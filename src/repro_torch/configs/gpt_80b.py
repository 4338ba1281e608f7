"""GPT-80B — paper simulation model (Table 3, Figs 13/14-right).

Table 3 lists one spec for the simulated 80B GPT and LLaMA; GPT uses
learned-positional/untied variant here to distinguish the two stacks.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gpt-80b",
    family="dense",
    n_layers=96,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=32000,
    mlp_act="geglu",
    source="(paper Table 3)",
)

SMOKE = ModelConfig(
    name="gpt-80b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=8,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    mlp_act="geglu",
)
