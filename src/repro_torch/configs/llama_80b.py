"""LLaMA-80B — paper simulation model (Table 3, Figs 12/14-left).

vocab=32000 d_model=8192 d_ff=28672 seq=4096 heads=64 kv=8 layers=96 batch=256.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-80b",
    family="dense",
    n_layers=96,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=32000,
    source="(paper Table 3)",
)

SMOKE = ModelConfig(
    name="llama-80b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=8,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=512,
)
