"""gemma-7b [arXiv:2403.08295; hf]

28L d_model=3072 16H (GQA kv=16) d_ff=24576 vocab=256000 — GeGLU, head_dim=256.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    d_ff=24576,
    vocab_size=256000,
    head_dim=256,
    mlp_act="geglu",
    tie_embeddings=True,
    source="[arXiv:2403.08295; hf]",
)

SMOKE = ModelConfig(
    name="gemma-7b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=512,
    head_dim=32,  # head_dim override exercised (4*32 != 64)
    mlp_act="geglu",
    tie_embeddings=True,
)
