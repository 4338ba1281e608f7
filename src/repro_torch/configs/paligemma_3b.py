"""paligemma-3b [arXiv:2407.07726; hf] — SigLIP + gemma decoder.

18L d_model=2048 8H (GQA kv=1) d_ff=16384 vocab=257216.
The SigLIP vision frontend is a stub: the batch supplies precomputed
patch embeddings [batch, 256, 1152] which the backbone projects to d_model.
"""
from repro_torch.configs.base import FrontendConfig, ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    d_ff=16384,
    vocab_size=257216,
    head_dim=256,
    mlp_act="geglu",
    frontend=FrontendConfig(kind="patch", n_tokens=256, d_embed=1152),
    tie_embeddings=True,
    source="[arXiv:2407.07726; hf]",
)

SMOKE = ModelConfig(
    name="paligemma-3b-smoke",
    family="vlm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    d_ff=128,
    vocab_size=512,
    head_dim=16,
    mlp_act="geglu",
    frontend=FrontendConfig(kind="patch", n_tokens=16, d_embed=48),
    tie_embeddings=True,
)
