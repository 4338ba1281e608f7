"""granite-moe-1b-a400m [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]

24L d_model=1024 16H (GQA kv=8) d_ff=512 vocab=49155, MoE 32e top-8.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,
    vocab_size=49155,  # padded to a multiple of 256 at embedding time
    moe=MoEConfig(n_experts=32, top_k=8, n_shared_experts=0, d_expert=512),
    tie_embeddings=True,
    source="[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]",
)

SMOKE = ModelConfig(
    name="granite-moe-1b-a400m-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=64,
    vocab_size=499,  # intentionally unpadded to test vocab padding
    moe=MoEConfig(n_experts=4, top_k=2, n_shared_experts=0, d_expert=64),
    tie_embeddings=True,
)
