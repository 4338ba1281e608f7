"""jamba-v0.1-52b [arXiv:2403.19887; hf] — Mamba+attn 1:7 interleave, MoE.

32L d_model=4096 32H (GQA kv=8) d_ff=14336, MoE 16e top-2.
Period-8 pattern with attention at position 4 (1 attn : 7 mamba), MoE FFN on
every other layer (moe_every=2), matching the published Jamba block layout.
Mamba layers use Mamba-2 SSD blocks, as in the JAX package (Jamba v0.1
used Mamba-1).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig

_PATTERN = ("mamba", "mamba", "mamba", "mamba", "attn", "mamba", "mamba", "mamba")

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    moe=MoEConfig(n_experts=16, top_k=2, n_shared_experts=0, d_expert=14336,
                  moe_every=2),
    ssm=SSMConfig(state_dim=16, head_dim=64, expand=2, conv_width=4, chunk_size=64),
    layer_pattern=_PATTERN,
    source="[arXiv:2403.19887; hf]",
)

SMOKE = ModelConfig(
    name="jamba-v0.1-52b-smoke",
    family="hybrid",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    moe=MoEConfig(n_experts=4, top_k=2, n_shared_experts=0, d_expert=128,
                  moe_every=2),
    ssm=SSMConfig(state_dim=16, head_dim=16, expand=2, conv_width=4, chunk_size=8),
    layer_pattern=("mamba", "attn"),
)
