"""mamba2-370m [arXiv:2405.21060; unverified] — SSD (state-space duality).

48L d_model=1024 (attn-free) vocab=50280, ssm_state=128.
d_inner = expand*d_model = 2048, head_dim=64 => 32 SSD heads.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,  # padded to a multiple of 256 at embedding time
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, conv_width=4, chunk_size=64),
    tie_embeddings=True,
    source="[arXiv:2405.21060; unverified]",
)

SMOKE = ModelConfig(
    name="mamba2-370m-smoke",
    family="ssm",
    n_layers=2,
    d_model=64,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=512,
    ssm=SSMConfig(state_dim=16, head_dim=16, expand=2, conv_width=4, chunk_size=8),
    tie_embeddings=True,
)
