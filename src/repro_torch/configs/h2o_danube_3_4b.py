"""h2o-danube-3-4b [arXiv:2401.16818; unverified] — llama+mistral mix, SWA.

24L d_model=3840 32H (GQA kv=8) d_ff=10240 vocab=32000.
Sliding-window attention => sub-quadratic => long_500k applies.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b",
    family="dense",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    d_ff=10240,
    vocab_size=32000,
    sliding_window=4096,
    rope_theta=10000.0,
    source="[arXiv:2401.16818; unverified]",
)

SMOKE = ModelConfig(
    name="h2o-danube-3-4b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=8,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    sliding_window=16,
)
