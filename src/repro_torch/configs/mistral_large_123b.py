"""mistral-large-123b [hf:mistralai/Mistral-Large-Instruct-2407; unverified]

88L d_model=12288 96H (GQA kv=8) d_ff=28672 vocab=32768.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mistral-large-123b",
    family="dense",
    n_layers=88,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=32768,
    head_dim=128,
    rope_theta=1000000.0,
    source="[hf:mistralai/Mistral-Large-Instruct-2407; unverified]",
)

SMOKE = ModelConfig(
    name="mistral-large-123b-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=8,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    head_dim=8,
)
