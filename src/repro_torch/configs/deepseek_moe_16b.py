"""deepseek-moe-16b [arXiv:2401.06066; hf]

28L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=102400, MoE 64e top-6,
2 shared + 64 routed top-6 (fine-grained expert segmentation).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=102400,
    moe=MoEConfig(n_experts=64, top_k=6, n_shared_experts=2, d_expert=1408),
    rope_theta=10000.0,
    source="[arXiv:2401.06066; hf]",
)

SMOKE = ModelConfig(
    name="deepseek-moe-16b-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=96,
    vocab_size=512,
    moe=MoEConfig(n_experts=8, top_k=2, n_shared_experts=1, d_expert=96),
)
