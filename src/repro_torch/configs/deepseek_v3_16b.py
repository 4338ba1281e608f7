"""DeepSeek-v3-16B — paper evaluation model (Table 2 Config 3).

The paper's Config 3 uses a 16B DeepSeek MoE (PP-only scale-out). We model it
with the published DeepSeekMoE-16B block structure.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v3-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=102400,
    moe=MoEConfig(n_experts=64, top_k=6, n_shared_experts=2, d_expert=1408),
    source="(paper Table 2, Config 3)",
)

SMOKE = ModelConfig(
    name="deepseek-v3-16b-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=96,
    vocab_size=512,
    moe=MoEConfig(n_experts=8, top_k=2, n_shared_experts=1, d_expert=96),
)
