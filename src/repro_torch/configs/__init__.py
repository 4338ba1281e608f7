"""Model configurations of the ported families: the dense architectures
(llama3-8b, yi-9b, h2o-danube-3-4b, gemma-7b, mistral-large-123b and the
paper's llama-80b and gpt-80b), mamba2-370m and the MoE architectures
(deepseek-moe-16b, granite-moe-1b-a400m, deepseek-v3-16b)."""
from repro_torch.configs.base import PAPER_ARCHS, ModelConfig, get_config

__all__ = ["PAPER_ARCHS", "ModelConfig", "get_config"]
