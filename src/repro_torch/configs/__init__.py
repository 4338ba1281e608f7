"""Model configurations of the ported families: the dense architectures,
mamba2-370m and the MoE architectures (deepseek-moe-16b, granite-moe-1b-a400m,
deepseek-v3-16b)."""
from repro_torch.configs.base import ModelConfig, get_config

__all__ = ["ModelConfig", "get_config"]
