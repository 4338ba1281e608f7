"""Model configurations of the serving slices: the dense architectures and mamba2-370m."""
from repro_torch.configs.base import ModelConfig, get_config

__all__ = ["ModelConfig", "get_config"]
