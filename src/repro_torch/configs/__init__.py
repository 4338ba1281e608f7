"""Model configurations of the serving slice: the dense architectures."""
from repro_torch.configs.base import ModelConfig, get_config

__all__ = ["ModelConfig", "get_config"]
