"""Model configurations of every family: the dense architectures (llama3-8b,
yi-9b, h2o-danube-3-4b, gemma-7b, mistral-large-123b and the paper's
llama-80b and gpt-80b), mamba2-370m, the MoE architectures
(deepseek-moe-16b, granite-moe-1b-a400m, deepseek-v3-16b), the hybrid
jamba-v0.1-52b, the VLM paligemma-3b and the audio encoder-decoder
seamless-m4t-medium."""
from repro_torch.configs.base import ASSIGNED_ARCHS, PAPER_ARCHS, ModelConfig, get_config

__all__ = ["ASSIGNED_ARCHS", "PAPER_ARCHS", "ModelConfig", "get_config"]
