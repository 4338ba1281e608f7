"""seamless-m4t-medium [arXiv:2308.11596; hf] — enc-dec, multimodal.

12L d_model=1024 16H (GQA kv=16) d_ff=4096 vocab=256206.
The audio frontend is a stub: the batch supplies precomputed frame
embeddings [batch, 1024, 1024] consumed by the 12L encoder; the 12L decoder
cross-attends to the encoder output.
"""
from repro_torch.configs.base import EncoderConfig, FrontendConfig, ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    n_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,  # padded to a multiple of 256 at embedding time
    encoder=EncoderConfig(
        n_layers=12, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=4096,
        n_frontend_tokens=1024,
    ),
    frontend=FrontendConfig(kind="audio_frames", n_tokens=1024, d_embed=1024),
    source="[arXiv:2308.11596; hf]",
)

SMOKE = ModelConfig(
    name="seamless-m4t-medium-smoke",
    family="audio",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=512,
    encoder=EncoderConfig(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        n_frontend_tokens=16,
    ),
    frontend=FrontendConfig(kind="audio_frames", n_tokens=16, d_embed=64),
)
