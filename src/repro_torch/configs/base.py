"""Model configuration for the PyTorch port (a copy of ``repro.configs.base``).

Each architecture module ``repro_torch/configs/<id>.py`` exposes ``CONFIG``
(the full published configuration) and ``SMOKE`` (a reduced configuration of
the same family for CPU tests).  ``get_config(name)`` resolves either.
The port keeps its own copy so that it never imports the JAX package.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts FFN configuration (fine-grained, DeepSeek-style)."""

    n_experts: int
    top_k: int
    n_shared_experts: int = 0
    d_expert: Optional[int] = None  # defaults to d_ff
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    # apply MoE FFN every `moe_every` layers (1 = every layer, 2 = alternate)
    moe_every: int = 1


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 SSD configuration."""

    state_dim: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk_size: int = 64
    n_groups: int = 1


@dataclass(frozen=True)
class EncoderConfig:
    """Encoder stack for enc-dec (audio) architectures."""

    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    n_frontend_tokens: int = 1024


@dataclass(frozen=True)
class FrontendConfig:
    """Modality frontend stub (VLM patches / audio frames)."""

    kind: str  # "patch" | "audio_frames"
    n_tokens: int
    d_embed: int


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default d_model // n_heads
    mlp_act: str = "swiglu"  # swiglu | geglu
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # layer pattern, repeated over depth.  Entries: "attn" | "mamba".
    # None => all-"attn" (or all-"mamba" for family=="ssm").
    layer_pattern: Optional[Tuple[str, ...]] = None
    sliding_window: Optional[int] = None
    encoder: Optional[EncoderConfig] = None
    frontend: Optional[FrontendConfig] = None
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    remat: str = "none"  # none | full | dots
    source: str = ""  # provenance tag, e.g. "[arXiv:2401.06066; hf]"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def pattern(self) -> Tuple[str, ...]:
        if self.layer_pattern is not None:
            return self.layer_pattern
        if self.family == "ssm":
            return ("mamba",)
        return ("attn",)

    @property
    def n_periods(self) -> int:
        p = len(self.pattern)
        assert self.n_layers % p == 0, (self.name, self.n_layers, p)
        return self.n_layers // p

    def layer_kind(self, i: int) -> str:
        return self.pattern[i % len(self.pattern)]

    def layer_has_moe(self, i: int) -> bool:
        return self.moe is not None and (i % self.moe.moe_every) == (self.moe.moe_every - 1)

    @property
    def sub_quadratic(self) -> bool:
        """True when long-context decode (long_500k) is supported."""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.sliding_window is not None

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# input shapes (the assigned shape set of the LM family), as in
# ``repro.configs.base``
@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


ASSIGNED_SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4096, 256, "train"),
    ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    ShapeConfig("decode_32k", 32768, 128, "decode"),
    ShapeConfig("long_500k", 524288, 1, "decode"),
)

SHAPES = {s.name: s for s in ASSIGNED_SHAPES}


def shape_applicable(model: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether an (arch x shape) cell is applicable, with a reason if not."""
    if shape.name == "long_500k" and not model.sub_quadratic:
        return False, "pure full-attention arch: long_500k needs sub-quadratic attention"
    return True, ""


# the model zoo and the models of the paper's Table 3 simulations, as in
# ``repro.configs.base``
ASSIGNED_ARCHS = (
    "deepseek_moe_16b",
    "granite_moe_1b_a400m",
    "gemma_7b",
    "mistral_large_123b",
    "yi_9b",
    "h2o_danube_3_4b",
    "paligemma_3b",
    "mamba2_370m",
    "seamless_m4t_medium",
    "jamba_v0_1_52b",
)

PAPER_ARCHS = ("llama3_8b", "deepseek_v3_16b", "llama_80b", "gpt_80b")


def canonical(name: str) -> str:
    return name.replace("-", "_").replace(".", "_")


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{canonical(name)}")
    return mod.SMOKE if smoke else mod.CONFIG
