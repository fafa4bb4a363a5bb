"""Architecture + shape configuration system.

``ArchConfig`` is a plain frozen dataclass (NOT a pytree module — configs are
static).  Every assigned architecture registers itself via
``repro_torch.configs.registry.register``; the CLI selects with ``--arch <id>``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class FactConfig:
    """Greenformer integration: factorization-by-design settings."""

    enabled: bool = False
    rank: float = 0.25  # int = absolute, float = ratio of r_max
    solver: str = "random"  # by-design default; 'svd'/'snmf' for post-training
    num_iter: int = 50
    submodules: Optional[Tuple[str, ...]] = None
    exclude: Optional[Tuple[str, ...]] = ("router", "lm_head", "embed")


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None  # default d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    n_shared: int = 0
    capacity_factor: float = 1.25
    # --- SSM / hybrid ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    window: int = 0  # sliding-window size for hybrid attn (0 = global)
    attn_chunk: int = 0  # >0: flash-style blockwise attention (O(chunk^2) temps)
    # --- encoder-decoder ---
    n_enc_layers: int = 0
    max_positions: int = 4096  # learned-pos-embedding size (encdec only)
    # --- numerics / notes ---
    dtype: str = "bfloat16"
    supports_long_context: bool = False  # sub-quadratic decode path exists
    has_decode: bool = True
    note: str = ""
    # --- Greenformer ---
    fact: FactConfig = dataclasses.field(default_factory=FactConfig)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        return self.replace(
            n_layers=2,
            d_model=64,
            n_heads=4,
            n_kv_heads=max(1, min(self.n_kv_heads, 2)),
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab=256,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            n_shared=min(self.n_shared, 1),
            ssm_state=min(self.ssm_state, 8) if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else 64,
            window=min(self.window, 8) if self.window else 0,
            n_enc_layers=2 if self.n_enc_layers else 0,
            max_positions=128,
            dtype="float32",
        )


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def applicable_shapes(cfg: ArchConfig) -> list[str]:
    out = ["train_4k", "prefill_32k"]
    if cfg.has_decode:
        out.append("decode_32k")
        if cfg.supports_long_context:
            out.append("long_500k")
    return out
