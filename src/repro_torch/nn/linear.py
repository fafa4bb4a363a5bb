"""Dense and low-rank (LED) linear layers (counterpart of
``repro.nn.linear``).

``Linear.weight`` is ``(in_features, out_features)`` (``y = x @ W + b``),
the JAX package's layout, not torch's ``(out, in)``.  ``LED`` is the
paper's factorized replacement ``y = (x @ A) @ B + b`` with ``A: (in, r)``
and ``B: (r, out)``.  ``fuse`` picks how the product runs:

* ``"auto"`` — :func:`repro_torch.kernels.led_matmul`: the hand-written
  CUDA kernel for an input on the card, the plain version for a CPU input;
* ``"cuda"`` — the kernel, and an input on the CPU raises;
* ``"torch"`` — the plain version everywhere (tests, and the smoke's
  comparisons on the card).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.kernels.led_matmul import led_matmul, led_matmul_torch
from repro_torch.nn import init as initializers

FUSE_MODES = ("auto", "cuda", "torch")


def _param(t: Optional[torch.Tensor]) -> Optional[nn.Parameter]:
    return None if t is None else nn.Parameter(t, requires_grad=False)


class Linear(nn.Module):
    def __init__(self, weight: torch.Tensor,
                 bias: Optional[torch.Tensor] = None):
        super().__init__()
        self.weight = _param(weight)  # (in_features, out_features)
        self.bias = _param(bias)      # (out_features,) or None

    @staticmethod
    def create(gen: torch.Generator, in_features: int, out_features: int, *,
               use_bias: bool = False, dtype=torch.float32) -> "Linear":
        weight = initializers.lecun_normal(gen, (in_features, out_features),
                                           dtype)
        bias = (torch.zeros(out_features, dtype=dtype, device=gen.device)
                if use_bias else None)
        return Linear(weight, bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.weight
        if self.bias is not None:
            y = y + self.bias
        return y


class LED(nn.Module):
    """Linear Encoder-Decoder layer: ``y = (x @ A) @ B + bias``."""

    def __init__(self, A: torch.Tensor, B: torch.Tensor,
                 bias: Optional[torch.Tensor] = None, *, fuse: str = "auto"):
        super().__init__()
        if fuse not in FUSE_MODES:
            raise ValueError(f"unknown fuse {fuse!r}; expected one of "
                             f"{FUSE_MODES}")
        self.A = _param(A)  # (in_features, rank) -- the "encoder"
        self.B = _param(B)  # (rank, out_features) -- the "decoder"
        self.bias = _param(bias)
        self.fuse = fuse

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fuse == "torch":
            y = led_matmul_torch(x, self.A, self.B)
        else:
            if self.fuse == "cuda" and not x.is_cuda:
                raise RuntimeError(
                    "LED(fuse='cuda') runs the CUDA kernel and was given a "
                    f"tensor on {x.device}; use fuse='auto' or 'torch' on "
                    "the CPU")
            y = led_matmul(x, self.A, self.B)
        if self.bias is not None:
            y = y + self.bias
        return y
