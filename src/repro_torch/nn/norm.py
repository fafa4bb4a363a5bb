"""Normalization layers (counterpart of ``repro.nn.norm``)."""

from __future__ import annotations

import torch
from torch import nn


class RMSNorm(nn.Module):
    """Computes in fp32 and casts back to the input dtype."""

    def __init__(self, dim: int, *, eps: float = 1e-6, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim, dtype=dtype, device=device),
                                  requires_grad=False)
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        orig_dtype = x.dtype
        x = x.float()
        var = torch.mean(torch.square(x), dim=-1, keepdim=True)
        x = x * torch.rsqrt(var + self.eps)
        return (x * self.scale.float()).to(orig_dtype)
