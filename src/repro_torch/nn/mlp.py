"""SwiGLU feed-forward block (counterpart of ``repro.nn.mlp.SwiGLU``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.nn.linear import Linear


class SwiGLU(nn.Module):
    def __init__(self, gate_proj: nn.Module, up_proj: nn.Module,
                 down_proj: nn.Module):
        super().__init__()
        self.gate_proj = gate_proj
        self.up_proj = up_proj
        self.down_proj = down_proj

    @staticmethod
    def create(gen: torch.Generator, dim: int, hidden: int, *,
               dtype=torch.float32) -> "SwiGLU":
        return SwiGLU(
            gate_proj=Linear.create(gen, dim, hidden, dtype=dtype),
            up_proj=Linear.create(gen, dim, hidden, dtype=dtype),
            down_proj=Linear.create(gen, hidden, dim, dtype=dtype),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))
