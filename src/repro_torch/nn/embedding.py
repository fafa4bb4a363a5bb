"""Token embedding, optionally tied as the output head (counterpart of
``repro.nn.embedding``)."""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.nn import init as initializers


class Embedding(nn.Module):
    def __init__(self, weight: torch.Tensor):
        super().__init__()
        self.weight = nn.Parameter(weight, requires_grad=False)  # (vocab, dim)

    @staticmethod
    def create(gen: torch.Generator, vocab_size: int, dim: int, *,
               dtype=torch.float32) -> "Embedding":
        return Embedding(initializers.normal(gen, (vocab_size, dim), dtype))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.weight[tokens]

    def attend(self, x: torch.Tensor) -> torch.Tensor:
        """Tied output head: logits = x @ E^T."""
        return x @ self.weight.T
