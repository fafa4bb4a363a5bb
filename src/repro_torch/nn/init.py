"""Parameter initializers, drawn from a ``torch.Generator`` on the target
device (counterpart of ``repro.nn.init``; only what ``create`` needs).

Values are drawn in float32 and cast to ``dtype``.  ``jax.random`` and
torch draw different numbers from one seed: tests carry weights across
with :mod:`repro_torch.bridge` instead of re-initializing."""

from __future__ import annotations

import math

import torch


def normal(gen: torch.Generator, shape, dtype=torch.float32,
           stddev: float = 0.02) -> torch.Tensor:
    w = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w * stddev).to(dtype)


def lecun_normal(gen: torch.Generator, shape, dtype=torch.float32,
                 fan_in_axes=(-2,)) -> torch.Tensor:
    fan_in = math.prod(shape[a] for a in fan_in_axes)
    w = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w / math.sqrt(max(fan_in, 1))).to(dtype)
