"""Factorization solvers: random and SVD (counterpart of
``repro.core.solvers``; SNMF is not ported yet).

Every solver maps ``W ∈ R^{..., m, n}`` (leading stack axes allowed:
layer-stacked weights factorize in one batched call) to ``(A ∈ R^{..., m,
r}, B ∈ R^{..., r, n})`` with ``W ≈ A @ B``.

* ``random`` — fresh initialization at the target rank, from a
  ``torch.Generator`` (factorization by design; it does not approximate W).
* ``svd``    — truncated SVD in fp32, split symmetrically:
  ``A = U·√Σ, B = √Σ·Vᵀ``.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch


def random_solver(w: torch.Tensor, rank: int, *,
                  generator: Optional[torch.Generator] = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    *stack, m, n = w.shape
    # lecun-style scaling so that var(A@B x) matches var(W x) at init
    a = torch.randn((*stack, m, rank), generator=generator, device=w.device)
    b = torch.randn((*stack, rank, n), generator=generator, device=w.device)
    return ((a / math.sqrt(m)).to(w.dtype),
            (b / math.sqrt(rank)).to(w.dtype))


def svd_solver(w: torch.Tensor, rank: int, *,
               generator: Optional[torch.Generator] = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    del generator
    u, s, vt = torch.linalg.svd(w.float(), full_matrices=False)
    u, s, vt = u[..., :rank], s[..., :rank], vt[..., :rank, :]
    sq = torch.sqrt(s)
    a = u * sq[..., None, :]
    b = sq[..., :, None] * vt
    return a.to(w.dtype), b.to(w.dtype)


SOLVERS: dict[str, Callable] = {
    "random": random_solver,
    "svd": svd_solver,
}


def get_solver(name: str) -> Callable:
    try:
        return SOLVERS[name]
    except KeyError:
        raise ValueError(
            f"unknown solver {name!r}; available: {sorted(SOLVERS)} "
            "(snmf is not ported yet)") from None
