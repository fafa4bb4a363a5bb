"""Rank policy: the paper's r_max gate and dynamic (ratio) ranks."""

from __future__ import annotations

from typing import Union

Rank = Union[int, float]


def r_max(m: int, n: int) -> float:
    """Paper Eq. 1: factorizing W∈R^{m×n} at rank r costs r·(m+n) instead of
    m·n, so the break-even rank is m·n/(m+n)."""
    return (m * n) / (m + n)


def resolve_rank(rank: Rank, m: int, n: int) -> int:
    """Resolve the user-facing rank spec for a given layer.

    * ``int``   — absolute rank, used as-is.
    * ``float`` — ratio of the layer's ``r_max`` (the paper's "dynamic rank
      across all layers"); must be in (0, 1].
    """
    if isinstance(rank, bool):  # guard: bool is an int subclass
        raise TypeError("rank must be int or float, got bool")
    if isinstance(rank, int):
        if rank < 1:
            raise ValueError(f"integer rank must be >= 1, got {rank}")
        return rank
    if isinstance(rank, float):
        if not 0.0 < rank <= 1.0:
            raise ValueError(f"ratio rank must be in (0, 1], got {rank}")
        return max(1, int(rank * r_max(m, n)))
    raise TypeError(f"rank must be int or float, got {type(rank)}")


def should_factorize(rank: Rank, m: int, n: int) -> bool:
    """The paper's gate: factorize only when the resolved rank is strictly
    below r_max, guaranteeing a theoretical FLOP/param reduction."""
    return resolve_rank(rank, m, n) < r_max(m, n)


def params_dense(m: int, n: int) -> int:
    return m * n


def params_factorized(m: int, n: int, r: int) -> int:
    return r * (m + n)
