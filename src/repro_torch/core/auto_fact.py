"""``auto_fact`` — the paper's one-line automatic factorization API
(counterpart of ``repro.core.auto_fact``; ``Linear`` layers only).

    from repro_torch.core import auto_fact
    fact_model = auto_fact(model, rank=0.5, solver="svd")

Replaces every ``Linear`` with an ``LED`` whenever the resolved rank passes
the paper's ``r < r_max`` gate (or always, with ``gate=False``).

The JAX package stacks a model's layers on a leading axis, so one
``Linear`` there covers every layer and its dotted path has no layer index
(``blocks.attn.q_proj``).  The port keeps its layers in an
``nn.ModuleList``; ``auto_fact`` folds the list index out of the path and
factorizes the same projection of every layer in one batched solve, so
paths, filters, ranks and the :class:`FactReport` (``rel_err`` over the
stacked weight) match the JAX package's.  The model is changed in place
and returned.
"""

from __future__ import annotations

import fnmatch
from dataclasses import dataclass, field
from typing import Optional, Sequence

import torch
from torch import nn

from repro_torch.core.rank import Rank, r_max, resolve_rank
from repro_torch.core.solvers import get_solver
from repro_torch.nn.linear import LED, Linear


@dataclass
class FactReport:
    """What auto_fact did, layer by layer."""

    # (path, kind, m, n, r, rel_err) — rel_err is the relative Frobenius
    # reconstruction error ||W - A@B||_F / ||W||_F over the whole (possibly
    # layer-stacked) weight
    entries: list = field(default_factory=list)
    skipped: list = field(default_factory=list)  # (path, reason)
    params_before: int = 0
    params_after: int = 0

    @property
    def compression(self) -> float:
        if self.params_after == 0:
            return 1.0  # nothing factorized → no compression, not 0x
        return self.params_before / self.params_after

    def summary(self) -> str:
        lines = [f"auto_fact: {len(self.entries)} layers factorized, "
                 f"{len(self.skipped)} skipped"]
        lines += [f"  [fact] {p} ({kind}) {m}x{n} -> r={r} rel_err={e:.4f}"
                  for p, kind, m, n, r, e in self.entries]
        lines += [f"  [skip] {p}: {why}" for p, why in self.skipped]
        if self.params_before:
            lines.append(
                f"  target params: {self.params_before:,} -> "
                f"{self.params_after:,} ({self.compression:.2f}x)")
        return "\n".join(lines)


def _matches(path: str, patterns: Optional[Sequence[str]]) -> bool:
    if patterns is None:
        return True
    return any(p in path or fnmatch.fnmatch(path, p) for p in patterns)


def _rel_err(w: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> float:
    """Relative Frobenius reconstruction error of W ≈ A @ B (stack-aware)."""
    w32 = w.float()
    diff = a.float() @ b.float() - w32
    denom = torch.clamp(torch.linalg.vector_norm(w32), min=1e-30)
    return float(torch.linalg.vector_norm(diff) / denom)


def _resolve_ungated(rank: Rank, m: int, n: int) -> int:
    """Rank resolution with the r_max gate off: float ratios scale
    min(m, n) (``rank=1.0`` is exact full rank), int ranks clamp to it."""
    if isinstance(rank, bool) or not isinstance(rank, (int, float)):
        raise TypeError(f"rank must be int or float, got {type(rank)}")
    if isinstance(rank, float):
        if not 0.0 < rank <= 1.0:
            raise ValueError(f"float rank must be in (0, 1], got {rank}")
        return max(1, int(rank * min(m, n)))
    if rank < 1:
        raise ValueError(f"int rank must be >= 1, got {rank}")
    return min(rank, min(m, n))


def linear_groups(module: nn.Module) -> dict:
    """JAX-style dotted path -> [(parent, attribute, Linear), ...] in
    module order, with ``nn.ModuleList`` indices folded out of the path
    (one entry per layer of a stacked projection)."""
    groups: dict = {}

    def walk(mod: nn.Module, path: str) -> None:
        folded = isinstance(mod, nn.ModuleList)
        for name, child in mod.named_children():
            cpath = path if folded else (f"{path}.{name}" if path else name)
            if isinstance(child, Linear):
                groups.setdefault(cpath, []).append((mod, name, child))
            else:
                walk(child, cpath)

    walk(module, "")
    return groups


@torch.no_grad()
def auto_fact(module: nn.Module, rank: Rank, *, solver: str = "svd",
              generator: Optional[torch.Generator] = None,
              submodules: Optional[Sequence[str]] = None,
              exclude: Optional[Sequence[str]] = None,
              fuse: str = "auto", gate: bool = True,
              return_report: bool = False):
    """Factorize ``module`` in place; returns it (and a
    :class:`FactReport` when ``return_report=True``).

    ``solver="random"`` draws from ``generator`` (default: a generator on
    the model's device seeded with 0).  ``gate=False`` disables the
    paper's ``r < r_max`` check and resolves float ranks against ``min(m,
    n)``, so ``rank=1.0, solver="svd"`` is an exact full-rank LED."""
    solve = get_solver(solver)
    report = FactReport()
    for path, members in linear_groups(module).items():
        if not _matches(path, submodules) or (exclude
                                              and _matches(path, exclude)):
            report.skipped.append((path, "filtered"))
            continue
        m, n = members[0][2].weight.shape
        if gate:
            r = resolve_rank(rank, m, n)
            if r >= r_max(m, n):
                report.skipped.append(
                    (path, f"rank {r} >= r_max {r_max(m, n):.1f} ({m}x{n})"))
                continue
        else:
            r = _resolve_ungated(rank, m, n)
        w = torch.stack([lin.weight for _, _, lin in members])
        if solver == "random" and generator is None:
            generator = torch.Generator(device=w.device).manual_seed(0)
        a, b = solve(w, r, generator=generator)
        report.params_before += w.numel()
        report.params_after += a.numel() + b.numel()
        report.entries.append((path, "linear", m, n, r, _rel_err(w, a, b)))
        del w
        for i, (parent, name, lin) in enumerate(members):
            bias = None if lin.bias is None else lin.bias.data
            setattr(parent, name, LED(a[i].clone(), b[i].clone(), bias,
                                      fuse=fuse))
    return (module, report) if return_report else module


__all__ = ["auto_fact", "FactReport", "linear_groups"]
