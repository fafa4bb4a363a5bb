"""Factorization core of the port (counterpart of ``repro.core``)."""

from repro_torch.core.auto_fact import FactReport, auto_fact
from repro_torch.core.rank import r_max, resolve_rank, should_factorize
from repro_torch.core.solvers import (SOLVERS, get_solver, random_solver,
                                      svd_solver)

__all__ = ["auto_fact", "FactReport", "r_max", "resolve_rank",
           "should_factorize", "SOLVERS", "get_solver", "random_solver",
           "svd_solver"]
