"""Solve timing, throughput stats, and profiler capture.

The replacement for the reference's wall-clock-only instrumentation
(``omp_get_wtime``/``clock`` around ``Minimize*``, solver.cpp:85-97):
``timed_solve`` returns a :class:`SolveStats` with wall time, iteration
throughput and achieved nnz/s, and ``profile_solve`` wraps a solve in a
``jax.profiler`` trace for the TensorBoard/xprof toolchain.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import jax


@dataclasses.dataclass
class SolveStats:
    """Per-solve performance record (the reference only ever printed the
    wall time; everything else here is new observability)."""

    wall_ms: float
    iterations: int
    status: int
    residual: float
    nnz: Optional[int] = None
    nnz_per_s: Optional[float] = None
    iterations_per_s: Optional[float] = None
    matvecs_per_iteration: int = 1

    def __str__(self):
        parts = [f"{self.wall_ms:.3f} ms", f"{self.iterations} iters"]
        if self.iterations_per_s:
            parts.append(f"{self.iterations_per_s:,.0f} iter/s")
        if self.nnz_per_s:
            parts.append(f"{self.nnz_per_s:.3e} nnz/s")
        return " | ".join(parts)


#: Operator products per iteration by method (SURVEY §6 cost model:
#: CG/PCG 1; CGS/BiCGSTAB-family/TFQMR 2).
_MATVECS = {
    "cg": 1, "pcg": 1, "cg_pipelined": 1, "pcg_pipelined": 1,
    "pg": 1, "spg": 1,
    "cgs": 2, "bicgstab": 2, "bicgstab2": 2, "tfqmr": 2,
    "bicg": 2, "bicg_sym": 1, "pbicg": 2,
    "block_cg": 1, "block_pcg": 1,
}


def timed_solve(A, b, *args, method: str = "cg", warmup: bool = True,
                reps: int = 1, **kw):
    """Run :func:`liblcg_tpu.solve` and time it with the device synced.

    Returns ``(SolveResult, SolveStats)``.  ``warmup=True`` runs one extra
    solve first so compilation does not pollute the measurement; ``reps``
    takes the best of that many runs.  Sync is via host materialization of
    the solution.
    """
    from ..solve import canonical_method, solve

    m = canonical_method(method)
    if warmup:
        res = solve(A, b, *args, method=method, **kw)
        np.asarray(res.x)
    best = float("inf")
    res = None
    for _ in range(max(1, reps)):
        t0 = time.perf_counter()
        res = solve(A, b, *args, method=method, **kw)
        np.asarray(res.x)
        best = min(best, time.perf_counter() - t0)

    iters = int(res.iterations)
    nnz = getattr(A, "nnz", None)
    mv = _MATVECS.get(m, 1)
    stats = SolveStats(
        wall_ms=best * 1e3,
        iterations=iters,
        status=int(res.status_code),
        residual=float(res.residual),
        nnz=nnz,
        nnz_per_s=(nnz * mv * iters / best) if (nnz and best > 0 and iters) else None,
        iterations_per_s=(iters / best) if (best > 0 and iters) else None,
        matvecs_per_iteration=mv,
    )
    return res, stats


def profile_solve(logdir: str, A, b, *args, **kw):
    """Capture a ``jax.profiler`` trace of one solve into ``logdir``
    (inspect with TensorBoard / xprof).  Returns the SolveResult."""
    from ..solve import solve

    with jax.profiler.trace(logdir):
        res = solve(A, b, *args, **kw)
        np.asarray(res.x)
    return res
