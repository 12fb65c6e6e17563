"""Object-oriented solver classes — the L4 convenience API.

A JAX re-design of the reference's abstract solver classes
(``src/lib/solver.h:32-283`` ``LCG_Solver``/``CLCG_Solver`` and the Eigen/
CUDA mirrors, ``solver_eigen.h:32-306``, ``solver_cuda.h:35-541``): the user
subclasses, overrides ``AxProduct`` (and optionally ``MxProduct`` /
``Progress``), and calls ``Minimize*`` which times the solve, reports, and
pretty-prints the exit status.

Differences from the reference, by design:

- ``AxProduct`` is a pure traced function ``x -> A x`` (no void* instance
  trampolines, ``solver.h:51-54`` — ``self`` is captured statically);
- ``Progress`` is the jit monitor: traced every iteration with
  ``(x, residual, t)``, returning True stops the solve with ``Status.STOP``
  (the reference's nonzero-return contract, lcg.h:53-54).  Per-iteration
  *printing* from inside a compiled loop is replaced by the residual trace,
  replayed after the solve at ``report_interval`` granularity;
- timing uses a host monotonic clock around the compiled solve, with the
  device synced before stopping the clock (the reference's
  ``omp_get_wtime``/``clock`` wrapping, solver.cpp:85-97);
- the CUDA-backend bug where ``_MxProduct`` called ``AxProduct``
  (solver_cuda.h:90) is — obviously — not reproduced.
"""

from __future__ import annotations

import sys
import time
from typing import Optional

import numpy as np
import jax.numpy as jnp

from .operators import LinearOperator, MatrixFreeOperator
from .solve import solve
from .types import DEFAULT_PARAMS, SolverParams, SolveResult
from .utils.errors import check_status

_METHOD_DISPLAY = {
    "cg": "CG", "pcg": "PCG", "cgs": "CGS", "bicgstab": "BICGSTAB",
    "bicgstab2": "BICGSTAB2", "pg": "PG", "spg": "SPG",
    "bicg": "BICG", "bicg_sym": "BICG-Symmetric", "tfqmr": "TFQMR",
    "pbicg": "PBICG",
}


class SolverBase:
    """Common machinery for both domains.  Subclass and override
    :meth:`AxProduct`; optionally :meth:`MxProduct` and :meth:`Progress`."""

    #: dtype of the system; subclasses set the domain default.
    dtype = jnp.float64

    def __init__(self, n: Optional[int] = None, dtype=None):
        self._n = n
        if dtype is not None:
            self.dtype = jnp.dtype(dtype)
        self._silent = False
        self._report_interval = 1
        self._params = DEFAULT_PARAMS
        self._throw = False

    # -- override points ------------------------------------------------------
    def AxProduct(self, x):
        """A @ x — must be jit-traceable.  Reference: the pure-virtual
        ``AxProduct`` (solver.h:60)."""
        raise NotImplementedError

    def MxProduct(self, x):
        """M^{-1} @ x for preconditioned methods (solver.h:120).  Default
        identity (i.e. unpreconditioned PCG)."""
        return x

    def AxProductLow(self, x):
        """Low-precision ``A @ x`` for :meth:`LCGSolver.MinimizeRefined`.

        Override with a genuinely fast-dtype product (e.g. f32 data).  A
        cast wrapper around :meth:`AxProduct` would silently run at full
        precision and defeat the refinement, so there is no default."""
        raise NotImplementedError(
            "override AxProductLow with a fast-dtype product to use "
            "MinimizeRefined"
        )

    def Progress(self, x, residual, t):
        """Traced monitor; return True to stop (lcg.h:53-54 contract)."""
        return False

    # -- knobs (solver.cpp:56-71) ---------------------------------------------
    def silent(self):
        self._silent = True
        return self

    def set_report_interval(self, interval: int):
        self._report_interval = max(1, int(interval))
        return self

    def set_parameters(self, params: SolverParams):
        self._params = params
        return self

    # Reference spellings.
    set_lcg_parameter = set_parameters
    set_clcg_parameter = set_parameters

    def throw_errors(self, flag: bool = True):
        """Raise LcgError on failure statuses instead of printing
        (``er_throw``, util.cpp:120)."""
        self._throw = flag
        return self

    # -- internals -------------------------------------------------------------
    def _operator(self, b) -> LinearOperator:
        return MatrixFreeOperator(self.AxProduct, n=len(b), dtype=b.dtype)

    def _monitor(self):
        # Only pass a monitor into the jit when the subclass overrides it:
        # the base implementation would just burn a branch per iteration.
        # The wrapper is memoized per instance — the jit cache keys on the
        # monitor's identity, so a fresh lambda per call would force a full
        # recompile of every Minimize (20-120 s through a remote backend).
        if type(self).Progress is not SolverBase.Progress:
            fn = getattr(self, "_monitor_fn", None)
            if fn is None:
                fn = lambda x, r, t: jnp.asarray(self.Progress(x, r, t))
                self._monitor_fn = fn
            return fn
        return None

    def _run(self, method, b, x0, M=None, lower=None, upper=None,
             params=None, key=None) -> SolveResult:
        params = params or self._params
        b = jnp.asarray(b, dtype=self.dtype)
        A = self._operator(b)
        t0 = time.perf_counter()
        result = solve(
            A, b, x0, method=method, params=params, M=M,
            lower=lower, upper=upper, monitor=self._monitor(),
            trace_len=0 if self._silent else 512, key=key,
        )
        np.asarray(result.x)  # sync the device before stopping the clock
        elapsed_ms = (time.perf_counter() - t0) * 1e3
        self._report(method, result, elapsed_ms)
        return result

    def _report(self, method, result: SolveResult, elapsed_ms: float):
        if self._silent:
            return
        if result.trace is not None:
            tr = np.asarray(result.trace)
            upto = min(int(result.iterations), len(tr))
            for t in range(0, upto, self._report_interval):
                print(f"\rIteration-times: {t}\tconvergence: {tr[t]:.6e}",
                      end="", file=sys.stderr)
            print(file=sys.stderr)
        name = _METHOD_DISPLAY.get(method, method.upper())
        print(f"Solver: {name}. Time cost: {elapsed_ms:.3f} ms",
              file=sys.stderr)
        check_status(result.status_code, raise_error=self._throw)


class LCGSolver(SolverBase):
    """Real-domain OO solver (reference ``LCG_Solver``, solver.h:32-177)."""

    dtype = jnp.float64

    def Minimize(self, b, x0=None, method: str = "cg",
                 params: Optional[SolverParams] = None) -> SolveResult:
        return self._run(method, b, x0, params=params)

    def MinimizePreconditioned(self, b, x0=None,
                               params: Optional[SolverParams] = None) -> SolveResult:
        """Always PCG with ``self.MxProduct`` (solver.cpp's
        MinimizePreconditioned -> lcg_solver_preconditioned, always lpcg)."""
        return self._run("pcg", b, x0, M=self.MxProduct, params=params)

    def MinimizeConstrained(self, b, lower, upper, x0=None,
                            method: str = "spg",
                            params: Optional[SolverParams] = None) -> SolveResult:
        return self._run(method, b, x0, lower=lower, upper=upper, params=params)

    def MinimizeRefined(self, b, x0=None, method: str = "cg",
                        inner_dtype=jnp.float32,
                        params: Optional[SolverParams] = None,
                        max_refinements: int = 8) -> SolveResult:
        """Mixed-precision iterative refinement through the class API:
        the outer correction runs on :meth:`AxProduct` (working
        precision) and the inner engine on :meth:`AxProductLow` (the
        fast dtype; must be overridden).  ``method="pcg"`` additionally
        applies :meth:`MxProduct` inside the inner engine.  No reference
        counterpart — its only mixed-precision story is the float copy
        of the complex library (clcg_cudaf.h)."""
        if type(self).AxProductLow is SolverBase.AxProductLow:
            raise NotImplementedError(
                "override AxProductLow with a fast-dtype product to use "
                "MinimizeRefined"
            )
        from .solvers.refine import solve_refined

        params = params or self._params
        b = jnp.asarray(b, dtype=self.dtype)
        A = self._operator(b)
        A_low = MatrixFreeOperator(self.AxProductLow, n=len(b),
                                   dtype=jnp.dtype(inner_dtype))
        M_low = self.MxProduct if method == "pcg" else None
        t0 = time.perf_counter()
        result = solve_refined(
            A, b, x0, method=method, params=params,
            inner_dtype=inner_dtype, A_low=A_low, M_low=M_low,
            max_refinements=max_refinements,
        )
        np.asarray(result.x)
        elapsed_ms = (time.perf_counter() - t0) * 1e3
        self._report(method, result, elapsed_ms)
        return result


class CLCGSolver(SolverBase):
    """Complex-domain OO solver (reference ``CLCG_Solver``, solver.h:182-283
    and ``CLCG_EIGEN_Solver``'s MinimizePreconditioned, solver_eigen.h:304)."""

    dtype = jnp.complex128

    def Minimize(self, b, x0=None, method: str = "bicg",
                 params: Optional[SolverParams] = None, key=None) -> SolveResult:
        return self._run(method, b, x0, params=params, key=key)

    def MinimizePreconditioned(self, b, x0=None, method: str = "pcg",
                               params: Optional[SolverParams] = None) -> SolveResult:
        if method not in ("pcg", "pbicg"):
            raise ValueError("preconditioned complex methods: pcg, pbicg")
        return self._run(method, b, x0, M=self.MxProduct, params=params)
