"""Core types: solver parameters, status codes, and solve results.

A JAX re-design of the reference liblcg configuration layer
(``src/lib/util.h:32-306``).  The reference exposes two C structs
(``lcg_para`` at util.h:95-148 and ``clcg_para`` at util.h:247-273) plus two
return-code enums; here a single frozen dataclass serves both domains (the
complex engines simply ignore the PG/SPG knobs, as the reference's
``clcg_para`` has no such fields), and a single IntEnum carries the status
codes with the reference's exact numeric values.

Everything in this module is either static jit metadata (``SolverParams`` is
hashable and used as a static argument) or a pytree leaf container
(``SolveResult``).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Optional

import jax.numpy as jnp
from jax.tree_util import register_pytree_node


class Status(enum.IntEnum):
    """Solver return codes.

    Numeric values mirror the reference ``lcg_return_enum``
    (``src/lib/util.h:69-90``): success codes are small non-negatives,
    errors count up from -1024.  The complex enum (``util.h:226-242``) is a
    subset with slightly different numbering; we use the real-domain values
    uniformly and document the mapping here so user code only needs one enum.
    """

    #: Iteration reached convergence (``LCG_CONVERGENCE`` == ``LCG_SUCCESS``).
    CONVERGENCE = 0
    #: Stopped early by the monitor callback (``LCG_STOP``).
    STOP = 1
    #: The initial solution already satisfies the tolerance
    #: (``LCG_ALREADY_OPTIMIZIED`` — reference spelling preserved in alias).
    ALREADY_OPTIMIZED = 2
    #: Internal sentinel: the solve is still in progress.  Never returned.
    RUNNING = 100

    UNKNOWN_ERROR = -1024
    INVALID_VARIABLE_SIZE = -1023
    INVALID_MAX_ITERATIONS = -1022
    INVALID_EPSILON = -1021
    INVALID_RESTART_EPSILON = -1020
    #: Iteration hit ``max_iterations`` (``LCG_REACHED_MAX_ITERATIONS``).
    REACHED_MAX_ITERATIONS = -1019
    NULL_PRECONDITION_MATRIX = -1018
    #: NaN detected in the solution vector (``LCG_NAN_VALUE``).
    NAN_VALUE = -1017
    INVALID_POINTER = -1016
    INVALID_LAMBDA = -1015
    INVALID_SIGMA = -1014
    INVALID_BETA = -1013
    INVALID_MAXIM = -1012
    SIZE_NOT_MATCH = -1011
    UNKNOWN_SOLVER = -1010

    @property
    def is_success(self) -> bool:
        return self.value >= 0

    def describe(self) -> str:
        from .utils.errors import status_message

        return status_message(self)


# Reference spelling kept as an alias (util.h:74 "LCG_ALREADY_OPTIMIZIED").
Status.ALREADY_OPTIMIZIED = Status.ALREADY_OPTIMIZED  # type: ignore[attr-defined]


@dataclasses.dataclass(frozen=True)
class SolverParams:
    """Iteration-control parameters.

    Field-for-field analogue of the reference ``lcg_para``
    (``src/lib/util.h:95-148``) with the reference defaults
    (``defparam = {0, 1e-6, 0, 1e-6, 1.0, 0.95, 0.9, 10}``, util.h:153).
    The complex-domain ``clcg_para`` (util.h:247-273) is the prefix
    (max_iterations, epsilon, abs_diff) of this struct.

    This object is static under ``jax.jit`` — changing a field triggers a
    recompile, exactly like recompiling the reference with different
    compile-time constants would.  ``max_iterations == 0`` means "iterate
    until convergence" (reference semantics); the jit harness then uses
    ``hard_iteration_cap`` as the compiled loop bound.
    """

    #: Maximal iteration count; 0 = run until convergence (util.h:101).
    max_iterations: int = 0
    #: Convergence tolerance, must lie in (0, 1) (util.h:110).
    epsilon: float = 1e-6
    #: Nonzero selects the absolute-difference stopping rule
    #: ``sqrt(||r||^2)/N <= eps`` instead of the relative rule
    #: ``||r||^2 / max(||x||^2, 1) <= eps`` (util.h:118; lcg.cpp:186-209).
    abs_diff: int = 0
    #: Restart threshold for BiCGSTAB2 (util.h:123; lcg.cpp:993-1009).
    restart_epsilon: float = 1e-6
    #: Initial BB step length for PG/SPG (util.h:128).
    step: float = 1.0
    #: Armijo sufficient-decrease multiplier for SPG, in (0,1) (util.h:134).
    sigma: float = 0.95
    #: Backtracking ratio for SPG's non-monotone line search (util.h:140).
    beta: float = 0.9
    #: History window for SPG's non-monotone objective record (util.h:147).
    maxi_m: int = 10
    #: Compiled upper bound on iterations when ``max_iterations == 0``.
    #: New knob (no reference equivalent — the C loop is unbounded).
    hard_iteration_cap: int = 10000
    #: Maximum backtracking steps for SPG's inner line search.  New knob:
    #: the reference inner loop (lcg.cpp:1377-1399) is unbounded, which
    #: cannot be compiled; 60 halvings at beta=0.9 shrink alpha below 2e-3.
    max_backtracks: int = 60
    #: Accumulate dot products in this dtype (e.g. "float64" with float32
    #: storage), cast back to the storage dtype.  None = storage dtype.
    #: New knob: the reference's only mixed-precision story is a duplicated
    #: float-complex stack (clcg_cudaf.*).
    reduce_dtype: Optional[str] = None

    def effective_max_iterations(self) -> int:
        return self.max_iterations if self.max_iterations > 0 else self.hard_iteration_cap

    def validate(self, for_method: str = "cg") -> Optional[Status]:
        """Pre-flight validation mirroring the engine entry checks
        (lcg.cpp:150-155, 1232-1238).  Returns an error Status or None."""
        if self.max_iterations < 0:
            return Status.INVALID_MAX_ITERATIONS
        if for_method == "bicgstab2":
            # lcg.cpp:821-822: epsilon>0 and restart_epsilon>0 and epsilon<1.
            if self.epsilon <= 0.0:
                return Status.INVALID_EPSILON
            if self.restart_epsilon <= 0.0 or self.epsilon >= 1.0:
                return Status.INVALID_RESTART_EPSILON
        elif for_method == "pg":
            # lcg.cpp:1064-1065.
            if self.epsilon <= 0.0:
                return Status.INVALID_EPSILON
            if self.step <= 0.0 or self.epsilon >= 1.0:
                return Status.INVALID_LAMBDA
        else:
            if self.epsilon <= 0.0 or self.epsilon >= 1.0:
                return Status.INVALID_EPSILON
        if for_method == "spg":
            # lcg.cpp:1235-1238.
            if self.step <= 0.0:
                return Status.INVALID_LAMBDA
            if not (0.0 < self.sigma < 1.0):
                return Status.INVALID_SIGMA
            if not (0.0 < self.beta < 1.0):
                return Status.INVALID_BETA
            if self.maxi_m <= 0:
                return Status.INVALID_MAXIM
        return None


#: Module-level defaults, analogous to ``defparam`` (util.h:153).
DEFAULT_PARAMS = SolverParams()


class SolveResult:
    """Result of a solve: a pytree of (x, status, iterations, residual, trace).

    The reference returns only an int code and mutates ``m`` in place
    (lcg.h:61); here the solution is returned functionally together with the
    iteration count and final residual the reference only exposed through the
    progress callback (lcg.h:53-54).

    ``trace`` is a fixed-length residual history buffer (``trace[t]`` is the
    residual computed at the top of iteration ``t``); entries past
    ``iterations`` hold zeros.  It replaces the reference's per-iteration
    ``Pfp`` printing without breaking jit.
    """

    __slots__ = ("x", "status_code", "iterations", "residual", "trace")

    def __init__(self, x, status_code, iterations, residual, trace=None):
        self.x = x
        self.status_code = status_code
        self.iterations = iterations
        self.residual = residual
        self.trace = trace

    @property
    def status(self) -> Status:
        """Materialize the on-device status code as a Status enum."""
        return Status(int(self.status_code))

    @property
    def converged(self) -> bool:
        return int(self.status_code) in (
            Status.CONVERGENCE,
            Status.ALREADY_OPTIMIZED,
        )

    def __repr__(self):
        try:
            s = Status(int(self.status_code)).name
            it = int(self.iterations)
            res = float(self.residual)
            return f"SolveResult(status={s}, iterations={it}, residual={res:.6e})"
        except Exception:  # traced values
            return "SolveResult(<traced>)"


def _solve_result_flatten(r: SolveResult):
    return (r.x, r.status_code, r.iterations, r.residual, r.trace), None


def _solve_result_unflatten(_, children):
    return SolveResult(*children)


register_pytree_node(SolveResult, _solve_result_flatten, _solve_result_unflatten)


def real_dtype_of(dtype) -> Any:
    """The real dtype underlying ``dtype`` (c128 -> f64, f32 -> f32, ...)."""
    return jnp.finfo(dtype).dtype if not jnp.issubdtype(dtype, jnp.complexfloating) else (
        jnp.float64 if dtype == jnp.complex128 else jnp.float32
    )


def is_complex_dtype(dtype) -> bool:
    return jnp.issubdtype(jnp.dtype(dtype), jnp.complexfloating)
