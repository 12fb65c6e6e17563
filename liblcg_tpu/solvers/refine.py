"""Mixed-precision iterative refinement: f64-accurate solves at ~f32 speed.

The reference's only mixed-precision story is a line-for-line float copy of
the complex library (``src/lib/clcg_cudaf.h/.cu`` — same algorithms, float
storage, no way back to double accuracy).  Where f64 costs more than f32
(half the bytes per vector for a bandwidth-bound solve, and fewer f64
FLOP/s on most accelerators), the answer is classical iterative
refinement (Wilkinson; the same loop behind GPU mixed-precision solvers):

    repeat:  r = b - A x          (working precision, e.g. f64)
             solve  A_lo d = r    (fast precision, e.g. f32 — any engine)
             x = x + d

Each refinement contracts the error by roughly the inner solve's relative
accuracy, so a handful of f32 solves + one f64 matvec each reaches full
f64 residual levels whenever cond(A) is comfortably below 1/eps_f32 —
while the heavy per-iteration work (SpMV, dots, axpys) all runs at f32
throughput.  The whole loop — outer refinement ``lax.while_loop``, inner
engine ``lax.while_loop`` — compiles into ONE XLA program: zero host
round-trips, one dispatch.

Stopping semantics mirror the library's reference-exact metric
(``lcg.cpp:186-209``): relative ``||r||^2 / max(||x||^2, 1)`` or
``abs_diff`` ``sqrt(||r||^2)/n``, evaluated in the working precision.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from ..operators import LinearOperator, aslinearoperator
from ..types import DEFAULT_PARAMS, SolverParams, SolveResult, Status
from . import harness as H
from . import real as _real

#: Inner engines eligible for refinement: unconstrained real-domain
#: methods (bounds-projected PG/SPG iterates are not linear corrections).
_INNER_ENGINES = {
    "cg": (_real.cg, False),
    "pcg": (_real.pcg, True),
    "cg_fused": (_real.cg_fused, False),
    "cg_pipelined": (_real.cg_pipelined, False),
    "pcg_pipelined": (_real.pcg_pipelined, True),
    "cgs": (_real.cgs, False),
    "bicgstab": (_real.bicgstab, False),
    "bicgstab2": (_real.bicgstab2, False),
}

_JIT_CACHE: dict = {}


def _default_inner_params(outer: SolverParams, lo: jnp.dtype) -> SolverParams:
    """Inner tolerance: push each correction to (near) the fast dtype's
    certification floor.  The metric is a *squared*-norm ratio, so the
    floor sits around eps_dtype^2 — 1.4e-14 for f32 (default 1e-12,
    contracting the true residual ~1e-6 per refinement), ~6e-5 for bf16
    (default 6e-3, ~6e-2 per refinement: more refinements, but each
    iteration moves half the HBM bytes).  Sub-f32 dtypes accumulate
    their dots in f32 (`reduce_dtype`) — bf16's 8-bit mantissa cannot
    sum millions of terms."""
    u2 = float(jnp.finfo(lo).eps) ** 2
    eps = max(100.0 * u2, 1e-24)
    sub_f32 = jnp.finfo(lo).bits < 32
    return SolverParams(
        epsilon=eps,
        max_iterations=outer.max_iterations,
        abs_diff=False,
        reduce_dtype="float32" if sub_f32 else None,
    )



def solve_refined(
    A,
    b,
    x0=None,
    *,
    method: str = "cg",
    M=None,
    params: SolverParams = DEFAULT_PARAMS,
    inner_dtype=jnp.float32,
    inner_params: Optional[SolverParams] = None,
    max_refinements: int = 8,
    A_low: Optional[LinearOperator] = None,
    M_low=None,
    trace_len: int = 0,
    lmin=None,
    lmax=None,
    s: int = 4,
    check: bool = False,
) -> SolveResult:
    """Solve ``A x = b`` to working-precision accuracy via mixed-precision
    iterative refinement (inner solves at ``inner_dtype``).

    ``method="cacg"`` runs the s-step engine inside the refinement loop
    (``s``/``lmin``/``lmax`` as in :func:`liblcg_tpu.solve`; bounds
    default to Gershgorin of ``A``).

    Parameters
    ----------
    A : LinearOperator (or array) in the working precision (e.g. f64).
    b : 1-D right-hand side; its dtype is the working precision.
    method : inner engine ("cg", "pcg", "cgs", "bicgstab", ...).
    M : preconditioner in working precision; cast to the inner dtype
        automatically (or pass ``M_low`` explicitly).
    params : outer stopping parameters — reference metric and epsilon
        evaluated on the TRUE residual in working precision.
    inner_dtype : the fast storage/compute dtype (default float32).
    inner_params : inner engine tolerance; defaults to the fast dtype's
        certification floor (see ``_default_inner_params``).
    max_refinements : outer-iteration cap.
    A_low, M_low : optional explicit low-precision operator/preconditioner
        (required for matrix-free operators without ``astype``).
    trace_len : if > 0, record the outer residual metric per refinement.

    Returns
    -------
    SolveResult — ``iterations`` counts TOTAL inner iterations across all
    refinements (the cost-comparable number); ``trace`` (when requested)
    holds one outer-metric entry per refinement, so its filled length is
    the refinement count.
    """
    from ..solve import canonical_method

    m = canonical_method(method)
    if m not in _INNER_ENGINES and m != "cacg":
        raise ValueError(
            f"solve_refined supports the unconstrained real engines "
            f"{sorted(_INNER_ENGINES) + ['cacg']}; got {m!r}.  For "
            "complex systems realify the operator first (PARITY.md "
            "decision tree)."
        )
    b = jnp.asarray(b)
    if jnp.issubdtype(b.dtype, jnp.complexfloating):
        raise ValueError(
            "solve_refined is real-domain; realify the complex system "
            "first (operators.realify / realify_coo)"
        )
    if b.ndim != 1:
        return SolveResult(
            x=b, status_code=jnp.asarray(
                int(Status.INVALID_VARIABLE_SIZE), jnp.int32),
            iterations=jnp.asarray(0, jnp.int32),
            residual=jnp.asarray(jnp.nan), trace=None)
    A = A if isinstance(A, LinearOperator) else aslinearoperator(
        A, n=b.shape[0], dtype=b.dtype)

    if m == "cacg":
        # s-step inner engine (the multi-chip composition — f64-class
        # accuracy at cacg's s-fold collective economy).  Resolved
        # through solve._resolve_engine so the partial is CACHED (a
        # fresh partial per call would defeat _JIT_CACHE — measured: a
        # full retrace per solve), and lmin/lmax/s pass through for
        # operators Gershgorin cannot bound.
        from ..solve import _resolve_engine

        fn, needs_M, _ = _resolve_engine("cacg", False, A=A, lmin=lmin,
                                         lmax=lmax, s=s)
    else:
        fn, needs_M = _INNER_ENGINES[m]
    if M is not None and not needs_M:
        raise ValueError(
            f"method {m!r} does not use a preconditioner; M would be "
            "silently ignored (use 'pcg' or drop M)")
    if needs_M and M is None and M_low is None:
        return SolveResult(
            x=jnp.zeros_like(b) if x0 is None else jnp.asarray(x0),
            status_code=jnp.asarray(
                int(Status.NULL_PRECONDITION_MATRIX), jnp.int32),
            iterations=jnp.asarray(0, jnp.int32),
            residual=jnp.asarray(jnp.nan), trace=None)

    lo = jnp.dtype(inner_dtype)
    if A_low is None:
        A_low = A.astype(lo)
    if needs_M and M_low is None:
        cast = getattr(M, "astype", None)
        if cast is None:
            raise ValueError(
                f"{type(M).__name__} has no astype; pass M_low= explicitly")
        M_low = cast(lo)
    if inner_params is None:
        inner_params = _default_inner_params(params, lo)
    err = params.validate(for_method=m)
    if err is not None:
        return SolveResult(
            x=jnp.zeros_like(b) if x0 is None else jnp.asarray(x0),
            status_code=jnp.asarray(int(err), jnp.int32),
            iterations=jnp.asarray(0, jnp.int32),
            residual=jnp.asarray(jnp.nan), trace=None)

    key = (fn, params, inner_params, int(max_refinements), int(trace_len),
           str(lo), needs_M)
    jitted = _JIT_CACHE.get(key)
    if jitted is None:
        jitted = jax.jit(_build_ir(
            fn, params, inner_params, int(max_refinements),
            int(trace_len), lo, needs_M))
        _JIT_CACHE[key] = jitted

    x0_arr = jnp.zeros_like(b) if x0 is None else jnp.asarray(x0, b.dtype)
    extras = (M_low,) if needs_M else ()
    carry = jitted(A, A_low, b, x0_arr, *extras)
    result = SolveResult(
        x=carry["x"], status_code=carry["status"],
        iterations=carry["total_t"], residual=carry["res"],
        trace=carry.get("trace"),
    )
    if check:
        from ..utils.errors import check_status

        check_status(result.status_code, raise_error=True, quiet=True)
    return result


def _build_ir(fn, params, inner_params, max_refinements, trace_len, lo,
              needs_M):
    """Compile-time builder: the whole refinement loop as one XLA program."""

    def run(A, A_low, b, x0, *extras):
        M_low = extras[0] if needs_M else None
        n = H.dim(b)
        hi = b.dtype

        def metric(r_sq, x_sq):
            return H.real_residual(r_sq, x_sq, n, params.abs_diff)

        def inner_solve(r_lo):
            kwargs = dict(params=inner_params)
            if needs_M:
                kwargs["M"] = M_low
            with H.reduction_dtype(inner_params.reduce_dtype):
                c = fn(A_low, r_lo, None, **kwargs)
            return c["x"], c["t"]

        r0 = b - A.mv(x0)
        res0 = metric(H.sq_norm(r0), jnp.maximum(H.sq_norm(x0), 1.0))
        carry = dict(
            x=x0,
            r=r0,
            res=res0,
            k=jnp.asarray(0, jnp.int32),
            total_t=jnp.asarray(0, jnp.int32),
            stall=jnp.asarray(0, jnp.int32),
            status=jnp.where(
                jnp.isnan(res0), int(Status.NAN_VALUE),
                jnp.where(res0 <= params.epsilon, int(Status.CONVERGENCE),
                          int(Status.RUNNING))).astype(jnp.int32),
            trace=H.init_trace(trace_len, b.real.dtype),
        )

        def cond_fn(c):
            return c["status"] == int(Status.RUNNING)

        def body_fn(c):
            # Scale the residual to unit 2-norm before the downcast so the
            # fast dtype's full relative precision applies at every outer
            # residual magnitude (classical IR practice).
            s = jnp.sqrt(H.sq_norm(c["r"]))
            safe = jnp.where(s > 0, s, 1.0).astype(hi)
            d_lo, t_in = inner_solve((c["r"] / safe).astype(lo))
            x_new = c["x"] + d_lo.astype(hi) * safe
            r_new = b - A.mv(x_new)
            res_new = metric(H.sq_norm(r_new),
                             jnp.maximum(H.sq_norm(x_new), 1.0))

            improved = res_new < c["res"]
            # Keep the best iterate: a stalled correction (cond(A) at the
            # fast dtype's limit) must not damage a converged-enough x.
            x = jnp.where(improved, x_new, c["x"])
            r = jnp.where(improved, r_new, c["r"])
            res = jnp.where(improved, res_new, c["res"])
            stall = jnp.where(improved, 0, c["stall"] + 1)
            k = c["k"] + 1

            nan = jnp.isnan(res_new) | H.has_nan(d_lo)
            status = jnp.where(
                nan, int(Status.NAN_VALUE),
                jnp.where(
                    res <= params.epsilon, int(Status.CONVERGENCE),
                    jnp.where(
                        (k >= max_refinements) | (stall >= 2),
                        int(Status.REACHED_MAX_ITERATIONS),
                        int(Status.RUNNING)))).astype(jnp.int32)
            trace = H.record_trace(c["trace"], c["k"], res_new)
            return dict(
                x=x, r=r, res=res, k=k,
                total_t=c["total_t"] + t_in.astype(jnp.int32),
                stall=stall, status=status, trace=trace,
            )

        out = lax.while_loop(cond_fn, body_fn, carry)
        # Converged before any refinement -> the reference's
        # ALREADY_OPTIMIZED relabel (harness.finalize semantics).
        out["status"] = jnp.where(
            (out["status"] == int(Status.CONVERGENCE)) & (out["k"] == 0),
            int(Status.ALREADY_OPTIMIZED), out["status"]).astype(jnp.int32)
        return out

    return run



def solve_refined_batched(
    A,
    B,
    X0=None,
    *,
    method: str = "cg",
    M=None,
    params: SolverParams = DEFAULT_PARAMS,
    inner_dtype=jnp.float32,
    inner_params: Optional[SolverParams] = None,
    max_refinements: int = 8,
    A_low: Optional[LinearOperator] = None,
    M_low=None,
    check: bool = False,
) -> SolveResult:
    """Multi-RHS mixed-precision iterative refinement.

    Solves ``A X[i] = B[i]`` for a stack of right-hand sides ``B`` of
    shape (nrhs, n): the outer working-precision correction loop runs
    all systems in lockstep (per-system freezing — converged systems
    stop updating and stop counting), while the fast-dtype inner
    correction solves run through the batched engine.  Per-system statuses,
    residuals and total inner-iteration counts come back as arrays, the
    same contract as :func:`liblcg_tpu.solve_batched`.
    """
    from ..solve import canonical_method

    m = canonical_method(method)
    if m not in _INNER_ENGINES:
        raise ValueError(
            f"solve_refined_batched supports the unconstrained real "
            f"engines {sorted(_INNER_ENGINES)}; got {m!r}")
    B = jnp.asarray(B)
    if B.ndim != 2:
        raise ValueError(f"B must be (nrhs, n), got {B.shape}")
    if jnp.issubdtype(B.dtype, jnp.complexfloating):
        raise ValueError("solve_refined_batched is real-domain")
    A = A if isinstance(A, LinearOperator) else aslinearoperator(
        A, n=B.shape[1], dtype=B.dtype)
    fn, needs_M = _INNER_ENGINES[m]
    if M is not None and not needs_M:
        raise ValueError(f"method {m!r} does not use a preconditioner")
    if needs_M and M is None and M_low is None:
        return SolveResult(
            x=jnp.zeros_like(B) if X0 is None else jnp.asarray(X0),
            status_code=jnp.full((B.shape[0],), int(
                Status.NULL_PRECONDITION_MATRIX), jnp.int32),
            iterations=jnp.zeros((B.shape[0],), jnp.int32),
            residual=jnp.full((B.shape[0],), jnp.nan), trace=None)
    err = params.validate(for_method=m)
    if err is not None:
        return SolveResult(
            x=jnp.zeros_like(B) if X0 is None else jnp.asarray(X0),
            status_code=jnp.full((B.shape[0],), int(err), jnp.int32),
            iterations=jnp.zeros((B.shape[0],), jnp.int32),
            residual=jnp.full((B.shape[0],), jnp.nan), trace=None)

    lo = jnp.dtype(inner_dtype)
    if A_low is None:
        A_low = A.astype(lo)
    if needs_M and M_low is None:
        cast = getattr(M, "astype", None)
        if cast is None:
            raise ValueError(
                f"{type(M).__name__} has no astype; pass M_low= explicitly")
        M_low = cast(lo)
    if inner_params is None:
        inner_params = _default_inner_params(params, lo)

    nrhs = int(B.shape[0])
    key = ("batched", fn, params, inner_params, int(max_refinements),
           str(lo), needs_M, nrhs)
    jitted = _JIT_CACHE.get(key)
    if jitted is None:
        jitted = jax.jit(_build_ir_batched(
            fn, params, inner_params, int(max_refinements), lo, needs_M,
            nrhs))
        _JIT_CACHE[key] = jitted

    X0_arr = jnp.zeros_like(B) if X0 is None else jnp.asarray(X0, B.dtype)
    extras = (M_low,) if needs_M else ()
    carry = jitted(A, A_low, B, X0_arr, *extras)
    result = SolveResult(
        x=carry["x"], status_code=carry["status"],
        iterations=carry["total_t"], residual=carry["res"],
        trace=None,
    )
    if check:
        from ..utils.errors import check_status

        for s in np.asarray(result.status_code):
            check_status(s, raise_error=True, quiet=True)
    return result


def _build_ir_batched(fn, params, inner_params, max_refinements, lo,
                      needs_M, nrhs):
    """Batched compile-time builder: lockstep refinement with per-system
    freezing, one XLA program."""

    def run(A, A_low, B, X0, *extras):
        from ..solve import _VmappedOperator

        M_low = extras[0] if needs_M else None
        with H.batched():
            n = H.dim(B)
            hi = B.dtype
            A_v = _VmappedOperator(A)
            Al_v = _VmappedOperator(A_low)
            if M_low is None:
                Ml_v = None
            elif isinstance(M_low, LinearOperator):
                Ml_v = _VmappedOperator(M_low)
            else:                      # bare callable: map per system
                Ml_v = lambda V: jax.vmap(M_low)(V)  # noqa: E731

            def metric(r_sq, x_sq):
                return H.real_residual(r_sq, x_sq, n, params.abs_diff)

            def inner_solve(R_lo):
                kwargs = dict(params=inner_params)
                if needs_M:
                    kwargs["M"] = Ml_v
                with H.reduction_dtype(inner_params.reduce_dtype):
                    c = fn(Al_v, R_lo, None, **kwargs)
                return c["x"], c["t"]

            R0 = B - A_v.mv(X0)
            res0 = metric(H.sq_norm(R0), jnp.maximum(H.sq_norm(X0), 1.0))
            carry = dict(
                x=X0,
                r=R0,
                res=res0,                              # (nrhs, 1)
                k=jnp.asarray(0, jnp.int32),
                total_t=jnp.zeros((nrhs,), jnp.int32),
                stall=jnp.zeros((nrhs, 1), jnp.int32),
                status=jnp.where(
                    jnp.isnan(res0), int(Status.NAN_VALUE),
                    jnp.where(res0 <= params.epsilon,
                              int(Status.CONVERGENCE),
                              int(Status.RUNNING))).astype(jnp.int32),
            )

            def cond_fn(c):
                return jnp.any(c["status"] == int(Status.RUNNING))

            def body_fn(c):
                runm = c["status"] == int(Status.RUNNING)   # (nrhs, 1)
                s = jnp.sqrt(H.sq_norm(c["r"]))
                safe = jnp.where(s > 0, s, 1.0).astype(hi)
                D_lo, t_in = inner_solve((c["r"] / safe).astype(lo))
                x_new = c["x"] + D_lo.astype(hi) * safe
                r_new = B - A_v.mv(x_new)
                res_new = metric(H.sq_norm(r_new),
                                 jnp.maximum(H.sq_norm(x_new), 1.0))

                improved = res_new < c["res"]
                take = improved & runm
                x = jnp.where(take, x_new, c["x"])
                r = jnp.where(take, r_new, c["r"])
                res = jnp.where(take, res_new, c["res"])
                stall = jnp.where(
                    runm, jnp.where(improved, 0, c["stall"] + 1),
                    c["stall"])
                k = c["k"] + 1

                nan = (jnp.isnan(res_new)
                       | jnp.any(jnp.isnan(D_lo), axis=-1, keepdims=True))
                status_new = jnp.where(
                    nan, int(Status.NAN_VALUE),
                    jnp.where(
                        res <= params.epsilon, int(Status.CONVERGENCE),
                        jnp.where(
                            (k >= max_refinements) | (stall >= 2),
                            int(Status.REACHED_MAX_ITERATIONS),
                            int(Status.RUNNING)))).astype(jnp.int32)
                status = jnp.where(runm, status_new, c["status"])
                total_t = c["total_t"] + jnp.where(
                    runm[:, 0], t_in.astype(jnp.int32), 0)
                return dict(x=x, r=r, res=res, k=k, total_t=total_t,
                            stall=stall, status=status)

            out = lax.while_loop(cond_fn, body_fn, carry)
            status = jnp.where(
                (out["status"] == int(Status.CONVERGENCE))
                & (out["total_t"][:, None] == 0),
                int(Status.ALREADY_OPTIMIZED), out["status"]).astype(
                    jnp.int32)
            return dict(x=out["x"], r=out["r"], res=out["res"][:, 0],
                        k=out["k"], total_t=out["total_t"],
                        stall=out["stall"], status=status[:, 0])

    return run
