"""Shared iteration harness: one compiled ``lax.while_loop`` per solve.

Every one of the reference's 17 engine functions repeats the same skeleton
(see e.g. ``src/lib/lcg.cpp:143-274``): merge params, form r0 = B - A x0,
then loop { progress callback -> epsilon test -> max-iteration test ->
recurrence update -> NaN scan }.  The reference runs that skeleton on the
host, syncing a device scalar back for every dot product in the CUDA backend
(lcg_cuda.cu:515-532) — its chief inefficiency.

Here the *entire* solve is a single XLA computation: the stopping tests,
status bookkeeping, optional monitor, residual trace and NaN guard all live
inside the ``while_loop`` carry, so no scalar ever crosses the host-device
boundary mid-solve.  Solvers plug in three pure functions:

    residual_fn(carry) -> float scalar      (reference lcg.cpp:208-209)
    step_fn(carry) -> carry                 (one recurrence update)
    x_of(carry) -> solution vector          (for the NaN scan / monitor)

Custom-loop solvers (BiCGSTAB2's mid-iteration check, TFQMR's half steps,
SPG's inner backtracking) build their own loops from the same helpers.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Optional

import jax
import jax.numpy as jnp
from jax import lax

from ..types import SolverParams, Status

Carry = Dict[str, Any]

# ---------------------------------------------------------------------------
# Distributed context
#
# When a solver is traced inside ``shard_map`` over a device mesh, every
# vector in its carry is a *local row shard* and every reduction must become
# a global one.  Rather than duplicating all 14 engines, the reduction
# helpers below consult a tracing-time context: ``with distributed("rows")``
# makes sq_norm/dot_u/dot_c/has_nan emit a ``lax.psum`` over the named mesh
# axis, and ``dim(v)`` report the *global* vector length.  This is the
# fused-reduction design of SURVEY §2.9: each iteration's adjacent dot
# products become psums that XLA coalesces.
# ---------------------------------------------------------------------------

_DIST_AXIS: list = []


@contextlib.contextmanager
def distributed(axis_name: str, logical_dim: Optional[int] = None):
    """Trace the enclosed solver as an SPMD program over mesh axis
    ``axis_name`` (vectors = local shards, reductions = psums).

    ``logical_dim`` is the true system size when rows were padded up to a
    multiple of the mesh size — the stopping metrics divide by it
    (lcg.cpp:186 divides by the user's N, not a padded N).
    """
    _DIST_AXIS.append((axis_name, logical_dim))
    try:
        yield
    finally:
        _DIST_AXIS.pop()


def dist_axis() -> Optional[str]:
    """The active mesh axis name, or None when tracing single-device."""
    return _DIST_AXIS[-1][0] if _DIST_AXIS else None


def _allreduce(s: jnp.ndarray) -> jnp.ndarray:
    ax = dist_axis()
    return lax.psum(s, ax) if ax is not None else s


# ---------------------------------------------------------------------------
# Batched (multi-RHS) context
#
# ``with batched()`` traces a solver over a stack of right-hand sides at
# once: vectors are (nrhs, n), reductions keep a (nrhs, 1) leading axis, and
# ``run_loop`` masks finished systems so they stop updating (naively letting
# a converged CG keep stepping divides 0/0 and poisons x with NaNs).  The
# iteration's launch and reduction count is unchanged; each kernel just
# carries nrhs times the work.  The reference has no
# multi-RHS story at all — solves are strictly one b at a time (lcg.h:61).
# ---------------------------------------------------------------------------

_BATCHED: list = []


@contextlib.contextmanager
def batched(nrhs: Optional[int] = None):
    """Trace the enclosed solver over a stack of right-hand sides.

    ``nrhs`` is only needed when the solve records a residual trace
    (``trace_len > 0``): :func:`init_trace` sizes the per-system trace
    matrix ``(nrhs, trace_len)`` from it.
    """
    _BATCHED.append(nrhs if nrhs is not None else True)
    try:
        yield
    finally:
        _BATCHED.pop()


def batch_active() -> bool:
    return bool(_BATCHED)


def batch_nrhs() -> Optional[int]:
    """The declared system count of the active batched context, if given."""
    if _BATCHED and _BATCHED[-1] is not True:
        return _BATCHED[-1]
    return None


# ---------------------------------------------------------------------------
# Mixed-precision reductions
#
# The reference's mixed-precision story is a whole duplicated float stack
# (clcg_cudaf.*); here storage dtype is already a parameter, and this
# context adds the complementary knob: accumulate dot products in a wider
# dtype (classically f32 storage + f64 accumulation) and cast the scalar
# back.  Activated by ``SolverParams.reduce_dtype``.
# ---------------------------------------------------------------------------

_REDUCE_DTYPE: list = []


@contextlib.contextmanager
def reduction_dtype(dt):
    _REDUCE_DTYPE.append(None if dt is None else jnp.dtype(dt))
    try:
        yield
    finally:
        _REDUCE_DTYPE.pop()


def _acc_dtype(value_dtype):
    if not _REDUCE_DTYPE or _REDUCE_DTYPE[-1] is None:
        return None
    return jnp.promote_types(value_dtype, _REDUCE_DTYPE[-1])


def dim(v: jnp.ndarray) -> int:
    """Global logical length of solve vector ``v`` (static).  Inside a
    distributed context: the declared logical dim, else local shard length
    times the mesh axis size.  Batched vectors are (nrhs, n)."""
    if _DIST_AXIS:
        ax, logical = _DIST_AXIS[-1]
        if logical is not None:
            return logical
        return v.shape[0] * lax.psum(1, ax)
    return v.shape[-1] if batch_active() else v.shape[0]


def real_residual(r_sq: jnp.ndarray, x_sq: jnp.ndarray, n: int, abs_diff: bool):
    """Real-domain stopping metric (lcg.cpp:186-209).

    relative: ||r||^2 / max(||x||^2, 1)   — NOTE: a ratio of *squared* norms.
    abs_diff: sqrt(||r||^2) / n
    """
    if abs_diff:
        return jnp.sqrt(r_sq) / n
    return r_sq / jnp.maximum(x_sq, 1.0)


def complex_residual(r_sq: jnp.ndarray, x_sq: jnp.ndarray, n: int, abs_diff: bool):
    """Complex-domain stopping metric (clcg.cpp:112-147).

    The reference squares the already-squared inner product:
    ``rk_square = |<r,r>|^2 = ||r||^4`` (clcg.cpp:120-121 via clcg_square),
    so the relative test compares ||r||^4 / max(||x||^4, 1) and the abs_diff
    test uses sqrt(||r||^4)/n = ||r||^2 / n.  ``r_sq``/``x_sq`` passed in are
    plain squared norms; the fourth powers are formed here so callers stay
    uniform across domains.
    """
    r4 = r_sq * r_sq
    x4 = x_sq * x_sq
    if abs_diff:
        return jnp.sqrt(r4) / n
    return r4 / jnp.maximum(x4, 1.0)


def _reduce_sum(v: jnp.ndarray) -> jnp.ndarray:
    """Sum over the solve dimension: scalar normally, (nrhs, 1) batched.
    Accumulates in the active mixed-precision dtype, cast back to the
    storage dtype so downstream arithmetic stays un-promoted."""
    acc = _acc_dtype(v.dtype)
    if batch_active():
        s = jnp.sum(v, axis=-1, keepdims=True, dtype=acc)
    else:
        s = jnp.sum(v, dtype=acc)
    return s.astype(v.dtype) if acc is not None else s


def sq_norm(v: jnp.ndarray) -> jnp.ndarray:
    """||v||^2 as a real scalar (complex-safe; global when distributed)."""
    if jnp.issubdtype(v.dtype, jnp.complexfloating):
        return _allreduce(_reduce_sum(v.real * v.real + v.imag * v.imag))
    return _allreduce(_reduce_sum(v * v))


def dot_u(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Unconjugated dot  sum_i a_i b_i  (reference ``clcg_dot``,
    lcg_complex.cpp:143-154; for real vectors equals ``lcg_dot``)."""
    return _allreduce(_reduce_sum(a * b))


def dot_c(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Conjugated inner product  sum_i conj(a_i) b_i  (reference
    ``clcg_inner``, lcg_complex.cpp:156-167)."""
    if jnp.issubdtype(a.dtype, jnp.complexfloating):
        return _allreduce(_reduce_sum(jnp.conj(a) * b))
    return _allreduce(_reduce_sum(a * b))


def has_nan(x: jnp.ndarray) -> jnp.ndarray:
    """Reference NaN scan ``m[i] != m[i]`` (lcg.cpp:247-253); global when
    distributed (any shard's NaN fails the solve everywhere, in lockstep);
    per-system (nrhs, 1) when batched."""
    if jnp.issubdtype(x.dtype, jnp.complexfloating):
        bad = jnp.isnan(x.real) | jnp.isnan(x.imag)
    else:
        bad = jnp.isnan(x)
    local = jnp.any(bad, axis=-1, keepdims=True) if batch_active() else jnp.any(bad)
    ax = dist_axis()
    if ax is not None:
        return lax.psum(local.astype(jnp.int32), ax) > 0
    return local


def init_trace(trace_len: int, dtype=jnp.float64):
    """Residual-trace buffer: ``(trace_len,)``, or per-system
    ``(nrhs, trace_len)`` inside a batched context (the progress contract
    of lcg.h:53-54, per right-hand side)."""
    if trace_len <= 0:
        return None
    if batch_active():
        nrhs = batch_nrhs()
        if nrhs is None:
            raise ValueError(
                "batched trace recording needs the system count: enter the "
                "context as harness.batched(nrhs=...) when trace_len > 0"
            )
        return jnp.zeros((nrhs, trace_len), dtype=dtype)
    return jnp.zeros((trace_len,), dtype=dtype)


def record_trace(trace, t, value):
    if trace is None:
        return None
    # mode="drop" discards out-of-range writes — no lax.cond needed.
    if trace.ndim == 2:
        # Per-system rows: t/value arrive as (nrhs, 1) mid-loop or (nrhs,)
        # after the post-loop reshape.
        nrhs = trace.shape[0]
        ti = jnp.reshape(t, (nrhs,))
        vi = jnp.reshape(value, (nrhs,)).astype(trace.dtype)
        return trace.at[jnp.arange(nrhs), ti].set(vi, mode="drop")
    return trace.at[t].set(value.astype(trace.dtype), mode="drop")


def run_loop(
    carry: Carry,
    *,
    residual_fn: Callable[[Carry], jnp.ndarray],
    step_fn: Callable[[Carry], Carry],
    x_of: Callable[[Carry], jnp.ndarray],
    params: SolverParams,
    monitor: Optional[Callable] = None,
    check_initial: bool = True,
) -> Carry:
    """Run the shared solve loop to completion.

    ``carry`` must contain integer ``t`` (iteration counter, starts at 0),
    int32 ``status`` (Status.RUNNING), float ``residual`` and optionally
    ``trace``.  Check order matches the reference loop (lcg.cpp:206-264):
    monitor -> convergence -> max-iterations, evaluated at the top of every
    iteration; the initial ALREADY_OPTIMIZED test (lcg.cpp:186-203) falls
    out as convergence at t == 0 (``finalize``).

    Performance shape: the loop body is *straight-line* — every exit test
    lives in the scalar-only ``cond_fn`` and the final status is
    reconstructed once after the loop.  ``lax.cond`` branches inside the
    body would serialize extra XLA computations per iteration, which costs
    far more than the arithmetic they guard.  The reference's
    per-iteration NaN scan (lcg.cpp:247-253) is replaced by NaN
    *propagation*: a NaN in the recurrence poisons the residual scalar,
    every comparison with it is False, the loop exits, and the post-loop
    classification reports NAN_VALUE — same exit iteration, zero cost in
    the hot path.
    """
    max_iter = params.effective_max_iterations()
    eps = params.epsilon
    tracing = carry.get("trace") is not None
    is_batched = batch_active()
    if is_batched:
        nrhs = x_of(carry).shape[0]
        carry = dict(carry, t=jnp.zeros((nrhs, 1), jnp.int32) + carry["t"])

    def top_checks(c):
        """(continue?, stop?, res) evaluated at the top of iteration t.
        Batched: all three are per-system (nrhs, 1)."""
        res = residual_fn(c)
        stop = (
            jnp.asarray(monitor(x_of(c), res, c["t"]))
            if monitor is not None
            else jnp.asarray(False)
        )
        hit_max = (params.max_iterations > 0) & (
            c["t"] + 1 > params.max_iterations
        )
        # NaN res compares False with everything -> loop exits on NaN too.
        keep_going = (res > eps) & ~stop & ~hit_max & (c["t"] <= max_iter)
        return keep_going, stop, res

    def cond_fn(c):
        kg = top_checks(c)[0]
        return jnp.any(kg) if is_batched else kg

    def body_fn(c):
        if tracing:
            c = dict(c, trace=record_trace(c["trace"], c["t"], residual_fn(c)))
        if not is_batched:
            c = dict(c, t=c["t"] + 1)
            return step_fn(c)
        # Batched: step everything, keep finished systems frozen — a
        # converged CG stepped further divides 0/0 and poisons x.
        alive = top_checks(c)[0]
        c2 = dict(c, t=c["t"] + alive.astype(jnp.int32))
        c2 = step_fn(c2)

        def mask(new, old):
            if not hasattr(new, "ndim") or new.ndim == 0:
                return new
            a = alive.reshape(alive.shape[:1] + (1,) * (new.ndim - 1))
            return jnp.where(a, new, old)

        return {k: mask(c2[k], c[k]) for k in c2}

    carry = lax.while_loop(cond_fn, body_fn, carry)

    # Post-loop: classify the exit exactly once.
    _, stop, res = top_checks(carry)
    nan = has_nan(x_of(carry)) | jnp.isnan(res)
    converged = res <= eps
    status = jnp.where(
        nan,
        int(Status.NAN_VALUE),
        jnp.where(
            stop,
            int(Status.STOP),
            jnp.where(
                converged, int(Status.CONVERGENCE),
                int(Status.REACHED_MAX_ITERATIONS),
            ),
        ),
    ).astype(jnp.int32)
    if is_batched:
        status = status.reshape(-1)
        res = res.reshape(-1)
        carry = dict(carry, t=carry["t"].reshape(-1))
    carry = dict(carry, status=status, residual=res)
    if tracing:
        carry["trace"] = record_trace(carry["trace"], carry["t"], res)
    return finalize(carry)


def finalize(carry: Carry) -> Carry:
    """Relabel convergence-at-t=0 as ALREADY_OPTIMIZED (lcg.cpp:186-203)."""
    carry["status"] = jnp.where(
        (carry["status"] == int(Status.CONVERGENCE)) & (carry["t"] == 0),
        int(Status.ALREADY_OPTIMIZED),
        carry["status"],
    ).astype(jnp.int32)
    return carry


def running_status() -> jnp.ndarray:
    return jnp.asarray(int(Status.RUNNING), dtype=jnp.int32)
