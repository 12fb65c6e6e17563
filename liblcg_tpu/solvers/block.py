"""Block conjugate gradient: one shared Krylov space for a stack of RHS.

The reference is strictly single-RHS (``lcg.h:61`` — one ``B`` per call) and
our ``solve_batched`` path solves a stack *independently* (vmapped
recurrences, per-system scalars).  Block CG (O'Leary 1980, "The block
conjugate gradient algorithm and related methods") goes further: all
right-hand sides share one block Krylov space, so every iteration expands
the search space by ``s`` directions at once and the iteration count drops
roughly with the effective condition number ``lambda_max / lambda_s`` —
the block "deflates" the ``s-1`` smallest eigenvalues.

This is also the one algorithm family in the package whose per-iteration
arithmetic is *matmul-shaped*: the Gram matrices ``P A Pᵀ`` and ``Z Rᵀ``
are (s, n) x (n, s) contractions and the vector updates are (s, s) x (s, n)
products — matrix-unit work, where batched CG's axpy/dot recurrences are
pure vector streams.  Whether the iteration reduction (14-38% at s=8-32 on
the tested spectra) covers the extra Gram and update passes has not been
measured on the GPU; prefer ``solve_batched(method="cg")`` unless the block
deflates an actual eigenvalue cluster (≳2x fewer iterations).

Recurrence (preconditioned; rows of the (s, n) matrices are systems):

    R0 = B - A X0;  Z0 = M⁻¹ R0;  P0 = Z0
    loop:  Q  = A Pk
           Wk = Pk Qᵀ                    (s x s, SPD on the active block)
           αk = Wk⁻¹ (Zk Rkᵀ)            (block step sizes)
           Xk+1 = Xk + αkᵀ Pk
           Rk+1 = Rk - αkᵀ Q
           Zk+1 = M⁻¹ Rk+1
           βk = (Zk Rkᵀ)⁻¹ (Zk+1 Rk+1ᵀ)  (block conjugation)
           Pk+1 = Zk+1 + βkᵀ Pk

Robustness: the classic algorithm breaks down when residual rows become
linearly dependent (duplicate RHS, or one system converging ahead of the
rest).  Both s x s solves are guarded the same way:

- **converged systems are frozen by masking**: their R/Z/P rows are zeroed
  before the Gram products, and the masked diagonal entries of ``W``/``Γ``
  are set to 1, so the solves return exactly-zero step rows/columns for
  frozen systems — their X rows stop moving, bit-for-bit, while their stale
  directions no longer pollute the active block;
- **a relative Tikhonov jitter** ``δ = 32·eps(f32)·max(diag)`` (f32 scale
  for every working dtype — see ``_GUARD_EPS``) absorbs rank deficiency
  *within* the active block (e.g. duplicated right-hand sides): the
  jittered solve splits the step across the dependent directions instead
  of dividing by ~0.  This is the bounded-cost alternative to full
  rank-revealing deflation (BFBCG, Ji & Li 2017).

Stopping semantics, status codes and the check order match the batched
harness exactly (reference loop lcg.cpp:206-264): per-system metric
``‖r‖²/max(‖x‖²,1)`` (or ``√‖r‖²/n`` in abs_diff mode), monitor →
convergence → max-iterations evaluated at the top, NaN classified after
the loop.  Gram reductions honour ``harness.distributed`` (one psum per
Gram) and ``SolverParams.reduce_dtype`` (wide accumulation via
``preferred_element_type``).
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

from ..types import SolverParams, Status
from . import harness as H


#: Every matmul in this engine runs at HIGHEST precision: a default f32
#: matmul may multiply in reduced precision (TF32 on GPUs, bf16 passes on
#: other accelerators), which poisons the Gram matrices (the step
#: equations' coefficients) and stalls the Newton-Schulz inverse below its
#: tolerance — seen as outright f32 convergence failure where true f32
#: matmuls converge.
_PREC = lax.Precision.HIGHEST


def _mm(a: jnp.ndarray, b: jnp.ndarray, pet=None) -> jnp.ndarray:
    if pet is not None:
        # Widen the operands rather than only the result: GPU GEMMs take
        # no mixed f32 x f32 -> f64 contraction.
        a, b = a.astype(pet), b.astype(pet)
    return jnp.matmul(a, b, precision=_PREC)


def _gram(Ablk: jnp.ndarray, Bblk: jnp.ndarray) -> jnp.ndarray:
    """(s, n) x (n, s) Gram product ``Ablk @ Bblkᵀ`` — a matrix-unit contraction;
    accumulates in the active mixed-precision dtype and psums over the
    mesh axis when tracing distributed."""
    acc = H._acc_dtype(Ablk.dtype)
    g = _mm(Ablk, Bblk.T, pet=acc)
    if acc is not None:
        g = g.astype(Ablk.dtype)
    ax = H.dist_axis()
    return lax.psum(g, ax) if ax is not None else g


def _mask_guard(W: jnp.ndarray, alive: jnp.ndarray) -> jnp.ndarray:
    """Prepare a masked Gram matrix for inversion: symmetrize (f32 Gram
    products drift slightly asymmetric), pin the frozen diagonal to 1
    (unit equations with zero RHS give exactly-zero step entries for
    frozen systems), and add a relative Tikhonov jitter that absorbs rank
    deficiency inside the active block (duplicate/dependent RHS)."""
    s = W.shape[0]
    Wm = 0.5 * (W + W.T)
    dead = 1.0 - alive.reshape(-1).astype(W.dtype)
    delta = _GUARD_EPS * jnp.max(jnp.abs(jnp.diag(Wm)))
    return Wm + (dead + delta) * jnp.eye(s, dtype=W.dtype)


#: The jitter scale is f32's, for EVERY working dtype: it bounds the
#: guarded matrices' condition number at ~1/(32 eps_f32) ~ 3e5, keeping
#: the Newton-Schulz sweep count small and f32-dtype solves resolvable.
#: Near convergence the block's residual rows ALWAYS become
#: near-dependent, so the near-singular case is the steady state, not
#: the exception.  The cost is a ~4e-6-relative perturbation of the step
#: equations on the most-dependent directions — the same directions
#: rank-revealing deflation (BFBCG) would drop outright.
_GUARD_EPS = 32.0 * float(jnp.finfo(jnp.float32).eps)

#: Newton-Schulz sweep cap: with the linear-spectrum init the residual
#: eigenvalue for the lowest mode is 1 - 1/(kappa s); reaching tol takes
#: ~log2(kappa * s * ln(1/tol)) sweeps ~ 31 at the guard bound for
#: s = 64, f64 tol.  48 leaves margin.
_NS_SWEEPS = 48


def _ns_inverse(Ws: jnp.ndarray) -> jnp.ndarray:
    """Batched Newton-Schulz inverse of a stack of guarded SPD matrices:
    ``X <- X (2I - W X)``, quadratically convergent.

    This replaces Cholesky + two triangular solves, which lower to long
    scalar-sequential chains inside the loop, with a chain of (s, s)
    matmuls with no data-dependent shapes.  Matrices must be pre-guarded by
    :func:`_mask_guard` (SPD, bounded condition number).

    Three properties keep the chain short and SAFE: Jacobi scaling
    ``W' = D^-1/2 W D^-1/2`` (unit diagonal — Gram matrices of blocks
    with heterogeneous row norms drop orders of magnitude in condition
    number); the SPD init ``X0 = I / ||W'||_inf``, under which the sweep
    residual's eigenvalues start at ``1 - λ/||W'||`` — *linear* in the
    condition number (the generic ``Wᵀ/(||W||_1 ||W||_inf)`` init squares
    the spectrum, and jitter-bounded modes then never converge in
    finite sweeps) — and stay in (0, 1), so the step matrices never
    overshoot (``X W`` eigenvalues remain in (0, 2) throughout: inverse
    error on the jitter-dominated modes is bounded, never amplifying);
    and an early exit on the sweep residual ``||I - W X||_F`` (reuses
    the sweep's own matmul), capped at the guard-bounded worst case.
    The chain runs in the working dtype (an f32 chain cannot resolve the
    guarded condition number's lowest modes).
    """
    s = Ws.shape[-1]
    dt = Ws.dtype
    eye = jnp.eye(s, dtype=dt)
    d = jnp.diagonal(Ws, axis1=-2, axis2=-1)                  # (k, s), > 0
    dis = lax.rsqrt(d)
    Wn = Ws * dis[..., :, None] * dis[..., None, :]

    norminf = jnp.max(jnp.sum(jnp.abs(Wn), axis=-1), axis=-1)  # (k,)
    X0 = eye / norminf[..., None, None]
    tol = jnp.asarray(4.0 * s * jnp.finfo(dt).eps, dt)

    def cond(c):
        k, _, r, r_prev = c
        # Exit on tolerance, the sweep cap, or a rounding floor: at the
        # jitter-bounded condition number the achievable residual floor
        # (~eps * kappa_guard) sits ABOVE tol, and without the stall
        # test every near-convergence iteration would burn the full cap
        # (r decreases strictly until the floor, so r >= r_prev is the
        # floor signature; the slow pre-quadratic phase still makes
        # strict progress every sweep).
        return (k < _NS_SWEEPS) & (r > tol) & (r < r_prev)

    def body(c):
        k, X, r, _ = c
        E = eye - _mm(Wn, X)
        r_new = jnp.max(jnp.sqrt(jnp.sum(E * E, axis=(-2, -1))))
        return k + 1, X + _mm(X, E), r_new, r

    _, X, _, _ = lax.while_loop(
        cond, body,
        (jnp.int32(0), X0, jnp.asarray(jnp.finfo(dt).max, dt),
         jnp.asarray(jnp.inf, dt)))
    # One polish sweep: the loop observes the PRE-sweep residual, so the
    # exit-time X is one squaring past the observation; polishing once
    # more squares it again.
    X = X + _mm(X, eye - _mm(Wn, X))
    return X * dis[..., :, None] * dis[..., None, :]


def block_cg(A, B, X0=None, *, M=None, params=SolverParams(), monitor=None,
             trace_len: int = 0):
    """Block (preconditioned) CG on ``A X_i = B_i`` for stacked rows of B.

    ``A.mv`` must map (s, n) -> (s, n) (the dispatcher wraps 1-D operators
    with its vmapped adapter).  ``M`` is an optional preconditioner applying
    M⁻¹ row-wise.  Returns the harness-shaped carry: per-system ``t``,
    ``status``, ``residual`` (all (s,)) and the (s, n) solution ``x``.
    """
    B = jnp.asarray(B)
    s = B.shape[0]
    X = jnp.zeros_like(B) if X0 is None else jnp.asarray(X0, dtype=B.dtype)
    n = B.shape[-1] if H.dist_axis() is None else H.dim(B[0])
    apply_M = (M.mv if hasattr(M, "mv") else M) if M is not None else None

    max_iter = params.effective_max_iterations()
    eps = params.epsilon

    R = B - A.mv(X)
    Z = apply_M(R) if apply_M is not None else R
    # Γ0 = Z Rᵀ is carried across iterations: freezing a system zeroes its
    # R/Z rows, which on Γ is a rank-structured row/col mask — re-masking
    # the carried (s, s) matrix replaces a full (s, n) Gram pass (and its
    # psum, when distributed) every iteration.
    carry = dict(
        x=X,
        R=R,
        P=Z,
        G=_gram(Z, R),
        t=jnp.zeros((s, 1), jnp.int32),
        status=H.running_status(),
        residual=jnp.zeros((s, 1), R.real.dtype),
        # Per-system residual trace rows, like every other batched path
        # (the lcg.h:53-54 progress contract per right-hand side).
        trace=(jnp.zeros((s, trace_len), R.real.dtype)
               if trace_len > 0 else None),
    )

    def row_sq(V):
        acc = H._acc_dtype(V.dtype)
        sq = jnp.sum(V * V, axis=-1, keepdims=True, dtype=acc)
        if acc is not None:
            sq = sq.astype(V.dtype)
        ax = H.dist_axis()
        return lax.psum(sq, ax) if ax is not None else sq

    def residual_fn(c):
        return H.real_residual(row_sq(c["R"]), jnp.maximum(row_sq(c["x"]), 1.0),
                               n, params.abs_diff)

    def top_checks(c):
        res = residual_fn(c)
        stop = (
            jnp.asarray(monitor(c["x"], res, c["t"]))
            if monitor is not None
            else jnp.asarray(False)
        )
        hit_max = (params.max_iterations > 0) & (
            c["t"] + 1 > params.max_iterations
        )
        keep_going = (res > eps) & ~stop & ~hit_max & (c["t"] <= max_iter)
        return keep_going, stop, res

    def cond_fn(c):
        return jnp.any(top_checks(c)[0])

    def body_fn(c):
        if c["trace"] is not None:
            c = dict(c, trace=H.record_trace(c["trace"], c["t"],
                                             residual_fn(c)))
        alive = top_checks(c)[0]                      # (s, 1) bool
        a = alive.astype(B.dtype)
        Rm = c["R"] * a
        Pm = c["P"] * a
        G = c["G"] * _mm(a, a.T)                      # Γk, masked rows/cols 0
        Q = A.mv(Pm)
        W = _gram(Pm, Q)
        # Both s x s systems of this iteration invert matrices known at
        # this point (W for the step, Γk for the conjugation) — one
        # batched Newton-Schulz chain serves both.
        inv = _ns_inverse(jnp.stack([_mask_guard(W, alive),
                                     _mask_guard(G, alive)]))
        alpha = _mm(inv[0], G)
        Xn = c["x"] + _mm(alpha.T, Pm)                # frozen rows: +0
        Rn = Rm - _mm(alpha.T, Q)
        Zn = apply_M(Rn) if apply_M is not None else Rn
        Gn = _gram(Zn, Rn)
        beta = _mm(inv[1], Gn)
        Pn = Zn + _mm(beta.T, Pm)
        # Frozen rows keep their converged values (the masked recurrence
        # leaves them at 0 — restore so the reported residual is the real
        # converged one, run_loop's mask(new, old) convention).  x too:
        # alpha's frozen columns are exactly zero in finite arithmetic,
        # but a NaN breakdown in an alive system would otherwise pollute
        # frozen solutions through NaN * 0.
        keep = lambda new, old: jnp.where(alive, new, old)
        return dict(
            c,
            x=keep(Xn, c["x"]),
            R=keep(Rn, c["R"]),
            P=keep(Pn, c["P"]),
            G=Gn,
            t=c["t"] + alive.astype(jnp.int32),
        )

    carry = lax.while_loop(cond_fn, body_fn, carry)

    # Post-loop classification, once (run_loop's batched epilogue).
    _, stop, res = top_checks(carry)
    bad = jnp.any(jnp.isnan(carry["x"]), axis=-1, keepdims=True)
    ax = H.dist_axis()
    if ax is not None:
        bad = lax.psum(bad.astype(jnp.int32), ax) > 0
    nan = bad | jnp.isnan(res)
    status = jnp.where(
        nan,
        int(Status.NAN_VALUE),
        jnp.where(
            stop,
            int(Status.STOP),
            jnp.where(
                res <= eps, int(Status.CONVERGENCE),
                int(Status.REACHED_MAX_ITERATIONS),
            ),
        ),
    ).astype(jnp.int32)
    if carry["trace"] is not None:
        carry = dict(carry, trace=H.record_trace(carry["trace"], carry["t"],
                                                 res))
    carry = dict(carry, status=status.reshape(-1), residual=res.reshape(-1),
                 t=carry["t"].reshape(-1))
    return H.finalize(carry)


def block_pcg(A, B, X0=None, *, M, params=SolverParams(), monitor=None,
              trace_len: int = 0):
    """Preconditioned block CG (see :func:`block_cg`)."""
    return block_cg(A, B, X0, M=M, params=params, monitor=monitor,
                    trace_len=trace_len)
