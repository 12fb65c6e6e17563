"""Restarted GMRES(m) — dtype-polymorphic (real and complex), batched-aware.

Beyond the reference's method set (its nonsymmetric story is the
BiCG/CGS/BiCGSTAB family); included because GMRES is the standard
nonsymmetric Krylov workhorse a production solver library is expected to
provide.  Accelerator shape: the Arnoldi orthogonalization is classical
Gram-Schmidt applied twice (CGS2 — the standard stability fix that turns
the inner products into two (m+1, n) x (n,) matmuls instead of j
sequential dots), the basis lives in a fixed (m+1, n) carry, and each
restart cycle is one step of the shared harness loop.

The least-squares problem is solved by the standard Givens-rotation QR of
the Hessenberg column by column (NOT the normal equations, which square
the condition number): each Arnoldi step applies the accumulated rotations
to its new column, computes one new rotation, and recurs the rotated
right-hand side — whose trailing entry |g[j+1]| IS the residual norm.
That recurred residual drives the reference stopping rule
(lcg.cpp:186-209) at *operator-product* granularity: the inner loop exits
the moment the tolerance is met, ``t``/``max_iterations`` count products
(like every other engine), and the true residual is still recomputed at
each cycle boundary so the outer check stays honest in finite precision.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

from ..types import SolverParams
from . import harness as H


def _vec_sum(v):
    """Sum over the vector (last) axis, keeping any leading axes; global
    when distributed and honoring the active mixed-precision reduction
    dtype (``SolverParams.reduce_dtype``), like every harness reduction."""
    acc = H._acc_dtype(v.dtype)
    s = jnp.sum(v, axis=-1, dtype=acc)
    if acc is not None:
        s = s.astype(v.dtype)
    ax = H.dist_axis()
    return lax.psum(s, ax) if ax is not None else s


def gmres(A, b, x0=None, *, restart: int = 32, M=None,
          params=SolverParams(), monitor=None, trace_len=0):
    """Solve ``A x = b`` with restarted GMRES(m), optionally right-
    preconditioned (``M`` applies M^{-1}; right preconditioning keeps the
    recurred residual equal to the TRUE residual b - A x, so the stopping
    semantics are unchanged).  Works on (n,) vectors and, under the
    batched context, on (nrhs, n) stacks."""
    b = jnp.asarray(b)
    x = jnp.zeros_like(b) if x0 is None else jnp.asarray(x0, dtype=b.dtype)
    n = H.dim(b)
    m = int(restart)
    is_cplx = jnp.issubdtype(b.dtype, jnp.complexfloating)
    rdt = b.real.dtype
    apply_M = (M.mv if hasattr(M, "mv") else M) if M is not None else None
    bshape = b.shape[:-1]          # () single, (nrhs,) batched
    max_iter = params.effective_max_iterations()

    def conj(v):
        return jnp.conj(v) if is_cplx else v

    def vdots(V, w):
        """[<V_k, w>]_k (conjugated) — shape (m+1,) + bshape."""
        return _vec_sum(conj(V) * w)

    def comb(V, h):
        """sum_k h[k] V[k] — shape bshape + (n_local,).  HIGHEST precision:
        this contraction lowers to a matmul, and a reduced-precision
        default (TF32 on GPUs) would perturb the assembled
        correction/basis at ~1e-3 (see ops/spmv.dense_mv)."""
        return jnp.einsum("k...,k...n->...n", h, V,
                          precision=lax.Precision.HIGHEST)

    def metric(r_sq, x_sq):
        """Reference stopping metric on squared norms (lcg.cpp:186-209)."""
        if params.abs_diff:
            return jnp.sqrt(r_sq) / n
        return r_sq / jnp.maximum(x_sq, 1.0)

    r0 = b - A.mv(x)
    carry = dict(
        x=x,
        rk_mod=H.sq_norm(r0),
        m_mod=jnp.maximum(H.sq_norm(x), 1.0),
        t=jnp.asarray(0, jnp.int32),
        status=H.running_status(),
        residual=jnp.asarray(0.0, rdt),
        trace=H.init_trace(trace_len, rdt),
    )

    def residual_fn(c):
        return H.real_residual(c["rk_mod"], c["m_mod"], n, params.abs_diff)

    def cycle(c):
        """One GMRES(m) cycle: Arnoldi + Givens QR, exiting at the first
        product whose recurred residual meets the tolerance."""
        x = c["x"]
        r = b - A.mv(x)
        beta_sq = H.sq_norm(r)                       # bshape + (1,) batched
        beta = jnp.sqrt(beta_sq).reshape(bshape)     # -> bshape
        beta_safe = jnp.where(beta == 0, 1, beta).astype(b.dtype)
        # ||x||^2 at cycle start drives the relative metric inside the
        # cycle (x only changes at cycle end).
        x_sq = jnp.maximum(H.sq_norm(x), 1.0).reshape(bshape)

        V0 = jnp.zeros((m + 1,) + b.shape, b.dtype)
        V0 = V0.at[0].set(r / beta_safe[..., None])
        R0 = jnp.zeros((m + 1, m) + bshape, b.dtype)
        cs0 = jnp.zeros((m,) + bshape, rdt)
        sn0 = jnp.zeros((m,) + bshape, b.dtype)
        g0 = jnp.zeros((m + 1,) + bshape, b.dtype)
        g0 = g0.at[0].set(beta.astype(b.dtype))
        phibar0 = beta                                # |g[j+1]| = ||r_j||

        # Product budget: t entering the cycle (harness pre-incremented by
        # one, so subtract it back out) — PER SYSTEM, so a batched system
        # is never capped earlier than the same system solved alone just
        # because a slower batchmate spent more products.  The hard
        # iteration cap bounds the inner loop too when max_iterations is
        # 0/unbounded.
        t_used = c["t"] - 1                          # bshape (or scalar)
        iter_limit = (params.max_iterations if params.max_iterations > 0
                      else max_iter)
        budget = jnp.maximum(iter_limit - t_used, 0).reshape(bshape)
        trace0 = c.get("trace")
        jconv0 = jnp.full(bshape, -1, jnp.int32)

        def inner_cond(s):
            V, R, cs, sn, g, phibar, j, trace, jconv = s
            live = (metric(phibar * phibar, x_sq) > params.epsilon) & (j < budget)
            return jnp.any(live) & (j < m)

        def inner_body(s):
            V, R, cs, sn, g, phibar, j, trace, jconv = s
            vj = V[j]
            z = apply_M(vj) if apply_M is not None else vj
            w = A.mv(z)
            # CGS2: two rounds of classical Gram-Schmidt, each one matmul
            # (unset basis rows are zero and contribute nothing).
            h1 = vdots(V, w)
            w = w - comb(V, h1)
            h2 = vdots(V, w)
            w = w - comb(V, h2)
            h = h1 + h2
            wnorm = jnp.sqrt(_vec_sum((w * conj(w)).real))      # bshape
            wnorm_safe = jnp.where(wnorm == 0, 1, wnorm).astype(b.dtype)
            V = V.at[j + 1].set(w / wnorm_safe[..., None])
            h = h.at[j + 1].set(wnorm.astype(b.dtype))

            # Apply the accumulated rotations to the new column.
            def rot_body(i, h):
                hi, hi1 = h[i], h[i + 1]
                ci, si = cs[i], sn[i]
                act = i < j
                new_hi = jnp.where(act, ci * hi + si * hi1, hi)
                new_hi1 = jnp.where(act, -conj(si) * hi + ci * hi1, hi1)
                return h.at[i].set(new_hi).at[i + 1].set(new_hi1)

            h = lax.fori_loop(0, m, rot_body, h)

            # New rotation zeroing h[j+1] (complex-safe; cs real).
            a_, b_ = h[j], h[j + 1]
            amod = jnp.abs(a_)
            rmod = jnp.sqrt(amod * amod + (b_ * conj(b_)).real)
            r_safe = jnp.where(rmod == 0, 1, rmod)
            cj = jnp.where(rmod == 0, 1.0, amod / r_safe).astype(rdt)
            phase = jnp.where(amod == 0, 1.0, a_ / jnp.where(amod == 0, 1, amod))
            sj = jnp.where(
                amod == 0,
                jnp.ones_like(b_),
                (phase * conj(b_) / r_safe).astype(b.dtype),
            )
            sj = jnp.where(rmod == 0, jnp.zeros_like(b_), sj)
            h = h.at[j].set((cj * a_ + sj * b_)).at[j + 1].set(jnp.zeros_like(b_))
            R = R.at[:, j].set(h)
            cs = cs.at[j].set(cj)
            sn = sn.at[j].set(sj)

            gj = g[j]
            g = g.at[j + 1].set(-conj(sj) * gj).at[j].set(cj * gj)
            phibar = jnp.abs(g[j + 1])
            res_j = metric(phibar * phibar, x_sq)
            # Per-product residual trace (same cadence as the other
            # engines; the outer harness records the cycle boundaries).
            # Batched: record_trace scatters per-system rows from the
            # per-system product counter c["t"] + j.
            if trace is not None:
                trace = H.record_trace(trace, c["t"] + j,
                                       res_j.astype(trace.dtype))
            # First product at which each system met the tolerance — the
            # per-system iteration count (matches a single solve even
            # when the batch keeps the cycle running for harder systems).
            # ... but only within the system's own product budget: a
            # system kept in the cycle by slower batchmates must not
            # report a convergence it was not entitled to reach (its
            # correction is budget-truncated in the back-substitution).
            jconv = jnp.where(
                (jconv < 0) & (res_j <= params.epsilon) & (j < budget),
                j + 1, jconv)
            return V, R, cs, sn, g, phibar, j + 1, trace, jconv

        V, R, cs, sn, g, phibar, j_taken, trace, jconv = lax.while_loop(
            inner_cond, inner_body,
            (V0, R0, cs0, sn0, g0, phibar0, jnp.asarray(0, jnp.int32),
             trace0, jconv0),
        )

        # Back-substitution on the rotated (upper-triangular) system.
        # Unused columns (>= j_taken) have zero rows -> safe unit diagonal
        # and zeroed rhs give y = 0 there.
        col = jnp.arange(m).reshape((m,) + (1,) * len(bshape))
        # Per-system truncation: a budget-exhausted system uses only the
        # first budget_i columns (its g entries below that index were
        # finalized by rotation budget_i-1, so this is exactly its own
        # budget_i-step correction even though batchmates kept rotating).
        g_m = jnp.where(col < jnp.minimum(j_taken, budget), g[:m], 0)
        y0 = jnp.zeros_like(g_m)

        def back_body(i, y):
            k = m - 1 - i
            acc = jnp.sum(R[k] * y, axis=0)
            diag = R[k, k]
            diag = jnp.where(diag == 0, 1, diag)
            return y.at[k].set((g_m[k] - acc) / diag)

        y = lax.fori_loop(0, m, back_body, y0)

        z = comb(V[:m], y)
        if apply_M is not None:
            z = apply_M(z)
        x = x + z
        rk = b - A.mv(x)                       # true residual, cycle boundary
        # Products charged per system: the product at which it converged,
        # or the cycle's products clamped to the system's own remaining
        # budget if it didn't (harness added 1 already).  The clamp
        # guarantees forward progress when the hard cap leaves a cycle no
        # product budget (j_taken == 0) — t then lands one past the cap,
        # the harness convention for a cap exit.
        spent = jnp.where(jconv >= 0, jconv, jnp.minimum(j_taken, budget))
        t = c["t"] + jnp.maximum(spent.reshape(c["t"].shape) - 1, 0)
        out = dict(
            c, x=x, t=t,
            rk_mod=H.sq_norm(rk),
            m_mod=jnp.maximum(H.sq_norm(x), 1.0),
        )
        if trace is not None:
            out["trace"] = trace
        return out

    return H.run_loop(
        carry,
        residual_fn=residual_fn,
        step_fn=cycle,
        x_of=lambda c: c["x"],
        params=params,
        monitor=monitor,
    )
