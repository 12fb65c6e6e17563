"""MINRES — minimal-residual iteration for symmetric (possibly indefinite)
systems.

Beyond the reference's method set: its only symmetric solver is CG, which
requires positive-definiteness; MINRES (Paige & Saunders 1975) minimizes
the residual over the same Krylov space for ANY symmetric A using a
three-term Lanczos recurrence plus Givens rotations — all scalar work,
one operator product and one fused reduction pair (alpha with the next
beta) per iteration, so its cost shape matches CG's.

The residual norm is tracked by the rotation recurrence (exact in exact
arithmetic), so the reference stopping rules apply unchanged.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..types import SolverParams
from . import harness as H


def pminres(A, b, x0=None, *, M, params=SolverParams(), monitor=None,
            trace_len=0):
    """Preconditioned MINRES (Paige–Saunders minres with an SPD
    preconditioner M applying M^{-1}).

    The tracked residual is the preconditioned one (||r||_{M^{-1}} via the
    phibar recurrence) — the quantity the method actually minimizes; the
    reference stopping rules are applied to it.
    """
    b = jnp.asarray(b)
    x = jnp.zeros_like(b) if x0 is None else jnp.asarray(x0, dtype=b.dtype)
    n = H.dim(b)
    apply_M = M.mv if hasattr(M, "mv") else M

    r1 = b - A.mv(x)
    y = apply_M(r1)
    beta1 = jnp.sqrt(H.dot_u(r1, y)).astype(b.dtype)
    zero = jnp.zeros_like(b)
    zf = jnp.zeros_like(beta1)

    carry = dict(
        x=x,
        r1=r1, r2=r1, y=y,
        w=zero, w2=zero,
        oldb=zf, beta=beta1, dbar=zf, epsln=zf,
        cs=zf - 1.0, sn=zf,
        phibar=beta1,
        rk_mod=beta1 * beta1,
        m_mod=jnp.maximum(H.sq_norm(x), 1.0),
        t=jnp.asarray(0, jnp.int32),
        status=H.running_status(),
        residual=jnp.asarray(0.0, b.real.dtype),
        trace=H.init_trace(trace_len, b.real.dtype),
    )

    def residual_fn(c):
        return H.real_residual(c["rk_mod"], c["m_mod"], n, params.abs_diff)

    def step_fn(c):
        beta = c["beta"]
        beta_safe = jnp.where(beta == 0, 1, beta)
        v = c["y"] / beta_safe
        y = A.mv(v)
        # Subtract the previous Lanczos direction from iteration 2 on.
        oldb_safe = jnp.where(c["oldb"] == 0, 1, c["oldb"])
        y = y - jnp.where(c["t"] >= 2, beta / oldb_safe, 0.0) * c["r1"]
        alfa = H.dot_u(v, y)
        y = y - (alfa / beta_safe) * c["r2"]
        r1, r2 = c["r2"], y
        y = apply_M(r2)
        oldb = beta
        beta_new = jnp.sqrt(H.dot_u(r2, y)).astype(b.dtype)

        # QR via Givens rotations.
        oldeps = c["epsln"]
        delta = c["cs"] * c["dbar"] + c["sn"] * alfa
        gbar = c["sn"] * c["dbar"] - c["cs"] * alfa
        epsln = c["sn"] * beta_new
        dbar = -c["cs"] * beta_new
        gamma = jnp.sqrt(gbar * gbar + beta_new * beta_new)
        gamma = jnp.where(gamma == 0, 1e-30, gamma)
        cs = gbar / gamma
        sn = beta_new / gamma
        phi = cs * c["phibar"]
        phibar = sn * c["phibar"]

        w1 = c["w2"]
        w2 = c["w"]
        w = (v - oldeps * w1 - delta * w2) / gamma
        x = c["x"] + phi * w
        return dict(
            c, x=x, r1=r1, r2=r2, y=y, w=w, w2=w2,
            oldb=oldb, beta=beta_new, dbar=dbar, epsln=epsln,
            cs=cs, sn=sn, phibar=phibar,
            rk_mod=(phibar * phibar).real.astype(c["rk_mod"].dtype),
            m_mod=jnp.maximum(H.sq_norm(x), 1.0),
        )

    return H.run_loop(
        carry,
        residual_fn=residual_fn,
        step_fn=step_fn,
        x_of=lambda c: c["x"],
        params=params,
        monitor=monitor,
    )


def minres(A, b, x0=None, *, params=SolverParams(), monitor=None, trace_len=0):
    """Solve ``A x = b`` with A symmetric (definite or indefinite)."""
    b = jnp.asarray(b)
    x = jnp.zeros_like(b) if x0 is None else jnp.asarray(x0, dtype=b.dtype)
    n = H.dim(b)

    r0 = b - A.mv(x)
    beta1 = jnp.sqrt(H.sq_norm(r0)).astype(b.dtype)
    safe = jnp.where(beta1 == 0, 1, beta1)
    v = r0 / safe
    zero = jnp.zeros_like(b)
    one = jnp.ones_like(beta1)

    carry = dict(
        x=x,
        v=v, v_prev=zero,
        w=zero, w_prev=zero,
        beta=beta1,
        eta=beta1,
        c=one, c_old=one,
        s=jnp.zeros_like(beta1), s_old=jnp.zeros_like(beta1),
        rk_mod=H.sq_norm(r0),
        m_mod=jnp.maximum(H.sq_norm(x), 1.0),
        t=jnp.asarray(0, jnp.int32),
        status=H.running_status(),
        residual=jnp.asarray(0.0, b.real.dtype),
        trace=H.init_trace(trace_len, b.real.dtype),
    )

    def residual_fn(c):
        return H.real_residual(c["rk_mod"], c["m_mod"], n, params.abs_diff)

    def step_fn(c):
        p = A.mv(c["v"])
        alpha = H.dot_u(c["v"], p)
        p = p - alpha * c["v"] - c["beta"] * c["v_prev"]
        beta_new = jnp.sqrt(H.sq_norm(p)).astype(b.dtype)

        # Apply the two previous Givens rotations to the new Lanczos column,
        # then compute the new rotation (Paige-Saunders recurrences).
        delta = c["c"] * alpha - c["c_old"] * c["s"] * c["beta"]
        rho1 = jnp.sqrt(delta * delta + beta_new * beta_new)
        rho2 = c["s"] * alpha + c["c_old"] * c["c"] * c["beta"]
        rho3 = c["s_old"] * c["beta"]
        rho1_safe = jnp.where(rho1 == 0, 1, rho1)
        c_new = delta / rho1_safe
        s_new = beta_new / rho1_safe

        w_new = (c["v"] - rho3 * c["w_prev"] - rho2 * c["w"]) / rho1_safe
        x = c["x"] + (c_new * c["eta"]) * w_new
        eta = -s_new * c["eta"]

        beta_safe = jnp.where(beta_new == 0, 1, beta_new)
        return dict(
            c,
            x=x,
            v=p / beta_safe, v_prev=c["v"],
            w=w_new, w_prev=c["w"],
            beta=beta_new,
            eta=eta,
            c=c_new, c_old=c["c"],
            s=s_new, s_old=c["s"],
            rk_mod=(eta * eta).real.astype(c["rk_mod"].dtype),
            m_mod=jnp.maximum(H.sq_norm(x), 1.0),
        )

    return H.run_loop(
        carry,
        residual_fn=residual_fn,
        step_fn=step_fn,
        x_of=lambda c: c["x"],
        params=params,
        monitor=monitor,
    )
