"""Real-domain Krylov engines: CG, PCG, CGS, BiCGSTAB, BiCGSTAB2, PG, SPG.

Each function reproduces the recurrence and the exact stopping semantics of
its reference counterpart in ``src/lib/lcg.cpp`` (citations inline) as a pure
JAX program: the whole iteration runs inside one ``lax.while_loop`` carry, so
there are no host round-trips and XLA fuses the axpy/dot updates around each
operator product.

All vectors are 1-D arrays of a common real dtype; the operator is anything
satisfying the ``LinearOperator`` protocol.  The preconditioner is likewise a
linear map ``M^{-1}`` applied through ``precond.apply`` (reference ``Mfp``
callback, lcg.h:44-45).
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

from ..types import SolverParams, Status
from . import harness as H


def _prep(A, b, x0):
    b = jnp.asarray(b)
    x = jnp.zeros_like(b) if x0 is None else jnp.asarray(x0, dtype=b.dtype)
    return A, b, x


def cg(A, b, x0=None, *, params=SolverParams(), monitor=None, trace_len=0):
    """Conjugate gradient (Hestenes–Stiefel).  Reference: ``lcg``
    lcg.cpp:143-274; 1 operator product and 2 reductions per iteration."""
    A, b, x = _prep(A, b, x0)
    n = H.dim(b)  # global length (psum-aware when sharded)

    Ax = A.mv(x)
    gk = Ax - b          # lcg.cpp:174 (gradient convention: g = Ax - B)
    dk = -gk
    carry = dict(
        x=x,
        gk=gk,
        dk=dk,
        gk_mod=H.sq_norm(gk),
        m_mod=jnp.maximum(H.sq_norm(x), 1.0),
        t=jnp.asarray(0, jnp.int32),
        status=H.running_status(),
        residual=jnp.asarray(0.0, gk.real.dtype),
        trace=H.init_trace(trace_len, b.real.dtype),
    )

    def residual_fn(c):
        return H.real_residual(c["gk_mod"], c["m_mod"], n, params.abs_diff)

    def step_fn(c):
        Adk = A.mv(c["dk"])
        dTAd = H.dot_u(c["dk"], Adk)             # lcg.cpp:234
        ak = c["gk_mod"] / dTAd
        x = c["x"] + ak * c["dk"]
        gk = c["gk"] + ak * Adk
        gk1_mod = H.sq_norm(gk)
        betak = gk1_mod / c["gk_mod"]            # lcg.cpp:256
        dk = betak * c["dk"] - gk
        return dict(
            c,
            x=x,
            gk=gk,
            dk=dk,
            gk_mod=gk1_mod,
            m_mod=jnp.maximum(H.sq_norm(x), 1.0),
        )

    carry = H.run_loop(
        carry,
        residual_fn=residual_fn,
        step_fn=step_fn,
        x_of=lambda c: c["x"],
        params=params,
        monitor=monitor,
    )
    return carry


def pcg(A, b, x0=None, *, M, params=SolverParams(), monitor=None, trace_len=0):
    """Preconditioned CG (Kaasschieter 1988 alg. 1).  Reference: ``lpcg``
    lcg.cpp:293-434.  ``M`` is a callable or operator applying M^{-1}."""
    A, b, x = _prep(A, b, x0)
    n = H.dim(b)  # global length (psum-aware when sharded)
    apply_M = M.mv if hasattr(M, "mv") else M

    Ax = A.mv(x)
    rk = b - Ax          # lcg.cpp:319 (residual convention: r = B - Ax)
    zk = apply_M(rk)
    carry = dict(
        x=x,
        rk=rk,
        zk=zk,
        dk=zk,
        rk_mod=H.sq_norm(rk),
        m_mod=jnp.maximum(H.sq_norm(x), 1.0),
        zTr=H.dot_u(zk, rk),
        t=jnp.asarray(0, jnp.int32),
        status=H.running_status(),
        residual=jnp.asarray(0.0, rk.real.dtype),
        trace=H.init_trace(trace_len, b.real.dtype),
    )

    def residual_fn(c):
        return H.real_residual(c["rk_mod"], c["m_mod"], n, params.abs_diff)

    def step_fn(c):
        Adk = A.mv(c["dk"])
        dTAd = H.dot_u(c["dk"], Adk)
        ak = c["zTr"] / dTAd                      # lcg.cpp:390
        x = c["x"] + ak * c["dk"]
        rk = c["rk"] - ak * Adk
        zk = apply_M(rk)
        zTr1 = H.dot_u(zk, rk)
        betak = zTr1 / c["zTr"]                   # lcg.cpp:415
        dk = zk + betak * c["dk"]
        return dict(
            c,
            x=x,
            rk=rk,
            zk=zk,
            dk=dk,
            rk_mod=H.sq_norm(rk),
            m_mod=jnp.maximum(H.sq_norm(x), 1.0),
            zTr=zTr1,
        )

    carry = H.run_loop(
        carry,
        residual_fn=residual_fn,
        step_fn=step_fn,
        x_of=lambda c: c["x"],
        params=params,
        monitor=monitor,
    )
    return carry


def _cg_pipelined(A, b, x0, M, params, monitor, trace_len):
    """Pipelined (communication-avoiding) preconditioned CG.

    Ghysels & Vanroose (2014): auxiliary recurrences put ALL of an
    iteration's inner products — gamma = (r, u), delta = (w, u), plus the
    ||r||^2 / ||x||^2 needed for the stopping metric — at a single fused
    reduction point.  Per iteration that is ONE operator product and ONE
    reduction region instead of CG's two dependent reduction points, which
    matters twice: on one device, launch latency bounds small solves;
    across a mesh, it halves the psum count per iteration.

    No reference counterpart (this variant exists because of hardware
    latency, not algebra); convergence matches CG in exact arithmetic, with
    the usual mild residual drift in finite precision.  Stopping semantics
    are the reference rules (lcg.cpp:186-209) applied to the recurred
    residual.
    """
    A, b, x = _prep(A, b, x0)
    n = H.dim(b)
    apply_M = (M.mv if hasattr(M, "mv") else M) if M is not None else (lambda v: v)

    r = b - A.mv(x)
    u = apply_M(r)
    w = A.mv(u)
    gamma = H.dot_u(r, u)
    delta = H.dot_u(w, u)
    rr = H.sq_norm(r)
    zero = jnp.zeros_like(b)
    carry = dict(
        x=x, r=r, u=u, w=w,
        z=zero, q=zero, s=zero, p=zero,
        gamma=gamma, delta=delta,
        alpha=jnp.asarray(0.0, gamma.dtype) + gamma / delta,
        beta=jnp.zeros_like(gamma),
        rk_mod=rr,
        m_mod=jnp.maximum(H.sq_norm(x), 1.0),
        t=jnp.asarray(0, jnp.int32),
        status=H.running_status(),
        residual=jnp.asarray(0.0, b.real.dtype),
        trace=H.init_trace(trace_len, b.real.dtype),
    )

    def residual_fn(c):
        return H.real_residual(c["rk_mod"], c["m_mod"], n, params.abs_diff)

    def step_fn(c):
        m_v = apply_M(c["w"])
        n_v = A.mv(m_v)                       # the iteration's one product
        beta, alpha = c["beta"], c["alpha"]
        z = n_v + beta * c["z"]
        q = m_v + beta * c["q"]
        s = c["w"] + beta * c["s"]
        p = c["u"] + beta * c["p"]
        x = c["x"] + alpha * p
        r = c["r"] - alpha * s
        u = c["u"] - alpha * q
        w = c["w"] - alpha * z
        # Single fused reduction point: all four dots in one region.
        gamma1 = H.dot_u(r, u)
        delta1 = H.dot_u(w, u)
        rr = H.sq_norm(r)
        xx = H.sq_norm(x)
        beta1 = gamma1 / c["gamma"]
        alpha1 = gamma1 / (delta1 - beta1 * gamma1 / alpha)
        return dict(
            c, x=x, r=r, u=u, w=w, z=z, q=q, s=s, p=p,
            gamma=gamma1, delta=delta1, alpha=alpha1, beta=beta1,
            rk_mod=rr, m_mod=jnp.maximum(xx, 1.0),
        )

    return H.run_loop(
        carry,
        residual_fn=residual_fn,
        step_fn=step_fn,
        x_of=lambda c: c["x"],
        params=params,
        monitor=monitor,
    )


def cg_fused(A, b, x0=None, *, params=SolverParams(), monitor=None, trace_len=0):
    """Chronopoulos–Gear CG: both inner products at one point, right after
    the product.

    Same Krylov iterates as classic CG, reorganized so each iteration is
    exactly TWO dependency steps — [p,s,x,r updates] then [w = A r with
    gamma = r.r, delta = r.w, ||x||^2 fused behind it] — versus CG's three
    (product+dot, update+dot, direction update), with only one extra carry
    vector.  The sweet spot between classic CG (fewest vectors, most
    serialized steps) and the Ghysels pipelined variant (fewest reduction
    points, most memory traffic).  Chronopoulos & Gear, J. Comp. Appl.
    Math. 25 (1989).  No reference counterpart.
    """
    A, b, x = _prep(A, b, x0)
    n = H.dim(b)

    r = b - A.mv(x)
    w = A.mv(r)
    gamma = H.dot_u(r, r)
    delta = H.dot_u(r, w)
    zero = jnp.zeros_like(b)
    carry = dict(
        x=x, r=r, w=w, p=zero, s=zero,
        gamma=gamma,
        alpha=gamma / delta,
        beta=jnp.zeros_like(gamma),
        m_mod=jnp.maximum(H.sq_norm(x), 1.0),
        t=jnp.asarray(0, jnp.int32),
        status=H.running_status(),
        residual=jnp.asarray(0.0, b.real.dtype),
        trace=H.init_trace(trace_len, b.real.dtype),
    )

    def residual_fn(c):
        return H.real_residual(c["gamma"], c["m_mod"], n, params.abs_diff)

    def step_fn(c):
        p = c["r"] + c["beta"] * c["p"]
        s = c["w"] + c["beta"] * c["s"]
        x = c["x"] + c["alpha"] * p
        r = c["r"] - c["alpha"] * s
        w = A.mv(r)
        gamma1 = H.dot_u(r, r)
        delta = H.dot_u(r, w)
        xx = H.sq_norm(x)
        beta1 = gamma1 / c["gamma"]
        alpha1 = gamma1 / (delta - beta1 * gamma1 / c["alpha"])
        return dict(
            c, x=x, r=r, w=w, p=p, s=s,
            gamma=gamma1, alpha=alpha1, beta=beta1,
            m_mod=jnp.maximum(xx, 1.0),
        )

    return H.run_loop(
        carry,
        residual_fn=residual_fn,
        step_fn=step_fn,
        x_of=lambda c: c["x"],
        params=params,
        monitor=monitor,
    )


def cg_pipelined(A, b, x0=None, *, params=SolverParams(), monitor=None, trace_len=0):
    """Unpreconditioned pipelined CG (see :func:`_cg_pipelined`)."""
    return _cg_pipelined(A, b, x0, None, params, monitor, trace_len)


def pcg_pipelined(A, b, x0=None, *, M, params=SolverParams(), monitor=None, trace_len=0):
    """Preconditioned pipelined CG (see :func:`_cg_pipelined`)."""
    return _cg_pipelined(A, b, x0, M, params, monitor, trace_len)


def chebyshev(A, b, x0=None, *, lmin, lmax, params=SolverParams(),
              monitor=None, trace_len=0):
    """Chebyshev iteration (Saad, Iterative Methods alg. 12.1).

    An addition with no reference counterpart: the recurrence uses
    NO inner products — the only reduction per iteration is the stopping
    metric itself, so the serialized-region count per iteration is the
    minimum possible for a monitored solve.  Requires an enclosing spectral
    interval [lmin, lmax] (see ``ops.spectra.gershgorin_bounds`` /
    ``power_bound``); convergence is geometric with the usual Chebyshev
    rate and, unlike CG, entirely insensitive to dot-product rounding.
    """
    A, b, x = _prep(A, b, x0)
    n = H.dim(b)
    lmin = jnp.asarray(lmin, b.real.dtype)
    lmax = jnp.asarray(lmax, b.real.dtype)
    theta = (lmax + lmin) / 2.0
    delta = (lmax - lmin) / 2.0
    sigma1 = theta / delta

    r = b - A.mv(x)
    carry = dict(
        x=x,
        r=r,
        d=r / theta,
        rho=1.0 / sigma1,
        rk_mod=H.sq_norm(r),
        m_mod=jnp.maximum(H.sq_norm(x), 1.0),
        t=jnp.asarray(0, jnp.int32),
        status=H.running_status(),
        residual=jnp.asarray(0.0, b.real.dtype),
        trace=H.init_trace(trace_len, b.real.dtype),
    )

    def residual_fn(c):
        return H.real_residual(c["rk_mod"], c["m_mod"], n, params.abs_diff)

    def step_fn(c):
        x = c["x"] + c["d"]
        r = c["r"] - A.mv(c["d"])
        rho1 = 1.0 / (2.0 * sigma1 - c["rho"])
        d = rho1 * c["rho"] * c["d"] + (2.0 * rho1 / delta) * r
        return dict(
            c, x=x, r=r, d=d, rho=rho1,
            rk_mod=H.sq_norm(r),
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


def cgs(A, b, x0=None, *, params=SolverParams(), monitor=None, trace_len=0):
    """Conjugate gradient squared (Fokkema 1996 alg. 2).  Reference: ``lcgs``
    lcg.cpp:437-612; 2 operator products per iteration, fixed shadow
    residual r0_T = r0 (lcg.cpp:483)."""
    A, b, x = _prep(A, b, x0)
    n = H.dim(b)  # global length (psum-aware when sharded)

    Ax = A.mv(x)
    rk = b - Ax
    carry = dict(
        x=x,
        rk=rk,
        r0T=rk,
        pk=rk,
        uk=rk,
        qk=jnp.zeros_like(rk),
        rkr0T=H.sq_norm(rk),   # dot(rk, r0T) with r0T == rk
        rk_mod=H.sq_norm(rk),
        m_mod=jnp.maximum(H.sq_norm(x), 1.0),
        t=jnp.asarray(0, jnp.int32),
        status=H.running_status(),
        residual=jnp.asarray(0.0, rk.real.dtype),
        trace=H.init_trace(trace_len, b.real.dtype),
    )

    def residual_fn(c):
        return H.real_residual(c["rk_mod"], c["m_mod"], n, params.abs_diff)

    def step_fn(c):
        Apk = A.mv(c["pk"])
        AprT = H.dot_u(Apk, c["r0T"])             # lcg.cpp:548-552
        ak = c["rkr0T"] / AprT
        qk = c["uk"] - ak * Apk
        wk = c["uk"] + qk
        Awk = A.mv(wk)
        x = c["x"] + ak * wk
        rk = c["rk"] - ak * Awk
        rkr0T1 = H.dot_u(rk, c["r0T"])
        betak = rkr0T1 / c["rkr0T"]               # lcg.cpp:589
        uk = rk + betak * qk
        pk = uk + betak * (qk + betak * c["pk"])
        return dict(
            c,
            x=x,
            rk=rk,
            pk=pk,
            uk=uk,
            qk=qk,
            rkr0T=rkr0T1,
            rk_mod=H.sq_norm(rk),
            m_mod=jnp.maximum(H.sq_norm(x), 1.0),
        )

    carry = H.run_loop(
        carry,
        residual_fn=residual_fn,
        step_fn=step_fn,
        x_of=lambda c: c["x"],
        params=params,
        monitor=monitor,
    )
    return carry


def bicgstab(A, b, x0=None, *, params=SolverParams(), monitor=None, trace_len=0):
    """BiCGSTAB (van der Vorst).  Reference: ``lbicgstab`` lcg.cpp:629-794;
    2 operator products per iteration, omega = (As.s)/(As.As)."""
    A, b, x = _prep(A, b, x0)
    n = H.dim(b)  # global length (psum-aware when sharded)

    Ax = A.mv(x)
    rk = b - Ax
    carry = dict(
        x=x,
        rk=rk,
        r0T=rk,
        pk=rk,
        Apk=jnp.zeros_like(rk),
        rkr0T=H.sq_norm(rk),
        rk_mod=H.sq_norm(rk),
        m_mod=jnp.maximum(H.sq_norm(x), 1.0),
        t=jnp.asarray(0, jnp.int32),
        status=H.running_status(),
        residual=jnp.asarray(0.0, rk.real.dtype),
        trace=H.init_trace(trace_len, b.real.dtype),
    )

    def residual_fn(c):
        return H.real_residual(c["rk_mod"], c["m_mod"], n, params.abs_diff)

    def step_fn(c):
        Apk = A.mv(c["pk"])
        AprT = H.dot_u(Apk, c["r0T"])            # lcg.cpp:720-724
        ak = c["rkr0T"] / AprT
        sk = c["rk"] - ak * Apk
        Ask = A.mv(sk)
        Ass = H.dot_u(Ask, sk)
        AsAs = H.dot_u(Ask, Ask)
        wk = Ass / AsAs                          # lcg.cpp:741
        x = c["x"] + ak * c["pk"] + wk * sk
        rk = sk - wk * Ask
        rkr0T1 = H.dot_u(rk, c["r0T"])
        betak = (ak / wk) * rkr0T1 / c["rkr0T"]  # lcg.cpp:773
        pk = rk + betak * (c["pk"] - wk * Apk)
        return dict(
            c,
            x=x,
            rk=rk,
            pk=pk,
            Apk=Apk,
            rkr0T=rkr0T1,
            rk_mod=H.sq_norm(rk),
            m_mod=jnp.maximum(H.sq_norm(x), 1.0),
        )

    carry = H.run_loop(
        carry,
        residual_fn=residual_fn,
        step_fn=step_fn,
        x_of=lambda c: c["x"],
        params=params,
        monitor=monitor,
    )
    return carry


def _bicgstab2_straight(A, b, x0, *, params, monitor, trace_len):
    """Restarted BiCGSTAB without the abs_diff mid-iteration check: the
    restart (lcg.cpp:993-1009) is a pure ``jnp.where`` select, so the whole
    engine runs on the shared straight-line harness."""
    A, b, x = _prep(A, b, x0)
    n = H.dim(b)

    Ax = A.mv(x)
    rk = b - Ax
    carry = dict(
        x=x,
        rk=rk,
        r0T=rk,
        pk=rk,
        rkr0T=H.sq_norm(rk),
        rk_mod=H.sq_norm(rk),
        m_mod=jnp.maximum(H.sq_norm(x), 1.0),
        t=jnp.asarray(0, jnp.int32),
        status=H.running_status(),
        residual=jnp.asarray(0.0, rk.real.dtype),
        trace=H.init_trace(trace_len, b.real.dtype),
    )

    def residual_fn(c):
        return H.real_residual(c["rk_mod"], c["m_mod"], n, params.abs_diff)

    def step_fn(c):
        Apk = A.mv(c["pk"])
        AprT = H.dot_u(Apk, c["r0T"])
        ak = c["rkr0T"] / AprT
        sk = c["rk"] - ak * Apk
        Ask = A.mv(sk)
        Ass = H.dot_u(Ask, sk)
        AsAs = H.dot_u(Ask, Ask)
        wk = Ass / AsAs
        x = c["x"] + ak * c["pk"] + wk * sk
        rk = sk - wk * Ask
        rk_mod = H.sq_norm(rk)
        rkr0T1 = H.dot_u(rk, c["r0T"])
        # Restart (lcg.cpp:994-1009): r0T <- rk, pk <- rk, rkr0T = ||rk||^2;
        # the betak direction update is skipped on restart.
        restart = jnp.abs(rkr0T1) < params.restart_epsilon
        r0T = jnp.where(restart, rk, c["r0T"])
        rkr0T_new = jnp.where(restart, rk_mod, rkr0T1)
        betak = (ak / wk) * rkr0T1 / c["rkr0T"]
        pk = jnp.where(restart, rk, rk + betak * (c["pk"] - wk * Apk))
        return dict(
            c, x=x, rk=rk, r0T=r0T, pk=pk, rkr0T=rkr0T_new,
            rk_mod=rk_mod, m_mod=jnp.maximum(H.sq_norm(x), 1.0),
        )

    return H.run_loop(
        carry,
        residual_fn=residual_fn,
        step_fn=step_fn,
        x_of=lambda c: c["x"],
        params=params,
        monitor=monitor,
    )


def bicgstab2(A, b, x0=None, *, params=SolverParams(), monitor=None, trace_len=0):
    """Restarted BiCGSTAB.  Reference: ``lbicgstab2`` lcg.cpp:812-1034.

    Differences from plain BiCGSTAB, reproduced exactly:
    - restart when |<r, r0T>| < restart_epsilon: the shadow residual and the
      search direction are reset to r (lcg.cpp:993-1009; note the restart
      branch does *not* apply the betak direction update);
    - in abs_diff mode, a mid-iteration convergence check on s with its own
      monitor call, half-step solution update, and extra counter increment
      (lcg.cpp:918-950).

    In the default relative-metric mode (abs_diff == 0) there is no
    mid-iteration check, so the engine runs on the shared straight-line
    harness with the restart as a ``jnp.where`` select; only the abs_diff
    mode pays for a branching loop body.
    """
    if not params.abs_diff:
        return _bicgstab2_straight(A, b, x0, params=params, monitor=monitor,
                                   trace_len=trace_len)
    A, b, x = _prep(A, b, x0)
    n = H.dim(b)  # global length (psum-aware when sharded)
    max_iter = params.effective_max_iterations()
    eps = params.epsilon

    Ax = A.mv(x)
    rk = b - Ax
    carry = dict(
        x=x,
        rk=rk,
        r0T=rk,
        pk=rk,
        rkr0T=H.sq_norm(rk),
        rk_mod=H.sq_norm(rk),
        m_mod=jnp.maximum(H.sq_norm(x), 1.0),
        t=jnp.asarray(0, jnp.int32),
        status=H.running_status(),
        residual=jnp.asarray(0.0, rk.real.dtype),
        trace=H.init_trace(trace_len, b.real.dtype),
    )

    def residual_fn(c):
        return H.real_residual(c["rk_mod"], c["m_mod"], n, params.abs_diff)

    def top_checks(c, res):
        """monitor -> convergence -> max-iter, shared by both check sites."""
        stop = (
            monitor(c["x"], res, c["t"]) if monitor is not None else jnp.asarray(False)
        )
        converged = res <= eps
        hit_max = (params.max_iterations > 0) & (c["t"] + 1 > params.max_iterations)
        return jnp.where(
            stop,
            int(Status.STOP),
            jnp.where(
                converged,
                int(Status.CONVERGENCE),
                jnp.where(
                    hit_max, int(Status.REACHED_MAX_ITERATIONS), int(Status.RUNNING)
                ),
            ),
        ).astype(jnp.int32)

    def cond_fn(c):
        return (c["status"] == int(Status.RUNNING)) & (c["t"] <= max_iter)

    def body_fn(c):
        res = residual_fn(c)
        c = dict(c, residual=res)
        if c["trace"] is not None:
            c["trace"] = record_trace = H.record_trace(c["trace"], c["t"], res)

        verdict = top_checks(c, res)

        def do_exit(c):
            return dict(c, status=verdict)

        def do_step(c):
            c = dict(c, t=c["t"] + 1)
            Apk = A.mv(c["pk"])
            AprT = H.dot_u(Apk, c["r0T"])
            ak = c["rkr0T"] / AprT
            sk = c["rk"] - ak * Apk

            def mid_check(c):
                # abs_diff-only convergence probe on s (lcg.cpp:918-950).
                s_res = jnp.sqrt(H.sq_norm(sk)) / n
                stop = (
                    monitor(c["x"], s_res, c["t"])
                    if monitor is not None
                    else jnp.asarray(False)
                )
                conv = s_res <= eps
                hit_max = (params.max_iterations > 0) & (
                    c["t"] + 1 > params.max_iterations
                )
                mid_status = jnp.where(
                    stop,
                    int(Status.STOP),
                    jnp.where(
                        conv,
                        int(Status.CONVERGENCE),
                        jnp.where(
                            hit_max,
                            int(Status.REACHED_MAX_ITERATIONS),
                            int(Status.RUNNING),
                        ),
                    ),
                ).astype(jnp.int32)

                def mid_exit(c):
                    # Half-step update only on the convergence exit
                    # (lcg.cpp:930-941); NaN scan included.
                    def apply_half(c):
                        x = c["x"] + ak * c["pk"]
                        st = jnp.where(
                            H.has_nan(x), int(Status.NAN_VALUE), mid_status
                        ).astype(jnp.int32)
                        return dict(c, x=x, status=st, residual=s_res)

                    return lax.cond(
                        mid_status == int(Status.CONVERGENCE),
                        apply_half,
                        lambda c: dict(c, status=mid_status, residual=s_res),
                        c,
                    )

                def mid_continue(c):
                    return dict(c, t=c["t"] + 1)  # second increment, lcg.cpp:949

                return lax.cond(
                    mid_status != int(Status.RUNNING), mid_exit, mid_continue, c
                )

            if params.abs_diff:
                c = mid_check(c)

            def rest(c):
                Ask = A.mv(sk)
                Ass = H.dot_u(Ask, sk)
                AsAs = H.dot_u(Ask, Ask)
                wk = Ass / AsAs
                x = c["x"] + ak * c["pk"] + wk * sk
                rk = sk - wk * Ask
                rk_mod = H.sq_norm(rk)
                rkr0T1 = H.dot_u(rk, c["r0T"])

                restart = jnp.abs(rkr0T1) < params.restart_epsilon

                # Restart branch (lcg.cpp:994-1009): r0T <- rk, pk <- rk,
                # rkr0T1 recomputed = ||rk||^2; betak is computed but unused
                # because pk is overwritten with rk.
                r0T = jnp.where(restart, rk, c["r0T"])
                rkr0T_new = jnp.where(restart, rk_mod, rkr0T1)
                betak = (ak / wk) * rkr0T1 / c["rkr0T"]
                pk_cont = rk + betak * (c["pk"] - wk * Apk)
                pk = jnp.where(restart, rk, pk_cont)

                st = jnp.where(
                    H.has_nan(x), int(Status.NAN_VALUE), c["status"]
                ).astype(jnp.int32)
                return dict(
                    c,
                    x=x,
                    rk=rk,
                    r0T=r0T,
                    pk=pk,
                    rkr0T=rkr0T_new,
                    rk_mod=rk_mod,
                    m_mod=jnp.maximum(H.sq_norm(x), 1.0),
                    status=st,
                )

            return lax.cond(
                c["status"] == int(Status.RUNNING), rest, lambda c: c, c
            )

        return lax.cond(verdict == int(Status.RUNNING), do_step, do_exit, c)

    carry = lax.while_loop(cond_fn, body_fn, carry)
    carry["status"] = jnp.where(
        carry["status"] == int(Status.RUNNING),
        int(Status.REACHED_MAX_ITERATIONS),
        carry["status"],
    ).astype(jnp.int32)
    return H.finalize(carry)


def _box_projector(lower, upper, lower_inclusive: bool, upper_inclusive: bool):
    """The per-iteration projection P(.): plain clip for the (default)
    inclusive bounds, the reference's exclusive ``set2box`` semantics
    (algebra.cpp:50-58) otherwise."""
    if lower_inclusive and upper_inclusive:
        return lambda v: jnp.clip(v, lower, upper)
    from ..operators import set2box

    return lambda v: set2box(lower, upper, v, lower_inclusive, upper_inclusive)


def pg(A, b, x0=None, *, lower, upper, params=SolverParams(), monitor=None,
       trace_len=0, lower_inclusive: bool = True, upper_inclusive: bool = True):
    """Projected gradient with Barzilai–Borwein step.  Reference: ``lpg``
    lcg.cpp:1054-1204 (the *native* version; the CUDA version's gradient
    update bugs at lcg_cuda.cu:681-703 are intentionally not replicated).
    ``lower_inclusive``/``upper_inclusive`` select ``lcg_set2box``'s
    exclusive-bound modes (algebra.cpp:50-58)."""
    A, b, x = _prep(A, b, x0)
    n = H.dim(b)  # global length (psum-aware when sharded)
    lower = jnp.asarray(lower, dtype=b.dtype)
    upper = jnp.asarray(upper, dtype=b.dtype)
    project = _box_projector(lower, upper, lower_inclusive, upper_inclusive)

    x = project(x)                               # lcg.cpp:1086-1090
    Ax = A.mv(x)
    gk = Ax - b
    carry = dict(
        x=x,
        gk=gk,
        # full_like the reduction result so the BB step is per-system
        # under batched solves (shape (nrhs, 1)) and scalar otherwise.
        alpha=jnp.full_like(H.sq_norm(gk), params.step).astype(b.dtype),
        gk_mod=H.sq_norm(gk),
        m_mod=jnp.maximum(H.sq_norm(x), 1.0),
        t=jnp.asarray(0, jnp.int32),
        status=H.running_status(),
        residual=jnp.asarray(0.0, gk.real.dtype),
        trace=H.init_trace(trace_len, b.real.dtype),
    )

    def residual_fn(c):
        return H.real_residual(c["gk_mod"], c["m_mod"], n, params.abs_diff)

    def step_fn(c):
        m_new = project(c["x"] - c["alpha"] * c["gk"])
        Ad = A.mv(m_new)
        gk_new = Ad - b
        sk = m_new - c["x"]
        yk = gk_new - c["gk"]
        alpha = H.dot_u(sk, sk) / H.dot_u(sk, yk)   # BB step, lcg.cpp:1171-1178
        return dict(
            c,
            x=m_new,
            gk=gk_new,
            alpha=alpha,
            gk_mod=H.sq_norm(gk_new),
            m_mod=jnp.maximum(H.sq_norm(m_new), 1.0),
        )

    carry = H.run_loop(
        carry,
        residual_fn=residual_fn,
        step_fn=step_fn,
        x_of=lambda c: c["x"],
        params=params,
        monitor=monitor,
    )
    return carry


def spg(A, b, x0=None, *, lower, upper, params=SolverParams(), monitor=None,
        trace_len=0, lower_inclusive: bool = True, upper_inclusive: bool = True):
    """Spectral projected gradient with Grippo non-monotone line search.
    Reference: ``lspg`` lcg.cpp:1224-1447.

    The inner Armijo backtracking ``while (qk > max(qk_m) + sigma*alpha*g.d)
    alpha *= beta`` (lcg.cpp:1377-1399) is data-dependent and unbounded in C;
    here it is a bounded ``lax.while_loop`` capped at
    ``params.max_backtracks`` steps (at the default beta=0.9 that allows a
    step reduction below 2e-3 — far past where the reference would accept).

    Batched mode: the BB step, objective ring and line search are
    per-system; the inner loop runs until every system's Armijo test
    passes, with satisfied systems frozen.
    """
    A, b, x = _prep(A, b, x0)
    n = H.dim(b)  # global length (psum-aware when sharded)
    lower = jnp.asarray(lower, dtype=b.dtype)
    upper = jnp.asarray(upper, dtype=b.dtype)
    project = _box_projector(lower, upper, lower_inclusive, upper_inclusive)
    maxi_m = params.maxi_m
    batched = H.batch_active()

    x = project(x)
    Ax = A.mv(x)
    gk = Ax - b
    qk0 = H.dot_u(0.5 * x, Ax) - H.dot_u(b, x)   # lcg.cpp:1305-1308
    # Objective ring: (maxi_m,) plain, (nrhs, maxi_m) batched.
    qk_m = jnp.full(qk0.shape[:-1] + (maxi_m,) if batched else (maxi_m,),
                    -1e30, dtype=b.real.dtype)
    qk_m = qk_m.at[..., 0].set(qk0[..., 0] if batched else qk0)

    carry = dict(
        x=x,
        gk=gk,
        lam=jnp.full_like(qk0, params.step),
        qk_m=qk_m,
        gk_mod=H.sq_norm(gk),
        m_mod=jnp.maximum(H.sq_norm(x), 1.0),
        # Total Armijo backtrack count (each costs one extra A.mv) —
        # the SPG cost model is iterations * (2 + bt/t) matvecs.
        bt=jnp.asarray(0, jnp.int32),
        t=jnp.asarray(0, jnp.int32),
        status=H.running_status(),
        residual=jnp.asarray(0.0, gk.real.dtype),
        trace=H.init_trace(trace_len, b.real.dtype),
    )

    def residual_fn(c):
        return H.real_residual(c["gk_mod"], c["m_mod"], n, params.abs_diff)

    def step_fn(c):
        dk = project(c["x"] - c["lam"] * c["gk"]) - c["x"]
        gd = H.dot_u(c["gk"], dk)
        maxi_qk = jnp.max(c["qk_m"], axis=-1, keepdims=batched)

        def ls_eval(alpha):
            m_new = c["x"] + alpha * dk
            Ad = A.mv(m_new)
            qk = H.dot_u(0.5 * m_new, Ad) - H.dot_u(b, m_new)
            return m_new, Ad, qk

        alpha0 = jnp.full_like(gd, 1.0)
        m_new0, Ad0, qk0 = ls_eval(alpha0)

        def ls_active(alpha, qk, k):
            return (qk > maxi_qk + params.sigma * alpha * gd) & (
                k < params.max_backtracks
            )

        def ls_cond(s):
            alpha, _, _, qk, k = s
            act = ls_active(alpha, qk, k)
            return jnp.any(act) if batched else act

        def ls_body(s):
            alpha, m_old, Ad_old, qk_old, k = s
            act = ls_active(alpha, qk_old, k)
            alpha = jnp.where(act, alpha * params.beta, alpha)
            m_new, Ad, qk = ls_eval(alpha)
            sel = lambda new, old: jnp.where(act, new, old)
            return (alpha, sel(m_new, m_old), sel(Ad, Ad_old),
                    sel(qk, qk_old), k + 1)

        alpha, m_new, Ad, qk, n_bt = lax.while_loop(
            ls_cond, ls_body, (alpha0, m_new0, Ad0, qk0, jnp.asarray(0, jnp.int32))
        )

        # Reference writes qk_m[(t+1) % maxi_m] with t already incremented
        # (lcg.cpp:1342 then :1402) — the off-by-one is reproduced as-is.
        slot = (c["t"] + 1) % maxi_m
        if batched:
            # slot is per-system (nrhs, 1): scatter row i's objective into
            # its own ring position.
            rows_idx = jnp.arange(c["qk_m"].shape[0])[:, None]
            qk_hist = c["qk_m"].at[rows_idx, slot].set(qk)
        else:
            qk_hist = c["qk_m"].at[slot].set(qk)

        gk_new = Ad - b
        sk = m_new - c["x"]
        yk = gk_new - c["gk"]
        lam = H.dot_u(sk, sk) / H.dot_u(sk, yk)
        return dict(
            c,
            x=m_new,
            gk=gk_new,
            lam=lam,
            qk_m=qk_hist,
            bt=c["bt"] + n_bt,
            gk_mod=H.sq_norm(gk_new),
            m_mod=jnp.maximum(H.sq_norm(m_new), 1.0),
        )

    carry = H.run_loop(
        carry,
        residual_fn=residual_fn,
        step_fn=step_fn,
        x_of=lambda c: c["x"],
        params=params,
        monitor=monitor,
    )
    return carry
