"""Complex Krylov engines on a complex-less backend: pair arithmetic.

A backend without complex dtypes (every complex op raises
UNIMPLEMENTED) still has to run the reference's flagship complex
workload, a 10K complex-symmetric sparse system driven by
BiCG/BiCG-sym/CGS/TFQMR and Jacobi-PCG/PBiCG (sample6.cpp:151-195,
sample10.cu:193-273).  The
engines here reproduce those recurrences EXACTLY — same inner products,
same stopping metric (the reference's ||r||^4 ratio, clcg.cpp:112-147),
same iteration counts — in pure real arithmetic:

- a complex vector travels as a stacked real vector ``[re; im]`` (2n,);
- the operator is a :class:`~liblcg_tpu.operators.RealifiedOperator`
  (block form [[Ar, -Ai], [Ai, Ar]]), whose ``rmv`` is the Hermitian
  product A^H and whose conjugate product conj(A)x is a sign flip away;
- the unconjugated ``clcg_dot`` (lcg_complex.cpp:143-154) and conjugated
  ``clcg_inner`` (:156-167) become fused two-reduction real dots.

Unlike the CGNR-on-realified-normal-equations escape hatch (PARITY.md
decision tree), these run the reference's OWN algorithms, so iteration
parity against the reference binary holds (bands in
tests/test_reference_parity.py; counts regenerable by
profiling/make_reference_counts.sh).

All state lives in one ``lax.while_loop`` carry via the shared harness —
identical performance shape to the real-domain engines.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..operators import (
    LinearOperator,
    RealifiedOperator,
    merge_complex,
    realify,
    split_complex,
)
from ..types import DEFAULT_PARAMS, SolverParams, SolveResult, Status
from . import harness as H

# ---------------------------------------------------------------------------
# Pair arithmetic: complex scalars are (re, im) tuples of 0-d real arrays;
# complex vectors are stacked (2n,) real arrays [re; im].
# ---------------------------------------------------------------------------


def _halves(v):
    n = v.shape[-1] // 2
    return v[..., :n], v[..., n:]


def pair_dot_u(a, b):
    """Unconjugated sum a_i b_i (``clcg_dot``) as a scalar pair."""
    ar, ai = _halves(a)
    br, bi = _halves(b)
    return (H.dot_u(ar, br) - H.dot_u(ai, bi),
            H.dot_u(ar, bi) + H.dot_u(ai, br))


def pair_dot_c(a, b):
    """Conjugated sum conj(a_i) b_i (``clcg_inner``) as a scalar pair."""
    ar, ai = _halves(a)
    br, bi = _halves(b)
    return (H.dot_u(ar, br) + H.dot_u(ai, bi),
            H.dot_u(ar, bi) - H.dot_u(ai, br))


def pair_sq_norm(a):
    """||a||^2 (real scalar)."""
    return H.sq_norm(a)


def fused_sums(*rows):
    """Many independent sum-reductions in ONE launch: stack the (n,)
    summand arrays and reduce along the trailing axis (psum'd when
    distributed; accumulated in the harness's active reduction dtype —
    ``SolverParams.reduce_dtype`` — and cast back, like H._reduce_sum).
    An engine step that needs 6 scalars pays 6 small reduction launches
    unfused but 1-2 fused — at n=10K launches, not arithmetic, set the
    cost.  Batched (multi-RHS) context: rows are
    (nrhs, n) and each returned scalar is (nrhs, 1)."""
    stacked = jnp.stack(rows)
    acc = H._acc_dtype(stacked.dtype)
    s = jnp.sum(stacked, axis=-1, dtype=acc,
                keepdims=H.batch_active())
    if acc is not None:
        s = s.astype(stacked.dtype)
    ax = H.dist_axis()
    if ax is not None:
        from jax import lax

        s = lax.psum(s, ax)
    return tuple(s)


def s_mul(s, t):
    sr, si = s
    tr, ti = t
    return (sr * tr - si * ti, sr * ti + si * tr)


def s_div(s, t):
    sr, si = s
    tr, ti = t
    d = tr * tr + ti * ti
    return ((sr * tr + si * ti) / d, (si * tr - sr * ti) / d)


def s_conj(s):
    return (s[0], -s[1])


def axpy(s, v, w):
    """w + s * v for a scalar pair s and stacked vectors (w may be 0)."""
    sr, si = s
    vr, vi = _halves(v)
    return jnp.concatenate([sr * vr - si * vi, sr * vi + si * vr],
                           axis=-1) + w


def vconj(v):
    vr, vi = _halves(v)
    return jnp.concatenate([vr, -vi], axis=-1)


def diag_mul(d, v):
    """Elementwise complex product diag(d) v; d a stacked (2n,) pair."""
    dr, di = _halves(d)
    vr, vi = _halves(v)
    return jnp.concatenate([dr * vr - di * vi, dr * vi + di * vr], axis=-1)


class PairJacobi:
    """Jacobi M^{-1} for pair vectors: elementwise complex multiply by
    1/diag(A) (the sample6.cpp:151-158 preconditioner)."""

    def __init__(self, inv_diag_stacked):
        self.inv_diag = jnp.asarray(inv_diag_stacked)

    @classmethod
    def from_complex_diag(cls, diag):
        diag = np.asarray(diag)
        return cls(split_complex(1.0 / diag))

    def mv(self, v):
        return diag_mul(self.inv_diag, v)


def _pairjacobi_unflatten(aux, ch):
    # No __init__: unflatten children may be tracers/specs/None and must
    # pass through untouched (jnp.asarray on a PartitionSpec raises).
    obj = object.__new__(PairJacobi)
    obj.inv_diag = ch[0]
    return obj


jax.tree_util.register_pytree_node(
    PairJacobi,
    lambda M: ((M.inv_diag,), None),
    _pairjacobi_unflatten,
)


def _conj_mv(A: RealifiedOperator, v):
    """conj(A) v for a stacked pair (the reference's (MatNormal, Conjugate)
    callback mode, lcg_complex.h:310-327): conj(A)(xr + i xi) has real part
    Ar xr + Ai xi and imaginary part -Ai xr + Ar xi."""
    xr, xi = _halves(v)
    yr = A.re.mv(xr) + A.im.mv(xi)
    yi = -A.im.mv(xr) + A.re.mv(xi)
    # axis=-1: v may be a batched (nrhs, 2n) stack (axis 0 would
    # interleave systems instead of halves).
    return jnp.concatenate([yr, yi], axis=-1)


# ---------------------------------------------------------------------------
# Engines (recurrences mirror solvers/cplx.py, which cites the reference
# line-by-line; only the arithmetic substrate differs).
# ---------------------------------------------------------------------------


def _carry_common(x, rk, b, trace_len):
    return dict(
        x=x,
        rk=rk,
        rk_sq=pair_sq_norm(rk),
        m_sq=pair_sq_norm(x),
        t=jnp.asarray(0, jnp.int32),
        status=H.running_status(),
        residual=jnp.asarray(0.0, b.dtype),
        trace=H.init_trace(trace_len, b.dtype),
    )


def bicg_sym_pairs(A, b, x0=None, *, params=SolverParams(), monitor=None,
                   trace_len=0):
    """BiCG for complex-symmetric A, pair form (clcg.cpp:228-364)."""
    # Global logical size for the stopping metric (psum-aware when
    # sharded: vectors are then LOCAL [re;im] shards, see
    # parallel/realified.py); vector construction uses local shapes.
    n = H.dim(b) // 2
    x = jnp.zeros_like(b) if x0 is None else x0
    rk = b - A.mv(x)
    carry = _carry_common(x, rk, b, trace_len)
    carry["dk"] = rk
    carry["rkrk"] = pair_dot_u(rk, rk)

    def residual_fn(c):
        return H.complex_residual(c["rk_sq"], c["m_sq"], n, params.abs_diff)

    def step_fn(c):
        Adk = A.mv(c["dk"])
        dr, di = _halves(c["dk"])
        Ar, Ai = _halves(Adk)
        dAr, dAi = fused_sums(dr * Ar - di * Ai, dr * Ai + di * Ar)
        ak = s_div(c["rkrk"], (dAr, dAi))
        x = axpy(ak, c["dk"], c["x"])
        rk = axpy((-ak[0], -ak[1]), Adk, c["rk"])
        rr, ri = _halves(rk)
        xr, xi = _halves(x)
        rkr, rki, rk_sq, m_sq = fused_sums(
            rr * rr - ri * ri, 2.0 * rr * ri,
            rr * rr + ri * ri, xr * xr + xi * xi)
        rkrk2 = (rkr, rki)
        betak = s_div(rkrk2, c["rkrk"])
        dk = axpy(betak, c["dk"], rk)
        return dict(c, x=x, rk=rk, dk=dk, rkrk=rkrk2,
                    rk_sq=rk_sq, m_sq=m_sq)

    return H.run_loop(carry, residual_fn=residual_fn, step_fn=step_fn,
                      x_of=lambda c: c["x"], params=params, monitor=monitor)


def bicg_pairs(A, b, x0=None, *, params=SolverParams(), monitor=None,
               trace_len=0):
    """General BiCG with the A^H dual sequence, pair form
    (clcg.cpp:77-226; the dual product A^H d2 is RealifiedOperator.rmv)."""
    # Global logical size for the stopping metric (psum-aware when
    # sharded: vectors are then LOCAL [re;im] shards, see
    # parallel/realified.py); vector construction uses local shapes.
    n = H.dim(b) // 2
    x = jnp.zeros_like(b) if x0 is None else x0
    r1k = b - A.mv(x)
    r2k = vconj(r1k)
    carry = _carry_common(x, r1k, b, trace_len)
    del carry["rk"]
    carry.update(r1k=r1k, r2k=r2k, d1k=r1k, d2k=r2k,
                 r1r2=pair_dot_c(r2k, r1k), rk_sq=pair_sq_norm(r1k))

    def residual_fn(c):
        return H.complex_residual(c["rk_sq"], c["m_sq"], n, params.abs_diff)

    def step_fn(c):
        Ad1 = A.mv(c["d1k"])
        ak = s_div(c["r1r2"], pair_dot_c(c["d2k"], Ad1))
        x = axpy(ak, c["d1k"], c["x"])
        r1k = axpy((-ak[0], -ak[1]), Ad1, c["r1k"])
        Ahd2 = A.rmv(c["d2k"])          # R(A)^T == R(A^H)
        cak = s_conj(ak)
        r2k = axpy((-cak[0], -cak[1]), Ahd2, c["r2k"])
        r1r2_2 = pair_dot_c(r2k, r1k)
        betak = s_div(r1r2_2, c["r1r2"])
        d1k = axpy(betak, c["d1k"], r1k)
        d2k = axpy(s_conj(betak), c["d2k"], r2k)
        return dict(c, x=x, r1k=r1k, r2k=r2k, d1k=d1k, d2k=d2k,
                    r1r2=r1r2_2, rk_sq=pair_sq_norm(r1k),
                    m_sq=pair_sq_norm(x))

    return H.run_loop(carry, residual_fn=residual_fn, step_fn=step_fn,
                      x_of=lambda c: c["x"], params=params, monitor=monitor)


def pcg_pairs(A, b, x0=None, *, M, params=SolverParams(), monitor=None,
              trace_len=0):
    """Complex-symmetric PCG, pair form (clcg_eigen.cpp:577-683 — the
    unconjugated d_new at :598)."""
    # Global logical size for the stopping metric (psum-aware when
    # sharded: vectors are then LOCAL [re;im] shards, see
    # parallel/realified.py); vector construction uses local shapes.
    n = H.dim(b) // 2
    apply_M = M.mv if hasattr(M, "mv") else M
    x = jnp.zeros_like(b) if x0 is None else x0
    rk = b - A.mv(x)
    dk = apply_M(rk)
    carry = _carry_common(x, rk, b, trace_len)
    carry["dk"] = dk
    carry["d_new"] = pair_dot_u(rk, dk)

    def residual_fn(c):
        return H.complex_residual(c["rk_sq"], c["m_sq"], n, params.abs_diff)

    def step_fn(c):
        Adk = A.mv(c["dk"])
        dr, di = _halves(c["dk"])
        Ar, Ai = _halves(Adk)
        dAr, dAi = fused_sums(dr * Ar - di * Ai, dr * Ai + di * Ar)
        ak = s_div(c["d_new"], (dAr, dAi))
        x = axpy(ak, c["dk"], c["x"])
        rk = axpy((-ak[0], -ak[1]), Adk, c["rk"])
        sk = apply_M(rk)
        rr, ri = _halves(rk)
        sr, si = _halves(sk)
        xr, xi = _halves(x)
        dnr, dni, rk_sq, m_sq = fused_sums(
            rr * sr - ri * si, rr * si + ri * sr,
            rr * rr + ri * ri, xr * xr + xi * xi)
        d_new = (dnr, dni)
        betak = s_div(d_new, c["d_new"])
        dk = axpy(betak, c["dk"], sk)
        return dict(c, x=x, rk=rk, dk=dk, d_new=d_new,
                    rk_sq=rk_sq, m_sq=m_sq)

    return H.run_loop(carry, residual_fn=residual_fn, step_fn=step_fn,
                      x_of=lambda c: c["x"], params=params, monitor=monitor)


def pbicg_pairs(A, b, x0=None, *, M, params=SolverParams(), monitor=None,
                trace_len=0):
    """Preconditioned BiCG with the conj(A) dual product, pair form
    (clcg_eigen.cpp:685-801; the (MatNormal, Conjugate) mode at :765)."""
    # Global logical size for the stopping metric (psum-aware when
    # sharded: vectors are then LOCAL [re;im] shards, see
    # parallel/realified.py); vector construction uses local shapes.
    n = H.dim(b) // 2
    apply_M = M.mv if hasattr(M, "mv") else M
    x = jnp.zeros_like(b) if x0 is None else x0
    rk = b - A.mv(x)
    zk = apply_M(rk)
    carry = _carry_common(x, rk, b, trace_len)
    carry.update(pk=zk, rsk=vconj(rk), psk=vconj(zk),
                 rhok=pair_dot_c(vconj(rk), zk))

    def residual_fn(c):
        return H.complex_residual(c["rk_sq"], c["m_sq"], n, params.abs_diff)

    def step_fn(c):
        Apk = A.mv(c["pk"])
        Aspsk = _conj_mv(A, c["psk"])
        ak = s_div(c["rhok"], pair_dot_c(c["psk"], Apk))
        x = axpy(ak, c["pk"], c["x"])
        cak = s_conj(ak)
        rsk = axpy((-cak[0], -cak[1]), Aspsk, vconj(c["rk"]))
        rk = axpy((-ak[0], -ak[1]), Apk, c["rk"])
        zk = apply_M(rk)
        rhok2 = pair_dot_c(rsk, zk)
        betak = s_div(rhok2, c["rhok"])
        pk = axpy(betak, c["pk"], zk)
        psk = axpy(s_conj(betak), c["psk"], vconj(zk))
        return dict(c, x=x, rk=rk, rsk=rsk, pk=pk, psk=psk, rhok=rhok2,
                    rk_sq=pair_sq_norm(rk), m_sq=pair_sq_norm(x))

    return H.run_loop(carry, residual_fn=residual_fn, step_fn=step_fn,
                      x_of=lambda c: c["x"], params=params, monitor=monitor)


def cgs_pairs(A, b, x0=None, *, params=SolverParams(), monitor=None,
              trace_len=0, key=None):
    """Complex CGS with random shadow residual, pair form
    (clcg.cpp:366-522; rbar0 ~ U[1,2) real so the redraw loop is skipped —
    the draw is real-positive and <rbar0, r0> vanishes only for adversarial
    r0, matching _shadow_residual's first draw)."""
    import jax

    # Global logical size for the stopping metric (psum-aware when
    # sharded: vectors are then LOCAL [re;im] shards, see
    # parallel/realified.py); vector construction uses local shapes.
    n = H.dim(b) // 2
    x = jnp.zeros_like(b) if x0 is None else x0
    rk = b - A.mv(x)
    if key is None:
        key = jax.random.PRNGKey(1234)
    # Draw at the LOCAL half-length (== n single-device; the shard length
    # under shard_map, where the caller decorrelates keys per shard).
    # One shared shadow per batched stack (like _shadow_residual's
    # broadcast in the vmapped complex engines).
    re = jax.random.uniform(key, (b.shape[-1] // 2,), dtype=b.dtype,
                            minval=1.0, maxval=2.0)
    # Broadcast to the (possibly batched) stack shape: carry entries
    # need the leading nrhs axis for per-system freezing.
    rbar0 = jnp.broadcast_to(
        jnp.concatenate([re, jnp.zeros_like(re)]), b.shape)
    carry = _carry_common(x, rk, b, trace_len)
    carry.update(rbar0=rbar0, pk=rk, uk=rk, qk=jnp.zeros_like(rk),
                 rhok=pair_dot_c(rbar0, rk))

    def residual_fn(c):
        return H.complex_residual(c["rk_sq"], c["m_sq"], n, params.abs_diff)

    def step_fn(c):
        Apk = A.mv(c["pk"])
        sigma = pair_dot_c(c["rbar0"], Apk)
        ak = s_div(c["rhok"], sigma)
        qk = axpy((-ak[0], -ak[1]), Apk, c["uk"])
        wk = c["uk"] + qk
        Awk = A.mv(wk)
        x = axpy(ak, wk, c["x"])
        rk = axpy((-ak[0], -ak[1]), Awk, c["rk"])
        rhok2 = pair_dot_c(c["rbar0"], rk)
        betak = s_div(rhok2, c["rhok"])
        uk = axpy(betak, qk, rk)
        pk = axpy(betak, axpy(betak, c["pk"], qk), uk)
        return dict(c, x=x, rk=rk, pk=pk, uk=uk, qk=qk, rhok=rhok2,
                    rk_sq=pair_sq_norm(rk), m_sq=pair_sq_norm(x))

    return H.run_loop(carry, residual_fn=residual_fn, step_fn=step_fn,
                      x_of=lambda c: c["x"], params=params, monitor=monitor)


def _shadow_pair(b, key):
    """Random shadow residual as a stacked pair: real-positive U[1,2)
    (clcg.cpp:399-403 draws until |<rbar0,r>| >= 1e-8; a real-positive
    draw makes the redraw loop a no-op for non-adversarial r0).  The
    split-then-draw sequence matches cplx._shadow_residual exactly, so a
    pair engine and its complex-dtype twin see the SAME rbar0 values and
    their iteration counts track each other, not just the same band.

    The draw length is the LOCAL half-length ``b.shape[-1] // 2`` (== the
    logical ``n`` single-device; the shard length under shard_map; one
    shared 1-D shadow for a batched (nrhs, 2n) stack)."""
    if key is None:
        key = jax.random.PRNGKey(1234)
    _, sub = jax.random.split(key)
    re = jax.random.uniform(sub, (b.shape[-1] // 2,), dtype=b.dtype,
                            minval=1.0, maxval=2.0)
    return jnp.broadcast_to(
        jnp.concatenate([re, jnp.zeros_like(re)]), b.shape)


def bicgstab_pairs(A, b, x0=None, *, params=SolverParams(), monitor=None,
                   trace_len=0, key=None):
    """Complex BiCGSTAB with random shadow residual, pair form
    (clcg.cpp:524-679 — native-only in the reference; the Eigen
    dispatcher rejects it, clcg_eigen.cpp:51-67)."""
    # Global logical size for the stopping metric (psum-aware when
    # sharded: vectors are then LOCAL [re;im] shards, see
    # parallel/realified.py); vector construction uses local shapes.
    n = H.dim(b) // 2
    x = jnp.zeros_like(b) if x0 is None else x0
    rk = b - A.mv(x)
    rbar0 = _shadow_pair(b, key)
    carry = _carry_common(x, rk, b, trace_len)
    carry.update(rbar0=rbar0, pk=rk, rhok=pair_dot_c(rbar0, rk))

    def residual_fn(c):
        return H.complex_residual(c["rk_sq"], c["m_sq"], n, params.abs_diff)

    def step_fn(c):
        Apk = A.mv(c["pk"])
        rbr, rbi = _halves(c["rbar0"])
        pr, pi = _halves(Apk)
        sgr, sgi = fused_sums(rbr * pr + rbi * pi, rbr * pi - rbi * pr)
        ak = s_div(c["rhok"], (sgr, sgi))
        sk = axpy((-ak[0], -ak[1]), Apk, c["rk"])
        Ask = A.mv(sk)
        ar, ai = _halves(Ask)
        sr, si = _halves(sk)
        # omega = <As, s>_c / <As, As>_c (clcg.cpp:631-638); the
        # denominator is a real squared norm.
        Assr, Assi, AsAs = fused_sums(
            ar * sr + ai * si, ar * si - ai * sr, ar * ar + ai * ai)
        omega = (Assr / AsAs, Assi / AsAs)
        x = axpy(omega, sk, axpy(ak, c["pk"], c["x"]))
        rk = axpy((-omega[0], -omega[1]), Ask, sk)
        rr, ri = _halves(rk)
        xr, xi = _halves(x)
        rhr, rhi, rk_sq, m_sq = fused_sums(
            rbr * rr + rbi * ri, rbr * ri - rbi * rr,
            rr * rr + ri * ri, xr * xr + xi * xi)
        rhok2 = (rhr, rhi)
        betak = s_div(s_mul(rhok2, ak), s_mul(c["rhok"], omega))
        pk = axpy(betak, axpy((-omega[0], -omega[1]), Apk, c["pk"]), rk)
        return dict(c, x=x, rk=rk, pk=pk, rhok=rhok2,
                    rk_sq=rk_sq, m_sq=m_sq)

    return H.run_loop(carry, residual_fn=residual_fn, step_fn=step_fn,
                      x_of=lambda c: c["x"], params=params, monitor=monitor)


def tfqmr_pairs(A, b, x0=None, *, params=SolverParams(), monitor=None,
                trace_len=0, key=None):
    """Transpose-free QMR, pair form (cltfqmr, clcg.cpp:681-882).

    Mirrors solvers/cplx.py:tfqmr exactly — tau/omega start at ||r0||^2
    (clcg.cpp:727-728), both half-step checks read the residual refreshed
    only after the pair (clcg.cpp:784-785, 853-854), t counts half steps
    — with complex scalars carried as (re, im) pairs.  Single-system
    (solve_realified's contract); the half-step exits are straight-line
    jnp.where selects like the complex-dtype engine.
    """
    from jax import lax

    # Global logical size for the stopping metric (psum-aware when
    # sharded: vectors are then LOCAL [re;im] shards, see
    # parallel/realified.py); vector construction uses local shapes.
    n = H.dim(b) // 2
    x = jnp.zeros_like(b) if x0 is None else x0
    rk = b - A.mv(x)
    rbar0 = _shadow_pair(b, key)
    rk_inner = pair_sq_norm(rk)  # |<r,r>| == ||r||^2
    rdt = b.dtype
    max_iter = params.effective_max_iterations()
    eps = params.epsilon

    carry = dict(
        x=x,
        rk=rk,
        rbar0=rbar0,
        pk=rk,
        uk=rk,
        qk=jnp.zeros_like(rk),
        dk=jnp.zeros_like(rk),
        rho=pair_dot_c(rbar0, rk),
        rk_mod=rk_inner,            # module of <r,r>, carried across iters
        rk_sq=rk_inner * rk_inner,  # reference rk_square = ||r||^4
        m_sq4=jnp.maximum(pair_sq_norm(x) ** 2, 1.0),
        theta=jnp.zeros((), rdt),
        tao=rk_inner,
        eta=(jnp.zeros((), rdt), jnp.zeros((), rdt)),
        t=jnp.asarray(0, jnp.int32),
        status=H.running_status(),
        residual=jnp.zeros((), rdt),
        trace=H.init_trace(trace_len, rdt),
    )

    def _init_res(c):
        # clcg.cpp:738-755 (the ||r||^4 metric, complex_residual's body,
        # on the carried fourth powers).
        if params.abs_diff:
            return jnp.sqrt(c["rk_sq"]) / n
        return c["rk_sq"] / c["m_sq4"]

    def cond_fn(c):
        return (c["status"] == int(Status.RUNNING)) & (c["t"] <= max_iter)

    def _half_verdict(c, x, t, res):
        stop = (
            monitor(x, res, t) if monitor is not None else jnp.asarray(False)
        )
        return jnp.where(
            stop,
            int(Status.STOP),
            jnp.where(
                res <= eps,
                int(Status.CONVERGENCE),
                jnp.where(
                    (params.max_iterations > 0)
                    & (t + 1 > params.max_iterations),
                    int(Status.REACHED_MAX_ITERATIONS),
                    int(Status.RUNNING),
                ),
            ),
        ).astype(jnp.int32)

    def body_fn(c):
        vk = A.mv(c["pk"])
        rbr, rbi = _halves(c["rbar0"])
        vr, vi = _halves(vk)
        sgr, sgi = fused_sums(rbr * vr + rbi * vi, rbr * vi - rbi * vr)
        alpha = s_div(c["rho"], (sgr, sgi))
        qk = axpy((-alpha[0], -alpha[1]), vk, c["uk"])
        uqk = c["uk"] + qk
        Auq = A.mv(uqk)
        rk = axpy((-alpha[0], -alpha[1]), Auq, c["rk"])
        rk_mod2 = pair_sq_norm(rk)
        # rk/qk committed before the checks (clcg.cpp:766-780).
        c = dict(c, qk=qk, rk=rk)

        res = _init_res(c)

        def half_update(c, j, alive):
            s = s_div(c["eta"], alpha)
            th2 = c["theta"] * c["theta"]
            sign = (th2 * s[0], th2 * s[1])
            if j == 1:
                omega = jnp.sqrt(c["rk_mod"] * rk_mod2)       # clcg.cpp:812
                dk_new = axpy(sign, c["dk"], c["uk"])
            else:
                omega = rk_mod2                               # clcg.cpp:822
                dk_new = axpy(sign, c["dk"], c["qk"])
            theta = omega / c["tao"]
            tao = omega / jnp.sqrt(1.0 + theta * theta)
            scale = 1.0 / (1.0 + theta * theta)
            eta = (scale * alpha[0], scale * alpha[1])
            x = axpy(eta, dk_new, c["x"])
            sel = lambda new, old: jnp.where(alive, new, old)
            return dict(
                c,
                x=sel(x, c["x"]),
                dk=sel(dk_new, c["dk"]),
                theta=sel(theta, c["theta"]),
                tao=sel(tao, c["tao"]),
                eta=(sel(eta[0], c["eta"][0]), sel(eta[1], c["eta"][1])),
                m_sq4=sel(jnp.maximum(pair_sq_norm(x) ** 2, 1.0),
                          c["m_sq4"]),
                t=c["t"] + alive.astype(jnp.int32),
            )

        # Half step 1.
        if c["trace"] is not None:
            c["trace"] = H.record_trace(c["trace"], c["t"], res)
        v1 = _half_verdict(c, c["x"], c["t"], res)
        a1 = v1 == int(Status.RUNNING)
        c = half_update(c, 1, a1)

        # Half step 2 — same stale rk_sq, half 1's refreshed ||x||^4.
        res2 = _init_res(c)
        res = jnp.where(a1, res2, res)
        if c["trace"] is not None:
            c["trace"] = jnp.where(
                a1, H.record_trace(c["trace"], c["t"], res), c["trace"]
            )
        v2 = _half_verdict(c, c["x"], c["t"], res)
        a2 = a1 & (v2 == int(Status.RUNNING))
        c = half_update(c, 2, a2)

        # Recurrence tail, committed only while still running.
        rr, ri = _halves(c["rk"])
        rhr, rhi = fused_sums(rbr * rr + rbi * ri, rbr * ri - rbi * rr)
        rho2 = (rhr, rhi)
        betak = s_div(rho2, c["rho"])
        uk = axpy(betak, c["qk"], c["rk"])
        pk = axpy(betak, axpy(betak, c["pk"], c["qk"]), uk)
        sel = lambda new, old: jnp.where(a2, new, old)
        c = dict(
            c,
            uk=sel(uk, c["uk"]),
            pk=sel(pk, c["pk"]),
            rho=(sel(rho2[0], c["rho"][0]), sel(rho2[1], c["rho"][1])),
            rk_mod=sel(rk_mod2, c["rk_mod"]),
            rk_sq=sel(rk_mod2 * rk_mod2, c["rk_sq"]),
            residual=res,
        )

        status = jnp.where(
            ~a1, v1, jnp.where(~a2, v2, int(Status.RUNNING))
        ).astype(jnp.int32)
        status = jnp.where(
            jnp.isnan(rk_mod2) & (status == int(Status.RUNNING)),
            int(Status.NAN_VALUE),
            status,
        ).astype(jnp.int32)
        return dict(c, status=status)

    # ALREADY_OPTIMIZED short-circuit (clcg.cpp:738-755).
    init_res = _init_res(carry)
    carry["residual"] = init_res
    carry["status"] = jnp.where(
        init_res <= eps, int(Status.CONVERGENCE), int(Status.RUNNING)
    ).astype(jnp.int32)

    carry = lax.while_loop(cond_fn, body_fn, carry)
    carry["status"] = jnp.where(
        carry["status"] == int(Status.RUNNING),
        int(Status.REACHED_MAX_ITERATIONS),
        carry["status"],
    ).astype(jnp.int32)
    # rho/eta are scalar pairs (not part of the SolveResult surface);
    # drop them so finalize/callers see the uniform carry schema.
    carry.pop("rho")
    carry.pop("eta")
    return H.finalize(carry)


_JIT_CACHE: dict = {}

#: methods whose engines draw a random shadow residual (accept ``key=``).
_KEYED_METHODS = ("cgs", "bicgstab", "tfqmr")

_PAIR_ENGINES = {
    "bicg": (bicg_pairs, False),
    "bicg_sym": (bicg_sym_pairs, False),
    "cgs": (cgs_pairs, False),
    "bicgstab": (bicgstab_pairs, False),
    "tfqmr": (tfqmr_pairs, False),
    "pcg": (pcg_pairs, True),
    "pbicg": (pbicg_pairs, True),
}


def solve_realified(A, b, x0=None, *, method: str = "bicg_sym", M=None,
                    params: SolverParams = DEFAULT_PARAMS, monitor=None,
                    trace_len: int = 0, key=None, mesh=None,
                    check: bool = False) -> SolveResult:
    """Solve the complex system ``A x = b`` on a complex-less backend with
    the reference's own complex algorithms (pair arithmetic).

    ``A``: a complex LinearOperator (Dense / Sparse / Banded — realified
    internally) or a prebuilt :class:`RealifiedOperator`.  ``b``/``x0``:
    complex host vectors (packed internally).  ``M``: ``"jacobi"``, a
    complex diagonal vector, or any callable on stacked pair vectors.
    Returns a SolveResult whose ``x`` is complex (merged on host).

    Iteration counts match :func:`liblcg_tpu.solve`'s complex engines
    (same recurrences; reduction order differs so very ill-conditioned
    systems may shift by a few counts) — and through them the reference
    binary (test_reference_parity.py bands).

    SPMD: pass ``A`` as a
    :class:`~liblcg_tpu.parallel.ShardedRealifiedOperator` (optionally
    with ``mesh=``) and the solve runs sharded over the device mesh —
    vectors as local ``[re_d; im_d]`` shards, reductions as psums
    (delegates to :func:`liblcg_tpu.solve_realified_sharded`).
    """
    from ..solve import canonical_method

    # Mesh-aware route: a sharded operator (or an explicit mesh) solves
    # SPMD via parallel/realified.py.
    from ..parallel.realified import (ShardedRealifiedOperator,
                                      solve_realified_sharded)

    if isinstance(A, ShardedRealifiedOperator) or mesh is not None:
        return solve_realified_sharded(
            A, b, x0, method=method, M=M, mesh=mesh, params=params,
            monitor=monitor, trace_len=trace_len, key=key, check=check)

    m = canonical_method(method)
    if m not in _PAIR_ENGINES:
        raise ValueError(
            f"pair-complex engines support {sorted(_PAIR_ENGINES)}; got {m!r}"
        )
    fn, needs_M = _PAIR_ENGINES[m]

    # Invalid params return the reference's error status
    # (lcg.cpp:150-155) without running a solve.
    err = params.validate(for_method=m)
    if err is not None:
        # x stays HOST numpy: a complex device array is a deferred
        # UNIMPLEMENTED bomb on the very backends this API serves.
        return SolveResult(
            x=np.zeros_like(np.asarray(b)),
            status_code=jnp.asarray(int(err), jnp.int32),
            iterations=jnp.asarray(0, jnp.int32),
            residual=jnp.asarray(jnp.nan), trace=None)


    b_np = np.asarray(b)
    if (np.iscomplexobj(b_np) and b_np.dtype == np.complex128
            and not jax.config.jax_enable_x64):
        import warnings

        warnings.warn(
            "solve_realified: complex128 input with jax_enable_x64 OFF — "
            "the pair arithmetic silently truncates to float32, and "
            "ill-conditioned systems then need many times the reference's "
            "iteration count (measured: 366 -> 2203 on case_10K_cA).  "
            "Call jax.config.update('jax_enable_x64', True) for "
            "double-precision parity.",
            stacklevel=2,
        )
    if isinstance(A, RealifiedOperator):
        R = A
        diag_c = None
    else:
        if not isinstance(A, LinearOperator):
            raise TypeError("A must be a LinearOperator or RealifiedOperator")
        diag_c = np.asarray(A.diagonal()) if needs_M else None
        R = realify(A)

    b = np.asarray(b)
    bp = jnp.asarray(split_complex(b) if np.iscomplexobj(b) else
                     np.concatenate([b, np.zeros_like(b)]))
    x0p = None if x0 is None else jnp.asarray(split_complex(np.asarray(x0)))

    if needs_M:
        if M is None:
            return SolveResult(
                x=np.zeros_like(b),
                status_code=jnp.asarray(
                    int(Status.NULL_PRECONDITION_MATRIX), jnp.int32),
                iterations=jnp.asarray(0, jnp.int32),
                residual=jnp.asarray(jnp.nan), trace=None)
        if isinstance(M, str) and M == "jacobi":
            if diag_c is None:
                raise ValueError(
                    "M='jacobi' needs a complex operator with .diagonal(); "
                    "pass the complex diagonal explicitly instead")
            M = PairJacobi.from_complex_diag(diag_c)
        elif not callable(M) and not hasattr(M, "mv"):
            # A complex diagonal vector.
            M = PairJacobi.from_complex_diag(np.asarray(M))

    M_traced = needs_M and isinstance(M, PairJacobi)
    # PRNG keys are jax arrays (unhashable) — hash their bytes; the key
    # itself is closed over in `run` below, so a different key value is
    # a different cache entry with the right constant baked in.
    if m not in _KEYED_METHODS or key is None:
        key_id = None
    else:
        try:
            key_id = np.asarray(key).tobytes()
        except TypeError:  # new-style typed PRNG key array
            key_id = np.asarray(jax.random.key_data(key)).tobytes()
    cache_key = (fn, params, monitor, trace_len,
                 None if M_traced or not needs_M else M,
                 key_id)
    jitted = _JIT_CACHE.get(cache_key)
    if jitted is None:
        def run(R_, b_, x_, *extras):
            kwargs = dict(params=params, monitor=monitor,
                          trace_len=trace_len)
            if m in _KEYED_METHODS:
                kwargs["key"] = key
            if needs_M:
                kwargs["M"] = extras[0] if M_traced else M
            return fn(R_, b_, x_, **kwargs)

        jitted = jax.jit(run)
        _JIT_CACHE[cache_key] = jitted

    extras = (M,) if M_traced else ()
    carry = jitted(R, bp, jnp.zeros_like(bp) if x0p is None else x0p,
                   *extras)
    x = merge_complex(carry["x"])
    result = SolveResult(
        x=x,
        status_code=carry["status"],
        iterations=carry["t"],
        residual=carry["residual"],
        trace=carry.get("trace"),
    )
    if check:
        from ..utils.errors import check_status

        check_status(result.status_code, raise_error=True, quiet=True)
    return result


class _VmappedPairOp:
    """Trace-time adapter mapping a stacked-pair operator over
    (nrhs, 2n) batches; exposes vmapped ``.re``/``.im`` sub-products for
    pbicg's conj(A) mode (cf. solve._VmappedOperator)."""

    def __init__(self, R):
        self._R = R
        from ..solve import _VmappedOperator

        self.re = _VmappedOperator(R.re)
        self.im = _VmappedOperator(R.im)

    def mv(self, X):
        return jax.vmap(self._R.mv)(X)

    def rmv(self, X):
        return jax.vmap(self._R.rmv)(X)


#: pair engines with a batched (multi-RHS) form.  tfqmr_pairs is a
#: custom half-step loop without per-system freezing — excluded (use
#: independent solves).
_BATCHED_PAIR_METHODS = ("bicg", "bicg_sym", "cgs", "bicgstab", "pcg",
                         "pbicg")

_BATCHED_JIT_CACHE: dict = {}


def solve_realified_batched(A, B, X0=None, *, method: str = "bicg_sym",
                            M=None, params: SolverParams = DEFAULT_PARAMS,
                            monitor=None, trace_len: int = 0, key=None,
                            check: bool = False) -> SolveResult:
    """Solve a STACK of complex systems ``A x_i = B_i`` on a complex-less
    backend in one compiled program (pair arithmetic, per-system
    freezing through the batched harness).

    ``B``: complex host (nrhs, n).  Returns per-system
    status/iterations/residual (and ``(nrhs, trace_len)`` trace rows)
    with ``x`` complex (nrhs, n).  The multi-RHS complex analogue of
    :func:`liblcg_tpu.solve_batched` — the reference solves strictly one
    b at a time (lcg.h:61).
    """
    from ..solve import canonical_method

    m = canonical_method(method)
    if m not in _BATCHED_PAIR_METHODS:
        raise ValueError(
            f"batched pair-complex engines support "
            f"{sorted(_BATCHED_PAIR_METHODS)}; got {m!r}"
        )
    fn, needs_M = _PAIR_ENGINES[m]

    B_np = np.asarray(B)
    if B_np.ndim != 2:
        raise ValueError(f"B must be (nrhs, n), got {B_np.shape}")
    nrhs, n = B_np.shape
    if (np.iscomplexobj(B_np) and B_np.dtype == np.complex128
            and not jax.config.jax_enable_x64):
        import warnings

        warnings.warn(
            "solve_realified_batched: complex128 input with "
            "jax_enable_x64 OFF truncates to float32 (see "
            "solve_realified's warning for the measured cost).",
            stacklevel=2,
        )

    if isinstance(A, RealifiedOperator):
        R = A
        diag_c = None
    else:
        if not isinstance(A, LinearOperator):
            raise TypeError("A must be a LinearOperator or RealifiedOperator")
        diag_c = np.asarray(A.diagonal()) if needs_M else None
        R = realify(A)

    def pack(Z):
        Z = np.asarray(Z)
        if not np.iscomplexobj(Z):
            Z = Z.astype(complex)
        return jnp.asarray(np.concatenate([Z.real, Z.imag], axis=-1))

    Bp = pack(B_np)
    X0p = None if X0 is None else pack(X0)

    err = params.validate(for_method=m)
    if err is not None:
        return SolveResult(
            x=np.zeros_like(B_np),
            status_code=jnp.full((nrhs,), int(err), jnp.int32),
            iterations=jnp.zeros((nrhs,), jnp.int32),
            residual=jnp.full((nrhs,), jnp.nan), trace=None)

    if needs_M:
        if M is None:
            return SolveResult(
                x=np.zeros_like(B_np),
                status_code=jnp.full(
                    (nrhs,), int(Status.NULL_PRECONDITION_MATRIX),
                    jnp.int32),
                iterations=jnp.zeros((nrhs,), jnp.int32),
                residual=jnp.full((nrhs,), jnp.nan), trace=None)
        if isinstance(M, str) and M == "jacobi":
            if diag_c is None:
                raise ValueError(
                    "M='jacobi' needs a complex operator with .diagonal(); "
                    "pass the complex diagonal explicitly instead")
            M = PairJacobi.from_complex_diag(diag_c)
        elif not callable(M) and not hasattr(M, "mv"):
            M = PairJacobi.from_complex_diag(np.asarray(M))

    M_traced = needs_M and isinstance(M, PairJacobi)
    if m not in _KEYED_METHODS or key is None:
        key_id = None
    else:
        try:
            key_id = np.asarray(key).tobytes()
        except TypeError:
            key_id = np.asarray(jax.random.key_data(key)).tobytes()
    cache_key = ("batched", fn, params, monitor, trace_len, nrhs,
                 None if M_traced or not needs_M else M, key_id)
    jitted = _BATCHED_JIT_CACHE.get(cache_key)
    if jitted is None:
        def run(R_, B_, X_, *extras):
            kwargs = dict(params=params, monitor=monitor,
                          trace_len=trace_len)
            if m in _KEYED_METHODS:
                kwargs["key"] = key
            Rb = _VmappedPairOp(R_)
            if needs_M:
                Mx = extras[0] if M_traced else M
                apply_M = Mx.mv if hasattr(Mx, "mv") else Mx
                kwargs["M"] = apply_M   # diag_mul broadcasts over rows
            with H.batched(nrhs=nrhs):
                return fn(Rb, B_, X_, **kwargs)

        jitted = jax.jit(run)
        _BATCHED_JIT_CACHE[cache_key] = jitted

    extras = (M,) if M_traced else ()
    carry = jitted(R, Bp, jnp.zeros_like(Bp) if X0p is None else X0p,
                   *extras)
    x2 = np.asarray(carry["x"])
    x = x2[:, :n] + 1j * x2[:, n:]
    result = SolveResult(
        x=x,
        status_code=carry["status"],
        iterations=carry["t"],
        residual=carry["residual"],
        trace=carry.get("trace"),
    )
    if check:
        from ..utils.errors import check_status

        for s in np.asarray(result.status_code):
            check_status(s, raise_error=True, quiet=True)
    return result
