#!/usr/bin/env python3
"""Smoke test of liblcg_tpu on one NVIDIA GPU, at the sizes users solve.

    python chip_smoke.py [--seed N]          # one card: phases 1-7
    python chip_smoke.py --multi [--seed N]  # four cards: sharded solves only

Every phase drives the library's public entry points (``solve``,
``solve_batched``, ``solve_refined``, ``solve_realified``, ``solve_sharded``)
and checks the answer against a plain reference written here, in f64,
independent of ``liblcg_tpu.operators``: pad-and-slice ``jax.numpy`` for the
7-point stencils, ``scipy.sparse`` CSR on the host for banded and scattered
systems.  Each phase prints one line per solve: shape, dtype, method,
status, iterations, the true relative residual ``||b - A x|| / ||b||`` and
its tolerance, and the warm wall time (the second call of the same solve,
ended by ``block_until_ready``) with microseconds per iteration.

Tolerances.  f64 solves stop at a recurrence residual 10x below the stated
true-residual tolerance; f32 solves stop at 1e-5 relative and are held to
1e-4, the gap covering f32 drift between recurrence and true residual.

Reduction order.  Phases 1, 2, 5 and 6 also solve a reduced instance (32^3
or n = 10^4) on the GPU and on ``jax.devices("cpu")[0]`` in this process and
compare iteration counts: equal within 1 in f64, within max(2, 3 %) in f32.
The GPU sums dot products in another order than the CPU, and in f32 that
moves the iteration at which the stopping test first passes.

Exit status is 0 only when every phase ran and met its tolerances; the last
line of standard output is then one JSON object naming the device.  With no
GPU the script exits non-zero before any solve.

The compile cache lives in ``$JAX_COMPILATION_CACHE_DIR`` when that is set,
else in ``.jax_cache`` beside this file.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

F32_STOP, F32_TOL = 1e-5, 1e-4


# --------------------------------------------------------------------------
# Plain references (f64, independent of liblcg_tpu.operators)
# --------------------------------------------------------------------------


def lap7_ref(x, grid):
    """7-point Dirichlet Laplacian ``6u - sum(face neighbours)`` in f64,
    by zero padding and slicing."""
    import jax.numpy as jnp

    u = jnp.asarray(x).astype(jnp.float64).reshape(grid)
    p = jnp.pad(u, 1)
    y = (6.0 * u
         - p[:-2, 1:-1, 1:-1] - p[2:, 1:-1, 1:-1]
         - p[1:-1, :-2, 1:-1] - p[1:-1, 2:, 1:-1]
         - p[1:-1, 1:-1, :-2] - p[1:-1, 1:-1, 2:])
    return y.reshape(-1)


def rel_res_stencil(x, b, grid):
    import jax.numpy as jnp

    b64 = jnp.asarray(b).astype(jnp.float64)
    r = b64 - lap7_ref(x, grid)
    return float(jnp.linalg.norm(r) / jnp.linalg.norm(b64))


def csr(n, rows, cols, vals):
    import scipy.sparse as sp

    return sp.csr_matrix((vals, (rows, cols)), shape=(n, n))


def rel_res_csr(A_ref, x, b):
    x64 = np.asarray(x).astype(np.complex128 if np.iscomplexobj(x)
                               else np.float64)
    b64 = np.asarray(b).astype(x64.dtype)
    r = b64 - A_ref @ x64
    return float(np.linalg.norm(r) / np.linalg.norm(b64))


# --------------------------------------------------------------------------
# Seeded systems
# --------------------------------------------------------------------------


def lap7_coo(grid):
    """COO triplets of the 7-point Laplacian (for operators built from COO
    and for the IC factorisation)."""
    nz, ny, nx = grid
    n = nz * ny * nx
    idx = np.arange(n, dtype=np.int64).reshape(grid)
    rows, cols = [idx.ravel()], [idx.ravel()]
    for ax in range(3):
        lo = [slice(None)] * 3
        hi = [slice(None)] * 3
        lo[ax] = slice(0, -1)
        hi[ax] = slice(1, None)
        a, c = idx[tuple(lo)].ravel(), idx[tuple(hi)].ravel()
        rows += [a, c]
        cols += [c, a]
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    vals = np.where(rows == cols, 6.0, -1.0)
    return n, rows, cols, vals


def case10k_like(rng, n=10_000):
    """SPD system of the case_10K structure: 19 diagonals (the main one
    and 9 symmetric pairs), about 48,800 nonzeros, diagonally dominant."""
    offsets = (1, 2, 3, 7, 10, 50, 100, 101, 200)
    rows, cols, vals = [], [], []
    for k in offsets:
        i = np.nonzero(rng.random(n - k) < 0.216)[0]
        v = -rng.uniform(0.1, 1.0, i.size)
        rows += [i, i + k]
        cols += [i + k, i]
        vals += [v, v]
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    vals = np.concatenate(vals)
    rowabs = np.bincount(rows, weights=np.abs(vals), minlength=n)
    d = np.arange(n)
    diag = rowabs + rng.uniform(0.05, 0.15, n)
    return (n, np.concatenate([rows, d]), np.concatenate([cols, d]),
            np.concatenate([vals, diag]))


def implicit_diffusion_7diag(rng, n=10_000_000, nx=216):
    """One implicit step of variable-coefficient diffusion: 7 diagonals
    at offsets 0, +-1, +-nx, +-nx^2 with random conductances and a unit
    mass term, SPD."""
    rows, cols, vals = [], [], []
    for k in (1, nx, nx * nx):
        i = np.arange(n - k, dtype=np.int64)
        v = -rng.uniform(0.5, 1.0, n - k)
        rows += [i, i + k]
        cols += [i + k, i]
        vals += [v, v]
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    vals = np.concatenate(vals)
    rowabs = np.bincount(rows, weights=np.abs(vals), minlength=n)
    d = np.arange(n, dtype=np.int64)
    return (n, np.concatenate([rows, d]), np.concatenate([cols, d]),
            np.concatenate([vals, rowabs + 1.0]))


def shifted_lap_c128(rng, grid):
    """Complex-symmetric frequency-domain operator: the 7-point Laplacian
    plus a complex diagonal shift (absorbing medium), A = A^T."""
    n, rows, cols, vals = lap7_coo(grid)
    vals = vals.astype(np.complex128)
    on = rows == cols
    vals[on] += 0.02 + 1j * rng.uniform(0.05, 0.15, int(on.sum()))
    return n, rows, cols, vals


def scattered_c128(rng, n=10_000, n_pairs=100):
    """Diagonal plus 200 symmetric couplings (the case_10K_cA shape)."""
    i = rng.choice(n, n_pairs, replace=False)
    j = (i + rng.integers(1, n - 1, n_pairs)) % n
    v = rng.uniform(-1, 1, n_pairs) + 1j * rng.uniform(-1, 1, n_pairs)
    d = np.arange(n)
    diag = 4.0 + rng.uniform(0, 1, n) + 1j * rng.uniform(0.1, 0.5, n)
    rows = np.concatenate([d, i, j])
    cols = np.concatenate([d, j, i])
    vals = np.concatenate([diag, v, v])
    return n, rows, cols, vals


def anisotropic_coo(grid, weak=1e-3, shift=1e-4):
    """Anisotropic 7-point operator on a long thin column: strong coupling
    along z, weak across, a small SPD shift.  Its bandwidth is ny*nx, so
    the IC(0) factor stays banded."""
    nz, ny, nx = grid
    n = nz * ny * nx
    idx = np.arange(n, dtype=np.int64).reshape(grid)
    rows, cols, vals = [], [], []
    for ax, c in ((0, 1.0), (1, weak), (2, weak)):
        lo = [slice(None)] * 3
        hi = [slice(None)] * 3
        lo[ax] = slice(0, -1)
        hi[ax] = slice(1, None)
        a, b = idx[tuple(lo)].ravel(), idx[tuple(hi)].ravel()
        rows += [a, b]
        cols += [b, a]
        vals += [np.full(a.size, -c), np.full(a.size, -c)]
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    vals = np.concatenate(vals)
    rowabs = np.bincount(rows, weights=np.abs(vals), minlength=n)
    d = np.arange(n, dtype=np.int64)
    return (n, np.concatenate([rows, d]), np.concatenate([cols, d]),
            np.concatenate([vals, rowabs + shift]))


# --------------------------------------------------------------------------
# Reporting
# --------------------------------------------------------------------------


class Report:
    """Collects one line per solve and every failed check."""

    def __init__(self):
        self.failures = []

    def check(self, ok, what):
        if not ok:
            self.failures.append(what)
        return ok

    def solve_line(self, tag, desc, res, true_res, tol, wall, extra=""):
        from liblcg_tpu import Status

        iters = np.asarray(res.iterations)
        status = np.asarray(res.status_code)
        it = int(iters.max())
        names = sorted({Status(int(s)).name for s in np.ravel(status)})
        conv = all(int(s) in (int(Status.CONVERGENCE),
                              int(Status.ALREADY_OPTIMIZED))
                   for s in np.ravel(status))
        ok = conv and np.isfinite(true_res) and true_res <= tol
        us = wall * 1e6 / max(it, 1)
        print(f"[{tag}] {desc:<44} | {'/'.join(names):<11} it={it:>5} | "
              f"true_res={true_res:.3e} <= {tol:.0e} | "
              f"warm {wall * 1e3:10.3f} ms {us:10.2f} us/it"
              f"{' | ' + extra if extra else ''} | {'ok' if ok else 'FAIL'}",
              flush=True)
        self.check(ok, f"{tag} {desc}: status {names}, true residual "
                       f"{true_res:.3e} (tolerance {tol:.0e})")
        return it

    def compare_line(self, tag, desc, it_a, it_b, f32):
        slack = max(2, int(np.ceil(0.03 * max(it_a, it_b)))) if f32 else 1
        ok = abs(it_a - it_b) <= slack
        print(f"[{tag}] {desc:<44} | gpu it={it_a} cpu it={it_b} "
              f"(|diff| <= {slack}) | {'ok' if ok else 'FAIL'}", flush=True)
        self.check(ok, f"{tag} {desc}: gpu {it_a} vs cpu {it_b} iterations")


def run_warm(fn):
    """First call compiles; the second, timed, is the warm wall time."""
    import jax

    r = fn()
    jax.block_until_ready((r.x, r.iterations))
    t0 = time.perf_counter()
    r = fn()
    jax.block_until_ready((r.x, r.iterations))
    return r, time.perf_counter() - t0


def stop_eps(target, b_norm, x_norm, power=2):
    """Epsilon of the reference metric ``||r||^p / max(||x||^p, 1)`` that
    stops at ``||r|| ~ target * ||b||`` (p = 2 real, 4 complex)."""
    return float((target * b_norm / max(x_norm, 1.0)) ** power)


def cpu_device():
    import jax

    return jax.default_device(jax.devices("cpu")[0])


# --------------------------------------------------------------------------
# Phases
# --------------------------------------------------------------------------


def phase1_cg_f64(rep, key, grid=256, small=32):
    import jax
    import jax.numpy as jnp
    import liblcg_tpu as lcg

    def one(g):
        shape = (g, g, g)
        A = lcg.Laplacian3DOperator(*shape, dtype=jnp.float64)
        x_true = jax.random.uniform(key, (g ** 3,), jnp.float64, -1.0, 1.0)
        b = lap7_ref(x_true, shape)
        p = lcg.SolverParams(
            epsilon=stop_eps(1e-9, float(jnp.linalg.norm(b)),
                             float(jnp.linalg.norm(x_true))),
            max_iterations=20000)
        res, wall = run_warm(lambda: lcg.solve(A, b, method="cg", params=p))
        err = float(jnp.linalg.norm(res.x - x_true) / jnp.linalg.norm(x_true))
        return res, wall, rel_res_stencil(res.x, b, shape), err

    res, wall, tr, err = one(grid)
    rep.solve_line("p1", f"lap7 {grid}^3 float64 cg", res, tr, 1e-8, wall,
                   f"rel_err={err:.3e}")
    r_g, w_g, tr_g, _ = one(small)
    rep.solve_line("p1", f"lap7 {small}^3 float64 cg (gpu)", r_g, tr_g, 1e-8,
                   w_g)
    with cpu_device():
        r_c, w_c, tr_c, _ = one(small)
    rep.solve_line("p1", f"lap7 {small}^3 float64 cg (cpu)", r_c, tr_c, 1e-8,
                   w_c)
    rep.compare_line("p1", f"lap7 {small}^3 float64 cg gpu vs cpu",
                     int(r_g.iterations), int(r_c.iterations), f32=False)


BANDED_METHODS = ("cg", "pcg", "cgs", "bicgstab", "bicgstab2")


def _banded_solves(rep, tag, label, system, rng, methods=BANDED_METHODS):
    """f32 solves of one banded system through ``solve()``'s default
    route; returns {method: iterations}."""
    import jax
    import jax.numpy as jnp
    import liblcg_tpu as lcg

    n, rows, cols, vals = system
    A = lcg.make_sparse_operator(n, n, rows, cols, vals, dtype=jnp.float32)
    assert isinstance(A, lcg.BandedOperator), type(A)
    A_ref = csr(n, rows, cols, vals.astype(np.float32).astype(np.float64))
    x_true = rng.uniform(-1.0, 1.0, n)
    b32 = np.asarray(A_ref @ x_true, np.float32)
    b = jnp.asarray(b32)
    p = lcg.SolverParams(
        epsilon=stop_eps(F32_STOP, np.linalg.norm(b32),
                         np.linalg.norm(x_true)),
        max_iterations=20000)
    its = {}
    for m in methods:
        kw = {"M": lcg.JacobiPreconditioner(A)} if m == "pcg" else {}
        res, wall = run_warm(
            lambda: lcg.solve(A, b, method=m, params=p, **kw))
        its[m] = rep.solve_line(
            tag, f"{label} float32 {m}", res,
            rel_res_csr(A_ref, res.x, b32), F32_TOL, wall)
    return its


def phase2_banded_f32(rep, seed, n_big=10_000_000, nx_big=216):
    rng = np.random.default_rng(seed)
    small = case10k_like(rng)
    big = implicit_diffusion_7diag(rng, n_big, nx_big)
    its_g = _banded_solves(rep, "p2", f"case10k-like n={small[0]} d=19",
                           small, np.random.default_rng(seed + 1))
    _banded_solves(rep, "p2", f"diffusion n={big[0]} d=7", big,
                   np.random.default_rng(seed + 2))
    with cpu_device():
        its_c = _banded_solves(rep, "p2", f"case10k-like n={small[0]} (cpu)",
                               small, np.random.default_rng(seed + 1))
    for m in BANDED_METHODS:
        rep.compare_line("p2", f"case10k-like float32 {m} gpu vs cpu",
                         its_g[m], its_c[m], f32=True)


def phase3_batched(rep, seed, nrhs=32):
    import jax.numpy as jnp
    import liblcg_tpu as lcg

    rng = np.random.default_rng(seed)
    n, rows, cols, vals = case10k_like(rng)
    A = lcg.make_sparse_operator(n, n, rows, cols, vals, dtype=jnp.float32)
    A_ref = csr(n, rows, cols, vals.astype(np.float32).astype(np.float64))
    X_true = rng.uniform(-1.0, 1.0, (nrhs, n))
    B32 = np.asarray((A_ref @ X_true.T).T, np.float32)
    ratio = np.median(np.linalg.norm(B32, axis=1)
                      / np.linalg.norm(X_true, axis=1))
    p = lcg.SolverParams(epsilon=float((F32_STOP * ratio) ** 2),
                         max_iterations=20000)
    B = jnp.asarray(B32)
    single = []
    for i in range(nrhs):
        r = lcg.solve(A, B[i], method="cg", params=p)
        single.append(int(r.iterations))
    single = np.asarray(single)
    for m in ("cg", "block_cg"):
        res, wall = run_warm(
            lambda: lcg.solve_batched(A, B, method=m, params=p))
        X = np.asarray(res.x)
        worst = max(rel_res_csr(A_ref, X[i], B32[i]) for i in range(nrhs))
        it_b = np.asarray(res.iterations)
        if m == "cg":
            d = int(np.abs(it_b - single).max())
            extra = f"max |batched - single| it = {d} (<= 2)"
            ok = d <= 2
        else:
            # One shared block Krylov space: never more iterations than
            # the slowest single solve.
            extra = (f"block it={int(it_b.max())} vs single max "
                     f"{int(single.max())} (<= +2)")
            ok = int(it_b.max()) <= int(single.max()) + 2
        rep.solve_line("p3", f"case10k-like x{nrhs} float32 {m}", res,
                       worst, F32_TOL, wall, extra)
        rep.check(ok, f"p3 {m}: {extra}")


def phase4_refined(rep, key, grid=256):
    import jax
    import jax.numpy as jnp
    import liblcg_tpu as lcg

    shape = (grid, grid, grid)
    A = lcg.Laplacian3DOperator(*shape, dtype=jnp.float64)
    x_true = jax.random.uniform(key, (grid ** 3,), jnp.float64, -1.0, 1.0)
    b = lap7_ref(x_true, shape)
    p = lcg.SolverParams(
        epsilon=stop_eps(1e-11, float(jnp.linalg.norm(b)),
                         float(jnp.linalg.norm(x_true))))
    res, wall = run_warm(
        lambda: lcg.solve_refined(A, b, method="cg", params=p,
                                  inner_dtype=jnp.float32, trace_len=8))
    refinements = int(np.count_nonzero(np.asarray(res.trace)))
    rep.solve_line("p4", f"lap7 {grid}^3 f64 refined (f32 cg inner)", res,
                   rel_res_stencil(res.x, b, shape), 1e-10, wall,
                   f"refinements={refinements}, it = inner total")


def phase5_cacg(rep, key, grid=256, small=32, s=4):
    import jax
    import jax.numpy as jnp
    import liblcg_tpu as lcg

    def one(g, methods):
        shape = (g, g, g)
        A = lcg.Laplacian3DOperator(*shape, dtype=jnp.float32)
        x_true = jax.random.uniform(key, (g ** 3,), jnp.float32, -1.0, 1.0)
        b = lap7_ref(x_true, shape).astype(jnp.float32)
        p = lcg.SolverParams(
            epsilon=stop_eps(F32_STOP, float(jnp.linalg.norm(b)),
                             float(jnp.linalg.norm(x_true))),
            max_iterations=20000)
        out = {}
        for m in methods:
            res, wall = run_warm(
                lambda: lcg.solve(A, b, method=m, params=p, s=s))
            out[m] = (res, wall, rel_res_stencil(res.x, b, shape))
        return out

    big = one(grid, ("cacg", "cg"))
    for m, (res, wall, tr) in big.items():
        label = f"cacg s={s} chebyshev" if m == "cacg" else "cg"
        rep.solve_line("p5", f"lap7 {grid}^3 float32 {label}", res, tr,
                       F32_TOL, wall)
    r_g = one(small, ("cacg",))["cacg"]
    rep.solve_line("p5", f"lap7 {small}^3 float32 cacg (gpu)", r_g[0],
                   r_g[2], F32_TOL, r_g[1])
    with cpu_device():
        r_c = one(small, ("cacg",))["cacg"]
    rep.solve_line("p5", f"lap7 {small}^3 float32 cacg (cpu)", r_c[0],
                   r_c[2], F32_TOL, r_c[1])
    rep.compare_line("p5", f"lap7 {small}^3 float32 cacg gpu vs cpu",
                     int(r_g[0].iterations), int(r_c[0].iterations),
                     f32=True)


def _complex_solves(rep, tag, label, system, rng, methods, tol=1e-8):
    import jax.numpy as jnp
    import liblcg_tpu as lcg

    n, rows, cols, vals = system
    A = lcg.make_sparse_operator(n, n, rows, cols, vals)
    A_ref = csr(n, rows, cols, vals)
    x_true = rng.uniform(-1, 1, n) + 1j * rng.uniform(-1, 1, n)
    b_np = A_ref @ x_true
    b = jnp.asarray(b_np)
    p = lcg.SolverParams(
        epsilon=stop_eps(0.1 * tol, np.linalg.norm(b_np),
                         np.linalg.norm(x_true), power=4),
        max_iterations=20000)
    out = {}
    for m in methods:
        kw = {"M": lcg.JacobiPreconditioner(A)} if m == "pcg" else {}
        res, wall = run_warm(lambda: lcg.solve(A, b, method=m, params=p,
                                               **kw))
        out[m] = res
        rep.solve_line(tag, f"{label} complex128 {m}", res,
                       rel_res_csr(A_ref, res.x, b_np), tol, wall,
                       f"operator={type(A).__name__}")
    return A, A_ref, b_np, p, out


def phase6_complex(rep, seed, grid=64, small=32):
    import liblcg_tpu as lcg

    rng = np.random.default_rng(seed)
    helm = shifted_lap_c128(rng, (grid, grid, grid))
    _complex_solves(rep, "p6", f"shifted lap7 {grid}^3", helm,
                    np.random.default_rng(seed + 1), ("bicg_sym", "tfqmr"))

    scat = scattered_c128(np.random.default_rng(seed + 2))
    A, A_ref, b_np, p, native = _complex_solves(
        rep, "p6", f"scattered n={scat[0]} +200", scat,
        np.random.default_rng(seed + 3), ("pcg",))
    res, wall = run_warm(lambda: lcg.solve_realified(
        A, b_np, method="pcg", M="jacobi", params=p))
    it_r, it_n = int(res.iterations), int(native["pcg"].iterations)
    rel = float(np.linalg.norm(np.asarray(res.x) - np.asarray(native["pcg"].x))
                / np.linalg.norm(np.asarray(native["pcg"].x)))
    rep.solve_line("p6", f"scattered n={scat[0]} realified pcg jacobi", res,
                   rel_res_csr(A_ref, res.x, b_np), 1e-8, wall,
                   f"native it={it_n}, |x_r - x_n|/|x_n|={rel:.2e}")
    rep.check(abs(it_r - it_n) <= 2 and rel <= 1e-8,
              f"p6 realified vs native pcg: it {it_r} vs {it_n}, "
              f"solution difference {rel:.2e}")

    small_sys = shifted_lap_c128(np.random.default_rng(seed + 4),
                                 (small, small, small))
    g = {}
    c = {}
    _, _, _, _, g["h"] = _complex_solves(
        rep, "p6", f"shifted lap7 {small}^3 (gpu)", small_sys,
        np.random.default_rng(seed + 5), ("bicg_sym", "tfqmr"))
    _, _, _, _, g["s"] = _complex_solves(
        rep, "p6", f"scattered n={scat[0]} (gpu)", scat,
        np.random.default_rng(seed + 3), ("pcg",))
    with cpu_device():
        _, _, _, _, c["h"] = _complex_solves(
            rep, "p6", f"shifted lap7 {small}^3 (cpu)", small_sys,
            np.random.default_rng(seed + 5), ("bicg_sym", "tfqmr"))
        _, _, _, _, c["s"] = _complex_solves(
            rep, "p6", f"scattered n={scat[0]} (cpu)", scat,
            np.random.default_rng(seed + 3), ("pcg",))
    for k, m in (("h", "bicg_sym"), ("h", "tfqmr"), ("s", "pcg")):
        rep.compare_line("p6", f"complex128 {m} gpu vs cpu",
                         int(g[k][m].iterations), int(c[k][m].iterations),
                         f32=False)


def phase7_ic(rep, seed, grid=(16384, 8, 8)):
    import jax.numpy as jnp
    import liblcg_tpu as lcg
    from liblcg_tpu import native
    from liblcg_tpu.precond.incomplete import incomplete_cholesky_coo

    n, rows, cols, vals = anisotropic_coo(grid)
    A = lcg.make_sparse_operator(n, n, rows, cols, vals, dtype=jnp.float32)
    A_ref = csr(n, rows, cols, vals.astype(np.float32).astype(np.float64))
    rng = np.random.default_rng(seed)
    x_true = rng.uniform(-1.0, 1.0, n)
    b32 = np.asarray(A_ref @ x_true, np.float32)
    b = jnp.asarray(b32)
    p = lcg.SolverParams(
        epsilon=stop_eps(F32_STOP, np.linalg.norm(b32),
                         np.linalg.norm(x_true)),
        max_iterations=20000)
    t0 = time.perf_counter()
    fac = incomplete_cholesky_coo(n, rows, cols, vals)
    t_fac = time.perf_counter() - t0
    runtime = "native C++" if native.available() else "Python fallback"
    f32 = dict(l_vals=fac.l_vals.astype(np.float32),
               u_vals=fac.u_vals.astype(np.float32))
    preconds = {
        "blocked": fac.preconditioner(mode="blocked", block=128,
                                      dtype=jnp.float32),
        "levels": fac._replace(**f32).preconditioner(mode="levels"),
    }
    its = {}
    for name, M in preconds.items():
        res, wall = run_warm(lambda: lcg.solve(A, b, method="pcg", M=M,
                                               params=p))
        its[name] = rep.solve_line(
            "p7", f"aniso {grid[0]}x{grid[1]}x{grid[2]} f32 ic0-pcg {name}",
            res, rel_res_csr(A_ref, res.x, b32), F32_TOL, wall,
            f"factor {runtime} {t_fac:.2f} s")
    res, wall = run_warm(lambda: lcg.solve(A, b, method="cg", params=p))
    rep.solve_line("p7", f"aniso {grid[0]}x{grid[1]}x{grid[2]} f32 cg",
                   res, rel_res_csr(A_ref, res.x, b32), F32_TOL, wall,
                   "unpreconditioned, for scale")
    rep.check(abs(its["blocked"] - its["levels"]) <= 2,
              f"p7 blocked vs levels IC apply: {its}")


def phase_multi(rep, key, seed, grid=512, n_banded=10_000_000, nx_banded=216,
                s=4):
    """Sharded solves over 4 cards, each compared with card 0 alone."""
    import jax
    import jax.numpy as jnp
    import liblcg_tpu as lcg
    from liblcg_tpu.parallel import ShardedBandedOperator

    D = 4
    devs = jax.devices()
    if not rep.check(len(devs) >= D, f"--multi needs {D} devices, "
                                     f"found {len(devs)}"):
        return
    mesh = lcg.make_mesh(D)

    def compare(desc, r_sh, r_one, true_res, tol, wall_sh, wall_one):
        where = sorted(str(d) for d in r_sh.x.sharding.device_set)
        x_sh = np.asarray(r_sh.x, np.float64)
        x_one = np.asarray(r_one.x, np.float64)
        rep.solve_line("multi", f"{desc} sharded x{D}", r_sh,
                       true_res(x_sh), tol, wall_sh,
                       f"x on {len(where)} devices: {where}")
        rep.solve_line("multi", f"{desc} card 0", r_one, true_res(x_one),
                       tol, wall_one)
        it_s, it_o = int(r_sh.iterations), int(r_one.iterations)
        rel = float(np.linalg.norm(x_sh - x_one) / np.linalg.norm(x_one))
        ok = abs(it_s - it_o) <= 2 and rel <= 1e-4 and len(where) == D
        print(f"[multi] {desc}: sharded it={it_s} card0 it={it_o} "
              f"|x_s - x_0|/|x_0|={rel:.2e} (<= 1e-4) | "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        rep.check(ok, f"multi {desc}: it {it_s} vs {it_o}, diff {rel:.2e}, "
                      f"{len(where)} devices")

    shape = (grid, grid, grid)
    n = grid ** 3
    x_true = jax.random.uniform(key, (n,), jnp.float32, -1.0, 1.0)
    b = lap7_ref(x_true, shape).astype(jnp.float32)
    p = lcg.SolverParams(
        epsilon=stop_eps(F32_STOP, float(jnp.linalg.norm(b)),
                         float(jnp.linalg.norm(x_true))),
        max_iterations=20000)
    A_sh = lcg.ShardedLaplacian3D(*shape, n_devices=D, dtype=jnp.float32)
    A_one = lcg.Laplacian3DOperator(*shape, dtype=jnp.float32)
    for m in ("cg", "cacg"):
        kw = dict(s=s, lmin=0.0, lmax=12.0) if m == "cacg" else {}
        r_sh, w_sh = run_warm(lambda: lcg.solve_sharded(
            A_sh, b, method=m, mesh=mesh, params=p, **kw))
        r_one, w_one = run_warm(lambda: lcg.solve(
            A_one, b, method=m, params=p, **kw))
        compare(f"lap7 {grid}^3 float32 {m}", r_sh, r_one,
                lambda x: rel_res_stencil(x, b, shape), F32_TOL, w_sh, w_one)
        del r_sh, r_one

    rng = np.random.default_rng(seed)
    nb, rows, cols, vals = implicit_diffusion_7diag(rng, n_banded, nx_banded)
    A_ref = csr(nb, rows, cols, vals.astype(np.float32).astype(np.float64))
    xb = rng.uniform(-1.0, 1.0, nb)
    b32 = np.asarray(A_ref @ xb, np.float32)
    pb = lcg.SolverParams(
        epsilon=stop_eps(F32_STOP, np.linalg.norm(b32), np.linalg.norm(xb)),
        max_iterations=20000)
    Ab_sh = ShardedBandedOperator(nb, rows, cols, vals, n_devices=D,
                                  dtype=np.float32)
    Ab_one = lcg.make_sparse_operator(nb, nb, rows, cols, vals,
                                      dtype=jnp.float32)
    M_sh = lcg.JacobiPreconditioner(Ab_sh)
    M_one = lcg.JacobiPreconditioner(Ab_one)
    r_sh, w_sh = run_warm(lambda: lcg.solve_sharded(
        Ab_sh, jnp.asarray(b32), method="pcg", M=M_sh, mesh=mesh,
        params=pb))
    r_one, w_one = run_warm(lambda: lcg.solve(
        Ab_one, jnp.asarray(b32), method="pcg", M=M_one, params=pb))
    compare(f"diffusion n={nb} d=7 float32 pcg jacobi", r_sh, r_one,
            lambda x: rel_res_csr(A_ref, x, b32), F32_TOL, w_sh, w_one)


# --------------------------------------------------------------------------
# Driver
# --------------------------------------------------------------------------


def card_line():
    """``nvidia-smi`` name and power limit of every card, joined by "; "."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return "; ".join(ln.strip() for ln in out.stdout.splitlines()
                     if ln.strip())


def run_phases(rep, phases):
    for name, fn in phases:
        t0 = time.perf_counter()
        print(f"== {name}", flush=True)
        try:
            fn()
        except Exception:  # record, report, and make the run fail
            traceback.print_exc()
            rep.failures.append(f"{name} raised")
        print(f"== {name} done in {time.perf_counter() - t0:.1f} s",
              flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--multi", action="store_true",
                    help="run only the 4-card sharded path and its "
                         "single-card comparison")
    args = ap.parse_args(argv)

    import jax

    if jax.default_backend() != "gpu":
        print(f"chip_smoke: no GPU (JAX backend is "
              f"{jax.default_backend()!r})", file=sys.stderr)
        return 2
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir",
                          os.path.join(REPO, ".jax_cache"))
    jax.config.update("jax_enable_x64", True)

    dev = jax.devices()[0]
    print(f"{card_line()} | jax device_kind: {dev.device_kind} | "
          f"jax {jax.__version__}, {len(jax.devices())} device(s)",
          flush=True)

    from liblcg_tpu import native

    print(f"native host runtime: "
          f"{'built' if native.available() else 'unavailable (Python)'}",
          flush=True)

    key = jax.random.PRNGKey(args.seed)
    k = jax.random.split(key, 4)
    rep = Report()
    s = args.seed
    if args.multi:
        phases = [("multi: sharded over 4 cards vs card 0",
                   lambda: phase_multi(rep, k[0], s))]
    else:
        phases = [
            ("phase 1: f64 CG, 7-point Laplacian 256^3",
             lambda: phase1_cg_f64(rep, k[0])),
            ("phase 2: f32 banded systems through solve()",
             lambda: phase2_banded_f32(rep, s)),
            ("phase 3: solve_batched, 32 right-hand sides",
             lambda: phase3_batched(rep, s + 10)),
            ("phase 4: solve_refined, f32 inner / f64 outer",
             lambda: phase4_refined(rep, k[1])),
            ("phase 5: CA-CG s=4 vs classic CG, 256^3 f32",
             lambda: phase5_cacg(rep, k[2])),
            ("phase 6: native complex and realified pairs",
             lambda: phase6_complex(rep, s + 20)),
            ("phase 7: IC(0)-PCG, anisotropic ~10^6",
             lambda: phase7_ic(rep, s + 30)),
        ]
    run_phases(rep, phases)
    if rep.failures:
        print("FAILED:", file=sys.stderr)
        for f in rep.failures:
            print(f"  {f}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
