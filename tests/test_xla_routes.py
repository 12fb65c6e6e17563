"""The XLA engines that serve every solve, on every backend.

``solve``, ``solve_batched``, ``solve_refined`` and ``ca_cg`` run one
``lax.while_loop`` per solve through XLA on the CPU and the GPU alike.
These tests pin, case for case, the configurations that once had
dedicated whole-solve kernels:

- each method x operator x single/batched case, as the XLA engine against
  a dense numpy f64 solve of the same system;
- each CA-CG grid x s x basis x Jacobi case, against classic CG and numpy;
- each pair-complex case, as the realified pair engine against the native
  complex engines of ``solvers/cplx.py``;
- the routing itself: with a GPU backend reported, the formerly kernel-
  eligible f32 solves import nothing from ``jax.experimental.pallas``;
- the precision of every f32 contraction on the block-CG, blocked-IC and
  CA-CG coefficient paths (a default-precision f32 dot may run in TF32 on
  a GPU).
"""

import os
import re
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import liblcg_tpu as lcg
from liblcg_tpu.solvers.sstep import ca_cg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# Systems
# ---------------------------------------------------------------------------


def _tridiag(n=256, seed=3):
    rng = np.random.default_rng(seed)
    main = 4.0 + rng.uniform(0, 1, n)
    off = rng.uniform(-1, 1, n - 1)
    rows = np.concatenate([np.arange(n), np.arange(n - 1), np.arange(1, n)])
    cols = np.concatenate([np.arange(n), np.arange(1, n), np.arange(n - 1)])
    return n, rows, cols, np.concatenate([main, off, off])


def _banded19(n=1500, seed=5):
    """The case_10K structure at reduced n: 19 diagonals, SPD."""
    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    for k in (1, 2, 3, 7, 10, 50, 100, 101, 200):
        i = np.nonzero(rng.random(n - k) < 0.216)[0]
        v = -rng.uniform(0.1, 1.0, i.size)
        rows += [i, i + k]
        cols += [i + k, i]
        vals += [v, v]
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    vals = np.concatenate(vals)
    diag = np.bincount(rows, weights=np.abs(vals), minlength=n) + 0.1
    d = np.arange(n)
    return (n, np.concatenate([rows, d]), np.concatenate([cols, d]),
            np.concatenate([vals, diag]))


_SYSTEMS = {"tridiag": _tridiag, "banded19": _banded19}


def _dense(n, rows, cols, vals):
    A = np.zeros((n, n), np.asarray(vals).dtype)
    np.add.at(A, (rows, cols), vals)
    return A


def _f32_system(name, nrhs=None, seed=11):
    n, rows, cols, vals = _SYSTEMS[name]()
    vals32 = vals.astype(np.float32)
    A = lcg.BandedOperator(n, n, rows, cols, vals32)
    dense = _dense(n, rows, cols, vals32.astype(np.float64))
    rng = np.random.default_rng(seed)
    shape = (n,) if nrhs is None else (nrhs, n)
    b = rng.uniform(-1, 1, shape).astype(np.float32)
    return A, dense, b


def _numpy_solution(dense, b):
    return np.linalg.solve(dense, np.asarray(b, np.float64).T).T


# ---------------------------------------------------------------------------
# Method x operator x single/batched: XLA engine vs a numpy f64 solve
# ---------------------------------------------------------------------------

_P32 = lcg.SolverParams(epsilon=1e-11, max_iterations=2000)


def _kw(method, A):
    return {"M": lcg.JacobiPreconditioner(A)} if method == "pcg" else {}


@pytest.mark.parametrize("system", ["tridiag", "banded19"])
@pytest.mark.parametrize("method",
                         ["cg", "pcg", "cgs", "bicgstab", "bicgstab2"])
def test_f32_banded_single_matches_numpy(method, system):
    A, dense, b = _f32_system(system)
    r = lcg.solve(A, jnp.asarray(b), method=method, params=_P32,
                  **_kw(method, A))
    assert int(r.status_code) == int(lcg.Status.CONVERGENCE)
    assert r.x.dtype == jnp.float32
    x_np = _numpy_solution(dense, b)
    err = np.linalg.norm(np.asarray(r.x, np.float64) - x_np)
    assert err <= 1e-4 * np.linalg.norm(x_np)


@pytest.mark.parametrize("system", ["tridiag", "banded19"])
@pytest.mark.parametrize("method", ["cg", "pcg", "cgs"])
def test_f32_banded_batched_matches_numpy_and_single(method, system):
    A, dense, B = _f32_system(system, nrhs=4)
    r = lcg.solve_batched(A, jnp.asarray(B), method=method, params=_P32,
                          **_kw(method, A))
    assert np.all(np.asarray(r.status_code) == int(lcg.Status.CONVERGENCE))
    X_np = _numpy_solution(dense, B)
    for i in range(B.shape[0]):
        err = np.linalg.norm(np.asarray(r.x[i], np.float64) - X_np[i])
        assert err <= 1e-4 * np.linalg.norm(X_np[i])
        single = lcg.solve(A, jnp.asarray(B[i]), method=method, params=_P32,
                           **_kw(method, A))
        assert abs(int(r.iterations[i]) - int(single.iterations)) <= 2


@pytest.mark.parametrize("system", ["tridiag", "banded19"])
def test_f32_banded_refined_matches_numpy(system):
    """f64 outer / f32 inner refinement on the formerly kernel-served
    banded systems reaches f64-class accuracy."""
    n, rows, cols, vals = _SYSTEMS[system]()
    A = lcg.BandedOperator(n, n, rows, cols, vals)
    b = np.random.default_rng(2).uniform(-1, 1, n)
    r = lcg.solve_refined(A, jnp.asarray(b),
                          params=lcg.SolverParams(epsilon=1e-24))
    assert int(r.status_code) == int(lcg.Status.CONVERGENCE)
    x_np = _numpy_solution(_dense(n, rows, cols, vals), b)
    np.testing.assert_allclose(np.asarray(r.x), x_np, rtol=0,
                               atol=1e-9 * np.abs(x_np).max())


# ---------------------------------------------------------------------------
# CA-CG: grid x s x basis x Jacobi, against classic CG and numpy
# ---------------------------------------------------------------------------


def _lap_rhs(grid, seed=0):
    n = grid[0] * grid[1] * grid[2]
    return jnp.asarray(np.random.default_rng(seed).standard_normal(n),
                       jnp.float32)


def _lap_dense(grid):
    nz, ny, nx = grid
    idx = np.arange(nz * ny * nx).reshape(grid)
    n = idx.size
    A = 6.0 * np.eye(n)
    for ax in range(3):
        a = np.take(idx, np.arange(grid[ax] - 1), axis=ax).ravel()
        c = np.take(idx, np.arange(1, grid[ax]), axis=ax).ravel()
        A[a, c] = A[c, a] = -1.0
    return A


@pytest.mark.parametrize("grid", [(8, 8, 16), (16, 4, 8)])
@pytest.mark.parametrize("s,basis", [(2, "chebyshev"), (4, "chebyshev"),
                                     (6, "chebyshev"), (4, "monomial")])
def test_ca_cg_xla_matches_cg_and_numpy(grid, s, basis):
    A = lcg.Laplacian3DOperator(*grid, dtype=jnp.float32)
    b = _lap_rhs(grid)
    p = lcg.SolverParams(epsilon=1e-10, max_iterations=2000)
    out = ca_cg(A, b, s=s, basis=basis, lmin=0.0, lmax=12.0, params=p)
    ref = lcg.solve(A, b, method="cg", params=p)
    assert int(out["status"]) == int(lcg.Status.CONVERGENCE)
    assert abs(int(out["t"]) - int(ref.iterations)) <= max(
        3, int(0.05 * int(ref.iterations)))
    x_np = np.linalg.solve(_lap_dense(grid), np.asarray(b, np.float64))
    np.testing.assert_allclose(np.asarray(out["x"], np.float64), x_np,
                               rtol=0, atol=1e-4 * np.abs(x_np).max())


def _shifted_stencil(grid=(8, 8, 16)):
    """Constant-coefficient anisotropic stencil with an SPD shift."""
    nz, ny, nx = grid
    n = nz * ny * nx
    ones = np.ones(n, np.float32)
    return lcg.Stencil3DOperator(nz, ny, nx, 8.5 * ones, -ones, -ones,
                                 -0.5 * ones, -0.5 * ones, -2.0 * ones,
                                 -2.0 * ones, dtype=np.float32)


@pytest.mark.parametrize("s", [2, 4])
def test_ca_cg_xla_const_stencil(s):
    A = _shifted_stencil()
    n = A.shape[0]
    b = jnp.ones((n,), jnp.float32)
    p = lcg.SolverParams(epsilon=1e-10, max_iterations=400)
    out = ca_cg(A, b, s=s, basis="chebyshev", lmin=0.0, lmax=17.0, params=p)
    ref = lcg.solve(A, b, method="cg", params=p)
    assert int(out["status"]) == int(lcg.Status.CONVERGENCE)
    assert abs(int(out["t"]) - int(ref.iterations)) <= 2
    np.testing.assert_allclose(np.asarray(out["x"]), np.asarray(ref.x),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("s", [2, 4])
def test_ca_cg_xla_jacobi(s):
    """Jacobi-scaled CA-CG through solve(method='cacg', M=...) against
    Jacobi-PCG and numpy on a variable-diagonal banded system."""
    n, rows, cols, vals = _banded19(n=600)
    A = lcg.BandedOperator(n, n, rows, cols, vals.astype(np.float32))
    M = lcg.JacobiPreconditioner(A)
    b = jnp.asarray(np.random.default_rng(4).uniform(-1, 1, n), jnp.float32)
    p = lcg.SolverParams(epsilon=1e-10, max_iterations=2000)
    r = lcg.solve(A, b, method="cacg", M=M, s=s, params=p)
    ref = lcg.solve(A, b, method="pcg", M=M, params=p)
    assert int(r.status_code) == int(lcg.Status.CONVERGENCE)
    assert abs(int(r.iterations) - int(ref.iterations)) <= 3
    x_np = _numpy_solution(_dense(n, rows, cols,
                                  vals.astype(np.float32).astype(np.float64)),
                           np.asarray(b))
    np.testing.assert_allclose(np.asarray(r.x, np.float64), x_np, rtol=0,
                               atol=1e-4 * np.abs(x_np).max())


@pytest.mark.parametrize("storage", [jnp.float32, jnp.float64])
def test_ca_cg_coeff_auto_is_wide_under_x64(storage):
    """coeff='auto' picks native wide coefficients whenever x64 is on
    (on every backend): bit-identical to coeff='wide'."""
    grid = (8, 8, 8)
    A = lcg.Laplacian3DOperator(*grid, dtype=storage)
    b = _lap_rhs(grid).astype(storage)
    p = lcg.SolverParams(epsilon=1e-10, max_iterations=500)
    kw = dict(s=4, basis="chebyshev", lmin=0.0, lmax=12.0, params=p)
    auto = ca_cg(A, b, coeff="auto", **kw)
    wide = ca_cg(A, b, coeff="wide", **kw)
    assert int(auto["t"]) == int(wide["t"])
    np.testing.assert_array_equal(np.asarray(auto["x"]),
                                  np.asarray(wide["x"]))


# ---------------------------------------------------------------------------
# Pair-complex engines vs native complex engines
# ---------------------------------------------------------------------------


def _scattered_complex(n=300, k=12, seed=4):
    rng = np.random.default_rng(seed)
    diag = (3.0 + rng.uniform(0, 1, n)) + 1j * (0.4 + rng.uniform(0, .4, n))
    J = rng.choice(n, size=k, replace=False)
    pairs = [(J[i], J[j]) for i in range(k) for j in range(i + 1, k)
             if rng.random() < 0.4]
    rows = np.array([p[0] for p in pairs] + [p[1] for p in pairs]
                    + list(range(n)))
    cols = np.array([p[1] for p in pairs] + [p[0] for p in pairs]
                    + list(range(n)))
    cv = 0.3 * (rng.standard_normal(len(pairs))
                + 1j * rng.standard_normal(len(pairs)))
    vals = np.concatenate([cv, cv, diag])
    x_true = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    return n, rows, cols, vals, _dense(n, rows, cols, vals) @ x_true, x_true


@pytest.mark.parametrize("seed", [4, 9, 15])
@pytest.mark.parametrize("method", ["pcg", "tfqmr"])
def test_realified_pairs_match_native_complex(method, seed):
    n, rows, cols, vals, b, x_true = _scattered_complex(seed=seed)
    A = lcg.ScatteredOperator(n, rows, cols, vals)
    p = lcg.SolverParams(epsilon=1e-12 if method == "pcg" else 1e-10,
                         abs_diff=1)
    kw_pair = {"M": "jacobi"} if method == "pcg" else {}
    kw_nat = {"M": lcg.JacobiPreconditioner(A)} if method == "pcg" else {}
    r_pair = lcg.solve_realified(A, b, method=method, params=p, **kw_pair)
    r_nat = lcg.solve(A, jnp.asarray(b), method=method, params=p, **kw_nat)
    assert int(r_pair.status_code) == int(lcg.Status.CONVERGENCE)
    assert int(r_nat.status_code) == int(lcg.Status.CONVERGENCE)
    assert abs(int(r_pair.iterations) - int(r_nat.iterations)) <= 2
    np.testing.assert_allclose(np.asarray(r_pair.x), x_true, atol=1e-4)
    np.testing.assert_allclose(np.asarray(r_nat.x), x_true, atol=1e-4)


def test_realified_pcg_diag_only_relative_metric():
    """Pure-diagonal complex system under the relative ||r||^4 metric:
    Jacobi-PCG converges in one step on both engines."""
    n = 200
    rng = np.random.default_rng(7)
    diag = (2.0 + rng.uniform(0, 1, n)) + 1j * rng.uniform(0.1, 0.3, n)
    x_true = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    A = lcg.ScatteredOperator(n, np.arange(n), np.arange(n), diag)
    p = lcg.SolverParams(epsilon=1e-20)
    r_pair = lcg.solve_realified(A, diag * x_true, method="pcg", M="jacobi",
                                 params=p)
    r_nat = lcg.solve(A, jnp.asarray(diag * x_true), method="pcg",
                      M=lcg.JacobiPreconditioner(A), params=p)
    assert int(r_pair.iterations) <= 2 and int(r_nat.iterations) <= 2
    np.testing.assert_allclose(np.asarray(r_pair.x), x_true, atol=1e-7)
    np.testing.assert_allclose(np.asarray(r_nat.x), x_true, atol=1e-7)


def test_realified_pcg_max_iterations_matches_native():
    n, rows, cols, vals, b, _ = _scattered_complex(seed=9)
    A = lcg.ScatteredOperator(n, rows, cols, vals)
    p = lcg.SolverParams(epsilon=1e-30, abs_diff=1, max_iterations=3)
    r_pair = lcg.solve_realified(A, b, method="pcg", M="jacobi", params=p)
    r_nat = lcg.solve(A, jnp.asarray(b), method="pcg",
                      M=lcg.JacobiPreconditioner(A), params=p)
    for r in (r_pair, r_nat):
        assert int(r.status_code) == int(lcg.Status.REACHED_MAX_ITERATIONS)
    assert int(r_pair.iterations) == int(r_nat.iterations)


# ---------------------------------------------------------------------------
# Routing: a GPU backend runs the XLA engines and imports no Pallas
# ---------------------------------------------------------------------------


def _route_solve():
    A, _, b = _f32_system("tridiag")
    return lcg.solve(A, jnp.asarray(b), params=_P32)


def _route_batched():
    A, _, B = _f32_system("tridiag", nrhs=3)
    return lcg.solve_batched(A, jnp.asarray(B), params=_P32)


def _route_refined():
    n, rows, cols, vals = _tridiag()
    A = lcg.BandedOperator(n, n, rows, cols, vals)
    return lcg.solve_refined(A, jnp.ones((n,)),
                             params=lcg.SolverParams(epsilon=1e-24))


def _route_cacg():
    A = lcg.Laplacian3DOperator(8, 8, 8, dtype=jnp.float32)
    return lcg.solve(A, _lap_rhs((8, 8, 8)), method="cacg",
                     params=lcg.SolverParams(epsilon=1e-10))


@pytest.mark.parametrize("entry", [_route_solve, _route_batched,
                                   _route_refined, _route_cacg],
                         ids=["solve", "solve_batched", "solve_refined",
                              "cacg"])
def test_gpu_backend_routes_to_xla(entry, monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    before = {m for m in sys.modules if m.startswith("jax.experimental.pallas")}
    r = entry()
    assert np.all(np.asarray(r.status_code) == int(lcg.Status.CONVERGENCE))
    after = {m for m in sys.modules if m.startswith("jax.experimental.pallas")}
    assert after == before


def test_package_has_no_mosaic_kernel_code():
    # Spelled in pieces so that this file itself does not match.
    pat = re.compile("pallas" r"\.t" "pu|" "plt" "pu|" "interp" r"ret\s*=")
    hits = []
    for root, _, files in os.walk(os.path.join(REPO, "liblcg_tpu")):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(root, f)
                with open(path) as fh:
                    for i, line in enumerate(fh, 1):
                        if pat.search(line):
                            hits.append(f"{path}:{i}: {line.strip()}")
    assert not hits, hits


# ---------------------------------------------------------------------------
# TF32 guard: every f32 dot_general on these paths asks for HIGHEST
# ---------------------------------------------------------------------------


def _dot_precisions(jaxpr):
    out = []

    def walk(jp):
        for eqn in jp.eqns:
            if eqn.primitive.name == "dot_general":
                dt = eqn.invars[0].aval.dtype
                out.append((str(dt), eqn.params["precision"]))
            for v in eqn.params.values():
                subs = v if isinstance(v, (tuple, list)) else (v,)
                for sub in subs:
                    inner = getattr(sub, "jaxpr", sub)   # ClosedJaxpr
                    if hasattr(inner, "eqns"):
                        walk(inner)

    walk(jaxpr.jaxpr)
    return out


def _block_cg_f32():
    n, rows, cols, vals = _tridiag(n=64)
    A = lcg.BandedOperator(n, n, rows, cols, vals.astype(np.float32))
    B = jnp.ones((4, n), jnp.float32)

    def f(B):
        from liblcg_tpu.solve import _VmappedOperator
        from liblcg_tpu.solvers.block import block_cg

        return block_cg(_VmappedOperator(A), B, None,
                        params=lcg.SolverParams(epsilon=1e-10))["x"]

    return f, (B,)


def _blocked_ic_f32():
    from liblcg_tpu.precond.incomplete import incomplete_cholesky_coo

    n, rows, cols, vals = _banded19(n=600)
    fac = incomplete_cholesky_coo(n, rows, cols, vals)
    M = fac.preconditioner(mode="blocked", dtype=jnp.float32)
    return (lambda r: M.mv(r)), (jnp.ones((n,), jnp.float32),)


def _cacg_coeff_f32():
    A = lcg.Laplacian3DOperator(8, 8, 8, dtype=jnp.float32)

    def f(b):
        return ca_cg(A, b, s=4, basis="chebyshev", lmin=0.0, lmax=12.0,
                     coeff="wide",
                     params=lcg.SolverParams(epsilon=1e-10))["x"]

    return f, (jnp.ones((512,), jnp.float32),)


@pytest.mark.parametrize("build", [_block_cg_f32, _blocked_ic_f32,
                                   _cacg_coeff_f32],
                         ids=["block_cg", "blocked_ic", "cacg_coeff"])
def test_f32_contractions_ask_for_highest(build):
    f, args = build()
    # x64 off: the CA-CG coefficient algebra then runs in f32 itself.
    with jax.enable_x64(False):
        jaxpr = jax.make_jaxpr(f)(*args)
    dots = _dot_precisions(jaxpr)
    assert any(dt == "float32" for dt, _ in dots), dots
    hi = jax.lax.Precision.HIGHEST
    bad = [(dt, pr) for dt, pr in dots
           if dt == "float32" and (pr is None or any(p != hi for p in pr))]
    assert not bad, bad
