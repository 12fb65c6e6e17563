"""Blocked banded triangular solve (precond/blocked_tri.py) — the
matmul-form IC/ILU application.  Parity target: the
level-scheduled form and the reference's sequential substitution
(preconditioner.cpp:309-366)."""

import numpy as np
import jax.numpy as jnp
import pytest

import liblcg_tpu as lcg
from liblcg_tpu.precond.blocked_tri import (
    BlockedTriangularPreconditioner,
    blocked_schedule,
    blocked_triangular_solve,
)
from liblcg_tpu.precond.triangular import level_schedule, triangular_solve


def _banded_lower(n, w, seed=0, dtype=np.float64):
    """Random banded lower-triangular COO with a dominant diagonal."""
    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    for i in range(n):
        rows.append(i); cols.append(i)
        vals.append(2.0 + rng.uniform(0, 1))
        for j in range(max(0, i - w), i):
            if rng.uniform() < 0.7:
                rows.append(i); cols.append(j)
                vals.append(rng.uniform(-0.5, 0.5))
    return (np.array(rows), np.array(cols), np.array(vals, dtype=dtype))


def _dense_of(n, rows, cols, vals):
    T = np.zeros((n, n))
    T[rows, cols] = vals
    return T


@pytest.mark.parametrize("n,w,block", [(64, 3, None), (100, 7, 16),
                                       (257, 5, 32), (130, 1, 128)])
def test_blocked_lower_solve_matches_dense(n, w, block):
    rows, cols, vals = _banded_lower(n, w, seed=n)
    fac = blocked_schedule(n, rows, cols, vals, lower=True, block=block)
    rng = np.random.default_rng(1)
    b = rng.uniform(-1, 1, n)
    x = np.asarray(blocked_triangular_solve(fac, jnp.asarray(b)))
    x_ref = np.linalg.solve(_dense_of(n, rows, cols, vals), b)
    np.testing.assert_allclose(x, x_ref, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("n,w", [(64, 3), (100, 7), (257, 5)])
def test_blocked_upper_solve_matches_dense(n, w):
    rows, cols, vals = _banded_lower(n, w, seed=n + 1)
    # transpose -> upper triangular
    fac = blocked_schedule(n, cols, rows, vals, lower=False, block=16)
    rng = np.random.default_rng(2)
    b = rng.uniform(-1, 1, n)
    x = np.asarray(blocked_triangular_solve(fac, jnp.asarray(b)))
    x_ref = np.linalg.solve(_dense_of(n, rows, cols, vals).T, b)
    np.testing.assert_allclose(x, x_ref, rtol=1e-10, atol=1e-12)


def test_blocked_matches_level_scheduled():
    n, w = 200, 9
    rows, cols, vals = _banded_lower(n, w, seed=7)
    b = np.random.default_rng(3).uniform(-1, 1, n)
    blk = blocked_schedule(n, rows, cols, vals, lower=True, block=32)
    lev = level_schedule(n, rows, cols, vals, lower=True)
    np.testing.assert_allclose(
        np.asarray(blocked_triangular_solve(blk, jnp.asarray(b))),
        np.asarray(triangular_solve(lev, jnp.asarray(b))),
        rtol=1e-10, atol=1e-12,
    )


def test_blocked_rejects_wide_band():
    n = 64
    rows = np.array([0, 50]); cols = np.array([0, 10])
    vals = np.array([1.0, 0.5])
    rows = np.concatenate([np.arange(n), rows])
    cols = np.concatenate([np.arange(n), cols])
    vals = np.concatenate([np.ones(n), vals])
    with pytest.raises(ValueError, match="bandwidth"):
        blocked_schedule(n, rows, cols, vals, lower=True, block=16)


def test_blocked_rejects_rank_deficient():
    n = 8
    rows = np.arange(n - 1)          # missing last diagonal entry
    cols = np.arange(n - 1)
    vals = np.ones(n - 1)
    with pytest.raises(ValueError, match="rank deficient"):
        blocked_schedule(n, rows, cols, vals, lower=True)


def test_blocked_rejects_non_triangular():
    rows = np.array([0, 1, 0]); cols = np.array([0, 1, 1])
    vals = np.array([1.0, 1.0, 0.5])
    with pytest.raises(ValueError, match="not lower"):
        blocked_schedule(2, rows, cols, vals, lower=True)


def test_ic_preconditioner_modes_agree():
    """IC(0)-PCG through mode='blocked' and mode='levels' must follow the
    identical convergence path (same iterations; answers equal to fp)."""
    n = 400
    rng = np.random.default_rng(11)
    main = 4.0 + rng.uniform(0, 1, n)
    off = rng.uniform(-1, 1, n - 1)
    rows = np.concatenate([np.arange(n), np.arange(n - 1), np.arange(1, n)])
    cols = np.concatenate([np.arange(n), np.arange(1, n), np.arange(n - 1)])
    vals = np.concatenate([main, off, off])
    A = lcg.SparseOperator(n, n, rows, cols, vals, assume_symmetric=True)
    fac = lcg.incomplete_cholesky(A)
    b = rng.uniform(-1, 1, n)
    params = lcg.SolverParams(epsilon=1e-20)

    r_lev = lcg.solve(A, b, method="pcg", M=fac.preconditioner(mode="levels"),
                      params=params)
    r_blk = lcg.solve(A, b, method="pcg", M=fac.preconditioner(mode="blocked"),
                      params=params)
    assert bool(r_lev.converged) and bool(r_blk.converged)
    assert int(r_lev.iterations) == int(r_blk.iterations)
    np.testing.assert_allclose(np.asarray(r_blk.x), np.asarray(r_lev.x),
                               rtol=1e-9, atol=1e-11)


def test_ic_preconditioner_auto_picks_blocked_for_banded():
    n = 128
    rng = np.random.default_rng(12)
    main = 4.0 + rng.uniform(0, 1, n)
    off = rng.uniform(-1, 1, n - 1)
    rows = np.concatenate([np.arange(n), np.arange(n - 1), np.arange(1, n)])
    cols = np.concatenate([np.arange(n), np.arange(1, n), np.arange(n - 1)])
    vals = np.concatenate([main, off, off])
    A = lcg.SparseOperator(n, n, rows, cols, vals, assume_symmetric=True)
    fac = lcg.incomplete_cholesky(A)
    assert isinstance(fac.preconditioner(), BlockedTriangularPreconditioner)
    with pytest.raises(ValueError, match="mode"):
        fac.preconditioner(mode="nope")


def test_blocked_preconditioner_is_jittable_pytree():
    import jax

    n = 96
    rows, cols, vals = _banded_lower(n, 4, seed=21)
    fac = blocked_schedule(n, rows, cols, vals, lower=True)
    facU = blocked_schedule(n, cols, rows, vals, lower=False)
    M = BlockedTriangularPreconditioner(fac, facU)
    b = jnp.asarray(np.random.default_rng(5).uniform(-1, 1, n))

    @jax.jit
    def apply(M, v):
        return M.mv(v)

    y = np.asarray(apply(M, b))
    T = _dense_of(n, rows, cols, vals)
    y_ref = np.linalg.solve(T.T, np.linalg.solve(T, np.asarray(b)))
    np.testing.assert_allclose(y, y_ref, rtol=1e-9, atol=1e-11)
