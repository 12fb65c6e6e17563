"""Realified complex solves: the 2n x 2n real block form lets every complex
system run on backends without complex dtypes."""

import numpy as np
import jax.numpy as jnp
import pytest

import liblcg_tpu as lcg


def _complex_system(n=64, seed=7):
    rng = np.random.default_rng(seed)
    M = rng.uniform(-1, 1, (n, n)) + 1j * rng.uniform(-1, 1, (n, n))
    A = (M + M.T) / 2 + (4 + 0.5j) * np.eye(n)
    x_true = rng.uniform(1, 2, n) + 1j * rng.uniform(-1, 1, n)
    return A, A @ x_true, x_true


def test_realified_products_match():
    A, b, _ = _complex_system()
    n = A.shape[0]
    for op in (lcg.DenseOperator(A),
               lcg.SparseOperator.from_dense(A),
               lcg.BandedOperator(n, n, *np.nonzero(A), A[np.nonzero(A)])):
        R = lcg.realify(op)
        assert R.dtype == jnp.float64
        z = np.random.default_rng(1).normal(size=n) + \
            1j * np.random.default_rng(2).normal(size=n)
        y = lcg.merge_complex(R.mv(jnp.asarray(lcg.split_complex(z))))
        np.testing.assert_allclose(y, A @ z, atol=1e-10)
        # Block-form identity: R(A)^T == R(A^H) — the algebraic transpose
        # of the realified operator is the HERMITIAN transpose of A.
        yt = lcg.merge_complex(R.rmv(jnp.asarray(lcg.split_complex(z))))
        np.testing.assert_allclose(yt, A.conj().T @ z, atol=1e-10)


def test_realified_solve_matches_complex_solve():
    A, b, x_true = _complex_system()
    R = lcg.realify(lcg.DenseOperator(A))
    # CGS: BiCGSTAB's omega minimization breaks down on the conjugate-pair
    # spectrum of a realified complex operator.
    res = lcg.solve(R, lcg.split_complex(b), method="cgs",
                    params=lcg.SolverParams(epsilon=1e-14))
    assert res.converged
    x = lcg.merge_complex(res.x)
    np.testing.assert_allclose(x, x_true, atol=1e-4)


def test_realified_golden_case1k_cgnr(case_1k_complex):
    """The robust realified recipe for hard systems: realify + CGNR
    (CG on the SPD normal equations R^T R x = R^T b) — solves the shipped
    complex case to 1e-8 where realified CGS stagnates."""
    sys_, answer = case_1k_complex
    A = lcg.SparseOperator(sys_.n, sys_.n, sys_.rows, sys_.cols, sys_.vals)
    R = lcg.realify(A)
    b2 = jnp.asarray(lcg.split_complex(sys_.b))
    res = lcg.solve(lcg.NormalEqOperator(R), R.rmv(b2), method="cg",
                    params=lcg.SolverParams(epsilon=1e-16))
    assert res.converged
    x = lcg.merge_complex(res.x)
    assert np.max(np.abs(x - answer)) < 1e-6


def test_realify_rejects_real_operator():
    with pytest.raises(ValueError):
        lcg.realify(lcg.DenseOperator(np.eye(4)))
