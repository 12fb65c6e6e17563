"""Batched multi-RHS solve tests: per-system convergence/status parity with
the one-at-a-time path (a capability with no reference
counterpart — solves there are strictly one b at a time, lcg.h:61)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import liblcg_tpu as lcg


@pytest.fixture(scope="module")
def spd():
    rng = np.random.default_rng(42)
    m, n = 100, 80
    K = rng.uniform(-1.0, 1.0, size=(m, n))
    A = K.T @ K + 0.1 * np.eye(n)
    X_true = rng.uniform(1.0, 2.0, size=(6, n))
    B = X_true @ A.T
    return A, B, X_true


PARAMS = lcg.SolverParams(epsilon=1e-12)


#: Batched-vs-single iteration-count slack: the vmapped matmul accumulates
#: in a different order, so borderline epsilon hits shift.  CG is nearly
#: insensitive; BiCGSTAB's omega computation amplifies rounding enough that
#: only solution accuracy is meaningful.
_ITER_SLACK = {"cg": 1, "cgs": 3, "bicgstab": None}


@pytest.mark.parametrize("method", ["cg", "cgs", "bicgstab"])
def test_batched_matches_individual(spd, method):
    A, B, X_true = spd
    op = lcg.DenseOperator(A)
    res = lcg.solve_batched(op, B, method=method, params=PARAMS)
    assert res.x.shape == B.shape
    assert res.status_code.shape == (B.shape[0],)
    slack = _ITER_SLACK[method]
    for i in range(B.shape[0]):
        single = lcg.solve(op, B[i], method=method, params=PARAMS)
        assert lcg.Status(int(res.status_code[i])) in (
            lcg.Status.CONVERGENCE, lcg.Status.ALREADY_OPTIMIZED,
        )
        if slack is not None:
            assert abs(int(res.iterations[i]) - int(single.iterations)) <= slack, (
                f"system {i}: batched {int(res.iterations[i])} vs "
                f"single {int(single.iterations)}"
            )
        np.testing.assert_allclose(
            np.asarray(res.x[i]), np.asarray(single.x), atol=1e-4
        )
    np.testing.assert_allclose(np.asarray(res.x), X_true, atol=2e-4)


def test_batched_pcg(spd):
    A, B, X_true = spd
    op = lcg.DenseOperator(A)
    M = lcg.JacobiPreconditioner(op)
    res = lcg.solve_batched(op, B, method="pcg", M=M, params=PARAMS)
    np.testing.assert_allclose(np.asarray(res.x), X_true, atol=2e-4)


def test_batched_callable_preconditioner(spd):
    A, B, X_true = spd
    op = lcg.DenseOperator(A)
    d = jnp.asarray(np.diag(A))
    res = lcg.solve_batched(op, B, method="pcg", M=lambda v: v / d, params=PARAMS)
    np.testing.assert_allclose(np.asarray(res.x), X_true, atol=2e-4)


def test_batched_heterogeneous_convergence():
    """Systems of very different conditioning converge at different t;
    early finishers must stay frozen (no 0/0 poisoning)."""
    n = 40
    rng = np.random.default_rng(1)
    A = np.diag(np.linspace(1.0, 3.0, n))
    B = np.stack([
        A @ np.ones(n),                  # converges immediately-ish
        A @ rng.uniform(1, 2, n),        # a few iterations
        rng.normal(size=n) * 1e3,        # harder scale
    ])
    res = lcg.solve_batched(lcg.DenseOperator(A), B, params=PARAMS)
    its = np.asarray(res.iterations)
    assert np.all(np.asarray(res.status_code) >= 0)
    assert not np.any(np.isnan(np.asarray(res.x)))
    # per-system solutions correct (B rows span magnitudes ~1e0..1e3, so
    # compare relative to each row's scale)
    for i in range(3):
        scale = max(np.max(np.abs(B[i])), 1.0)
        np.testing.assert_allclose(A @ np.asarray(res.x[i]) / scale,
                                   B[i] / scale, rtol=0, atol=1e-6)
    # iteration counts genuinely differ across systems
    assert len(set(its.tolist())) > 1


def test_batched_complex_bicg():
    rng = np.random.default_rng(7)
    n = 40
    Mx = rng.uniform(-1, 1, (n, n)) + 1j * rng.uniform(-1, 1, (n, n))
    A = (Mx + Mx.T) / 2 + (3 + 0.5j) * np.eye(n)
    X_true = rng.uniform(1, 2, (4, n)) + 1j * rng.uniform(-1, 1, (4, n))
    B = X_true @ A.T
    res = lcg.solve_batched(lcg.DenseOperator(A), B, method="bicg",
                            params=lcg.SolverParams(epsilon=1e-18))
    np.testing.assert_allclose(np.asarray(res.x), X_true, atol=1e-4)


def test_batched_complex_cgs_with_key():
    rng = np.random.default_rng(8)
    n = 32
    Mx = rng.uniform(-1, 1, (n, n)) + 1j * rng.uniform(-1, 1, (n, n))
    A = (Mx + Mx.T) / 2 + (3 + 0.5j) * np.eye(n)
    X_true = rng.uniform(1, 2, (3, n)) + 1j * rng.uniform(-1, 1, (3, n))
    B = X_true @ A.T
    res = lcg.solve_batched(lcg.DenseOperator(A), B, method="cgs",
                            params=lcg.SolverParams(epsilon=1e-18),
                            key=jax.random.PRNGKey(5))
    np.testing.assert_allclose(np.asarray(res.x), X_true, atol=1e-4)


def test_batched_rejects_unsupported(spd):
    A, B, _ = spd
    with pytest.raises(ValueError):
        lcg.solve_batched(lcg.DenseOperator(A), B, method="nope")
    with pytest.raises(ValueError):
        # bicgstab2's abs_diff mid-iteration exit is not batchable
        lcg.solve_batched(lcg.DenseOperator(A), B, method="bicgstab2",
                          params=lcg.SolverParams(abs_diff=1))
    with pytest.raises(ValueError):
        lcg.solve_batched(lcg.DenseOperator(A), B[0])  # 1-D B


def test_batched_bicgstab2(spd):
    A, B, X_true = spd
    res = lcg.solve_batched(lcg.DenseOperator(A), B, method="bicgstab2",
                            params=PARAMS)
    assert np.all(np.asarray(res.status_code) >= 0)
    np.testing.assert_allclose(np.asarray(res.x), X_true, atol=2e-4)


def test_batched_sparse_operator(case_10k):
    sys_, answer = case_10k
    A = lcg.make_sparse_operator(sys_.n, sys_.n, sys_.rows, sys_.cols, sys_.vals)
    B = jnp.stack([jnp.asarray(sys_.b), 2.0 * jnp.asarray(sys_.b)])
    res = lcg.solve_batched(A, B, params=PARAMS)
    x = np.asarray(res.x)
    assert np.sqrt(np.sum((x[0] - answer) ** 2)) / sys_.n < 1e-5
    assert np.sqrt(np.sum((x[1] - 2 * answer) ** 2)) / sys_.n < 2e-5


def test_batched_pg_box_constrained(spd):
    """Multi-RHS projected gradient with shared box bounds."""
    A, B, X_true = spd  # X_true rows in [1, 2]
    n = B.shape[1]
    res = lcg.solve_batched(
        lcg.DenseOperator(A), B, method="pg",
        lower=np.full(n, 1.0), upper=np.full(n, 2.0),
        params=lcg.SolverParams(epsilon=1e-10, max_iterations=3000),
    )
    x = np.asarray(res.x)
    assert np.all(x >= 1.0 - 1e-10) and np.all(x <= 2.0 + 1e-10)
    np.testing.assert_allclose(x, X_true, atol=5e-2)
    assert np.all(np.asarray(res.status_code) >= 0)


def test_batched_pg_missing_bounds(spd):
    A, B, _ = spd
    res = lcg.solve_batched(lcg.DenseOperator(A), B, method="pg")
    assert lcg.Status(int(np.asarray(res.status_code).reshape(-1)[0])) == \
        lcg.Status.INVALID_POINTER


def test_batched_tfqmr():
    rng = np.random.default_rng(12)
    n = 36
    Mx = rng.uniform(-1, 1, (n, n)) + 1j * rng.uniform(-1, 1, (n, n))
    A = (Mx + Mx.T) / 2 + (3 + 0.5j) * np.eye(n)
    X_true = rng.uniform(1, 2, (3, n)) + 1j * rng.uniform(-1, 1, (3, n))
    B = X_true @ A.T
    res = lcg.solve_batched(lcg.DenseOperator(A), B, method="tfqmr",
                            params=lcg.SolverParams(epsilon=1e-18))
    assert np.all(np.asarray(res.status_code) >= 0)
    np.testing.assert_allclose(np.asarray(res.x), X_true, atol=1e-4)
    # iteration parity vs single solves (tfqmr counts half steps)
    for i in range(3):
        single = lcg.solve(lcg.DenseOperator(A), B[i], method="tfqmr",
                           params=lcg.SolverParams(epsilon=1e-18))
        assert abs(int(res.iterations[i]) - int(single.iterations)) <= 4


def test_batched_spg_box_constrained(spd):
    A, B, X_true = spd
    n = B.shape[1]
    res = lcg.solve_batched(
        lcg.DenseOperator(A), B, method="spg",
        lower=np.full(n, 1.0), upper=np.full(n, 2.0),
        params=lcg.SolverParams(epsilon=1e-10, max_iterations=3000),
    )
    x = np.asarray(res.x)
    assert np.all(x >= 1.0 - 1e-10) and np.all(x <= 2.0 + 1e-10)
    np.testing.assert_allclose(x, X_true, atol=5e-2)
    # parity with single solves
    for i in range(B.shape[0]):
        single = lcg.solve(lcg.DenseOperator(A), B[i], method="spg",
                           lower=np.full(n, 1.0), upper=np.full(n, 2.0),
                           params=lcg.SolverParams(epsilon=1e-10,
                                                   max_iterations=3000))
        np.testing.assert_allclose(x[i], np.asarray(single.x), atol=1e-4)
