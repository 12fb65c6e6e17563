"""Regression tests for the round-3 review findings: silent-M rejection,
GMRES per-system product budgets, and batched Jacobi-PCG parity."""

import numpy as np
import jax.numpy as jnp
import pytest

import liblcg_tpu as lcg


def _spd(n=48, seed=0):
    rng = np.random.default_rng(seed)
    Q = rng.normal(size=(n, n))
    A = Q @ Q.T + n * np.eye(n)
    x_true = rng.uniform(1, 2, n)
    return A, A @ x_true, x_true


# ---- solve() must reject M for non-preconditioned methods -------------------


def test_solve_rejects_M_on_unpreconditioned_method():
    A, b, _ = _spd()
    M = lcg.JacobiPreconditioner(lcg.DenseOperator(A))
    with pytest.raises(ValueError, match="pcg"):
        lcg.solve(A, b, method="cg", M=M)
    with pytest.raises(ValueError, match="pgmres"):
        lcg.solve(A, b, method="gmres", M=M)
    with pytest.raises(ValueError, match="pminres"):
        lcg.solve(A, b, method="minres", M=M)


def test_solve_batched_rejects_M_on_unpreconditioned_method():
    A, b, _ = _spd()
    M = lcg.JacobiPreconditioner(lcg.DenseOperator(A))
    B = np.stack([b, 2 * b])
    with pytest.raises(ValueError, match="does not use a preconditioner"):
        lcg.solve_batched(A, B, method="cg", M=M)


def test_preconditioned_methods_still_accept_M():
    A, b, x_true = _spd()
    M = lcg.JacobiPreconditioner(lcg.DenseOperator(A))
    res = lcg.solve(A, b, method="pcg", M=M,
                    params=lcg.SolverParams(epsilon=1e-20))
    assert res.converged
    np.testing.assert_allclose(np.asarray(res.x), x_true, rtol=1e-6)


# ---- GMRES batched product budget is per-system -----------------------------


def test_gmres_batched_cap_matches_solo_cap():
    """Under a hard ``max_iterations`` cap, a system solved in a batch must
    receive exactly the products it gets when solved alone — the cap is
    per-system, not shared with slower batchmates (gmres.py budget)."""
    n = 64
    rng = np.random.default_rng(3)
    Q = rng.normal(size=(n, n))
    A = Q @ Q.T + 2 * np.eye(n)          # ill-conditioned enough to need many
    b_hard = rng.normal(size=n)
    b_easy = A @ np.ones(n) * 1e-8       # converges almost immediately
    params = lcg.SolverParams(epsilon=1e-10, max_iterations=11)

    solo = lcg.solve(A, b_hard, method="gmres", restart=4, params=params)
    batch = lcg.solve_batched(A, np.stack([b_easy, b_hard]),
                              method="gmres", restart=4, params=params)
    assert int(batch.iterations[1]) == int(solo.iterations)
    assert np.asarray(batch.residual)[1] == pytest.approx(
        float(solo.residual), rel=1e-6)
    np.testing.assert_allclose(np.asarray(batch.x[1]), np.asarray(solo.x),
                               rtol=1e-6, atol=1e-9)


def test_gmres_batched_unconverged_does_not_exceed_cap():
    n = 64
    rng = np.random.default_rng(4)
    Q = rng.normal(size=(n, n))
    A = Q @ Q.T + 0.5 * np.eye(n)
    B = rng.normal(size=(3, n))
    cap = 7
    res = lcg.solve_batched(A, B, method="gmres", restart=5,
                            params=lcg.SolverParams(epsilon=1e-28,
                                                    max_iterations=cap))
    # Harness convention: a cap exit lands at cap + 1.
    assert int(np.max(np.asarray(res.iterations))) <= cap + 1


def test_batched_pcg_auto_route_cpu_falls_back():
    """Batched f32 Jacobi-PCG on a banded operator runs the XLA engine:
    every system converges and matches its one-at-a-time solve."""
    rng = np.random.default_rng(5)
    n = 128
    main = 4.0 + rng.uniform(0, 1, n)
    off = rng.uniform(-1, 1, n - 1)
    rows = np.concatenate([np.arange(n), np.arange(n - 1), np.arange(1, n)])
    cols = np.concatenate([np.arange(n), np.arange(1, n), np.arange(n - 1)])
    vals = np.concatenate([main, off, off]).astype(np.float32)
    A = lcg.BandedOperator(n, n, rows, cols, vals)
    M = lcg.JacobiPreconditioner(A)
    B = rng.uniform(-1, 1, (4, n)).astype(np.float32)
    params = lcg.SolverParams(epsilon=1e-11)
    r_auto = lcg.solve_batched(A, B, method="pcg", M=M, params=params)
    assert bool(np.all(np.asarray(r_auto.status_code)
                       == int(lcg.Status.CONVERGENCE)))
    for i in range(B.shape[0]):
        r1 = lcg.solve(A, B[i], method="pcg", M=M, params=params)
        np.testing.assert_allclose(np.asarray(r1.x),
                                   np.asarray(r_auto.x[i]), atol=2e-4)
        assert int(r1.iterations) == int(np.asarray(r_auto.iterations)[i])


# ---- Jacobi-CGNR: NormalEqOperator.diagonal() via col_sq_norms --------------


def test_col_sq_norms_matches_dense():
    rng = np.random.default_rng(9)
    A = np.where(rng.uniform(size=(20, 20)) < 0.3,
                 rng.normal(size=(20, 20)), 0.0)
    np.fill_diagonal(A, 3.0)
    rows, cols = np.nonzero(A)
    ref = np.sum(np.abs(A) ** 2, axis=0)
    ops = [lcg.DenseOperator(A),
           lcg.SparseOperator(20, 20, rows, cols, A[rows, cols]),
           lcg.BandedOperator(20, 20, rows, cols, A[rows, cols])]
    for op in ops:
        np.testing.assert_allclose(np.asarray(op.col_sq_norms()), ref,
                                   rtol=1e-12)
        np.testing.assert_allclose(
            np.asarray(lcg.NormalEqOperator(op).diagonal()), ref, rtol=1e-12)


def test_jacobi_cgnr_beats_plain_cgnr_on_case1k():
    """The recorded scattered-complex recipe (bench complex1k): Jacobi on
    the normal equations cuts CGNR iterations ~30% on the shipped complex
    case (200 vs 291) at the same accuracy."""
    import os

    path = "/root/reference/data/case_1K_cA"
    if not os.path.exists(path):
        pytest.skip("reference data not present")
    from liblcg_tpu.utils import io

    s = io.read_system(path, complex_values=True)
    ans = io.read_answer("/root/reference/data/case_1K_cB",
                         complex_values=True)
    n = s.n
    r2, c2, v2 = lcg.realify_coo(s.rows, s.cols, s.vals)
    # ELL here: the recipe under test is the preconditioner (iteration
    # count), not the storage format — the chip path's scan-DIA form is
    # ~30x slower on CPU and is exercised by the bench/dryrun instead.
    A2 = lcg.make_sparse_operator(2 * n, 2 * n, r2, c2, v2, format="ell")
    b2 = jnp.asarray(lcg.split_complex_interleaved(s.b))
    NE = lcg.NormalEqOperator(A2)
    rhs = A2.rmv(b2)
    params = lcg.SolverParams(epsilon=1e-16)

    plain = lcg.solve(NE, rhs, method="cg", params=params)
    pc = lcg.solve(NE, rhs, method="pcg", M=lcg.JacobiPreconditioner(NE),
                   params=params)
    assert bool(plain.converged) and bool(pc.converged)
    assert int(pc.iterations) < int(plain.iterations) - 50
    x = lcg.merge_complex_interleaved(np.asarray(pc.x))
    assert float(np.max(np.abs(x - ans))) < 1e-6


def test_normal_eq_diagonal_raises_for_matrix_free():
    op = lcg.MatrixFreeOperator(lambda v: v, n=8, dtype=jnp.float64)
    with pytest.raises(NotImplementedError, match="col_sq_norms"):
        lcg.NormalEqOperator(op).diagonal()


def test_gmres_batched_convergence_respects_per_system_budget():
    """A batched system kept in a cycle by slower batchmates must not
    report convergence past its own max_iterations budget, and its
    correction is truncated to its budget (code-review r3 finding)."""
    rng = np.random.default_rng(5)
    n = 48
    # easy: well-conditioned diag; hard: wide-spread spectrum
    d_hard = np.logspace(0, 4, n)
    A_hard = lcg.DenseOperator(np.diag(d_hard))
    # One operator, two right-hand sides of very different difficulty:
    # a spectrum-aligned rhs converges in ~1 product, a random one needs
    # many — so cycles keep running past the easy system's budget.
    b_easy = np.zeros(n); b_easy[0] = 1.0
    b_hard = rng.normal(size=n)
    B = jnp.asarray(np.stack([b_easy, b_hard]))
    cap = 5
    p = lcg.SolverParams(epsilon=1e-20, max_iterations=cap)
    r = lcg.solve_batched(A_hard, B, method="gmres", restart=8, params=p)
    t = np.asarray(r.iterations)
    st = np.asarray(r.status_code)
    assert np.all(t <= cap + 1), t
    conv = st == int(lcg.Status.CONVERGENCE)
    assert np.all(t[conv] <= cap), (t, st)
