"""Round-4 items: batched residual traces (VERDICT r3 item 7).

The reference's progress contract exposes the residual every iteration
(lcg.h:53-54); the multi-RHS paths now honor it with per-system trace
rows: ``solve_batched(..., trace_len=k).trace`` is (nrhs, k).
"""

import numpy as np
import jax.numpy as jnp
import pytest

import liblcg_tpu as lcg


@pytest.fixture(scope="module")
def spd():
    rng = np.random.default_rng(7)
    m, n = 100, 80
    K = rng.uniform(-1.0, 1.0, size=(m, n))
    A = K.T @ K + 0.1 * np.eye(n)
    X_true = rng.uniform(1.0, 2.0, size=(4, n))
    B = X_true @ A.T
    return A, B, X_true


PARAMS = lcg.SolverParams(epsilon=1e-12)


@pytest.mark.parametrize("method", ["cg", "cgs", "bicgstab"])
def test_batched_trace_matches_single(spd, method):
    A, B, _ = spd
    op = lcg.DenseOperator(A)
    k = 24
    res = lcg.solve_batched(op, B, method=method, params=PARAMS, trace_len=k)
    assert res.trace is not None and res.trace.shape == (B.shape[0], k)
    for i in range(B.shape[0]):
        single = lcg.solve(op, B[i], method=method, params=PARAMS,
                           trace_len=k)
        ti = int(min(int(single.iterations), k))
        np.testing.assert_allclose(
            np.asarray(res.trace[i][:ti]), np.asarray(single.trace[:ti]),
            rtol=1e-6,
        )


def test_batched_trace_frozen_rows_stop_updating(spd):
    """A system that converges early must keep zeros past its exit point
    (frozen rows), while a harder batchmate keeps recording."""
    A, B, _ = spd
    op = lcg.DenseOperator(A)
    # Make system 0 trivial (b = 0 -> already optimized at t=0).
    B2 = np.array(B)
    B2[0] = 0.0
    k = 16
    res = lcg.solve_batched(lcg.DenseOperator(A), B2, method="cg",
                            params=PARAMS, trace_len=k)
    assert int(res.iterations[0]) == 0
    # Row 0 recorded at most its initial residual; the tail stays zero.
    assert np.all(np.asarray(res.trace[0][1:]) == 0.0)
    # A real system's early entries are decreasing and nonzero.
    row = np.asarray(res.trace[1])
    nz = row[row > 0]
    assert nz.size >= 3 and nz[2] < nz[0]


def test_batched_trace_tfqmr_complex(case_1k_complex=None):
    rng = np.random.default_rng(3)
    n = 60
    Ar = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    A = (Ar + Ar.T) / 2 + 4 * n * np.eye(n)  # complex-symmetric, diag-dominant
    X = rng.standard_normal((3, n)) + 1j * rng.standard_normal((3, n))
    B = X @ A.T
    k = 32
    res = lcg.solve_batched(lcg.DenseOperator(A), B, method="tfqmr",
                            params=lcg.SolverParams(epsilon=1e-10),
                            trace_len=k)
    assert res.trace is not None and res.trace.shape == (3, k)
    for i in range(3):
        assert lcg.Status(int(res.status_code[i])) in (
            lcg.Status.CONVERGENCE, lcg.Status.ALREADY_OPTIMIZED)
        row = np.asarray(res.trace[i])
        assert (row > 0).sum() >= 2


def test_batched_trace_gmres(spd):
    A, B, _ = spd
    res = lcg.solve_batched(lcg.DenseOperator(A), B, method="gmres",
                            params=lcg.SolverParams(epsilon=1e-12),
                            restart=40, trace_len=40)
    assert res.trace is not None and res.trace.shape == (B.shape[0], 40)
    for i in range(B.shape[0]):
        row = np.asarray(res.trace[i])
        nz = row[row > 0]
        assert nz.size >= 3 and nz[-1] < nz[0]


def test_sharded_batched_trace(spd):
    from liblcg_tpu.parallel import ShardedSparseOperator, solve_sharded

    A, B, _ = spd
    n = A.shape[0]
    rows, cols = np.nonzero(A)
    S = ShardedSparseOperator(n, rows, cols, A[rows, cols], n_devices=8)
    k = 24
    res = solve_sharded(S, jnp.asarray(B), method="cg", params=PARAMS,
                        trace_len=k)
    assert res.trace is not None and res.trace.shape == (B.shape[0], k)
    single = lcg.solve(lcg.DenseOperator(A), B[0], method="cg",
                       params=PARAMS, trace_len=k)
    ti = min(int(single.iterations), k)
    np.testing.assert_allclose(np.asarray(res.trace[0][:ti]),
                               np.asarray(single.trace[:ti]), rtol=1e-5)


def test_batched_cacg_matches_single():
    """solve_batched(method='cacg') vmaps the single-system engine; the
    per-system masks must keep finished systems frozen, so counts and
    iterates match one-at-a-time solves exactly (VERDICT r4 #5)."""
    import liblcg_tpu as lcg

    g = 16
    A = lcg.Laplacian3DOperator(g, g, g, dtype=jnp.float32)
    n = g ** 3
    rng = np.random.default_rng(0)
    X_true = rng.uniform(1, 2, (3, n)).astype(np.float32)
    B = np.stack([np.asarray(A.mv(jnp.asarray(x))) for x in X_true])
    p = lcg.SolverParams(epsilon=1e-10)
    res = lcg.solve_batched(A, B, method="cacg", s=3, lmin=0.0, lmax=12.0,
                            params=p, trace_len=8)
    assert res.trace is not None and res.trace.shape == (3, 8)
    for i in range(3):
        single = lcg.solve(A, jnp.asarray(B[i]), method="cacg", s=3,
                           lmin=0.0, lmax=12.0, params=p)
        assert int(res.iterations[i]) == int(single.iterations)
        assert lcg.Status(int(res.status_code[i])) == lcg.Status.CONVERGENCE
        np.testing.assert_allclose(np.asarray(res.x[i]), X_true[i],
                                   atol=5e-3)


def test_batched_cacg_jacobi():
    import liblcg_tpu as lcg

    g = 16
    A = lcg.Laplacian3DOperator(g, g, g, dtype=jnp.float32)
    n = g ** 3
    rng = np.random.default_rng(1)
    X_true = rng.uniform(1, 2, (2, n)).astype(np.float32)
    B = np.stack([np.asarray(A.mv(jnp.asarray(x))) for x in X_true])
    res = lcg.solve_batched(A, B, method="cacg", s=3,
                            M=lcg.JacobiPreconditioner(A),
                            params=lcg.SolverParams(epsilon=1e-10))
    assert all(int(s_) == 0 for s_ in np.asarray(res.status_code))
    np.testing.assert_allclose(np.asarray(res.x), X_true, atol=5e-3)
    with pytest.raises(ValueError, match="Jacobi"):
        lcg.solve_batched(A, B, method="cacg",
                          M=lcg.SSORPreconditioner(
                              lcg.make_sparse_operator(
                                  n, n, np.arange(n), np.arange(n),
                                  np.full(n, 6.0))))


def test_make_sparse_operator_auto_scattered():
    """Diagonal-plus-few-couplings patterns auto-route to
    ScatteredOperator (and stay DIA/ELL otherwise)."""
    import liblcg_tpu as lcg

    n = 1000
    rng = np.random.default_rng(2)
    J = rng.choice(n, size=8, replace=False)
    rows = np.concatenate([np.arange(n), J[:4], J[4:]])
    cols = np.concatenate([np.arange(n), J[4:], J[:4]])
    vals = np.concatenate([np.full(n, 4.0), np.full(8, 0.5)])
    A = lcg.make_sparse_operator(n, n, rows, cols, vals)
    assert isinstance(A, lcg.ScatteredOperator)
    # solve through it + gershgorin-backed chebyshev
    x_true = rng.uniform(1, 2, n)
    dense = np.zeros((n, n))
    np.add.at(dense, (rows, cols), vals)
    b = dense @ x_true
    r = lcg.solve(A, jnp.asarray(b), method="cg",
                  params=lcg.SolverParams(epsilon=1e-14))
    np.testing.assert_allclose(np.asarray(r.x), x_true, atol=1e-5)
    r2 = lcg.solve(A, jnp.asarray(b), method="chebyshev",
                   params=lcg.SolverParams(epsilon=1e-14,
                                           max_iterations=3000))
    np.testing.assert_allclose(np.asarray(r2.x), x_true, atol=1e-4)
    # a tridiagonal pattern must keep DIA (off-diagonals ~2n >> 5% n)
    r3 = np.concatenate([np.arange(n), np.arange(n - 1)])
    c3 = np.concatenate([np.arange(n), np.arange(1, n)])
    v3 = np.concatenate([np.full(n, 2.0), np.full(n - 1, -1.0)])
    assert isinstance(lcg.make_sparse_operator(n, n, r3, c3, v3),
                      lcg.BandedOperator)
    # explicit scattered on a diagonal-missing pattern raises
    with pytest.raises(ValueError, match="diagonal"):
        lcg.make_sparse_operator(4, 4, [0, 1], [0, 1], [1.0, 1.0],
                                 format="scattered")


def test_batched_cacg_rejects_complex_and_scales_monitor():
    import liblcg_tpu as lcg

    n = 16
    Ac = np.eye(n) * (2 + 1j)
    Bc = np.ones((2, n), complex)
    with pytest.raises(ValueError, match="real-domain"):
        lcg.solve_batched(lcg.DenseOperator(Ac), Bc, method="cacg")
    # Jacobi-scaled batched cacg: the monitor must see the PHYSICAL x
    # (round-4 review: it saw the D^{1/2}-scaled iterate).
    g = 8
    A = lcg.Laplacian3DOperator(g, g, g, dtype=jnp.float32)
    n = g ** 3
    rng = np.random.default_rng(0)
    x_true = rng.uniform(10.0, 20.0, n).astype(np.float32)  # big scale
    B = np.stack([np.asarray(A.mv(jnp.asarray(x_true)))])
    M = lcg.JacobiPreconditioner(A)
    res = lcg.solve_batched(
        A, B, method="cacg", s=2, M=M,
        monitor=lambda xv, r, t: jnp.max(jnp.abs(xv)) > 1e6,
        params=lcg.SolverParams(epsilon=1e-10))
    assert lcg.Status(int(res.status_code[0])) in (
        lcg.Status.CONVERGENCE, lcg.Status.ALREADY_OPTIMIZED)
    x = np.asarray(res.x[0])
    np.testing.assert_allclose(x, x_true, atol=2e-2)
    # Physical-scale check: a monitor thresholded just above the true
    # solution magnitude must NOT stop the solve (the scaled iterate
    # x-hat = D^{1/2} x ~ 2.45x would cross it).
    thresh = float(np.max(np.abs(x_true))) * 1.5
    res2 = lcg.solve_batched(
        A, B, method="cacg", s=2, M=M,
        monitor=lambda xv, r, t: jnp.max(jnp.abs(xv)) > thresh,
        params=lcg.SolverParams(epsilon=1e-10))
    assert lcg.Status(int(res2.status_code[0])) != lcg.Status.STOP


def test_solve_sequence_matches_manual_chain(spd):
    """solve_sequence chains K dependent warm-started solves in one
    dispatch; iterates must match K manual solve() calls exactly."""
    import liblcg_tpu as lcg

    A, B, _ = spd
    op = lcg.DenseOperator(A)
    b0 = B[0]
    K = 4
    seq = lcg.solve_sequence(op, b0, lambda x, k: x / jnp.sqrt(
        jnp.sum(x * x)), K, method="cg", params=PARAMS)
    assert seq.x.shape == (K, A.shape[0])
    x_prev = np.zeros(A.shape[0])
    b = np.asarray(b0)
    for k in range(K):
        r = lcg.solve(op, jnp.asarray(b), x0=jnp.asarray(x_prev),
                      method="cg", params=PARAMS)
        # Inside lax.scan XLA fuses the dense matvec differently, so the
        # two trajectories converge (to the shared tolerance) along
        # slightly different paths — agreement is at the eps-implied
        # solution accuracy, not bitwise.
        np.testing.assert_allclose(np.asarray(seq.x[k]), np.asarray(r.x),
                                   rtol=1e-4, atol=1e-6)
        assert abs(int(seq.iterations[k]) - int(r.iterations)) <= 2
        x_prev = np.asarray(r.x)
        b = x_prev / np.linalg.norm(x_prev)


def test_solve_sequence_options(spd):
    import liblcg_tpu as lcg

    A, B, _ = spd
    op = lcg.DenseOperator(A)
    # keep_solutions=False returns only the final x; preconditioned form.
    M = lcg.JacobiPreconditioner(op)
    seq = lcg.solve_sequence(op, B[0], lambda x, k: x, 3, method="pcg",
                             M=M, params=PARAMS, keep_solutions=False)
    assert seq.x.shape == (A.shape[0],)
    assert seq.status_code.shape == (3,)
    # guards
    with pytest.raises(ValueError, match="unconstrained"):
        lcg.solve_sequence(op, B[0], lambda x, k: x, 2, method="spg")
    with pytest.raises(ValueError, match="preconditioner"):
        lcg.solve_sequence(op, B[0], lambda x, k: x, 2, method="cg", M=M)


def test_solve_sequence_batched(spd):
    """Dependent chains over a STACK of states (ensemble implicit
    integration): per-step leaves gain the nrhs axis and each lane
    matches its own single-lane chain."""
    import liblcg_tpu as lcg

    A, B, _ = spd
    op = lcg.DenseOperator(A)
    B0 = B[:3]
    K = 3

    def nxt(X, k):
        return X / jnp.sqrt(jnp.sum(X * X, axis=-1, keepdims=True))

    seq = lcg.solve_sequence(op, B0, nxt, K, method="cg", params=PARAMS)
    assert seq.x.shape == (K, 3, A.shape[0])
    assert seq.status_code.shape == (K, 3)
    for lane in range(3):
        single = lcg.solve_sequence(
            op, B0[lane], lambda x, k: x / jnp.sqrt(jnp.sum(x * x)), K,
            method="cg", params=PARAMS)
        for k in range(K):
            np.testing.assert_allclose(
                np.asarray(seq.x[k, lane]), np.asarray(single.x[k]),
                rtol=1e-4, atol=1e-6)
    with pytest.raises(ValueError, match="batched"):
        lcg.solve_sequence(op, B0, nxt, K, method="cacg")


def test_block_solve_trace_records(spd):
    # Round 4 rejected trace_len for block solves; round 5 implemented
    # per-system rows (the lcg.h:53-54 progress contract) — see
    # test_round5_fixes.test_block_cg_records_per_system_traces.
    import numpy as np

    A, B, _ = spd
    r = lcg.solve_batched(lcg.DenseOperator(A), B, method="block_cg",
                          params=PARAMS, trace_len=8)
    assert np.asarray(r.trace).shape == (B.shape[0], 8)
