"""Block CG (shared block Krylov space over stacked RHS, solvers/block.py).

The reference is strictly single-RHS (lcg.h:61); block CG is an extension:
one iteration expands the search space by nrhs directions, so the iteration
count drops with the effective condition number, and all the per-iteration
reductions/updates are (s, n) x (n, s) matmuls instead of vmapped vector
recurrences.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import liblcg_tpu as lcg
from liblcg_tpu.types import SolverParams, Status


def _spd_system(n=300, s=6, seed=0):
    rng = np.random.default_rng(seed)
    Araw = rng.standard_normal((n, n))
    A = Araw @ Araw.T + n * np.eye(n)
    B = rng.standard_normal((s, n))
    return jnp.asarray(A), jnp.asarray(B)


def test_block_cg_matches_direct_solve():
    A, B = _spd_system()
    res = lcg.solve_batched(A, B, method="block_cg",
                            params=SolverParams(epsilon=1e-14))
    Xtrue = np.linalg.solve(np.asarray(A), np.asarray(B).T).T
    assert np.all(np.asarray(res.status_code) == int(Status.CONVERGENCE))
    assert np.abs(np.asarray(res.x) - Xtrue).max() < 1e-8


def test_block_cg_fewer_iterations_than_batched(case_10k):
    """The point of sharing the Krylov space: on the shipped ill-conditioned
    case_10K (121 single-RHS CG iterations at eps=1e-12), a block of 8
    converges in strictly fewer iterations than independent batched CG."""
    sys_, _ = case_10k
    A = lcg.make_sparse_operator(sys_.n, sys_.n, sys_.rows, sys_.cols,
                                 sys_.vals)
    rng = np.random.default_rng(7)
    B = jnp.asarray(np.vstack(
        [np.asarray(sys_.b)] + [rng.standard_normal(sys_.n) for _ in range(7)]
    ))
    p = SolverParams(epsilon=1e-12)
    rb = lcg.solve_batched(A, B, method="block_cg", params=p)
    rc = lcg.solve_batched(A, B, method="cg", params=p)
    assert np.all(np.asarray(rb.status_code) == int(Status.CONVERGENCE))
    assert int(np.max(rb.iterations)) < int(np.max(rc.iterations))
    # Both converged to the same tolerance: solutions agree to its scale.
    scale = float(jnp.abs(rc.x).max())
    assert float(jnp.abs(rb.x - rc.x).max()) < 1e-4 * max(scale, 1.0)


def test_block_cg_duplicate_rhs_breakdown_guard():
    """Classic block CG divides by a singular P^T A P when RHS rows are
    linearly dependent; the masked-jitter solve must stay finite and give
    the same answer for the duplicated systems."""
    A, B = _spd_system(n=200, s=4, seed=3)
    B2 = jnp.concatenate([B, B[:2]], axis=0)  # rows 4,5 duplicate 0,1
    res = lcg.solve_batched(A, B2, method="block_cg",
                            params=SolverParams(epsilon=1e-14))
    assert np.all(np.asarray(res.status_code) == int(Status.CONVERGENCE))
    x = np.asarray(res.x)
    assert np.abs(x[4] - x[0]).max() < 1e-9
    assert np.abs(x[5] - x[1]).max() < 1e-9


def test_block_pcg_jacobi(case_10k):
    sys_, _ = case_10k
    A = lcg.make_sparse_operator(sys_.n, sys_.n, sys_.rows, sys_.cols,
                                 sys_.vals)
    M = lcg.JacobiPreconditioner(A.diagonal())
    B = jnp.stack([jnp.asarray(sys_.b), 2.0 * jnp.asarray(sys_.b) + 1.0])
    p = SolverParams(epsilon=1e-12)
    rp = lcg.solve_batched(A, B, method="block_pcg", M=M, params=p)
    rb = lcg.solve_batched(A, B, method="block_cg", params=p)
    assert np.all(np.asarray(rp.status_code) == int(Status.CONVERGENCE))
    assert int(np.max(rp.iterations)) <= int(np.max(rb.iterations))


def test_block_cg_per_system_freezing():
    """An easy system alongside a hard one freezes early: its recorded
    iteration count is lower and its solution does not drift afterwards."""
    A, B = _spd_system(n=200, s=3, seed=5)
    # System 0: b = A @ e1-ish tiny -> x0 initial guess is nearly exact.
    xeasy = np.zeros(200)
    xeasy[0] = 1e-8
    Beasy = jnp.asarray((np.asarray(A) @ xeasy)[None, :])
    Bmix = jnp.concatenate([Beasy, B], axis=0)
    res = lcg.solve_batched(A, Bmix, method="block_cg",
                            params=SolverParams(epsilon=1e-14))
    its = np.asarray(res.iterations)
    assert its[0] < its[1:].min()
    Xtrue = np.linalg.solve(np.asarray(A), np.asarray(Bmix).T).T
    assert np.abs(np.asarray(res.x) - Xtrue).max() < 1e-8


def test_block_cg_warm_start_and_monitor():
    A, B = _spd_system(n=150, s=4, seed=9)
    Xtrue = np.linalg.solve(np.asarray(A), np.asarray(B).T).T
    # Warm start at the answer: ALREADY_OPTIMIZED at t=0.
    res = lcg.solve_batched(A, B, X0=jnp.asarray(Xtrue), method="block_cg",
                            params=SolverParams(epsilon=1e-10))
    assert np.all(np.asarray(res.status_code) == int(Status.ALREADY_OPTIMIZED))
    # Monitor stop after 3 iterations (reference Pfp contract).
    stop_at = lambda x, r, t: jnp.any(t >= 3)
    res2 = lcg.solve_batched(A, B, method="block_cg", monitor=stop_at,
                             params=SolverParams(epsilon=1e-30))
    assert np.all(np.asarray(res2.status_code) == int(Status.STOP))
    assert int(np.max(res2.iterations)) == 3


def test_block_cg_api_guards():
    A, B = _spd_system(n=50, s=2)
    with pytest.raises(ValueError, match="solve_batched"):
        lcg.solve(A, B[0], method="block_cg")
    with pytest.raises(ValueError, match="block_pcg"):
        lcg.solve_batched(A, B, method="block_cg", M=lambda x: x)
    res = lcg.solve_batched(A, B, method="block_pcg")
    assert int(np.asarray(res.status_code).reshape(-1)[0]) == int(
        Status.NULL_PRECONDITION_MATRIX
    )
    with pytest.raises(ValueError, match="realify"):
        lcg.solve_batched(A.astype(jnp.complex128), B.astype(jnp.complex128),
                          method="block_cg")
    # Alias accepted.
    res2 = lcg.solve_batched(A, B, method="bcg",
                             params=SolverParams(epsilon=1e-12))
    assert np.all(np.asarray(res2.status_code) == int(Status.CONVERGENCE))


def test_block_cg_reduce_dtype():
    """f32 storage + f64 Gram accumulation converges where it otherwise
    merely must not break; exercises the preferred_element_type path."""
    A, B = _spd_system(n=300, s=6, seed=1)
    res = lcg.solve_batched(A.astype(jnp.float32), B.astype(jnp.float32),
                            method="block_cg",
                            params=SolverParams(epsilon=1e-9,
                                                reduce_dtype=jnp.float64))
    assert np.all(np.asarray(res.status_code) == int(Status.CONVERGENCE))


def test_block_cg_sharded_matches_single_device():
    """Sharded block CG (Gram psums inside shard_map) is the same
    recurrence: iteration counts match the single-device block engine."""
    from liblcg_tpu.parallel import ShardedSparseOperator, solve_sharded

    rng = np.random.default_rng(0)
    n = 203
    main = 4.0 + rng.uniform(0, 1, n)
    off = rng.uniform(-1, 1, n - 1)
    rows = np.concatenate([np.arange(n), np.arange(n - 1), np.arange(1, n)])
    cols = np.concatenate([np.arange(n), np.arange(1, n), np.arange(n - 1)])
    vals = np.concatenate([main, off, off])
    B = jnp.asarray(rng.standard_normal((4, n)))

    p = SolverParams(epsilon=1e-12)
    ref = lcg.solve_batched(
        lcg.SparseOperator(n, n, rows, cols, vals), B, method="block_cg",
        params=p)
    A = ShardedSparseOperator(n, rows, cols, vals, n_devices=8)
    res = solve_sharded(A, B, method="block_cg", params=p)
    assert np.all(np.asarray(res.status_code) == int(Status.CONVERGENCE))
    np.testing.assert_array_equal(np.asarray(res.iterations),
                                  np.asarray(ref.iterations))
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(ref.x),
                               atol=1e-8)


def test_block_matmuls_request_highest_precision():
    """Regression: a reduced-precision default matmul (TF32 on GPUs)
    poisons the Gram matrices and breaks f32 block CG where true f32
    matmuls converge.  Every engine matmul must request HIGHEST."""
    import jax
    from liblcg_tpu.solvers import block as BL

    jaxpr = jax.make_jaxpr(BL._mm)(jnp.ones((4, 8), jnp.float32),
                                   jnp.ones((8, 4), jnp.float32))
    assert "highest" in str(jaxpr).lower()


def test_ns_inverse_matches_numpy_inverse():
    """The Newton-Schulz chain must reproduce the true inverse of guarded
    (jitter-bounded) SPD matrices to working precision, including the
    near-singular steady state block CG reaches at convergence."""
    from liblcg_tpu.solvers import block as BL

    rng = np.random.default_rng(0)
    s = 16
    alive = jnp.ones((s, 1), bool)
    M1 = rng.standard_normal((s, s))
    well = M1 @ M1.T + s * np.eye(s)
    M2 = rng.standard_normal((s, 3))
    sing = M2 @ M2.T                      # rank 3: the convergence regime
    stack = jnp.stack([
        BL._mask_guard(jnp.asarray(well), alive),
        BL._mask_guard(jnp.asarray(sing), alive),
    ])
    inv = np.asarray(BL._ns_inverse(stack))
    for k in range(2):
        err = np.abs(inv[k] @ np.asarray(stack[k]) - np.eye(s)).max()
        assert err < 1e-4, (k, err)   # guarded kappa ~ 3e5 at f32 jitter


def test_block_cg_nan_breakdown_does_not_pollute_frozen_systems():
    """Review finding (round 3): a NaN breakdown in an alive system must
    not leak into already-frozen systems through the block updates — the
    x rows use the same keep()/mask convention as run_loop's batched
    path."""
    n = 40
    rng = np.random.default_rng(1)
    # Indefinite operator: CG breaks down (d^T A d < 0 -> NS rsqrt NaN).
    D = np.diag(np.concatenate([np.full(n // 2, 2.0),
                                np.full(n - n // 2, -2.0)]))
    A = jnp.asarray(D)
    xt = rng.standard_normal(n)
    b_hard = jnp.asarray(D @ rng.standard_normal(n))
    b_easy = jnp.asarray(D @ xt)
    X0 = jnp.stack([jnp.asarray(xt), jnp.zeros(n)])  # system 0 pre-solved
    res = lcg.solve_batched(A, jnp.stack([b_easy, b_hard]), X0=X0,
                            method="block_cg",
                            params=SolverParams(epsilon=1e-12,
                                                max_iterations=60))
    st = np.asarray(res.status_code)
    assert st[0] in (int(Status.ALREADY_OPTIMIZED), int(Status.CONVERGENCE))
    assert np.all(np.isfinite(np.asarray(res.x)[0]))
    np.testing.assert_allclose(np.asarray(res.x)[0], xt, atol=1e-10)


def test_block_methods_not_in_real_methods():
    """Review finding (round 3): every REAL_METHODS member must be a
    valid solve() method; the multi-RHS-only methods live in
    BLOCK_METHODS."""
    assert "block_cg" not in lcg.REAL_METHODS
    assert set(lcg.BLOCK_METHODS) == {"block_cg", "block_pcg"}
    assert set(lcg.BLOCK_METHODS) <= set(lcg.BATCHED_METHODS)
