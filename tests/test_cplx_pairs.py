"""Pair-complex engines (solvers/cplx_pairs.py) and the scattered-direct
Woodbury solver (solvers/direct.py) — the round-4 complex-10K machinery.

The pair engines run the reference's complex recurrences in pure real
arithmetic (stacked [re; im] vectors over a RealifiedOperator), which is
what executes on a backend without complex dtypes.  Counts must track the
complex-dtype engines (same recurrence; reduction order differs).
"""

import numpy as np
import jax.numpy as jnp
import pytest

import liblcg_tpu as lcg

#: (method, |pair iterations - complex-dtype iterations| allowed).
#: BiCGSTAB's omega arithmetic is the most reduction-order-sensitive
#: recurrence in the family (the reference's own real BiCGSTAB gets a
#: ±5 band at 80 iterations); the pair substrate reorders every dot, so
#: its count drifts further while converging to the same solution
#: (measured 115 vs 132 on this system, residuals both ~2e-15).
PAIR_METHODS = [("bicg", 3), ("bicg_sym", 3), ("cgs", 3),
                ("bicgstab", 25), ("tfqmr", 3)]
PAIR_PRE_METHODS = ["pcg", "pbicg"]


@pytest.mark.parametrize("method,tol", PAIR_METHODS)
def test_pairs_match_complex_engine(complex_sym_small, method, tol):
    A, b, x_true = complex_sym_small
    op = lcg.DenseOperator(A)
    p = lcg.SolverParams(epsilon=1e-14)
    rc = lcg.solve(op, jnp.asarray(b), method=method, params=p)
    rp = lcg.solve_realified(op, b, method=method, params=p)
    assert lcg.Status(int(rp.status_code)) == lcg.Status.CONVERGENCE
    assert abs(int(rp.iterations) - int(rc.iterations)) <= tol
    np.testing.assert_allclose(rp.x, x_true, atol=2e-3)


@pytest.mark.parametrize("method", PAIR_PRE_METHODS)
def test_pairs_preconditioned(complex_sym_small, method):
    A, b, x_true = complex_sym_small
    op = lcg.DenseOperator(A)
    p = lcg.SolverParams(epsilon=1e-14)
    rc = lcg.solve(op, jnp.asarray(b), method=method,
                   M=lcg.JacobiPreconditioner(op), params=p)
    rp = lcg.solve_realified(op, b, method=method, M="jacobi", params=p)
    assert lcg.Status(int(rp.status_code)) == lcg.Status.CONVERGENCE
    assert abs(int(rp.iterations) - int(rc.iterations)) <= 3
    np.testing.assert_allclose(rp.x, x_true, atol=2e-3)


def test_pairs_golden_case10k(case_10k_complex):
    """The flagship complex workload (sample6 configuration) through the
    pair path: Jacobi-PCG converges in ~340 iterations (the complex-dtype
    engine takes 337; reference-binary BiCG takes 450 unpreconditioned)."""
    sys_, answer = case_10k_complex
    A = lcg.SparseOperator(sys_.n, sys_.n, sys_.rows, sys_.cols, sys_.vals)
    p = lcg.SolverParams(epsilon=1e-6, abs_diff=1)
    r = lcg.solve_realified(A, sys_.b, method="pcg", M="jacobi", params=p)
    assert lcg.Status(int(r.status_code)) == lcg.Status.CONVERGENCE
    assert abs(int(r.iterations) - 337) <= 35
    md = float(np.max(np.abs(r.x - answer)))
    assert md < 0.1, md


def test_pairs_golden_case10k_bicg_sym(case_10k_complex):
    """Unpreconditioned bicg_sym tracks the reference binary's 450 within
    the ill-conditioned band (the complex-dtype engine lands at 464, the
    pair substrate at ~496 — same recurrence, different reduction order)."""
    sys_, answer = case_10k_complex
    A = lcg.SparseOperator(sys_.n, sys_.n, sys_.rows, sys_.cols, sys_.vals)
    p = lcg.SolverParams(epsilon=1e-6, abs_diff=1)
    r = lcg.solve_realified(A, sys_.b, method="bicg_sym", params=p)
    assert lcg.Status(int(r.status_code)) == lcg.Status.CONVERGENCE
    assert abs(int(r.iterations) - 450) <= 70
    md = float(np.max(np.abs(r.x - answer)))
    assert md < 0.1, md


def test_pairs_golden_case1k_tfqmr(case_1k_complex):
    """Pair-form TFQMR on the shipped case_1K lands inside the reference
    binary's random-shadow band (1464±400 across regenerations — the
    reference seeds rbar0 from time(0), clcg.cpp:399-403)."""
    sys_, answer = case_1k_complex
    A = lcg.SparseOperator(sys_.n, sys_.n, sys_.rows, sys_.cols, sys_.vals)
    p = lcg.SolverParams(epsilon=1e-6, abs_diff=1)
    r = lcg.solve_realified(A, sys_.b, method="tfqmr", params=p)
    assert lcg.Status(int(r.status_code)) == lcg.Status.CONVERGENCE
    assert abs(int(r.iterations) - 1464) <= 400, int(r.iterations)
    md = float(np.max(np.abs(r.x - answer)))
    assert md < 0.1, md


def test_pairs_bicgstab_converges_well_conditioned():
    """Pair-form BiCGSTAB solves a well-conditioned complex-symmetric
    system to machine accuracy (the shipped cases are adversarial for
    BiCGSTAB — the reference's own engine needs 7-9K iterations there,
    so correctness is asserted on a controlled spectrum)."""
    rng = np.random.default_rng(3)
    n = 300
    C = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    A = (C + C.T) * 0.05 + np.eye(n) * 6.0   # complex-symmetric, diag-dominant
    x_true = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    b = A @ x_true
    op = lcg.DenseOperator(A)
    # abs_diff: ||r||^2/n <= eps (the relative metric is a ||r||^4 ratio
    # against ||x||^4 — far looser than it looks for ||x|| >> 1).
    p = lcg.SolverParams(epsilon=1e-14, abs_diff=1)
    r = lcg.solve_realified(op, b, method="bicgstab", params=p)
    assert lcg.Status(int(r.status_code)) == lcg.Status.CONVERGENCE
    np.testing.assert_allclose(r.x, x_true, atol=1e-5)


def test_pairs_trace_and_monitor(complex_sym_small):
    A, b, _ = complex_sym_small
    op = lcg.DenseOperator(A)
    r = lcg.solve_realified(op, b, method="bicg_sym",
                            params=lcg.SolverParams(epsilon=1e-14),
                            trace_len=8)
    tr = np.asarray(r.trace)
    assert tr.shape == (8,) and np.all(tr[1:4] > 0)
    r = lcg.solve_realified(op, b, method="bicg_sym",
                            monitor=lambda x, res, t: t >= 3)
    assert lcg.Status(int(r.status_code)) == lcg.Status.STOP
    assert int(r.iterations) == 3


def test_pairs_rejects_unknown_and_missing_M(complex_sym_small):
    A, b, _ = complex_sym_small
    op = lcg.DenseOperator(A)
    # All 7 reference complex methods have pair forms since round 5;
    # real-domain methods remain out of scope here.
    with pytest.raises(ValueError, match="pair-complex"):
        lcg.solve_realified(op, b, method="cg")
    r = lcg.solve_realified(op, b, method="pcg", M=None)
    assert lcg.Status(int(r.status_code)) == lcg.Status.NULL_PRECONDITION_MATRIX


# --- batched pair solves (round 5: multi-RHS complex on-chip) ---------------


@pytest.mark.parametrize(
    "method", ["bicg", "bicg_sym", "cgs", "bicgstab", "pcg", "pbicg"])
def test_pairs_batched_matches_single(complex_sym_small, method):
    """Per-system counts/solutions of the batched pair path must match
    one-at-a-time solve_realified (per-system freezing through the
    batched harness) — every method _BATCHED_PAIR_METHODS advertises
    (pbicg exercises the conj(A) product's batched axis)."""
    A, b, x_true = complex_sym_small
    op = lcg.DenseOperator(A)
    p = lcg.SolverParams(epsilon=1e-13)
    kw = dict(M="jacobi") if method in ("pcg", "pbicg") else {}
    B = np.stack([b, 2.0 * b, b * (1 - 0.5j)])
    rb = lcg.solve_realified_batched(op, B, method=method, params=p, **kw)
    assert rb.x.shape == B.shape
    # bicgstab's unsmoothed recurrence amplifies the batched reductions'
    # reordering on this fixture's spectrum (counts drift ~8 at
    # eps=1e-13 with both sides CONVERGENCE); the others track tightly.
    count_tol = 12 if method == "bicgstab" else 2
    scales = [1.0, 2.0, 1 - 0.5j]
    for i in range(3):
        r1 = lcg.solve_realified(op, B[i], method=method, params=p, **kw)
        assert int(rb.status_code[i]) == int(r1.status_code)
        assert abs(int(rb.iterations[i]) - int(r1.iterations)) <= count_tol
        if method == "bicgstab":
            # its unsmoothed trajectories land ~1e-3 apart on this
            # conditioning — assert both against the true solution
            np.testing.assert_allclose(rb.x[i], x_true * scales[i],
                                       atol=1e-2)
            np.testing.assert_allclose(r1.x, x_true * scales[i],
                                       atol=1e-2)
        else:
            # batched reductions reorder the sums -> ~1e-4 trajectory
            # drift at the loose ||r||^4 metric; both are true solutions
            np.testing.assert_allclose(rb.x[i], r1.x, atol=1e-3)


def test_pairs_batched_traces_and_errors(complex_sym_small):
    A, b, _ = complex_sym_small
    op = lcg.DenseOperator(A)
    r = lcg.solve_realified_batched(
        op, np.stack([b, 3.0 * b]), method="bicg_sym",
        params=lcg.SolverParams(epsilon=1e-13), trace_len=6)
    tr = np.asarray(r.trace)
    assert tr.shape == (2, 6) and np.all(tr[:, 1] > 0)
    with pytest.raises(ValueError, match="batched pair-complex"):
        lcg.solve_realified_batched(op, np.stack([b, b]), method="tfqmr")
    with pytest.raises(ValueError, match="nrhs"):
        lcg.solve_realified_batched(op, b, method="bicg_sym")
    res = lcg.solve_realified_batched(op, np.stack([b, b]), method="pcg",
                                      M=None)
    assert all(int(s) == int(lcg.Status.NULL_PRECONDITION_MATRIX)
               for s in np.asarray(res.status_code))


# --- scattered-direct (Woodbury) --------------------------------------------


def test_scattered_direct_exact_case10k(case_10k_complex):
    sys_, answer = case_10k_complex
    D = lcg.ScatteredDirectSolver(sys_.n, sys_.rows, sys_.cols, sys_.vals)
    assert D.k == 198
    r = D.solve(np.asarray(sys_.b))
    md = float(np.max(np.abs(r.x - answer)))
    assert md < 1e-10, md
    assert lcg.Status(int(r.status_code)) == lcg.Status.CONVERGENCE


def test_scattered_direct_real_random():
    rng = np.random.default_rng(5)
    n, k = 500, 24
    diag = rng.uniform(2.0, 4.0, n)
    J = rng.choice(n, size=k, replace=False)
    pairs = [(J[i], J[j]) for i in range(k) for j in range(i + 1, k)
             if rng.random() < 0.2]
    rows = [p[0] for p in pairs] + [p[1] for p in pairs] + list(range(n))
    cols = [p[1] for p in pairs] + [p[0] for p in pairs] + list(range(n))
    vals = ([0.3] * (2 * len(pairs))) + list(diag)
    A = np.zeros((n, n))
    A[rows, cols] = 0.0
    for r_, c_, v_ in zip(rows, cols, vals):
        A[r_, c_] += v_
    x_true = rng.standard_normal(n)
    b = A @ x_true
    D = lcg.ScatteredDirectSolver(n, np.array(rows), np.array(cols),
                                  np.array(vals))
    res = D.solve(b)
    np.testing.assert_allclose(res.x, x_true, atol=1e-10)


def test_pairs_warns_without_x64(complex_sym_small):
    """complex128 input with x64 off silently truncates the pair
    arithmetic to f32 (measured 6x iteration blowup on case_10K_cA) —
    solve_realified must warn."""
    import jax

    A, b, _ = complex_sym_small
    op = lcg.DenseOperator(A)
    jax.config.update("jax_enable_x64", False)
    try:
        with pytest.warns(UserWarning, match="x64"):
            lcg.solve_realified(op, b, method="bicg_sym",
                                params=lcg.SolverParams(epsilon=1e-6))
    finally:
        jax.config.update("jax_enable_x64", True)


def test_complex_backend_guard_message():
    """When the backend probe says complex is unsupported, solve() must
    fail fast with routing guidance (the cached probe result is forced
    here; CPU and GPU backends have complex dtypes)."""
    import jax

    import importlib

    # liblcg_tpu.solve the MODULE (the package attribute `solve` is the
    # function and shadows it under `import ... as`).
    solve_mod = importlib.import_module("liblcg_tpu.solve")

    plat = jax.default_backend()
    old = solve_mod._COMPLEX_OK.get(plat)
    solve_mod._COMPLEX_OK[plat] = False
    try:
        A = np.eye(4) * (2 + 1j)
        b = np.ones(4) + 1j * np.ones(4)
        with pytest.raises(ValueError, match="solve_realified"):
            lcg.solve(lcg.DenseOperator(A), jnp.asarray(b),
                      method="bicg_sym")
        with pytest.raises(ValueError, match="solve_realified"):
            lcg.solve_batched(lcg.DenseOperator(A), jnp.stack(
                [jnp.asarray(b)] * 2), method="bicg_sym")
    finally:
        if old is None:
            solve_mod._COMPLEX_OK.pop(plat, None)
        else:
            solve_mod._COMPLEX_OK[plat] = old


def test_scattered_direct_sums_duplicate_coo():
    """Duplicate COO entries must SUM (the SparseOperator convention) —
    fancy-index assignment silently last-write-wins (round-4 review)."""
    rng = np.random.default_rng(8)
    n = 6
    rows = np.array([0, 1, 2, 3, 4, 5, 0, 2, 0, 2, 2, 0, 2, 0])
    cols = np.array([0, 1, 2, 3, 4, 5, 2, 0, 2, 0, 0, 2, 0, 2])
    vals = np.array([4.0, 4, 4, 4, 4, 4, .3, .3, .2, .2, .1, .1, .1, .1])
    # duplicated diagonal entries too
    rows = np.concatenate([rows, [1, 1]])
    cols = np.concatenate([cols, [1, 1]])
    vals = np.concatenate([vals, [0.5, 0.25]])
    dense = np.zeros((n, n))
    np.add.at(dense, (rows, cols), vals)
    x_true = rng.standard_normal(n)
    b = dense @ x_true
    D = lcg.ScatteredDirectSolver(n, rows, cols, vals)
    np.testing.assert_allclose(D.solve(b).x, x_true, atol=1e-12)
    # the iterative operator agrees
    A = lcg.ScatteredOperator(n, rows, cols, vals)
    np.testing.assert_allclose(np.asarray(A.mv(jnp.asarray(x_true))), b,
                               atol=1e-12)


def test_realify_scattered_zero_real_diagonal():
    """A purely imaginary diagonal entry has a zero REAL part — the
    realified product is still well-defined and must not trip the direct
    solver's invertibility check (round-4 review)."""
    n = 5
    diag = np.array([2 + 1j, 3 + 0j, 2j, 1 + 1j, 4 + 0j])
    rows = np.concatenate([np.arange(n), [0, 4]])
    cols = np.concatenate([np.arange(n), [4, 0]])
    vals = np.concatenate([diag, [0.5 + 0.1j, 0.5 + 0.1j]])
    A = lcg.ScatteredOperator(n, rows, cols, vals)
    p = lcg.SolverParams(epsilon=1e-14)
    dense = np.zeros((n, n), complex)
    np.add.at(dense, (rows, cols), vals)
    x_true = np.arange(1, n + 1) + 1j * np.ones(n)
    b = dense @ x_true
    r = lcg.solve_realified(A, b, method="bicg_sym", params=p)
    np.testing.assert_allclose(r.x, x_true, atol=1e-6)


def test_solve_realified_user_key_and_host_error_paths(complex_sym_small):
    A, b, _ = complex_sym_small
    op = lcg.DenseOperator(A)
    import jax

    # user-supplied PRNG key must not break the jit cache (round-4 review)
    r = lcg.solve_realified(op, b, method="cgs",
                            params=lcg.SolverParams(epsilon=1e-12),
                            key=jax.random.PRNGKey(7))
    assert lcg.Status(int(r.status_code)) == lcg.Status.CONVERGENCE
    # error-path x stays HOST numpy (complex device arrays are deferred
    # UNIMPLEMENTED bombs on complex-less backends)
    res = lcg.solve_realified(op, b, method="pcg", M=None)
    assert isinstance(res.x, np.ndarray)
    res = lcg.solve_realified(op, b, method="pcg", M="jacobi",
                              params=lcg.SolverParams(epsilon=-1.0))
    assert isinstance(res.x, np.ndarray)
    assert int(res.status_code) < 0


def test_scattered_direct_guards():
    # Missing diagonal -> ValueError; too many coupled -> ValueError.
    with pytest.raises(ValueError, match="diagonal"):
        lcg.ScatteredDirectSolver(3, [0, 1], [0, 1], [1.0, 1.0])
    n = 64
    rows = list(range(n)) + [i for i in range(n - 1)]
    cols = list(range(n)) + [i + 1 for i in range(n - 1)]
    vals = [2.0] * n + [0.5] * (n - 1)
    with pytest.raises(ValueError, match="max_coupled"):
        lcg.ScatteredDirectSolver(n, np.array(rows), np.array(cols),
                                  np.array(vals), max_coupled=8)
    assert lcg.try_scattered_direct(3, [0, 1], [0, 1], [1.0, 1.0]) is None
