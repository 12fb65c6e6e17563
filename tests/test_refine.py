"""Mixed-precision iterative refinement (solvers/refine.py).

The replacement for the reference's float-copy mixed-precision story
(src/lib/clcg_cudaf.h/.cu): f32 inner solves + f64 residual correction
reach full f64 accuracy at f32 throughput.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

import liblcg_tpu as lcg

EPS_F64 = 1e-24  # squared-norm metric ~ rel 1e-12: beyond f32's reach


def _lap(n=12, dtype=jnp.float64):
    return lcg.Laplacian3DOperator(n, n, n, dtype=dtype)


def test_ir_reaches_f64_accuracy_with_f32_inner():
    A = _lap()
    b = jnp.ones((A.shape[0],), jnp.float64)
    p = lcg.SolverParams(epsilon=EPS_F64)
    r = lcg.solve_refined(A, b, params=p, trace_len=8)
    direct = lcg.solve(A, b, method="cg", params=p)
    assert int(r.status_code) == int(lcg.Status.CONVERGENCE)
    assert float(r.residual) <= EPS_F64
    np.testing.assert_allclose(np.asarray(r.x), np.asarray(direct.x),
                               rtol=0, atol=1e-9)
    # An f32-only solve may drive its RECURSIVE residual below this
    # epsilon, but its TRUE residual stagnates near the f32 rounding
    # floor — refinement certifies the true residual in f64.
    f32 = lcg.solve(A.astype(jnp.float32), b.astype(jnp.float32),
                    params=lcg.SolverParams(epsilon=EPS_F64,
                                            max_iterations=2000))
    x32 = np.asarray(f32.x, np.float64)
    rr32 = np.asarray(b) - np.asarray(A.mv(jnp.asarray(x32)))
    true32 = np.sum(rr32 ** 2) / max(np.sum(x32 ** 2), 1.0)
    assert true32 > 1e3 * EPS_F64          # f32 floor: orders above eps
    assert float(r.residual) <= EPS_F64    # IR's residual IS the true one


def test_ir_trace_counts_refinements():
    A = _lap()
    b = jnp.ones((A.shape[0],), jnp.float64)
    r = lcg.solve_refined(A, b, params=lcg.SolverParams(epsilon=EPS_F64),
                          trace_len=8)
    tr = np.asarray(r.trace)
    n_refine = int(np.count_nonzero(tr))
    assert 2 <= n_refine <= 5
    # outer residual contracts by ~the inner tolerance each refinement
    assert tr[1] < tr[0] * 1e-3


def test_ir_case10k_pcg_inner(case_10k):
    sys_, ans = case_10k
    A = lcg.make_sparse_operator(sys_.n, sys_.n, sys_.rows, sys_.cols,
                                 sys_.vals)
    b = jnp.asarray(sys_.b)
    M = lcg.JacobiPreconditioner(A)
    r = lcg.solve_refined(A, b, method="pcg", M=M,
                          params=lcg.SolverParams(epsilon=EPS_F64))
    assert int(r.status_code) == int(lcg.Status.CONVERGENCE)
    assert float(np.mean(np.abs(np.asarray(r.x) - ans))) < 1e-5


def test_ir_already_optimized():
    A = _lap()
    b = jnp.ones((A.shape[0],), jnp.float64)
    x = lcg.solve(A, b, params=lcg.SolverParams(epsilon=1e-28)).x
    r = lcg.solve_refined(A, b, x0=x, params=lcg.SolverParams(epsilon=1e-20))
    assert int(r.status_code) == int(lcg.Status.ALREADY_OPTIMIZED)
    assert int(r.iterations) == 0


def test_ir_stall_or_cap_returns_best_iterate():
    """Starved inner budget (1 iteration per refinement): the solve must
    terminate with REACHED_MAX_ITERATIONS and return the best iterate."""
    A = _lap()
    b = jnp.ones((A.shape[0],), jnp.float64)
    r = lcg.solve_refined(
        A, b, params=lcg.SolverParams(epsilon=EPS_F64),
        inner_params=lcg.SolverParams(epsilon=1e-12, max_iterations=1),
        max_refinements=4)
    assert int(r.status_code) == int(lcg.Status.REACHED_MAX_ITERATIONS)
    assert np.isfinite(float(r.residual))
    # best-iterate guarantee: no worse than the zero initial guess
    r0 = float(jnp.sum(b * b) / 1.0)
    assert float(r.residual) <= r0


def test_ir_abs_diff_metric():
    A = _lap()
    n = A.shape[0]
    b = jnp.ones((n,), jnp.float64)
    p = lcg.SolverParams(epsilon=1e-13, abs_diff=1)  # sqrt(||r||^2)/n
    r = lcg.solve_refined(A, b, params=p)
    assert int(r.status_code) == int(lcg.Status.CONVERGENCE)
    rr = np.asarray(b) - np.asarray(A.mv(r.x))
    assert np.sqrt(np.sum(rr * rr)) / n <= 1e-13


def test_ir_guards():
    A = _lap()
    b = jnp.ones((A.shape[0],), jnp.float64)
    with pytest.raises(ValueError, match="preconditioner"):
        lcg.solve_refined(A, b, method="cg", M=lcg.JacobiPreconditioner(A))
    with pytest.raises(ValueError, match="unconstrained real"):
        lcg.solve_refined(A, b, method="spg")
    with pytest.raises(ValueError, match="real-domain"):
        lcg.solve_refined(A, b.astype(jnp.complex128))
    mf = lcg.MatrixFreeOperator(lambda v: 6.0 * v, n=8)
    with pytest.raises(NotImplementedError, match="A_low"):
        lcg.solve_refined(mf, jnp.ones(8))


def test_ir_matrix_free_with_explicit_a_low():
    d_hi = jnp.linspace(1.0, 3.0, 64).astype(jnp.float64)
    mf_hi = lcg.MatrixFreeOperator(lambda v: d_hi * v, n=64)
    mf_lo = lcg.MatrixFreeOperator(
        lambda v: d_hi.astype(jnp.float32) * v, n=64, dtype=jnp.float32)
    b = jnp.ones((64,), jnp.float64)
    r = lcg.solve_refined(mf_hi, b, A_low=mf_lo,
                          params=lcg.SolverParams(epsilon=EPS_F64))
    assert int(r.status_code) == int(lcg.Status.CONVERGENCE)
    np.testing.assert_allclose(np.asarray(r.x), 1.0 / np.asarray(d_hi),
                               rtol=1e-11)


# ---- operator astype ---------------------------------------------------------


def _rand_coo(n=24, seed=3):
    rng = np.random.default_rng(seed)
    A = np.where(rng.uniform(size=(n, n)) < 0.2, rng.normal(size=(n, n)), 0.0)
    np.fill_diagonal(A, 4.0)
    r, c = np.nonzero(A)
    return n, r, c, A[r, c], A


def test_astype_concrete_operators():
    n, r, c, v, A = _rand_coo()
    x = np.linspace(-1, 1, n)
    ops = [
        lcg.DenseOperator(A),
        lcg.SparseOperator(n, n, r, c, v),
        lcg.BandedOperator(n, n, r, c, v),
        lcg.Laplacian3DOperator(4, 3, 2, dtype=jnp.float64),
        lcg.NormalEqOperator(lcg.DenseOperator(A)),
        lcg.ScaledOperator(2.0, lcg.DenseOperator(A)),
        lcg.SumOperator(lcg.DenseOperator(A), lcg.DenseOperator(A)),
        lcg.ProductOperator(lcg.DenseOperator(A), lcg.DenseOperator(A)),
    ]
    for op in ops:
        lo = op.astype(jnp.float32)
        assert lo.dtype == jnp.dtype(jnp.float32), type(op).__name__
        xx = x[: op.shape[1]]
        hi_out = np.asarray(op.mv(jnp.asarray(xx)))
        lo_out = np.asarray(lo.mv(jnp.asarray(xx, jnp.float32)))
        np.testing.assert_allclose(lo_out, hi_out, rtol=2e-5, atol=2e-4)


def test_astype_stencil_and_realified():
    kappa = np.exp(np.random.default_rng(0).normal(size=(4, 4, 4)))
    S = lcg.Stencil3DOperator.diffusion(kappa, dtype=np.float64)
    S32 = S.astype(jnp.float32)
    x = np.linspace(0, 1, S.shape[1])
    np.testing.assert_allclose(
        np.asarray(S32.mv(jnp.asarray(x, jnp.float32))),
        np.asarray(S.mv(jnp.asarray(x))), rtol=1e-5, atol=1e-5)

    n, r, c, v, A = _rand_coo(seed=5)
    Ac = A + 1j * np.triu(A, 1)
    R = lcg.realify(lcg.DenseOperator(Ac))
    R32 = R.astype(jnp.float32)
    z = np.linspace(-1, 1, 2 * n)
    np.testing.assert_allclose(
        np.asarray(R32.mv(jnp.asarray(z, jnp.float32))),
        np.asarray(R.mv(jnp.asarray(z))), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="real-valued"):
        R.astype(jnp.complex64)


def test_astype_jacobi_preconditioner():
    n, r, c, v, A = _rand_coo()
    M = lcg.JacobiPreconditioner(lcg.DenseOperator(A))
    M32 = M.astype(jnp.float32)
    assert M32.dtype == jnp.dtype(jnp.float32)
    np.testing.assert_allclose(np.asarray(M32.inv_diag),
                               np.asarray(M.inv_diag).astype(np.float32))


def test_ir_bf16_inner_reaches_f64_accuracy():
    """bf16 inner solves refine to deep f64 residuals when
    cond(A)*u_bf16 < 1 (here cond~40): more refinements (contraction
    ~6e-2/step vs f32's ~1e-6), dots accumulated in f32 (auto
    reduce_dtype for sub-f32 dtypes).  For stiff systems bf16 IR stalls
    (on 128^3: cond*u ~ 26, stalls at 7e-5) — f32 inner is the default."""
    A = _lap(10)
    b = jnp.ones((A.shape[0],), jnp.float64)
    r = lcg.solve_refined(A, b, inner_dtype=jnp.bfloat16,
                          params=lcg.SolverParams(epsilon=1e-20),
                          max_refinements=24, trace_len=24)
    assert int(r.status_code) == int(lcg.Status.CONVERGENCE)
    assert float(r.residual) <= 1e-20
    tr = np.asarray(r.trace)
    n_refine = int(np.count_nonzero(tr))
    assert n_refine > 4  # coarser inner precision -> more outer steps
    direct = lcg.solve(A, b, method="cg",
                       params=lcg.SolverParams(epsilon=1e-20))
    np.testing.assert_allclose(np.asarray(r.x), np.asarray(direct.x),
                               rtol=0, atol=1e-7)


def test_ir_bf16_inner_defaults():
    """Sub-f32 inner dtypes get f32 dot accumulation and a floor-matched
    inner epsilon by default."""
    from liblcg_tpu.solvers.refine import _default_inner_params

    p32 = _default_inner_params(lcg.SolverParams(), jnp.dtype(jnp.float32))
    assert p32.reduce_dtype is None and 1e-13 < p32.epsilon < 1e-11
    pbf = _default_inner_params(lcg.SolverParams(), jnp.dtype(jnp.bfloat16))
    assert pbf.reduce_dtype == "float32" and 1e-4 < pbf.epsilon < 1e-1


# ---- sharded refinement ------------------------------------------------------


def test_ir_sharded_matches_single_device(case_10k):
    sys_, _ = case_10k
    A8 = lcg.ShardedSparseOperator(sys_.n, sys_.rows, sys_.cols, sys_.vals,
                                   n_devices=8)
    b = jnp.asarray(sys_.b)
    p = lcg.SolverParams(epsilon=EPS_F64)
    r8 = lcg.solve_refined_sharded(A8, b, params=p, trace_len=8)
    A1 = lcg.make_sparse_operator(sys_.n, sys_.n, sys_.rows, sys_.cols,
                                  sys_.vals, format="ell")
    r1 = lcg.solve_refined(A1, b, params=p)
    assert int(r8.status_code) == int(lcg.Status.CONVERGENCE)
    assert float(r8.residual) <= EPS_F64
    np.testing.assert_allclose(np.asarray(r8.x), np.asarray(r1.x),
                               rtol=0, atol=1e-8)
    # same refinement count as the single-device nest
    t8 = np.asarray(r8.trace)
    assert int(np.count_nonzero(t8)) in (2, 3, 4)


def test_ir_sharded_pcg_and_guards():
    AL = lcg.ShardedLaplacian3D(16, 16, 16, n_devices=8, dtype=jnp.float64)
    b = jnp.ones((AL.n,), jnp.float64)
    M = lcg.JacobiPreconditioner(jnp.full((AL.n,), 6.0))
    r = lcg.solve_refined_sharded(AL, b, method="pcg", M=M,
                                  params=lcg.SolverParams(epsilon=EPS_F64))
    assert int(r.status_code) == int(lcg.Status.CONVERGENCE)
    with pytest.raises(ValueError, match="preconditioner"):
        lcg.solve_refined_sharded(AL, b, method="cg", M=M)
    with pytest.raises(ValueError, match="unconstrained real"):
        lcg.solve_refined_sharded(AL, b, method="spg")


def test_sharded_astype():
    sysn, r_, c_, v_, _ = _rand_coo(n=64, seed=13)
    for cls_kw in (dict(),):
        A = lcg.ShardedSparseOperator(sysn, r_, c_, v_, n_devices=8, **cls_kw)
        A32 = A.astype(jnp.float32)
        assert A32.dtype == jnp.dtype(jnp.float32)
        assert A32.comm == A.comm and A32.halo == A.halo
    AL = lcg.ShardedLaplacian3D(8, 8, 8, n_devices=8, dtype=jnp.float64)
    assert AL.astype(jnp.float32).dtype == jnp.dtype(jnp.float32)


# ---- batched refinement ------------------------------------------------------


def test_ir_batched_matches_single(case_10k):
    sys_, _ = case_10k
    A = lcg.make_sparse_operator(sys_.n, sys_.n, sys_.rows, sys_.cols,
                                 sys_.vals)
    B = jnp.stack([jnp.asarray(sys_.b) * (1 + 0.1 * k) for k in range(3)])
    p = lcg.SolverParams(epsilon=EPS_F64)
    r = lcg.solve_refined_batched(A, B, params=p)
    assert np.all(np.asarray(r.status_code) == int(lcg.Status.CONVERGENCE))
    assert np.all(np.asarray(r.residual) <= EPS_F64)
    r1 = lcg.solve_refined(A, B[1], params=p)
    np.testing.assert_allclose(np.asarray(r.x[1]), np.asarray(r1.x),
                               rtol=0, atol=1e-8)


def test_ir_batched_per_system_freezing(case_10k):
    """A zero right-hand side is ALREADY_OPTIMIZED at zero inner
    iterations while the other systems refine to convergence."""
    sys_, _ = case_10k
    A = lcg.make_sparse_operator(sys_.n, sys_.n, sys_.rows, sys_.cols,
                                 sys_.vals)
    M = lcg.JacobiPreconditioner(A)
    B = jnp.stack([jnp.asarray(sys_.b), jnp.zeros((sys_.n,))])
    r = lcg.solve_refined_batched(A, B, method="pcg", M=M,
                                  params=lcg.SolverParams(epsilon=EPS_F64))
    st = np.asarray(r.status_code)
    assert st[0] == int(lcg.Status.CONVERGENCE)
    assert st[1] == int(lcg.Status.ALREADY_OPTIMIZED)
    assert int(np.asarray(r.iterations)[1]) == 0


def test_ir_batched_guards():
    A = _lap(8)
    B = jnp.ones((2, A.shape[0]), jnp.float64)
    with pytest.raises(ValueError, match="preconditioner"):
        lcg.solve_refined_batched(A, B, method="cg",
                                  M=lcg.JacobiPreconditioner(A))
    with pytest.raises(ValueError, match=r"\(nrhs, n\)"):
        lcg.solve_refined_batched(A, B[0])


def test_class_api_minimize_refined():
    """LCGSolver.MinimizeRefined: class-callback refinement with an
    explicit low-precision product."""
    d64 = jnp.linspace(2.0, 5.0, 128).astype(jnp.float64)
    d32 = d64.astype(jnp.float32)

    class S(lcg.LCGSolver):
        def AxProduct(self, x):
            return d64 * x

        def AxProductLow(self, x):
            return d32 * x

    s = S(dtype=jnp.float64).silent()
    b = jnp.ones((128,), jnp.float64)
    r = s.MinimizeRefined(b, params=lcg.SolverParams(epsilon=EPS_F64))
    assert int(r.status_code) == int(lcg.Status.CONVERGENCE)
    np.testing.assert_allclose(np.asarray(r.x), 1.0 / np.asarray(d64),
                               rtol=1e-12)

    class NoLow(lcg.LCGSolver):
        def AxProduct(self, x):
            return d64 * x

    with pytest.raises(NotImplementedError, match="AxProductLow"):
        NoLow(dtype=jnp.float64).silent().MinimizeRefined(b)


def test_ir_refined_cgnr_complex_case1k():
    """Refinement composes with the scattered-complex recipe: f64 CGNR
    on the realified case_1K with f32 inner Jacobi-PCG normal-equation
    solves — full f64-class residual from f32-speed iterations."""
    import os
    if not os.path.exists("/root/reference/data/case_1K_cA"):
        pytest.skip("reference data not present")
    from liblcg_tpu.utils import io

    s = io.read_system("/root/reference/data/case_1K_cA",
                       complex_values=True)
    ans = io.read_answer("/root/reference/data/case_1K_cB",
                         complex_values=True)
    r2, c2, v2 = lcg.realify_coo(s.rows, s.cols, s.vals)
    A2 = lcg.make_sparse_operator(2 * s.n, 2 * s.n, r2, c2, v2,
                                  format="ell")
    NE = lcg.NormalEqOperator(A2)
    rhs = A2.rmv(jnp.asarray(lcg.split_complex_interleaved(s.b)))
    M = lcg.JacobiPreconditioner(NE)
    r = lcg.solve_refined(NE, rhs, method="pcg", M=M,
                          params=lcg.SolverParams(epsilon=1e-26),
                          max_refinements=10)
    assert int(r.status_code) == int(lcg.Status.CONVERGENCE)
    x = lcg.merge_complex_interleaved(np.asarray(r.x))
    assert float(np.max(np.abs(x - ans))) < 1e-8
