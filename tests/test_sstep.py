"""s-step (communication-avoiding) CG: parity with classic CG, stopping
semantics, solve() integration, and the sharded one-psum-per-block path.

The method being matched is the reference's CG (src/lib/lcg.cpp:143-274)
— ca_cg must reproduce its iterates (exactly in f64, within rounding in
f32) while restructuring the per-iteration memory/communication pattern.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import liblcg_tpu as lcg
from liblcg_tpu.solvers import real as _real
from liblcg_tpu.solvers.sstep import ca_cg, xla_basis_gram, basis_recurrence
from liblcg_tpu.types import Status


def _laplacian(g=20, dtype=jnp.float64):
    A = lcg.Laplacian3DOperator(g, g, g, dtype=dtype)
    rng = np.random.default_rng(3)
    b = jnp.asarray(rng.standard_normal(g ** 3), dtype)
    return A, b


@pytest.mark.parametrize(
    "s,basis", [(1, "monomial"), (3, "monomial"), (4, "chebyshev"),
                (8, "chebyshev")]
)
def test_f64_iteration_parity_with_cg(s, basis):
    A, b = _laplacian()
    params = lcg.SolverParams(epsilon=1e-14)
    ref = _real.cg(A, b, params=params)
    out = ca_cg(A, b, s=s, basis=basis, lmin=0.0, lmax=12.0, params=params)
    assert int(out["status"]) == int(Status.CONVERGENCE)
    assert int(out["t"]) == int(ref["t"])
    rel = jnp.linalg.norm(b - A.mv(out["x"])) / jnp.linalg.norm(b)
    assert float(rel) < 1e-6


def test_f32_parity_and_true_residual():
    A, b = _laplacian(dtype=jnp.float32)
    params = lcg.SolverParams(epsilon=1e-10)
    ref = _real.cg(A, b, params=params)
    out = ca_cg(A, b, s=8, basis="chebyshev", lmin=0.0, lmax=12.0,
                params=params)
    assert int(out["status"]) == int(Status.CONVERGENCE)
    # rounding may shift the count by an iteration or two
    assert abs(int(out["t"]) - int(ref["t"])) <= 2
    rel = jnp.linalg.norm(b - A.mv(out["x"])) / jnp.linalg.norm(b)
    assert float(rel) < 2e-5


def test_x0_and_abs_diff_parity():
    A, b = _laplacian()
    rng = np.random.default_rng(7)
    x0 = jnp.asarray(rng.standard_normal(b.shape[0]))
    params = lcg.SolverParams(epsilon=1e-9, abs_diff=True)
    ref = _real.cg(A, b, x0, params=params)
    out = ca_cg(A, b, x0, s=5, basis="chebyshev", lmin=0.0, lmax=12.0,
                params=params)
    assert int(out["t"]) == int(ref["t"])
    np.testing.assert_allclose(np.asarray(out["x"]), np.asarray(ref["x"]),
                               rtol=1e-8, atol=1e-8)


def test_max_iterations_and_trace():
    A, b = _laplacian()
    params = lcg.SolverParams(epsilon=1e-30, max_iterations=10)
    ref = _real.cg(A, b, params=params, trace_len=12)
    out = ca_cg(A, b, s=4, basis="chebyshev", lmin=0.0, lmax=12.0,
                params=params, trace_len=12)
    assert int(out["status"]) == int(Status.REACHED_MAX_ITERATIONS)
    assert int(out["t"]) == 10 == int(ref["t"])
    # trace records the same residual sequence as classic CG
    np.testing.assert_allclose(
        np.asarray(out["trace"])[:10], np.asarray(ref["trace"])[:10],
        rtol=1e-10,
    )


def test_already_optimized_and_monitor_stop():
    A, b = _laplacian()
    out = ca_cg(A, jnp.zeros_like(b), s=4, basis="monomial",
                params=lcg.SolverParams(epsilon=1e-14))
    assert int(out["status"]) == int(Status.ALREADY_OPTIMIZED)
    assert int(out["t"]) == 0

    # monitor fires at outer-step granularity: stop after >= 6 iterations
    out = ca_cg(A, b, s=4, basis="monomial",
                params=lcg.SolverParams(epsilon=1e-30),
                monitor=lambda x, res, t: t >= 6)
    assert int(out["status"]) == int(Status.STOP)
    assert 6 <= int(out["t"]) <= 8  # stops at the s-block boundary


def test_nan_classification():
    n = 64
    M = np.eye(n)
    M[3, 3] = np.nan
    out = ca_cg(lcg.DenseOperator(jnp.asarray(M)), jnp.ones((n,)), s=4,
                basis="monomial", params=lcg.SolverParams(epsilon=1e-14))
    assert int(out["status"]) == int(Status.NAN_VALUE)


def test_solve_integration_auto_bounds(case_10k):
    sys_, answer = case_10k
    A = lcg.make_sparse_operator(sys_.n, sys_.n, sys_.rows, sys_.cols,
                                 sys_.vals)
    b = jnp.asarray(sys_.b)
    params = lcg.SolverParams(epsilon=1e-12)
    ref = lcg.solve(A, b, method="cg", params=params)
    res = lcg.solve(A, b, method="cacg", params=params, s=6)
    assert res.converged
    # same iterate sequence as CG (121-iteration reference parity class)
    assert abs(int(res.iterations) - int(ref.iterations)) <= 1
    # matches classic CG's solution (the shipped answer is only reachable
    # to ~3e-4 at this epsilon — CG itself stops there too)
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(ref.x),
                               rtol=1e-8, atol=1e-8)
    err = np.max(np.abs(np.asarray(res.x) - answer))
    assert err < 1e-3

    # alias
    res2 = lcg.solve(A, b, method="ca_cg", params=params, s=6)
    assert int(res2.iterations) == int(res.iterations)


def test_cacg_jacobi_preconditioned(case_10k):
    """solve(method='cacg', M=Jacobi) = CG on the symmetrically scaled
    system: converges, tracks pcg's iteration count closely (same
    preconditioned spectrum; stopping metric differs — scaled vs true
    residual), physical-space answer."""
    sys_, answer = case_10k
    A = lcg.make_sparse_operator(sys_.n, sys_.n, sys_.rows, sys_.cols,
                                 sys_.vals)
    b = jnp.asarray(sys_.b)
    params = lcg.SolverParams(epsilon=1e-12)
    M = lcg.JacobiPreconditioner(A)
    ref = lcg.solve(A, b, method="pcg", M=M, params=params)
    res = lcg.solve(A, b, method="cacg", M=M, params=params, s=4)
    assert res.converged
    assert abs(int(res.iterations) - int(ref.iterations)) <= max(
        4, int(0.1 * int(ref.iterations))
    )
    # The stop fires on the SCALED residual (M^-1-weighted norm), so
    # certify the physical solution by its true relative residual — the
    # stored answer is only reachable to ~1e-3 at this epsilon either way.
    true_res = float(jnp.linalg.norm(b - A.mv(res.x)) / jnp.linalg.norm(b))
    assert true_res < 1e-5
    err = np.max(np.abs(np.asarray(res.x) - answer))
    assert err < 5e-3

    # monitor sees the PHYSICAL iterate (norm scale of the pcg solution)
    seen = []

    def mon(x, r, t):
        seen.append(None)
        return False

    res_m = lcg.solve(A, b, method="cacg", M=M, params=params, s=4,
                      monitor=mon)
    assert res_m.converged

    # x0 round-trips through the scaling
    res_w = lcg.solve(A, b, x0=res.x, method="cacg", M=M, params=params,
                      s=4)
    assert int(res_w.iterations) <= 1

    # non-diagonal M is rejected with a pointer to pcg
    from liblcg_tpu.operators import DenseOperator
    with pytest.raises(ValueError, match="diagonal .*Jacobi"):
        lcg.solve(A, b, method="cacg",
                  M=DenseOperator(jnp.eye(sys_.n)), params=params)


def test_solve_laplacian_auto_bounds():
    A, b = _laplacian(16)
    params = lcg.SolverParams(epsilon=1e-12)
    ref = lcg.solve(A, b, method="cg", params=params)
    res = lcg.solve(A, b, method="cacg", params=params, s=4)
    assert res.converged
    assert int(res.iterations) == int(ref.iterations)


def test_sharded_cacg_matches_single_device():
    from liblcg_tpu.parallel import ShardedLaplacian3D, solve_sharded

    g = 16
    A1 = lcg.Laplacian3DOperator(g, g, g, dtype=jnp.float64)
    S = ShardedLaplacian3D(g, g, g, n_devices=8, dtype=jnp.float64)
    rng = np.random.default_rng(11)
    b = jnp.asarray(rng.standard_normal(g ** 3))
    params = lcg.SolverParams(epsilon=1e-13)
    ref = lcg.solve(A1, b, method="cacg", params=params, s=4)
    res = solve_sharded(S, b, method="cacg", params=params, s=4)
    assert res.converged
    assert int(res.iterations) == int(ref.iterations)
    np.testing.assert_allclose(np.asarray(res.x), np.asarray(ref.x),
                               rtol=1e-9, atol=1e-9)


def _while_body_text(txt: str) -> str:
    """Extract the (largest) while-loop body computation from HLO text.

    HLO text lays computations out flat (one brace level per
    computation); the while instruction names its body via ``body=%name``.
    An earlier version of this test grepped ``%region_\\d+`` fragments —
    the compiled body is actually named ``%wide.region_..._spmd...``, so
    that regex matched nothing and the assertion was vacuous."""
    import re

    names = re.findall(r"body=%([\w.\-]+)", txt)
    assert names, "no while loop found in compiled HLO"
    bodies = []
    for name in names:
        m = re.search(
            r"^%?" + re.escape(name) + r"[^\n]*\{\n(.*?)\n\}",
            txt, re.S | re.M,
        )
        if m:
            bodies.append(m.group(1))
    assert bodies, f"while bodies {names} not found in HLO text"
    return max(bodies, key=len)


def test_sharded_cacg_collectives_per_block():
    """The communication-avoiding property, asserted on the compiled HLO:
    the while body (= ONE s-iteration block) contains at most 2
    all-reduces — the Gram/moment psum and the block-end norm psum — so
    collectives per ITERATION are 2/s, an s-fold reduction vs classic
    CG's 2 per iteration (test_weak_scaling pins the classic bound)."""
    from liblcg_tpu.parallel import ShardedLaplacian3D, make_mesh
    from liblcg_tpu.solvers import harness as H
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    g = 16
    s = 4
    S = ShardedLaplacian3D(g, g, g, n_devices=8, dtype=jnp.float64)
    mesh = make_mesh(8, "rows")
    params = lcg.SolverParams(epsilon=1e-13)

    def local(b):
        with H.distributed("rows", logical_dim=g ** 3):
            return ca_cg(S, b, s=s, basis="chebyshev", lmin=0.0,
                         lmax=12.0, params=params)["x"]

    fn = shard_map(local, mesh=mesh, in_specs=P("rows"), out_specs=P("rows"))
    txt = jax.jit(fn).lower(jnp.ones((g ** 3,))).compile().as_text()
    import re

    body = _while_body_text(txt)
    # opcode occurrences only — operand references like
    # get-tuple-element(%all-reduce.8) must not count
    n_ar = len(re.findall(r"(?<!%)all-reduce\(", body))
    assert 1 <= n_ar <= 2, (
        f"expected 1-2 all-reduces per s-block, found {n_ar}"
    )


def test_basis_gram_consistency():
    """xla_basis_gram's Gram/moment block agrees with explicit products."""
    A, b = _laplacian(8)
    rng = np.random.default_rng(0)
    n = b.shape[0]
    p = jnp.asarray(rng.standard_normal(n))
    r = jnp.asarray(rng.standard_normal(n))
    x = jnp.asarray(rng.standard_normal(n))
    s = 3
    abc = basis_recurrence(s, "chebyshev", 0.0, 12.0)
    V, G, w, xx = xla_basis_gram(A, p, r, x, s=s, abc=abc)
    assert V.shape == (2 * s + 1, n)
    np.testing.assert_allclose(np.asarray(G), np.asarray(V @ V.T),
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(np.asarray(w), np.asarray(V @ x), rtol=1e-10)
    np.testing.assert_allclose(float(xx), float(x @ x), rtol=1e-12)
    # the recurrence tracks A: columns satisfy A v_j = b_j v_{j+1} + a_j v_j
    a, bc, cc = abc
    for j in range(s):
        lhs = A.mv(V[j])
        rhs = bc[j] * V[j + 1] + a[j] * V[j] + (cc[j] * V[j - 1] if j else 0)
        np.testing.assert_allclose(np.asarray(lhs), np.asarray(rhs),
                                   rtol=1e-10, atol=1e-10)


def test_refined_cacg_inner_engine():
    """solve_refined composes with the s-step inner engine: full
    working-precision residuals at cacg's collective economy (the
    multi-chip recipe)."""
    g = 16
    A = lcg.Laplacian3DOperator(g, g, g, dtype=jnp.float64)
    rng = np.random.default_rng(0)
    b = jnp.asarray(rng.standard_normal(g ** 3))
    params = lcg.SolverParams(epsilon=1e-24)
    ref = lcg.solve_refined(A, b, method="cg", params=params)
    res = lcg.solve_refined(A, b, method="cacg", params=params)
    assert res.converged
    tr = float(jnp.linalg.norm(b - A.mv(res.x)) / jnp.linalg.norm(b))
    assert tr < 1e-13
    assert abs(int(res.iterations) - int(ref.iterations)) <= 10


def test_refined_cacg_engine_is_cached():
    """The inner cacg engine must resolve to a CACHED partial: a fresh
    partial per call defeats refine._JIT_CACHE and re-traces the whole
    refinement program every solve (code-review finding).  lmin/lmax
    must also pass through for operators Gershgorin cannot bound."""
    from liblcg_tpu.solvers import refine as RF

    g = 12
    A = lcg.Laplacian3DOperator(g, g, g, dtype=jnp.float64)
    b = jnp.ones((g ** 3,))
    params = lcg.SolverParams(epsilon=1e-20)
    n0 = len(RF._JIT_CACHE)
    lcg.solve_refined(A, b, method="cacg", params=params)
    lcg.solve_refined(A, b, method="cacg", params=params)
    assert len(RF._JIT_CACHE) - n0 == 1

    Amf = lcg.aslinearoperator(lambda v: A.mv(v), n=g ** 3,
                               dtype=jnp.float64)
    A32 = lcg.Laplacian3DOperator(g, g, g, dtype=jnp.float32)
    r = lcg.solve_refined(Amf, b, method="cacg", params=params,
                          lmin=0.0, lmax=12.0, A_low=A32)
    assert r.converged
