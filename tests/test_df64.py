"""df64 (double-float) coefficient algebra: primitive accuracy and the
ca_cg coeff="df64" path.

What is being protected: the s-step coefficient recurrences need ~48+
mantissa bits (Gram quadratic forms cancel below f32 on near-collinear
bases); with x64 off there is no native wide dtype.  df64 must deliver
wide-path iteration counts from pure f32 elementwise ops.  Reference semantics being matched:
classic CG, src/lib/lcg.cpp:143-274.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import liblcg_tpu as lcg
from liblcg_tpu.ops import df64 as D
from liblcg_tpu.solvers import real as _real
from liblcg_tpu.solvers.sstep import ca_cg
from liblcg_tpu.types import Status


def _val(pair):
    return np.asarray(pair[0], np.float64) + np.asarray(pair[1], np.float64)


def test_two_sum_exact():
    rng = np.random.default_rng(0)
    a = jnp.asarray(rng.standard_normal(512), jnp.float32)
    b = jnp.asarray(rng.standard_normal(512) * 1e-6, jnp.float32)
    s, e = D.two_sum(a, b)
    exact = np.asarray(a, np.float64) + np.asarray(b, np.float64)
    np.testing.assert_array_equal(
        np.asarray(s, np.float64) + np.asarray(e, np.float64), exact
    )


def test_two_prod_exact():
    rng = np.random.default_rng(1)
    a = jnp.asarray(rng.standard_normal(512), jnp.float32)
    b = jnp.asarray(rng.standard_normal(512), jnp.float32)
    p, e = D.two_prod(a, b)
    exact = np.asarray(a, np.float64) * np.asarray(b, np.float64)
    np.testing.assert_array_equal(
        np.asarray(p, np.float64) + np.asarray(e, np.float64), exact
    )


@pytest.mark.parametrize("op,npop", [
    (D.add, np.add), (D.sub, np.subtract), (D.mul, np.multiply),
    (D.div, np.divide),
])
def test_pair_ops_accuracy(op, npop):
    rng = np.random.default_rng(2)
    a = rng.standard_normal(1024) * 10.0 ** rng.integers(-8, 8, 1024)
    b = rng.standard_normal(1024) * 10.0 ** rng.integers(-8, 8, 1024)
    A, B = D.from_array(jnp.asarray(a)), D.from_array(jnp.asarray(b))
    ref = npop(_val(A), _val(B))
    rel = np.abs(_val(op(A, B)) - ref) / np.maximum(np.abs(ref), 1e-300)
    assert float(rel.max()) < 1e-13


@pytest.mark.parametrize("n", [1, 2, 3, 7, 9, 13, 16])
def test_dot_beats_f32_on_cancellation(n):
    rng = np.random.default_rng(n)
    x = rng.standard_normal(n)
    y = rng.standard_normal(n)
    if n > 1:
        # engineer the dot to cancel to ~1e-10 of the operand scale
        y[-1] -= (x @ y) / x[-1] * (1.0 - 1e-10)
    X, Y = D.from_array(jnp.asarray(x)), D.from_array(jnp.asarray(y))
    ref = _val(X) @ _val(Y)
    got = float(_val(D.dot(X, Y)))
    # absolute error at the df64 floor (~2^-48 of operand scale)
    assert abs(got - ref) < 1e-12


def test_matvec_matmul():
    rng = np.random.default_rng(5)
    M = D.from_array(jnp.asarray(rng.standard_normal((18, 9))))
    N = D.from_array(jnp.asarray(rng.standard_normal((9, 9))))
    v = D.from_array(jnp.asarray(rng.standard_normal(9)))
    ref_mv = _val(M) @ _val(v)
    ref_mm = _val(M) @ _val(N)
    assert np.abs(_val(D.matvec(M, v)) - ref_mv).max() < 1e-13
    assert np.abs(_val(D.matmul(M, N)) - ref_mm).max() < 1e-12


def test_nan_propagates_through_hi():
    nanp = D.from_array(jnp.asarray(np.nan, jnp.float32))
    one = D.from_array(jnp.asarray(1.0, jnp.float32))
    assert np.isnan(_val(D.add(nanp, one)))
    assert np.isnan(_val(D.mul(nanp, one)))
    assert np.isnan(float(D.to_array(D.div(one, D.from_array(
        jnp.asarray(0.0, jnp.float32))))) * 0.0) or np.isinf(
        float(D.to_array(D.div(one, D.from_array(
            jnp.asarray(0.0, jnp.float32))))))
    # nonpos: NaN compares False (wide-path ``rr2 <= 0`` convention)
    assert not bool(D.nonpos(nanp))
    assert bool(D.nonpos(D.from_array(jnp.asarray(-1.0, jnp.float32))))
    assert bool(D.nonpos(D.from_array(jnp.asarray(0.0, jnp.float32))))


# ---------------------------------------------------------------------------
# ca_cg coefficient-mode integration
# ---------------------------------------------------------------------------


def _laplacian(g=20, dtype=jnp.float32):
    A = lcg.Laplacian3DOperator(g, g, g, dtype=dtype)
    rng = np.random.default_rng(3)
    b = jnp.asarray(rng.standard_normal(g ** 3), dtype)
    return A, b


@pytest.mark.parametrize("s", [4, 8])
def test_df64_iteration_parity_with_cg_f32(s):
    """df64 coefficients must deliver wide-path iteration counts — the
    plain-f32 coefficient path was measured at +70% iterations (339 vs
    200 at 128^3) from Gram cancellation."""
    A, b = _laplacian()
    params = lcg.SolverParams(epsilon=1e-10)
    ref = _real.cg(A, b, params=params)
    out = ca_cg(A, b, s=s, basis="chebyshev", lmin=0.0, lmax=12.0,
                params=params, coeff="df64")
    assert int(out["status"]) == int(Status.CONVERGENCE)
    assert abs(int(out["t"]) - int(ref["t"])) <= 2
    rel = jnp.linalg.norm(b - A.mv(out["x"])) / jnp.linalg.norm(b)
    assert float(rel) < 2e-5


def test_df64_matches_wide_blocks():
    """Block-by-block agreement with the wide path on the same system."""
    A, b = _laplacian()
    params = lcg.SolverParams(epsilon=1e-9)
    wide = ca_cg(A, b, s=4, basis="chebyshev", lmin=0.0, lmax=12.0,
                 params=params, coeff="wide", trace_len=64)
    df = ca_cg(A, b, s=4, basis="chebyshev", lmin=0.0, lmax=12.0,
               params=params, coeff="df64", trace_len=64)
    assert int(df["t"]) == int(wide["t"])
    # residual traces agree to f32 rounding over the whole history
    tw = np.asarray(wide["trace"])
    td = np.asarray(df["trace"])
    m = min(int(wide["t"]), int(df["t"]))
    valid = tw[:m] > 0
    assert np.allclose(td[:m][valid], tw[:m][valid], rtol=2e-3)


def test_df64_rejects_f64_storage():
    A, b = _laplacian(dtype=jnp.float64)
    with pytest.raises(ValueError, match="df64"):
        ca_cg(A, b, s=4, basis="chebyshev", lmin=0.0, lmax=12.0,
              coeff="df64")


def test_df64_x0_and_abs_diff():
    A, b = _laplacian()
    rng = np.random.default_rng(7)
    x0 = jnp.asarray(rng.standard_normal(b.shape[0]), jnp.float32)
    params = lcg.SolverParams(epsilon=1e-8, abs_diff=True)
    ref = _real.cg(A, b, x0, params=params)
    out = ca_cg(A, b, x0, s=4, basis="chebyshev", lmin=0.0, lmax=12.0,
                params=params, coeff="df64")
    assert int(out["status"]) == int(Status.CONVERGENCE)
    assert abs(int(out["t"]) - int(ref["t"])) <= 2


def test_auto_prefers_wide_on_cpu_with_x64():
    """On CPU with x64 available, auto must keep the (native-f64) wide
    path — df64 is the accelerator answer to EMULATED f64."""
    A, b = _laplacian()
    params = lcg.SolverParams(epsilon=1e-9)
    auto = ca_cg(A, b, s=4, basis="chebyshev", lmin=0.0, lmax=12.0,
                 params=params, coeff="auto")
    wide = ca_cg(A, b, s=4, basis="chebyshev", lmin=0.0, lmax=12.0,
                 params=params, coeff="wide")
    assert int(auto["t"]) == int(wide["t"])
