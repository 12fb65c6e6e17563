"""Operator-format and IO tests: DIA vs ELL equivalence, auto format
selection, compositions, and reference binary round-trips."""

import os

import numpy as np
import jax.numpy as jnp
import pytest

import liblcg_tpu as lcg
from liblcg_tpu.utils import io


@pytest.fixture(scope="module")
def random_sparse():
    rng = np.random.default_rng(3)
    n = 128
    nnz = 700
    rows = rng.integers(0, n, nnz)
    cols = rng.integers(0, n, nnz)
    vals = rng.normal(size=nnz)
    dense = np.zeros((n, n))
    np.add.at(dense, (rows, cols), vals)
    return n, rows, cols, vals, dense


def test_dia_matches_ell_and_dense(random_sparse):
    n, rows, cols, vals, dense = random_sparse
    v = np.random.default_rng(0).normal(size=n)
    vj = jnp.asarray(v)
    ell = lcg.SparseOperator(n, n, rows, cols, vals)
    dia = lcg.BandedOperator(n, n, rows, cols, vals)
    np.testing.assert_allclose(np.asarray(dia.mv(vj)), dense @ v, atol=1e-12)
    np.testing.assert_allclose(np.asarray(ell.mv(vj)), dense @ v, atol=1e-12)
    np.testing.assert_allclose(np.asarray(dia.rmv(vj)), dense.T @ v, atol=1e-12)
    np.testing.assert_allclose(np.asarray(dia.diagonal()),
                               np.asarray(ell.diagonal()), atol=1e-14)


def test_auto_format_selection(case_10k):
    sys_, _ = case_10k
    # case_10K has 19 diagonals -> DIA
    A = lcg.make_sparse_operator(sys_.n, sys_.n, sys_.rows, sys_.cols, sys_.vals)
    assert isinstance(A, lcg.BandedOperator)
    assert A.n_diagonals == 19
    # A scattered random pattern -> ELL
    rng = np.random.default_rng(0)
    nnz = 500
    B = lcg.make_sparse_operator(
        1000, 1000, rng.integers(0, 1000, nnz), rng.integers(0, 1000, nnz),
        rng.normal(size=nnz),
    )
    assert isinstance(B, lcg.SparseOperator)


def test_forced_format(random_sparse):
    n, rows, cols, vals, _ = random_sparse
    assert isinstance(
        lcg.make_sparse_operator(n, n, rows, cols, vals, format="dia"),
        lcg.BandedOperator,
    )
    assert isinstance(
        lcg.make_sparse_operator(n, n, rows, cols, vals, format="ell"),
        lcg.SparseOperator,
    )
    with pytest.raises(ValueError):
        lcg.make_sparse_operator(n, n, rows, cols, vals, format="csr")


def test_duplicate_accumulation():
    # COO accumulate semantics (algebra.cpp:203-207): duplicates sum.
    rows = np.array([0, 0, 1, 1, 1])
    cols = np.array([0, 0, 1, 1, 0])
    vals = np.array([1.0, 2.0, 3.0, 4.0, 5.0])
    dense = np.array([[3.0, 0.0], [5.0, 7.0]])
    v = np.array([1.0, 2.0])
    for op in (lcg.SparseOperator(2, 2, rows, cols, vals),
               lcg.BandedOperator(2, 2, rows, cols, vals)):
        np.testing.assert_allclose(np.asarray(op.mv(jnp.asarray(v))), dense @ v)


def test_composition_operators(random_sparse):
    n, rows, cols, vals, dense = random_sparse
    A = lcg.DenseOperator(dense)
    v = np.random.default_rng(1).normal(size=n)
    vj = jnp.asarray(v)
    S = lcg.ScaledOperator(2.5, A)
    np.testing.assert_allclose(np.asarray(S.mv(vj)), 2.5 * dense @ v, atol=1e-12)
    Sum = lcg.SumOperator(A, S)
    np.testing.assert_allclose(np.asarray(Sum.mv(vj)), 3.5 * dense @ v, atol=1e-12)
    P = lcg.ProductOperator(A, A)
    np.testing.assert_allclose(np.asarray(P.mv(vj)), dense @ (dense @ v), atol=1e-10)
    np.testing.assert_allclose(np.asarray(P.rmv(vj)), dense.T @ (dense.T @ v),
                               atol=1e-10)


def test_io_roundtrip_real(tmp_path):
    rng = np.random.default_rng(5)
    n, nnz = 50, 120
    rows = rng.integers(0, n, nnz).astype(np.int32)
    cols = rng.integers(0, n, nnz).astype(np.int32)
    vals = rng.normal(size=nnz)
    b = rng.normal(size=n)
    p = str(tmp_path / "sys_A")
    io.write_system(p, rows, cols, vals, b)
    back = io.read_system(p)
    assert back.n == n and back.nnz == nnz
    np.testing.assert_array_equal(back.rows, rows)
    np.testing.assert_array_equal(back.cols, cols)
    np.testing.assert_allclose(back.vals, vals)
    np.testing.assert_allclose(back.b, b)


def test_io_roundtrip_complex(tmp_path):
    rng = np.random.default_rng(6)
    n, nnz = 30, 80
    rows = rng.integers(0, n, nnz).astype(np.int32)
    cols = rng.integers(0, n, nnz).astype(np.int32)
    vals = rng.normal(size=nnz) + 1j * rng.normal(size=nnz)
    x = rng.normal(size=n) + 1j * rng.normal(size=n)
    p = str(tmp_path / "sys_cA")
    io.write_system(p, rows, cols, vals, x)
    back = io.read_system(p, complex_values=True)
    np.testing.assert_allclose(back.vals, vals)
    np.testing.assert_allclose(back.b, x)
    pb = str(tmp_path / "sys_cB")
    io.write_answer(pb, x)
    np.testing.assert_allclose(io.read_answer(pb, complex_values=True), x)


def test_reads_shipped_headers():
    """Golden check of the documented binary layout (data/README:1-11)."""
    base = "/root/reference/data"
    if not os.path.exists(base):
        pytest.skip("reference data not mounted")
    s = io.read_system(f"{base}/case_10K_A")
    assert (s.n, s.nnz) == (10000, 48834)
    c = io.read_system(f"{base}/case_1K_cA", complex_values=True)
    assert (c.n, c.nnz) == (1000, 1200)


def test_aslinearoperator_errors():
    with pytest.raises(ValueError):
        lcg.aslinearoperator(lambda v: v)          # callable without n=
    with pytest.raises(ValueError):
        lcg.aslinearoperator(np.zeros((2, 2, 2)))  # not 2-D
    op = lcg.aslinearoperator(np.eye(4))
    assert isinstance(op, lcg.DenseOperator)
    same = lcg.aslinearoperator(op)
    assert same is op


def test_docs_build_runs():
    """The docs generator (the reference ships refman.pdf; we ship a
    markdown API build) runs clean and covers the package modules."""
    import subprocess
    import sys
    import os

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, os.path.join(repo, "docs", "generate_api.py")],
        capture_output=True, text=True, timeout=240,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    idx = os.path.join(repo, "docs", "api", "index.md")
    assert os.path.exists(idx)
    text = open(idx).read()
    for mod in ("liblcg_tpu.solve", "liblcg_tpu.parallel.api",
                "liblcg_tpu.solvers.sstep"):
        assert mod in text


def test_dia_scan_path_matches_dense():
    """Above SCAN_THRESHOLD diagonals the DIA products switch to a
    lax.scan of dynamic slices (compile-time fix for wide scattered
    patterns, e.g. realified complex systems); parity vs dense for
    mv / transpose / Hermitian on a rectangular complex matrix."""
    import jax.numpy as jnp

    from liblcg_tpu.ops import dia as D

    rng = np.random.default_rng(0)
    n, m = 300, 280
    dense = np.zeros((n, m), dtype=complex)
    for off in rng.choice(np.arange(-200, 200), size=120, replace=False):
        idx = np.arange(max(0, -off), min(n, m - off))
        if len(idx):
            dense[idx, idx + off] = rng.normal(size=len(idx)) + \
                1j * rng.normal(size=len(idx))
    rows, cols = np.nonzero(dense)
    offs, dv = D.coo_to_dia(n, m, rows, cols, dense[rows, cols])
    assert len(offs) > D.SCAN_THRESHOLD
    x = jnp.asarray(rng.normal(size=m) + 1j * rng.normal(size=m))
    np.testing.assert_allclose(
        np.asarray(D.dia_spmv(offs, jnp.asarray(dv), x)),
        dense @ np.asarray(x), atol=1e-12,
    )
    xr = jnp.asarray(rng.normal(size=n) + 1j * rng.normal(size=n))
    np.testing.assert_allclose(
        np.asarray(D.dia_spmv_transpose(offs, jnp.asarray(dv), xr, m)),
        dense.T @ np.asarray(xr), atol=1e-12,
    )
    np.testing.assert_allclose(
        np.asarray(D.dia_spmv_transpose(offs, jnp.asarray(dv), xr, m,
                                        conj=True)),
        dense.conj().T @ np.asarray(xr), atol=1e-12,
    )
