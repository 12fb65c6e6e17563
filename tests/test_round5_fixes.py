"""Round-5 regression tests.

The bench stdout JSON line outgrew a 2000-char tail window.  The fix is a
compact curated headline line on stdout + the full record in
``bench_full.json``.  These tests pin the contract.
"""

import json

from liblcg_tpu.bench import _COMPACT_MAP, _OK_KEYS, _compact_report


def _worst_case_full_report():
    out = {
        "metric": "laplacian128_f64_cg100_device_ms",
        "value": 123456.789,
        "unit": "ms",
        "vs_baseline": 123456.789,
        "device": "CudaDevice(id=0)",
    }
    for full_key, _ in _COMPACT_MAP:
        out[full_key] = 123456.789
    for k in _OK_KEYS:
        out[k] = True
    return out


def test_compact_line_fits_driver_tail_window():
    line = json.dumps(_compact_report(_worst_case_full_report()))
    # Driver tail is 2000 chars; leave headroom for incidental stdout.
    assert len(line) < 1500, len(line)


def test_compact_line_keeps_driver_contract_fields():
    c = _compact_report(_worst_case_full_report())
    for k in ("metric", "value", "unit", "vs_baseline"):
        assert k in c
    assert c["ok"] is True
    assert "stale_n" not in c


def test_compact_ok_false_when_any_workload_failed():
    out = _worst_case_full_report()
    out["case10kc_ok"] = False
    assert _compact_report(out)["ok"] is False


def test_compact_ok_false_when_no_ok_fields_present():
    out = _worst_case_full_report()
    for k in _OK_KEYS:
        del out[k]
    assert _compact_report(out)["ok"] is False


# --- block-solve traces ----------------------------------------------------


def _spd_stack(n=64, nrhs=3):
    import numpy as np

    rng = np.random.default_rng(2)
    C = rng.standard_normal((n, n))
    A = C @ C.T / n + 4.0 * np.eye(n)
    B = rng.standard_normal((nrhs, n))
    return A, B


def test_block_cg_records_per_system_traces():
    import numpy as np

    import liblcg_tpu as lcg

    A, B = _spd_stack()
    op = lcg.DenseOperator(A)
    p = lcg.SolverParams(epsilon=1e-12)
    r = lcg.solve_batched(op, B, method="block_cg", params=p, trace_len=8)
    tr = np.asarray(r.trace)
    assert tr.shape == (3, 8)
    # every system's early residuals are recorded and decreasing overall
    assert np.all(tr[:, 1] > 0)
    assert np.all(tr[:, 4] < tr[:, 1])
    # the vmapped batched path records the same metric; the t=0 entry
    # (initial residual, before any step) must agree exactly — later
    # entries legitimately diverge (shared vs independent Krylov spaces)
    r2 = lcg.solve_batched(op, B, method="cg", params=p, trace_len=8)
    np.testing.assert_allclose(tr[:, 0], np.asarray(r2.trace)[:, 0],
                               rtol=1e-6)


# --- halo/compute overlap structure ----------------------------------------


def _banded_real(n):
    import numpy as np

    rng = np.random.default_rng(5)
    main = 4.0 + rng.uniform(0, 1, n)
    off = rng.uniform(-1, 1, n - 1)
    off2 = rng.uniform(-0.5, 0.5, n - 2)
    rows = np.concatenate([np.arange(n), np.arange(n - 1), np.arange(1, n),
                           np.arange(n - 2), np.arange(2, n)])
    cols = np.concatenate([np.arange(n), np.arange(1, n), np.arange(n - 1),
                           np.arange(2, n), np.arange(n - 2)])
    vals = np.concatenate([main, off, off, off2, off2])
    return rows, cols, vals


def test_banded_halo_split_product_matches_dense():
    """The split sharded DIA product equals the assembled matrix product,
    and the interior rows are computable from the LOCAL shard alone (the
    by-construction overlap guarantee: _interior_mv contains no
    collective — it runs here outside any mesh)."""
    import numpy as np
    import jax
    from jax.sharding import PartitionSpec as P

    import liblcg_tpu as lcg

    n, D = 64, 8
    rows, cols, vals = _banded_real(n)
    dense = np.zeros((n, n))
    np.add.at(dense, (rows, cols), vals)
    Ab = lcg.parallel.ShardedBandedOperator(n, rows, cols, vals,
                                            n_devices=D)
    assert Ab.halo != (0, 0)
    x = np.linspace(-1, 1, n)

    mesh = lcg.make_mesh(D)
    y = jax.jit(jax.shard_map(
        lambda A_l, x_l: A_l.mv(x_l), mesh=mesh,
        in_specs=(jax.tree.map(lambda l: P("rows") if getattr(
            l, "ndim", 0) >= 1 and l.shape[0] == Ab.n_padded else P(), Ab),
            P("rows")),
        out_specs=P("rows")))(Ab, x)
    np.testing.assert_allclose(np.asarray(y), dense @ x, rtol=1e-12)

    # Interior product, collective-free by construction: shard 2's rows.
    h_l, h_r = Ab.halo
    nl = Ab.n_local
    sh = 2
    vals_l = np.asarray(Ab.dia_vals)[sh * nl:(sh + 1) * nl]
    import jax.numpy as jnp

    y_int = Ab._interior_mv(jnp.asarray(x[sh * nl:(sh + 1) * nl]),
                            jnp.asarray(vals_l))
    np.testing.assert_allclose(
        np.asarray(y_int),
        (dense @ x)[sh * nl + h_l:(sh + 1) * nl - h_r], rtol=1e-12)


def test_stencil_halo_split_product_matches_single_device():
    """Sharded Laplacian/variable-stencil products after the
    interior/boundary split equal the single-device operators exactly."""
    import numpy as np
    import jax
    from jax.sharding import PartitionSpec as P

    import liblcg_tpu as lcg

    nz, ny, nx, D = 24, 4, 4, 8
    assert nz // D == 3   # exactly the minimum interior
    S = lcg.ShardedLaplacian3D(nz, ny, nx, n_devices=D, dtype=np.float64)
    L = lcg.Laplacian3DOperator(nz, ny, nx, dtype=np.float64)
    x = np.linspace(-1, 1, nz * ny * nx)
    mesh = lcg.make_mesh(D)
    run = jax.jit(jax.shard_map(
        lambda A_l, x_l: A_l.mv(x_l), mesh=mesh,
        in_specs=(jax.tree.map(lambda l: P(), S), P("rows")),
        out_specs=P("rows")))
    np.testing.assert_allclose(np.asarray(run(S, x)),
                               np.asarray(L.mv(x)), rtol=1e-14, atol=1e-14)

    rng = np.random.default_rng(3)
    kappa = rng.uniform(0.5, 2.0, (nz, ny, nx))
    St = lcg.Stencil3DOperator.diffusion(kappa, dtype=np.float64)
    Ss = lcg.ShardedStencil3D(St, n_devices=D)
    run2 = jax.jit(jax.shard_map(
        lambda A_l, x_l: A_l.mv(x_l), mesh=mesh,
        in_specs=(jax.tree.map(
            lambda l: P("rows") if getattr(l, "ndim", 0) == 1 else P(), Ss),
            P("rows")),
        out_specs=P("rows")))
    # Same per-cell operation order; separately compiled programs may
    # differ by compiler FMA contraction (1 ulp), never by the split.
    np.testing.assert_allclose(np.asarray(run2(Ss, x)),
                               np.asarray(St.mv(x)), rtol=1e-14, atol=1e-14)


def test_block_cg_traces_sharded():
    import numpy as np

    import liblcg_tpu as lcg

    n = 64
    rng = np.random.default_rng(3)
    main = 4.0 + rng.uniform(0, 1, n)
    off = rng.uniform(-0.5, 0.5, n - 1)
    rows = np.concatenate([np.arange(n), np.arange(n - 1), np.arange(1, n)])
    cols = np.concatenate([np.arange(n), np.arange(1, n), np.arange(n - 1)])
    vals = np.concatenate([main, off, off])
    A8 = lcg.ShardedSparseOperator(n, rows, cols, vals, n_devices=8)
    B = np.stack([np.ones(n), 2.0 * np.ones(n), np.arange(n) * 0.1])
    r = lcg.solve_sharded(A8, B, method="block_cg",
                          params=lcg.SolverParams(epsilon=1e-12),
                          trace_len=6)
    tr = np.asarray(r.trace)
    assert tr.shape == (3, 6) and np.all(tr[:, 1] > 0)
