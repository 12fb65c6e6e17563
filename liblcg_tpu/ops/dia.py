"""DIA (diagonal) sparse storage — the gather-free SpMV form.

An ELL product pays for index loads plus a scattered read of x.  A matrix with few occupied diagonals
(stencil discretizations — e.g. the shipped ``data/case_10K_A`` is a
19-diagonal operator) is better stored as those diagonals: the product

    y[i] = sum_d  vals_d[i] * x[i + offset_d]

is a static-shift multiply-add per diagonal — pure elementwise work at
memory bandwidth, no index traffic at all.  The implementation pads x once and
takes D static slices of it, so XLA fuses the whole product into a single
elementwise pass (x is read from on-chip cache for every shift).  The
reference has no DIA path (its COO SpMV is a scalar loop,
algebra.cpp:195-222).

Host-side conversion runs once in numpy.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import jax.numpy as jnp
from jax import lax

#: Above this many diagonals the unrolled static-slice product is replaced
#: by a lax.scan of dynamic slices: the unrolled graph's compile time
#: grows with the diagonal count (minutes at ~500 diagonals) while the scan
#: compiles in seconds and runs the same arithmetic as a single fused loop
#: region.
SCAN_THRESHOLD = 64


def coo_to_dia(
    n_rows: int,
    n_cols: int,
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    """Convert COO triplets to DIA storage.

    Returns ``(offsets, diag_vals)`` with ``offsets`` int64 (D,) sorted and
    ``diag_vals`` (D, n_rows): ``diag_vals[d, i] = A[i, i + offsets[d]]``
    (zero where out of range).  Duplicates are summed (COO accumulate
    semantics, algebra.cpp:203-207).
    """
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals)
    off = cols - rows
    offsets = np.unique(off)
    diag_vals = np.zeros((len(offsets), n_rows), dtype=vals.dtype)
    d_idx = np.searchsorted(offsets, off)
    np.add.at(diag_vals, (d_idx, rows), vals)
    return offsets, diag_vals


def dia_spmv(offsets, diag_vals: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """``A @ x`` for DIA storage of an (n, m) matrix.

    ``offsets`` must be static (numpy): each diagonal becomes one static
    slice of the zero-padded x — no gathers, no scatters, one fused pass.
    ``diag_vals[d, i]`` is zero wherever ``i + offsets[d]`` is out of range,
    so the padding contributes nothing.
    """
    n = diag_vals.shape[1]
    m = x.shape[0]
    offs = [int(o) for o in np.asarray(offsets)]
    pad_l = max(0, max((-o for o in offs), default=0))
    pad_r = max(0, max((n + o - m for o in offs), default=0))
    x_pad = jnp.pad(x, (pad_l, pad_r))
    out_dt = jnp.promote_types(diag_vals.dtype, x.dtype)
    if len(offs) > SCAN_THRESHOLD:
        starts = jnp.asarray([pad_l + o for o in offs], jnp.int32)

        def step(acc, ov):
            o, v = ov
            return acc + v * lax.dynamic_slice(x_pad, (o,), (n,)), None

        y, _ = lax.scan(step, jnp.zeros((n,), out_dt), (starts, diag_vals))
        return y
    y = None
    for d, o in enumerate(offs):
        term = diag_vals[d] * x_pad[pad_l + o : pad_l + o + n]
        y = term if y is None else y + term
    if y is None:
        y = jnp.zeros((n,), dtype=out_dt)
    return y


def dia_spmv_transpose(offsets, diag_vals, x, n_cols: int, conj: bool = False):
    """``A^T @ x`` (or ``A^H @ x``) from the same DIA storage.

    Identity: (A^T x)[j] = sum_d v_d[j - o_d] * x[j - o_d] — form the
    elementwise products p_d = v_d * x once, then shift each by -o_d.
    """
    n = diag_vals.shape[1]
    offs = [int(o) for o in np.asarray(offsets)]
    vals = jnp.conj(diag_vals) if conj else diag_vals
    pad_l = max(0, max((o for o in offs), default=0))
    pad_r = max(0, max((n_cols - o - n for o in offs), default=0))
    out_dt = jnp.promote_types(diag_vals.dtype, x.dtype)
    if len(offs) > SCAN_THRESHOLD:
        starts = jnp.asarray([pad_l - o for o in offs], jnp.int32)
        xn = x[:n]

        def step(acc, ov):
            o, v = ov
            p_pad = jnp.pad(v * xn, (pad_l, pad_r))
            return acc + lax.dynamic_slice(p_pad, (o,), (n_cols,)), None

        y, _ = lax.scan(step, jnp.zeros((n_cols,), out_dt), (starts, vals))
        return y
    y = None
    for d, o in enumerate(offs):
        p = vals[d] * x[:n]
        p_pad = jnp.pad(p, (pad_l, pad_r))
        # (shift by -o): y[j] = p[j - o]
        term = p_pad[pad_l - o : pad_l - o + n_cols]
        y = term if y is None else y + term
    if y is None:
        y = jnp.zeros((n_cols,), dtype=out_dt)
    return y
