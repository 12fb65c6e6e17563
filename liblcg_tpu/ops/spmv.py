"""Sparse matrix-vector product primitives (XLA path).

The reference's only nontrivial compute kernels are its COO SpMV loops
(``src/lib/algebra.cpp:195-222`` — forward and transposed, OpenMP) and the
cuSPARSE SpMV calls in the CUDA samples.  Here the general sparse layout is
**ELL** (fixed nnz-per-row with padding): the product becomes a dense gather
``x[cols]`` of shape (n, k) followed by a multiply-reduce, which XLA fuses
with no scalar loops and no dynamic shapes.  COO scatter-adds
are kept only as a fallback via ``segment_sum``.

Host-side format conversion (COO -> ELL / CSR) runs once in numpy at operator
construction; nothing here traces data-dependent shapes.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import numpy as np
import jax
import jax.numpy as jnp


class EllArrays(NamedTuple):
    """Padded ELL storage: ``cols``/``vals`` have shape (n_rows, k).

    Padding entries have ``vals == 0`` and ``cols`` pointing at row 0 (any
    in-range index is safe because the value is zero).
    """

    cols: jnp.ndarray  # int32 (n_rows, k)
    vals: jnp.ndarray  # (n_rows, k)


def coo_to_ell(
    n_rows: int,
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    pad_rows_to: int = 1,
) -> Tuple[np.ndarray, np.ndarray]:
    """Convert COO triplets to padded ELL (numpy, host side, once).

    Duplicate (row, col) entries are summed, matching the accumulate
    semantics of the reference COO SpMV (algebra.cpp:203-207).  ``pad_rows_to``
    rounds the row count up (for sharding or tile alignment); padded rows are
    all-zero.
    """
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals)
    # Sum duplicates by sorting on (row, col).
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    if len(rows) > 1:
        same = (rows[1:] == rows[:-1]) & (cols[1:] == cols[:-1])
        if same.any():
            # np.add.reduceat over group starts.
            starts = np.concatenate([[0], np.nonzero(~same)[0] + 1])
            rows = rows[starts]
            cols = cols[starts]
            vals = np.add.reduceat(vals, starts)

    n_padded = -(-n_rows // pad_rows_to) * pad_rows_to
    counts = np.bincount(rows, minlength=n_padded)
    k = int(counts.max()) if len(counts) else 0
    k = max(k, 1)
    ell_cols = np.zeros((n_padded, k), dtype=np.int32)
    ell_vals = np.zeros((n_padded, k), dtype=vals.dtype)
    # Position of each nnz within its row (rows are sorted).
    offsets = np.arange(len(rows)) - np.concatenate([[0], np.cumsum(counts)])[rows]
    ell_cols[rows, offsets] = cols.astype(np.int32)
    ell_vals[rows, offsets] = vals
    return ell_cols, ell_vals


def ell_spmv(cols: jnp.ndarray, vals: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """``(A @ x)`` for ELL storage: gather + multiply-reduce."""
    gathered = jnp.take(x, cols, axis=0)  # (n, k)
    return jnp.sum(vals * gathered, axis=1)


def coo_spmv_transposed(
    n_cols: int, rows: jnp.ndarray, cols: jnp.ndarray, vals: jnp.ndarray, x: jnp.ndarray
) -> jnp.ndarray:
    """``A^T @ x`` via segment-sum over COO triplets (fallback path).

    Mirrors the reference's transposed COO loop (algebra.cpp:209-215), but as
    a single XLA scatter-add with static segment count.
    """
    contrib = vals * jnp.take(x, rows, axis=0)
    return jax.ops.segment_sum(contrib, cols, num_segments=n_cols)


def dense_mv(A: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """Dense matvec.

    The reference's OpenMP dense matvec is ``lcg_matvec`` (algebra.cpp:165-193);
    here it is a single ``dot`` with an explicit accumulation type so
    f32/bf16 inputs still accumulate at full precision.

    ``precision=HIGHEST`` for f32 inputs: a default-precision f32 matmul
    may multiply in reduced precision (TF32 on GPUs), which turns the
    solver's operator into a perturbed one — Krylov residuals then stall
    around the perturbation level.  bf16 inputs keep the default — that
    precision was opted into by the caller.
    """
    preferred = jnp.promote_types(A.dtype, jnp.float32)
    if jnp.issubdtype(A.dtype, jnp.complexfloating):
        preferred = A.dtype
    prec = (None if A.dtype == jnp.dtype(jnp.bfloat16)
            else jax.lax.Precision.HIGHEST)
    return jnp.matmul(A, x, preferred_element_type=preferred,
                      precision=prec)


@partial(jax.jit, static_argnames=("n_chunks",))
def ell_spmv_chunked(cols, vals, x, n_chunks: int = 1):
    """Chunked ELL SpMV for very wide k: bounds peak gather footprint."""
    if n_chunks <= 1:
        return ell_spmv(cols, vals, x)
    k = cols.shape[1]
    chunk = -(-k // n_chunks)
    out = jnp.zeros(cols.shape[0], dtype=jnp.promote_types(vals.dtype, x.dtype))
    for c in range(n_chunks):
        sl = slice(c * chunk, min((c + 1) * chunk, k))
        if sl.start >= k:
            break
        out = out + jnp.sum(vals[:, sl] * jnp.take(x, cols[:, sl], axis=0), axis=1)
    return out
