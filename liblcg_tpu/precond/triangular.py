"""Level-scheduled sparse triangular solves on device.

Sparse triangular substitution is the hard device kernel in this library: the
reference runs it as a sequential row scan on host/GPU
(``preconditioner.cpp:309-366`` native COO; ``preconditioner_eigen.cpp:
925-1047`` Eigen; cusparse csrsv2 in the CUDA samples).  A row-by-row scan
cannot map to a vector unit, but rows whose dependencies are satisfied can
solve *in parallel*: classic level scheduling.

Host side (once, numpy): topologically layer the rows of L (or U) into
levels; pack each level's rows and their off-diagonal entries into padded
ELL blocks.  Device side: a ``lax.fori_loop`` over levels, each level one
gather + multiply-reduce + masked scatter — static shapes, no data-dependent
control flow, XLA-fusible.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import jax.numpy as jnp
from jax import lax
from jax.tree_util import register_pytree_node

from ..operators import LinearOperator


class LevelSchedule(NamedTuple):
    """Device-ready level-scheduled triangular factor.

    Shapes: ``level_rows`` (n_levels, rows_per_level) padded with ``n``
    (out-of-range; scatters drop it), ``ell_cols``/``ell_vals``
    (n_levels, rows_per_level, k) padded with zeros, ``inv_diag``
    (n_levels, rows_per_level).
    """

    level_rows: jnp.ndarray
    ell_cols: jnp.ndarray
    ell_vals: jnp.ndarray
    inv_diag: jnp.ndarray
    n: int

    @property
    def n_levels(self) -> int:
        return self.level_rows.shape[0]


def level_schedule(
    n: int, rows, cols, vals, *, lower: bool = True
) -> LevelSchedule:
    """Build a LevelSchedule from COO triplets of a triangular matrix.

    ``lower=True`` expects entries with row >= col (forward substitution);
    ``lower=False`` expects row <= col (backward substitution).  The diagonal
    must be fully present and nonzero — the reference enforces the same via
    ``lcg_full_rank_coo`` (preconditioner.cpp:368-381).
    """
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals)

    diag_mask = rows == cols
    diag = np.zeros(n, dtype=vals.dtype)
    diag[rows[diag_mask]] = vals[diag_mask]
    if np.any(diag == 0):
        missing = int(np.sum(diag == 0))
        raise ValueError(
            f"triangular factor is rank deficient: {missing} zero/missing "
            "diagonal entries"
        )

    o_rows = rows[~diag_mask]
    o_cols = cols[~diag_mask]
    o_vals = vals[~diag_mask]

    order = np.argsort(o_rows, kind="stable")
    o_rows_s, o_cols_s, o_vals_s = o_rows[order], o_cols[order], o_vals[order]
    starts = np.searchsorted(o_rows_s, np.arange(n + 1))

    # Dependency depth per row: level[i] = 1 + max(level[j]) over off-diag
    # deps j, processed in substitution order.  The chain is sequential —
    # the native C++ pass handles it when available; Python row scan else.
    from .. import native

    level = native.level_schedule_levels(n, o_rows_s, o_cols_s, lower)
    if level is None:
        level = np.zeros(n, dtype=np.int64)
        row_order = range(n) if lower else range(n - 1, -1, -1)
        for i in row_order:
            deps = o_cols_s[starts[i] : starts[i + 1]]
            if len(deps):
                level[i] = level[deps].max() + 1

    n_levels = int(level.max()) + 1 if n else 1
    counts = np.bincount(level, minlength=n_levels)
    rows_per_level = int(counts.max())

    # Pack rows into (level, slot) positions — vectorized numpy throughout.
    order_rows = np.lexsort((np.arange(n), level))
    level_offsets = np.concatenate([[0], np.cumsum(counts)])
    slot_sorted = np.arange(n) - level_offsets[level[order_rows]]
    level_rows = np.full((n_levels, rows_per_level), n, dtype=np.int32)
    level_rows[level[order_rows], slot_sorted] = order_rows
    slot_of_row = np.empty(n, dtype=np.int64)
    slot_of_row[order_rows] = slot_sorted

    k = int(np.bincount(o_rows, minlength=n).max()) if len(o_rows) else 0
    k = max(k, 1)
    ell_cols = np.zeros((n_levels, rows_per_level, k), dtype=np.int32)
    ell_vals = np.zeros((n_levels, rows_per_level, k), dtype=vals.dtype)
    if len(o_rows_s):
        pos = np.arange(len(o_rows_s)) - starts[o_rows_s]
        ell_cols[level[o_rows_s], slot_of_row[o_rows_s], pos] = o_cols_s
        ell_vals[level[o_rows_s], slot_of_row[o_rows_s], pos] = o_vals_s

    inv_diag = np.zeros((n_levels, rows_per_level), dtype=vals.dtype)
    valid = level_rows < n
    inv_diag[valid] = 1.0 / diag[level_rows[valid]]

    return LevelSchedule(
        level_rows=jnp.asarray(level_rows),
        ell_cols=jnp.asarray(ell_cols),
        ell_vals=jnp.asarray(ell_vals),
        inv_diag=jnp.asarray(inv_diag),
        n=n,
    )


def triangular_solve(sched: LevelSchedule, b: jnp.ndarray) -> jnp.ndarray:
    """Solve ``T x = b`` for the level-scheduled triangular factor T."""
    n = sched.n
    # Derive the init from b (not jnp.zeros) so its device-variance matches
    # the loop body under shard_map's VMA tracking.
    x0 = (b * 0).astype(jnp.promote_types(b.dtype, sched.ell_vals.dtype))

    def body(l, x):
        rows_l = sched.level_rows[l]          # (R,) padded with n
        cols_l = sched.ell_cols[l]            # (R, k)
        vals_l = sched.ell_vals[l]
        s = jnp.sum(vals_l * jnp.take(x, cols_l, axis=0), axis=1)
        b_l = jnp.take(b, rows_l, axis=0, mode="fill", fill_value=0)
        x_l = (b_l - s) * sched.inv_diag[l]
        return x.at[rows_l].set(x_l, mode="drop")

    return lax.fori_loop(0, sched.n_levels, body, x0)


def _sched_flatten(s: LevelSchedule):
    return (s.level_rows, s.ell_cols, s.ell_vals, s.inv_diag), (s.n,)


def _sched_unflatten(aux, children):
    return LevelSchedule(*children, n=aux[0])


# NamedTuple is already a pytree; no extra registration needed.


class TriangularPreconditioner(LinearOperator):
    """M^{-1} x = U^{-1} (D?) L^{-1} x from level-scheduled factors.

    The reference applies IC/ILU preconditioners as two user-side triangular
    solves inside the ``MxProduct`` callback (sample7.cpp:107-108,
    sample8.cu:112-118); this operator packages the same application for the
    solve loop.  ``mid_scale`` multiplies between the two solves (used by
    SSOR; identity for IC/ILU).
    """

    def __init__(
        self,
        lower: LevelSchedule,
        upper: LevelSchedule,
        mid_scale: Optional[np.ndarray] = None,
    ):
        self.lower = lower
        self.upper = upper
        self.mid_scale = None if mid_scale is None else jnp.asarray(mid_scale)
        n = lower.n
        self.shape = (n, n)
        self.dtype = lower.ell_vals.dtype

    def mv(self, x):
        y = triangular_solve(self.lower, x)
        if self.mid_scale is not None:
            y = y * self.mid_scale
        return triangular_solve(self.upper, y)


def _tri_flatten(op):
    return (op.lower, op.upper, op.mid_scale), None


def _tri_unflatten(_, children):
    obj = object.__new__(TriangularPreconditioner)
    obj.lower, obj.upper, obj.mid_scale = children
    try:
        n = obj.lower.n
        obj.shape = (n, n)
        obj.dtype = obj.lower.ell_vals.dtype
    except (AttributeError, TypeError):
        obj.shape = None
        obj.dtype = None
    return obj


register_pytree_node(TriangularPreconditioner, _tri_flatten, _tri_unflatten)
