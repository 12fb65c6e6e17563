"""Row-partitioned sparse operator for SPMD solves.

The solver-world analogue of tensor/data parallelism (SURVEY §2.9): the
matrix rows are block-partitioned over the 1-D solver mesh, every solve
vector is carried as the matching local shard, and the per-iteration
communication is

- ``mv`` (the hot op, 1-2 per iteration):
  * ``comm="allgather"`` — gather the full x, then one local
    ELL gather-multiply-reduce.  Correct for any sparsity pattern.
  * ``comm="halo"`` — exchange only the boundary slices each neighbor
    needs via two ``lax.ppermute`` hops, then compute on the extended
    local window.  Valid when the matrix bandwidth fits one block
    (checked at construction); this is the banded/stencil fast path whose
    communication volume is O(halo) instead of O(n).
- ``rmv``/``hmv`` (only used by complex BiCG/PBiCG): local transpose
  contributions scatter-added into a full-length vector, one ``psum``,
  then the local slice.  Costlier than ``mv`` by design — the reference's
  BiCG also pays a second full product for A^H (clcg.cpp:188).

Construction is host-side numpy (once), mirroring where the reference does
its COO sorting and CSR conversion on host (lcg_complex_cuda.cu:267,
sample8.cu:142-173).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.tree_util import register_pytree_node

from ..operators import LinearOperator
from ..ops.dia import coo_to_dia
from ..ops.spmv import coo_to_ell, ell_spmv


class ShardedSparseOperator(LinearOperator):
    """Sparse operator row-partitioned into ``n_devices`` equal blocks.

    Outside ``shard_map`` the leaves are global ``(n_padded, k)`` arrays;
    inside the solve they are the local ``(n_local, k)`` shards and ``mv``
    consumes/produces local ``(n_local,)`` vectors.  ``axis_name`` is the
    mesh axis the operator communicates over.
    """

    #: Logical (unpadded) system size; shadows the base-class property so the
    #: instance attribute can report the user's N rather than n_padded.
    n = None

    def __init__(
        self,
        n: int,
        rows,
        cols,
        vals,
        *,
        n_devices: int,
        axis_name: str = "rows",
        comm: str = "auto",
        dtype=None,
    ):
        if comm not in ("auto", "allgather", "halo"):
            raise ValueError(f"unknown comm strategy {comm!r}")
        rows = np.asarray(rows)
        cols = np.asarray(cols)
        vals = np.asarray(vals)
        if dtype is not None:
            vals = vals.astype(dtype)

        self.n = int(n)
        self.n_devices = int(n_devices)
        self.axis_name = axis_name
        n_local = -(-n // n_devices)
        self.n_local = n_local
        self.n_padded = n_local * n_devices
        self.shape = (self.n_padded, self.n_padded)
        self.dtype = jnp.dtype(vals.dtype)
        self.nnz = int(len(vals))

        ell_cols, ell_vals = coo_to_ell(self.n_padded, rows, cols, vals, 1)

        # Decide halo feasibility: every block's column footprint must lie
        # within [block_start - n_local, block_end + n_local).
        block_of = rows // n_local
        lo = cols - block_of * n_local          # col offset from block start
        hi = lo - (n_local - 1)                 # offset past block end
        h_l = int(max(0, -(lo.min() if len(lo) else 0)))
        h_r = int(max(0, (hi.max() if len(hi) else 0)))
        halo_ok = h_l <= n_local and h_r <= n_local and n_devices > 1
        if comm == "halo" and not halo_ok:
            raise ValueError(
                f"halo comm infeasible: bandwidth needs halo ({h_l},{h_r}) "
                f"but block size is {n_local}"
            )
        self.comm = (
            "halo" if (comm == "halo" or (comm == "auto" and halo_ok)) else "allgather"
        )
        if n_devices == 1:
            self.comm = "allgather"  # degenerates to a plain local gather

        if self.comm == "halo":
            self.halo = (h_l, h_r)
            # Remap columns into the extended local frame
            # [block_start - h_l, block_end + h_r):  local = col - start + h_l.
            starts = (np.arange(self.n_padded) // n_local * n_local)[:, None]
            local_cols = ell_cols.astype(np.int64) - starts + h_l
            # Padding entries (val == 0) may map out of range; park them at 0.
            local_cols = np.where(ell_vals != 0, local_cols, 0)
            n_ext = n_local + h_l + h_r
            if len(rows):
                assert local_cols.min() >= 0 and local_cols.max() < n_ext
            self.ell_cols = jnp.asarray(local_cols.astype(np.int32))
        else:
            self.halo = (0, 0)
            self.ell_cols = jnp.asarray(ell_cols)
        self.ell_vals = jnp.asarray(ell_vals)
        self._build_transpose_plan(ell_cols, ell_vals)

        diag = np.ones(self.n_padded, dtype=vals.dtype)  # 1 on padding rows
        diag[:n] = 0
        dm = rows == cols
        np.add.at(diag, rows[dm], vals[dm])
        self._diag = jnp.asarray(diag)

    def _build_transpose_plan(self, ell_cols, ell_vals):
        """Column-block plan for the general-pattern transpose: bound the
        rmv/hmv accumulation buffer to O(|R| * n_local) instead of the full
        O(N) image (the 100M-row BiCG target would otherwise
        materialize ~800 MB per device before the reduce-scatter).

        Host-side, per ELL entry: the *relative* destination block
        ``r = col_block - row_block`` and a combined segment id
        ``index(r) * n_local + col_local``.  Device-side the transpose is
        ONE segment_sum into a ``(|R|, n_local)`` buffer plus one
        ``ppermute`` per nonzero r — SPMD-uniform because the offset list
        R is a static union over all devices.  Dense coupling
        (``|R| >= n_devices``) keeps the reduce-scatter, which is exactly
        the all-offsets case done in one fused collective.
        """
        self._tr_offsets = None
        self.tr_segs = None
        if self.comm == "halo" or self.n_devices <= 1:
            return
        n_local = self.n_local
        real = ell_vals != 0
        row_block = (np.arange(self.n_padded) // n_local)[:, None]
        col_block = ell_cols.astype(np.int64) // n_local
        rel = col_block - row_block
        offsets = np.unique(rel[real])
        if len(offsets) == 0 or len(offsets) >= self.n_devices:
            return
        idx_of = {int(r): i for i, r in enumerate(offsets)}
        rel_idx = np.zeros_like(rel)
        for r, i in idx_of.items():
            rel_idx[rel == r] = i
        col_local = ell_cols.astype(np.int64) - col_block * n_local
        segs = rel_idx * n_local + col_local
        segs = np.where(real, segs, 0)     # padding entries park at 0
        self._tr_offsets = tuple(int(r) for r in offsets)
        self.tr_segs = jnp.asarray(segs.astype(np.int32))

    # -- SPMD products (call inside shard_map; arrays are local shards) ------

    def _gather_x(self, x):
        """The communication step: extended/full source vector for the local
        ELL product."""
        ax = self.axis_name
        if self.comm == "halo":
            h_l, h_r = self.halo
            D = self.n_devices
            parts = []
            if h_l:
                # Receive the left neighbor's trailing h_l entries.
                left = lax.ppermute(
                    x[-h_l:], ax, perm=[(i, (i + 1) % D) for i in range(D)]
                )
                parts.append(left)
            parts.append(x)
            if h_r:
                # Receive the right neighbor's leading h_r entries.
                right = lax.ppermute(
                    x[:h_r], ax, perm=[(i, (i - 1) % D) for i in range(D)]
                )
                parts.append(right)
            return jnp.concatenate(parts) if len(parts) > 1 else x
        return lax.all_gather(x, ax, tiled=True)

    def mv(self, x):
        return ell_spmv(self.ell_cols, self.ell_vals, self._gather_x(x))

    def cmv(self, x):
        return ell_spmv(self.ell_cols, jnp.conj(self.ell_vals), self._gather_x(x))

    def _transpose_apply(self, x, conj: bool):
        """(A^T x) / (A^H x) with owner-targeted accumulation.

        halo comm: every local entry (row i, col j) has j inside the
        extended window [start - h_l, start + n_local + h_r), so the
        transpose contribution A[i,j] * x[i] lands either in the local
        block or in a neighbor's edge slice.  Accumulate into the extended
        window (O(n_local) memory), then ship each edge slice to its owner
        with one ``ppermute`` hop — communication O(halo), the mirror image
        of ``_gather_x``.  The reference's A^H product (clcg.cpp:188) done
        distributedly without any full-length vector.

        allgather comm (general patterns): when the column-block plan is
        available (|R| distinct block offsets < n_devices), accumulate ONE
        ``(|R|, n_local)`` buffer and ``ppermute`` each per-neighbor slice
        to its owner — peak local memory O(|R| * n_local), never the full
        image.  Genuinely dense coupling falls back to the full-image
        ``psum_scatter`` (reduce-scatter), which IS the all-offsets case
        in one fused collective.
        """
        ax = self.axis_name
        vals = jnp.conj(self.ell_vals) if conj else self.ell_vals
        contrib = (vals * x[:, None]).ravel()
        segs = self.ell_cols.ravel()
        if self.comm == "halo":
            h_l, h_r = self.halo
            n_ext = h_l + self.n_local + h_r
            ext = jax.ops.segment_sum(contrib, segs, num_segments=n_ext)
            y = ext[h_l : h_l + self.n_local]
            D = self.n_devices
            if h_l:
                # Bins [0, h_l) are the left neighbor's trailing rows; the
                # right neighbor's same bins are our trailing rows.
                from_right = lax.ppermute(
                    ext[:h_l], ax, perm=[(i + 1, i) for i in range(D - 1)]
                )
                y = y.at[self.n_local - h_l :].add(from_right)
            if h_r:
                # Bins [h_l + n_local, n_ext) are the right neighbor's
                # leading rows; received from the left neighbor they are
                # our leading rows.
                from_left = lax.ppermute(
                    ext[h_l + self.n_local :], ax,
                    perm=[(i, i + 1) for i in range(D - 1)],
                )
                y = y.at[:h_r].add(from_left)
            return y
        if self._tr_offsets is not None:
            D = self.n_devices
            nl = self.n_local
            parts = jax.ops.segment_sum(
                contrib, self.tr_segs.ravel(),
                num_segments=len(self._tr_offsets) * nl,
            ).reshape(len(self._tr_offsets), nl)
            y = jnp.zeros((nl,), parts.dtype)
            for i, r in enumerate(self._tr_offsets):
                if r == 0:
                    y = y + parts[i]
                else:
                    y = y + lax.ppermute(
                        parts[i], ax, perm=[(d, (d + r) % D) for d in range(D)]
                    )
            return y
        full = jax.ops.segment_sum(contrib, segs, num_segments=self.n_padded)
        if self.n_devices == 1:
            return full
        return lax.psum_scatter(full, ax, scatter_dimension=0, tiled=True)

    def rmv(self, x):
        return self._transpose_apply(x, conj=False)

    def hmv(self, x):
        return self._transpose_apply(x, conj=True)

    def diagonal(self):
        return self._diag

    def astype(self, dtype):
        """Same partitioning/plan, values cast — the sharded low-precision
        operator for :func:`liblcg_tpu.solve_refined_sharded`."""
        obj = object.__new__(ShardedSparseOperator)
        obj.__dict__.update(self.__dict__)
        obj.ell_vals = self.ell_vals.astype(dtype)
        obj._diag = self._diag.astype(dtype)
        obj.dtype = jnp.dtype(dtype)
        return obj

    @classmethod
    def from_system(cls, system, *, n_devices: int, **kw):
        """Build from a :class:`liblcg_tpu.utils.io.LinearSystem`."""
        return cls(
            system.n, system.rows, system.cols, system.vals,
            n_devices=n_devices, **kw,
        )


class ShardedBandedOperator(LinearOperator):
    """Row-partitioned DIA (diagonal-storage) operator — the gather-free
    sharded form for banded matrices and stencil discretizations.

    Per product: two one-hop ``ppermute`` halo slices of x (halo width =
    matrix bandwidth, checked <= block size at construction) and a sum of
    static slices of the extended local window — no index loads, no
    gathers, communication O(bandwidth) per neighbor.  Values are stored
    transposed, ``(n_padded, n_diags)``, so the leading axis row-shards.
    """

    n = None  # shadow the base-class property (logical size attribute)

    def __init__(
        self,
        n: int,
        rows,
        cols,
        vals,
        *,
        n_devices: int,
        axis_name: str = "rows",
        dtype=None,
    ):
        rows = np.asarray(rows)
        cols = np.asarray(cols)
        vals = np.asarray(vals)
        if dtype is not None:
            vals = vals.astype(dtype)
        self.n = int(n)
        self.n_devices = int(n_devices)
        self.axis_name = axis_name
        n_local = -(-n // n_devices)
        self.n_local = n_local
        self.n_padded = n_local * n_devices
        self.shape = (self.n_padded, self.n_padded)
        self.dtype = jnp.dtype(vals.dtype)
        self.nnz = int(len(vals))

        offsets, diag_vals = coo_to_dia(self.n_padded, self.n_padded,
                                        rows, cols, vals)
        self.offsets = tuple(int(o) for o in offsets)
        h_l = max(0, -min(self.offsets, default=0))
        h_r = max(0, max(self.offsets, default=0))
        if h_l > n_local or h_r > n_local:
            raise ValueError(
                f"bandwidth ({h_l},{h_r}) exceeds the block size {n_local}; "
                "use ShardedSparseOperator for wide patterns"
            )
        self.halo = (h_l, h_r)
        dv = diag_vals.T.copy()              # (n_padded, n_diags)
        # Unit diagonal on padding rows keeps Jacobi preconditioners finite
        # (padding x/b are zero, so the rows never influence the solve).
        # A zero-offset diagonal is materialized if the matrix stores none —
        # otherwise diagonal() would return zeros on padding rows and a
        # Jacobi built from it would divide by zero.
        if self.n_padded > n:
            if 0 not in self.offsets:
                dv = np.concatenate(
                    [dv, np.zeros((self.n_padded, 1), dtype=dv.dtype)], axis=1
                )
                self.offsets = self.offsets + (0,)
            dv[n:, self.offsets.index(0)] = 1.0
        self.dia_vals = jnp.asarray(dv)

    def _exchange(self, x, h_l, h_r):
        """Extended local window [left-halo | x | right-halo]; edge devices
        receive zeros (out-of-range diagonal values are zero anyway)."""
        ax = self.axis_name
        D = self.n_devices
        parts = []
        if h_l:
            parts.append(
                lax.ppermute(x[-h_l:], ax, perm=[(i, i + 1) for i in range(D - 1)])
            )
        parts.append(x)
        if h_r:
            parts.append(
                lax.ppermute(x[:h_r], ax, perm=[(i + 1, i) for i in range(D - 1)])
            )
        return jnp.concatenate(parts) if len(parts) > 1 else x

    def _apply_window(self, x_ext, vals=None):
        """DIA product against an ALREADY-exchanged extended window —
        lets callers that need several products of the same source
        (e.g. the realified complex product's four real sub-products,
        parallel/realified.py) pay the halo exchange once."""
        h_l, h_r = self.halo
        n_local = x_ext.shape[0] - h_l - h_r
        if vals is None:
            vals = self.dia_vals
        y = None
        for d, o in enumerate(self.offsets):
            term = vals[:, d] * x_ext[h_l + o : h_l + o + n_local]
            y = term if y is None else y + term
        return y if y is not None else jnp.zeros((n_local,), self.dtype)

    def _interior_mv(self, x, vals=None):
        """Rows [h_l, n_local - h_r): their diagonal reads stay inside the
        local shard, so this product takes ONLY ``x`` — no halo data, by
        construction (the function has no collective in its trace).  The
        structural half of SURVEY §2.9's 'halo exchange overlapped with
        local SpMV': XLA's latency-hiding scheduler can run this between
        the ppermute start/done pair."""
        h_l, h_r = self.halo
        if vals is None:
            vals = self.dia_vals
        nl = x.shape[0]
        m = nl - h_l - h_r
        y = None
        for d, o in enumerate(self.offsets):
            term = vals[h_l:nl - h_r, d] * x[h_l + o : nl - h_r + o]
            y = term if y is None else y + term
        return y if y is not None else jnp.zeros((m,), self.dtype)

    def _boundary_mv(self, x, left, right, vals=None):
        """The h_l top rows and h_r bottom rows — the only rows whose
        product reads the exchanged halo slices."""
        h_l, h_r = self.halo
        if vals is None:
            vals = self.dia_vals
        nl = x.shape[0]
        y_top = y_bot = None
        if h_l:
            w_top = jnp.concatenate([left, x[:h_l + h_r]])
            for d, o in enumerate(self.offsets):
                term = vals[:h_l, d] * w_top[h_l + o : h_l + o + h_l]
                y_top = term if y_top is None else y_top + term
        if h_r:
            w_bot = jnp.concatenate([x[nl - h_r - h_l:], right])
            for d, o in enumerate(self.offsets):
                term = vals[nl - h_r:, d] * w_bot[h_l + o : h_l + o + h_r]
                y_bot = term if y_bot is None else y_bot + term
        return y_top, y_bot

    def _apply(self, vals, x):
        h_l, h_r = self.halo
        nl = x.shape[0]
        if (h_l == 0 and h_r == 0) or nl - h_l - h_r <= 0:
            # No halo, or shard too small for an interior: combined path.
            return self._apply_window(self._exchange(x, h_l, h_r), vals)
        # Interior/boundary split: the ppermutes depend only on x's edge
        # slices and ONLY the h-sized boundary rows depend on their
        # results — the interior product is collective-free, so the
        # exchange and the bulk compute are schedulable concurrently.
        # Per-row arithmetic (offset order) is unchanged -> bit-identical
        # to the combined path.
        ax = self.axis_name
        D = self.n_devices
        left = (lax.ppermute(x[-h_l:], ax,
                             perm=[(i, i + 1) for i in range(D - 1)])
                if h_l else None)
        right = (lax.ppermute(x[:h_r], ax,
                              perm=[(i + 1, i) for i in range(D - 1)])
                 if h_r else None)
        y_int = self._interior_mv(x, vals)
        y_top, y_bot = self._boundary_mv(x, left, right, vals)
        parts = [p for p in (y_top, y_int, y_bot) if p is not None]
        return jnp.concatenate(parts) if len(parts) > 1 else parts[0]

    def mv(self, x):
        return self._apply(self.dia_vals, x)

    def cmv(self, x):
        return self._apply(jnp.conj(self.dia_vals), x)

    def _transpose_apply(self, x, conj: bool):
        # (A^T x)[j] = sum_d v_d[j - o] x[j - o]: form P = vals * x once,
        # halo-exchange the whole (rows, n_diags) block with the *swapped*
        # halo widths, then shift each column by -o.
        h_l, h_r = self.halo
        vals = jnp.conj(self.dia_vals) if conj else self.dia_vals
        n_local = x.shape[0]
        P = vals * x[:, None]
        P_ext = self._exchange(P, h_r, h_l)
        y = None
        for d, o in enumerate(self.offsets):
            term = P_ext[h_r - o : h_r - o + n_local, d]
            y = term if y is None else y + term
        return y if y is not None else jnp.zeros_like(x)

    def rmv(self, x):
        return self._transpose_apply(x, conj=False)

    def hmv(self, x):
        return self._transpose_apply(x, conj=True)

    def diagonal(self):
        if 0 in self.offsets:
            return self.dia_vals[:, self.offsets.index(0)]
        return jnp.zeros((self.n_padded,), dtype=self.dtype)

    def astype(self, dtype):
        obj = object.__new__(ShardedBandedOperator)
        obj.__dict__.update(self.__dict__)
        obj.dia_vals = self.dia_vals.astype(dtype)
        obj.dtype = jnp.dtype(dtype)
        return obj

    @classmethod
    def from_system(cls, system, *, n_devices: int, **kw):
        return cls(system.n, system.rows, system.cols, system.vals,
                   n_devices=n_devices, **kw)


def _sharded_banded_flatten(op):
    return (op.dia_vals,), (
        op.n, op.n_devices, op.axis_name, op.offsets, op.halo,
        op.n_local, op.n_padded, op.shape, str(op.dtype), op.nnz,
    )


def _sharded_banded_unflatten(aux, children):
    obj = object.__new__(ShardedBandedOperator)
    (obj.dia_vals,) = children
    (obj.n, obj.n_devices, obj.axis_name, obj.offsets, obj.halo,
     obj.n_local, obj.n_padded, obj.shape, dtype_str, obj.nnz) = aux
    obj.dtype = jnp.dtype(dtype_str)
    return obj


register_pytree_node(
    ShardedBandedOperator, _sharded_banded_flatten, _sharded_banded_unflatten
)


def _sharded_flatten(op):
    leaves = (op.ell_cols, op.ell_vals, op._diag, op.tr_segs)
    aux = (
        op.n, op.n_devices, op.axis_name, op.comm, op.halo,
        op.n_local, op.n_padded, op.shape, str(op.dtype), op.nnz,
        op._tr_offsets,
    )
    return leaves, aux


def _sharded_unflatten(aux, children):
    obj = object.__new__(ShardedSparseOperator)
    obj.ell_cols, obj.ell_vals, obj._diag, obj.tr_segs = children
    (obj.n, obj.n_devices, obj.axis_name, obj.comm, obj.halo,
     obj.n_local, obj.n_padded, obj.shape, dtype_str, obj.nnz,
     obj._tr_offsets) = aux
    obj.dtype = jnp.dtype(dtype_str)
    return obj


register_pytree_node(ShardedSparseOperator, _sharded_flatten, _sharded_unflatten)
