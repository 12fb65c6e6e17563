"""Linear operator protocol — the JAX replacement for liblcg's
callback design.

The reference never materializes ``A`` inside a solver: the user passes a C
function pointer ``lcg_axfunc_ptr`` computing ``Ax`` (``src/lib/lcg.h:37-38``),
and in the complex domain the callback additionally receives a
``(lcg_matrix_e layout, clcg_complex_e conjugate)`` mode pair so a single
callback can serve A, A^T, conj(A) and A^H (``src/lib/clcg.h:40-41``,
``lcg_complex.h:310-327``).

Here that contract becomes a small protocol of four linear maps:

    mv(x)  = A x          rmv(x) = A^T x
    cmv(x) = conj(A) x    hmv(x) = A^H x

Only ``mv`` is required; the other three default to conjugation identities or
to ``jax.linear_transpose`` (matrix-free).  Operators are pytrees, so they
flow through ``jax.jit`` / ``lax.while_loop`` carries and across
``shard_map`` boundaries unchanged.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp
from jax.tree_util import register_pytree_node

from .ops.dia import coo_to_dia, dia_spmv, dia_spmv_transpose
from .ops.spmv import coo_to_ell, dense_mv, ell_spmv


class LinearOperator:
    """Abstract square (or rectangular) linear operator.

    Subclasses must define ``mv`` and the ``shape``/``dtype`` attributes.
    ``rmv`` (transpose), ``cmv`` (elementwise conjugate) and ``hmv``
    (conjugate transpose) have consistent defaults.
    """

    shape: Tuple[int, int]
    dtype: np.dtype

    # -- required -----------------------------------------------------------
    def mv(self, x):
        raise NotImplementedError

    # -- derived ------------------------------------------------------------
    def rmv(self, x):
        """A^T x.  Default: algebraic transpose via jax.linear_transpose."""
        transpose = jax.linear_transpose(
            self.mv, jnp.zeros(self.shape[1], dtype=self.dtype)
        )
        (out,) = transpose(x)
        return out

    def cmv(self, x):
        """conj(A) x = conj(A conj(x))."""
        if not jnp.issubdtype(jnp.dtype(self.dtype), jnp.complexfloating):
            return self.mv(x)
        return jnp.conj(self.mv(jnp.conj(x)))

    def hmv(self, x):
        """A^H x = conj(A^T conj(x))."""
        if not jnp.issubdtype(jnp.dtype(self.dtype), jnp.complexfloating):
            return self.rmv(x)
        return jnp.conj(self.rmv(jnp.conj(x)))

    def diagonal(self):
        """diag(A), used by the Jacobi preconditioner.  Optional."""
        raise NotImplementedError(f"{type(self).__name__} has no diagonal()")

    def astype(self, dtype) -> "LinearOperator":
        """The same operator with its values cast to ``dtype`` — the hook
        :func:`liblcg_tpu.solve_refined` uses to build the low-precision
        inner operator for mixed-precision iterative refinement.  Concrete
        storage classes override this with a cheap leaf cast."""
        raise NotImplementedError(
            f"{type(self).__name__} cannot be cast to another dtype "
            "automatically; construct the operator at the target dtype "
            "(or pass A_low= to solve_refined)"
        )

    # -- sugar --------------------------------------------------------------
    def __matmul__(self, x):
        return self.mv(x)

    @property
    def n(self) -> int:
        return self.shape[1]


class DenseOperator(LinearOperator):
    """Dense matrix operator; products run as matmuls.

    Replaces the reference's OpenMP dense matvec ``lcg_matvec``
    (algebra.cpp:165-193) and the 4-mode complex variant
    (lcg_complex.cpp:169-234).
    """

    def __init__(self, A):
        self.A = jnp.asarray(A)
        self.shape = tuple(self.A.shape)
        self.dtype = self.A.dtype

    def mv(self, x):
        return dense_mv(self.A, x)

    def rmv(self, x):
        return dense_mv(self.A.T, x)

    def cmv(self, x):
        return dense_mv(jnp.conj(self.A), x)

    def hmv(self, x):
        return dense_mv(jnp.conj(self.A.T), x)

    def diagonal(self):
        return jnp.diagonal(self.A)

    def col_sq_norms(self):
        """``diag(A^H A)``: per-column sum of |A_ij|^2."""
        return jnp.sum(jnp.abs(self.A) ** 2, axis=0)

    def astype(self, dtype):
        return DenseOperator(self.A.astype(dtype))


def _dense_flatten(op):
    return (op.A,), None


def _dense_unflatten(_, children):
    obj = object.__new__(DenseOperator)
    obj.A = children[0]
    try:
        obj.shape = tuple(children[0].shape)
        obj.dtype = children[0].dtype
    except AttributeError:  # tracing placeholders
        obj.shape = None
        obj.dtype = None
    return obj


register_pytree_node(DenseOperator, _dense_flatten, _dense_unflatten)


class SparseOperator(LinearOperator):
    """Sparse operator in padded ELL layout (gather-based SpMV).

    Built from COO triplets (the reference's on-disk and in-memory sparse
    format, ``data/README:1-11`` and ``algebra.cpp:195-222``).  Construction
    runs on host in numpy: duplicates are summed, rows are packed to fixed
    width k = max nnz/row, and — unless ``assume_symmetric`` — a second ELL
    image of A^T is prepared so ``rmv``/``hmv`` are also single gathers.
    """

    def __init__(
        self,
        n_rows: int,
        n_cols: int,
        rows,
        cols,
        vals,
        *,
        assume_symmetric: bool = False,
        pad_rows_to: int = 1,
        dtype=None,
    ):
        rows = np.asarray(rows)
        cols = np.asarray(cols)
        vals = np.asarray(vals)
        if dtype is not None:
            vals = vals.astype(dtype)
        self.shape = (n_rows, n_cols)
        self.dtype = jnp.dtype(vals.dtype)
        self.assume_symmetric = bool(assume_symmetric)
        self.n_padded = -(-n_rows // pad_rows_to) * pad_rows_to

        ell_cols, ell_vals = coo_to_ell(n_rows, rows, cols, vals, pad_rows_to)
        self.ell_cols = jnp.asarray(ell_cols)
        self.ell_vals = jnp.asarray(ell_vals)

        if assume_symmetric:
            self.ell_cols_t = self.ell_cols
            self.ell_vals_t = self.ell_vals
        else:
            t_cols, t_vals = coo_to_ell(n_cols, cols, rows, vals, pad_rows_to)
            self.ell_cols_t = jnp.asarray(t_cols)
            self.ell_vals_t = jnp.asarray(t_vals)

        diag_mask = rows == cols
        diag = np.zeros(n_rows, dtype=vals.dtype)
        np.add.at(diag, rows[diag_mask], vals[diag_mask])
        self._diag = jnp.asarray(diag)
        self.nnz = int(len(vals))

    def mv(self, x):
        y = ell_spmv(self.ell_cols, self.ell_vals, x)
        return y[: self.shape[0]] if self.n_padded != self.shape[0] else y

    def rmv(self, x):
        y = ell_spmv(self.ell_cols_t, self.ell_vals_t, x)
        return y[: self.shape[1]] if self.ell_cols_t.shape[0] != self.shape[1] else y

    def cmv(self, x):
        y = ell_spmv(self.ell_cols, jnp.conj(self.ell_vals), x)
        return y[: self.shape[0]] if self.n_padded != self.shape[0] else y

    def hmv(self, x):
        y = ell_spmv(self.ell_cols_t, jnp.conj(self.ell_vals_t), x)
        return y[: self.shape[1]] if self.ell_cols_t.shape[0] != self.shape[1] else y

    def diagonal(self):
        return self._diag

    def col_sq_norms(self):
        """``diag(A^H A)``: per-column sum of |A_ij|^2 (padding entries are
        zero-valued and contribute nothing)."""
        import jax

        v = jnp.abs(self.ell_vals) ** 2
        return jax.ops.segment_sum(
            v.ravel(), self.ell_cols.ravel().astype(jnp.int32),
            num_segments=self.shape[1],
        )

    def astype(self, dtype):
        """Cheap leaf cast: the ELL column maps are dtype-independent."""
        obj = object.__new__(SparseOperator)
        obj.ell_cols = self.ell_cols
        obj.ell_vals = self.ell_vals.astype(dtype)
        obj.ell_cols_t = self.ell_cols_t
        obj.ell_vals_t = (obj.ell_vals if self.assume_symmetric
                          else self.ell_vals_t.astype(dtype))
        obj._diag = self._diag.astype(dtype)
        obj.shape = self.shape
        obj.dtype = jnp.dtype(dtype)
        obj.assume_symmetric = self.assume_symmetric
        obj.n_padded = self.n_padded
        obj.nnz = self.nnz
        return obj

    @classmethod
    def from_dense(cls, A, **kw):
        A = np.asarray(A)
        rows, cols = np.nonzero(A)
        return cls(A.shape[0], A.shape[1], rows, cols, A[rows, cols], **kw)


def _sparse_flatten(op):
    leaves = (
        op.ell_cols,
        op.ell_vals,
        op.ell_cols_t,
        op.ell_vals_t,
        op._diag,
    )
    aux = (op.shape, str(op.dtype), op.assume_symmetric, op.n_padded, op.nnz)
    return leaves, aux


def _sparse_unflatten(aux, children):
    obj = object.__new__(SparseOperator)
    (obj.ell_cols, obj.ell_vals, obj.ell_cols_t, obj.ell_vals_t, obj._diag) = children
    obj.shape, dtype_str, obj.assume_symmetric, obj.n_padded, obj.nnz = aux
    obj.dtype = jnp.dtype(dtype_str)
    return obj


register_pytree_node(SparseOperator, _sparse_flatten, _sparse_unflatten)


class ScatteredOperator(LinearOperator):
    """Diagonal plus a handful of scattered off-diagonal entries.

    The shape of the reference's shipped complex 10K system
    (data/case_10K_cA: 10,000 diagonal entries + 200 scattered
    symmetric couplings over 197 distinct offsets,
    sample6.cpp:162-163).  Neither ELL (one giant gather per product —
    and the realified ELL graph is a pinned remote-compile hang,
    PARITY.md) nor DIA (197 mostly-empty diagonals) fits it; the natural
    product is

        A x = diag * x + scatter_add(rows, vals * x[cols])

    — one elementwise multiply plus a k-element gather/scatter
    (k = #off-diagonals), which compiles instantly and costs ~nothing.
    For an exact direct solve of the same shape see
    :class:`liblcg_tpu.ScatteredDirectSolver` (Woodbury).
    """

    def __init__(self, n: int, rows, cols, vals, *, dtype=None):
        from .solvers.direct import scattered_split

        rows = np.asarray(rows)
        cols = np.asarray(cols)
        vals = np.asarray(vals)
        if dtype is not None:
            vals = vals.astype(dtype)
        diag, orow, ocol, oval = scattered_split(n, rows, cols, vals)
        self.shape = (int(n), int(n))
        self.dtype = jnp.dtype(vals.dtype)
        # Complex values stay HOST-side (numpy): on complex-less
        # accelerator backends even creating a complex device array fails
        # with UNIMPLEMENTED at first materialization, and realify() /
        # solve_realified read host values.
        put = (np.asarray if jnp.issubdtype(self.dtype, jnp.complexfloating)
               else jnp.asarray)
        self.diag = put(diag)
        self.off_rows = jnp.asarray(orow, jnp.int32)
        self.off_cols = jnp.asarray(ocol, jnp.int32)
        self.off_vals = put(oval)
        self.nnz = int(len(vals))

    def mv(self, x):
        return (self.diag * x).at[self.off_rows].add(
            self.off_vals * x[self.off_cols])

    def rmv(self, x):
        return (self.diag * x).at[self.off_cols].add(
            self.off_vals * x[self.off_rows])

    def cmv(self, x):
        if not jnp.issubdtype(self.dtype, jnp.complexfloating):
            return self.mv(x)
        return (jnp.conj(self.diag) * x).at[self.off_rows].add(
            jnp.conj(self.off_vals) * x[self.off_cols])

    def hmv(self, x):
        if not jnp.issubdtype(self.dtype, jnp.complexfloating):
            return self.rmv(x)
        return (jnp.conj(self.diag) * x).at[self.off_cols].add(
            jnp.conj(self.off_vals) * x[self.off_rows])

    def diagonal(self):
        return self.diag

    def col_sq_norms(self):
        v = jnp.abs(self.diag) ** 2
        return v.at[self.off_cols].add(jnp.abs(self.off_vals) ** 2)

    def astype(self, dtype):
        obj = object.__new__(ScatteredOperator)
        obj.diag = self.diag.astype(dtype)
        obj.off_rows = self.off_rows
        obj.off_cols = self.off_cols
        obj.off_vals = self.off_vals.astype(dtype)
        obj.shape = self.shape
        obj.dtype = jnp.dtype(dtype)
        obj.nnz = self.nnz
        return obj


def _scattered_flatten(op):
    return ((op.diag, op.off_rows, op.off_cols, op.off_vals),
            (op.shape, str(op.dtype), op.nnz))


def _scattered_unflatten(aux, children):
    obj = object.__new__(ScatteredOperator)
    obj.diag, obj.off_rows, obj.off_cols, obj.off_vals = children
    obj.shape, dtype_str, obj.nnz = aux
    obj.dtype = jnp.dtype(dtype_str)
    return obj


register_pytree_node(ScatteredOperator, _scattered_flatten,
                     _scattered_unflatten)


class BandedOperator(LinearOperator):
    """Sparse operator in DIA (diagonal) storage — the gather-free form.

    For matrices whose nonzeros live on few diagonals (stencils, banded
    systems — the shipped ``data/case_10K_A`` has 19 diagonals), the product
    is a sum of statically-shifted elementwise multiplies: no index loads,
    no gathers, one fused bandwidth-bound XLA pass.  Prefer this over
    :class:`SparseOperator` whenever ``offsets`` is small; the
    :func:`make_sparse_operator` factory chooses automatically.
    """

    def __init__(self, n_rows: int, n_cols: int, rows, cols, vals, *, dtype=None):
        rows = np.asarray(rows)
        cols = np.asarray(cols)
        vals = np.asarray(vals)
        if dtype is not None:
            vals = vals.astype(dtype)
        self.shape = (n_rows, n_cols)
        self.dtype = jnp.dtype(vals.dtype)
        offsets, diag_vals = coo_to_dia(n_rows, n_cols, rows, cols, vals)
        self.offsets = tuple(int(o) for o in offsets)  # static metadata
        self.diag_vals = jnp.asarray(diag_vals)
        self.nnz = int(len(vals))

    def mv(self, x):
        return dia_spmv(self.offsets, self.diag_vals, x)

    def rmv(self, x):
        return dia_spmv_transpose(self.offsets, self.diag_vals, x, self.shape[1])

    def cmv(self, x):
        return dia_spmv(self.offsets, jnp.conj(self.diag_vals), x)

    def hmv(self, x):
        return dia_spmv_transpose(
            self.offsets, self.diag_vals, x, self.shape[1], conj=True
        )

    def diagonal(self):
        if 0 in self.offsets:
            return self.diag_vals[self.offsets.index(0)]
        return jnp.zeros((self.shape[0],), dtype=self.dtype)

    def col_sq_norms(self):
        """``diag(A^H A)``: per-column sum of |A_ij|^2, as statically
        shifted adds of each squared diagonal (gather-free, like
        :func:`dia_spmv`)."""
        n_rows, n_cols = self.shape
        out = jnp.zeros((n_cols,), jnp.result_type(jnp.abs(self.diag_vals)))
        for d, o in enumerate(self.offsets):
            # diag_vals[d, i] = A[i, i+o] -> contributes to column j = i+o.
            i_lo = max(0, -o)
            i_hi = min(n_rows, n_cols - o)
            if i_hi <= i_lo:
                continue
            v = jnp.abs(self.diag_vals[d, i_lo:i_hi]) ** 2
            out = out.at[i_lo + o : i_hi + o].add(v)
        return out

    def astype(self, dtype):
        """Cheap leaf cast: diagonal offsets are dtype-independent."""
        obj = object.__new__(BandedOperator)
        obj.diag_vals = self.diag_vals.astype(dtype)
        obj.offsets = self.offsets
        obj.shape = self.shape
        obj.dtype = jnp.dtype(dtype)
        obj.nnz = self.nnz
        return obj

    @property
    def n_diagonals(self) -> int:
        return len(self.offsets)


def _banded_flatten(op):
    return (op.diag_vals,), (op.shape, str(op.dtype), op.offsets, op.nnz)


def _banded_unflatten(aux, children):
    obj = object.__new__(BandedOperator)
    (obj.diag_vals,) = children
    obj.shape, dtype_str, obj.offsets, obj.nnz = aux
    obj.dtype = jnp.dtype(dtype_str)
    return obj


register_pytree_node(BandedOperator, _banded_flatten, _banded_unflatten)


def make_sparse_operator(
    n_rows: int,
    n_cols: int,
    rows,
    cols,
    vals,
    *,
    format: str = "auto",
    max_diagonals: int = 96,
    **kw,
) -> LinearOperator:
    """Build the best sparse operator for the given pattern.

    ``format="auto"`` picks, in order:

    - ``ScatteredOperator`` for diagonal-plus-few-couplings patterns
      (full diagonal present; off-diagonals at most 5% of n): the
      diag+scatter product beats both a one-giant-gather ELL and a
      mostly-empty DIA there (the shipped case_10K_cA shape — and the
      form whose realified product is a fused elementwise pass);
    - DIA when the nonzeros occupy at most ``max_diagonals`` distinct
      diagonals *and* DIA storage is not wildly larger than ELL;
    - padded ELL otherwise.

    Explicit: ``format="scattered" | "dia" | "ell"``.
    """
    if format not in ("auto", "dia", "ell", "scattered"):
        raise ValueError(f"unknown sparse format {format!r}")
    if format == "scattered" and n_rows != n_cols:
        raise ValueError(
            f"format='scattered' needs a square matrix (diagonal + "
            f"couplings); got {n_rows}x{n_cols}"
        )
    if format in ("auto", "scattered") and n_rows == n_cols:
        rows_a = np.asarray(rows)
        cols_a = np.asarray(cols)
        n_off = int(np.count_nonzero(rows_a != cols_a))
        diag_full = (len(rows_a) - n_off) >= n_rows
        if format == "scattered" or (diag_full and n_off <= 0.05 * n_rows):
            try:
                return ScatteredOperator(n_rows, rows, cols, vals,
                                         dtype=kw.get("dtype"))
            except ValueError:
                if format == "scattered":
                    raise
                # duplicate-diagonal accounting fooled the heuristic;
                # fall through to DIA/ELL.
    if format in ("auto", "dia"):
        off = np.asarray(cols, dtype=np.int64) - np.asarray(rows, dtype=np.int64)
        n_diags = len(np.unique(off))
        dia_cells = n_diags * n_rows
        if format == "dia" or (
            n_diags <= max_diagonals and dia_cells <= 8 * max(len(np.asarray(vals)), 1)
        ):
            return BandedOperator(n_rows, n_cols, rows, cols, vals,
                                  dtype=kw.get("dtype"))
    return SparseOperator(n_rows, n_cols, rows, cols, vals, **kw)


class MatrixFreeOperator(LinearOperator):
    """Wraps an arbitrary jit-compatible linear callable, the direct analogue
    of passing a bare ``lcg_axfunc_ptr`` (lcg.h:37-38).

    ``rmv`` defaults to the algebraic transpose derived by
    ``jax.linear_transpose`` — the functional-transform answer to the
    reference's requirement that one callback implement all four operator
    modes (clcg.h:40-41).
    """

    def __init__(
        self,
        fun: Callable,
        n: int,
        dtype=jnp.float64,
        *,
        m: Optional[int] = None,
        rmv_fun: Optional[Callable] = None,
        diag=None,
    ):
        self._fun = fun
        self._rmv_fun = rmv_fun
        self.shape = (m if m is not None else n, n)
        self.dtype = jnp.dtype(dtype)
        self._diag_val = None if diag is None else jnp.asarray(diag)

    def mv(self, x):
        return self._fun(x)

    def rmv(self, x):
        if self._rmv_fun is not None:
            return self._rmv_fun(x)
        return super().rmv(x)

    def diagonal(self):
        if self._diag_val is None:
            raise NotImplementedError("matrix-free operator without diag")
        return self._diag_val


def _mf_flatten(op):
    return (op._diag_val,), (op._fun, op._rmv_fun, op.shape, str(op.dtype))


def _mf_unflatten(aux, children):
    obj = object.__new__(MatrixFreeOperator)
    obj._fun, obj._rmv_fun, obj.shape, dtype_str = aux
    obj.dtype = jnp.dtype(dtype_str)
    obj._diag_val = children[0]
    return obj


register_pytree_node(MatrixFreeOperator, _mf_flatten, _mf_unflatten)


class NormalEqOperator(LinearOperator):
    """A^T A as an SPD operator (real) / A^H A (complex).

    The reference's sample1 builds an SPD system via normal equations
    (sample1.cpp:48-52: the callback computes ``A^T (A x)``).  This wrapper
    gives the same two-pass product for any inner operator.
    """

    def __init__(self, inner: LinearOperator):
        self.inner = inner
        n = inner.shape[1]
        self.shape = (n, n)
        self.dtype = inner.dtype

    def mv(self, x):
        if jnp.issubdtype(jnp.dtype(self.dtype), jnp.complexfloating):
            return self.inner.hmv(self.inner.mv(x))
        return self.inner.rmv(self.inner.mv(x))

    def rmv(self, x):
        return self.mv(x)  # symmetric / Hermitian by construction

    def hmv(self, x):
        return self.mv(x)

    def diagonal(self):
        """``diag(A^H A)`` — the per-column squared norms of the inner
        operator, so ``JacobiPreconditioner(NormalEqOperator(A))`` gives
        Jacobi-CGNR out of the box (measured: 200 vs 291 iterations on
        the realified case_1K)."""
        f = getattr(self.inner, "col_sq_norms", None)
        if f is None:
            raise NotImplementedError(
                f"{type(self.inner).__name__} does not expose col_sq_norms; "
                "Jacobi on the normal equations needs explicit storage "
                "(SparseOperator/BandedOperator/DenseOperator)"
            )
        return f()

    def astype(self, dtype):
        return NormalEqOperator(self.inner.astype(dtype))


def _ne_flatten(op):
    return (op.inner,), None


def _ne_unflatten(_, children):
    obj = object.__new__(NormalEqOperator)
    obj.inner = children[0]
    try:
        n = obj.inner.shape[1]
        obj.shape = (n, n)
        obj.dtype = obj.inner.dtype
    except (AttributeError, TypeError):
        obj.shape = None
        obj.dtype = None
    return obj


register_pytree_node(NormalEqOperator, _ne_flatten, _ne_unflatten)


class ScaledOperator(LinearOperator):
    """alpha * A."""

    def __init__(self, alpha, inner: LinearOperator):
        self.alpha = jnp.asarray(alpha)
        self.inner = inner
        self.shape = inner.shape
        self.dtype = jnp.promote_types(self.alpha.dtype, inner.dtype)

    def mv(self, x):
        return self.alpha * self.inner.mv(x)

    def rmv(self, x):
        return self.alpha * self.inner.rmv(x)

    def cmv(self, x):
        return jnp.conj(self.alpha) * self.inner.cmv(x)

    def hmv(self, x):
        return jnp.conj(self.alpha) * self.inner.hmv(x)

    def diagonal(self):
        return self.alpha * self.inner.diagonal()

    def astype(self, dtype):
        dt = jnp.dtype(dtype)
        if (jnp.issubdtype(self.alpha.dtype, jnp.complexfloating)
                and not jnp.issubdtype(dt, jnp.complexfloating)):
            raise ValueError(
                "cannot cast a complex-scaled operator to a real dtype "
                "(dropping the imaginary part would change the operator); "
                "realify the composition instead"
            )
        return ScaledOperator(self.alpha.astype(dtype),
                              self.inner.astype(dtype))


def _scaled_flatten(op):
    return (op.alpha, op.inner), None


def _scaled_unflatten(_, children):
    obj = object.__new__(ScaledOperator)
    obj.alpha, obj.inner = children
    try:
        obj.shape = obj.inner.shape
        obj.dtype = jnp.promote_types(obj.alpha.dtype, obj.inner.dtype)
    except (AttributeError, TypeError):
        obj.shape = None
        obj.dtype = None
    return obj


register_pytree_node(ScaledOperator, _scaled_flatten, _scaled_unflatten)


class SymScaledOperator(LinearOperator):
    """Symmetric diagonal scaling ``S A S`` with ``S = diag(s)``.

    The change of variables behind diagonally preconditioned Krylov
    methods: PCG on ``(A, M=D)`` is CG on ``D^{-1/2} A D^{-1/2}`` (with
    ``x = S x̂``, ``b̂ = S b``) — how ``solve(method="cacg", M=Jacobi)``
    composes Jacobi preconditioning with the s-step engine without a
    preconditioned recurrence.  Two fused elementwise multiplies per
    product; symmetry (and bandedness, sparsity, ...) of the inner
    operator is preserved by construction.
    """

    def __init__(self, s, inner: LinearOperator):
        self.s = jnp.asarray(s)
        self.inner = inner
        self.shape = inner.shape
        self.dtype = jnp.promote_types(self.s.dtype, inner.dtype)

    def mv(self, x):
        return self.s * self.inner.mv(self.s * x)

    def rmv(self, x):
        return self.s * self.inner.rmv(self.s * x)

    def cmv(self, x):
        sc = jnp.conj(self.s)
        return sc * self.inner.cmv(sc * x)

    def hmv(self, x):
        sc = jnp.conj(self.s)
        return sc * self.inner.hmv(sc * x)

    def diagonal(self):
        return self.s * self.inner.diagonal() * self.s

    def astype(self, dtype):
        dt = jnp.dtype(dtype)
        if (jnp.issubdtype(self.s.dtype, jnp.complexfloating)
                and not jnp.issubdtype(dt, jnp.complexfloating)):
            raise ValueError(
                "cannot cast a complex-scaled operator to a real dtype"
            )
        return SymScaledOperator(self.s.astype(dtype),
                                 self.inner.astype(dtype))


def _symscaled_flatten(op):
    return (op.s, op.inner), None


def _symscaled_unflatten(_, children):
    obj = object.__new__(SymScaledOperator)
    obj.s, obj.inner = children
    try:
        obj.shape = obj.inner.shape
        obj.dtype = jnp.promote_types(obj.s.dtype, obj.inner.dtype)
    except (AttributeError, TypeError):
        obj.shape = None
        obj.dtype = None
    return obj


register_pytree_node(SymScaledOperator, _symscaled_flatten,
                     _symscaled_unflatten)


class SumOperator(LinearOperator):
    """A + B."""

    def __init__(self, a: LinearOperator, b: LinearOperator):
        assert a.shape == b.shape, "operator shapes must match"
        self.a, self.b = a, b
        self.shape = a.shape
        self.dtype = jnp.promote_types(a.dtype, b.dtype)

    def mv(self, x):
        return self.a.mv(x) + self.b.mv(x)

    def rmv(self, x):
        return self.a.rmv(x) + self.b.rmv(x)

    def cmv(self, x):
        return self.a.cmv(x) + self.b.cmv(x)

    def hmv(self, x):
        return self.a.hmv(x) + self.b.hmv(x)

    def diagonal(self):
        return self.a.diagonal() + self.b.diagonal()

    def astype(self, dtype):
        return SumOperator(self.a.astype(dtype), self.b.astype(dtype))


def _sum_flatten(op):
    return (op.a, op.b), None


def _sum_unflatten(_, children):
    obj = object.__new__(SumOperator)
    obj.a, obj.b = children
    try:
        obj.shape = obj.a.shape
        obj.dtype = jnp.promote_types(obj.a.dtype, obj.b.dtype)
    except (AttributeError, TypeError):
        obj.shape = None
        obj.dtype = None
    return obj


register_pytree_node(SumOperator, _sum_flatten, _sum_unflatten)


class ProductOperator(LinearOperator):
    """A @ B (applied right-to-left)."""

    def __init__(self, a: LinearOperator, b: LinearOperator):
        assert a.shape[1] == b.shape[0]
        self.a, self.b = a, b
        self.shape = (a.shape[0], b.shape[1])
        self.dtype = jnp.promote_types(a.dtype, b.dtype)

    def mv(self, x):
        return self.a.mv(self.b.mv(x))

    def rmv(self, x):
        return self.b.rmv(self.a.rmv(x))

    def cmv(self, x):
        return self.a.cmv(self.b.cmv(x))

    def hmv(self, x):
        return self.b.hmv(self.a.hmv(x))

    def astype(self, dtype):
        return ProductOperator(self.a.astype(dtype), self.b.astype(dtype))


def _prod_flatten(op):
    return (op.a, op.b), None


def _prod_unflatten(_, children):
    obj = object.__new__(ProductOperator)
    obj.a, obj.b = children
    try:
        obj.shape = (obj.a.shape[0], obj.b.shape[1])
        obj.dtype = jnp.promote_types(obj.a.dtype, obj.b.dtype)
    except (AttributeError, TypeError):
        obj.shape = None
        obj.dtype = None
    return obj


register_pytree_node(ProductOperator, _prod_flatten, _prod_unflatten)


class RealifiedOperator(LinearOperator):
    """Real 2n x 2n block form of a complex operator:

        [[Ar, -Ai], [Ai, Ar]] @ [xr; xi]  ==  split(A @ (xr + i xi))

    Built from the *data* of a concrete complex operator (Dense / ELL /
    DIA), so every product runs in pure real arithmetic — the escape hatch
    for accelerators without complex support.  Solve with CGS (or BiCG): the block form is
    not symmetric even for complex-symmetric A, and its eigenvalues come in
    conjugate pairs, which breaks BiCGSTAB's one-dimensional residual
    smoothing (omega -> 0) — a classic result; CGS has no such stage.  Pack/unpack with :func:`split_complex` /
    :func:`merge_complex`.

    Transpose identity: ``R(A)^T == R(A^H)`` — ``rmv`` is the algebraic
    transpose of the real block (what real BiCG-type methods need), which
    corresponds to the *Hermitian* transpose of the complex operator.
    """

    def __init__(self, A: "LinearOperator"):
        if not jnp.issubdtype(jnp.dtype(A.dtype), jnp.complexfloating):
            raise ValueError("realify expects a complex operator")
        rdt = jnp.float64 if jnp.dtype(A.dtype) == jnp.complex128 else jnp.float32
        if isinstance(A, DenseOperator):
            self.re = DenseOperator(A.A.real.astype(rdt))
            self.im = DenseOperator(A.A.imag.astype(rdt))
        elif isinstance(A, BandedOperator):
            vals = np.asarray(A.diag_vals)
            self.re = object.__new__(BandedOperator)
            self.im = object.__new__(BandedOperator)
            for part, v in ((self.re, vals.real), (self.im, vals.imag)):
                part.shape = A.shape
                part.dtype = jnp.dtype(rdt)
                part.offsets = A.offsets
                part.diag_vals = jnp.asarray(v.astype(rdt))
                part.nnz = A.nnz
        elif isinstance(A, ScatteredOperator):
            # Keep the diag-plus-scatter product shape.  Both parts are
            # built WITHOUT the constructor: its scattered_split validity
            # check (every diagonal nonzero) belongs to the direct
            # solver, not to this product form — a complex matrix with a
            # purely imaginary diagonal entry has a zero REAL diagonal
            # there and the realified product is still well-defined.
            n0 = A.shape[0]
            d = np.asarray(A.diag)
            orow = np.asarray(A.off_rows)
            ocol = np.asarray(A.off_cols)
            oval = np.asarray(A.off_vals)
            for part, dv, ov in ((0, d.real, oval.real),
                                 (1, d.imag, oval.imag)):
                obj = object.__new__(ScatteredOperator)
                obj.shape = (n0, n0)
                obj.dtype = jnp.dtype(rdt)
                obj.diag = jnp.asarray(dv.astype(rdt))
                obj.off_rows = jnp.asarray(orow, jnp.int32)
                obj.off_cols = jnp.asarray(ocol, jnp.int32)
                obj.off_vals = jnp.asarray(ov.astype(rdt))
                obj.nnz = A.nnz
                if part == 0:
                    self.re = obj
                else:
                    self.im = obj
        elif isinstance(A, SparseOperator):
            cols = np.asarray(A.ell_cols)
            vals = np.asarray(A.ell_vals)
            n_rows = cols.shape[0]
            r = np.repeat(np.arange(n_rows), cols.shape[1])
            c = cols.ravel()
            v = vals.ravel()
            keep = v != 0
            self.re = SparseOperator(A.shape[0], A.shape[1], r[keep], c[keep],
                                     v[keep].real.astype(rdt))
            self.im = SparseOperator(A.shape[0], A.shape[1], r[keep], c[keep],
                                     v[keep].imag.astype(rdt))
        else:
            raise TypeError(
                f"realify supports Dense/Sparse/Banded/Scattered operators, "
                f"got {type(A).__name__}"
            )
        n = A.shape[1]
        self._n = n
        self.shape = (2 * A.shape[0], 2 * n)
        self.dtype = jnp.dtype(rdt)

    def _scattered_apply(self, x2, transpose: bool):
        """Fused stacked product for diag+scattered parts: ONE gather and
        ONE scatter over the stacked (2n,) vector instead of 4 each (the
        generic path's 4 sub-products) — gathers/scatters are the
        dominant per-iteration cost of the pair engines."""
        n = self._n
        re, im = self.re, self.im
        xr, xi = x2[:n], x2[n:]
        dr, di = re.diag, im.diag
        if transpose:
            # R(A)^T: [[Ar^T, Ai^T], [-Ai^T, Ar^T]]
            yr = dr * xr + di * xi
            yi = -di * xr + dr * xi
            rows, cols = re.off_cols, re.off_rows
        else:
            yr = dr * xr - di * xi
            yi = di * xr + dr * xi
            rows, cols = re.off_rows, re.off_cols
        vr, vi = re.off_vals, im.off_vals
        k = vr.shape[0]
        g = x2[jnp.concatenate([cols, cols + n])]
        xr_c, xi_c = g[:k], g[k:]
        if transpose:
            adds = jnp.concatenate([vr * xr_c + vi * xi_c,
                                    -vi * xr_c + vr * xi_c])
        else:
            adds = jnp.concatenate([vr * xr_c - vi * xi_c,
                                    vi * xr_c + vr * xi_c])
        idx = jnp.concatenate([rows, rows + n])
        return jnp.concatenate([yr, yi]).at[idx].add(adds)

    def mv(self, x2):
        if isinstance(self.re, ScatteredOperator):
            return self._scattered_apply(x2, transpose=False)
        xr, xi = x2[: self._n], x2[self._n :]
        yr = self.re.mv(xr) - self.im.mv(xi)
        yi = self.im.mv(xr) + self.re.mv(xi)
        return jnp.concatenate([yr, yi])

    def rmv(self, x2):
        if isinstance(self.re, ScatteredOperator):
            return self._scattered_apply(x2, transpose=True)
        xr, xi = x2[: self._n], x2[self._n :]
        yr = self.re.rmv(xr) + self.im.rmv(xi)
        yi = -self.im.rmv(xr) + self.re.rmv(xi)
        return jnp.concatenate([yr, yi])

    def diagonal(self):
        d = self.re.diagonal()
        return jnp.concatenate([d, d])

    def astype(self, dtype):
        if jnp.issubdtype(jnp.dtype(dtype), jnp.complexfloating):
            raise ValueError("a realified operator is real-valued")
        obj = object.__new__(RealifiedOperator)
        obj.re = self.re.astype(dtype)
        obj.im = self.im.astype(dtype)
        obj._n = self._n
        obj.shape = self.shape
        obj.dtype = jnp.dtype(dtype)
        return obj


def _realified_flatten(op):
    return (op.re, op.im), (op._n, op.shape, str(op.dtype))


def _realified_unflatten(aux, children):
    obj = object.__new__(RealifiedOperator)
    obj.re, obj.im = children
    obj._n, obj.shape, dtype_str = aux
    obj.dtype = jnp.dtype(dtype_str)
    return obj


register_pytree_node(RealifiedOperator, _realified_flatten, _realified_unflatten)


def realify(A: "LinearOperator") -> "RealifiedOperator":
    """Real block form of a complex operator (see RealifiedOperator)."""
    return RealifiedOperator(A)


def split_complex(z) -> jnp.ndarray:
    """Pack a complex vector as [real; imag] for a realified solve.

    Host (numpy) inputs split on host — creating a complex DEVICE array
    first would raise UNIMPLEMENTED on complex-less backends;
    only the real-valued stacked result goes to the device.
    """
    if not isinstance(z, jnp.ndarray):
        z = np.asarray(z)
        return jnp.asarray(np.concatenate([z.real, z.imag]))
    return jnp.concatenate([jnp.real(z), jnp.imag(z)])


def merge_complex(x2) -> np.ndarray:
    """Unpack a realified solution back into a complex vector.  Runs on
    host numpy — complex dtypes may not exist on the solve's backend."""
    x2 = np.asarray(x2)
    n = x2.shape[0] // 2
    return x2[:n] + 1j * x2[n:]


def aslinearoperator(A, **kw) -> LinearOperator:
    """Coerce an array / callable / operator into a LinearOperator."""
    if isinstance(A, LinearOperator):
        return A
    if callable(A):
        if "n" not in kw:
            raise ValueError("matrix-free operator requires n=")
        return MatrixFreeOperator(A, **kw)
    arr = np.asarray(A)
    if arr.ndim != 2:
        raise ValueError(f"expected 2-D array, got shape {arr.shape}")
    return DenseOperator(arr)


def set2box(low, hig, a, low_bound: bool = True, hig_bound: bool = True):
    """Box projection with optional exclusive bounds.

    Reference: ``lcg_set2box`` (algebra.cpp:50-58; inclusive defaults
    declared algebra.h:92-93).  Inclusive bounds clamp to ``[low, hig]``.
    An exclusive bound maps values at-or-beyond it just *inside* instead:
    ``a >= hig -> hig - 1e-16`` and ``a <= low -> low + 1e-16``.  The exact
    piecewise semantics are reproduced — a value already strictly inside
    ``(hig - 1e-16, hig)`` passes through unchanged, so the exclusive mode
    is *not* the same as clipping to the shrunken interval — and the upper
    test wins when the bounds cross, matching the reference's early return.
    """
    a = jnp.asarray(a)
    low = jnp.asarray(low, dtype=a.dtype)
    hig = jnp.asarray(hig, dtype=a.dtype)
    hig_val = hig if hig_bound else hig - 1e-16
    low_val = low if low_bound else low + 1e-16
    return jnp.where(a >= hig, hig_val, jnp.where(a <= low, low_val, a))


def realify_coo(rows, cols, vals):
    """Interleaved real 2n-form of a complex COO matrix (host-side).

    Each complex entry ``a + bi`` at (i, j) becomes the 2x2 block
    ``[[a, -b], [b, a]]`` at rows (2i, 2i+1), cols (2j, 2j+1).  Unlike the
    ``[Re; Im]``-stacked block layout of :class:`RealifiedOperator` (whose
    off-diagonal blocks sit at offset n), the interleaving PRESERVES
    BANDEDNESS: a diagonal at offset d maps to offsets {2d-1, 2d, 2d+1},
    so banded complex systems keep a gather-free DIA form — the
    complex-on-real-backend fast path (the capability matched:
    clcg_cuda.cu's complex-on-accelerator stack).  Returns (rows2, cols2,
    vals2) with exact zeros dropped; feed to make_sparse_operator /
    ShardedBandedOperator with n = 2 * n_complex.

    Pack/unpack vectors with :func:`split_complex_interleaved` /
    :func:`merge_complex_interleaved`.
    """
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals)
    re = np.ascontiguousarray(vals.real)
    im = np.ascontiguousarray(vals.imag)
    r2 = np.concatenate([2 * rows, 2 * rows, 2 * rows + 1, 2 * rows + 1])
    c2 = np.concatenate([2 * cols, 2 * cols + 1, 2 * cols, 2 * cols + 1])
    v2 = np.concatenate([re, -im, im, re])
    keep = v2 != 0
    return r2[keep], c2[keep], v2[keep]


def split_complex_interleaved(z) -> np.ndarray:
    """Pack a complex vector as [re0, im0, re1, im1, ...] (host numpy) for
    a solve against the :func:`realify_coo` form."""
    z = np.asarray(z)
    out = np.empty(2 * z.shape[0], dtype=z.real.dtype)
    out[0::2] = z.real
    out[1::2] = z.imag
    return out


def merge_complex_interleaved(x2) -> np.ndarray:
    """Unpack an interleaved realified solution back into complex (host
    numpy — complex dtypes may not exist on the solve's backend)."""
    x2 = np.asarray(x2)
    return x2[0::2] + 1j * x2[1::2]
