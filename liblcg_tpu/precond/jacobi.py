"""Jacobi (diagonal) and SSOR preconditioners.

The reference builds Jacobi preconditioners in user code: ``p = 1/diag``
(sample1.cpp:98-107, sample6.cpp:151-158) or on-GPU diagonal extraction plus
element-wise divide (sample10.cu:193 with ``clcg_vecDvecZ_element_wise``,
lcg_complex_cuda.cu:65-103).  Here they are first-class device operators.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax.tree_util import register_pytree_node

from ..operators import LinearOperator


class JacobiPreconditioner(LinearOperator):
    """M^{-1} x = x / diag(A).  Accepts an operator (its ``diagonal()`` is
    taken) or the diagonal itself as a 1-D array."""

    def __init__(self, diag_or_operator):
        # NOTE: arrays also expose .diagonal(), so dispatch on the operator
        # type, not the attribute.
        if isinstance(diag_or_operator, LinearOperator):
            diag = diag_or_operator.diagonal()
        else:
            diag = jnp.asarray(diag_or_operator)
            if diag.ndim != 1:
                raise ValueError(
                    "JacobiPreconditioner expects an operator or a 1-D diagonal"
                )
        self.inv_diag = 1.0 / diag
        n = self.inv_diag.shape[0]
        self.shape = (n, n)
        self.dtype = self.inv_diag.dtype

    def mv(self, x):
        return self.inv_diag * x

    def rmv(self, x):
        return self.mv(x)

    def cmv(self, x):
        return jnp.conj(self.inv_diag) * x

    def hmv(self, x):
        return self.cmv(x)

    def diagonal(self):
        return self.inv_diag

    def astype(self, dtype):
        obj = object.__new__(JacobiPreconditioner)
        obj.inv_diag = self.inv_diag.astype(dtype)
        obj.shape = self.shape
        obj.dtype = obj.inv_diag.dtype
        return obj


def _jac_flatten(op):
    return (op.inv_diag,), None


def _jac_unflatten(_, children):
    obj = object.__new__(JacobiPreconditioner)
    (obj.inv_diag,) = children
    try:
        n = obj.inv_diag.shape[0]
        obj.shape = (n, n)
        obj.dtype = obj.inv_diag.dtype
    except (AttributeError, TypeError):
        obj.shape = None
        obj.dtype = None
    return obj


register_pytree_node(JacobiPreconditioner, _jac_flatten, _jac_unflatten)


class ChebyshevPreconditioner(LinearOperator):
    """Polynomial preconditioner: M^{-1} ~= p_d(A) by ``degree`` steps of
    Chebyshev iteration on [lmin, lmax].

    An addition with no reference counterpart: applying M^{-1} costs
    ``degree`` extra operator products but ZERO inner products, so PCG with
    this preconditioner performs its global reductions ~(degree+1)x less
    often per unit of operator work — exactly the trade that wins when
    reductions are the latency bottleneck (single device) or become
    collective psums (mesh).  Bounds default to Gershgorin circles.
    """

    def __init__(self, A, degree: int = 4, lmin=None, lmax=None):
        from ..ops.spectra import gershgorin_bounds

        if lmin is None or lmax is None:
            glo, ghi = gershgorin_bounds(A)
            lmin = glo if lmin is None else lmin
            lmax = ghi if lmax is None else lmax
        lmin, lmax = float(lmin), float(lmax)
        if lmin <= 0.0:
            lmin = 1e-2 * max(lmax, 1.0)  # keep the polynomial contractive
        self._A = A
        self.degree = int(degree)
        self.lmin = lmin
        self.lmax = lmax
        self.shape = A.shape
        self.dtype = A.dtype

    def mv(self, r):
        theta = (self.lmax + self.lmin) / 2.0
        delta = (self.lmax - self.lmin) / 2.0
        sigma1 = theta / delta
        rho = 1.0 / sigma1
        # Chebyshev iteration on A z = r from z0 = 0 (Saad alg 12.1),
        # unrolled `degree` times — pure products and axpys.
        z = jnp.zeros_like(r)
        res = r
        d = res / theta
        for _ in range(self.degree):
            z = z + d
            res = res - self._A.mv(d)
            rho1 = 1.0 / (2.0 * sigma1 - rho)
            d = rho1 * rho * d + (2.0 * rho1 / delta) * res
            rho = rho1
        return z + d

    def rmv(self, x):
        return self.mv(x)  # polynomial in a symmetric operator

    def hmv(self, x):
        return self.mv(x)


def _cheb_flatten(op):
    return (op._A,), (op.degree, op.lmin, op.lmax)


def _cheb_unflatten(aux, children):
    obj = object.__new__(ChebyshevPreconditioner)
    (obj._A,) = children
    obj.degree, obj.lmin, obj.lmax = aux
    try:
        obj.shape = obj._A.shape
        obj.dtype = obj._A.dtype
    except (AttributeError, TypeError):
        obj.shape = None
        obj.dtype = None
    return obj


register_pytree_node(ChebyshevPreconditioner, _cheb_flatten, _cheb_unflatten)


class SSORPreconditioner(LinearOperator):
    """Symmetric SOR preconditioner M = (D/w + L) (w/(2-w)) D^{-1} (D/w + U).

    No direct reference counterpart (liblcg ships Jacobi/IC/ILU); included
    because SSOR needs only the triangular parts the sparse operator already
    stores, and it is the standard middle ground between Jacobi and IC on
    hardware where the IC factorization itself is host-side work.  Built
    from a ``SparseOperator`` via :func:`from_sparse`.
    """

    def __init__(self, tri_solver, omega: float = 1.0):
        # tri_solver: TriangularPreconditioner-like with lower/upper solves.
        self._tri = tri_solver
        self.omega = omega
        self.shape = tri_solver.shape
        self.dtype = tri_solver.dtype

    def mv(self, x):
        return self._tri.mv(x)

    @classmethod
    def from_sparse(cls, op, omega: float = 1.0):
        import numpy as np

        from .incomplete import _coo_from_operator
        from .triangular import TriangularPreconditioner, level_schedule

        n, rows, cols, vals = _coo_from_operator(op)
        diag = np.zeros(n, dtype=vals.dtype)
        dm = rows == cols
        np.add.at(diag, rows[dm], vals[dm])
        scale = (2.0 - omega) / omega
        # M^{-1} = scale * (D/w + U)^{-1} D (D/w + L)^{-1}
        lower_mask = rows >= cols
        lrows, lcols = rows[lower_mask], cols[lower_mask]
        lvals = vals[lower_mask].copy()
        ldm = lrows == lcols
        lvals[ldm] = diag[lrows[ldm]] / omega
        urows, ucols = lcols, lrows  # symmetric A: upper = lower^T
        uvals = lvals
        lower = level_schedule(n, lrows, lcols, lvals, lower=True)
        upper = level_schedule(n, urows, ucols, uvals, lower=False)
        tri = TriangularPreconditioner(
            lower, upper, mid_scale=np.asarray(diag) * scale
        )
        return cls(tri, omega)


def _ssor_flatten(op):
    return (op._tri,), (op.omega,)


def _ssor_unflatten(aux, children):
    obj = object.__new__(SSORPreconditioner)
    (obj._tri,) = children
    (obj.omega,) = aux
    try:
        obj.shape = obj._tri.shape
        obj.dtype = obj._tri.dtype
    except (AttributeError, TypeError):
        obj.shape = None
        obj.dtype = None
    return obj


register_pytree_node(SSORPreconditioner, _ssor_flatten, _ssor_unflatten)
