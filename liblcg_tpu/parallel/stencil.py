"""Matrix-free 3-D 7-point Laplacian operators (single-device and sharded).

The weak-scaling workload from BASELINE.md ("synthetic 100M-row 3D 7-point
Laplacian CSR, row-partitioned") — except that the idiomatic XLA form of
a stencil operator is not a sparse gather at all: it is a fused
pad/shift/add over a dense 3-D grid, which XLA vectorizes at memory
bandwidth with zero index traffic.  The sharded variant partitions the
grid into z-slabs and exchanges one boundary plane per neighbor per product
via ``lax.ppermute`` (the one-hop halo pattern of SURVEY §2.9), so the
communication volume per product is O(nx*ny) against O(nx*ny*nz_local)
compute — the textbook weak-scaling regime.

Operator: (A u)[i,j,k] = 6 u[i,j,k] - sum of the 6 face neighbors, with
homogeneous Dirichlet boundaries — symmetric positive definite.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.tree_util import register_pytree_node

from ..operators import LinearOperator


def _stencil_interior(u_ext: jnp.ndarray) -> jnp.ndarray:
    """6*u - face neighbors for a z-extended block ``u_ext`` of shape
    (nz_local + 2, ny, nx); x/y boundaries are Dirichlet (zero-padded)."""
    p = jnp.pad(u_ext, ((0, 0), (1, 1), (1, 1)))
    core = u_ext[1:-1]
    return (
        6.0 * core
        - u_ext[:-2]
        - u_ext[2:]
        - p[1:-1, :-2, 1:-1]
        - p[1:-1, 2:, 1:-1]
        - p[1:-1, 1:-1, :-2]
        - p[1:-1, 1:-1, 2:]
    )


class Laplacian3DOperator(LinearOperator):
    """Single-device 7-point Laplacian on an (nz, ny, nx) grid, flattened
    with z slowest (row i = z*ny*nx + y*nx + x)."""

    def __init__(self, nz: int, ny: int, nx: int, dtype=jnp.float32):
        self.grid = (int(nz), int(ny), int(nx))
        n = nz * ny * nx
        self.shape = (n, n)
        self.dtype = jnp.dtype(dtype)
        self.nnz = 7 * n - 2 * (nx * ny + ny * nz + nz * nx)  # interior bonds

    def mv(self, x):
        nz, ny, nx = self.grid
        u = x.reshape(nz, ny, nx)
        u_ext = jnp.pad(u, ((1, 1), (0, 0), (0, 0)))
        return _stencil_interior(u_ext).reshape(-1)

    def rmv(self, x):
        return self.mv(x)  # symmetric

    def hmv(self, x):
        return self.mv(x)

    def diagonal(self):
        return jnp.full((self.shape[0],), 6.0, dtype=self.dtype)

    def astype(self, dtype):
        nz, ny, nx = self.grid
        return Laplacian3DOperator(nz, ny, nx, dtype=dtype)


def _lap_flatten(op):
    return (), (op.grid, str(op.dtype))


def _lap_unflatten(aux, _):
    obj = object.__new__(Laplacian3DOperator)
    obj.grid, dtype_str = aux
    nz, ny, nx = obj.grid
    n = nz * ny * nx
    obj.shape = (n, n)
    obj.dtype = jnp.dtype(dtype_str)
    obj.nnz = 7 * n - 2 * (nx * ny + ny * nz + nz * nx)
    return obj


register_pytree_node(Laplacian3DOperator, _lap_flatten, _lap_unflatten)


class ShardedLaplacian3D(LinearOperator):
    """Z-slab-partitioned 7-point Laplacian for SPMD solves.

    Each device owns ``nz // n_devices`` contiguous z-planes; ``mv`` (called
    inside ``shard_map`` on local flat shards) ppermutes one boundary plane
    to each neighbor and applies the fused stencil.  Edge devices receive
    zeros from the missing neighbor (``ppermute`` semantics), which realizes
    the Dirichlet boundary for free.
    """

    n = None  # instance attribute shadows the base-class property

    def __init__(
        self,
        nz: int,
        ny: int,
        nx: int,
        *,
        n_devices: int,
        axis_name: str = "rows",
        dtype=jnp.float32,
    ):
        if nz % n_devices != 0:
            raise ValueError(f"nz={nz} must divide evenly over {n_devices} devices")
        self.grid = (int(nz), int(ny), int(nx))
        self.n_devices = int(n_devices)
        self.axis_name = axis_name
        self.nz_local = nz // n_devices
        n = nz * ny * nx
        self.n = n
        self.n_padded = n
        self.n_local = n // n_devices
        self.shape = (n, n)
        self.dtype = jnp.dtype(dtype)
        self.nnz = 7 * n - 2 * (nx * ny + ny * nz + nz * nx)

    def mv(self, x):
        nz, ny, nx = self.grid
        D = self.n_devices
        ax = self.axis_name
        u = x.reshape(self.nz_local, ny, nx)
        # Halo planes: from the z-below neighbor (shard i-1) and z-above
        # (shard i+1); missing neighbors contribute zeros (Dirichlet).
        below = lax.ppermute(u[-1:], ax, perm=[(i, i + 1) for i in range(D - 1)])
        above = lax.ppermute(u[:1], ax, perm=[(i + 1, i) for i in range(D - 1)])
        if self.nz_local < 3:
            # Too thin for an interior: combined path.
            u_ext = jnp.concatenate([below, u, above], axis=0)
            return _stencil_interior(u_ext).reshape(-1)
        # Interior/boundary split (SURVEY §2.9 'overlapped with local
        # SpMV', structurally): the nz_local - 2 interior planes depend
        # ONLY on u — the ppermutes feed just the two edge planes, so
        # XLA's latency-hiding scheduler can run the bulk stencil between
        # the permute start/done pair.  Per-cell arithmetic is identical
        # to the combined path (same neighbor-add order): bit-equal.
        y_int = _stencil_interior(u)                    # planes 1..nz-2
        y_top = _stencil_interior(
            jnp.concatenate([below, u[:2]], axis=0))    # plane 0
        y_bot = _stencil_interior(
            jnp.concatenate([u[-2:], above], axis=0))   # plane nz-1
        return jnp.concatenate([y_top, y_int, y_bot], axis=0).reshape(-1)

    def rmv(self, x):
        return self.mv(x)

    def hmv(self, x):
        return self.mv(x)

    def diagonal(self):
        return jnp.full((self.n,), 6.0, dtype=self.dtype)

    def astype(self, dtype):
        nz, ny, nx = self.grid
        return ShardedLaplacian3D(nz, ny, nx, n_devices=self.n_devices,
                                  axis_name=self.axis_name, dtype=dtype)


def _slap_flatten(op):
    return (), (op.grid, op.n_devices, op.axis_name, str(op.dtype))


def _slap_unflatten(aux, _):
    grid, n_devices, axis_name, dtype_str = aux
    obj = object.__new__(ShardedLaplacian3D)
    obj.grid = grid
    obj.n_devices = n_devices
    obj.axis_name = axis_name
    nz, ny, nx = grid
    obj.nz_local = nz // n_devices
    n = nz * ny * nx
    obj.n = n
    obj.n_padded = n
    obj.n_local = n // n_devices
    obj.shape = (n, n)
    obj.dtype = jnp.dtype(dtype_str)
    obj.nnz = 7 * n - 2 * (nx * ny + ny * nz + nz * nx)
    return obj


register_pytree_node(ShardedLaplacian3D, _slap_flatten, _slap_unflatten)


def _variable_stencil(u_ext, c0, cxm, cxp, cym, cyp, czm, czp):
    """General 7-point product on a z-extended block.

    ``u_ext`` is (nz_local + 2, ny, nx); coefficient arrays are
    (nz_local, ny, nx), each multiplying the value at the named neighbor
    (czm -> z-1, cxp -> x+1, ...).  x/y boundaries are zero-padded;
    out-of-domain coefficients must be zero (enforced at construction).
    """
    p = jnp.pad(u_ext, ((0, 0), (1, 1), (1, 1)))
    core = u_ext[1:-1]
    return (
        c0 * core
        + czm * u_ext[:-2]
        + czp * u_ext[2:]
        + cym * p[1:-1, :-2, 1:-1]
        + cyp * p[1:-1, 2:, 1:-1]
        + cxm * p[1:-1, 1:-1, :-2]
        + cxp * p[1:-1, 1:-1, 2:]
    )


class Stencil3DOperator(LinearOperator):
    """Variable-coefficient 7-point operator on an (nz, ny, nx) grid.

    The general form of the reference's application domain (geophysical
    PDE discretizations): per-cell diagonal plus six face coefficients,
    applied as fused shifted multiply-adds — bandwidth-bound, no index
    traffic.  Coefficients are stored flat (n,) so the same leaves
    row-shard in the SPMD variant.

    Symmetric operators (e.g. -div(kappa grad)) satisfy
    ``cxp[i] == cxm[i + ex]`` etc.; ``rmv`` implements the exact algebraic
    transpose so unsymmetric stencils (advection terms) also work.
    """

    def __init__(self, nz, ny, nx, c0, cxm, cxp, cym, cyp, czm, czp,
                 *, dtype=None):
        self.grid = (int(nz), int(ny), int(nx))
        n = nz * ny * nx
        self.shape = (n, n)
        coeffs = []
        for name, c in (("c0", c0), ("cxm", cxm), ("cxp", cxp), ("cym", cym),
                        ("cyp", cyp), ("czm", czm), ("czp", czp)):
            # copy=True: the boundary-zeroing below must never mutate the
            # caller's arrays through a reshape view.
            c = np.array(c, dtype=dtype, copy=True).reshape(-1)
            if c.shape[0] != n:
                raise ValueError(f"{name} has {c.shape[0]} entries, expected {n}")
            coeffs.append(c)
        c0, cxm, cxp, cym, cyp, czm, czp = coeffs
        # Zero the out-of-domain faces so boundary reads (which alias the
        # zero padding) contribute nothing regardless of user input.
        g = lambda a: a.reshape(self.grid)
        g(cxm)[:, :, 0] = 0;  g(cxp)[:, :, -1] = 0
        g(cym)[:, 0, :] = 0;  g(cyp)[:, -1, :] = 0
        g(czm)[0, :, :] = 0;  g(czp)[-1, :, :] = 0
        (self.c0, self.cxm, self.cxp, self.cym, self.cyp, self.czm,
         self.czp) = [jnp.asarray(c) for c in coeffs]
        self.dtype = self.c0.dtype
        self.nnz = int(sum(np.count_nonzero(c) for c in coeffs))

    def _coeff_grids(self):
        nz, ny, nx = self.grid
        return [c.reshape(nz, ny, nx) for c in
                (self.c0, self.cxm, self.cxp, self.cym, self.cyp,
                 self.czm, self.czp)]

    def mv(self, x):
        nz, ny, nx = self.grid
        u_ext = jnp.pad(x.reshape(nz, ny, nx), ((1, 1), (0, 0), (0, 0)))
        return _variable_stencil(u_ext, *self._coeff_grids()).reshape(-1)

    def rmv(self, x):
        # (A^T u): the cxp coefficient at cell i couples i -> i+ex, so the
        # transpose routes (cxp*u) shifted one cell +x, etc.
        nz, ny, nx = self.grid
        u = x.reshape(nz, ny, nx)
        c0, cxm, cxp, cym, cyp, czm, czp = self._coeff_grids()

        def shift(a, axis, by):
            pad = [(0, 0)] * 3
            pad[axis] = (1, 0) if by > 0 else (0, 1)
            ap = jnp.pad(a, pad)
            sl = [slice(None)] * 3
            sl[axis] = slice(0, a.shape[axis]) if by > 0 else slice(1, None)
            return ap[tuple(sl)]

        y = c0 * u
        y = y + shift(cxp * u, 2, +1) + shift(cxm * u, 2, -1)
        y = y + shift(cyp * u, 1, +1) + shift(cym * u, 1, -1)
        y = y + shift(czp * u, 0, +1) + shift(czm * u, 0, -1)
        return y.reshape(-1)

    def hmv(self, x):
        if jnp.issubdtype(self.dtype, jnp.complexfloating):
            return jnp.conj(self.rmv(jnp.conj(x)))
        return self.rmv(x)

    def diagonal(self):
        return self.c0

    def astype(self, dtype):
        obj = object.__new__(Stencil3DOperator)
        obj.grid = self.grid
        obj.shape = self.shape
        for name in ("c0", "cxm", "cxp", "cym", "cyp", "czm", "czp"):
            setattr(obj, name, getattr(self, name).astype(dtype))
        obj.dtype = obj.c0.dtype
        obj.nnz = self.nnz
        return obj

    def to_coo(self):
        """Host COO triplets (rows, cols, vals) of the assembled matrix —
        the bridge to the factorization helpers (incomplete_cholesky_coo
        etc.), mirroring how the reference's samples hand an assembled
        COO to the preconditioner builders (sample8.cu:142-236)."""
        nz, ny, nx = self.grid
        n = nz * ny * nx
        idx = np.arange(n).reshape(nz, ny, nx)
        rows = [np.arange(n)]
        cols = [np.arange(n)]
        vals = [np.asarray(self.c0)]
        for cname, ax, d in (("cxm", 2, -1), ("cxp", 2, 1), ("cym", 1, -1),
                             ("cyp", 1, 1), ("czm", 0, -1), ("czp", 0, 1)):
            c = np.asarray(getattr(self, cname)).reshape(nz, ny, nx)
            sl_src = [slice(None)] * 3
            sl_dst = [slice(None)] * 3
            if d < 0:
                sl_src[ax] = slice(1, None)
                sl_dst[ax] = slice(0, -1)
            else:
                sl_src[ax] = slice(0, -1)
                sl_dst[ax] = slice(1, None)
            r = idx[tuple(sl_src)].ravel()
            cc = idx[tuple(sl_dst)].ravel()
            v = c[tuple(sl_src)].ravel()
            keep = v != 0
            rows.append(r[keep])
            cols.append(cc[keep])
            vals.append(v[keep])
        return (np.concatenate(rows), np.concatenate(cols),
                np.concatenate(vals))

    @classmethod
    def diffusion(cls, kappa, *, dtype=None):
        """SPD operator -div(kappa grad) with harmonic-mean face
        transmissibilities from a cell-centred conductivity ``kappa``
        of shape (nz, ny, nx) — the standard finite-volume build."""
        kappa = np.asarray(kappa, dtype=dtype)
        nz, ny, nx = kappa.shape

        def face(axis):
            k0 = kappa
            sl_lo = [slice(None)] * 3
            sl_hi = [slice(None)] * 3
            sl_lo[axis] = slice(0, -1)
            sl_hi[axis] = slice(1, None)
            t = 2.0 * k0[tuple(sl_lo)] * k0[tuple(sl_hi)] / (
                k0[tuple(sl_lo)] + k0[tuple(sl_hi)]
            )
            m = np.zeros_like(kappa)   # coefficient toward -axis
            p = np.zeros_like(kappa)   # coefficient toward +axis
            p[tuple(sl_lo)] = -t
            m[tuple(sl_hi)] = -t
            return m, p

        cxm, cxp = face(2)
        cym, cyp = face(1)
        czm, czp = face(0)
        c0 = -(cxm + cxp + cym + cyp + czm + czp)
        # Dirichlet boundary: add the boundary-face conductance to c0.
        for axis in range(3):
            for side in (0, -1):
                sl = [slice(None)] * 3
                sl[axis] = side
                c0[tuple(sl)] += 2.0 * kappa[tuple(sl)]
        return cls(nz, ny, nx, c0, cxm, cxp, cym, cyp, czm, czp, dtype=dtype)


def _st_flatten(op):
    return (
        (op.c0, op.cxm, op.cxp, op.cym, op.cyp, op.czm, op.czp),
        (op.grid, str(op.dtype), op.nnz),
    )


def _st_unflatten(aux, children):
    obj = object.__new__(Stencil3DOperator)
    (obj.c0, obj.cxm, obj.cxp, obj.cym, obj.cyp, obj.czm, obj.czp) = children
    obj.grid, dtype_str, obj.nnz = aux
    n = obj.grid[0] * obj.grid[1] * obj.grid[2]
    obj.shape = (n, n)
    obj.dtype = jnp.dtype(dtype_str)
    return obj


register_pytree_node(Stencil3DOperator, _st_flatten, _st_unflatten)


class ShardedStencil3D(LinearOperator):
    """Z-slab-partitioned variable-coefficient 7-point operator.

    Coefficients are flat (n,) leaves that row-shard over the mesh; ``mv``
    exchanges one u-plane per neighbor via ``ppermute`` exactly like
    :class:`ShardedLaplacian3D`.
    """

    n = None

    def __init__(self, stencil: Stencil3DOperator, *, n_devices: int,
                 axis_name: str = "rows"):
        nz, ny, nx = stencil.grid
        if nz % n_devices != 0:
            raise ValueError(f"nz={nz} must divide evenly over {n_devices} devices")
        self.grid = stencil.grid
        self.n_devices = int(n_devices)
        self.axis_name = axis_name
        self.nz_local = nz // n_devices
        n = nz * ny * nx
        self.n = n
        self.n_padded = n
        self.n_local = n // n_devices
        self.shape = (n, n)
        self.dtype = stencil.dtype
        self.nnz = stencil.nnz
        (self.c0, self.cxm, self.cxp, self.cym, self.cyp, self.czm,
         self.czp) = (stencil.c0, stencil.cxm, stencil.cxp, stencil.cym,
                      stencil.cyp, stencil.czm, stencil.czp)

    def mv(self, x):
        nz, ny, nx = self.grid
        D = self.n_devices
        ax = self.axis_name
        u = x.reshape(self.nz_local, ny, nx)
        below = lax.ppermute(u[-1:], ax, perm=[(i, i + 1) for i in range(D - 1)])
        above = lax.ppermute(u[:1], ax, perm=[(i + 1, i) for i in range(D - 1)])
        shape_l = (self.nz_local, ny, nx)
        coeffs = [c.reshape(shape_l) for c in
                  (self.c0, self.cxm, self.cxp, self.cym, self.cyp,
                   self.czm, self.czp)]
        if self.nz_local < 3:
            u_ext = jnp.concatenate([below, u, above], axis=0)
            return _variable_stencil(u_ext, *coeffs).reshape(-1)
        # Interior/boundary split, exactly as ShardedLaplacian3D.mv: the
        # bulk product is collective-free, only the two edge planes read
        # the ppermuted halos.
        y_int = _variable_stencil(u, *[c[1:-1] for c in coeffs])
        y_top = _variable_stencil(
            jnp.concatenate([below, u[:2]], axis=0),
            *[c[:1] for c in coeffs])
        y_bot = _variable_stencil(
            jnp.concatenate([u[-2:], above], axis=0),
            *[c[-1:] for c in coeffs])
        return jnp.concatenate([y_top, y_int, y_bot], axis=0).reshape(-1)

    def diagonal(self):
        return self.c0

    def astype(self, dtype):
        obj = object.__new__(ShardedStencil3D)
        obj.__dict__.update(self.__dict__)
        for name in ("c0", "cxm", "cxp", "cym", "cyp", "czm", "czp"):
            setattr(obj, name, getattr(self, name).astype(dtype))
        obj.dtype = jnp.dtype(dtype)
        return obj


def _sst_flatten(op):
    return (
        (op.c0, op.cxm, op.cxp, op.cym, op.cyp, op.czm, op.czp),
        (op.grid, op.n_devices, op.axis_name, str(op.dtype), op.nnz),
    )


def _sst_unflatten(aux, children):
    obj = object.__new__(ShardedStencil3D)
    (obj.c0, obj.cxm, obj.cxp, obj.cym, obj.cyp, obj.czm, obj.czp) = children
    obj.grid, obj.n_devices, obj.axis_name, dtype_str, obj.nnz = aux
    nz, ny, nx = obj.grid
    obj.nz_local = nz // obj.n_devices
    n = nz * ny * nx
    obj.n = n
    obj.n_padded = n
    obj.n_local = n // obj.n_devices
    obj.shape = (n, n)
    obj.dtype = jnp.dtype(dtype_str)
    return obj


register_pytree_node(ShardedStencil3D, _sst_flatten, _sst_unflatten)
