"""SPMD complex solves on complex-less backends: the sharded pair path.

The reference's flagship complex workload (sample6.cpp:162-195) runs its
complex recurrences through ``clcg_solver``; on a backend without
complex dtypes, single-device complex solves go through the pair engines
(solvers/cplx_pairs.py) over a RealifiedOperator.  This module is the
multi-device story for that path:

- :class:`ShardedRealifiedOperator` — the complex matrix row-partitioned
  over the solver mesh as TWO identically-partitioned real sharded
  operators (re / im parts share the sparsity pattern, hence the same
  halo plan / transpose plan / comm strategy);
- a **block-interleaved stacked layout**: device ``d``'s local vector is
  ``[re_d; im_d]`` (2 * n_local,), so the pair engines' ``_halves`` split
  works shard-locally and their fused reductions become per-iteration
  ``psum`` pairs — the engines themselves run UNCHANGED inside
  ``shard_map`` (their stopping metrics read the global size via
  ``harness.dim``);
- :func:`solve_realified_sharded` — the ``solve_sharded`` twin for pair
  engines (all 7 reference complex methods), plus the packing helpers
  :func:`pack_pairs` / :func:`unpack_pairs`.

Communication per iteration (ELL/allgather comm): the two halves gather
once each (2 all-gathers feed all 4 real sub-products of one complex
``mv``) and the engines' fused scalar reductions are 2 psums — the same
collective economy as the real-domain sharded CG (SURVEY §2.9).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P
from jax.tree_util import register_pytree_node

from ..operators import LinearOperator
from ..ops.spmv import ell_spmv
from ..solvers import harness as H
from ..types import DEFAULT_PARAMS, SolverParams, SolveResult, Status
from .mesh import make_mesh
from .sharded import ShardedBandedOperator, ShardedSparseOperator


def pack_pairs(z, n_devices: int, n_padded: int) -> jnp.ndarray:
    """Complex host vector (n,) -> block-interleaved stacked real
    ``(2 * n_padded,)`` array whose ``P(axis)`` shard on device ``d`` is
    ``[re_d; im_d]``.  Host-side numpy: a complex DEVICE array would be a
    deferred UNIMPLEMENTED bomb on the backends this serves."""
    z = np.asarray(z)
    rdt = np.float64 if z.dtype in (np.complex128, np.float64) else np.float32
    n = z.shape[0]
    nl = n_padded // n_devices
    re = np.zeros(n_padded, rdt)
    im = np.zeros(n_padded, rdt)
    re[:n] = z.real
    im[:n] = z.imag if np.iscomplexobj(z) else 0.0
    packed = np.stack(
        [re.reshape(n_devices, nl), im.reshape(n_devices, nl)], axis=1
    ).reshape(-1)
    return jnp.asarray(packed)


def unpack_pairs(x2, n_devices: int, n: int) -> np.ndarray:
    """Inverse of :func:`pack_pairs`: block-interleaved stacked result ->
    complex host vector (n,)."""
    a = np.asarray(x2)
    nl = a.shape[0] // (2 * n_devices)
    a = a.reshape(n_devices, 2, nl)
    return (a[:, 0].reshape(-1)[:n]
            + 1j * a[:, 1].reshape(-1)[:n])


class ShardedRealifiedOperator(LinearOperator):
    """Complex sparse operator row-partitioned for the pair engines.

    ``mv``/``rmv`` consume and produce LOCAL block-interleaved stacked
    vectors ``[re_d; im_d]`` inside ``shard_map``.  The four real
    sub-products of one complex product share the two gathered/exchanged
    source windows, so communication is exactly that of TWO real sharded
    products, not four.

    ``storage="ell"`` (default) uses :class:`ShardedSparseOperator`
    (any pattern; halo comm auto-picked for banded ones);
    ``storage="dia"`` uses :class:`ShardedBandedOperator` (gather-free
    shifted-diagonal products for banded/stencil patterns).

    Reference counterpart: the complex 10K system of sample6.cpp:162-195,
    whose multi-chip story the reference does not have (SURVEY §2.9).
    """

    n = None  # logical STACKED size 2 * n_complex (shadows base property)

    def __init__(self, n: int, rows, cols, vals, *, n_devices: int,
                 axis_name: str = "rows", comm: str = "auto",
                 storage: str = "ell"):
        vals = np.asarray(vals)
        if not np.iscomplexobj(vals):
            raise ValueError(
                "ShardedRealifiedOperator expects complex values; use "
                "ShardedSparseOperator for real systems")
        rows = np.asarray(rows)
        cols = np.asarray(cols)
        if storage == "ell":
            mk = lambda v: ShardedSparseOperator(
                n, rows, cols, v, n_devices=n_devices,
                axis_name=axis_name, comm=comm)
        elif storage == "dia":
            mk = lambda v: ShardedBandedOperator(
                n, rows, cols, v, n_devices=n_devices, axis_name=axis_name)
        else:
            raise ValueError(f"unknown storage {storage!r} (ell|dia)")
        self.re = mk(np.ascontiguousarray(vals.real))
        self.im = mk(np.ascontiguousarray(vals.imag))
        self.storage = storage
        self.n_complex = int(n)
        self.n = 2 * int(n)                     # logical stacked size
        self.n_devices = int(n_devices)
        self.axis_name = axis_name
        self.n_local = self.re.n_local          # complex rows per device
        self.n_padded = 2 * self.re.n_padded    # stacked padded size
        self.shape = (self.n_padded, self.n_padded)
        self.dtype = self.re.dtype
        self.nnz = self.re.nnz
        # Host complex diagonal for Jacobi (padding rows get 1 so the
        # inverse stays finite; their x/b entries are zero).
        diag = np.ones(self.re.n_padded, dtype=vals.dtype)
        diag[:n] = 0
        dm = rows == cols
        np.add.at(diag, rows[dm], vals[dm])
        self._diag_c = diag

    # -- SPMD products (inside shard_map; x2 is local [re_d; im_d]) ---------

    def _windows(self, x2):
        """The two communicated source windows (one per half)."""
        nl = x2.shape[0] // 2
        xr, xi = x2[:nl], x2[nl:]
        if self.storage == "ell":
            return self.re._gather_x(xr), self.re._gather_x(xi)
        h_l, h_r = self.re.halo
        return (self.re._exchange(xr, h_l, h_r),
                self.re._exchange(xi, h_l, h_r))

    def mv(self, x2):
        xr_w, xi_w = self._windows(x2)
        if self.storage == "ell":
            # Each part uses its OWN column table: halo-mode column
            # parking depends on which entries are zero in THAT part
            # (a purely imaginary entry has re val 0 but im val != 0).
            # The windows are shared — halo widths derive from the
            # pattern only, identical across parts.
            re_c, re_v = self.re.ell_cols, self.re.ell_vals
            im_c, im_v = self.im.ell_cols, self.im.ell_vals
            ar_xr = ell_spmv(re_c, re_v, xr_w)
            ar_xi = ell_spmv(re_c, re_v, xi_w)
            ai_xr = ell_spmv(im_c, im_v, xr_w)
            ai_xi = ell_spmv(im_c, im_v, xi_w)
        else:
            ar_xr = self.re._apply_window(xr_w)
            ar_xi = self.re._apply_window(xi_w)
            ai_xr = self.im._apply_window(xr_w)
            ai_xi = self.im._apply_window(xi_w)
        return jnp.concatenate([ar_xr - ai_xi, ai_xr + ar_xi])

    def rmv(self, x2):
        """R(A)^T == R(A^H): yr = Ar^T xr + Ai^T xi, yi = -Ai^T xr + Ar^T xi.
        Four owner-targeted transpose products (each O(halo) / O(|R| *
        n_local) communication, sharded.py:_transpose_apply); the pair
        engines that need this (bicg) pay a second product for A^H just
        like the reference (clcg.cpp:188)."""
        nl = x2.shape[0] // 2
        xr, xi = x2[:nl], x2[nl:]
        yr = self.re.rmv(xr) + self.im.rmv(xi)
        yi = -self.im.rmv(xr) + self.re.rmv(xi)
        return jnp.concatenate([yr, yi])

    def diagonal(self):
        raise NotImplementedError(
            "use .complex_diagonal() (host) — the stacked device diagonal "
            "is layout-dependent")

    def complex_diagonal(self) -> np.ndarray:
        """Host complex diagonal (padded length), for Jacobi."""
        return self._diag_c

    def jacobi_inv_diag_packed(self) -> jnp.ndarray:
        """1/diag packed in the block-interleaved stacked layout — the
        ``PairJacobi`` leaf for sharded pair solves."""
        return pack_pairs(1.0 / self._diag_c, self.n_devices,
                          self.re.n_padded)


def _sharded_realified_flatten(op):
    return (op.re, op.im), (
        op.storage, op.n_complex, op.n, op.n_devices, op.axis_name,
        op.n_local, op.n_padded, op.shape, str(op.dtype), op.nnz,
    )


def _sharded_realified_unflatten(aux, children):
    obj = object.__new__(ShardedRealifiedOperator)
    obj.re, obj.im = children
    (obj.storage, obj.n_complex, obj.n, obj.n_devices, obj.axis_name,
     obj.n_local, obj.n_padded, obj.shape, dtype_str, obj.nnz) = aux
    obj.dtype = jnp.dtype(dtype_str)
    obj._diag_c = None   # host-only; not needed inside traced code
    return obj


register_pytree_node(ShardedRealifiedOperator, _sharded_realified_flatten,
                     _sharded_realified_unflatten)


class _DummyPairOp:
    """Shape-only stand-in for carry-structure derivation (eval_shape)."""

    def __init__(self, n2: int, dtype):
        from ..operators import MatrixFreeOperator

        half = MatrixFreeOperator(lambda v: v, n=n2 // 2, dtype=dtype)
        self.re = half
        self.im = half

    def mv(self, x):
        return x

    def rmv(self, x):
        return x


def _pair_carry_specs(fn, b_dtype, n_local2: int, axis: str, kwargs):
    """out_specs for a pair-engine carry: eval-shape the plain engine on a
    local-sized dummy; vectors shard on the mesh axis, scalars (including
    the (re, im) tuple entries) and the trace replicate."""
    nl2 = max(n_local2, 4)
    b_s = jax.ShapeDtypeStruct((nl2,), b_dtype)
    dummy = _DummyPairOp(nl2, b_dtype)
    shapes = jax.eval_shape(lambda b: fn(dummy, b, b, **kwargs), b_s)

    def spec_for(key):
        def f(leaf):
            if leaf is None:
                return P()
            if key == "trace" or leaf.ndim == 0:
                return P()
            return P(axis)
        return f

    return {k: jax.tree.map(spec_for(k), v) for k, v in shapes.items()}


_SHARDED_PAIR_JIT_CACHE: dict = {}


def solve_realified_sharded(
    A: ShardedRealifiedOperator,
    b,
    x0=None,
    *,
    method: str = "bicg_sym",
    M=None,
    mesh: Optional[Mesh] = None,
    params: SolverParams = DEFAULT_PARAMS,
    monitor: Optional[Callable] = None,
    trace_len: int = 0,
    key=None,
    check: bool = False,
) -> SolveResult:
    """Solve the complex system ``A x = b`` SPMD over a device mesh with
    the reference's own complex algorithms in pair arithmetic.

    The sharded twin of :func:`liblcg_tpu.solve_realified` (all 7
    reference complex methods, clcg.cpp:46-74): one compiled
    ``shard_map`` program, vectors carried as local ``[re_d; im_d]``
    shards, reductions as fused psums.  ``b``/``x0`` are complex HOST
    vectors; the returned ``x`` is complex host.  ``M``: ``"jacobi"``
    (from the operator's complex diagonal), a complex diagonal vector,
    or a PairJacobi whose ``inv_diag`` is already packed.
    """
    from ..solve import canonical_method
    from ..solvers.cplx_pairs import (_KEYED_METHODS, _PAIR_ENGINES,
                                      PairJacobi)

    m = canonical_method(method)
    if m not in _PAIR_ENGINES:
        raise ValueError(
            f"pair-complex engines support {sorted(_PAIR_ENGINES)}; got {m!r}"
        )
    fn, needs_M = _PAIR_ENGINES[m]
    if not isinstance(A, ShardedRealifiedOperator):
        raise TypeError("A must be a ShardedRealifiedOperator; build one "
                        "from the complex COO data, or use solve_realified "
                        "for single-device solves")

    err = params.validate(for_method=m)
    if err is not None:
        return SolveResult(
            x=np.zeros_like(np.asarray(b)),
            status_code=jnp.asarray(int(err), jnp.int32),
            iterations=jnp.asarray(0, jnp.int32),
            residual=jnp.asarray(jnp.nan), trace=None)

    axis = A.axis_name
    D = A.n_devices
    n_c = A.n_complex
    nl2 = A.n_padded // D          # local stacked length (2 * n_local)
    if mesh is None:
        mesh = make_mesh(D, axis)
    if mesh.shape[axis] != D:
        raise ValueError(
            f"mesh axis {axis!r} has size {mesh.shape[axis]}, operator "
            f"was partitioned for {D}")

    bp = pack_pairs(b, D, A.re.n_padded)
    x0p = (jnp.zeros_like(bp) if x0 is None
           else pack_pairs(np.asarray(x0), D, A.re.n_padded))

    if needs_M:
        if M is None:
            return SolveResult(
                x=np.zeros_like(np.asarray(b)),
                status_code=jnp.asarray(
                    int(Status.NULL_PRECONDITION_MATRIX), jnp.int32),
                iterations=jnp.asarray(0, jnp.int32),
                residual=jnp.asarray(jnp.nan), trace=None)
        if isinstance(M, str) and M == "jacobi":
            M = PairJacobi(A.jacobi_inv_diag_packed())
        elif not isinstance(M, PairJacobi):
            # A complex diagonal vector (host).
            M = PairJacobi(pack_pairs(1.0 / np.asarray(M), D,
                                      A.re.n_padded))

    takes_key = m in _KEYED_METHODS
    extras = []
    if needs_M:
        extras.append(M)
    if takes_key:
        extras.append(jax.random.PRNGKey(1234) if key is None else key)

    from .api import _structure_key

    cache_key = (fn, params, monitor, trace_len, axis, D, n_c, mesh,
                 needs_M, takes_key, _structure_key(A),
                 tuple(bp.shape), str(bp.dtype))
    jitted = _SHARDED_PAIR_JIT_CACHE.get(cache_key)
    if jitted is None:
        solver_kwargs = dict(params=params, monitor=monitor,
                             trace_len=trace_len)
        struct_kwargs = dict(solver_kwargs)
        if needs_M:
            struct_kwargs["M"] = (lambda v: v)
        if takes_key:
            struct_kwargs["key"] = jax.random.PRNGKey(0)
        out_specs = _pair_carry_specs(fn, bp.dtype, nl2, axis, struct_kwargs)

        # Sub-operator leaves lead with the COMPLEX padded row count
        # (ELL tables, DIA values, diagonals); PairJacobi's inv_diag is
        # the full packed stacked vector.
        def a_leaf_spec(l):
            shp = getattr(l, "shape", None)
            if shp and len(shp) >= 1 and shp[0] == A.re.n_padded:
                return P(axis, *([None] * (len(shp) - 1)))
            return P()

        A_specs = jax.tree.map(a_leaf_spec, A)
        extra_specs = []
        if needs_M:
            extra_specs.append(jax.tree.map(
                lambda l: P(axis) if getattr(l, "shape", (0,))[0]
                == A.n_padded else P(), M))
        if takes_key:
            extra_specs.append(P())

        def body(A_l, b_l, x0_l, *extras_l):
            kwargs = dict(solver_kwargs)
            i = 0
            if needs_M:
                kwargs["M"] = extras_l[i]
                i += 1
            if takes_key:
                # Decorrelate the shadow draw across shards.
                kwargs["key"] = jax.random.fold_in(
                    extras_l[i], lax.axis_index(axis))
            with H.distributed(axis, logical_dim=2 * n_c):
                with H.reduction_dtype(params.reduce_dtype):
                    return fn(A_l, b_l, x0_l, **kwargs)

        mapped = jax.shard_map(
            body, mesh=mesh,
            in_specs=(A_specs, P(axis), P(axis), *extra_specs),
            out_specs=out_specs,
        )
        jitted = jax.jit(mapped)
        _SHARDED_PAIR_JIT_CACHE[cache_key] = jitted

    carry = jitted(A, bp, x0p, *extras)
    x = unpack_pairs(carry["x"], D, n_c)
    result = SolveResult(
        x=x,
        status_code=carry["status"],
        iterations=carry["t"],
        residual=carry["residual"],
        trace=carry.get("trace"),
    )
    if check:
        from ..utils.errors import check_status

        check_status(result.status_code, raise_error=True, quiet=True)
    return result
