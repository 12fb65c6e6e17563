"""SPMD solve entry point: any solver, any mesh, one compiled program.

``solve_sharded`` wraps the same engines :func:`liblcg_tpu.solve` dispatches
to, but traces them inside ``jax.shard_map`` over the solver mesh with the
harness in distributed mode: every vector in the while-loop carry is a local
row shard, every reduction a ``psum`` over the mesh axis, and the operator's
``mv`` performs its own halo/all-gather communication.  The whole solve is
still ONE compiled XLA program — the multi-chip upgrade costs no extra
host-device round trips.

The reference has no counterpart for any of this (SURVEY §2.9: its only
parallelism is OpenMP threads or one GPU).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from ..operators import LinearOperator, MatrixFreeOperator
from ..solvers import harness as H
from ..types import DEFAULT_PARAMS, SolverParams, SolveResult, Status
from .mesh import make_mesh
from .sharded import ShardedSparseOperator

#: Carry entries that stay replicated even though they are rank-1 arrays.
_REPLICATED_KEYS = frozenset({"trace", "qk_m"})

#: Compiled sharded solves, keyed on everything static (engine, params,
#: mesh, operator structure + leaf shapes, operand shapes).  Without this
#: every solve_sharded call rebuilt a fresh ``jax.jit(shard_map(...))``
#: and re-traced AND re-compiled the whole SPMD program — measured at
#: ~400 ms per call on the 8-device weak-scaling workload (the solve
#: itself: ~90 ms).
_SHARDED_JIT_CACHE: dict = {}


def _structure_key(tree) -> tuple:
    """Hashable (treedef, leaf shapes/dtypes) signature of a pytree."""
    leaves, treedef = jax.tree.flatten(tree)

    def sig(l):
        shp = getattr(l, "shape", None)
        dt = getattr(l, "dtype", None)
        return (tuple(shp) if shp is not None else None,
                str(dt) if dt is not None else type(l).__name__)

    return (treedef, tuple(sig(l) for l in leaves))


def _pad_to(v, n_padded, fill=0.0):
    """Zero-pad the solve (trailing) dimension up to n_padded."""
    v = jnp.asarray(v)
    if v.shape[-1] == n_padded:
        return v
    pad = n_padded - v.shape[-1]
    return jnp.concatenate(
        [v, jnp.full(v.shape[:-1] + (pad,), fill, dtype=v.dtype)], axis=-1
    )


def _leaf_spec(leaf, n_padded: int, axis: str, n_devices: int = 0):
    """Row-sharded spec for array leaves: leading dim == n_padded (row data)
    or == n_devices (per-shard stacked data, e.g. block-Jacobi factors)
    shards over the mesh axis; everything else replicates."""
    try:
        shp = leaf.shape
    except AttributeError:
        return P()
    if len(shp) >= 1 and (shp[0] == n_padded or
                          (n_devices and shp[0] == n_devices)):
        return P(axis, *([None] * (len(shp) - 1)))
    return P()


def _carry_specs(fn, A_struct_op, b_dtype, n_local, axis, kwargs, nrhs=None):
    """Derive the carry pytree's out_specs by eval-shaping the *plain*
    (single-device) solver — the carry structure is identical, and scalars/
    vectors are told apart by rank/shape (with the named replicated-array
    exceptions).  ``nrhs`` switches to batched shapes: vectors are
    (nrhs, n_local) sharded on the trailing axis, per-system scalars
    ((nrhs,), (nrhs, 1), (nrhs, maxi_m)) replicate."""
    nl = max(n_local, 2)
    batched = nrhs is not None
    shape = (nrhs, nl) if batched else (nl,)
    b_s = jax.ShapeDtypeStruct(shape, b_dtype)

    def run(b):
        if batched:
            with H.batched(nrhs=nrhs):
                return fn(A_struct_op, b, b, **kwargs)
        return fn(A_struct_op, b, b, **kwargs)

    shapes = jax.eval_shape(run, b_s)

    def spec_of(key, leaf):
        if key in _REPLICATED_KEYS or leaf is None or leaf.ndim == 0:
            return P()
        if batched:
            if leaf.ndim == 2 and leaf.shape[-1] == nl:
                return P(None, axis)
            return P()          # (nrhs,), (nrhs, 1), (nrhs, maxi_m) scalars
        return P(axis)

    return {k: spec_of(k, v) for k, v in shapes.items()}


def solve_sharded(
    A: ShardedSparseOperator,
    b,
    x0=None,
    *,
    method: str = "cg",
    mesh: Optional[Mesh] = None,
    params: SolverParams = DEFAULT_PARAMS,
    M=None,
    lower=None,
    upper=None,
    monitor: Optional[Callable] = None,
    trace_len: int = 0,
    key=None,
    lmin=None,
    lmax=None,
    restart: int = 32,
    s: int = 4,
    check: bool = False,
) -> SolveResult:
    """Solve ``A x = b`` SPMD over a device mesh.

    Parameters mirror :func:`liblcg_tpu.solve`; differences:

    - ``A`` must be a mesh-aware operator (``ShardedSparseOperator``,
      ``ShardedLaplacian3D``, or any LinearOperator pytree whose ``mv``
      maps local shards to local shards and whose array leaves are either
      ``(n_padded, ...)`` row-shardable or replicated);
    - ``mesh`` defaults to a fresh 1-D mesh over ``A.n_devices`` devices;
    - ``M`` may be a diagonal-style operator with ``(n_padded,)`` leaves
      (sharded) or a callable applied shard-locally (block-Jacobi style);
    - ``monitor`` receives the *local shard* of x (residual/t are global).
    """
    from ..solve import _resolve_engine, canonical_method

    m = canonical_method(method)
    b = jnp.asarray(b)
    # 2-D b = batched multi-RHS: rows are systems, sharding stays on the
    # solve dimension.  The batched and distributed tracing contexts
    # compose (reductions become per-system psums).
    nrhs = b.shape[0] if b.ndim == 2 else None
    if b.ndim > 2:
        raise ValueError(f"b must be (n,) or (nrhs, n), got {b.shape}")
    if nrhs is not None:
        from ..solve import BATCHED_METHODS

        if m not in BATCHED_METHODS:
            raise ValueError(
                f"method {m!r} does not support batched solves; available: "
                f"{sorted(BATCHED_METHODS)}"
            )
    is_complex = jnp.issubdtype(b.dtype, jnp.complexfloating) or jnp.issubdtype(
        jnp.dtype(A.dtype), jnp.complexfloating
    )
    from ..solve import _BLOCK_METHODS

    if m in _BLOCK_METHODS and nrhs is None:
        raise ValueError(
            f"method {m!r} solves a stack of right-hand sides in one shared "
            f"block Krylov space; pass b of shape (nrhs, n)"
        )
    fn, needs_M, needs_bounds = _resolve_engine(m, is_complex, A=A,
                                                lmin=lmin, lmax=lmax,
                                                restart=restart, s=s)

    if M is not None and not needs_M:
        # Same guard as solve(): silently ignoring M is a
        # wrong-experiment class of bug (solve.py:432).
        raise ValueError(
            f"method {m!r} does not use a preconditioner under "
            f"solve_sharded; M would be silently ignored.  Use the "
            f"preconditioned variant, or pre-scale the operator "
            f"(operators.SymScaledOperator) for the Jacobi-scaled "
            f"method='cacg' form."
        )

    err = params.validate(for_method=m)
    if err is not None:
        return SolveResult(
            x=b * 0, status_code=jnp.asarray(int(err), jnp.int32),
            iterations=jnp.asarray(0, jnp.int32), residual=jnp.asarray(jnp.nan),
            trace=None,
        )

    axis = A.axis_name
    D = A.n_devices
    n = getattr(A, "n", b.shape[0])
    n_padded = A.n_padded
    n_local = n_padded // D
    if mesh is None:
        mesh = make_mesh(D, axis)
    if mesh.shape[axis] != D:
        raise ValueError(
            f"mesh axis {axis!r} has size {mesh.shape[axis]}, operator "
            f"was partitioned for {D}"
        )

    if is_complex and not jnp.issubdtype(b.dtype, jnp.complexfloating):
        b = b.astype(A.dtype)
    bp = _pad_to(b, n_padded)
    x0p = (
        jnp.zeros_like(bp)
        if x0 is None
        else _pad_to(jnp.asarray(x0, dtype=bp.dtype), n_padded)
    )

    takes_key = is_complex and m in ("cgs", "bicgstab", "tfqmr")

    # Assemble positional extras.
    extras = []
    M_is_callable = needs_M and not isinstance(M, LinearOperator)
    if needs_M:
        if M is None:
            return SolveResult(
                x=b * 0,
                status_code=jnp.asarray(int(Status.NULL_PRECONDITION_MATRIX), jnp.int32),
                iterations=jnp.asarray(0, jnp.int32),
                residual=jnp.asarray(jnp.nan), trace=None,
            )
        if not M_is_callable:
            extras.append(M)
    if needs_bounds:
        rdt = bp.real.dtype
        extras.append(_pad_to(jnp.asarray(lower, dtype=rdt), n_padded))
        extras.append(_pad_to(jnp.asarray(upper, dtype=rdt), n_padded))
    if takes_key:
        extras.append(jax.random.PRNGKey(1234) if key is None else key)

    cache_key = (
        fn, params, monitor, trace_len, axis, D, n, n_padded, nrhs, mesh,
        needs_M, M_is_callable, M if M_is_callable else None,
        needs_bounds, takes_key, _structure_key(A),
        tuple(bp.shape), str(bp.dtype),
        tuple(_structure_key(e) for e in extras),
    )
    jitted = _SHARDED_JIT_CACHE.get(cache_key)
    if jitted is None:
        extra_specs = []
        if needs_M and not M_is_callable:
            extra_specs.append(
                jax.tree.map(lambda l: _leaf_spec(l, n_padded, axis, D), M)
            )
        if needs_bounds:
            extra_specs.extend([P(axis), P(axis)])
        if takes_key:
            extra_specs.append(P())

        solver_kwargs = dict(params=params, monitor=monitor,
                             trace_len=trace_len)

        # Carry structure for out_specs (same keys as the sharded run).
        struct_kwargs = dict(solver_kwargs)
        if needs_M:
            struct_kwargs["M"] = (lambda v: v)
        if needs_bounds:
            nl = max(n_local, 2)
            struct_kwargs["lower"] = jnp.zeros((nl,), bp.real.dtype)
            struct_kwargs["upper"] = jnp.ones((nl,), bp.real.dtype)
        if takes_key:
            struct_kwargs["key"] = jax.random.PRNGKey(0)
        dummy_A = MatrixFreeOperator(
            lambda v: v, n=max(n_local, 2), dtype=bp.dtype
        )
        out_specs = _carry_specs(
            fn, dummy_A, bp.dtype, n_local, axis, struct_kwargs, nrhs=nrhs
        )

        A_specs = jax.tree.map(lambda l: _leaf_spec(l, n_padded, axis, D), A)
        vec_spec = P(None, axis) if nrhs is not None else P(axis)
        in_specs = (A_specs, vec_spec, vec_spec, *extra_specs)

        def body(A_l, b_l, x0_l, *extras_l):
            from ..solve import _VmappedOperator

            batched = nrhs is not None
            A_use = _VmappedOperator(A_l) if batched else A_l
            kwargs = dict(solver_kwargs)
            i = 0
            if needs_M:
                if M_is_callable:
                    kwargs["M"] = (lambda V: jax.vmap(M)(V)) if batched else M
                else:
                    kwargs["M"] = (
                        _VmappedOperator(extras_l[i]) if batched else extras_l[i]
                    )
                    i += 1
            if needs_bounds:
                kwargs["lower"] = extras_l[i]
                kwargs["upper"] = extras_l[i + 1]
                i += 2
            if takes_key:
                # Decorrelate the shadow-residual draw across shards.
                kwargs["key"] = jax.random.fold_in(extras_l[i], lax.axis_index(axis))
            ctx = [H.distributed(axis, logical_dim=n),
                   H.reduction_dtype(params.reduce_dtype)]
            import contextlib as _cl

            with _cl.ExitStack() as stack:
                for c in ctx:
                    stack.enter_context(c)
                if batched:
                    stack.enter_context(H.batched(nrhs=nrhs))
                return fn(A_use, b_l, x0_l, **kwargs)

        mapped = jax.shard_map(
            body, mesh=mesh, in_specs=in_specs, out_specs=out_specs
        )
        jitted = jax.jit(mapped)
        _SHARDED_JIT_CACHE[cache_key] = jitted
    carry = jitted(A, bp, x0p, *extras)

    x = carry["x"][..., :n]
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


def shard_system(system, *, n_devices: Optional[int] = None, **kw):
    """Convenience: (ShardedSparseOperator, padded-compatible b) from a
    :class:`liblcg_tpu.utils.io.LinearSystem`."""
    if n_devices is None:
        n_devices = len(jax.devices())
    op = ShardedSparseOperator.from_system(system, n_devices=n_devices, **kw)
    return op, jnp.asarray(system.b)


def solve_refined_sharded(
    A,
    b,
    x0=None,
    *,
    method: str = "cg",
    M=None,
    params: SolverParams = DEFAULT_PARAMS,
    inner_dtype=jnp.float32,
    inner_params: Optional[SolverParams] = None,
    max_refinements: int = 8,
    A_low=None,
    M_low=None,
    trace_len: int = 0,
    mesh: Optional[Mesh] = None,
    check: bool = False,
) -> SolveResult:
    """Mixed-precision iterative refinement, SPMD over a device mesh.

    The sharded composition of :func:`liblcg_tpu.solve_refined`: the
    whole outer-correction / inner-engine nest traces inside ONE
    ``jax.shard_map`` with the harness in distributed mode — the
    working-precision residual matvec and the fast-dtype inner solves
    all run on local row shards with ``psum`` reductions, one compiled
    program, no extra host round trips.  ``A`` must be a mesh-aware
    operator (same contract as :func:`solve_sharded`); ``A_low``
    defaults to ``A.astype(inner_dtype)`` (same partitioning, cast
    leaves).  Preconditioners: an operator pytree with shardable leaves
    (cast via ``astype``) or pass ``M_low`` explicitly.

    The reference's mixed-precision analogue (clcg_cudaf.*) is single-
    GPU float storage with no way back to double accuracy; this is f64
    accuracy at f32 throughput on every shard.
    """
    from ..solve import canonical_method
    from ..solvers import refine as R

    m = canonical_method(method)
    if m not in R._INNER_ENGINES:
        raise ValueError(
            f"solve_refined_sharded supports the unconstrained real "
            f"engines {sorted(R._INNER_ENGINES)}; got {m!r}"
        )
    b = jnp.asarray(b)
    if jnp.issubdtype(b.dtype, jnp.complexfloating):
        raise ValueError("solve_refined_sharded is real-domain; realify "
                         "the complex system first")
    fn, needs_M = R._INNER_ENGINES[m]
    if M is not None and not needs_M:
        raise ValueError(f"method {m!r} does not use a preconditioner")
    if needs_M and M is None and M_low is None:
        return SolveResult(
            x=b * 0, status_code=jnp.asarray(
                int(Status.NULL_PRECONDITION_MATRIX), jnp.int32),
            iterations=jnp.asarray(0, jnp.int32),
            residual=jnp.asarray(jnp.nan), trace=None)
    err = params.validate(for_method=m)
    if err is not None:
        return SolveResult(
            x=b * 0, status_code=jnp.asarray(int(err), jnp.int32),
            iterations=jnp.asarray(0, jnp.int32),
            residual=jnp.asarray(jnp.nan), trace=None)

    lo = jnp.dtype(inner_dtype)
    if A_low is None:
        A_low = A.astype(lo)
    M_is_callable = needs_M and M_low is None and not isinstance(
        M, LinearOperator)
    if needs_M and M_low is None:
        if M_is_callable:
            M_low = M          # shard-local callable; applied in lo dtype
        else:
            cast = getattr(M, "astype", None)
            if cast is None:
                raise ValueError(
                    f"{type(M).__name__} has no astype; pass M_low=")
            M_low = cast(lo)
    if inner_params is None:
        inner_params = R._default_inner_params(params, lo)

    axis = A.axis_name
    D = A.n_devices
    n = getattr(A, "n", b.shape[0])
    n_padded = A.n_padded
    if mesh is None:
        mesh = make_mesh(D, axis)
    if mesh.shape[axis] != D:
        raise ValueError(
            f"mesh axis {axis!r} has size {mesh.shape[axis]}, operator "
            f"was partitioned for {D}"
        )

    bp = _pad_to(b, n_padded)
    x0p = (jnp.zeros_like(bp) if x0 is None
           else _pad_to(jnp.asarray(x0, dtype=bp.dtype), n_padded))

    run = R._build_ir(fn, params, inner_params, int(max_refinements),
                      int(trace_len), lo, needs_M)

    extras = []
    extra_specs = []
    if needs_M and not M_is_callable:
        extras.append(M_low)
        extra_specs.append(
            jax.tree.map(lambda l: _leaf_spec(l, n_padded, axis, D), M_low)
        )

    cache_key = (
        "refined", run, axis, D, n, n_padded, mesh,
        M_low if (needs_M and M_is_callable) else None,
        _structure_key(A), _structure_key(A_low),
        tuple(bp.shape), str(bp.dtype),
        tuple(_structure_key(e) for e in extras),
    )
    jitted = _SHARDED_JIT_CACHE.get(cache_key)
    if jitted is None:
        def body(A_l, Al_l, b_l, x0_l, *extras_l):
            args = list(extras_l)
            if needs_M and M_is_callable:
                args = [M_low]
            with H.distributed(axis, logical_dim=n):
                return run(A_l, Al_l, b_l, x0_l, *args)

        A_specs = jax.tree.map(lambda l: _leaf_spec(l, n_padded, axis, D), A)
        Al_specs = jax.tree.map(
            lambda l: _leaf_spec(l, n_padded, axis, D), A_low)
        out_specs = {
            "x": P(axis), "r": P(axis), "res": P(), "k": P(), "total_t": P(),
            "stall": P(), "status": P(), "trace": P(),
        }
        mapped = jax.shard_map(
            body, mesh=mesh,
            in_specs=(A_specs, Al_specs, P(axis), P(axis), *extra_specs),
            out_specs=out_specs,
        )
        jitted = jax.jit(mapped)
        _SHARDED_JIT_CACHE[cache_key] = jitted
    carry = jitted(A, A_low, bp, x0p, *extras)
    result = SolveResult(
        x=carry["x"][..., :n],
        status_code=carry["status"],
        iterations=carry["total_t"],
        residual=carry["res"],
        trace=carry.get("trace"),
    )
    if check:
        from ..utils.errors import check_status

        check_status(result.status_code, raise_error=True, quiet=True)
    return result
