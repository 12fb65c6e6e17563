"""Multi-device / multi-host scaling layer.

The reference library has **no distributed code whatsoever** (SURVEY §2.9:
no MPI/NCCL/sockets anywhere in the tree; parallelism is OpenMP threads or a
single GPU).  This package is the new first-class component this library
adds: solves run as SPMD programs over a ``jax.sharding.Mesh``, with

- the operator row-partitioned over the mesh (``ShardedSparseOperator``) or
  domain-decomposed (``ShardedLaplacian3D``),
- the solution/residual/direction vectors carried as local shards inside one
  compiled ``lax.while_loop``,
- per-iteration dot products reduced with ``lax.psum`` (adjacent
  reductions coalesce into one collective),
- operator communication as ``all_gather`` (general sparsity) or one-hop
  ``ppermute`` halo exchange (banded sparsity / stencils), overlapped with
  local compute by the XLA scheduler.

Every solver in :mod:`liblcg_tpu.solvers` works unchanged: the engines'
reductions are mesh-aware through :func:`harness.distributed`.
"""

from .mesh import make_mesh, initialize_distributed
from .sharded import ShardedBandedOperator, ShardedSparseOperator
from .stencil import (
    Laplacian3DOperator,
    ShardedLaplacian3D,
    ShardedStencil3D,
    Stencil3DOperator,
)
from .api import solve_refined_sharded, solve_sharded, shard_system
from .block_jacobi import BlockJacobiPreconditioner
from .realified import (
    ShardedRealifiedOperator,
    pack_pairs,
    solve_realified_sharded,
    unpack_pairs,
)

__all__ = [
    "make_mesh",
    "initialize_distributed",
    "ShardedSparseOperator",
    "ShardedBandedOperator",
    "ShardedRealifiedOperator",
    "solve_realified_sharded",
    "pack_pairs",
    "unpack_pairs",
    "Laplacian3DOperator",
    "ShardedLaplacian3D",
    "Stencil3DOperator",
    "ShardedStencil3D",
    "solve_sharded",
    "solve_refined_sharded",
    "BlockJacobiPreconditioner",
    "shard_system",
]
