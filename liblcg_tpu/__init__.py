"""liblcg_tpu — a JAX Krylov solver framework.

A from-scratch JAX/XLA re-design with the full capability set of the
reference C++/CUDA library liblcg (YiZhangCUG/liblcg): CG, PCG, CGS,
BiCGSTAB, restarted BiCGSTAB, projected-gradient and spectral-projected-
gradient solvers for real systems; BiCG, symmetric BiCG, CGS, BiCGSTAB,
TFQMR, PCG and PBiCG for complex systems; Jacobi / incomplete-Cholesky /
incomplete-LU / dense-Cholesky preconditioning — plus capabilities the
reference (single-process OpenMP / single GPU) never had:

- hardware-shaped solver variants: pipelined CG (``cgp``), Chronopoulos-
  Gear fused CG (``cgf``), s-step communication-avoiding CG (``cacg``:
  s iterations per basis build + two reduction rounds (an s-fold
  collective reduction vs classic CG's two per iteration)),
  Chebyshev iteration, restarted GMRES(m), MINRES/PMINRES;
- first-class multi-device scaling over a ``jax.sharding.Mesh``
  (``parallel``): row-partitioned/DIA/stencil operators with ppermute
  halos, psum'd reductions, block-Jacobi IC, multi-process execution;
- multi-RHS batched solves (``solve_batched``), composable with sharding,
  plus block CG (``block_cg``/``block_pcg``): all RHS share one block
  Krylov space — fewer iterations, matmul Gram reductions;
- complex systems on complex-less backends via ``realify``.

Design principles (vs. the reference):
- one dtype-polymorphic engine per algorithm instead of 3 duplicated
  backend stacks (native/Eigen/CUDA);
- whole solves compile to a single XLA while-loop — no host-device scalar
  round-trips per iteration (the reference CUDA path syncs 3-4 scalars to
  host every iteration, lcg_cuda.cu:515-532);
- the ``lcg_axfunc_ptr`` callback becomes a ``LinearOperator`` protocol
  (mv/rmv/cmv/hmv) that is a pytree, matrix-free friendly, and shards;
- explicit PRNG keys instead of ``srand(time(0))``;
- solver state is a pytree: suspend/resume/checkpoint by construction.
"""

from .types import (
    DEFAULT_PARAMS,
    SolverParams,
    SolveResult,
    Status,
)
from .operators import (
    BandedOperator,
    DenseOperator,
    LinearOperator,
    MatrixFreeOperator,
    NormalEqOperator,
    ProductOperator,
    ScaledOperator,
    SymScaledOperator,
    RealifiedOperator,
    ScatteredOperator,
    SparseOperator,
    SumOperator,
    aslinearoperator,
    make_sparse_operator,
    merge_complex,
    merge_complex_interleaved,
    realify,
    realify_coo,
    set2box,
    split_complex,
    split_complex_interleaved,
)
from .solve import (
    BATCHED_METHODS,
    BLOCK_METHODS,
    COMPLEX_METHODS,
    REAL_METHODS,
    canonical_method,
    clcg_solver,
    lcg_solver,
    lcg_solver_constrained,
    lcg_solver_preconditioned,
    solve,
    solve_batched,
    solve_sequence,
)
from .solvers.refine import solve_refined, solve_refined_batched
from .solvers.cplx_pairs import (PairJacobi, solve_realified,
                                 solve_realified_batched)
from .solvers.direct import ScatteredDirectSolver, try_scattered_direct
from .precond import (
    ChebyshevPreconditioner,
    JacobiPreconditioner,
    SSORPreconditioner,
    TriangularPreconditioner,
    incomplete_cholesky,
    incomplete_lu,
)
from .solver_class import CLCGSolver, LCGSolver, SolverBase
from .utils.errors import LcgError, check_status, status_message
from .utils.profiling import SolveStats, profile_solve, timed_solve
from .utils import io
from . import parallel
from .parallel import (
    Laplacian3DOperator,
    ShardedStencil3D,
    Stencil3DOperator,
    ShardedLaplacian3D,
    ShardedRealifiedOperator,
    ShardedSparseOperator,
    make_mesh,
    solve_realified_sharded,
    solve_refined_sharded,
    solve_sharded,
)

__version__ = "0.5.0"

__all__ = [
    "DEFAULT_PARAMS",
    "SolverParams",
    "SolveResult",
    "Status",
    "LinearOperator",
    "DenseOperator",
    "ScatteredOperator",
    "SparseOperator",
    "BandedOperator",
    "RealifiedOperator",
    "realify",
    "realify_coo",
    "set2box",
    "split_complex",
    "merge_complex",
    "split_complex_interleaved",
    "merge_complex_interleaved",
    "make_sparse_operator",
    "MatrixFreeOperator",
    "NormalEqOperator",
    "ScaledOperator",
    "SymScaledOperator",
    "SumOperator",
    "ProductOperator",
    "aslinearoperator",
    "solve",
    "solve_refined",
    "solve_refined_batched",
    "solve_realified",
    "solve_realified_batched",
    "PairJacobi",
    "ScatteredDirectSolver",
    "try_scattered_direct",
    "solve_batched",
    "solve_sequence",
    "BATCHED_METHODS",
    "BLOCK_METHODS",
    "lcg_solver",
    "lcg_solver_preconditioned",
    "lcg_solver_constrained",
    "clcg_solver",
    "canonical_method",
    "REAL_METHODS",
    "COMPLEX_METHODS",
    "JacobiPreconditioner",
    "ChebyshevPreconditioner",
    "SSORPreconditioner",
    "TriangularPreconditioner",
    "incomplete_cholesky",
    "incomplete_lu",
    "SolverBase",
    "LCGSolver",
    "CLCGSolver",
    "LcgError",
    "check_status",
    "status_message",
    "SolveStats",
    "timed_solve",
    "profile_solve",
    "io",
    "parallel",
    "ShardedSparseOperator",
    "ShardedRealifiedOperator",
    "ShardedLaplacian3D",
    "Laplacian3DOperator",
    "Stencil3DOperator",
    "ShardedStencil3D",
    "make_mesh",
    "solve_sharded",
    "solve_realified_sharded",
    "solve_refined_sharded",
]
