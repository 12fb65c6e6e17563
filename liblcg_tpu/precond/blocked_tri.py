"""Blocked banded triangular solve — the matmul-form IC/ILU application.

Sparse triangular substitution is the hard accelerator kernel in this
library (the reference runs it as a sequential row scan,
``preconditioner.cpp:309-366``, or csrsv2 on GPU, sample8.cu:112-118).
The level-scheduled form (:mod:`.triangular`) parallelizes rows within a
dependency level but pays one gather + scatter per level.

For *banded* factors (bandwidth ``w``), substitution is a linear
recurrence that maps onto batched matmuls instead:

- partition rows into ``nb = ceil(n/m)`` blocks of ``m >= w``;
- the diagonal block ``D_k`` is triangular and couples to at most the
  adjacent ``w`` entries of the neighboring block (``C_k``);
- host-side (once, like every factorization here): invert each ``D_k``
  and fold the coupling into ``G_k = D_k^{-1} C_k`` — explicit triangular
  inverses have reference precedent (``lcg_invert_lower_triangle``,
  preconditioner_eigen.cpp:153-223);
- device-side: ``x_k = D_k^{-1} b_k - G_k v_(k∓1)`` where ``v`` is the
  ``w``-wide coupling slice — ONE batched (nb, m, m) x (nb, m) matvec
  plus a ``lax.scan`` of ``nb`` tiny (m, w) matvecs.  No gathers,
  no scatters, static shapes, ~n/m sequential steps instead of the level
  schedule's n_levels.

On case_10K's IC(0) factor (bandwidth 101, 201 levels) this replaces 201
gather rounds per solve with 79 scan steps over matvecs.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import jax.numpy as jnp
from jax import lax
from jax.tree_util import register_pytree_node

from ..operators import LinearOperator


class BlockedTriangular:
    """Device-ready blocked triangular factor T (lower or upper).

    ``dinv`` is ``(nb, m, m)`` — dense inverses of the diagonal blocks;
    ``g`` is ``(nb, m, w)`` — ``D_k^{-1} C_k`` coupling to the previous
    (lower) / next (upper) block's adjacent ``w`` entries.
    """

    def __init__(self, dinv, g, *, lower: bool, n: int, m: int, w: int):
        self.dinv = dinv
        self.g = g
        self.lower = bool(lower)
        self.n = int(n)
        self.m = int(m)
        self.w = int(w)

    @property
    def n_blocks(self) -> int:
        return self.dinv.shape[0]


def _blocked_flatten(f):
    return (f.dinv, f.g), (f.lower, f.n, f.m, f.w)


def _blocked_unflatten(aux, children):
    obj = object.__new__(BlockedTriangular)
    obj.dinv, obj.g = children
    obj.lower, obj.n, obj.m, obj.w = aux
    return obj


register_pytree_node(BlockedTriangular, _blocked_flatten, _blocked_unflatten)


def blocked_schedule(
    n: int, rows, cols, vals, *, lower: bool = True,
    block: Optional[int] = None, dtype=None,
) -> BlockedTriangular:
    """Build a :class:`BlockedTriangular` from COO triplets of a banded
    triangular matrix.

    ``block`` (default: bandwidth rounded up to a multiple of 128, min
    128) must be >= the factor's bandwidth; raises ValueError otherwise —
    wide or unbanded factors should use :func:`.triangular.level_schedule`.
    The diagonal must be fully present and nonzero (the reference's
    ``lcg_full_rank_coo`` contract, preconditioner.cpp:368-381).
    ``dtype`` sets the DEVICE storage dtype (e.g. float32 to halve the
    bytes each apply streams); the block inversions always run host-side
    in f64.
    """
    from scipy.linalg import solve_triangular

    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    vals = np.asarray(vals)
    dt = np.promote_types(vals.dtype, np.float64)
    vals = vals.astype(dt)

    off = (rows - cols) if lower else (cols - rows)
    if len(off) and off.min() < 0:
        side = "lower" if lower else "upper"
        raise ValueError(f"matrix is not {side} triangular")
    w = int(off.max()) if len(off) else 0

    m = int(block) if block is not None else max(128, -(-w // 128) * 128)
    if w > m:
        raise ValueError(
            f"bandwidth {w} exceeds the block size {m}; pass block>= {w} "
            "or use level_schedule for wide factors"
        )
    nb = -(-n // m) if n else 1
    n_pad = nb * m

    diag_mask = rows == cols
    diag = np.zeros(n, dtype=dt)
    diag[rows[diag_mask]] = vals[diag_mask]
    if np.any(diag == 0):
        raise ValueError(
            f"triangular factor is rank deficient: {int(np.sum(diag == 0))} "
            "zero/missing diagonal entries"
        )

    D = np.zeros((nb, m, m), dtype=dt)
    C = np.zeros((nb, m, max(w, 1)), dtype=dt)
    k = rows // m
    lr = rows - k * m
    in_block = (cols >= k * m) & (cols < (k + 1) * m)
    np.add.at(D, (k[in_block], lr[in_block], cols[in_block] - k[in_block] * m),
              vals[in_block])
    ob = ~in_block
    if np.any(ob):
        # Coupling columns: the previous block's trailing w (lower) or the
        # next block's leading w (upper) entries.
        base = (k[ob] * m - w) if lower else ((k[ob] + 1) * m)
        cc = cols[ob] - base
        assert cc.min() >= 0 and cc.max() < w
        np.add.at(C, (k[ob], lr[ob], cc), vals[ob])
    # Unit diagonal on padding rows (their b is zero; they never couple in).
    for i in range(n, n_pad):
        D[i // m, i - (i // m) * m, i - (i // m) * m] = 1.0

    eye = np.eye(m, dtype=dt)
    dinv = np.stack([solve_triangular(D[j], eye, lower=lower)
                     for j in range(nb)])
    g = np.einsum("kij,kjw->kiw", dinv, C)
    sd = np.dtype(dtype) if dtype is not None else dt
    return BlockedTriangular(jnp.asarray(dinv.astype(sd)),
                             jnp.asarray(g.astype(sd)),
                             lower=lower, n=n, m=m, w=w)


#: Sequential-scan cutoff: below this many blocks the lax.scan form wins
#: (the parallel form's log2(nb) batched rounds carry fixed launch cost).
_ASSOC_MIN_BLOCKS = 32


def blocked_triangular_solve(fac: BlockedTriangular, b: jnp.ndarray,
                             parallel: Optional[bool] = None):
    """Solve ``T x = b`` for the blocked factor T.

    Two device forms:

    - sequential: a ``lax.scan`` of nb tiny coupled matvecs — fine for
      few blocks, but nb launch-bound steps make large-n applies
      scan-depth-bound;
    - parallel (default for nb >= 32): the coupling recurrence
      ``v_k = A_k v_(k-1) + c_k`` is affine, so ALL couplings come from
      one ``lax.associative_scan`` over (w, w) affine maps — ceil(log2
      nb) rounds of batched matmuls instead of nb sequential steps
      (the parallel-prefix / cyclic-reduction form of banded
      substitution, done the XLA way).

    Both forms are exact (Precision.HIGHEST on every matmul — a default
    f32 matmul may multiply in TF32 on GPUs).
    """
    n, m, w = fac.n, fac.m, fac.w
    nb = fac.n_blocks
    dt = jnp.promote_types(b.dtype, fac.dinv.dtype)
    bp = jnp.zeros((nb * m,), dt).at[:n].set(b.astype(dt)).reshape(nb, m)
    hp = lax.Precision.HIGHEST
    db = jnp.einsum("kij,kj->ki", fac.dinv.astype(dt), bp, precision=hp)
    if w == 0:
        return db.reshape(-1)[:n]

    G = fac.g.astype(dt)
    if parallel is None:
        parallel = nb >= _ASSOC_MIN_BLOCKS

    if not parallel:
        def step(v, inp):
            db_k, g_k = inp
            x_k = db_k - jnp.matmul(g_k, v, precision=hp)
            v_next = x_k[m - w:] if fac.lower else x_k[:w]
            return v_next, x_k

        v0 = jnp.zeros((fac.g.shape[-1],), dt)
        _, xs = lax.scan(step, v0, (db, G), reverse=not fac.lower)
        return xs.reshape(-1)[:n]

    # Parallel-prefix form.  v_k = A_k v_(k-1) + c_k where A_k is the
    # coupling-slice of -G_k and c_k the same slice of db_k; compose the
    # affine maps with an inclusive associative scan, then recover every
    # block in ONE batched matvec.
    if fac.lower:
        A = -G[:, m - w:, :]
        c = db[:, m - w:]
    else:
        A = -G[:, :w, :]
        c = db[:, :w]
        A, c = A[::-1], c[::-1]

    def combine(left, right):
        A1, c1 = left
        A2, c2 = right
        return (jnp.einsum("...ij,...jk->...ik", A2, A1, precision=hp),
                jnp.einsum("...ij,...j->...i", A2, c1, precision=hp) + c2)

    _, v = lax.associative_scan(combine, (A, c))
    if not fac.lower:
        v = v[::-1]
    zero = jnp.zeros((1, w), dt)
    vprev = (jnp.concatenate([zero, v[:-1]], axis=0) if fac.lower
             else jnp.concatenate([v[1:], zero], axis=0))
    x = db - jnp.einsum("kmw,kw->km", G, vprev, precision=hp)
    return x.reshape(-1)[:n]


class BlockedTriangularPreconditioner(LinearOperator):
    """``M^{-1} x = U^{-1} (D?) L^{-1} x`` from blocked factors — the
    matmul form of :class:`.triangular.TriangularPreconditioner`, same
    reference contract (the IC/ILU ``MxProduct`` callback,
    sample7.cpp:107-108, sample8.cu:112-118)."""

    def __init__(
        self,
        lower: BlockedTriangular,
        upper: BlockedTriangular,
        mid_scale=None,
    ):
        self.lower = lower
        self.upper = upper
        self.mid_scale = None if mid_scale is None else jnp.asarray(mid_scale)
        n = lower.n
        self.shape = (n, n)
        self.dtype = lower.dinv.dtype

    def mv(self, x):
        y = blocked_triangular_solve(self.lower, x)
        if self.mid_scale is not None:
            y = y * self.mid_scale
        return blocked_triangular_solve(self.upper, y)


def _btp_flatten(op):
    return (op.lower, op.upper, op.mid_scale), None


def _btp_unflatten(_, children):
    obj = object.__new__(BlockedTriangularPreconditioner)
    obj.lower, obj.upper, obj.mid_scale = children
    try:
        n = obj.lower.n
        obj.shape = (n, n)
        obj.dtype = obj.lower.dinv.dtype
    except (AttributeError, TypeError):
        obj.shape = None
        obj.dtype = None
    return obj


register_pytree_node(
    BlockedTriangularPreconditioner, _btp_flatten, _btp_unflatten
)
