"""Host-side incomplete factorizations: IC(0)/ICT and ILU(0)/ILUT.

The reference computes these factorizations sequentially on the host (native
COO IC: ``preconditioner.cpp:42-307``; Eigen sparse IC/ILU with a per-row
``fill`` cap: ``preconditioner_eigen.cpp:334-923``; even the CUDA backend
factorizes complex IC on host, ``preconditioner_cuda.cu:40-278``) and applies
them as triangular solves.  We keep that split: factorization is inherently
sequential per row -> numpy on host, once; application is level-scheduled on
device (see ``triangular.py``).

``fill`` semantics follow the reference's Eigen API
(preconditioner_eigen.h:90-119): 0 keeps the full pattern that arises (no
dropping); fill > 0 caps each factor row at ``fill`` off-diagonal entries,
keeping the largest magnitudes.

Complex matrices use the *unconjugated* symmetric factorization A = L L^T
with complex sqrt — matching ``clcg_Cholesky``'s convention
(preconditioner_eigen.cpp:96-151) and sample7's ``u_tri = l_tri.transpose()``
(sample7.cpp:161-162).
"""

from __future__ import annotations

import heapq
from typing import NamedTuple, Tuple

import numpy as np

from .triangular import TriangularPreconditioner, level_schedule


def _coo_from_operator(A) -> Tuple[int, np.ndarray, np.ndarray, np.ndarray]:
    """Extract host COO triplets from a SparseOperator / dense array."""
    if hasattr(A, "coo"):  # _RawCoo passthrough
        return A.coo
    if hasattr(A, "ell_cols"):  # SparseOperator
        cols = np.asarray(A.ell_cols)
        vals = np.asarray(A.ell_vals)
        n = A.shape[0]
        r = np.repeat(np.arange(cols.shape[0]), cols.shape[1])
        c = cols.ravel()
        v = vals.ravel()
        keep = v != 0
        return n, r[keep].astype(np.int64), c[keep].astype(np.int64), v[keep]
    if hasattr(A, "diag_vals"):  # BandedOperator (DIA storage)
        n = A.shape[0]
        dv = np.asarray(A.diag_vals)            # (n_diags, n)
        rs, cs, vs = [], [], []
        for d, o in enumerate(A.offsets):
            rows = np.arange(max(0, -o), min(n, n - o))
            v = dv[d, rows]
            keep = v != 0
            rs.append(rows[keep])
            cs.append(rows[keep] + o)
            vs.append(v[keep])
        return (n, np.concatenate(rs).astype(np.int64),
                np.concatenate(cs).astype(np.int64), np.concatenate(vs))
    arr = np.asarray(A if not hasattr(A, "A") else A.A)
    rr, cc = np.nonzero(arr)
    return arr.shape[0], rr, cc, arr[rr, cc]


class IncompleteFactorization(NamedTuple):
    """Raw factor triplets plus ready-to-use device schedules."""

    n: int
    l_rows: np.ndarray
    l_cols: np.ndarray
    l_vals: np.ndarray
    u_rows: np.ndarray
    u_cols: np.ndarray
    u_vals: np.ndarray

    def preconditioner(self, mode: str = "auto", block=None, dtype=None):
        """Application operator for the factorization (the ``MxProduct``
        callback the reference's samples build, sample7.cpp:107-108).

        ``mode="blocked"`` uses the matmul-form blocked banded solve
        (:mod:`.blocked_tri` — no gathers, ~n/block sequential steps);
        ``"levels"`` the level-scheduled gather form; ``"auto"`` picks
        blocked for banded factors (bandwidth <= 1024) and levels
        otherwise.  ``dtype`` (blocked mode) sets device storage — pass
        float32 to halve the bytes each apply streams.
        """
        if mode not in ("auto", "blocked", "levels"):
            raise ValueError(f"mode must be auto/blocked/levels, got {mode!r}")
        if mode != "levels":
            off = self.l_rows - self.l_cols
            w = int(off.max()) if len(off) else 0
            # auto takes the blocked (matmul) form only when its dense
            # block-diagonal storage is sane: device memory is O(n * m)
            # and the host factor-inversion work O((n/m) * m^3) for block
            # size m ~ bandwidth.  A wide band on a large n (e.g. a
            # 1000-wide 2-D grid ordering at n=1e6) would silently cost
            # gigabytes / minutes — fall back to the level-scheduled form
            # there; mode="blocked" still forces it for callers who know.
            # blocked_schedule's default block: bandwidth rounded up to a
            # multiple of 128, min 128.
            m_eff = max(((max(w, 1) + 127) // 128) * 128, 128)
            sane = (self.n * m_eff * 8 <= 256 * 1024 * 1024
                    and (self.n / m_eff) * m_eff ** 3 <= 5e10)
            if mode == "blocked" or (w <= 1024 and sane):
                from .blocked_tri import (
                    BlockedTriangularPreconditioner,
                    blocked_schedule,
                )

                lower = blocked_schedule(self.n, self.l_rows, self.l_cols,
                                         self.l_vals, lower=True, block=block,
                                         dtype=dtype)
                upper = blocked_schedule(self.n, self.u_rows, self.u_cols,
                                         self.u_vals, lower=False, block=block,
                                         dtype=dtype)
                return BlockedTriangularPreconditioner(lower, upper)
        lower = level_schedule(self.n, self.l_rows, self.l_cols, self.l_vals, lower=True)
        upper = level_schedule(self.n, self.u_rows, self.u_cols, self.u_vals, lower=False)
        return TriangularPreconditioner(lower, upper)


def _rows_to_coo(rows_list, diag=None):
    rr, cc, vv = [], [], []
    for i, row in enumerate(rows_list):
        for j, v in row.items():
            rr.append(i)
            cc.append(j)
            vv.append(v)
        if diag is not None:
            rr.append(i)
            cc.append(i)
            vv.append(diag[i])
    return (
        np.asarray(rr, dtype=np.int64),
        np.asarray(cc, dtype=np.int64),
        np.asarray(vv),
    )


def incomplete_cholesky_coo(n, rows, cols, vals,
                            fill: int = 0) -> IncompleteFactorization:
    """IC(0)/ICT directly from COO triplets (see :func:`incomplete_cholesky`)."""
    return incomplete_cholesky(
        _RawCoo(n, np.asarray(rows), np.asarray(cols), np.asarray(vals)),
        fill=fill,
    )


class _RawCoo:
    """COO carrier recognised by ``_coo_from_operator``."""

    def __init__(self, n, rows, cols, vals):
        self.coo = (int(n), rows.astype(np.int64), cols.astype(np.int64), vals)


def incomplete_cholesky(A, fill: int = 0) -> IncompleteFactorization:
    """Incomplete Cholesky A ~= L L^T (unconjugated for complex symmetric).

    ``fill=0`` restricts the factor to A's lower-triangle pattern (IC(0),
    the native reference algorithm preconditioner.cpp:42-156); ``fill>0``
    admits fill-in but keeps only the ``fill`` largest off-diagonal entries
    per row (the Eigen ICT behaviour, preconditioner_eigen.cpp:334-431).
    """
    n, r, c, v = _coo_from_operator(A)
    lower_mask = r >= c
    r, c, v = r[lower_mask], c[lower_mask], v[lower_mask]
    order = np.lexsort((c, r))
    r, c, v = r[order], c[order], v[order]
    starts = np.searchsorted(r, np.arange(n + 1))

    # Native C++ fast path (falls through to pure Python when no toolchain).
    from .. import native

    nat = native.ic_factorize(n, r, c, v, fill)
    if nat is not None:
        lr, lc, lv = nat
        return IncompleteFactorization(
            n=n, l_rows=lr, l_cols=lc, l_vals=lv,
            u_rows=lc.copy(), u_cols=lr.copy(), u_vals=lv.copy(),
        )

    is_complex = np.iscomplexobj(v)
    dt = v.dtype
    allow_fill = fill > 0

    l_rows = []          # row i -> {col: val}, strictly lower part
    l_diag = np.zeros(n, dtype=dt)
    cols_of = [[] for _ in range(n)]  # p -> [(j, L[j,p])], built as rows finish

    for i in range(n):
        w = {}
        a_ii = None
        for idx in range(starts[i], starts[i + 1]):
            j = int(c[idx])
            if j == i:
                a_ii = v[idx] if a_ii is None else a_ii + v[idx]
            else:
                w[j] = w.get(j, 0) + v[idx]
        if a_ii is None:
            a_ii = 0.0

        heap = list(w.keys())
        heapq.heapify(heap)
        seen = set(w.keys())
        while heap:
            p = heapq.heappop(heap)
            wp = w[p] / l_diag[p]
            w[p] = wp
            if wp == 0:
                continue
            for (j, Ljp) in cols_of[p]:
                if j >= i:
                    continue
                if j in w:
                    w[j] -= wp * Ljp
                elif allow_fill:
                    w[j] = -wp * Ljp
                    if j not in seen:
                        heapq.heappush(heap, j)
                        seen.add(j)

        if allow_fill and len(w) > fill:
            kept = heapq.nlargest(fill, w.items(), key=lambda kv: abs(kv[1]))
            w = dict(kept)

        sq = a_ii - sum(val * val for val in w.values())
        if is_complex:
            d = np.sqrt(complex(sq))
        else:
            if sq <= 0:
                raise ValueError(
                    f"incomplete Cholesky breakdown at row {i}: pivot {sq!r}"
                )
            d = np.sqrt(sq)
        l_diag[i] = d
        l_rows.append(w)
        for j, val in w.items():
            cols_of[j].append((i, val))

    lr, lc, lv = _rows_to_coo(l_rows, diag=l_diag)
    return IncompleteFactorization(
        n=n,
        l_rows=lr,
        l_cols=lc,
        l_vals=lv,
        u_rows=lc.copy(),
        u_cols=lr.copy(),
        u_vals=lv.copy(),  # U = L^T (unconjugated), sample7.cpp:161-162
    )


def incomplete_lu(A, fill: int = 0) -> IncompleteFactorization:
    """Incomplete LU A ~= L U with unit lower diagonal (Saad IKJ variant).

    ``fill=0`` = ILU(0) on A's pattern; ``fill>0`` = ILUT keeping the
    ``fill`` largest entries per factor row.  Reference: Eigen
    ``lcg_incomplete_LU`` (preconditioner_eigen.cpp:600-744) and the
    cusparse ILU sample (sample11.cu:219-244).
    """
    n, r, c, v = _coo_from_operator(A)
    order = np.lexsort((c, r))
    r, c, v = r[order], c[order], v[order]
    starts = np.searchsorted(r, np.arange(n + 1))

    from .. import native

    nat = native.ilu_factorize(n, r, c, v, fill)
    if nat is not None:
        lr, lc, lv, ur, uc, uv = nat
        return IncompleteFactorization(
            n=n, l_rows=lr, l_cols=lc, l_vals=lv,
            u_rows=ur, u_cols=uc, u_vals=uv,
        )

    dt = v.dtype
    allow_fill = fill > 0

    l_rows = []                       # strictly lower, unit diag implied
    u_rows = []                       # including diagonal
    u_diag = np.zeros(n, dtype=dt)

    for i in range(n):
        w = {}
        for idx in range(starts[i], starts[i + 1]):
            j = int(c[idx])
            w[j] = w.get(j, 0) + v[idx]

        heap = [j for j in w if j < i]
        heapq.heapify(heap)
        seen = set(heap)
        while heap:
            k = heapq.heappop(heap)
            wk = w[k] / u_diag[k]
            w[k] = wk
            if wk == 0:
                continue
            for j, Ukj in u_rows[k].items():
                if j <= k:
                    continue
                if j in w:
                    w[j] -= wk * Ukj
                elif allow_fill:
                    w[j] = -wk * Ukj
                    if j < i and j not in seen:
                        heapq.heappush(heap, j)
                        seen.add(j)

        l_part = {j: val for j, val in w.items() if j < i}
        u_part = {j: val for j, val in w.items() if j > i}
        if i not in w or w[i] == 0:
            raise ValueError(f"incomplete LU breakdown: zero pivot at row {i}")
        u_diag[i] = w[i]

        if allow_fill:
            if len(l_part) > fill:
                l_part = dict(
                    heapq.nlargest(fill, l_part.items(), key=lambda kv: abs(kv[1]))
                )
            if len(u_part) > fill:
                u_part = dict(
                    heapq.nlargest(fill, u_part.items(), key=lambda kv: abs(kv[1]))
                )

        l_rows.append(l_part)
        u_full = dict(u_part)
        u_full[i] = u_diag[i]
        u_rows.append(u_full)

    ones = np.ones(n, dtype=dt)
    lr, lc, lv = _rows_to_coo(l_rows, diag=ones)
    ur, uc, uv = _rows_to_coo(u_rows, diag=None)
    return IncompleteFactorization(
        n=n, l_rows=lr, l_cols=lc, l_vals=lv, u_rows=ur, u_cols=uc, u_vals=uv
    )
