"""Exact direct solve for diagonal-plus-scattered systems (Woodbury).

The reference's shipped complex 10K workload (data/case_10K_cA, driven by
sample6.cpp:151-195 and sample10.cu:193-273) is a diagonal matrix plus
200 scattered symmetric off-diagonal entries touching k=198 distinct
indices — i.e. ``A = D + P S P^T`` with a tiny k×k coupling block S.
The reference iterates 450+ times on it; the right algorithm is a ONE
k×k dense solve:

    A x = b  ⇔  (I_k + D_J^{-1} S) y = (D^{-1} b)_J,
               x = D^{-1} b - D^{-1} P (S y)

(derived by eliminating x = D^{-1}(b - P S P^T x) and taking the J-rows).
Exact in one pass, O(nnz + k^3) — at k=198 that is microseconds on host.

``ScatteredDirectSolver`` factorizes once on host (LU of the k×k block,
like the host-factorize/device-apply split the reference itself uses for
CUDA IC, preconditioner_cuda.cu) and then solves any right-hand side with
O(nnz + k^2) work.  Works for real and complex systems; complex systems
solve in host numpy complex arithmetic (n + k^2 work is far below the
cost of a device dispatch).

This is a capability beyond the reference (no direct methods exist there);
it slots into PARITY.md's complex decision tree as case 0.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..types import SolveResult, Status


def scattered_split(n: int, rows, cols, vals):
    """Split a COO matrix into (diag, off_rows, off_cols, off_vals); raises
    if any diagonal entry is missing (the Woodbury form needs D invertible;
    a zero/absent diagonal should go to the iterative paths instead)."""
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    vals = np.asarray(vals)
    isdiag = rows == cols
    diag = np.zeros(n, dtype=vals.dtype)
    # add.at, not fancy-index assignment: duplicate COO entries must SUM
    # (the SparseOperator/BandedOperator convention; plain assignment
    # last-write-wins and silently corrupts FEM-style assembled input).
    np.add.at(diag, rows[isdiag], vals[isdiag])
    if np.any(diag == 0):
        missing = int(np.sum(diag == 0))
        raise ValueError(
            f"{missing} zero/missing diagonal entries; the "
            f"diagonal-plus-scattered direct solve needs an invertible D"
        )
    return diag, rows[~isdiag], cols[~isdiag], vals[~isdiag]


class ScatteredDirectSolver:
    """Host-factorized exact solver for ``A = D + scattered off-diagonals``.

    Parameters: the COO triplet of the FULL matrix (diagonal included).
    ``max_coupled`` guards against accidentally densifying a matrix that
    is not actually scattered (k beyond it raises).
    """

    def __init__(self, n: int, rows, cols, vals, *, max_coupled: int = 4096):
        import scipy.linalg as sla  # SciPy ships with the baked-in stack

        diag, orow, ocol, oval = scattered_split(n, rows, cols, vals)
        J = np.unique(np.concatenate([orow, ocol]))
        k = len(J)
        if k > max_coupled:
            raise ValueError(
                f"{k} coupled indices exceed max_coupled={max_coupled}; "
                f"this matrix is not diagonal-plus-scattered — use an "
                f"iterative method"
            )
        self.n = int(n)
        self.k = int(k)
        self.diag = diag
        self.J = J
        pos = np.full(n, -1, dtype=np.int64)
        pos[J] = np.arange(k)
        # Dense k x k coupling block S (off-diagonal values only);
        # add.at so duplicate COO entries sum.
        S = np.zeros((k, k), dtype=vals.dtype)
        np.add.at(S, (pos[orow], pos[ocol]), oval)
        self.S = S
        # T = I_k + D_J^{-1} S, LU-factorized once.
        T = np.eye(k, dtype=vals.dtype) + (S / diag[J][:, None])
        self._lu = sla.lu_factor(T)
        self._sla = sla

    def solve(self, b) -> SolveResult:
        """Exact solution of ``A x = b`` (host numpy; one k×k back-solve)."""
        b = np.asarray(b)
        xd = b / self.diag
        y = self._sla.lu_solve(self._lu, xd[self.J])
        x = xd.copy()
        x[self.J] -= (self.S @ y) / self.diag[self.J]
        # Exact residual for the reported metric (reference relative rule).
        r = b - self._matvec(x)
        r_sq = float(np.real(np.vdot(r, r)))
        x_sq = float(np.real(np.vdot(x, x)))
        res = r_sq / max(x_sq, 1.0)
        if np.iscomplexobj(b):
            res = res * res  # complex metric squares the squared norm
        return SolveResult(
            x=x,
            status_code=np.int32(int(Status.CONVERGENCE)),
            iterations=np.int32(1),
            residual=np.float64(res),
            trace=None,
        )

    def _matvec(self, x):
        y = self.diag * x
        # Scatter-add the coupling block's contribution.
        y[self.J] += self.S @ x[self.J]
        return y


def try_scattered_direct(n: int, rows, cols, vals, *,
                         max_coupled: int = 4096
                         ) -> Optional[ScatteredDirectSolver]:
    """Build a ScatteredDirectSolver when the pattern qualifies, else None
    (missing diagonal or too many coupled indices)."""
    try:
        return ScatteredDirectSolver(n, rows, cols, vals,
                                     max_coupled=max_coupled)
    except ValueError:
        return None
