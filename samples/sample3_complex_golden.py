"""Complex solvers on the shipped case_1K system (reference sample4/sample6):
BICG / BICG_SYM / CGS / TFQMR at epsilon=1e-6 abs_diff, max_diff oracle."""

import _bootstrap  # noqa: F401  (checkout-run import path; no-op when installed)


import jax

# This golden-data parity demo pins the CPU backend up front, so its
# c128 counts compare with the reference binary's host run (env-var
# selection can be preempted by an app that already imported jax, hence
# jax.config).  The same native complex engines run on GPU backends
# (chip_smoke.py phase 6).
# The reference is double precision (c128); without x64 the system loads
# as c64 and the ill-conditioned case_1K stalls short of the 1e-6 bar.
# Both config updates sit in ONE guard: if the backend is already
# initialized (imported from a larger app) we must neither re-pin the
# platform nor mutate the host application's global x64 setting — this
# sample's c128 parity then requires standalone execution.
try:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
except RuntimeError:
    pass  # backend already initialized; run standalone for c128 parity

import numpy as np
import jax.numpy as jnp

import liblcg_tpu as lcg
from liblcg_tpu.utils import io

DATA = "/root/reference/data"


def main():
    sys_ = io.read_system(f"{DATA}/case_1K_cA", complex_values=True)
    answer = io.read_answer(f"{DATA}/case_1K_cB", complex_values=True)
    A = lcg.SparseOperator(sys_.n, sys_.n, sys_.rows, sys_.cols, sys_.vals)
    params = lcg.SolverParams(epsilon=1e-6, abs_diff=1)

    for method in ("bicg", "bicg_sym", "cgs", "tfqmr"):
        res = lcg.solve(A, jnp.asarray(sys_.b), method=method, params=params)
        md = np.max(np.abs(np.asarray(res.x) - answer))
        print(f"{method:10s} {res!r}  max_diff={md:.3e}")

    # Jacobi-preconditioned PCG / PBiCG (sample6.cpp:151-163).
    M = lcg.JacobiPreconditioner(A)
    for method in ("pcg", "pbicg"):
        res = lcg.solve(A, jnp.asarray(sys_.b), method=method, M=M, params=params)
        md = np.max(np.abs(np.asarray(res.x) - answer))
        print(f"{method:10s} {res!r}  max_diff={md:.3e}")


if __name__ == "__main__":
    main()
