"""The reference's flagship complex workload, three ways.

Reference counterpart: sample6.cpp (Eigen complex sparse, Jacobi-PCG /
PBiCG on data/case_10K_cA at eps=1e-6 abs_diff) and sample10.cu (the
same system on GPU).  Every path below runs without complex device
dtypes — three ways, fastest first:

1. ``ScatteredDirectSolver`` — the system is a diagonal plus 200
   scattered symmetric couplings (k=198 coupled indices), so one exact
   Woodbury solve through the k×k coupling block answers it at
   machine precision (the reference iterates 450 times).
2. ``solve_realified`` — the reference's OWN algorithms (Jacobi-PCG,
   BiCG-sym, ...) in real [re; im]-pair arithmetic: iteration-count
   parity with the reference binary, entirely on the accelerator.
3. The shipped answer check (data/case_10K_cB), the sample6 oracle.

Runs on any backend (CPU included).
"""

import _bootstrap  # noqa: F401  (checkout-run import path; no-op when installed)

import time

import numpy as np
import jax

# The reference is double precision; without x64 the pair arithmetic
# truncates to f32 and this ill-conditioned system needs ~6x the
# iterations (solve_realified warns).  Irrelevant for the direct path,
# which runs on host.
jax.config.update("jax_enable_x64", True)

import liblcg_tpu as lcg
from liblcg_tpu.utils import io

DATA = "/root/reference/data"


def main():
    sys_ = io.read_system(f"{DATA}/case_10K_cA", complex_values=True)
    answer = io.read_answer(f"{DATA}/case_10K_cB", complex_values=True)
    b = np.asarray(sys_.b)
    print(f"case_10K_cA: n={sys_.n}, nnz={len(sys_.rows)} "
          f"(diagonal + {len(sys_.rows) - sys_.n} scattered couplings)")

    # 1) exact direct (Woodbury through the coupling block) ----------------
    t0 = time.perf_counter()
    D = lcg.ScatteredDirectSolver(sys_.n, sys_.rows, sys_.cols, sys_.vals)
    t_factor = time.perf_counter() - t0
    res = D.solve(b)
    t0 = time.perf_counter()
    res = D.solve(b)
    t_solve = time.perf_counter() - t0
    md = float(np.max(np.abs(res.x - answer)))
    print(f"direct (k={D.k}): factor {t_factor * 1e3:.1f} ms, "
          f"solve {t_solve * 1e3:.3f} ms, max_diff {md:.2e}")

    # 2) the reference's own methods, pair-complex form --------------------
    A = lcg.ScatteredOperator(sys_.n, sys_.rows, sys_.cols, sys_.vals)
    params = lcg.SolverParams(epsilon=1e-6, abs_diff=1)
    for method, kw in (("pcg", dict(M="jacobi")),       # sample6.cpp:151-163
                       ("bicg_sym", {}),                # sample6's method set
                       ("pbicg", dict(M="jacobi"))):
        r = lcg.solve_realified(A, b, method=method, params=params, **kw)
        md = float(np.max(np.abs(r.x - answer)))
        r2 = lcg.solve_realified(A, b, method=method, params=params, **kw)
        t0 = time.perf_counter()
        r2 = lcg.solve_realified(A, b, method=method, params=params, **kw)
        wall = time.perf_counter() - t0
        print(f"pairs {method:9s}: {int(r.iterations):4d} iterations, "
              f"{wall * 1e3:7.1f} ms wall, max_diff {md:.2e}  "
              f"[{lcg.Status(int(r.status_code)).name}]")

    print("(reference binary on this host: bicg_sym 450 iterations, "
          "66.8 ms best — bench_baseline.json)")


if __name__ == "__main__":
    main()
