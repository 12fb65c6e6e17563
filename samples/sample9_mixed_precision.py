"""Mixed-precision iterative refinement: f64 accuracy at ~f32 speed.

The reference's mixed-precision story is a float copy of the complex
library (``src/lib/clcg_cudaf.h/.cu`` — float storage, no way back to
double accuracy).  Where f64 costs more than f32 (twice the bytes per
vector in a bandwidth-bound solve), the answer is classical iterative
refinement (``solve_refined``): f32 inner solves + f64 residual
correction, the whole nest compiled as one XLA program.

Demonstrates, on the shipped ``data/case_10K`` system and a 3-D
Laplacian:

1. a deep tolerance (ε=1e-24 on the squared-norm metric ~ 1e-12
   relative residual) that f32 alone cannot certify;
2. ``solve_refined`` reaching it with f32-only inner iterations —
   compare ``iterations`` (total inner f32) against the pure-f64 solve;
3. the preconditioned variant (``method="pcg"`` + Jacobi, cast to the
   inner dtype automatically);
4. the refinement trace: one outer-residual entry per refinement.

"""

import _bootstrap  # noqa: F401  (checkout-run import path)

import sys

import numpy as np
import jax

if "--cpu" in sys.argv:
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp

import liblcg_tpu as lcg
from liblcg_tpu.utils import io

DATA = "/root/reference/data"
EPS_DEEP = 1e-24   # squared-norm ratio ~ ||r||/||x|| ~ 1e-12


def main():
    jax.config.update("jax_enable_x64", True)
    print(f"backend: {jax.devices()[0]}")

    # -- 1/2: case_10K to f64 depth from f32 inner solves -----------------
    s = io.read_system(f"{DATA}/case_10K_A")
    answer = io.read_answer(f"{DATA}/case_10K_B")
    A = lcg.make_sparse_operator(s.n, s.n, s.rows, s.cols, s.vals)  # f64 DIA
    b = jnp.asarray(s.b)

    r64 = lcg.solve(A, b, method="cg",
                    params=lcg.SolverParams(epsilon=EPS_DEEP,
                                            max_iterations=2000))
    r_ir = lcg.solve_refined(A, b, params=lcg.SolverParams(epsilon=EPS_DEEP),
                             trace_len=8)
    tr = np.asarray(r_ir.trace)
    err = float(np.mean(np.abs(np.asarray(r_ir.x) - answer)))
    print(f"pure f64 CG : {int(r64.iterations)} f64 iterations")
    print(f"refined     : {int(r_ir.iterations)} f32 inner iterations, "
          f"{int(np.count_nonzero(tr))} refinements, residual "
          f"{float(r_ir.residual):.2e}, err vs answer {err:.2e}")
    print(f"trace       : {tr[:int(np.count_nonzero(tr))]}")

    # -- 3: preconditioned inner engine -----------------------------------
    M = lcg.JacobiPreconditioner(A)   # f64; cast to f32 automatically
    r_pir = lcg.solve_refined(A, b, method="pcg", M=M,
                              params=lcg.SolverParams(epsilon=EPS_DEEP))
    print(f"refined pcg : {int(r_pir.iterations)} f32 inner iterations, "
          f"residual {float(r_pir.residual):.2e}")

    # -- 4: f32 alone cannot certify this tolerance ------------------------
    A32 = A.astype(jnp.float32)
    r32 = lcg.solve(A32, jnp.asarray(s.b, jnp.float32),
                    params=lcg.SolverParams(epsilon=EPS_DEEP,
                                            max_iterations=2000))
    x32 = np.asarray(r32.x, np.float64)
    rr = np.asarray(s.b) - np.asarray(A.mv(jnp.asarray(x32)))
    true_metric = float(np.sum(rr ** 2) / max(np.sum(x32 ** 2), 1.0))
    print(f"f32-only    : claimed residual {float(r32.residual):.2e}, TRUE "
          f"residual {true_metric:.2e} (stuck at the f32 floor — the point)")

    assert bool(r_ir.converged) and bool(r_pir.converged)
    print("OK")


if __name__ == "__main__":
    main()
