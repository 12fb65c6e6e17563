"""Weak-scaling demonstration: the BASELINE.md north-star workload.

Sweeps mesh sizes on the 3-D 7-point Laplacian with the grid growing
proportionally (constant work per device) and reports nnz/s and parallel
efficiency.  On real hardware the mesh axis spans the GPUs of a host and,
via ``initialize_distributed``, several hosts; on a development machine
run with virtual CPU devices:

    python samples/sample6_weak_scaling.py --virtual   # 8 CPU devices

Note: on virtual CPU devices the "efficiency" measures the SPMD machinery's
overhead, not real interconnect bandwidth — the point here is that the same
compiled program scales the mesh without code changes.
"""

import _bootstrap  # noqa: F401  (checkout-run import path; no-op when installed)


import sys
import time

import numpy as np
import jax


def main():
    if "--virtual" in sys.argv:
        # Must happen before any backend initialization.
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", 8)

    import jax.numpy as jnp
    import liblcg_tpu as lcg
    from liblcg_tpu.parallel import ShardedLaplacian3D, make_mesh, solve_sharded

    max_d = len(jax.devices())
    nz_per, ny, nx = 16, 64, 64
    iters = 30
    params = lcg.SolverParams(epsilon=1e-30, max_iterations=iters)

    base_rate = None
    print(f"devices  grid              nnz/s        efficiency")
    d = 1
    while d <= max_d:
        nz = nz_per * d
        S = ShardedLaplacian3D(nz, ny, nx, n_devices=d, dtype=jnp.float32)
        b = np.ones(nz * ny * nx, dtype=np.float32)
        mesh = make_mesh(d)
        res = solve_sharded(S, b, mesh=mesh, params=params)
        np.asarray(res.x[:4])
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            res = solve_sharded(S, b, mesh=mesh, params=params)
            np.asarray(res.x[:4])
            best = min(best, time.perf_counter() - t0)
        rate = S.nnz * iters / best
        if base_rate is None:
            base_rate = rate
        eff = rate / (base_rate * d)
        print(f"{d:7d}  {nz:4d}x{ny}x{nx:<6d}  {rate:.3e}  {eff:6.1%}")
        d *= 2


if __name__ == "__main__":
    main()
