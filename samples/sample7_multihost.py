"""Multi-process (multi-host-style) SPMD solve via ``jax.distributed``.

Each process owns a slice of the global device mesh; the solver mesh spans
all of them and the per-iteration psums ride the inter-process transport
(the network between hosts on a real cluster).  Run with no arguments to launch a 2-process demo on
CPU (4 virtual devices per process, 8-device global mesh):

    python samples/sample7_multihost.py

or launch workers manually on real hosts:

    python samples/sample7_multihost.py --worker <pid> <nprocs> <coord_ip:port>
"""

import _bootstrap  # noqa: F401  (checkout-run import path; no-op when installed)

import os
import subprocess
import sys


def worker(process_id: int, num_processes: int, coordinator: str) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 4)
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )

    import numpy as np
    import liblcg_tpu as lcg
    from liblcg_tpu.parallel import ShardedBandedOperator, make_mesh, solve_sharded

    D = len(jax.devices())
    if process_id == 0:
        print(f"global devices: {D} across {num_processes} processes")

    rng = np.random.default_rng(0)          # identical data on every process
    n = 4096
    main = 4.0 + rng.uniform(0, 1, n)
    off = rng.uniform(-1, 1, n - 1)
    rows = np.concatenate([np.arange(n), np.arange(n - 1), np.arange(1, n)])
    cols = np.concatenate([np.arange(n), np.arange(1, n), np.arange(n - 1)])
    vals = np.concatenate([main, off, off])
    x_true = rng.uniform(1, 2, n)
    b = np.zeros(n)
    np.add.at(b, rows, vals * x_true[cols])

    A = ShardedBandedOperator(n, rows, cols, vals, n_devices=D)
    mesh = make_mesh(D)
    res = solve_sharded(A, b, method="cg", mesh=mesh,
                        params=lcg.SolverParams(epsilon=1e-12))
    from jax.experimental import multihost_utils

    x = np.asarray(multihost_utils.process_allgather(res.x, tiled=True))
    if process_id == 0:
        err = np.max(np.abs(x - x_true))
        print(f"iterations={int(res.iterations)} residual={float(res.residual):.3e}")
        print(f"max err vs manufactured solution: {err:.3e}")
        assert err < 1e-4
        print("MULTIHOST OK")
    jax.distributed.shutdown()


def main():
    if "--worker" in sys.argv:
        i = sys.argv.index("--worker")
        worker(int(sys.argv[i + 1]), int(sys.argv[i + 2]), sys.argv[i + 3])
        return
    coord = "127.0.0.1:19876"
    # Propagate this process's import path so the workers resolve
    # liblcg_tpu identically whether it is installed or run from a checkout.
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join(p for p in sys.path if p)}
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__),
             "--worker", str(pid), "2", coord],
            env=env,
        )
        for pid in range(2)
    ]
    rc = [p.wait(timeout=300) for p in procs]
    if any(rc):
        raise SystemExit(f"worker exit codes: {rc}")


if __name__ == "__main__":
    main()
