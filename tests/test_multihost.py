"""Multi-process SPMD solve over jax.distributed (2 processes x 4 CPU
devices -> one 8-device global mesh, collectives over the inter-process
transport).  Exercises the path a real multi-host run uses."""

import os
import subprocess
import sys

import pytest


@pytest.mark.timeout(360)
def test_two_process_distributed_solve():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = os.path.join(repo, "samples", "sample7_multihost.py")
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": repo + os.pathsep + os.environ.get("PYTHONPATH", "")}
    out = subprocess.run(
        [sys.executable, script], env=env, capture_output=True, text=True,
        timeout=330,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "MULTIHOST OK" in out.stdout
