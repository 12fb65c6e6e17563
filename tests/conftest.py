"""Test config: run on a virtual 8-device CPU mesh with f64 enabled.

Multi-device hardware is not available in CI; sharding paths are validated
on ``xla_force_host_platform_device_count=8`` CPU devices (the standard JAX
recipe for testing pjit/shard_map code without accelerators).  The GPU path
runs as ``python chip_smoke.py`` (``--multi`` on 4 GPUs).
"""

import os

# Force CPU even when the environment pins another platform (the sharding
# tests need 8 devices).  The environment may import jax before this
# conftest runs, so set the config directly as well — backends are only
# instantiated on first use.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_x64", True)
# NO persistent compile cache for the CPU test suite: XLA:CPU AOT cache
# entries embed the compile-time machine-feature set, and the loader
# warns ("+prefer-no-scatter is not supported on the host machine ...
# could lead to execution errors such as SIGILL") when features drift —
# observed here as wildly erratic weak-scaling timings from cached
# executables.  The GPU runs (chip_smoke.py, bench.py) keep their cache in
# $JAX_COMPILATION_CACHE_DIR or <repo>/.jax_cache; the CPU suite
# recompiles.

import numpy as np
import pytest

REFERENCE_DATA = "/root/reference/data"


@pytest.fixture(scope="session")
def case_10k():
    from liblcg_tpu.utils import io

    sys = io.read_system(f"{REFERENCE_DATA}/case_10K_A", complex_values=False)
    ans = io.read_answer(f"{REFERENCE_DATA}/case_10K_B", complex_values=False)
    return sys, ans


@pytest.fixture(scope="session")
def case_1k_complex():
    from liblcg_tpu.utils import io

    sys = io.read_system(f"{REFERENCE_DATA}/case_1K_cA", complex_values=True)
    ans = io.read_answer(f"{REFERENCE_DATA}/case_1K_cB", complex_values=True)
    return sys, ans


@pytest.fixture(scope="session")
def case_10k_complex():
    from liblcg_tpu.utils import io

    sys = io.read_system(f"{REFERENCE_DATA}/case_10K_cA", complex_values=True)
    ans = io.read_answer(f"{REFERENCE_DATA}/case_10K_cB", complex_values=True)
    return sys, ans


@pytest.fixture(scope="session")
def spd_small():
    """Random SPD system via normal equations, the sample1.cpp:48-52 recipe."""
    rng = np.random.default_rng(42)
    m, n = 100, 80
    K = rng.uniform(-1.0, 1.0, size=(m, n))
    A = K.T @ K + 0.1 * np.eye(n)
    x_true = rng.uniform(1.0, 2.0, size=n)
    b = A @ x_true
    return A, b, x_true


@pytest.fixture(scope="session")
def complex_sym_small():
    """Random complex symmetric (A = A^T) system, the sample3.cpp:68-74 recipe."""
    rng = np.random.default_rng(7)
    n = 60
    M = rng.uniform(-1.0, 1.0, size=(n, n)) + 1j * rng.uniform(-1.0, 1.0, size=(n, n))
    A = (M + M.T) / 2 + (2.5 + 0.5j) * np.eye(n)
    x_true = rng.uniform(1.0, 2.0, size=n) + 1j * rng.uniform(-1.0, 1.0, size=n)
    b = A @ x_true
    return A, b, x_true
