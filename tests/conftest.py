import os
import sys

import pytest

# The suite runs on the CPU unless JAX_PLATFORMS names another platform:
# a virtual 8-device CPU mesh for the sharding tests, the XLA decode
# route, and Pallas kernels in interpret mode. Tests that need the GPU
# carry the `gpu` marker and skip on the CPU; on a GPU machine
# `JAX_PLATFORMS=cuda python -m pytest -m gpu tests/` runs them, and
# chip_smoke.py runs the same checks at full size.
ON_CPU = os.environ.get("JAX_PLATFORMS", "cpu") == "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if ON_CPU and "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
import jax  # noqa: E402

if ON_CPU:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_device", jax.devices("cpu")[0])

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from brotlig_tpu.utils import jaxcache  # noqa: E402

jaxcache.enable()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a GPU; skips elsewhere (chip_smoke.py runs "
        "the same checks on the card)")
    config.addinivalue_line(
        "markers", "slow: long-running; tier-1 runs deselect it")


@pytest.fixture(autouse=True)
def _skip_gpu_tests_without_gpu(request):
    """`gpu`-marked tests skip unless the default JAX device is a GPU;
    decided per test at run time, so every worker collects the same
    tests."""
    if (request.node.get_closest_marker("gpu")
            and jax.devices()[0].platform != "gpu"):
        pytest.skip("needs a GPU")


# The full suite compiles hundreds of XLA:CPU executables; each holds
# LLVM-JIT mmap regions for as long as jax's in-process executable caches
# keep it alive. A single cold pytest process accumulates ~60K maps and
# then hits the kernel's vm.max_map_count (65530 default) partway through
# the suite — mmap fails inside LLVM and the process aborts. Dropping
# compiled executables bounds the map count; the persistent on-disk cache
# (jaxcache) makes the recompiles cheap loads. The guard runs before EVERY
# test: one heavy module's interpret-mode compiles alone can cross the
# limit. The check itself is one /proc/self/maps read (~1 ms).
@pytest.fixture(autouse=True)
def _bound_jit_mmap_regions():
    jaxcache.clear_if_bloated()
    yield
