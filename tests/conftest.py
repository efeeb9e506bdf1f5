"""Test configuration: run everything on a virtual 8-device CPU mesh in f64.

Tests use float64 on the CPU so golden values and QP oracle comparisons are
solver-grade. A test marked `gpu` needs an NVIDIA GPU and skips elsewhere
(run such tests on the card with JAX_PLATFORMS=cuda and without xdist: one
JAX process per card).
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import pytest  # noqa: E402

from legged_mpc_control_tpu import device  # noqa: E402

jax.config.update("jax_enable_x64", True)
# persistent compilation cache: the suite is compile-bound; warm runs reuse
# cached executables
device.enable_compile_cache()


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip `gpu` tests unless JAX runs on a GPU — decided per test, at
    run time, never while modules are imported."""
    if (request.node.get_closest_marker("gpu")
            and jax.default_backend() != "gpu"):
        pytest.skip("needs an NVIDIA GPU")
