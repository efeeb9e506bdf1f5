"""The device module: supported platforms, device description, and the
compile-cache location."""

import os

import jax
import pytest

from legged_mpc_control_tpu import device


@pytest.mark.parametrize("platform,ok", [
    ("gpu", True), ("cpu", True), ("rocm", False), ("metal", False)])
def test_check_platform(platform, ok):
    if ok:
        assert device.check_platform(platform) == platform
    else:
        with pytest.raises(RuntimeError, match="unsupported platform"):
            device.check_platform(platform)


def test_check_platform_defaults_to_running_platform():
    assert device.check_platform() == jax.default_backend()


def test_device_info_describes_jax_devices():
    info = device.device_info()
    assert info == {"platform": jax.devices()[0].platform,
                    "kind": jax.devices()[0].device_kind,
                    "count": len(jax.devices())}


def test_compile_cache_dir_follows_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert device.compile_cache_dir() == str(tmp_path)


def test_compile_cache_dir_defaults_inside_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = device.compile_cache_dir()
    assert path == os.path.join(device.REPO_ROOT, ".jax_cache")
    assert os.path.isfile(os.path.join(os.path.dirname(path),
                                       "chip_smoke.py"))
    assert path == device.compile_cache_dir()      # fixed, not per call


def test_enable_compile_cache_points_jax_at_it(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    try:
        assert device.enable_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
