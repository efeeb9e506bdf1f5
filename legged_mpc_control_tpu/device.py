"""The one place that knows which device the program runs on.

Three jobs: accept or refuse the platform JAX runs on, describe that
device (and the card's power limit, which bounds its clocks), and place
the persistent compile cache. Every path of the program
is plain JAX left to XLA, on the GPU as on the CPU; no code chooses a path
by platform name.
"""

import os
import subprocess

import jax

# The GPU is the accelerator; the CPU runs the tests and the small-size
# rehearsals. Any other platform is refused rather than run untested.
SUPPORTED_PLATFORMS = ("gpu", "cpu")

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def check_platform(platform: str = None) -> str:
    """`platform` (default: the one JAX runs on) if supported, else
    RuntimeError."""
    platform = platform or jax.default_backend()
    if platform not in SUPPORTED_PLATFORMS:
        raise RuntimeError(
            f"unsupported platform {platform!r}; supported: "
            f"{list(SUPPORTED_PLATFORMS)}")
    return platform


def device_info() -> dict:
    """{"platform", "kind", "count"} of the devices JAX runs on (after
    `check_platform`)."""
    devs = jax.devices()
    check_platform(devs[0].platform)
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def gpu_name_and_power_limit():
    """`name, power.limit` of the first card as nvidia-smi reports them,
    or None where nvidia-smi is missing or fails."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else None


def compile_cache_dir() -> str:
    """JAX_COMPILATION_CACHE_DIR when set, else `<repo>/.jax_cache`. The
    path is fixed: the cache is keyed on it, so a moving path never hits."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(REPO_ROOT, ".jax_cache"))


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at `compile_cache_dir()`."""
    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
