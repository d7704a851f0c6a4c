"""Device checks and the persistent compile cache for the runnable scripts.

The library itself is device-agnostic (the CPU test suite runs every path);
the scripts that measure or prove the system on the GPU (``chip_smoke.py``,
``bench.py``) and the driver entry points (``__graft_entry__.py``) share
these three helpers:

- :func:`enable_compile_cache` — JAX's persistent compilation cache at a
  fixed path, so a second process with the same programs skips compiling;
- :func:`require_gpu` — fail loudly, never fall back to the CPU;
- :func:`describe_device` — what ran: JAX's device fields plus the card's
  name and power limit from ``nvidia-smi``.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import Optional

__all__ = [
    "CHECKOUT",
    "compile_cache_dir",
    "enable_compile_cache",
    "require_gpu",
    "describe_device",
    "nvidia_smi_line",
]

# repository root: the package lives at <checkout>/tissue_analysis_tpu/
CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def compile_cache_dir() -> str:
    """``$JAX_COMPILATION_CACHE_DIR`` when set, else ``<checkout>/.jax_cache``.

    The path is part of what makes a cache hit possible, so the default is
    fixed by the checkout's location alone (never a temporary directory).
    """
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        CHECKOUT, ".jax_cache"
    )


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at :func:`compile_cache_dir`.

    When the environment variable is set JAX already reads it, and nothing
    else is configured. Returns the directory in use.
    """
    path = compile_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        import jax

        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    return path


def require_gpu() -> None:
    """Raise unless JAX's default device is a GPU."""
    import jax

    platform = jax.devices()[0].platform
    if platform != "gpu":
        raise RuntimeError(
            f"a GPU is required, but JAX's default platform is {platform!r}"
        )


def nvidia_smi_line() -> Optional[str]:
    """``name, power.limit`` of the first card as nvidia-smi reports them
    (None when nvidia-smi is absent or fails)."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return None
    try:
        out = subprocess.run(
            [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.strip().splitlines()
    return lines[0].strip() if lines else None


def describe_device() -> dict:
    """JAX's view of the devices plus the card's name and power limit."""
    import jax

    devs = jax.devices()
    return {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
        "nvidia_smi": nvidia_smi_line(),
    }
