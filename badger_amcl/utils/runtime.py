"""Process-level JAX setup shared by the entry points.

- `enable_compile_cache()`: the persistent compilation cache. Where
  `JAX_COMPILATION_CACHE_DIR` is set, JAX already uses it and nothing is
  set here. Otherwise the cache goes to `.jax_cache/` at the root of the
  checkout — a fixed path, because the path is part of the cache's key and
  a directory that moves never hits.
- `require_gpu()`: the measurement paths refuse to run anywhere but on a
  GPU. JAX falls back to the CPU with only a warning when its CUDA plugin
  fails to load, and a CPU number must never pass for a device number.
"""

from __future__ import annotations

import os

import jax

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and return
    that directory. Call before the first compilation."""
    env = os.environ.get(CACHE_ENV)
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR


def require_gpu(device=None):
    """Return `device` (default: JAX's first device) if it is a GPU; raise
    RuntimeError otherwise."""
    device = jax.devices()[0] if device is None else device
    if device.platform != "gpu":
        raise RuntimeError(
            f"this measurement needs a GPU, but JAX's device is "
            f"{device.platform!r} ({device.device_kind}); refusing to report "
            "host numbers as device numbers"
        )
    return device
