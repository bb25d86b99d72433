"""The one platform switch: which render path and kernel mode a backend gets.

  * ``"gpu"`` — the tiled kernel path (tile raster + fused shade, Pallas
    lowered through Triton), always compiled;
  * ``"cpu"`` — the jnp golden path. The tiled path still runs when a
    caller asks for it by name (the tests do), with the Pallas kernels in
    interpret mode;
  * any other backend raises.

Every module that used to test ``jax.default_backend()`` on its own asks
here instead, so the decision is made in exactly one place.
"""

from __future__ import annotations

import os

import jax

SUPPORTED = ("gpu", "cpu")
# RenderSettings.backend values: "auto" asks this module, the others name a
# path explicitly (tests render both and compare)
BACKENDS = ("auto", "tiled", "jnp")


def backend() -> str:
    """The JAX default backend, checked against the supported set."""
    name = jax.default_backend()
    if name not in SUPPORTED:
        raise RuntimeError(
            f"unsupported JAX backend {name!r}: the engine runs on an "
            "NVIDIA GPU, and on the CPU for tests")
    return name


def use_tiled_path(requested: str = "auto") -> bool:
    """Whether a frame takes the tiled kernel path (True) or the jnp golden
    path (False). ``requested`` is ``RenderSettings.backend``."""
    if requested == "jnp":
        return False
    if requested == "tiled":
        return True
    if requested != "auto":
        raise ValueError(
            f"unknown render backend {requested!r}; expected one of "
            f"{BACKENDS}")
    return backend() == "gpu"


def interpret_kernels() -> bool:
    """Pallas kernels run compiled on the GPU and interpreted on the CPU."""
    return backend() == "cpu"


def gpu_devices(count: int = 1) -> list:
    """The JAX devices of a measurement entry point. Exits non-zero unless
    JAX finds at least ``count`` GPUs: a measurement never falls back to
    the CPU."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"needs an NVIDIA GPU; JAX found "
                         f"{devs[0].platform!r}")
    if len(devs) < count:
        raise SystemExit(f"needs {count} GPUs; JAX found {len(devs)}")
    return devs


def device_record(devs) -> dict:
    """What every result names: platform, device kind, device count."""
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


# ---------------------------------------------------------------------------
# persistent compilation cache
# ---------------------------------------------------------------------------
CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_CACHE_DIR = os.path.join(_REPO_ROOT, ".jax_cache")


def resolve_cache_dir(environ=None):
    """(directory, from_env). When ``JAX_COMPILATION_CACHE_DIR`` is set,
    JAX already reads it at start-up, so nothing needs setting in code;
    otherwise the fixed (gitignored) ``DEFAULT_CACHE_DIR`` in the checkout —
    fixed because the path is part of the cache key."""
    environ = os.environ if environ is None else environ
    env = environ.get(CACHE_ENV)
    if env:
        return env, True
    return DEFAULT_CACHE_DIR, False


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache for an entry point and
    return its directory. Call before the first compile."""
    path, from_env = resolve_cache_dir()
    if not from_env:
        jax.config.update("jax_compilation_cache_dir", path)
    return path
