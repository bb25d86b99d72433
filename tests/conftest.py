"""Test configuration: run everything on CPU with 8 virtual devices.

Tests need no accelerator: CPU execution plus interpret-mode Pallas covers
correctness; the multi-device tests use the virtual 8-device CPU mesh
created by the XLA flag below. Tests that need the GPU take the ``gpu``
fixture (marked ``gpu``), which skips them here; ``chip_smoke.py`` runs
their checks on the card.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")

# Persistent compilation cache: the suite's wall time is dominated by XLA
# CPU compiles of DISTINCT programs (full-engine frame pipelines at several
# shapes, 8-device sharded renders, scan bodies) that the session-scoped
# engine cache cannot share. Warm runs on the same box skip them all.
# JAX_COMPILATION_CACHE_DIR, when set, is the cache (JAX reads it itself).
if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update("jax_compilation_cache_dir", os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        ".jax_test_cache"))
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)

import pytest  # noqa: E402

_ENGINE_CACHE = {}


@pytest.fixture
def gpu():
    """The JAX GPU devices; skips the test when there are none (decided
    here, at run time, never while modules are imported)."""
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs this check "
                    "on the card")
    return devs


@pytest.fixture(scope="session")
def engine_factory():
    """Session-scoped demo-engine cache. Building the space engine re-traces
    the full step+render pipeline (tens of seconds per build on CPU; the
    round-2 suite spent most of its 15 minutes rebuilding identical
    engines). Engines are cached by (slot, kwargs) and ``Engine.reset()``
    to frame zero on reuse. Pass a distinct ``slot`` when a test needs two
    live engines at once (e.g. record + replay), or when it mutates
    non-resettable config (set_window)."""
    from render_engine_tpu.demo.space_scene import build_space_engine

    def get(slot=0, **kw):
        key = (slot, tuple(sorted(kw.items())))
        eng = _ENGINE_CACHE.get(key)
        if eng is None:
            _ENGINE_CACHE[key] = eng = build_space_engine(**kw)
            eng._test_cfg0 = (eng.config.record_history,
                              eng.config.history_dir)
        else:
            eng.config.record_history, eng.config.history_dir = eng._test_cfg0
            eng.reset()
        return eng

    return get
