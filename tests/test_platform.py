"""The platform switch (which render path and kernel mode a backend gets)
and the compile-cache helper."""

import os

import jax
import pytest

from render_engine_tpu import platform
from render_engine_tpu.render import raster_jnp, raster_pallas
from render_engine_tpu.render.frame import RenderSettings, pick_rasterizer


@pytest.fixture
def backend_is(monkeypatch):
    def set_(name):
        monkeypatch.setattr(jax, "default_backend", lambda: name)
    return set_


class TestPlatformSwitch:
    def test_gpu_takes_compiled_tiled_path(self, backend_is):
        backend_is("gpu")
        assert platform.backend() == "gpu"
        assert platform.use_tiled_path("auto")
        assert not platform.interpret_kernels()
        assert (pick_rasterizer("auto")
                is raster_pallas.rasterize_depth_winner_pallas)

    def test_cpu_takes_golden_path(self, backend_is):
        backend_is("cpu")
        assert not platform.use_tiled_path("auto")
        assert platform.interpret_kernels()
        assert pick_rasterizer("auto") is raster_jnp.rasterize_depth_winner

    @pytest.mark.parametrize("requested,tiled", [("tiled", True),
                                                 ("jnp", False)])
    def test_explicit_path_wins_on_either_backend(self, backend_is,
                                                  requested, tiled):
        for name in ("cpu", "gpu"):
            backend_is(name)
            assert platform.use_tiled_path(requested) is tiled

    @pytest.mark.parametrize("name", ["rocm", "metal", "xpu"])
    def test_other_backend_raises(self, backend_is, name):
        backend_is(name)
        with pytest.raises(RuntimeError, match="unsupported JAX backend"):
            platform.backend()
        with pytest.raises(RuntimeError):
            platform.use_tiled_path("auto")
        with pytest.raises(RuntimeError):
            platform.interpret_kernels()

    def test_tiled_path_shades_with_fused_kernel_by_default(self):
        # the GPU's auto path gets the fused shade kernel without a flag
        assert RenderSettings().fused_shading

    def test_unknown_render_backend_rejected(self):
        with pytest.raises(ValueError, match="unknown render backend"):
            platform.use_tiled_path("pallas")

    def test_measurement_refuses_cpu(self):
        # the suite runs on the CPU: a measurement entry point must exit
        with pytest.raises(SystemExit, match="needs an NVIDIA GPU"):
            platform.gpu_devices()

    def test_device_record_names_platform_kind_count(self):
        rec = platform.device_record(jax.devices())
        assert rec == {"platform": "cpu",
                       "kind": jax.devices()[0].device_kind,
                       "count": len(jax.devices())}


class TestCompileCacheDir:
    def test_env_var_wins_and_nothing_is_set(self, monkeypatch, tmp_path):
        monkeypatch.setenv(platform.CACHE_ENV, str(tmp_path))
        calls = []
        monkeypatch.setattr(jax.config, "update",
                            lambda *a: calls.append(a))
        assert platform.resolve_cache_dir() == (str(tmp_path), True)
        assert platform.enable_compile_cache() == str(tmp_path)
        assert calls == []

    def test_unset_uses_fixed_checkout_path(self, monkeypatch):
        monkeypatch.delenv(platform.CACHE_ENV, raising=False)
        calls = []
        monkeypatch.setattr(jax.config, "update",
                            lambda *a: calls.append(a))
        path, from_env = platform.resolve_cache_dir()
        assert not from_env and path == platform.DEFAULT_CACHE_DIR
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert path == os.path.join(repo, ".jax_cache")
        assert platform.enable_compile_cache() == path
        assert calls == [("jax_compilation_cache_dir", path)]

    def test_empty_env_counts_as_unset(self):
        path, from_env = platform.resolve_cache_dir(
            environ={platform.CACHE_ENV: ""})
        assert (path, from_env) == (platform.DEFAULT_CACHE_DIR, False)

    def test_default_cache_dir_is_gitignored(self):
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        with open(os.path.join(repo, ".gitignore")) as f:
            assert ".jax_cache/" in f.read().split()
