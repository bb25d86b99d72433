"""chip_smoke.py's phase functions at a tiny size on the CPU (the tile
kernels in interpret mode), its refusal to run without a GPU, and its
card-only parity run."""

import json
import os
import shutil
import subprocess
import sys

import pytest

import chip_smoke as C

# 72 rows: four ranks of 8-row tiles pad the image to 96 rows, so the
# sharded phase covers the padded band
TINY = dict(width=256, height=72, num_asteroids=40, max_tris=2048)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def eng(engine_factory):
    e = engine_factory(slot="chip_smoke", capacity=C.capacity_for(40),
                       **TINY)
    e.config.record_history = False
    C.run_frames(e, 2)  # shadow maps in place
    return e


def test_capacity_matches_bench_sizing():
    assert C.capacity_for(10000) == 16384
    assert C.capacity_for(40) == 128


def test_parity_phase_tiny(eng):
    out = C.parity_phase(eng, timing=False)
    assert out["raster_frame"]["winner_mismatch_frac"] == 0.0
    assert out["raster_shadow"]["covered"] > 0
    assert out["resolve"]["material_equal"]
    assert out["frame"]["vs_tiled_xla"]["max"] < 0.05


def test_main_path_phase_tiny(eng, tmp_path):
    out = C.main_path_phase(eng, str(tmp_path), timed=2, replay=3)
    assert out["replay_equal"]
    assert (tmp_path / "chip_smoke_frame.png").stat().st_size > 0
    assert set(out["drops"]) >= {"tile_candidate_dropped",
                                 "triangle_budget_dropped"}


def test_four_device_phase_tiny(eng):
    out = C.four_gpu_phase(eng, 4)
    assert out["shard_rows"] == eng.config.capacity // 4
    assert out["image_max"] < 0.03


def test_refuses_without_gpu(capsys):
    with pytest.raises(SystemExit, match="needs an NVIDIA GPU"):
        C.main([])
    assert "ok" not in capsys.readouterr().out


def test_fails_alone_without_the_repo(tmp_path):
    """In a directory that holds only the script, it exits non-zero and
    prints no result."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    for line in proc.stdout.splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)


@pytest.mark.gpu
def test_kernel_parity_on_card(gpu, eng):
    """The smoke's parity checks, compiled for the card (skips without
    one)."""
    C.parity_phase(eng, timing=False)
