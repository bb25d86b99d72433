"""The five BASELINE.json benchmark configs.

Usage:
    python benchmarks/run_benchmarks.py [config ...]
configs: scene, asteroids, lights, tick, playback (default: all)

Each prints one JSON line naming the device it ran on:
  {"config": ..., "metric": ..., "value": N, "unit": ..., "device": {...}}

Needs an NVIDIA GPU: exits non-zero when JAX finds none. Scale knob via
env: BENCH_SCALE=0.1 shrinks populations/resolutions for a quick pass.
BENCH_OUT=path appends every run's results to a JSON file.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import numpy as np

SCALE = float(os.environ.get("BENCH_SCALE", "1.0"))


def _s(x, lo=1):
    return max(lo, int(round(x * SCALE)))


def _sync(eng, img=None):
    jax.block_until_ready((eng.world, img))


def _time_frames(eng, frames, render=True, key=None):
    from render_engine_tpu.logic.types import InputState, KEY_W

    for i in range(3):
        img = eng.frame(InputState.idle(i).with_keys(KEY_W), 1 / 60,
                        render=render)
    _sync(eng, img)
    t0 = time.perf_counter()
    out = None
    for i in range(frames):
        out = eng.frame(InputState.idle(100 + i).with_keys(KEY_W), 1 / 60,
                        render=render)
    _sync(eng, out)
    return frames / (time.perf_counter() - t0)


def bench_scene():
    """Config 1: sample space scene, deferred at 800x600 offscreen."""
    from render_engine_tpu.demo.space_scene import build_space_engine

    eng = build_space_engine(
        width=_s(800, 128), height=_s(600, 96), capacity=256,
        num_asteroids=40, max_tris=32768,
    )
    eng.config.record_history = False
    fps = _time_frames(eng, _s(30, 5))
    return {"config": "scene", "metric": "space scene 800x600 deferred",
            "value": round(fps, 2), "unit": "fps"}


def bench_asteroids():
    """Config 2: 10k instanced asteroids, culling active, 1 dir light."""
    from render_engine_tpu.demo.space_scene import build_space_engine
    from render_engine_tpu.ecs import registry as R

    n = _s(10000, 100)
    cap = 1 << (n + 64).bit_length()
    eng = build_space_engine(
        width=_s(1920, 256), height=_s(1080, 144), capacity=cap,
        num_asteroids=n, max_tris=16384,
        # the thrusting patrol here reaches poses with ~35 LARGE collision
        # movers (the headline's coasting patrol stays at ~32 — the
        # EngineConfig default); 64 keeps collision_large_dropped 0 with
        # headroom (r5 run: 3 dropped at 32)
        collision_large_budget=64,
    )
    eng.config.record_history = False
    # one directional light
    eng.world, _ = __import__(
        "render_engine_tpu.ecs.world", fromlist=["spawn_host"]
    ).spawn_host(
        eng.world, 1,
        position=np.array([[1000.0, 1400.0, 1000.0]], np.float32),
        sortable=np.array([R.SORTABLE_DIRECTIONAL], np.int32),
        light_direction=np.array([[0.3, -1.0, 0.2]], np.float32),
        light_diffuse=np.full((1, 3), 0.8, np.float32),
        light_ambient=np.full((1, 3), 0.1, np.float32),
    )
    fps = _time_frames(eng, _s(20, 5))
    return {"config": "asteroids",
            "metric": f"{n} asteroids culled+drawn at 1080p",
            "value": round(fps, 2), "unit": "fps",
            "drops": eng.drop_stats()}


def bench_lights():
    """Config 3: 256 point lights + skybox; the demo's TWO user render
    systems (default lit + unlit light_sources) run through the Engine's
    single fused pass, sharing the one G-buffer by construction."""
    import dataclasses

    from render_engine_tpu.demo.space_scene import build_space_engine
    from render_engine_tpu.ecs import registry as R
    from render_engine_tpu.ecs.world import spawn_host

    nl = _s(256, 8)
    eng = build_space_engine(
        width=_s(1280, 256), height=_s(720, 144), capacity=1024,
        num_asteroids=200, max_tris=24576,
        # 720p packs the 200-asteroid cluster into fewer tiles than 1080p:
        # the default 112 candidate budget dropped 312 candidates, 160
        # still 45; 192 covers the opaque windows. The residual 8 drops at
        # r5b were TRANSPARENT-window overflow (the wormhole/producer
        # spheres stack >64 candidates in a 720p tile — per-class diag:
        # trans 128 -> 0, opaque 256 -> still 8), so the transparent
        # budget doubles here too.
        raster_tile_budget=192,
        trans_tile_budget=128,
    )
    eng.config.record_history = False
    rng = np.random.default_rng(0)
    pos = (np.array([1000.0, 1000.0, 900.0]) +
           rng.uniform(-200, 200, (nl, 3))).astype(np.float32)
    eng.world, _ = spawn_host(
        eng.world, nl,
        position=pos,
        sortable=np.full(nl, R.SORTABLE_POINT, np.int32),
        light_diffuse=rng.uniform(0.2, 1.0, (nl, 3)).astype(np.float32),
        light_atten=np.full((nl, 2), [0.05, 0.01], np.float32),
        # influence radii (LightInformation.radius): the per-tile light
        # culling bounds each light's screen effect by this sphere — the
        # light-volume scaling answer (second_pass_vertex.glsl proxies)
        light_radius=rng.uniform(40.0, 90.0, nl).astype(np.float32),
    )
    # rebuild jitted fns with a bigger light budget (keep fused shading,
    # raster config, and the demo's render systems); tiles cull the light
    # loop to their own lists (overflow shows in drops as
    # light_tile_overflow — keep it 0; 96 has no overflow here).
    eng.config.render = dataclasses.replace(
        eng.config.render, max_point_lights=nl, max_spot_lights=8,
        light_tile_budget=int(os.environ.get("BENCH_LIGHT_TILE_BUDGET", 96)),
    )
    eng.finalize_scene()
    assert eng.compiled_systems is not None
    n_sys = len(eng.compiled_systems.names)
    fps = _time_frames(eng, _s(20, 5))
    return {"config": "lights",
            "metric": (f"{nl} point lights deferred 720p, "
                       f"{n_sys} render systems, shared G-buffer"),
            "value": round(fps, 2), "unit": "fps",
            "light_tile_budget": eng.config.render.light_tile_budget,
            "drops": eng.drop_stats()}


def bench_tick():
    """Config 4: 100k-entity world tick (spin/orbit logic), step-only rate
    plus a 1080p render rate."""
    from render_engine_tpu.demo.space_scene import build_space_engine

    n = _s(100000, 1000)
    cap = 1 << (n + 64).bit_length()
    eng = build_space_engine(
        width=_s(1920, 256), height=_s(1080, 144), capacity=cap,
        num_asteroids=n, max_tris=49152,
    )
    eng.config.record_history = False
    steps_per_sec = _time_frames(eng, _s(30, 5), render=False)
    alive = int(np.asarray(eng.world.alive).sum())

    # device-rate control: the per-frame figure above includes the host's
    # per-dispatch cost; one lax.scan dispatch steps N frames back-to-back,
    # so its rate is dominated by device time.
    from render_engine_tpu.logic.types import InputState

    nscan = _s(60, 5)
    ins = [InputState.idle(1000 + i) for i in range(nscan)]
    dts = [1 / 60] * nscan
    eng.run_frames(ins, dts)  # compile
    _sync(eng)
    t0 = time.perf_counter()
    eng.run_frames(ins, dts)
    _sync(eng)
    scan_steps_per_sec = nscan / (time.perf_counter() - t0)

    return {"config": "tick",
            "metric": f"{alive}-entity world tick (no render)",
            "value": round(steps_per_sec * alive, 0),
            "unit": "entities_stepped_per_sec",
            "steps_per_sec": round(steps_per_sec, 2),
            "scan_steps_per_sec": round(scan_steps_per_sec, 2),
            "scan_entities_per_sec": round(scan_steps_per_sec * alive, 0)}


def bench_playback():
    """Config 5: record N frames, bit-deterministic replay, detached camera,
    continue-past-end."""
    from render_engine_tpu.demo.space_scene import build_space_engine
    from render_engine_tpu.logic.types import InputState, KEY_UP, KEY_W
    from render_engine_tpu.runtime.replay import Player
    from render_engine_tpu.utils.hashing import world_hash

    n_frames = _s(10000, 50)
    eng = build_space_engine(width=128, height=32, capacity=256,
                             num_asteroids=40, max_tris=8192)
    t0 = time.perf_counter()
    for i in range(n_frames):
        eng.frame(InputState.idle(i).with_keys(KEY_W), 1 / 60, render=False)
    _sync(eng)
    record_fps = n_frames / (time.perf_counter() - t0)
    live_hash = world_hash(eng.world)

    eng2 = build_space_engine(width=128, height=32, capacity=256,
                              num_asteroids=40, max_tris=8192)
    player = Player(eng2, eng.history)
    t0 = time.perf_counter()
    while player.cursor < eng.history.num_frames:
        player.step(render=False)
    _sync(eng2)
    replay_fps = eng.history.num_frames / (time.perf_counter() - t0)
    deterministic = world_hash(eng2.world) == live_hash
    # continue past end: one live frame
    player.step(render=False)  # -> ONE_PAST_LAST_FRAME
    player.step(InputState.idle(0).with_keys(KEY_UP), render=False)

    # RECORDED rendering at the headline scenario: rendered recorded
    # frames advance through the SAME fused one-dispatch program as the
    # unrecorded headline (the per-frame advance choice is stored in the
    # history and replay re-drives it — docs/playback.md), so recording
    # costs only the host-side input append. Measured explicitly: this is
    # the north-star conjunction figure (">60 FPS with bit-deterministic
    # playback", BASELINE.md). max_tris matches the headline bench.
    rec = build_space_engine(
        width=_s(1920, 256), height=_s(1080, 144),
        capacity=1 << (_s(10000, 64) + 64).bit_length(),
        num_asteroids=_s(10000, 32), max_tris=16384,
    )
    assert rec.config.record_history
    nrec = _s(120, 10)
    img = None
    for i in range(3):  # compile
        img = rec.frame(InputState.idle(i).with_keys(KEY_W), 1 / 60)
    _sync(rec, img)
    t0 = time.perf_counter()
    for i in range(nrec):
        img = rec.frame(InputState.idle(3 + i).with_keys(KEY_W), 1 / 60)
    _sync(rec, img)
    recorded_render_fps = nrec / (time.perf_counter() - t0)

    return {"config": "playback",
            "metric": f"{n_frames}-frame record/replay",
            "value": round(replay_fps, 1), "unit": "replay_fps",
            "record_fps": round(record_fps, 1),
            "recorded_render_1080p_fps": round(recorded_render_fps, 2),
            "bit_deterministic": bool(deterministic)}


ALL = {
    "scene": bench_scene,
    "asteroids": bench_asteroids,
    "lights": bench_lights,
    "tick": bench_tick,
    "playback": bench_playback,
}


def main():
    from render_engine_tpu import platform

    device = platform.device_record(platform.gpu_devices())
    platform.enable_compile_cache()
    names = sys.argv[1:] or list(ALL)
    results = []
    for name in names:
        result = dict(ALL[name](), device=device)
        print(json.dumps(result), flush=True)
        results.append(result)
    out = os.environ.get("BENCH_OUT")
    if out:
        rec = {"device": device, "scale": SCALE,
               "time": time.strftime("%Y-%m-%dT%H:%M:%S"),
               "results": results}
        history = []
        if os.path.exists(out):
            try:
                with open(out) as fh:
                    history = json.load(fh)
            except Exception:
                history = []
        history.append(rec)
        with open(out, "w") as fh:
            json.dump(history, fh, indent=1)
        print(f"# appended to {out}", file=sys.stderr, flush=True)


if __name__ == "__main__":
    main()
