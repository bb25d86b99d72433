"""Bit-determinism replay over the round-3/4 feature set.

Exercises in ONE recorded run: emissive texture maps (third pair),
per-tile light culling (light_tile_budget > 0), and multi-contact
per-pair collision callbacks (hits_topk); then replays the recording and
asserts live hash == replay hash. This is the feature-targeted variant of
scripts/smoke_space.py's replay check (the reference's de-facto
integration test is its playback system, pipeline.rs:279-421).

Run on the GPU: python scripts/replay_features.py
Run on the CPU: JAX_PLATFORMS=cpu python scripts/replay_features.py
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import numpy as np

from render_engine_tpu.ecs import changes as C
from render_engine_tpu.ecs import registry as R
from render_engine_tpu.logic.types import EntityType, InputState
from render_engine_tpu.math.camera import CameraBuilder
from render_engine_tpu.models import primitives
from render_engine_tpu.render.frame import RenderSettings
from render_engine_tpu.render.raster_jnp import RasterConfig
from render_engine_tpu.render.textures import TextureAtlasBuilder
from render_engine_tpu.runtime.config import EngineConfig
from render_engine_tpu.runtime.engine import Engine
from render_engine_tpu.runtime.history import HistoryLog
from render_engine_tpu.runtime.replay import Player
from render_engine_tpu.utils.hashing import world_hash

N_BALLS = 12
N_LIGHTS = 6


def bounce(world, other_idx, mask, cs):
    """Per-contact callback: every delivered contact flips 60% of the
    entity's velocity — multi-contact delivery (hits_topk) visibly changes
    the trajectory vs a single-contact scheme, so a replay divergence in
    pair ordering would change the hash."""
    import jax.numpy as jnp

    away = world["position"] - world["position"][other_idx]
    norm = jnp.linalg.norm(away, axis=-1, keepdims=True)
    away = away / jnp.maximum(norm, 1e-6)
    vel = world["velocity"] * 0.4 + away * 2.0
    return C.with_update(cs, "velocity", vel, mask)


def build_scene(engine: Engine):
    bb = engine.bank_builder
    ab = TextureAtlasBuilder(layer_size=16)
    etid = ab.add_checkerboard(a=(1.0, 1.0, 1.0), b=(0.2, 0.2, 0.2),
                               cells=2)
    glow_mat = bb.add_material(albedo=(1.0, 0.6, 0.3), emissive=0.9,
                               texture_emissive=etid)
    ball_mat = bb.add_material(albedo=(0.5, 0.6, 0.8))
    glow = bb.add_model("glow", primitives.quad(8.0), material=glow_mat)
    ball = bb.add_model("ball", primitives.icosahedron(1.5),
                        material=ball_mat)
    engine.set_atlas(ab.finalize())

    engine.spawn(1, position=np.array([[64.0, 64.0, 50.0]], np.float32),
                 model_id=np.array([glow], np.int32),
                 type_id=np.array([0], np.int32))

    # clustered collidable balls with inward velocities: several entities
    # overlap per frame, driving multi-slot hits_topk delivery
    rng = np.random.default_rng(7)
    pos = (np.array([64.0, 64.0, 60.0])
           + rng.uniform(-2.5, 2.5, (N_BALLS, 3))).astype(np.float32)
    vel = (-(pos - np.array([64.0, 64.0, 60.0])) * 0.8
           + rng.uniform(-0.5, 0.5, (N_BALLS, 3))).astype(np.float32)
    engine.spawn(N_BALLS, position=pos, velocity=vel,
                 model_id=np.full(N_BALLS, ball, np.int32),
                 type_id=np.full(N_BALLS, 1, np.int32),
                 flags=np.full(N_BALLS, int(R.FLAG_COLLIDABLE), np.uint32))

    # point lights with influence radii: the per-tile light culling input
    lpos = (np.array([64.0, 64.0, 56.0])
            + rng.uniform(-12, 12, (N_LIGHTS, 3))).astype(np.float32)
    engine.spawn(N_LIGHTS, position=lpos,
                 sortable=np.full(N_LIGHTS, R.SORTABLE_POINT, np.int32),
                 light_diffuse=rng.uniform(0.3, 1.0, (N_LIGHTS, 3))
                 .astype(np.float32),
                 light_atten=np.full((N_LIGHTS, 2), [0.05, 0.01],
                                     np.float32),
                 light_radius=rng.uniform(15.0, 30.0, N_LIGHTS)
                 .astype(np.float32))


def make_engine(history_dir=None):
    cfg = EngineConfig(
        capacity=64, world_length=128.0, section_length=8.0,
        entity_types=(EntityType("glow", 0),
                      EntityType("ball", 1, collision=bounce)),
        collision_budget=16, collision_pairs=4,
        render=RenderSettings(
            width=128, height=64, max_tris=2048, backend="tiled",
            light_tile_budget=8,
            max_point_lights=N_LIGHTS, texture_tile_budget=1.0,
            raster=RasterConfig(tile_budget=32, max_tiles_per_tri=16,
                                global_budget=16, chunk=8)),
        build_scene=build_scene,
    )
    if history_dir is not None:
        cfg.history_dir = history_dir
    cam = (CameraBuilder().with_position(64.0, 64.0, 70.0)
           .with_yaw_pitch_degrees(-90.0, 0.0).with_fov_degrees(70.0)
           .with_aspect(2.0).with_near_far(0.1, 100.0)
           .with_draw_distance(100.0).build())
    return Engine(cfg, camera=cam)


def main():
    import jax

    print("backend:", jax.default_backend(), flush=True)
    t0 = time.time()
    eng = make_engine()
    assert eng.bank.has_emissive_maps(), "scene must carry an emissive map"
    assert eng.config.render.light_tile_budget > 0
    print(f"engine built in {time.time()-t0:.1f}s", flush=True)

    t0 = time.time()
    n = 30
    for i in range(n):
        img = eng.frame(InputState.idle(i), dt=1 / 60)
    jax.block_until_ready(img)
    print(f"{n} recorded frames: {(time.time()-t0)/n*1e3:.0f} ms/frame",
          flush=True)
    drops = eng.drop_stats()
    print("drops:", {k: v for k, v in drops.items() if v}, flush=True)
    # the cluster must actually deliver multi-contact pairs
    stats = eng.fps_stats()
    h_live = world_hash(eng.world)

    path = eng.flush_history()
    print("history flushed:", path, f"({eng.history.num_frames} frames)")
    hist = HistoryLog.load(eng.config.history_dir)
    eng2 = make_engine()
    hashes = Player(eng2, hist).replay_all(render=False)
    h_replay = hashes[-1]
    print("live   hash:", h_live[:16])
    print("replay hash:", h_replay[:16])
    assert h_live == h_replay, "FEATURE REPLAY DIVERGED"
    print("FEATURE REPLAY OK (emissive maps + tile lights + hits_topk)")
    return stats


if __name__ == "__main__":
    main()
