"""Size the raster / shadow-raster tile budgets so the idle-patrol bench
counters hit zero: steps the bench trajectory on CPU (with full-f32
matrix composes the CPU and accelerator trajectories track), then
evaluates the binning overflow at several budgets per window boundary.

Run from the repository root: python debug_logs/diag_budgets.py"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax

jax.config.update("jax_platforms", "cpu")

import dataclasses

import jax.numpy as jnp
import numpy as np

from render_engine_tpu.demo.space_scene import build_space_engine
from render_engine_tpu.logic.types import InputState
from render_engine_tpu.render import raster_pallas as RP
from render_engine_tpu.render import shadows as SHD
from render_engine_tpu.render.geometry import build_triangle_batch, to_screen
from render_engine_tpu.render.raster_jnp import RasterConfig, _bin_triangles

eng = build_space_engine(width=1920, height=1080, capacity=1 << 14,
                         num_asteroids=10000, max_tris=16384)
eng.config.record_history = False
settings = eng.config.render
systems = eng.compiled_systems
bank = eng.bank

BUDGETS = (96, 112, 128, 144, 160, 192)

@jax.jit
def overflow_counts(world, camera, shadow_state):
    batch = build_triangle_batch(world, bank, camera,
                                 max_tris=settings.max_tris, systems=systems)
    batch = to_screen(batch, settings.width, settings.height)
    tiles_x = -(-settings.width // settings.raster.tile_w)
    tiles_y = -(-settings.height // settings.raster.tile_h)
    tri_class = jnp.where(batch.valid,
                          jnp.where(batch.transparent, 2.0, 1.0), 0.0)
    out = {}
    for b in BUDGETS:
        cfg = dataclasses.replace(settings.raster, tile_budget=b)
        dropped = _bin_triangles(batch, cfg, tiles_x, tiles_y,
                                 tri_class)[-1]
        out[f"main_{b}"] = dropped
    # shadow raster binning at the scheduled light
    _, _, slight, sface, sdo = SHD.choose_light(shadow_state, world,
                                                camera.position)
    spv = SHD.light_proj_view(world, slight, face=sface)
    sbatch = build_triangle_batch(world, bank, camera,
                                  max_tris=eng.config.shadow_max_tris,
                                  apply_lov=True, proj_view=spv,
                                  depth_only=True,
                                  lov_bias=eng.config.shadow_lov_bias)
    res = eng.config.shadow_resolution
    sb2 = to_screen(sbatch, res, res)
    base = SHD.shadow_raster_cfg(eng.config.shadow_max_tris)
    s_tx, s_ty = -(-res // base.tile_w), -(-res // base.tile_h)
    for b in BUDGETS:
        scfg = dataclasses.replace(base, tile_budget=b)
        _, _, _, sd = _bin_triangles(sb2, scfg, s_tx, s_ty)
        out[f"shadow_{b}"] = jnp.where(sdo, sd, 0)
    return out

for i in range(3):
    eng.frame(InputState.idle(i), dt=1 / 60, render=False)
fidx = 100
for w in range(3):
    for i in range(50):
        eng.frame(InputState.idle(fidx), dt=1 / 60, render=False)
        fidx += 1
    # advance the shadow schedule by hand (render=False skips it): the
    # counter only needs choose_light's pick, which cycles with cursor
    vals = {k: int(v) for k, v in overflow_counts(
        eng.world, eng.camera, eng.shadow_state).items()}
    print(f"window {w+1}:", vals)
