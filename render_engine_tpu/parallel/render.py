"""Multi-device frame rendering: shard_map over image tile rows.

The single-device tiled frame (render/frame.py tiled_fused_core) runs
unchanged on every rank over its slice of tile ROWS; pallas_call does not
auto-partition under a sharded jit, so the partitioning is explicit:

  * geometry + light extraction run in the surrounding (auto-sharded) jit
    over the entity-sharded world — XLA inserts the collectives the
    cumsum/sort/scatter expansion needs, and the budgeted TriangleBatch
    comes out replicated (it is small: max_tris x ~50 channels);
  * shard_map splits the screen into n contiguous row bands; each rank
    shifts triangle y coordinates into its local frame, bins, rasters,
    resolves, and fused-shades ONLY its rows (the same kernels as the
    single-device frame), including shadow-slot PCF factors;
  * the background (starfield/cubemap/clear) is computed in the outer jit
    with row sharding, so each rank receives exactly its band;
  * the output image is row-sharded (P(axis)) — no gather unless the host
    reads it back.

The image height is padded so every rank gets a whole number of 8-row
tiles; the pad rows are cropped after the shard_map.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from render_engine_tpu.render import lighting as L
from render_engine_tpu.render import skybox as SB
from render_engine_tpu.render.frame import RenderSettings, tiled_fused_core
from render_engine_tpu.render.geometry import build_triangle_batch, to_screen


def render_frame_sharded(
    world,
    camera,
    bank,
    settings: RenderSettings,
    mesh,
    *,
    cubemap=None,
    atlas=None,
    shadow_state=None,
    systems=None,
    inputs=None,
    axis_name: str = "world",
):
    """Deferred-render one frame with tile rows sharded over ``mesh``.

    Call under ``jit`` with the world entity-sharded (parallel/mesh.py);
    returns a row-sharded (H, W, 3) image. Always runs the tile kernels
    (compiled on the GPU, interpreted on the CPU). ``atlas``: an optional
    TextureAtlas, replicated to every rank — the texture resolve runs per rank on its own tile
    band (UV interpolation is local-coordinate, so row shifting is safe).
    """
    n = mesh.shape[axis_name]
    h, w = settings.height, settings.width
    th = settings.raster.tile_h
    # pad so each rank owns a whole number of tile rows
    band = -(-h // (n * th)) * th  # rows per rank, multiple of tile_h
    hp = band * n

    # per-frame user draw callbacks run in the outer (auto-sharded) jit,
    # exactly like the single-device path; custom fragment shading rides the
    # fused kernels as a per-rank post-hook (frame._fused_custom_shading)
    draw_ctx = None
    if systems is not None and systems.has_draw_callbacks():
        from render_engine_tpu.render.render_system import (
            run_draw_callbacks,
        )

        draw_ctx = run_draw_callbacks(systems, world, camera, inputs, bank)

    batch = build_triangle_batch(
        world, bank, camera, max_tris=settings.max_tris, systems=systems,
        instance_mask=None if draw_ctx is None else draw_ctx.allowed,
    )
    batch = to_screen(batch, w, h)

    # per-triangle system ids for the custom-shading post-hook: computed in
    # the outer jit (needs the entity-sharded world), replicated into ranks
    tri_sys = None
    if systems is not None and systems.has_shade_callbacks():
        from render_engine_tpu.render.render_system import (
            triangle_system_ids,
        )

        tri_sys = triangle_system_ids(batch, world, systems)

    ent_attrs = None
    if systems is not None:
        from render_engine_tpu.render.render_system import entity_shade_attrs

        ent_attrs = entity_shade_attrs(
            world, systems,
            sys_table=None if draw_ctx is None else draw_ctx.sys_table)

    lights = L.extract_lights(
        world,
        max_dir=settings.max_dir_lights,
        max_point=settings.max_point_lights,
        max_spot=settings.max_spot_lights,
    )

    # background at the real image size (star and ray positions scale with
    # the height), padded to the band rows (extra rows are cropped);
    # background_for handles every skybox kind incl. CubemapRows
    background = SB.background_for(camera, cubemap, h, w,
                                   settings.clear_color)
    background = jnp.pad(background, ((0, hp - h), (0, 0), (0, 0)))
    if draw_ctx is not None and draw_ctx.skybox_on is not None:
        background = jnp.where(
            jnp.asarray(draw_ctx.skybox_on, bool), background,
            jnp.asarray(settings.clear_color, jnp.float32))

    # optional args can be None — build the arg/spec lists dynamically so
    # the pytree structures line up
    extras = []
    extra_specs = []
    has_attrs = ent_attrs is not None
    has_shadow = shadow_state is not None
    has_atlas = atlas is not None
    if has_attrs:
        extras.append(ent_attrs)
        extra_specs.append(P())
    if has_shadow:
        extras.append(shadow_state)
        extra_specs.append(P())
    if has_atlas:
        extras.append(atlas)
        extra_specs.append(P())

    def rank_body(batch, lights, background_rows, *rest):
        it = iter(rest)
        ea = next(it) if has_attrs else None
        ss = next(it) if has_shadow else None
        at = next(it) if has_atlas else None
        r = jax.lax.axis_index(axis_name)
        y_off = (r * band).astype(jnp.float32)
        local = dataclasses.replace(
            batch,
            xy=batch.xy - jnp.stack(
                [jnp.float32(0.0), y_off])[None, None, :],
        )
        img = tiled_fused_core(
            local, lights, bank, settings, camera,
            width=w, h_total=h, h_local=band, y_off=y_off,
            background=background_rows[0], shadow_state=ss,
            ent_attrs=ea, atlas=at,
            systems=systems, draw_ctx=draw_ctx, tri_sys=tri_sys,
        )
        return img[None]  # leading rank axis for the sharded output

    rep = P()
    img = jax.shard_map(
        rank_body, mesh=mesh,
        in_specs=(rep, rep, P(axis_name), *extra_specs),
        out_specs=P(axis_name),
        check_vma=False,
    )(batch, lights, background.reshape(n, band, w, 3), *extras)
    return img.reshape(hp, w, 3)[:h]
