"""Frame composition: world -> final (H, W, 3) image.

The RenderFlow + RenderSystem::draw orchestration (src/flows/render_flow.rs:
247-335, src/render_system/render_system.rs:410-595) as one pure function:
opaque G-buffer pass, deferred lighting, skybox for background pixels, then
a forward transparency pass blended over the lit image (the reference draws
transparency after lighting in the first pass target,
render_system.rs:501)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp

from render_engine_tpu import platform
from render_engine_tpu.ecs.world import World
from render_engine_tpu.math import transforms as T
from render_engine_tpu.models.bank import ModelBank
from render_engine_tpu.render import lighting as L
from render_engine_tpu.render import skybox as SB
from render_engine_tpu.render.geometry import build_triangle_batch, to_screen
from render_engine_tpu.render.raster_jnp import (
    RasterConfig,
    rasterize_depth_winner,
    resolve_gbuffer,
)


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    width: int = 800
    height: int = 600
    max_tris: int = 16384
    raster: RasterConfig = RasterConfig()
    max_dir_lights: int = 4
    max_point_lights: int = 64
    max_spot_lights: int = 16
    clear_color: tuple = (0.0, 0.0, 0.0)
    # render path: "auto" asks the platform switch (render_engine_tpu.
    # platform: the tiled kernel path on the GPU, the jnp golden path on the
    # CPU); "tiled" / "jnp" name a path explicitly (tests compare both)
    backend: str = "auto"
    # tiled path only: shade with the fused Pallas kernel (True), or with
    # XLA on the tile buffers (False; also taken when a caller passes a
    # custom ``shadow_factor``, which cannot run inside the kernel)
    fused_shading: bool = True
    # atlas sampling on the fused path: texture the transparent layer only
    # when asked (each layer costs one full-screen row gather)
    texture_transparent: bool = False
    # coverage-compacted gathers: PCF / texture row gathers (the latency
    # wall, ~10 ns/row) run only for the most-occupied fraction of screen
    # tiles. 1.0 = every tile (exact); lower trades sky-tile gather cost
    # for conservative-lit / untextured overflow tiles when the screen is
    # denser than the budget — the engine's usual budgeted conservatism.
    shadow_tile_budget: float = 1.0
    texture_tile_budget: float = 1.0
    # per-tile light culling on the fused path (the reference's
    # light-volume second pass, second_pass_vertex.glsl:1-20, as tile
    # lists): each tile's light loop covers only lights whose influence
    # sphere intersects its view pyramid, bit-identical to the full loop
    # until a tile exceeds this many lights (then counted in
    # light_tile_overflow). 0 = off (loop every light per tile): the
    # dense loop already runs only the LIVE light count, so scenes with a
    # handful of lights gain nothing and pay the per-frame tile cull;
    # many-light scenes set ~96 (run_benchmarks.py's lights config does).
    light_tile_budget: int = 0

    def __hash__(self):
        return hash((self.width, self.height, self.max_tris,
                     tuple(dataclasses.astuple(self.raster)),
                     self.max_dir_lights, self.max_point_lights,
                     self.max_spot_lights, self.clear_color, self.backend,
                     self.fused_shading, self.texture_transparent,
                     self.shadow_tile_budget, self.texture_tile_budget,
                     self.light_tile_budget))


def pick_rasterizer(backend: str = "auto"):
    """Select the depth/winner rasterizer implementation (the tile kernel
    or the jnp reference) through the platform switch."""
    from render_engine_tpu.render.raster_pallas import (
        rasterize_depth_winner_pallas,
    )

    if platform.use_tiled_path(backend):
        return rasterize_depth_winner_pallas
    return rasterize_depth_winner


def _gate_skybox(background, skybox_on, settings):
    """Apply a per-frame DrawParam skybox toggle (None = configured
    default): off replaces the sampled background with the clear color."""
    if skybox_on is None:
        return background
    return jnp.where(jnp.asarray(skybox_on, bool), background,
                     jnp.asarray(settings.clear_color, jnp.float32))


def render_frame(
    world: World,
    camera,
    bank: ModelBank,
    settings: RenderSettings,
    *,
    cubemap: Optional[jnp.ndarray] = None,
    atlas=None,
    shadow_state=None,
    shadow_factor=None,
    systems=None,
    inputs=None,
) -> jnp.ndarray:
    """Deferred-render one frame. Returns float32 (H, W, 3) linear color.

    ``shadow_state``: a shadows.ShadowState whose maps PCF-attenuate the
    matching lights; ``shadow_factor`` overrides it with a custom callback.
    NOTE: a custom ``shadow_factor`` forfeits the fused Pallas shading
    kernel — the frame drops to the tiled XLA path (the callback's
    arbitrary Python can't run inside the kernel's light loop), which
    costs several ms at 1080p. The built-in PCF path (shadow_state alone)
    stays fused.
    ``systems``: optional render_system.CompiledSystems — user render
    systems folded into the single fused pass as per-triangle data (model
    routing, LoV gating, unlit/emissive boost, tint/alpha uniforms), plus
    per-frame DrawParam callbacks when any system registers one.
    ``inputs``: the frame's InputState, exposed to draw callbacks
    (DrawParam.get_input_history); optional.
    """
    h, w = settings.height, settings.width
    rasterizer = pick_rasterizer(settings.backend)

    # per-frame user draw callbacks (DrawParam): instance gating, traced
    # uniform rows, skybox toggle (rendering.rs:57-396 semantics as data)
    draw_ctx = None
    if systems is not None and systems.has_draw_callbacks():
        from render_engine_tpu.render.render_system import run_draw_callbacks

        draw_ctx = run_draw_callbacks(systems, world, camera, inputs, bank)

    batch = build_triangle_batch(
        world, bank, camera, max_tris=settings.max_tris, systems=systems,
        instance_mask=None if draw_ctx is None else draw_ctx.allowed,
    )
    batch = to_screen(batch, w, h)

    ent_attrs = None
    if systems is not None:
        from render_engine_tpu.render.render_system import entity_shade_attrs

        ent_attrs = entity_shade_attrs(
            world, systems,
            sys_table=None if draw_ctx is None else draw_ctx.sys_table)

    # --- raster: opaque + transparent layers ----------------------------
    from render_engine_tpu.render.raster_pallas import (
        rasterize_depth_winner_pallas,
    )

    extras = t_extras = None
    if rasterizer is rasterize_depth_winner_pallas:
        # fully tiled fast path: raster + resolve + shading stay in the
        # (NT*th, tw) "tall image" layout; only the final color untiles
        return _render_frame_pallas_tiled(
            world, camera, bank, settings,
            cubemap=cubemap, atlas=atlas, shadow_state=shadow_state,
            shadow_factor=shadow_factor, batch=batch, ent_attrs=ent_attrs,
            systems=systems, draw_ctx=draw_ctx,
        )
    else:
        depth, winner = rasterizer(batch, h, w, settings.raster,
                                   ~batch.transparent)
        t_depth, t_winner = rasterizer(batch, h, w, settings.raster,
                                       batch.transparent)
        spec_img = t_spec_img = emis_mul = t_emis_mul = None
        with_spec = atlas is not None and bank.has_specular_maps()
        with_emis = atlas is not None and bank.has_emissive_maps()
        # dissolve maps only matter on the transparent layer (per-pixel
        # alpha); the opaque resolve never samples them
        with_diss = atlas is not None and bank.has_dissolve_maps()

        def _resolve(d_, wn_, dissolve):
            # per-pixel specular/emissive/dissolve maps (trace-time gates:
            # scenes without them skip the extra sampling entirely);
            # resolve_gbuffer appends images by flag order
            out = resolve_gbuffer(
                batch, bank, d_, wn_, atlas=atlas, with_specular=with_spec,
                with_emissive=with_emis, with_dissolve=dissolve)
            if not (with_spec or with_emis or dissolve):
                return out, None, None, None
            out = list(out)
            g = out.pop(0)
            spec = out.pop(0) if (with_spec or with_emis) else None
            emis = out.pop(0) if with_emis else None
            diss = out.pop(0) if dissolve else None
            return g, spec, emis, diss

        gbuf, spec_img, emis_mul, _ = _resolve(depth, winner, False)
        t_gbuf, t_spec_img, t_emis_mul, t_diss_mul = _resolve(
            t_depth, t_winner, with_diss)
        if with_emis:
            # fold the emissive-map multiplier into explicit per-pixel
            # emissive images (the systems path multiplies ITS boosted
            # values below instead)
            def em_base(g):
                m = jnp.clip(g.material, 0, bank.mat_emissive.shape[0] - 1)
                return bank.mat_emissive[m]

            extras = {"emissive": em_base(gbuf) * emis_mul}
            t_extras = {
                "emissive": em_base(t_gbuf) * t_emis_mul,
                "alpha": jnp.clip(
                    bank.mat_alpha[jnp.clip(
                        t_gbuf.material, 0, bank.mat_alpha.shape[0] - 1)],
                    0.0, 1.0),
            }
        if ent_attrs is not None:
            # golden-path system semantics: per-pixel tint/emissive/alpha
            # from the winner triangle's entity's system row
            sa = ent_attrs[jnp.clip(batch.entity, 0, world.capacity - 1)]
            mat_safe = jnp.clip(batch.material, 0,
                                bank.mat_emissive.shape[0] - 1)
            tri_em = jnp.where(sa[:, 0] > 0.5,
                               jnp.maximum(bank.mat_emissive[mat_safe], 1.0)
                               * sa[:, 1],
                               bank.mat_emissive[mat_safe])
            tri_tint = sa[:, 2:5]
            tri_ascale = sa[:, 5]

            def apply_sys(g):
                tri = jnp.clip(g.tri_id, 0, batch.budget - 1)
                cm = g.covered()
                alb = g.albedo * jnp.where(cm[..., None], tri_tint[tri], 1.0)
                em = jnp.where(cm, tri_em[tri], 0.0)
                asc = jnp.where(cm, tri_ascale[tri], 1.0)
                return dataclasses.replace(g, albedo=alb), em, asc

            gbuf, em_img, _ = apply_sys(gbuf)
            t_gbuf, t_em_img, t_asc = apply_sys(t_gbuf)
            if emis_mul is not None:
                em_img = em_img * emis_mul
                t_em_img = t_em_img * t_emis_mul
            extras = {"emissive": em_img}
            t_extras = {
                "emissive": t_em_img,
                "alpha": jnp.clip(
                    bank.mat_alpha[
                        jnp.clip(t_gbuf.material, 0,
                                 bank.mat_alpha.shape[0] - 1)
                    ] * t_asc, 0.0, 1.0),
            }

    # --- lights (visible-light upload analogue) -------------------------
    lights = L.extract_lights(
        world,
        max_dir=settings.max_dir_lights,
        max_point=settings.max_point_lights,
        max_spot=settings.max_spot_lights,
    )

    if shadow_factor is None and shadow_state is not None:
        from render_engine_tpu.render.shadows import make_shadow_factor

        shadow_factor = make_shadow_factor(
            shadow_state, world,
            {"dir": lights.dir_entity, "spot": lights.sp_entity,
             "point": lights.pt_entity},
        )

    # --- background: starfield splats, cubemap rows, or clear color -----
    background = SB.background_for(camera, cubemap, h, w,
                                   settings.clear_color)
    background = _gate_skybox(
        background, None if draw_ctx is None else draw_ctx.skybox_on,
        settings)

    color = L.shade(
        gbuf, lights, bank, camera.position,
        background=background, shadow_factor=shadow_factor,
        emissive_image=None if extras is None else extras["emissive"],
        specular_image=spec_img,
    )
    if systems is not None and systems.has_shade_callbacks():
        from render_engine_tpu.render.render_system import (
            apply_custom_shading,
        )

        color = apply_custom_shading(color, gbuf, winner, batch, world,
                                     camera, lights, systems, draw_ctx)

    # --- transparency: single-layer forward pass over the lit image -----
    # (no shadow sampling: the reference draws transparency forward after
    # the second pass without shadow lookups, render_system.rs:501)
    t_lit = L.shade(
        gbuf=t_gbuf, lights=lights, bank=bank,
        camera_position=camera.position, background=color,
        shadow_factor=None,
        emissive_image=None if t_extras is None else t_extras["emissive"],
        specular_image=t_spec_img,
    )
    if systems is not None and systems.has_shade_callbacks():
        # user shader bodies shade the transparent layer too
        # (render_system.rs:501)
        t_lit = apply_custom_shading(t_lit, t_gbuf, t_winner, batch, world,
                                     camera, lights, systems, draw_ctx)
    if t_extras is not None:
        alpha = t_extras["alpha"][..., None]
    else:
        mat = jnp.clip(t_gbuf.material, 0, bank.mat_alpha.shape[0] - 1)
        alpha = bank.mat_alpha[mat][..., None]
    if t_diss_mul is not None:
        # dissolve map (map_d, fifth pair): per-pixel alpha multiplier
        alpha = alpha * t_diss_mul[..., None]
    in_front = t_gbuf.covered() & (t_gbuf.depth <= gbuf.depth)
    color = jnp.where(
        in_front[..., None], alpha * t_lit + (1.0 - alpha) * color, color
    )

    return jnp.clip(color, 0.0, 1.0)


def _unproject_tiled(d, tiles_x, th, twd, width, height, inv_pv,
                     y_off=0.0, tids=None, stride=1):
    """World positions from tiled depth (NT, th, tw) -> (NT, th, tw, 3).
    ``y_off``: global row of this buffer's first tile row (row sharding).
    ``tids``: optional tile ids when ``d`` is a compacted tile subset.
    ``stride``: when ``d`` is already a pixel-subsampled tile (every
    stride-th pixel, phase 0), generate the matching strided centers —
    identical values to unprojecting full tiles then striding, without
    striding a computed array."""
    nt = d.shape[0]
    if tids is None:
        tids = jnp.arange(nt, dtype=jnp.int32)
    oy = ((tids // tiles_x) * th).astype(jnp.float32) + y_off
    ox = ((tids % tiles_x) * twd).astype(jnp.float32)
    py = (oy[:, None, None]
          + jnp.arange(d.shape[1], dtype=jnp.float32)[None, :, None] * stride
          + 0.5)
    px = (ox[:, None, None]
          + jnp.arange(d.shape[2], dtype=jnp.float32)[None, None, :] * stride
          + 0.5)
    ndc = jnp.stack(
        [jnp.broadcast_to(px / width * 2.0 - 1.0, d.shape),
         jnp.broadcast_to(1.0 - py / height * 2.0, d.shape),
         d, jnp.ones_like(d)], axis=-1)
    wp = jnp.einsum("ij,...j->...i", inv_pv, ndc, precision=T.MM_PRECISION)
    return wp[..., :3] / jnp.where(
        jnp.abs(wp[..., 3:4]) > 1e-12, wp[..., 3:4], 1.0)


def _texture_override(res, atlas, tiles_x, th, twd, tids=None,
                      with_spec=False, with_emis=False, with_norm=False,
                      with_diss=False):
    """Per-pixel textured albedo from the resolve channels: barycentric UV
    interpolation (elementwise) + ONE bilinear row gather from the atlas,
    at full resolution.
    ``tids``: optional (NT_sel,) tile ids when ``res`` is a compacted tile
    subset. Returns (4, NT[_sel], th, tw): [rgb | flag]; with
    ``with_spec`` (5, ...): [rgb | flag | spec DELTA]; with ``with_emis``
    (6, ...): [... | emissive DELTA]. Delta channels are stored as
    (map_sample - 1) where the material carries that map, else 0 — the
    kernel applies value * (1 + delta), so zero-filled unselected tiles
    and map-less materials read as neutral while a black texel still
    kills the highlight/glow."""
    from render_engine_tpu.render.textures import sample_atlas_rows

    a, nt = res.shape[0], res.shape[1]
    ch = res.reshape(a, nt * th, twd)
    if tids is None:
        tids = jnp.arange(nt, dtype=jnp.int32)
    oy = ((tids // tiles_x) * th).astype(jnp.float32)
    ox = ((tids % tiles_x) * twd).astype(jnp.float32)
    py = (oy[:, None, None]
          + jnp.arange(th, dtype=jnp.float32)[None, :, None] + 0.5)
    px = (ox[:, None, None]
          + jnp.arange(twd, dtype=jnp.float32)[None, None, :] + 0.5)
    py = jnp.broadcast_to(py, (nt, th, twd)).reshape(nt * th, twd)
    px = jnp.broadcast_to(px, (nt, th, twd)).reshape(nt * th, twd)

    x0, y0, x1, y1, x2, y2 = ch[0], ch[1], ch[2], ch[3], ch[4], ch[5]
    l0 = (x2 - x1) * (py - y1) - (y2 - y1) * (px - x1)
    l1 = (x0 - x2) * (py - y2) - (y0 - y2) * (px - x2)
    l2 = (x1 - x0) * (py - y0) - (y1 - y0) * (px - x0)
    area = l0 + l1 + l2
    inv_area = 1.0 / jnp.where(jnp.abs(area) > 1e-12, area, 1.0)
    b0, b1, b2 = l0 * inv_area, l1 * inv_area, l2 * inv_area
    w0, w1, w2 = b0 * ch[25], b1 * ch[26], b2 * ch[27]
    denom = w0 + w1 + w2
    inv_d = 1.0 / jnp.where(jnp.abs(denom) > 1e-12, denom, 1.0)
    p0, p1, p2 = w0 * inv_d, w1 * inv_d, w2 * inv_d
    u = p0 * ch[19] + p1 * ch[21] + p2 * ch[23]
    v = p0 * ch[20] + p1 * ch[22] + p2 * ch[24]
    layer = ch[35]
    uv = jnp.stack([u, v], axis=-1)
    rgb = sample_atlas_rows(
        atlas, layer, uv,
        jnp.stack([ch[36], ch[37], ch[38], ch[39]], axis=-1),
    )  # (rows, cols, 3)
    flag = (layer >= 0.0).astype(jnp.float32)
    # channel indices are FIXED (spec @4, emis @5, diss @6): a later role
    # forces the earlier slots to exist, neutral-zero when the scene has
    # no such maps (their layer columns are -1)
    parts = [rgb, flag[..., None]]
    if with_spec or with_emis or with_diss:
        slayer = ch[40]
        smul = sample_atlas_rows(
            atlas, slayer, uv,
            jnp.stack([ch[41], ch[42], ch[43], ch[44]], axis=-1),
        )[..., 0]
        delta = jnp.where(slayer >= 0.0, smul - 1.0, 0.0)
        parts.append(delta[..., None])
    if with_emis or with_diss:
        elayer = ch[45]
        emul = sample_atlas_rows(
            atlas, elayer, uv,
            jnp.stack([ch[46], ch[47], ch[48], ch[49]], axis=-1),
        )[..., 0]
        edelta = jnp.where(elayer >= 0.0, emul - 1.0, 0.0)
        parts.append(edelta[..., None])
    if with_diss:
        # dissolve-map delta: alpha multiplies by (1 + delta) in-kernel,
        # neutral zero for unselected tiles and map-less materials
        dlayer = ch[59]
        dmul = sample_atlas_rows(
            atlas, dlayer, uv,
            jnp.stack([ch[60], ch[61], ch[62], ch[63]], axis=-1),
        )[..., 0]
        ddelta = jnp.where(dlayer >= 0.0, dmul - 1.0, 0.0)
        parts.append(ddelta[..., None])
    if with_norm:
        # LAST 4 channels: perturbed world normal + use-flag (the kernel
        # replaces its interpolated normal where the flag is set; zero-
        # filled unselected tiles keep the geometric normal)
        from render_engine_tpu.render.geometry import perturb_normal

        nrm = jnp.stack(
            [p0 * ch[10] + p1 * ch[13] + p2 * ch[16],
             p0 * ch[11] + p1 * ch[14] + p2 * ch[17],
             p0 * ch[12] + p1 * ch[15] + p2 * ch[18]], axis=-1)
        nlen = jnp.linalg.norm(nrm, axis=-1, keepdims=True)
        nrm = nrm / jnp.where(nlen > 1e-12, nlen, 1.0)
        nlayer = ch[50]
        nsamp = sample_atlas_rows(
            atlas, nlayer, uv,
            jnp.stack([ch[51], ch[52], ch[53], ch[54]], axis=-1))
        tan = jnp.stack([ch[55], ch[56], ch[57]], axis=-1)
        pert = perturb_normal(nrm, tan, ch[58], nsamp)
        nflag = (nlayer >= 0.0).astype(jnp.float32)
        parts.append(jnp.where(nflag[..., None] > 0.0, pert, 0.0))
        parts.append(nflag[..., None])
    out = jnp.concatenate(parts, axis=-1)
    c = out.shape[-1]
    return jnp.moveaxis(out, -1, 0).reshape(c, nt, th, twd)


def _tile_frustum_inputs(d, wn, tiles_x, th, twd, width, h_total, y_off):
    """Per-tile covered-pixel stats + conservative clip-space corner rays
    for the per-slot light-frustum tile test: returns (ncov, corners) with
    corners (NT, 8, 4) = the tile's screen rect x its covered depth range
    in camera NDC homogeneous coords."""
    nt = d.shape[0]
    cov = wn >= 0
    ncov = jnp.sum(cov.astype(jnp.int32), axis=(1, 2))  # (nt,)
    big = jnp.float32(1e9)
    dmin = jnp.min(jnp.where(cov, d, big), axis=(1, 2))
    dmax = jnp.max(jnp.where(cov, d, -big), axis=(1, 2))

    tids = jnp.arange(nt, dtype=jnp.int32)
    oy = (tids // tiles_x * th).astype(jnp.float32) + y_off
    ox = (tids % tiles_x * twd).astype(jnp.float32)
    x0 = ox / width * 2.0 - 1.0
    x1 = (ox + twd) / width * 2.0 - 1.0
    y0 = 1.0 - oy / h_total * 2.0
    y1 = 1.0 - (oy + th) / h_total * 2.0
    cx = jnp.stack([x0, x1, x0, x1] * 2, axis=1)
    cy = jnp.stack([y0, y0, y1, y1] * 2, axis=1)
    cz = jnp.stack([dmin] * 4 + [dmax] * 4, axis=1)
    corners = jnp.stack([cx, cy, cz, jnp.ones_like(cx)], axis=-1)
    return ncov, corners


def _frustum_need(m, corners, ncov):
    """(NT,) tiles that may contain a pixel inside the light frustum
    ``m`` = light_mat @ inv_pv (conservative: a tile is culled only when
    all 8 corners fail one clip plane — a LINEAR condition on the
    homogeneous corner vectors, so it bounds the whole projective hull;
    culled tiles are exactly lit by pcf_factor's inside mask)."""
    clip = jnp.matmul(corners, m.T, precision=T.MM_PRECISION)
    x, y, z, w = clip[..., 0], clip[..., 1], clip[..., 2], clip[..., 3]
    culled = (jnp.all(x + w < 0, 1) | jnp.all(x - w > 0, 1)
              | jnp.all(y + w < 0, 1) | jnp.all(y - w > 0, 1)
              | jnp.all(z - w > 0, 1) | jnp.all(w <= 0, 1))
    return (~culled) & (ncov > 0)


def shadow_tile_overflow(shadow, d, wn, tiles_x, th, twd, width, h_total,
                         inv_pv, y_off, frac):
    """Max over active slots of (frustum-needed tiles - per-slot budget):
    the EXACT count of tiles whose PCF degraded to lit this frame (the
    drop-stats analogue of the reference's soft-error prints)."""
    nt = d.shape[0]
    tb = max(1, int(round(nt * frac)))
    ncov, corners = _tile_frustum_inputs(d, wn, tiles_x, th, twd, width,
                                         h_total, y_off)
    over = jnp.int32(0)
    for s in range(shadow.slot_entity.shape[0]):
        m = T.mm44(shadow.light_mats[s], inv_pv)
        need = jnp.sum(_frustum_need(m, corners, ncov).astype(jnp.int32))
        need = jnp.where(shadow.slot_entity[s] >= 0, need, 0)
        over = jnp.maximum(over, jnp.maximum(need - tb, 0))
    return over


def _per_slot_factor_tiles(shadow, d, wn, tiles_x, th, twd, width, h_total,
                           inv_pv, y_off, frac):
    """COMPACT per-shadow-slot PCF factor tiles: (S, TB, th, tw) factors +
    an (S, NT) int32 inverse map (tile -> its row in the slot's compact
    buffer, -1 = not selected, treated as lit). Rows are gathered ONLY for
    tiles that conservatively intersect the slot's light frustum.

    The PCF row gather is latency-bound, so the win is per-slot ROW
    reduction: a spot light's frustum covers a fraction of the screen,
    and any tile fully outside it is exactly lit (pcf_factor's ``inside``
    mask returns 1 there) — culling those tiles is lossless. The test is
    conservative in clip space: the tile's screen rect x its covered-pixel
    depth range maps (projectively, so corners bound the hull) through
    light_mat @ inv_pv; a tile whose 8 corners all fail one clip plane
    cannot contain a shadowed pixel. Per slot, the densest intersecting
    tiles fill a static budget of round(NT * frac); overflow degrades to
    lit (counted in drop stats as shadow_tile_overflow). The compact form
    feeds the fused kernel, whose programs read their own tile's inverse
    map rows — the dense (S, NT, th, tw) factor image is never
    materialized in device memory."""
    from render_engine_tpu.render import shadows as SHD

    nt = d.shape[0]
    n_slots = shadow.slot_entity.shape[0]
    tb = max(1, int(round(nt * frac)))
    ncov, corners = _tile_frustum_inputs(d, wn, tiles_x, th, twd, width,
                                         h_total, y_off)

    k = shadow.pcf_scale
    # pcf_scale subsample ONCE, shared by every slot (once on the depth
    # image, not per slot on the 3x-wider unprojected positions),
    # flattened so per-slot tile
    # selection is one contiguous row gather. The subsampled pixels' camera
    # NDC x/y ride the SAME (NT, 3*sh*sw) row table, so each slot's cond
    # is one row gather + the composed-matrix transform — the per-slot
    # world-position unprojection cancels projectively (see
    # shadows.pcf_factor_from_clip).
    ds = d[:, ::k, ::k] if k > 1 else d
    sh, sw = ds.shape[1], ds.shape[2]
    tids_all = jnp.arange(nt, dtype=jnp.int32)
    oy = ((tids_all // tiles_x) * th).astype(jnp.float32) + jnp.float32(y_off)
    ox = ((tids_all % tiles_x) * twd).astype(jnp.float32)
    py = (oy[:, None, None]
          + jnp.arange(sh, dtype=jnp.float32)[None, :, None] * k + 0.5)
    px = (ox[:, None, None]
          + jnp.arange(sw, dtype=jnp.float32)[None, None, :] * k + 0.5)
    ndc_x = jnp.broadcast_to(px, (nt, sh, sw)) / jnp.float32(width) \
        * 2.0 - 1.0
    ndc_y = 1.0 - jnp.broadcast_to(py, (nt, sh, sw)) \
        / jnp.float32(h_total) * 2.0
    rows_tab = jnp.concatenate(
        [ds.reshape(nt, sh * sw), ndc_x.reshape(nt, sh * sw),
         ndc_y.reshape(nt, sh * sw)], axis=1)  # (NT, 3*sh*sw)

    # batched per-slot frustum need + tile selection, hoisted OUT of the
    # conds (vector math + S small sorts; the conds keep only the
    # latency-bound gathers and the factor math)
    m_all = jax.vmap(lambda lm: T.mm44(lm, inv_pv))(
        shadow.light_mats)  # (S, 4, 4) camera NDC -> light clip
    clip_all = jnp.einsum("tcj,sij->stci", corners, m_all,
                          precision=T.MM_PRECISION)  # (S, NT, 8, 4)
    xs, ys_, zs, ws = (clip_all[..., 0], clip_all[..., 1],
                       clip_all[..., 2], clip_all[..., 3])
    culled = (jnp.all(xs + ws < 0, -1) | jnp.all(xs - ws > 0, -1)
              | jnp.all(ys_ + ws < 0, -1) | jnp.all(ys_ - ws > 0, -1)
              | jnp.all(zs - ws > 0, -1) | jnp.all(ws <= 0, -1))
    need_all = (~culled) & (ncov > 0)[None, :]  # (S, NT)
    key_all = jnp.where(need_all, ncov[None, :], -1)
    sel_all = jnp.argsort(-key_all, axis=1, stable=True).astype(
        jnp.int32)[:, :tb]  # (S, tb)

    facs, invs = [], []
    for s in range(n_slots):
        def active(s=s):
            sel = sel_all[s]
            rows = rows_tab[sel]  # ONE (tb, 3*sh*sw) row gather
            dsub = rows[:, :sh * sw].reshape(tb, sh, sw)
            nx = rows[:, sh * sw:2 * sh * sw].reshape(tb, sh, sw)
            ny = rows[:, 2 * sh * sw:].reshape(tb, sh, sw)
            m = m_all[s]
            cx = m[0, 0] * nx + m[0, 1] * ny + m[0, 2] * dsub + m[0, 3]
            cy = m[1, 0] * nx + m[1, 1] * ny + m[1, 2] * dsub + m[1, 3]
            cz = m[2, 0] * nx + m[2, 1] * ny + m[2, 2] * dsub + m[2, 3]
            cw = m[3, 0] * nx + m[3, 1] * ny + m[3, 2] * dsub + m[3, 3]
            f = SHD.pcf_factor_from_clip(shadow, s, cx, cy, cz, cw)
            if k > 1:
                f = jnp.repeat(jnp.repeat(f, k, axis=-2), k, axis=-1)
                f = f[:, :th, :twd]
            # budget-underflow rows point at non-needed tiles: unmap them
            # (the kernel treats inv < 0 as lit; their factor rows are
            # never read)
            inv = jnp.full(nt, -1, jnp.int32).at[sel].set(
                jnp.where(need_all[s][sel],
                          jnp.arange(tb, dtype=jnp.int32), -1))
            return f, inv

        f_s, inv_s = jax.lax.cond(
            shadow.slot_entity[s] >= 0, active,
            lambda: (jnp.ones((tb, th, twd), jnp.float32),
                     jnp.full(nt, -1, jnp.int32)))
        facs.append(f_s)
        invs.append(inv_s)
    return jnp.stack(facs), jnp.stack(invs)


def _fused_custom_shading(shaded, s, d, wn, rows, cfg, tri_sys, camera,
                          lights, systems, uniform_writes, bank, atlas,
                          tiles_x, th, twd, width, h_total, y_off,
                          out_base=0, textured=True):
    """Custom fragment shading on the fused path — a post-kernel hook.

    The fused kernel resolves winner attributes in-kernel and never
    materializes the G-buffer, but user shade fns consume the G-buffer
    contract (ShadeParam). So pay the explicit attribute resolve ONLY when
    a system declares with_fragment_shading (trace-time gate) and rewrite
    the layer's color (kernel output channels [out_base:out_base+3] — 0:3
    opaque lit, 3:6 transparent t_lit; the reference runs its user
    transparency draw through the same generated program,
    render_system.rs:501) for the pixels those systems own. ``base_color``
    handed to the user fn is the kernel's own result, so shadows,
    tile-light culling, and texture overrides all fold in. ``textured``:
    whether the kernel textured THIS layer (the transparent layer only
    textures under texture_transparent/dissolve), so ShadeParam.albedo
    matches what the lighting consumed. This keeps user shader bodies on
    THE production path, as the reference does
    (src/render_system/initialize_logic.rs:137-185 splices user bodies
    into the one real pipeline)."""
    import dataclasses as _dc

    from render_engine_tpu.render import raster_pallas as RP
    from render_engine_tpu.render.render_system import shade_systems_color

    nt = s.shape[0]
    res = RP.resolve_attributes(s, rows)
    ch = res.reshape(res.shape[0], nt * th, twd)
    d_t = d.reshape(nt * th, twd)
    wn_t = wn.reshape(nt * th, twd)
    # pixel centers: the barycentrics need band-LOCAL y (the rank rasters
    # with y-shifted triangles), the NDC unproject needs the GLOBAL row —
    # h_total/width drive the unproject NDC mapping
    tids = jnp.arange(nt, dtype=jnp.int32)
    oy = ((tids // tiles_x) * th).astype(jnp.float32)
    ox = ((tids % tiles_x) * twd).astype(jnp.float32)
    py = (oy[:, None, None]
          + jnp.arange(th, dtype=jnp.float32)[None, :, None] + 0.5)
    px = (ox[:, None, None]
          + jnp.arange(twd, dtype=jnp.float32)[None, None, :] + 0.5)
    py = jnp.broadcast_to(py, (nt, th, twd)).reshape(nt * th, twd)
    px = jnp.broadcast_to(px, (nt, th, twd)).reshape(nt * th, twd)
    inv_pv = T.inv44(camera.proj_view())
    gbuf, extras = RP._gbuffer_from_channels(
        ch, d_t, wn_t, h_total, width, inv_pv, px=px, py=py,
        ndc_py=py + jnp.float32(y_off),
        spec_packed=bank.uniform_shininess() is None)
    if atlas is not None and textured:
        # ShadeParam.albedo/normal match what the lighting consumed (the
        # XLA path textures the G-buffer before shading)
        from render_engine_tpu.render.textures import sample_atlas

        mat_safe = jnp.clip(gbuf.material, 0,
                            bank.mat_textures.shape[0] - 1)
        layer = bank.mat_texture[mat_safe]
        tex = sample_atlas(atlas, layer, extras["uv"])
        normal = gbuf.normal
        if bank.has_normal_maps():
            from render_engine_tpu.render.geometry import perturb_normal

            nl_ = bank.mat_texture_norm[mat_safe]
            nsamp = sample_atlas(atlas, nl_, extras["uv"])
            pert = perturb_normal(gbuf.normal, extras["tangent"],
                                  extras["tangent_w"], nsamp)
            normal = jnp.where((nl_ >= 0)[..., None], pert, gbuf.normal)
        gbuf = _dc.replace(
            gbuf, normal=normal,
            albedo=jnp.where((layer >= 0)[..., None], tex, gbuf.albedo))
    covered = wn_t >= 0
    px_sys = tri_sys[jnp.clip(wn_t, 0, tri_sys.shape[0] - 1)]
    color = jnp.transpose(shaded[out_base:out_base + 3], (1, 2, 3, 0)
                          ).reshape(nt * th, twd, 3)
    color = shade_systems_color(color, gbuf, px_sys, covered, camera,
                                lights, systems, uniform_writes)
    color = jnp.transpose(color.reshape(nt, th, twd, 3), (3, 0, 1, 2))
    return shaded.at[out_base:out_base + 3].set(color)


def tiled_fused_core(
    batch, lights, bank, settings: RenderSettings, camera, *,
    width, h_total, h_local, y_off, background, shadow_state, ent_attrs,
    atlas=None, systems=None, draw_ctx=None, tri_sys=None,
) -> jnp.ndarray:
    """Raster + resolve + fused shading over tiles covering global image
    rows [y_off, y_off + h_local). ``batch.xy`` must be in LOCAL pixel
    coordinates (global y minus y_off) and ``background`` the matching
    (h_local, w, 3) rows. This is the per-rank body of the multi-chip
    sharded frame (parallel/render.py) and the whole frame when y_off=0.
    """
    from render_engine_tpu.render import raster_pallas as RP
    from render_engine_tpu.render.shade_pallas import fused_shade

    cfg = settings.raster
    th, twd = cfg.tile_h, cfg.tile_w
    tiles_x, tiles_y = -(-width // twd), -(-h_local // th)

    tri_class = jnp.where(
        batch.valid, jnp.where(batch.transparent, 2.0, 1.0), 0.0
    ).astype(jnp.float32)
    cand, counts = RP._candidate_table(batch, cfg, tiles_x, tiles_y, tri_class)
    packed = RP._packed_tri_table(batch, bank, tri_class, ent_attrs=ent_attrs,
                                  atlas=atlas)
    rows = RP._gather_candidate_rows(packed, cand)  # (NT, K, A)
    d, wn, s, td, twn, ts = RP._launch(
        batch, h_local, width, cfg, tri_class, two_pass=True,
        cand=cand, counts=counts,
    )
    # NOTE: no full-frame attribute resolve here — the fused shading kernel
    # resolves winner attributes in-kernel from ``rows`` (the per-layer
    # channel images never touch device memory). Only texture-selected
    # tiles get a small explicit resolve below for UV interpolation.

    albedo_override = None
    if atlas is not None:
        ntt = s.shape[0]
        ttb = max(1, int(round(ntt * settings.texture_tile_budget)))
        # spec/emissive/dissolve maps ride the same override block as
        # extra DELTA channels (trace-time gates: scenes without them keep
        # 4 channels; a later role forces the earlier slots so indices are
        # fixed); normal maps add 4 trailing channels (normal + flag)
        with_spec = bank.has_specular_maps()
        with_emis = bank.has_emissive_maps()
        with_norm = bank.has_normal_maps()
        with_diss = bank.has_dissolve_maps()
        if with_diss:
            n_base = 7
        elif with_emis:
            n_base = 6
        elif with_spec:
            n_base = 5
        else:
            n_base = 4
        n_ovr = n_base + (4 if with_norm else 0)
        # tiles with any textured CANDIDATE (conservative superset of
        # textured winners — avoids resolving every tile just to test).
        # One masked max over the row table's channel axis instead of one
        # strided channel select per role: the reduce is one pass.
        tex_ch = [35]
        if with_spec:
            tex_ch.append(40)
        if with_emis:
            tex_ch.append(45)
        if with_norm:
            tex_ch.append(50)
        if with_diss:
            tex_ch.append(59)
        chmask = jnp.zeros((rows.shape[-1],), bool).at[
            jnp.array(tex_ch, jnp.int32)].set(True)
        tex_tri = jnp.max(jnp.where(chmask, rows, -1.0), axis=-1) >= 0.0
        tex_cand = jnp.any((cand >= 0) & tex_tri, axis=1)

        def textured(slot):
            if ttb >= ntt:
                res = RP.resolve_attributes(slot, rows)
                return _texture_override(res, atlas, tiles_x, th, twd,
                                         with_spec=with_spec,
                                         with_emis=with_emis,
                                         with_norm=with_norm,
                                         with_diss=with_diss)
            order = jnp.argsort(jnp.where(tex_cand, 0, 1).astype(jnp.int32),
                                stable=True).astype(jnp.int32)
            sel = order[:ttb]
            res_sel = RP.resolve_attributes(slot[sel], rows[sel])
            ovr_sel = _texture_override(res_sel, atlas, tiles_x, th,
                                        twd, tids=sel, with_spec=with_spec,
                                        with_emis=with_emis,
                                        with_norm=with_norm,
                                        with_diss=with_diss)
            return jnp.zeros((n_ovr, ntt, th, twd),
                             jnp.float32).at[:, sel].set(ovr_sel)

        ovr_o = textured(s)
        if settings.texture_transparent or with_diss:
            # dissolve maps only act on the transparent pass, so they
            # force the transparent-layer texture resolve on
            ovr_t = textured(ts)
        else:
            ovr_t = jnp.zeros_like(ovr_o)
        albedo_override = jnp.concatenate([ovr_o, ovr_t])  # (2*n_ovr, ...)

    inv_pv = T.inv44(camera.proj_view())
    nt_ = d.shape[0]
    sft = sfi = sent = None
    if shadow_state is not None:
        # per-slot PCF factor tiles (COMPACT + inverse map): each slot
        # gathers rows only for the densest tiles intersecting ITS light
        # frustum (lossless cull — outside tiles are exactly lit), up to
        # shadow_tile_budget * NT tiles per slot. Overflow tiles stay lit
        # (counted in drops).
        sft, sfi = _per_slot_factor_tiles(
            shadow_state, d, wn, tiles_x, th, twd, width, h_total,
            inv_pv, y_off, settings.shadow_tile_budget)
        sent = shadow_state.slot_entity
    tile_lights = None
    if settings.light_tile_budget > 0:
        from render_engine_tpu.render.shade_pallas import (
            pack_lights,
            select_tile_lights,
        )

        lbud = (settings.max_dir_lights + settings.max_point_lights
                + settings.max_spot_lights)
        ltab_sel, n_live = pack_lights(lights, lbud)
        tlist, tcount, _light_drop = select_tile_lights(
            ltab_sel, n_live, camera.position, inv_pv, tiles_x, tiles_y,
            th, twd, width, h_total, y_off, settings.light_tile_budget)
        tile_lights = (tlist, tcount)
    uni_shin = bank.uniform_shininess()
    shaded = fused_shade(
        rows, s, ts, d, td, lights, camera.position, inv_pv,
        tiles_x, width, h_total, slot_factor_tiles=sft,
        slot_factor_inv=sfi, slot_entity=sent,
        pixel_origin=(0.0, y_off),
        albedo_override=albedo_override, tile_lights=tile_lights,
        with_norm=atlas is not None and bank.has_normal_maps(),
        with_diss=atlas is not None and bank.has_dissolve_maps(),
        spec_packed=uni_shin is None,
        shin_const=uni_shin if uni_shin is not None else 64.0,
    )  # (8, NT, th, tw)

    if (systems is not None and systems.has_shade_callbacks()
            and tri_sys is not None):
        uw = None if draw_ctx is None else draw_ctx.uniform_writes
        shaded = _fused_custom_shading(
            shaded, s, d, wn, rows, cfg, tri_sys, camera, lights, systems,
            uw, bank, atlas, tiles_x, th, twd, width, h_total, y_off)
        # the user program shades the transparent layer too
        # (render_system.rs:501 runs the user transparency draw through
        # the same generated program): rewrite t_lit (channels 3:6)
        shaded = _fused_custom_shading(
            shaded, ts, td, twn, rows, cfg, tri_sys, camera, lights,
            systems, uw, bank, atlas, tiles_x, th, twd, width, h_total,
            y_off, out_base=3,
            textured=settings.texture_transparent
            or (atlas is not None and bank.has_dissolve_maps()))

    def untile8(x):  # (C, NT, th, tw) -> (h_local, w, C)
        c = x.shape[0]
        x = x.reshape(c, tiles_y, tiles_x, th, twd)
        x = jnp.transpose(x, (1, 3, 2, 4, 0)).reshape(
            tiles_y * th, tiles_x * twd, c)[:h_local, :width]
        return x

    img = untile8(shaded)
    color_i, t_lit_i = img[..., 0:3], img[..., 3:6]
    alpha_i = img[..., 6:7]
    flags_i = img[..., 7]
    covered_i = (jnp.mod(flags_i, 2.0) >= 1.0)[..., None]
    t_front_i = (flags_i >= 2.0)[..., None]
    base = jnp.where(covered_i, color_i, background)
    out = jnp.where(t_front_i,
                    alpha_i * t_lit_i + (1.0 - alpha_i) * base, base)
    return jnp.clip(out, 0.0, 1.0)


def _render_frame_pallas_tiled(
    world, camera, bank, settings: RenderSettings, *,
    cubemap, atlas, shadow_state, shadow_factor, batch, ent_attrs=None,
    systems=None, draw_ctx=None,
) -> jnp.ndarray:
    """Tiled frame: the tile raster kernel, then either the fused shade
    kernel or XLA shading on the contiguous (NT*th, tw) view of the tile
    buffers (zero transposes); only the final color + compose masks
    untile."""
    from render_engine_tpu.render import raster_pallas as RP

    cfg = settings.raster
    h, w = settings.height, settings.width
    th, twd = cfg.tile_h, cfg.tile_w
    tiles_x, tiles_y = -(-w // twd), -(-h // th)
    nt = tiles_x * tiles_y
    skybox_on = None if draw_ctx is None else draw_ctx.skybox_on

    # --- fused interp+lighting kernel path ------------------------------
    if settings.fused_shading and shadow_factor is None:
        lights = L.extract_lights(
            world,
            max_dir=settings.max_dir_lights,
            max_point=settings.max_point_lights,
            max_spot=settings.max_spot_lights,
        )
        background = SB.background_for(camera, cubemap, h, w,
                                       settings.clear_color)
        background = _gate_skybox(background, skybox_on, settings)
        tri_sys = None
        if systems is not None and systems.has_shade_callbacks():
            from render_engine_tpu.render.render_system import (
                triangle_system_ids,
            )

            tri_sys = triangle_system_ids(batch, world, systems)
        return tiled_fused_core(
            batch, lights, bank, settings, camera,
            width=w, h_total=h, h_local=h, y_off=0.0,
            background=background, shadow_state=shadow_state,
            ent_attrs=ent_attrs, atlas=atlas, systems=systems,
            draw_ctx=draw_ctx, tri_sys=tri_sys,
        )

    tri_class = jnp.where(
        batch.valid, jnp.where(batch.transparent, 2.0, 1.0), 0.0
    ).astype(jnp.float32)
    cand, counts = RP._candidate_table(batch, cfg, tiles_x, tiles_y, tri_class)
    # one packed per-tri table + ONE contiguous row gather feeds both the
    # raster (channels 0:10) and the resolve (all channels); render-system
    # attributes (tint/boost/unlit/alpha) fold in per triangle
    packed = RP._packed_tri_table(batch, bank, tri_class, ent_attrs=ent_attrs)
    rows = RP._gather_candidate_rows(packed, cand)  # (NT, K, A)
    d, wn, s, td, twn, ts = RP._launch(
        batch, h, w, cfg, tri_class, two_pass=True,
        cand=cand, counts=counts,
    )
    res_o = RP.resolve_attributes(s, rows)  # (A, NT, th, tw)
    res_t = RP.resolve_attributes(ts, rows)

    a_dim = res_o.shape[0]

    def tall(x):  # (NT, th, tw) -> (NT*th, tw), contiguous
        return x.reshape(nt * th, twd)

    ch_o = res_o.reshape(a_dim, nt * th, twd)
    ch_t = res_t.reshape(a_dim, nt * th, twd)

    # pixel-center coordinates in the tall layout
    tids = jnp.arange(nt, dtype=jnp.int32)
    oy = ((tids // tiles_x) * th).astype(jnp.float32)
    ox = ((tids % tiles_x) * twd).astype(jnp.float32)
    py_t = (oy[:, None, None]
            + jnp.arange(th, dtype=jnp.float32)[None, :, None] + 0.5)
    px_t = (ox[:, None, None]
            + jnp.arange(twd, dtype=jnp.float32)[None, None, :] + 0.5)
    py_tall = jnp.broadcast_to(py_t, (nt, th, twd)).reshape(nt * th, twd)
    px_tall = jnp.broadcast_to(px_t, (nt, th, twd)).reshape(nt * th, twd)

    inv_pv = T.inv44(camera.proj_view())
    spk = bank.uniform_shininess() is None
    gbuf, extras = RP._gbuffer_from_channels(
        ch_o, tall(d), tall(wn), h, w, inv_pv, px=px_tall, py=py_tall,
        spec_packed=spk)
    t_gbuf, t_extras = RP._gbuffer_from_channels(
        ch_t, tall(td), tall(twn), h, w, inv_pv, px=px_tall, py=py_tall,
        spec_packed=spk)

    if atlas is not None:
        from render_engine_tpu.render.textures import sample_atlas

        def texture(g, ex):
            mat_safe = jnp.clip(g.material, 0,
                                bank.mat_textures.shape[0] - 1)
            layer = bank.mat_texture[mat_safe]
            tex = sample_atlas(atlas, layer, ex["uv"])
            if bank.has_specular_maps():
                # spec-map red channel multiplies the per-pixel strength
                # (trace-time gate — no cost without spec maps)
                slayer = bank.mat_texture_spec[mat_safe]
                smul = sample_atlas(atlas, slayer, ex["uv"])[..., 0]
                ex["specular"] = ex["specular"] * jnp.where(
                    slayer >= 0, smul, 1.0)
            if bank.has_emissive_maps():
                # emissive-map red channel multiplies the per-pixel
                # brightness (third texture pair, same gating)
                elayer = bank.mat_texture_emis[mat_safe]
                emul = sample_atlas(atlas, elayer, ex["uv"])[..., 0]
                ex["emissive"] = ex["emissive"] * jnp.where(
                    elayer >= 0, emul, 1.0)
            if bank.has_dissolve_maps():
                # dissolve map (map_d): per-pixel alpha multiplier,
                # consumed by the transparent-pass blend
                dl_ = bank.mat_texture_diss[mat_safe]
                dmul = sample_atlas(atlas, dl_, ex["uv"])[..., 0]
                ex["alpha"] = ex["alpha"] * jnp.where(dl_ >= 0, dmul, 1.0)
            normal = g.normal
            if bank.has_normal_maps():
                # fourth texture pair: tangent-space normal map. The
                # tangent frame rides the 64-wide packed rows when the
                # table was built with the atlas; otherwise gather it by
                # winner id (this path is not the production kernel)
                from render_engine_tpu.render.geometry import (
                    perturb_normal,
                    triangle_tangents,
                )

                nl_ = bank.mat_texture_norm[mat_safe]
                nsamp = sample_atlas(atlas, nl_, ex["uv"])
                if "tangent" in ex:
                    tan_px, w_px = ex["tangent"], ex["tangent_w"]
                else:
                    tri_ = jnp.clip(g.tri_id, 0, batch.budget - 1)
                    tan, handed = triangle_tangents(batch)
                    tan_px, w_px = tan[tri_], handed[tri_]
                pert = perturb_normal(g.normal, tan_px, w_px, nsamp)
                normal = jnp.where((nl_ >= 0)[..., None], pert, g.normal)
            return dataclasses.replace(
                g, normal=normal,
                albedo=jnp.where((layer >= 0)[..., None], tex, g.albedo))

        gbuf = texture(gbuf, extras)
        t_gbuf = texture(t_gbuf, t_extras)

    lights = L.extract_lights(
        world,
        max_dir=settings.max_dir_lights,
        max_point=settings.max_point_lights,
        max_spot=settings.max_spot_lights,
    )
    if shadow_factor is None and shadow_state is not None:
        from render_engine_tpu.render.shadows import make_shadow_factor

        shadow_factor = make_shadow_factor(
            shadow_state, world,
            {"dir": lights.dir_entity, "spot": lights.sp_entity,
             "point": lights.pt_entity},
        )

    zeros_bg = jnp.zeros((nt * th, twd, 3), jnp.float32)
    color = L.shade(gbuf, lights, bank, camera.position,
                    background=zeros_bg, shadow_factor=shadow_factor,
                    emissive_image=extras["emissive"],
                    specular_image=extras["specular"],
                    shininess_image=extras.get("shininess"))
    if systems is not None and systems.has_shade_callbacks():
        from render_engine_tpu.render.render_system import (
            apply_custom_shading,
        )

        color = apply_custom_shading(color, gbuf, tall(wn), batch, world,
                                     camera, lights, systems, draw_ctx)
    # transparency: forward pass without shadow sampling (reference parity)
    t_lit = L.shade(t_gbuf, lights, bank, camera.position,
                    background=zeros_bg, shadow_factor=None,
                    emissive_image=t_extras["emissive"],
                    specular_image=t_extras["specular"],
                    shininess_image=t_extras.get("shininess"))
    if systems is not None and systems.has_shade_callbacks():
        from render_engine_tpu.render.render_system import (
            apply_custom_shading,
        )

        t_lit = apply_custom_shading(t_lit, t_gbuf, tall(twn), batch,
                                     world, camera, lights, systems,
                                     draw_ctx)
    alpha = t_extras["alpha"][..., None]
    t_front = t_gbuf.covered() & (t_gbuf.depth <= gbuf.depth)

    def untile(x):  # (NT*th, tw[, C]) -> (h, w[, C])
        squeeze = x.ndim == 2
        if squeeze:
            x = x[..., None]
        c = x.shape[-1]
        x = x.reshape(tiles_y, tiles_x, th, twd, c)
        x = jnp.transpose(x, (0, 2, 1, 3, 4)).reshape(
            tiles_y * th, tiles_x * twd, c)[:h, :w]
        return x[..., 0] if squeeze else x

    # one packed untile for everything the compose needs (11 channels)
    packed = jnp.concatenate(
        [
            color, t_lit, alpha,
            gbuf.covered().astype(jnp.float32)[..., None],
            t_front.astype(jnp.float32)[..., None],
        ],
        axis=-1,
    )
    img = untile(packed)
    color_i, t_lit_i = img[..., 0:3], img[..., 3:6]
    alpha_i = img[..., 6:7]
    covered_i = img[..., 7:8] > 0.5
    t_front_i = img[..., 8:9] > 0.5

    # background (image space): starfield / cubemap rows / clear color
    background = SB.background_for(camera, cubemap, h, w,
                                   settings.clear_color)
    background = _gate_skybox(background, skybox_on, settings)
    base = jnp.where(covered_i, color_i, background)
    out = jnp.where(t_front_i, alpha_i * t_lit_i + (1.0 - alpha_i) * base,
                    base)
    return jnp.clip(out, 0.0, 1.0)


def to_srgb_u8(color: jnp.ndarray) -> jnp.ndarray:
    """Linear -> sRGB 8-bit for PNG dumps."""
    c = jnp.clip(color, 0.0, 1.0)
    srgb = jnp.where(
        c <= 0.0031308, 12.92 * c, 1.055 * jnp.power(c, 1.0 / 2.4) - 0.055
    )
    return (srgb * 255.0 + 0.5).astype(jnp.uint8)
