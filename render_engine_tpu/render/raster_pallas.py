"""Tile rasterizer: a Pallas kernel lowered through Triton.

Same contract as raster_jnp.rasterize_depth_winner (bit-compatible winner
selection: nearest depth, first-seen wins ties in stable binning order), but
the per-tile candidate march runs as one GPU program per 8x128 screen tile:

  * each program reads its candidates' scalars straight from a row-major
    (NT, K, 16) table (one XLA row gather builds it; a tile's K rows stay in
    L1/L2);
  * the loops run only over the tile's valid candidates (dynamic counts per
    segment: opaque window, transparent window, global list), where the XLA
    version marches the full fixed budget for every tile;
  * depth and winner accumulate in registers; nothing touches device memory
    until the final store.

Binning (bbox -> tile pairs -> sort -> windows) is shared with the jnp
version. The winner-attribute resolve is a plain gather
(``resolve_attributes``).

On the CPU the kernel runs in interpret mode (render_engine_tpu.platform),
so the tests exercise the same code path.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from render_engine_tpu import platform
from render_engine_tpu.render.geometry import TriangleBatch
from render_engine_tpu.render.raster_jnp import RasterConfig, _bin_triangles
from render_engine_tpu.math import transforms as T

# raster candidate row: x0 y0 x1 y1 x2 y2 z0 z1 z2 class tri_id (f32, exact
# below 2^24), zero-padded to 16 columns (a 64-byte row)
RAST_COLS = 16
NUM_WARPS = 4  # 128 threads over a 1024-pixel tile: 8 pixels per thread


def _tile_kernel(
    tiles_x: int,
    tile_h: int,
    tile_w: int,
    tile_budget: int,
    trans_budget: int,
    two_pass: bool,
    data_ref,  # (K, 16) f32 this tile's candidate rows (RAST_COLS layout)
    counts_ref,  # (3,) int32 (opaque, transparent, global) valid counts
    depth_ref,  # (tile_h, tile_w) f32
    winner_ref,  # (tile_h, tile_w) int32 global tri id, -1 empty
    slot_ref,  # (tile_h, tile_w) int32 winner's candidate slot
    t_depth_ref=None,  # two_pass: transparent-layer outputs
    t_winner_ref=None,
    t_slot_ref=None,
):
    """One program per tile: march this tile's candidates, keeping the
    nearest depth and its winner in registers. Candidate scalars are read
    straight from the tile's row-major rows (an L1/L2-resident block)."""
    t = pl.program_id(0)
    oy = (t // tiles_x) * tile_h
    ox = (t % tiles_x) * tile_w
    py = (
        jax.lax.broadcasted_iota(jnp.int32, (tile_h, tile_w), 0).astype(
            jnp.float32
        )
        + oy.astype(jnp.float32)
        + 0.5
    )
    px = (
        jax.lax.broadcasted_iota(jnp.int32, (tile_h, tile_w), 1).astype(
            jnp.float32
        )
        + ox.astype(jnp.float32)
        + 0.5
    )

    def body(k, carry):
        x0 = data_ref[k, 0]
        y0 = data_ref[k, 1]
        x1 = data_ref[k, 2]
        y1 = data_ref[k, 3]
        x2 = data_ref[k, 4]
        y2 = data_ref[k, 5]
        z0 = data_ref[k, 6]
        z1 = data_ref[k, 7]
        z2 = data_ref[k, 8]
        cls = data_ref[k, 9]  # 0 invalid, 1 opaque, 2 transparent
        tid = data_ref[k, 10].astype(jnp.int32)

        l0 = (x2 - x1) * (py - y1) - (y2 - y1) * (px - x1)
        l1 = (x0 - x2) * (py - y2) - (y0 - y2) * (px - x2)
        l2 = (x1 - x0) * (py - y0) - (y1 - y0) * (px - x0)
        area = l0 + l1 + l2
        inside = ((l0 >= 0.0) & (l1 >= 0.0) & (l2 >= 0.0)) | (
            (l0 <= 0.0) & (l1 <= 0.0) & (l2 <= 0.0)
        )
        nz = jnp.abs(area) > 1e-9
        inside = inside & nz & (cls > 0.0)
        inv_area = 1.0 / jnp.where(nz, area, 1.0)
        d = (l0 * z0 + l1 * z1 + l2 * z2) * inv_area
        inside = inside & (d >= -1.0) & (d <= 1.0)
        if two_pass:
            best_d, best_t, best_k, best_td, best_tt, best_tk = carry
            do = jnp.where(inside & (cls < 1.5), d, jnp.inf)
            upd = do < best_d
            best_d = jnp.where(upd, do, best_d)
            best_t = jnp.where(upd, tid, best_t)
            best_k = jnp.where(upd, k, best_k)
            dt_ = jnp.where(inside & (cls > 1.5), d, jnp.inf)
            updt = dt_ < best_td
            best_td = jnp.where(updt, dt_, best_td)
            best_tt = jnp.where(updt, tid, best_tt)
            best_tk = jnp.where(updt, k, best_tk)
            return best_d, best_t, best_k, best_td, best_tt, best_tk
        best_d, best_t, best_k = carry
        d = jnp.where(inside, d, jnp.inf)
        upd = d < best_d
        return (jnp.where(upd, d, best_d), jnp.where(upd, tid, best_t),
                jnp.where(upd, k, best_k))

    inf = jnp.full((tile_h, tile_w), jnp.inf, jnp.float32)
    neg = jnp.full((tile_h, tile_w), -1, jnp.int32)
    init = (inf, neg, neg, inf, neg, neg) if two_pass else (inf, neg, neg)
    # dynamic trip counts: only march candidates that actually exist, so
    # sparse tiles are nearly free. Segments: [0, B) opaque window,
    # [B, B+BT) transparent window, [B+BT, ..) global list.
    n_tile = counts_ref[0]
    n_trans = counts_ref[1]
    n_glob = counts_ref[2]
    carry = jax.lax.fori_loop(0, n_tile, body, init)
    carry = jax.lax.fori_loop(tile_budget, tile_budget + n_trans, body,
                              carry)
    g0 = tile_budget + trans_budget
    carry = jax.lax.fori_loop(g0, g0 + n_glob, body, carry)
    if two_pass:
        best_d, best_t, best_k, best_td, best_tt, best_tk = carry
        t_depth_ref[...] = jnp.where(best_tt >= 0, best_td, 1.0)
        t_winner_ref[...] = best_tt
        t_slot_ref[...] = best_tk
    else:
        best_d, best_t, best_k = carry
    depth_ref[...] = jnp.where(best_t >= 0, best_d, 1.0)
    winner_ref[...] = best_t
    slot_ref[...] = best_k


def _candidate_table(batch, cfg, tiles_x, tiles_y, tri_class=None):
    """Bin once: (NT, K) candidate ids (-1 invalid) + per-tile/global
    counts for the kernel's dynamic trip bounds. With ``tri_class`` the
    table is [opaque window | transparent window | global list] and counts
    carry 3 entries; otherwise [window | global] with a zero middle count."""
    nt = tiles_x * tiles_y
    if tri_class is not None:
        tile_cand, global_list, _, trans_cand, cand_dropped = _bin_triangles(
            batch, cfg, tiles_x, tiles_y, tri_class
        )
    else:
        tile_cand, global_list, _, cand_dropped = _bin_triangles(
            batch, cfg, tiles_x, tiles_y
        )
        trans_cand = jnp.full((nt, cfg.trans_tile_budget), -1, jnp.int32)
    cand = jnp.concatenate(
        [tile_cand, trans_cand,
         jnp.broadcast_to(global_list[None], (nt, cfg.global_budget))],
        axis=1,
    )  # (NT, K)
    n_tile = jnp.sum(tile_cand >= 0, axis=1, dtype=jnp.int32)  # (NT,)
    n_trans = jnp.sum(trans_cand >= 0, axis=1, dtype=jnp.int32)
    n_glob = jnp.sum(global_list >= 0, dtype=jnp.int32)
    counts = jnp.stack(
        [n_tile, n_trans, jnp.broadcast_to(n_glob, n_tile.shape)], axis=-1
    )  # (NT, 3)
    return cand, counts


def _prepare_candidates(batch, cfg, tiles_x, tiles_y, tri_class,
                        cand=None, counts=None, classed=False):
    """Gather the raster's candidate rows: (NT, K, 16) f32 in RAST_COLS
    layout, plus the (NT, 3) valid counts. ``tri_class``: (T,) f32 class
    per triangle (0 excluded, 1 opaque, 2 transparent)."""
    if cand is None:
        cand, counts = _candidate_table(
            batch, cfg, tiles_x, tiles_y,
            tri_class if classed else None,
        )
    t = batch.budget
    if t >= 1 << 24:
        raise ValueError(f"triangle budget {t} exceeds the f32-exact id range")
    x = batch.xy[..., 0]  # (T, 3)
    y = batch.xy[..., 1]
    packed = jnp.concatenate(
        [x[:, 0:1], y[:, 0:1], x[:, 1:2], y[:, 1:2], x[:, 2:3], y[:, 2:3],
         batch.z, tri_class[:, None],
         jnp.arange(t, dtype=jnp.float32)[:, None],
         jnp.zeros((t, RAST_COLS - 11), jnp.float32)],
        axis=1,
    )  # (T, RAST_COLS)
    return _gather_candidate_rows(packed, cand), counts


def _packed_tri_table(batch, bank, tri_class, ent_attrs=None, atlas=None):
    """ONE (T, N_ATTR) f32 per-triangle channel table (layout per the
    N_ATTR comment below). The frame path gathers candidate ROWS from this
    table — one contiguous row gather per candidate instead of ~15
    separate per-channel gathers.

    ``ent_attrs``: optional (CAP, 6) per-entity render-system shading rows
    [unlit, boost, tint rgb, alpha_scale] (render_system.entity_shade_attrs)
    folded into the albedo/emissive/alpha channels — user render systems as
    per-triangle data on the single fused pass."""
    t = batch.budget
    x = batch.xy[..., 0]  # (T, 3)
    y = batch.xy[..., 1]
    mat_safe = jnp.clip(batch.material, 0, bank.mat_albedo.shape[0] - 1)
    albedo = bank.mat_albedo[mat_safe]
    emissive = bank.mat_emissive[mat_safe]
    alpha = bank.mat_alpha[mat_safe]
    if bank.uniform_shininess() is not None:
        # one scene-wide exponent: channel 34 stays pure specular strength
        specular = bank.mat_specular[mat_safe]
    else:
        # varying MTL Ns: channel 34 carries the exact quantized
        # (strength, exponent) packing (bank.pack_spec_shin); consumers
        # decode with the shared codec so every path agrees bit-for-bit
        specular = bank.mat_spec_shin_packed[mat_safe]
    if atlas is not None:
        # texture ids resolve to (absolute layer, packed pixel rect) here,
        # so the resolve/override path needs no extra indirection
        def tex_cols(tex_ids):
            ts = jnp.clip(tex_ids, 0, atlas.num_textures - 1)
            lay = jnp.where(tex_ids >= 0,
                            atlas.tex_layer[ts].astype(jnp.float32), -1.0)
            return lay, atlas.uv_rect[ts]  # (T,), (T, 4)

        layer, uvs = tex_cols(bank.mat_texture[mat_safe])
        slayer, suvs = tex_cols(bank.mat_texture_spec[mat_safe])
        # the third (emissive) pair's 5 columns exist only when some
        # material carries one — scenes without emissive maps keep the
        # 48-wide rows (17% narrower resolve dots in the fused kernel)
        with_emis = bank.has_emissive_maps()
        if with_emis:
            elayer, euvs = tex_cols(bank.mat_texture_emis[mat_safe])
        # the fourth (normal-map) pair + per-tri tangent frame and the
        # fifth (dissolve) pair exist only in scenes carrying them; either
        # forces the 64-wide rows
        with_norm = bank.has_normal_maps()
        if with_norm:
            nlayer, nuvs = tex_cols(bank.mat_texture_norm[mat_safe])
        with_diss = bank.has_dissolve_maps()
        if with_diss:
            dlayer, duvs = tex_cols(bank.mat_texture_diss[mat_safe])
    else:
        uvs = suvs = jnp.ones((t, 4), jnp.float32)
        layer = slayer = jnp.full(t, -1.0, jnp.float32)
        with_emis = False
        with_norm = False
        with_diss = False
    if not with_emis:
        euvs = jnp.zeros((t, 4), jnp.float32)
        elayer = jnp.full(t, -1.0, jnp.float32)
    if not with_norm:
        nuvs = jnp.zeros((t, 4), jnp.float32)
        nlayer = jnp.full(t, -1.0, jnp.float32)
        tangent = jnp.zeros((t, 3), jnp.float32)
        handed = jnp.ones(t, jnp.float32)
    else:
        from render_engine_tpu.render.geometry import triangle_tangents

        tangent, handed = triangle_tangents(batch)
    if not with_diss:
        duvs = jnp.zeros((t, 4), jnp.float32)
        dlayer = jnp.full(t, -1.0, jnp.float32)
    if ent_attrs is not None:
        sa = ent_attrs[jnp.clip(batch.entity, 0, ent_attrs.shape[0] - 1)]
        unlit, boost, ascale = sa[:, 0] > 0.5, sa[:, 1], sa[:, 5]
        albedo = albedo * sa[:, 2:5]
        # unlit systems bypass lighting via the emissive path at the
        # system's boost (the light-source draw callback's 6x-brightness,
        # render_system_setup.rs:57-77)
        emissive = jnp.where(unlit, jnp.maximum(emissive, 1.0) * boost,
                             emissive)
        alpha = jnp.clip(alpha * ascale, 0.0, 1.0)
    return jnp.concatenate(
        [
            x[:, 0:1], y[:, 0:1], x[:, 1:2], y[:, 1:2], x[:, 2:3], y[:, 2:3],
            batch.z,  # 6:9
            tri_class[:, None],  # 9
            batch.normal.reshape(t, 9),  # 10:19
            batch.uv.reshape(t, 6),  # 19:25
            batch.inv_w,  # 25:28
            batch.material.astype(jnp.float32)[:, None],  # 28
            albedo,  # 29:32
            emissive[:, None],  # 32
            alpha[:, None],  # 33
            specular[:, None],  # 34
            layer[:, None],  # 35 (absolute atlas layer, -1 = untextured)
            uvs,  # 36:40 packed rect [u_scale, v_scale, u_off, v_off] px
            slayer[:, None],  # 40 specular-map layer
            suvs,  # 41:45 its packed rect
            elayer[:, None],  # 45 emissive-map layer (only present in
            euvs,  # 46:50 its packed rect        # emissive-map scenes)
            nlayer[:, None],  # 50 normal-map layer (normal-map scenes)
            nuvs,  # 51:55 its packed rect
            tangent,  # 55:58 per-tri tangent
            handed[:, None],  # 58 bitangent handedness
            dlayer[:, None],  # 59 dissolve-map layer
            duvs,  # 60:64 its packed rect
        ],
        axis=1,
    )[:, : (N_ATTR_NORM if (with_norm or with_diss)
            else (N_ATTR if with_emis else N_ATTR_BASE))]


def _gather_candidate_rows(packed, cand):
    """(T, A) table + (NT, K) candidate ids -> (NT, K, A) rows.

    Empty slots (cand < 0) gather row 0's data unmasked — safe because the
    candidate tables are valid-prefix per segment and the raster kernel's
    dynamic trip counts never read past the valid prefix; the resolve
    gathers only winner slots (always valid)."""
    safe = jnp.clip(cand, 0, packed.shape[0] - 1)
    return packed[safe]  # (NT, K, A) — one contiguous row gather


def _launch(batch, height, width, cfg, tri_class, two_pass,
            cand=None, counts=None, classed=False):
    """Run the tile raster. Returns 3 (or, with ``two_pass``, 6) tiled
    (NT, th, tw) buffers: depth, winner, slot [, t_depth, t_winner,
    t_slot]. Compiled on the GPU, interpreted on the CPU (platform)."""
    th, tw = cfg.tile_h, cfg.tile_w
    tiles_x = -(-width // tw)
    tiles_y = -(-height // th)
    nt = tiles_x * tiles_y

    data, counts = _prepare_candidates(
        batch, cfg, tiles_x, tiles_y, tri_class, cand, counts,
        classed=classed,
    )
    k = data.shape[1]
    kernel = functools.partial(_tile_kernel, tiles_x, th, tw,
                               cfg.tile_budget, cfg.trans_tile_budget,
                               two_pass)
    n_out = 6 if two_pass else 3
    out_dtypes = [jnp.float32, jnp.int32, jnp.int32] * (n_out // 3)
    return pl.pallas_call(
        kernel,
        grid=(nt,),
        in_specs=[
            pl.BlockSpec((None, k, RAST_COLS), lambda i: (i, 0, 0)),
            pl.BlockSpec((None, 3), lambda i: (i, 0)),
        ],
        out_specs=[
            pl.BlockSpec((None, th, tw), lambda i: (i, 0, 0))
            for _ in range(n_out)
        ],
        out_shape=[
            jax.ShapeDtypeStruct((nt, th, tw), dt) for dt in out_dtypes
        ],
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=NUM_WARPS,
                                                num_stages=1),
        interpret=platform.interpret_kernels(),
        name="tile_raster",
    )(data, counts)  # tiled (NT, th, tw) buffers


def _untile(a, tiles_y, tiles_x, th, tw, height, width):
    a = a.reshape(tiles_y, tiles_x, th, tw)
    a = jnp.transpose(a, (0, 2, 1, 3)).reshape(tiles_y * th, tiles_x * tw)
    return a[:height, :width]


def rasterize_depth_winner_pallas(
    batch: TriangleBatch,
    height: int,
    width: int,
    cfg: RasterConfig = RasterConfig(),
    tri_mask: jnp.ndarray | None = None,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Drop-in replacement for raster_jnp.rasterize_depth_winner."""
    if tri_mask is not None:
        batch = dataclasses.replace(batch, valid=batch.valid & tri_mask)
    tri_class = batch.valid.astype(jnp.float32)
    th, tw = cfg.tile_h, cfg.tile_w
    tiles_x, tiles_y = -(-width // tw), -(-height // th)
    depth, winner, _slot = _launch(batch, height, width, cfg, tri_class,
                                   two_pass=False)
    u = lambda a: _untile(a, tiles_y, tiles_x, th, tw, height, width)
    return u(depth), u(winner)


def rasterize_two_pass_pallas(
    batch: TriangleBatch,
    height: int,
    width: int,
    cfg: RasterConfig = RasterConfig(),
):
    """Opaque + transparent layers from ONE binning and ONE kernel launch.

    Returns (depth, winner, t_depth, t_winner). Matches two separate
    rasterize calls up to exact-depth ties between triangles of different
    classes (candidate order differs; winners on exact ties may too).
    """
    tri_class = jnp.where(
        batch.valid,
        jnp.where(batch.transparent, 2.0, 1.0),
        0.0,
    ).astype(jnp.float32)
    th, tw = cfg.tile_h, cfg.tile_w
    tiles_x, tiles_y = -(-width // tw), -(-height // th)
    d, w, _s, td, twi, _ts = _launch(batch, height, width, cfg, tri_class,
                                     two_pass=True, classed=True)
    u = lambda a: _untile(a, tiles_y, tiles_x, th, tw, height, width)
    return u(d), u(w), u(td), u(twi)


# ---------------------------------------------------------------------------
# Winner-attribute resolve
# ---------------------------------------------------------------------------
# Channel layout of the per-candidate attribute table (A axis). World
# position is NOT gathered — it reconstructs from depth + the inverse
# proj-view per pixel (the standard deferred-shading unproject trick),
# cutting 9 channels from the gather.
#   0:10   x0 y0 x1 y1 x2 y2 z0 z1 z2 cls      (same as the raster data)
#   10:19  normal vertex 0,1,2 (3 each)
#   19:25  uv vertex 0,1,2 (2 each)
#   25:28  inv_w vertex 0,1,2
#   28     material id (as f32; ids are small so the roundtrip is exact)
#   29:32  albedo rgb      (material table folded in -> no per-pixel lookup)
#   32     emissive
#   33     alpha
#   34     specular strength (gAlbedoSpec alpha semantics)
#   35     texture layer (f32, ABSOLUTE atlas layer, -1 = untextured)
#   36:40  packed atlas rect [u_scale, v_scale, u_off, v_off] in px
#   40     specular-map layer (f32, -1 = none) — second texture pair
#          (model_definitions.rs:71-148)
#   41:45  the specular map's packed atlas rect
#   45     emissive-map layer (f32, -1 = none) — third texture pair
#   46:50  its packed atlas rect (columns 45:50 exist only in scenes with
#          emissive maps; others keep the 48-wide base rows)
#   50     normal-map layer (f32, -1 = none) — fourth texture pair
#   51:55  its packed atlas rect
#   55:58  per-triangle tangent xyz (geometry.triangle_tangents)
#   58     bitangent handedness (+-1)
#   59     dissolve-map layer (f32, -1 = none) — fifth texture pair
#          (MTL map_d: per-pixel alpha on the transparent pass)
#   60:64  its packed atlas rect   (columns 50:64 exist only in scenes
#          with normal or dissolve maps; they force the 64-wide rows and
#          carry the lower optional columns too, zeroed when unused)
N_ATTR_BASE = 48  # base row width (columns 0:45 used)
N_ATTR = 56  # with the emissive pair
N_ATTR_NORM = 64  # with the normal-map pair + tangent frame


def _gbuffer_from_channels(ch, depth, winner, height, width, inv_proj_view,
                           px=None, py=None, ndc_py=None,
                           spec_packed=False):
    """Per-pixel interpolation from winner-vertex channel images — pure
    elementwise math, zero gathers. ``ch``: (A, H, W). World position
    reconstructs from depth via ``inv_proj_view`` (4, 4).

    ``px``/``py`` override the pixel-center coordinate arrays (the tiled
    fast path passes tile-derived coordinates; then ``height``/``width``
    refer to the ORIGINAL image for the unproject NDC mapping).
    ``ndc_py`` overrides the y used for the NDC unproject only: a sharded
    row band rasters with band-LOCAL triangle y (so ``py`` must be local
    for the barycentrics) while the unproject needs the GLOBAL row."""
    from render_engine_tpu.render.gbuffer import GBuffer, MATERIAL_BACKGROUND

    covered = winner >= 0
    if px is None:
        px = jnp.arange(width, dtype=jnp.float32)[None, :] + 0.5
        py = jnp.arange(height, dtype=jnp.float32)[:, None] + 0.5
    x0, y0, x1, y1, x2, y2 = ch[0], ch[1], ch[2], ch[3], ch[4], ch[5]

    l0 = (x2 - x1) * (py - y1) - (y2 - y1) * (px - x1)
    l1 = (x0 - x2) * (py - y2) - (y0 - y2) * (px - x2)
    l2 = (x1 - x0) * (py - y0) - (y1 - y0) * (px - x0)
    area = l0 + l1 + l2
    inv_area = 1.0 / jnp.where(jnp.abs(area) > 1e-12, area, 1.0)
    b0, b1, b2 = l0 * inv_area, l1 * inv_area, l2 * inv_area
    iw0, iw1, iw2 = ch[25], ch[26], ch[27]
    w0, w1, w2 = b0 * iw0, b1 * iw1, b2 * iw2
    denom = w0 + w1 + w2
    inv_d = 1.0 / jnp.where(jnp.abs(denom) > 1e-12, denom, 1.0)
    p0, p1, p2 = w0 * inv_d, w1 * inv_d, w2 * inv_d

    def interp3(base):
        return jnp.stack(
            [
                p0 * ch[base + i] + p1 * ch[base + 3 + i]
                + p2 * ch[base + 6 + i]
                for i in range(3)
            ],
            axis=-1,
        )

    # world position: unproject (pixel, depth) — deferred-shading standard
    ndc_x = px / jnp.float32(width) * 2.0 - 1.0
    ndc_y = 1.0 - (py if ndc_py is None else ndc_py) \
        / jnp.float32(height) * 2.0
    ndc = jnp.stack(
        [
            jnp.broadcast_to(ndc_x, depth.shape),
            jnp.broadcast_to(ndc_y, depth.shape),
            depth,
            jnp.ones_like(depth),
        ],
        axis=-1,
    )  # (H, W, 4)
    wp = jnp.einsum("ij,hwj->hwi", inv_proj_view, ndc,
                    precision=T.MM_PRECISION)
    pos = wp[..., :3] / jnp.where(
        jnp.abs(wp[..., 3:4]) > 1e-12, wp[..., 3:4], 1.0
    )

    nrm = interp3(10)
    nlen = jnp.linalg.norm(nrm, axis=-1, keepdims=True)
    nrm = nrm / jnp.where(nlen > 1e-12, nlen, 1.0)
    uv = jnp.stack(
        [
            p0 * ch[19 + i] + p1 * ch[21 + i] + p2 * ch[23 + i]
            for i in range(2)
        ],
        axis=-1,
    )
    mat = ch[28].astype(jnp.int32)
    albedo = jnp.stack([ch[29], ch[30], ch[31]], axis=-1)
    emissive = ch[32]
    alpha = ch[33]

    cm = covered[..., None]
    gbuf = GBuffer(
        depth=depth,
        position=jnp.where(cm, pos, 0.0),
        normal=jnp.where(cm, nrm, 0.0),
        albedo=jnp.where(cm, albedo, 0.0),
        material=jnp.where(covered, mat, MATERIAL_BACKGROUND),
        tri_id=winner,
    )
    if spec_packed:
        from render_engine_tpu.models.bank import unpack_spec_shin

        spec34, shin34 = unpack_spec_shin(ch[34])
    else:
        spec34, shin34 = ch[34], None
    extras = {
        "emissive": jnp.where(covered, emissive, 0.0),
        "alpha": jnp.where(covered, alpha, 1.0),
        "uv": uv,
        "specular": jnp.where(covered, spec34, 1.0),
    }
    if shin34 is not None:
        from render_engine_tpu.models.bank import DEFAULT_SHININESS

        extras["shininess"] = jnp.where(covered, shin34, DEFAULT_SHININESS)
    if ch.shape[0] >= N_ATTR_NORM:  # normal-mapped scene rows
        extras["tangent"] = jnp.stack([ch[55], ch[56], ch[57]], axis=-1)
        extras["tangent_w"] = ch[58]
    return gbuf, extras


def render_gbuffers_pallas(
    batch: TriangleBatch,
    bank,
    height: int,
    width: int,
    cfg: RasterConfig = RasterConfig(),
    proj_view: jnp.ndarray | None = None,
):
    """Full tiled G-buffer: ONE binning, ONE raster launch (opaque +
    transparent layers), one winner-row gather per layer. Returns (gbuf,
    extras, t_gbuf, t_extras)."""
    th, tw = cfg.tile_h, cfg.tile_w
    tiles_x, tiles_y = -(-width // tw), -(-height // th)

    tri_class = jnp.where(
        batch.valid, jnp.where(batch.transparent, 2.0, 1.0), 0.0
    ).astype(jnp.float32)
    cand, counts = _candidate_table(batch, cfg, tiles_x, tiles_y, tri_class)
    packed = _packed_tri_table(batch, bank, tri_class)
    rows = _gather_candidate_rows(packed, cand)
    d, w, s, td, twi, ts = _launch(
        batch, height, width, cfg, tri_class, two_pass=True,
        cand=cand, counts=counts,
    )
    res_o = resolve_attributes(s, rows)
    res_t = resolve_attributes(ts, rows)

    def untile2(a):
        return _untile(a, tiles_y, tiles_x, th, tw, height, width)

    def untile_ch(r):  # (A, NT, th, tw) -> (A, H, W)
        a_dim = r.shape[0]
        r = r.reshape(a_dim, tiles_y, tiles_x, th, tw)
        r = jnp.transpose(r, (0, 1, 3, 2, 4)).reshape(
            a_dim, tiles_y * th, tiles_x * tw
        )
        return r[:, :height, :width]

    depth, winner = untile2(d), untile2(w)
    t_depth, t_winner = untile2(td), untile2(twi)
    if proj_view is None:
        inv_pv = jnp.eye(4, dtype=jnp.float32)
    else:
        inv_pv = T.inv44(proj_view)
    spk = bank.uniform_shininess() is None
    gbuf, extras = _gbuffer_from_channels(
        untile_ch(res_o), depth, winner, height, width, inv_pv,
        spec_packed=spk,
    )
    t_gbuf, t_extras = _gbuffer_from_channels(
        untile_ch(res_t), t_depth, t_winner, height, width, inv_pv,
        spec_packed=spk,
    )
    return gbuf, extras, t_gbuf, t_extras


def resolve_attributes(slot_tiled, attrs_rows):
    """Gather each pixel's winner row. ``slot_tiled``: (NT, th, tw) int32
    winner candidate slots (-1 empty); ``attrs_rows``: (NT, K, A) candidate
    rows as gathered. Returns (A, NT, th, tw), zero where the slot is
    empty — channels leading, so ``out.reshape(A, NT*th, tw)`` is a
    contiguous "tall image" view. One gather moves just the winner row."""
    nt, th, tw = slot_tiled.shape
    a = attrs_rows.shape[2]
    slot = slot_tiled.reshape(nt, th * tw, 1)
    got = jnp.take_along_axis(attrs_rows, jnp.maximum(slot, 0), axis=1)
    got = jnp.where(slot >= 0, got, 0.0)  # (NT, th*tw, A)
    return jnp.moveaxis(got, -1, 0).reshape(a, nt, th, tw)
