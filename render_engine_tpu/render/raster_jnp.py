"""Tile-binned software rasterizer — pure-jnp reference implementation.

Replaces the OpenGL rasterizer + first-pass shaders of the reference
(glDrawElementsInstanced via DrawParam, src/exports/rendering.rs:270-386;
first_pass_vertex.glsl / first_pass_frag.glsl). Architecture (SURVEY.md
section 7 "hard part 1" plan — fixed per-tile triangle budgets, f32 depth
compare, 8x128-friendly tile shapes):

  1. **Bin**: each valid triangle's screen bbox -> covered tile range;
     triangles covering <= ``max_tiles_per_tri`` tiles expand into
     (tile, tri) pairs; the rest go to a small **global list** tested by
     every tile (big near-camera triangles).
  2. **Sort** pairs by tile id; per-tile candidate windows come from
     ``searchsorted`` (same machinery as the spatial grid).
  3. **Tile loop**: for every tile, march its candidates in fixed chunks,
     evaluating edge functions over the tile's pixels and keeping the
     nearest depth + winning triangle id (deterministic: first-seen wins
     ties, candidate order is the stable binning order).
  4. **Resolve**: one gather per pixel recomputes the winner's barycentrics
     and perspective-correct attributes -> G-buffer.

The Pallas kernel (raster_pallas.py) implements the same contract with the
tile loop in registers, one GPU program per tile; this version is the
golden reference and the CPU path. Both are bit-deterministic.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from render_engine_tpu.models.bank import ModelBank
from render_engine_tpu.render.gbuffer import GBuffer, MATERIAL_BACKGROUND
from render_engine_tpu.render.geometry import TriangleBatch


@dataclasses.dataclass(frozen=True)
class RasterConfig:
    tile_h: int = 8
    tile_w: int = 128  # 8x128 = 1024 pixels per tile
    tile_budget: int = 128  # binned candidates per tile
    trans_tile_budget: int = 16  # transparent-class candidates per tile
    max_tiles_per_tri: int = 8  # larger triangles go to the global list
    global_budget: int = 64  # big-triangle list tested by every tile
    chunk: int = 8  # candidates evaluated per tile-loop iteration
    cull_backfaces: bool = False  # accept both windings by default
    # cap on live (tile, tri) pairs fed to the window scatter. The scatter
    # is row-latency-bound, so its cost is T * max_tiles_per_tri rows even
    # though live pairs are typically ~1.5 per VISIBLE triangle; live pairs
    # sort to a prefix, so slicing the sorted pair list to this budget
    # scatters only rows that can matter. None = no cap (exact). Overflow
    # (live pairs beyond the cap) is counted in cand_dropped.
    pair_budget: int | None = None


def _edge(ax, ay, bx, by, px, py):
    """Signed edge function: >0 when p is left of a->b."""
    return (bx - ax) * (py - ay) - (by - ay) * (px - ax)


def _bin_triangles(batch: TriangleBatch, cfg: RasterConfig,
                   tiles_x: int, tiles_y: int, tri_class=None):
    """Returns (tile_cand (NT,B) int32 ids or -1, global_list (GB,) ids or -1,
    tri_valid (T,)); with ``tri_class`` (T,) in {0,1,2} also a 4th element
    ``trans_cand (NT, BT)`` — transparent-class triangles get their OWN
    per-tile window (one shared sort keyed by (tile, class)) so a saturated
    opaque budget cannot starve the transparency layer."""
    t = batch.budget
    nt = tiles_x * tiles_y
    xy = batch.xy  # (T,3,2) pixels
    x, y = xy[..., 0], xy[..., 1]

    area = _edge(x[:, 0], y[:, 0], x[:, 1], y[:, 1], x[:, 2], y[:, 2])
    valid = batch.valid & (jnp.abs(area) > 1e-9)
    if cfg.cull_backfaces:
        # screen space is y-down: world CCW triangles have negative area
        valid = valid & (area < 0)

    xmin = jnp.min(x, axis=-1)
    xmax = jnp.max(x, axis=-1)
    ymin = jnp.min(y, axis=-1)
    ymax = jnp.max(y, axis=-1)
    w_px = jnp.float32(tiles_x * cfg.tile_w)
    h_px = jnp.float32(tiles_y * cfg.tile_h)
    valid = valid & (xmax >= 0) & (xmin < w_px) & (ymax >= 0) & (ymin < h_px)

    tx0 = jnp.clip((xmin / cfg.tile_w).astype(jnp.int32), 0, tiles_x - 1)
    tx1 = jnp.clip((xmax / cfg.tile_w).astype(jnp.int32), 0, tiles_x - 1)
    ty0 = jnp.clip((ymin / cfg.tile_h).astype(jnp.int32), 0, tiles_y - 1)
    ty1 = jnp.clip((ymax / cfg.tile_h).astype(jnp.int32), 0, tiles_y - 1)
    wx = tx1 - tx0 + 1
    wy = ty1 - ty0 + 1
    ncover = wx * wy
    mt = cfg.max_tiles_per_tri
    overflow = valid & (ncover > mt)
    binned = valid & ~overflow

    # ---- expansion to (tile, tri) pairs --------------------------------
    m = jnp.arange(mt, dtype=jnp.int32)  # (MT,)
    dy = m[None, :] // jnp.maximum(wx, 1)[:, None]
    dx = m[None, :] % jnp.maximum(wx, 1)[:, None]
    pair_ok = binned[:, None] & (m[None, :] < ncover[:, None])
    tile = (ty0[:, None] + dy) * tiles_x + (tx0[:, None] + dx)

    # key = ((tile * 2 + class_bit) << 8) | depth_bucket: one sort gives
    # per-(tile, class) windows ordered NEAR-FIRST, so when a tile's budget
    # overflows it drops the FARTHEST triangles — occluded-anyway content —
    # instead of arbitrary ids. (Ties keep stable triangle order, so
    # determinism holds.)
    zc = jnp.mean(batch.z, axis=-1)  # (T,) NDC depth in [-1, 1]
    bucket = jnp.clip(((zc * 0.5 + 0.5) * 255.0).astype(jnp.int32), 0, 255)
    classed = tri_class is not None
    if classed:
        cls_bit = (tri_class >= 1.5).astype(jnp.int32)  # (T,)
        base = tile * 2 + cls_bit[:, None]
        sentinel = (nt * 2) << 8
    else:
        base = tile
        sentinel = nt << 8
    key = (base << 8) | bucket[:, None]
    pair_key = jnp.where(pair_ok, key, sentinel).reshape(-1)
    pair_tri = jnp.broadcast_to(
        jnp.arange(t, dtype=jnp.int32)[:, None], (t, mt)
    ).reshape(-1)

    sorted_key, sorted_tri = jax.lax.sort_key_val(
        pair_key, pair_tri, is_stable=True
    )

    # live pairs are a sorted prefix (sentinel keys are max): cap the
    # scatter length at cfg.pair_budget rows — the dominant binning cost is
    # scatter-row latency over T * mt rows, almost all of them sentinels.
    # Sliced-off LIVE pairs are budget overflow, counted in cand_dropped.
    pair_sliced = jnp.int32(0)
    if cfg.pair_budget is not None and cfg.pair_budget < pair_key.shape[0]:
        pb = cfg.pair_budget
        pair_sliced = jnp.sum((sorted_key[pb:] < sentinel).astype(jnp.int32))
        sorted_key = sorted_key[:pb]
        sorted_tri = sorted_tri[:pb]

    # window fill by run-rank SCATTER: each sorted pair knows its window row
    # (its rank within its base's run) directly, so no searchsorted and no
    # window gather. Base
    # runs are contiguous because the sort key is (base << 8) | bucket.
    # Triangle ids ride as f32 (budgets < 2^24: exact) to keep the scatter
    # on the vector path.
    length = sorted_key.shape[0]
    pos = jnp.arange(length, dtype=jnp.int32)
    sbase = sorted_key >> 8
    newrun = jnp.concatenate(
        [jnp.ones(1, bool), sbase[1:] != sbase[:-1]]
    )
    run_start = jax.lax.cummax(jnp.where(newrun, pos, 0))
    rank = pos - run_start
    live = sorted_key < sentinel
    bt = cfg.tile_budget
    btr = cfg.trans_tile_budget
    if classed:
        tile_of = sbase >> 1
        is_trans = (sbase & 1) == 1
        budget_of = jnp.where(is_trans, btr, bt)
        ok = live & (rank < budget_of)
    else:
        is_trans = None
        tile_of = sbase
        ok = live & (rank < bt)
    # window fill is ONE scatter-max of 128-wide one-hot rows: each live
    # pair writes its triangle id into column rank%128 of row
    # (tile, rank//128); ids >= 0 and the window initializes to -1, so max
    # combines collision-free columns. The row count is independent of the
    # budget widths up to each 128-wide group.
    go = -(-bt // 128)  # 128-wide groups per opaque window
    gt = -(-btr // 128) if classed else 0
    lane = rank % 128
    grp = rank // 128
    if classed:
        row = jnp.where(is_trans,
                        nt * go + tile_of * gt + jnp.minimum(grp, gt - 1)
                        if gt > 0 else nt * go,
                        tile_of * go + jnp.minimum(grp, go - 1))
        n_rows = nt * (go + gt)
    else:
        row = tile_of * go + jnp.minimum(grp, go - 1)
        n_rows = nt * go
    row = jnp.where(ok, row, n_rows)  # out-of-budget -> dropped
    onehot = (jax.lax.broadcasted_iota(jnp.int32, (length, 128), 1)
              == lane[:, None])
    val_rows = jnp.where(onehot, sorted_tri.astype(jnp.float32)[:, None],
                         -1.0)
    win = jnp.full((n_rows, 128), -1.0, jnp.float32).at[row].max(
        val_rows, mode="drop").astype(jnp.int32)
    # budget-overflow diagnostics (the engine's silent-truncation counter,
    # cf. the reference's soft-error prints texture_array.rs:91)
    cand_dropped = jnp.sum((live & ~ok).astype(jnp.int32)) + pair_sliced
    tile_cand = win[:nt * go].reshape(nt, go * 128)[:, :bt]
    if classed:
        trans_cand = win[nt * go:].reshape(nt, gt * 128)[:, :btr]
    else:
        trans_cand = None

    # ---- global list ----------------------------------------------------
    gb = cfg.global_budget
    rank = jnp.cumsum(overflow.astype(jnp.int32)) - 1
    dest = jnp.where(overflow & (rank < gb), rank, gb)
    global_list = jnp.full(gb, -1, jnp.int32).at[dest].set(
        jnp.arange(t, dtype=jnp.int32), mode="drop"
    )
    # global-list overflow (computed below by the caller's scatter rank)
    if classed:
        return tile_cand, global_list, valid, trans_cand, cand_dropped
    return tile_cand, global_list, valid, cand_dropped


def rasterize_depth_winner(
    batch: TriangleBatch,
    height: int,
    width: int,
    cfg: RasterConfig = RasterConfig(),
    tri_mask: jnp.ndarray | None = None,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Rasterize to (depth (H,W) NDC, winner (H,W) int32 tri id or -1).

    ``tri_mask`` optionally restricts which triangles draw (opaque vs
    transparent passes share one batch).
    """
    th, tw = cfg.tile_h, cfg.tile_w
    tiles_x = -(-width // tw)
    tiles_y = -(-height // th)
    nt = tiles_x * tiles_y

    if tri_mask is not None:
        batch = dataclasses.replace(batch, valid=batch.valid & tri_mask)

    tile_cand, global_list, _, _ = _bin_triangles(batch, cfg, tiles_x, tiles_y)
    # append the global list to every tile's candidates
    cand = jnp.concatenate(
        [tile_cand, jnp.broadcast_to(global_list[None], (nt, cfg.global_budget))],
        axis=1,
    )  # (NT, K)
    k = cand.shape[1]
    chunk = cfg.chunk
    n_chunks = -(-k // chunk)
    pad = n_chunks * chunk - k
    if pad:
        cand = jnp.concatenate(
            [cand, jnp.full((nt, pad), -1, jnp.int32)], axis=1
        )

    # pixel centers per tile
    tile_ids = jnp.arange(nt, dtype=jnp.int32)
    oy = (tile_ids // tiles_x) * th
    ox = (tile_ids % tiles_x) * tw
    py = oy[:, None, None] + jnp.arange(th, dtype=jnp.int32)[None, :, None]
    px = ox[:, None, None] + jnp.arange(tw, dtype=jnp.int32)[None, None, :]
    pxf = px.astype(jnp.float32) + 0.5  # (NT, 1, tw) broadcasting vs (NT, th, 1)
    pyf = py.astype(jnp.float32) + 0.5

    x = batch.xy[..., 0]
    y = batch.xy[..., 1]
    z = batch.z

    def body(i, carry):
        best_d, best_t = carry
        c = jax.lax.dynamic_slice(cand, (0, i * chunk), (nt, chunk))  # (NT,C)
        cvalid = c >= 0
        cs = jnp.clip(c, 0, batch.budget - 1)
        vx = x[cs]  # (NT, C, 3)
        vy = y[cs]
        vz = z[cs]
        # edge functions at pixel centers: (NT, C, th, tw)
        p_x = pxf[:, None, :, :]
        p_y = pyf[:, None, :, :]

        def e(a, b):
            return _edge(
                vx[..., a, None, None], vy[..., a, None, None],
                vx[..., b, None, None], vy[..., b, None, None],
                p_x, p_y,
            )

        l0 = e(1, 2)
        l1 = e(2, 0)
        l2 = e(0, 1)
        area = l0 + l1 + l2
        inside = ((l0 >= 0) & (l1 >= 0) & (l2 >= 0)) | (
            (l0 <= 0) & (l1 <= 0) & (l2 <= 0)
        )
        inside = inside & (jnp.abs(area) > 1e-9) & cvalid[..., None, None]
        inv_area = 1.0 / jnp.where(jnp.abs(area) > 1e-9, area, 1.0)
        d = (
            l0 * vz[..., 0, None, None]
            + l1 * vz[..., 1, None, None]
            + l2 * vz[..., 2, None, None]
        ) * inv_area
        inside = inside & (d >= -1.0) & (d <= 1.0)
        d = jnp.where(inside, d, jnp.inf)
        # nearest within chunk (argmin picks the first on ties ->
        # deterministic given stable binning order)
        amin = jnp.argmin(d, axis=1)  # (NT, th, tw)
        dmin = jnp.take_along_axis(d, amin[:, None], axis=1)[:, 0]
        tmin = jnp.take_along_axis(
            jnp.broadcast_to(cs[..., None, None], d.shape), amin[:, None],
            axis=1,
        )[:, 0]
        closer = dmin < best_d
        return jnp.where(closer, dmin, best_d), jnp.where(closer, tmin, best_t)

    init = (
        jnp.full((nt, th, tw), jnp.inf, jnp.float32),
        jnp.full((nt, th, tw), -1, jnp.int32),
    )
    best_d, best_t = jax.lax.fori_loop(0, n_chunks, body, init)

    # untile: (NT, th, tw) -> (HP, WP) -> crop
    def untile(a):
        a = a.reshape(tiles_y, tiles_x, th, tw)
        a = jnp.transpose(a, (0, 2, 1, 3)).reshape(tiles_y * th, tiles_x * tw)
        return a[:height, :width]

    depth = untile(best_d)
    winner = untile(best_t)
    depth = jnp.where(winner >= 0, depth, 1.0)
    return depth, winner


def resolve_gbuffer(
    batch: TriangleBatch,
    bank: ModelBank,
    depth: jnp.ndarray,
    winner: jnp.ndarray,
    atlas=None,
    with_specular: bool = False,
    with_emissive: bool = False,
    with_dissolve: bool = False,
):
    """Per-pixel attribute interpolation for the winning triangles.

    The first-pass fragment shader's job (first_pass_frag.glsl): write
    world position / normal / albedo, with the material id replacing the
    sentinel position tags. With ``with_specular`` (and an atlas), also
    returns the per-pixel specular-strength image (material scalar x
    specular-map red channel) as ``(gbuf, spec_img)``; with
    ``with_emissive`` additionally the per-pixel emissive-map MULTIPLIER
    (the map's red channel, 1 where unmapped — the caller multiplies it
    into whatever emissive base it uses, material table or system-boosted)
    as ``(gbuf, spec_img, emis_mul)``.
    """
    h, w = depth.shape
    tri = jnp.clip(winner, 0, batch.budget - 1)
    covered = winner >= 0

    vx = batch.xy[tri, :, 0]  # (H, W, 3)
    vy = batch.xy[tri, :, 1]
    px = jnp.arange(w, dtype=jnp.float32)[None, :, None] + 0.5
    py = jnp.arange(h, dtype=jnp.float32)[:, None, None] + 0.5

    def e(a, b):
        return (vx[..., b] - vx[..., a]) * (py[..., 0] - vy[..., a]) - (
            vy[..., b] - vy[..., a]
        ) * (px[..., 0] - vx[..., a])

    l0, l1, l2 = e(1, 2), e(2, 0), e(0, 1)
    area = l0 + l1 + l2
    inv_area = 1.0 / jnp.where(jnp.abs(area) > 1e-12, area, 1.0)
    bary = jnp.stack([l0, l1, l2], axis=-1) * inv_area[..., None]  # (H,W,3)

    # perspective-correct weights
    iw = batch.inv_w[tri]  # (H, W, 3)
    wi = bary * iw
    denom = jnp.sum(wi, axis=-1, keepdims=True)
    pl = wi / jnp.where(jnp.abs(denom) > 1e-12, denom, 1.0)  # (H, W, 3)

    pos = jnp.sum(batch.world_pos[tri] * pl[..., None], axis=-2)
    nrm = jnp.sum(batch.normal[tri] * pl[..., None], axis=-2)
    nlen = jnp.linalg.norm(nrm, axis=-1, keepdims=True)
    nrm = nrm / jnp.where(nlen > 1e-12, nlen, 1.0)
    mat = batch.material[tri]
    mat_safe = jnp.clip(mat, 0, bank.mat_albedo.shape[0] - 1)
    albedo = bank.mat_albedo[mat_safe]
    spec_img = emis_mul = None
    if atlas is not None:
        # textured materials sample the atlas; solid colors skip
        # (first_pass_frag.glsl texture-vs-solid-vs-error selection)
        from render_engine_tpu.render.textures import sample_atlas

        uv = jnp.sum(batch.uv[tri] * pl[..., None], axis=-2)  # (H, W, 2)
        layer = bank.mat_texture[mat_safe]
        tex = sample_atlas(atlas, layer, uv)
        albedo = jnp.where((layer >= 0)[..., None], tex, albedo)
        if with_specular:
            # per-pixel specular strength: the material scalar times the
            # specular map's red channel (the second of the reference's
            # packed texture pairs, model_definitions.rs:71-148)
            slayer = bank.mat_texture_spec[mat_safe]
            smul = sample_atlas(atlas, slayer, uv)[..., 0]
            # mat_specular_eff: quantized in varying-Ns scenes so this
            # golden path matches the packed-channel paths bit-for-bit
            spec_img = bank.mat_specular_eff[mat_safe] * jnp.where(
                slayer >= 0, smul, 1.0)
        if with_emissive:
            # per-pixel emissive-map multiplier, same pattern (third pair)
            elayer = bank.mat_texture_emis[mat_safe]
            emul = sample_atlas(atlas, elayer, uv)[..., 0]
            emis_mul = jnp.where(elayer >= 0, emul, 1.0)
        if bank.has_normal_maps():
            # fourth texture pair: a tangent-space normal map perturbs the
            # G-buffer normal — the one reserved role with real visual
            # payoff (the reference packs NORMAL_INDEX but never samples
            # it, model_definitions.rs:77-81, first_pass_frag.glsl:58-75)
            from render_engine_tpu.render.geometry import (
                perturb_normal,
                triangle_tangents,
            )

            nlayer = bank.mat_texture_norm[mat_safe]
            nsamp = sample_atlas(atlas, nlayer, uv)
            tan, handed = triangle_tangents(batch)
            pert = perturb_normal(nrm, tan[tri], handed[tri], nsamp)
            nrm = jnp.where((nlayer >= 0)[..., None], pert, nrm)

    cm = covered[..., None]
    gbuf = GBuffer(
        depth=depth,
        position=jnp.where(cm, pos, 0.0),
        normal=jnp.where(cm, nrm, 0.0),
        albedo=jnp.where(cm, albedo, 0.0),
        material=jnp.where(covered, mat, MATERIAL_BACKGROUND),
        tri_id=winner,
    )
    if with_dissolve:
        # per-pixel alpha multiplier (MTL map_d red channel; fifth pair)
        # — appended LAST so existing flag combinations keep their shape
        if atlas is not None:
            dlayer = bank.mat_texture_diss[mat_safe]
            dmul_s = sample_atlas(atlas, dlayer, uv)[..., 0]
            diss_mul = jnp.where(dlayer >= 0, dmul_s, 1.0)
        else:
            diss_mul = jnp.ones_like(depth)
        if with_emissive:
            return gbuf, spec_img, emis_mul, diss_mul
        if with_specular:
            return gbuf, spec_img, diss_mul
        return gbuf, diss_mul
    if with_emissive:
        return gbuf, spec_img, emis_mul
    if with_specular:
        return gbuf, spec_img
    return gbuf


def render_gbuffer(
    batch: TriangleBatch,
    bank: ModelBank,
    height: int,
    width: int,
    cfg: RasterConfig = RasterConfig(),
    tri_mask: jnp.ndarray | None = None,
    atlas=None,
    rasterizer=rasterize_depth_winner,
) -> GBuffer:
    depth, winner = rasterizer(batch, height, width, cfg, tri_mask)
    return resolve_gbuffer(batch, bank, depth, winner, atlas=atlas)
