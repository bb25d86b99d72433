"""Fused per-tile shading kernel: attribute interpolation + Blinn-Phong.

A Pallas kernel lowered through Triton, one program per 8x128 tile. It
replaces the tiled frame path's post-resolve stages (_gbuffer_from_channels
+ two lighting.shade passes + transparency blend): each program gathers its
pixels' winner rows from the tile's candidate table (the per-pixel channel
images never reach device memory), loops over the tile's culled light list
read from the packed light table, and emits [lit rgb | t_lit rgb | alpha |
flags] in one launch.

The tiled path's default (RenderSettings.fused_shading). Shadows (per-slot PCF
factor tiles), texture-atlas overrides, and per-tile light lists ARE
threaded through this kernel (frame.py resolves them into per-tile
inputs). The math mirrors lighting.shade exactly (tested against it).

Packed light-table row layout (f32, N_LCOL columns):
  0      kind (0 dir, 1 point, 2 spot)
  1:4    position (point/spot) or unused
  4:7    direction (dir/spot; normalized on the host side)
  7:10   diffuse rgb
  10:13  specular rgb
  13:16  ambient rgb
  16:18  attenuation (linear, quadratic)
  18:20  cutoff (cos inner, cos outer)
  20     influence radius (point; <=0 = unbounded) — LightInformation.radius
         (reference src/exports/light_components.rs:13)
  21:21+S shadow-slot ownership (1.0 where shadow slot s belongs to this
         light; S = shadow budget, 6) — drives the per-slot PCF factor
         multiply in-kernel
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from render_engine_tpu import platform
from render_engine_tpu.math import transforms as T
from render_engine_tpu.render.lighting import (
    DIFFUSE_FLOOR,
    SHININESS,
    LightArrays,
)

N_LCOL = 28  # padded row width (21 + shadow budget 6, padded)
NUM_WARPS = 4  # 128 threads over a 1024-pixel tile: 8 pixels per thread


def pack_lights(lights: LightArrays, budget: int, slot_entity=None):
    """(budget, N_LCOL) f32 table + count, dir/point/spot concatenated.

    Valid rows are COMPACTED to the table prefix so the kernel's
    fori_loop(0, n_live) covers exactly the live lights even when an
    earlier segment is not full (e.g. 0 of 4 dir lights).

    ``slot_entity``: optional (S,) shadow-slot owner entities — fills the
    per-light ownership columns 21:21+S."""
    rows = []
    counts = []

    def seg(kind, pos, direction, dif, spe, amb, att, cut, radius, count,
            entity):
        n = pos.shape[0]
        if n == 0:
            return
        k = jnp.full((n, 1), float(kind), jnp.float32)
        if slot_entity is not None:
            own = (entity[:, None] == slot_entity[None, :]) & (
                entity[:, None] >= 0)
            own = own.astype(jnp.float32)
        else:
            own = jnp.zeros((n, 0), jnp.float32)
        row = jnp.concatenate(
            [k, pos, direction, dif, spe, amb, att, cut,
             radius.reshape(n, 1).astype(jnp.float32),
             own,
             jnp.zeros((n, N_LCOL - 21 - own.shape[1]), jnp.float32)],
            axis=1,
        )
        rows.append(row)
        counts.append(count)

    nd = lights.dir_direction.shape[0]
    dl = lights.dir_direction
    dlen = jnp.linalg.norm(dl, axis=-1, keepdims=True)
    dl = dl / jnp.where(dlen > 1e-9, dlen, 1.0)
    seg(0, jnp.zeros((nd, 3)), dl, lights.dir_diffuse,
        lights.dir_specular, lights.dir_ambient, jnp.zeros((nd, 2)),
        jnp.zeros((nd, 2)), jnp.zeros((nd,)), lights.dir_count,
        lights.dir_entity)
    npnt = lights.pt_position.shape[0]
    seg(1, lights.pt_position, jnp.zeros((npnt, 3)), lights.pt_diffuse,
        lights.pt_specular, lights.pt_ambient, lights.pt_atten,
        jnp.zeros((npnt, 2)), lights.pt_radius, lights.pt_count,
        lights.pt_entity)
    ns = lights.sp_position.shape[0]
    sd = lights.sp_direction
    slen = jnp.linalg.norm(sd, axis=-1, keepdims=True)
    sd = sd / jnp.where(slen > 1e-9, slen, 1.0)
    seg(2, lights.sp_position, sd, lights.sp_diffuse, lights.sp_specular,
        lights.sp_ambient, lights.sp_atten, lights.sp_cutoff,
        jnp.zeros((ns,)), lights.sp_count, lights.sp_entity)

    table = jnp.concatenate(rows, axis=0) if rows else jnp.zeros(
        (0, N_LCOL), jnp.float32)
    # per-segment enable masks -> one flat validity vector
    valid_parts = []
    for row, count in zip(rows, counts):
        n = row.shape[0]
        valid_parts.append(jnp.arange(n) < count)
    valid = (jnp.concatenate(valid_parts) if valid_parts
             else jnp.zeros(0, bool))
    total = table.shape[0]
    assert total <= budget, (
        f"light table has {total} rows but fused-shade budget is {budget}; "
        "size the budget from RenderSettings (max_dir+max_point+max_spot)")
    # compact valid rows to the prefix (stable: keeps dir->point->spot order)
    if total:
        order = jnp.argsort(jnp.where(valid, 0, 1).astype(jnp.int32),
                            stable=True)
        table = jnp.where(valid[order][:, None], table[order], 0.0)
    if total < budget:
        table = jnp.concatenate(
            [table, jnp.zeros((budget - total, N_LCOL), jnp.float32)])
    n_live = jnp.sum(valid.astype(jnp.int32))
    return table, n_live


def select_tile_lights(ltab, n_live, camera_position, inv_pv, tiles_x,
                       tiles_y, tile_h, tile_w, width, h_total,
                       y_off, budget: int):
    """Per-tile light lists — the tiled light-volume pass.

    The reference bounds each point light's screen effect with a sphere
    proxy in the second pass (render_engine_assets/shaders/
    second_pass_vertex.glsl:1-20); here each TILE culls the packed light
    table against its view pyramid (4 side planes + behind-camera plane,
    sphere-conservative, xy only — no depth dependence, so the engine's
    stats program reproduces the exact counts). The kernel's light loop
    then runs over tlist[t, :tcount[t]] instead of all n_live lights.

    Culled lights contribute EXACTLY 0 in the full loop (their radius
    cutoff zeroes the attenuation), and tlist preserves ascending table
    order, so tile-listed shading is bit-identical to the full loop
    whenever nothing overflows the budget.

    Always included: directional lights and any light with radius <= 0
    (unbounded; spot rows currently pack radius 0). Returns
    (tlist int32 (NT, budget), tcount int32 (NT,), dropped int32 scalar).
    """
    nt = tiles_x * tiles_y
    ll = ltab.shape[0]
    cam = jnp.asarray(camera_position, jnp.float32)

    # tile-corner world rays: unproject the (tiles_y+1, tiles_x+1) grid of
    # tile boundary pixels at a fixed NDC depth; rays = world - camera
    cx = (jnp.arange(tiles_x + 1, dtype=jnp.float32) * tile_w)
    cy = (jnp.arange(tiles_y + 1, dtype=jnp.float32) * tile_h
          + jnp.float32(y_off))
    ndc_x = cx / jnp.float32(width) * 2.0 - 1.0
    ndc_y = 1.0 - cy / jnp.float32(h_total) * 2.0
    gx = jnp.broadcast_to(ndc_x[None, :], (tiles_y + 1, tiles_x + 1))
    gy = jnp.broadcast_to(ndc_y[:, None], (tiles_y + 1, tiles_x + 1))
    ndc = jnp.stack([gx, gy, jnp.full_like(gx, 0.5), jnp.ones_like(gx)],
                    axis=-1)
    wp = jnp.einsum("ij,yxj->yxi", inv_pv, ndc, precision=T.MM_PRECISION)
    rays = wp[..., :3] / jnp.where(jnp.abs(wp[..., 3:4]) > 1e-12,
                                   wp[..., 3:4], 1.0) - cam  # (Ty+1,Tx+1,3)

    tl = rays[:-1, :-1]  # (Ty, Tx, 3)
    tr = rays[:-1, 1:]
    bl = rays[1:, :-1]
    br = rays[1:, 1:]
    planes = jnp.stack(
        [jnp.cross(tl, bl),   # left
         jnp.cross(br, tr),   # right
         jnp.cross(tr, tl),   # top
         jnp.cross(bl, br)],  # bottom
        axis=2)  # (Ty, Tx, 4, 3)
    center = tl + tr + bl + br  # (Ty, Tx, 3) un-normalized center ray
    # orient every normal inward (positive toward the tile's own rays)
    sign = jnp.sign(jnp.sum(planes * center[:, :, None, :], axis=-1))
    sign = jnp.where(sign == 0.0, 1.0, sign)
    planes = planes * sign[..., None]
    planes = planes / jnp.maximum(
        jnp.linalg.norm(planes, axis=-1, keepdims=True), 1e-12)
    clen = jnp.maximum(jnp.linalg.norm(center, axis=-1, keepdims=True),
                       1e-12)
    fwd = (center / clen)[:, :, None, :]  # behind-camera plane normal
    planes = jnp.concatenate([planes, fwd], axis=2)  # (Ty, Tx, 5, 3)
    planes = planes.reshape(nt, 5, 3)

    kind = ltab[:, 0]
    lpos = ltab[:, 1:4] - cam[None, :]  # (L, 3) light offsets from camera
    radius = ltab[:, 20]
    live = jnp.arange(ll) < n_live
    always = live & ((kind < 0.5) | (radius <= 0.0))
    d = jnp.einsum("tpi,li->tpl", planes, lpos,
                   precision=T.MM_PRECISION)  # (NT, 5, L)
    in_pyramid = jnp.all(d >= -radius[None, None, :], axis=1)  # (NT, L)
    mask = always[None, :] | (live[None, :] & in_pyramid)
    mask = mask & live[None, :]

    idx = jnp.arange(ll, dtype=jnp.int32)
    key = jnp.where(mask, idx[None, :], ll)
    tlist = jnp.sort(key, axis=1)[:, :budget]
    tlist = jnp.where(tlist < ll, tlist, 0).astype(jnp.int32)
    counts = jnp.sum(mask.astype(jnp.int32), axis=1)
    tcount = jnp.minimum(counts, budget)
    dropped = jnp.sum(jnp.maximum(counts - budget, 0))
    return tlist, tcount, dropped.astype(jnp.int32)


def _interp(ch, px, py, spec_packed=False):
    """Per-pixel winner attributes from the resolved channels (a callable
    ``ch(c) -> (th, tw)``).

    ``spec_packed``: channel 34 carries the quantized (specular strength,
    shininess exponent) packing of varying-Ns scenes (models/bank.py
    pack_spec_shin) — returns (spec, shin) decoded; otherwise spec is the
    raw strength and shin is None (the caller uses the scene's
    compile-time exponent)."""
    x0, y0, x1, y1, x2, y2 = ch(0), ch(1), ch(2), ch(3), ch(4), ch(5)
    l0 = (x2 - x1) * (py - y1) - (y2 - y1) * (px - x1)
    l1 = (x0 - x2) * (py - y2) - (y0 - y2) * (px - x2)
    l2 = (x1 - x0) * (py - y0) - (y1 - y0) * (px - x0)
    area = l0 + l1 + l2
    inv_area = 1.0 / jnp.where(jnp.abs(area) > 1e-12, area, 1.0)
    b0, b1, b2 = l0 * inv_area, l1 * inv_area, l2 * inv_area
    w0, w1, w2 = b0 * ch(25), b1 * ch(26), b2 * ch(27)
    denom = w0 + w1 + w2
    inv_d = 1.0 / jnp.where(jnp.abs(denom) > 1e-12, denom, 1.0)
    p0, p1, p2 = w0 * inv_d, w1 * inv_d, w2 * inv_d

    nx = p0 * ch(10) + p1 * ch(13) + p2 * ch(16)
    ny = p0 * ch(11) + p1 * ch(14) + p2 * ch(17)
    nz = p0 * ch(12) + p1 * ch(15) + p2 * ch(18)
    nl = jax.lax.rsqrt(jnp.maximum(nx * nx + ny * ny + nz * nz, 1e-24))
    c34 = ch(34)
    if spec_packed:
        # exact decode (bank.unpack_spec_shin semantics, in-kernel)
        hq = jnp.floor(c34 * (1.0 / 4096.0))
        spec = (c34 - hq * 4096.0) * (1.0 / 1024.0)
        shin = hq
    else:
        spec, shin = c34, None
    return (nx * nl, ny * nl, nz * nl), (ch(29), ch(30), ch(31)), ch(32), \
        ch(33), spec, shin


def _shade_kernel(
    tiles_x, tile_h, tile_w, width, height, n_slots, has_texture,
    ovr_chans,  # override channels per pass: 4 = [rgb|flag], 5 adds the
    #             specular-map DELTA (spec_k multiplies by 1 + delta),
    #             6 adds the emissive-map delta; with_norm appends 4 more
    with_norm,  # static: the LAST 4 override channels are the normal-map
    #             perturbed world normal + use-flag
    with_diss,  # static: override channel 6 is the dissolve-map alpha
    #             delta (alpha multiplies by 1 + delta; transparent pass)
    use_tile_lights,  # static: light loop runs over this tile's culled
    #                   list (tl_ref/tc_ref) instead of all n_live lights
    spec_packed,  # static: channel 34 is the quantized (spec, Ns) packing
    shin_const,  # static float: the scene's uniform specular exponent
    #              (used when not spec_packed)
    rows_ref,  # (K, A) this tile's candidate attribute rows
    so_ref, st_ref,  # (th, tw) winner candidate slots, opaque/transparent
    do_ref, dt_ref,  # (th, tw) depths
    ltab_ref,  # (L, N_LCOL) packed light table (whole)
    lcount_ref,  # (1,) live light count
    tl_ref,  # (LB,) int32 this tile's light list (tile-culled)
    tc_ref,  # (1,) int32 its live count (unused unless use_tile_lights)
    cam_ref,  # (3,) camera position
    ipv_ref,  # (4, 4) inverse proj-view
    org_ref,  # (2,) global pixel origin (x, y) of this buffer — nonzero
    #           under multi-device row sharding, where the local tile grid
    #           starts partway down the global image
    inv_ref,  # (S, NT) int32 per-slot tile -> compact factor row (whole;
    #           -1 = not selected -> lit)
    sft_ref,  # (S, TB, th, tw) compact per-slot PCF factor tiles (whole)
    ovr_ref,  # (2*ovr_chans, th, tw) this tile's texture overrides
    out_ref,  # (8, th, tw): lit rgb, t_lit rgb, alpha, flags
):
    t = pl.program_id(0)
    oy = ((t // tiles_x) * tile_h).astype(jnp.float32)
    ox = ((t % tiles_x) * tile_w).astype(jnp.float32)
    # px/py are LOCAL pixel coords (edge functions match the possibly
    # row-shifted batch coordinates); unprojection adds the global origin
    py = (jax.lax.broadcasted_iota(jnp.int32, (tile_h, tile_w), 0)
          .astype(jnp.float32) + oy + 0.5)
    px = (jax.lax.broadcasted_iota(jnp.int32, (tile_h, tile_w), 1)
          .astype(jnp.float32) + ox + 0.5)

    # world position from depth (shared by both layers' shading)
    def unproject(depth):
        ndc_x = (px + org_ref[0]) / width * 2.0 - 1.0
        ndc_y = 1.0 - (py + org_ref[1]) / height * 2.0
        cx = (ipv_ref[0, 0] * ndc_x + ipv_ref[0, 1] * ndc_y
              + ipv_ref[0, 2] * depth + ipv_ref[0, 3])
        cy = (ipv_ref[1, 0] * ndc_x + ipv_ref[1, 1] * ndc_y
              + ipv_ref[1, 2] * depth + ipv_ref[1, 3])
        cz = (ipv_ref[2, 0] * ndc_x + ipv_ref[2, 1] * ndc_y
              + ipv_ref[2, 2] * depth + ipv_ref[2, 3])
        cw = (ipv_ref[3, 0] * ndc_x + ipv_ref[3, 1] * ndc_y
              + ipv_ref[3, 2] * depth + ipv_ref[3, 3])
        inv = 1.0 / jnp.where(jnp.abs(cw) > 1e-12, cw, 1.0)
        return cx * inv, cy * inv, cz * inv

    # per-slot compact factor rows of THIS tile (scalars, loaded once)
    slot_rows = [inv_ref[sl, t] for sl in range(n_slots)]

    def shade_layer(slot, depth, covered, use_shadows, ovr_base):
        # in-kernel resolve: each channel is a gather of the winner rows
        # from this tile's candidate table (an L1/L2-resident block), so
        # the per-pixel channel images never touch device memory
        safe = jnp.maximum(slot, 0)

        def ch(c):
            return rows_ref[safe, c]

        (nx, ny, nz), (ar, ag, ab), emissive, alpha, spec_k, shin = _interp(
            ch, px, py, spec_packed=spec_packed)
        if shin is None:
            shin = shin_const
        if has_texture:
            base_chans = ovr_chans - (4 if with_norm else 0)
            tf = ovr_ref[ovr_base + 3] > 0.5
            ar = jnp.where(tf, ovr_ref[ovr_base + 0], ar)
            ag = jnp.where(tf, ovr_ref[ovr_base + 1], ag)
            ab = jnp.where(tf, ovr_ref[ovr_base + 2], ab)
            if base_chans >= 5:
                # specular-map delta: neutral (0) for unselected tiles and
                # spec-less materials, (sample - 1) otherwise
                spec_k = spec_k * (1.0 + ovr_ref[ovr_base + 4])
            if base_chans >= 6:
                # emissive-map delta, same neutral-zero convention
                emissive = emissive * (1.0 + ovr_ref[ovr_base + 5])
            if with_diss and base_chans >= 7:
                # dissolve-map delta: per-pixel alpha (map_d, fifth pair);
                # only the transparent pass consumes alpha downstream
                alpha = alpha * (1.0 + ovr_ref[ovr_base + 6])
            if with_norm:
                # normal-map override: replace the interpolated normal
                # where the flag is set (unselected tiles stay geometric)
                nb = ovr_base + base_chans
                nf = ovr_ref[nb + 3] > 0.5
                nx = jnp.where(nf, ovr_ref[nb + 0], nx)
                ny = jnp.where(nf, ovr_ref[nb + 1], ny)
                nz = jnp.where(nf, ovr_ref[nb + 2], nz)
        wx, wy, wz = unproject(depth)
        vx = cam_ref[0] - wx
        vy = cam_ref[1] - wy
        vz = cam_ref[2] - wz
        vl = jax.lax.rsqrt(jnp.maximum(vx * vx + vy * vy + vz * vz, 1e-24))
        vx, vy, vz = vx * vl, vy * vl, vz * vl

        zero = jnp.zeros((tile_h, tile_w), jnp.float32)

        def light_body(i, acc):
            cr, cg, cb = acc
            li = tl_ref[i] if use_tile_lights else i
            kind = ltab_ref[li, 0]
            lpx, lpy, lpz = ltab_ref[li, 1], ltab_ref[li, 2], ltab_ref[li, 3]
            ldx, ldy, ldz = ltab_ref[li, 4], ltab_ref[li, 5], ltab_ref[li, 6]
            # point/spot: direction from surface to light; dir: -direction
            tx, ty, tz = lpx - wx, lpy - wy, lpz - wz
            d2 = tx * tx + ty * ty + tz * tz
            d = jnp.sqrt(jnp.maximum(d2, 1e-18))
            invd = 1.0 / d
            is_dir = kind < 0.5
            lx = jnp.where(is_dir, -ldx, tx * invd)
            ly = jnp.where(is_dir, -ldy, ty * invd)
            lz = jnp.where(is_dir, -ldz, tz * invd)
            atten = jnp.where(
                is_dir, 1.0,
                1.0 / (1.0 + ltab_ref[li, 16] * d + ltab_ref[li, 17] * d2),
            )
            # point-light influence radius (<=0 = unbounded)
            radius = ltab_ref[li, 20]
            atten = jnp.where((radius > 0.0) & (d > radius), 0.0, atten)
            # spot smooth cutoff
            cos_t = -(lx * ldx + ly * ldy + lz * ldz)
            inner, outer = ltab_ref[li, 18], ltab_ref[li, 19]
            eps = jnp.maximum(inner - outer, 1e-6)
            spot_i = jnp.clip((cos_t - outer) / eps, 0.0, 1.0)
            intensity = jnp.where(kind > 1.5, spot_i, 1.0)

            ndl = jnp.maximum(nx * lx + ny * ly + nz * lz, 0.0)
            hx, hy, hz = lx + vx, ly + vy, lz + vz
            hl = jax.lax.rsqrt(jnp.maximum(hx * hx + hy * hy + hz * hz,
                                           1e-24))
            ndh = jnp.maximum((nx * hx + ny * hy + nz * hz) * hl, 0.0)
            # per-material specular strength (gAlbedoSpec.a semantics) and
            # exponent (MTL Ns; a compile-time constant in uniform scenes)
            spec = jnp.where(ndl > 0.0, ndh ** shin, 0.0) * spec_k
            s = atten * intensity
            if use_shadows:
                # per-slot PCF factor, multiplicatively combined over the
                # slots this light owns (cube faces etc.); tiles outside
                # the slot's compact selection (row < 0) are lit. The
                # factor tile is loaded only for owned, mapped slots.
                for sl in range(n_slots):
                    row = slot_rows[sl]
                    use = (ltab_ref[li, 21 + sl] > 0.5) & (row >= 0)
                    s = jax.lax.cond(
                        use,
                        lambda s=s, sl=sl, row=row: (
                            s * sft_ref[sl, jnp.maximum(row, 0)]),
                        lambda s=s: s * 1.0)
            cr = cr + s * (ltab_ref[li, 13] * ar + ltab_ref[li, 7] * ndl * ar
                           + ltab_ref[li, 10] * spec)
            cg = cg + s * (ltab_ref[li, 14] * ag + ltab_ref[li, 8] * ndl * ag
                           + ltab_ref[li, 11] * spec)
            cb = cb + s * (ltab_ref[li, 15] * ab + ltab_ref[li, 9] * ndl * ab
                           + ltab_ref[li, 12] * spec)
            return cr, cg, cb

        n_iter = tc_ref[0] if use_tile_lights else lcount_ref[0]
        cr, cg, cb = jax.lax.fori_loop(0, n_iter, light_body,
                                       (zero, zero, zero))
        cr = jnp.maximum(cr, DIFFUSE_FLOOR * ar)
        cg = jnp.maximum(cg, DIFFUSE_FLOOR * ag)
        cb = jnp.maximum(cb, DIFFUSE_FLOOR * ab)
        emi = emissive > 0.0
        cr = jnp.where(emi, ar * emissive, cr)
        cg = jnp.where(emi, ag * emissive, cg)
        cb = jnp.where(emi, ab * emissive, cb)
        return (jnp.where(covered, cr, 0.0), jnp.where(covered, cg, 0.0),
                jnp.where(covered, cb, 0.0), alpha)

    s_o = so_ref[...]
    s_t = st_ref[...]
    d_o = do_ref[...]
    d_t = dt_ref[...]
    cov_o = s_o >= 0
    cov_t = s_t >= 0
    zero = jnp.zeros((tile_h, tile_w), jnp.float32)

    def any_(m):
        return jnp.max(m.astype(jnp.int32)) > 0

    # per-tile coverage gates: sky tiles skip the whole resolve+light loop,
    # and the transparent layer (usually a handful of tiles) only shades
    # where a transparent candidate actually won a pixel. Shadows apply to
    # the opaque (deferred) layer only — the reference's transparency draw
    # is a forward pass with no shadow sampling (render_system.rs:501)
    r_o, g_o, b_o, _ = jax.lax.cond(
        any_(cov_o),
        lambda: shade_layer(s_o, d_o, cov_o, n_slots > 0, 0),
        lambda: (zero, zero, zero, zero),
    )
    r_t, g_t, b_t, alpha = jax.lax.cond(
        any_(cov_t),
        lambda: shade_layer(s_t, d_t, cov_t, False, ovr_chans),
        lambda: (zero, zero, zero, zero),
    )

    t_front = cov_t & (d_t <= d_o)
    flags = cov_o.astype(jnp.float32) + 2.0 * t_front.astype(jnp.float32)
    out_ref[0] = r_o
    out_ref[1] = g_o
    out_ref[2] = b_o
    out_ref[3] = r_t
    out_ref[4] = g_t
    out_ref[5] = b_t
    out_ref[6] = jnp.where(cov_t, alpha, 1.0)
    out_ref[7] = flags


def fused_shade(rows, s_o, s_t, d_o, d_t, lights: LightArrays,
                camera_position, inv_pv, tiles_x, width, height,
                light_budget: int | None = None,
                slot_factor_tiles=None, slot_factor_inv=None,
                slot_entity=None,
                pixel_origin=(0.0, 0.0), albedo_override=None,
                tile_lights=None, with_norm=False, with_diss=False,
                spec_packed=False, shin_const=SHININESS):
    """Run the fused resolve+interp+lighting kernel over tiled buffers.

    rows: (NT, K, A) gathered candidate attribute rows; s_o/s_t:
    (NT, th, tw) winner candidate slots; d: (NT, th, tw) depths. The
    winner-attribute resolve happens IN-KERNEL (the channel images never
    touch device memory). Returns (8, NT, th, tw): [lit rgb | t_lit rgb |
    alpha | flags] where flags bit0 = opaque covered, bit1 = transparent in
    front.

    ``light_budget`` defaults to the full packed-table size
    (dir+point+spot capacities) so no light is ever truncated.
    ``slot_factor_tiles``: optional COMPACT (S, TB, th, tw) per-shadow-slot
    PCF factor tiles with ``slot_factor_inv`` (S, NT) int32 mapping each
    screen tile to its compact row (-1 = unselected -> lit). Each program
    reads its own tile's rows of the inverse map and loads only the factor
    tiles it needs, so the dense (S, NT, th, tw) image never exists.
    ``slot_entity``: the matching (S,) owner entities. Shadows multiply
    the opaque layer's per-light contribution in-kernel.
    ``tile_lights``: optional (tlist (NT, LB) int32, tcount (NT,) int32)
    from select_tile_lights — the light loop then covers only each tile's
    culled list (bit-identical when nothing overflowed the budget).
    Compiled on the GPU, interpreted on the CPU (platform).
    """
    if light_budget is None:
        light_budget = (lights.dir_direction.shape[0]
                        + lights.pt_position.shape[0]
                        + lights.sp_position.shape[0])
    nt, k, a = rows.shape
    th, tw = s_o.shape[1], s_o.shape[2]
    ltab, n_live = pack_lights(lights, light_budget, slot_entity=slot_entity)
    if light_budget == 0:
        ltab = jnp.zeros((1, N_LCOL), jnp.float32)  # never read
    lcount = n_live.reshape(1).astype(jnp.int32)
    cam = jnp.asarray(camera_position, jnp.float32).reshape(3)
    org = jnp.asarray(pixel_origin, jnp.float32).reshape(2)
    if slot_factor_tiles is None:
        n_slots = 0
        sft = jnp.ones((1, 1, th, tw), jnp.float32)  # never read
        sfi = jnp.full((1, nt), -1, jnp.int32)
    else:
        n_slots = slot_factor_tiles.shape[0]
        assert n_slots <= N_LCOL - 21, "shadow budget exceeds light-table pad"
        assert slot_factor_inv.shape == (n_slots, nt)
        sft = slot_factor_tiles
        sfi = slot_factor_inv.astype(jnp.int32)
    has_texture = albedo_override is not None
    ovr = (albedo_override if has_texture
           else jnp.zeros((8, 1, th, tw), jnp.float32))
    ovr_chans = ovr.shape[0] // 2  # 4, +1 spec-map delta, +1 emissive-map

    use_tile_lights = tile_lights is not None
    if use_tile_lights:
        tlist, tcount = tile_lights
        tl_arg = tlist.astype(jnp.int32)
        tc_arg = tcount.reshape(nt, 1).astype(jnp.int32)
        tl_spec = pl.BlockSpec((None, tl_arg.shape[1]), lambda i: (i, 0))
        tc_spec = pl.BlockSpec((None, 1), lambda i: (i, 0))
    else:
        tl_arg = jnp.zeros((1, 1), jnp.int32)
        tc_arg = jnp.zeros((1, 1), jnp.int32)
        tl_spec = pl.BlockSpec((None, 1), lambda i: (0, 0))
        tc_spec = pl.BlockSpec((None, 1), lambda i: (0, 0))

    kernel = functools.partial(_shade_kernel, tiles_x, th, tw,
                               float(width), float(height),
                               n_slots, has_texture, ovr_chans,
                               bool(with_norm) and has_texture,
                               bool(with_diss) and has_texture,
                               use_tile_lights, bool(spec_packed),
                               float(shin_const))

    def tile(i):
        return (i, 0, 0)

    def whole(x):
        return pl.BlockSpec(x.shape, lambda i, n=x.ndim: (0,) * n)

    return pl.pallas_call(
        kernel,
        grid=(nt,),
        in_specs=[
            pl.BlockSpec((None, k, a), tile),
            pl.BlockSpec((None, th, tw), tile),
            pl.BlockSpec((None, th, tw), tile),
            pl.BlockSpec((None, th, tw), tile),
            pl.BlockSpec((None, th, tw), tile),
            whole(ltab),
            whole(lcount),
            tl_spec,
            tc_spec,
            whole(cam),
            whole(inv_pv),
            whole(org),
            whole(sfi),
            whole(sft),
            pl.BlockSpec(
                (ovr.shape[0], None, th, tw),
                (lambda i: (0, i, 0, 0)) if has_texture
                else (lambda i: (0, 0, 0, 0))),
        ],
        out_specs=[
            pl.BlockSpec((8, None, th, tw), lambda i: (0, i, 0, 0)),
        ],
        out_shape=[jax.ShapeDtypeStruct((8, nt, th, tw), jnp.float32)],
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=NUM_WARPS,
                                                num_stages=1),
        interpret=platform.interpret_kernels(),
        name="fused_shade",
    )(rows, s_o, s_t, d_o, d_t, ltab, lcount, tl_arg, tc_arg, cam,
      jnp.asarray(inv_pv, jnp.float32), org, sfi, sft, ovr)[0]
