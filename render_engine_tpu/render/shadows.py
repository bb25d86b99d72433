"""Shadow maps: light cameras, depth-only raster, PCF, round-robin budget.

Port of the reference's ShadowFlow (src/flows/shadow_flow.rs): a budget of 6
shadow-map layers at 1024^2 with AT MOST ONE new map rendered per frame,
round-robin across light types (:111-133), prioritizing currently-visible
lights and evicting maps of lights that left the neighborhood (:364-447).
Light cameras: directional -> orthographic (:140-204), spot -> perspective
along the spot direction, point -> perspective using the light's fov field
(:211-260). The PCF 3x3 comparison in the lighting pass ports
second_pass_frag.glsl:141-207 (border-clamped lookups return lit).

Shadow maps are derived caches (like the reference's GPU-side layers): they
live outside the replayed world state and rebuild deterministically during
playback because the schedule is a pure function of (state, cursor).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from render_engine_tpu.ecs import registry as R
from render_engine_tpu.ecs.world import World
from render_engine_tpu.math import transforms as T
from render_engine_tpu.render.geometry import build_triangle_batch, to_screen
from render_engine_tpu.render.raster_jnp import (
    RasterConfig,
)

SHADOW_BUDGET = 6  # reference render_flow.rs:220-235
SHADOW_RES = 1024
PCF_BIAS = 2e-3


N_PCF = 16  # neighborhood row width: 9 taps padded to a 64-byte row


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["maps", "maps_pcf", "light_mats", "slot_entity",
                 "slot_face", "cursor", "tick"],
    meta_fields=["resolution", "pcf_scale"],
)
@dataclasses.dataclass(frozen=True)
class ShadowState:
    maps: jnp.ndarray  # (BUDGET, S, S) NDC depth from the light camera
    # (BUDGET, S*S, N_PCF): each texel's 3x3 depth neighborhood (columns
    # 0:9, edge-clamped, padded to an aligned 64-byte row), precomputed by
    # pure SHIFTS in map space when a map renders. PCF then needs ONE
    # contiguous row gather per pixel instead of 9 separate gathers — the
    # same trade as the raster's packed candidate rows.
    maps_pcf: jnp.ndarray
    light_mats: jnp.ndarray  # (BUDGET, 4, 4) light proj_view per slot
    slot_entity: jnp.ndarray  # (BUDGET,) entity index of the light, -1 free
    slot_face: jnp.ndarray  # (BUDGET,) cube face 0-5 (point lights), else 0
    cursor: jnp.ndarray  # int32 round-robin cursor
    tick: jnp.ndarray  # int32 frames seen (drives update_interval gating)
    resolution: int
    # compute PCF factors every pcf_scale-th pixel and nearest-upsample:
    # the gather is the dominant cost (12.8 ms/slot at 1080p full-res);
    # scale 2 quarters it at a penumbra-sharpness cost only
    pcf_scale: int


def pack_shadow_state(sh: ShadowState):
    """ShadowState -> 4 boundary leaves (maps, maps_pcf, f32 vec, i32
    counters). Every pytree leaf crossing a jit boundary is its own buffer
    handle with its own dispatch cost; the five small fields ride two
    leaves.
    Bit-exact: light_mats is f32 pass-through; slot ids are < 2^24 (f32
    exact); cursor/tick stay int32."""
    vec = jnp.concatenate([
        sh.light_mats.reshape(-1),
        sh.slot_entity.astype(jnp.float32),
        sh.slot_face.astype(jnp.float32),
    ])
    return sh.maps, sh.maps_pcf, vec, jnp.stack([sh.cursor, sh.tick])


def unpack_shadow_state(maps, maps_pcf, vec, counters,
                        template: ShadowState) -> ShadowState:
    """Traced inverse of ``pack_shadow_state`` (static config — resolution,
    pcf_scale, slot budget — comes from ``template``)."""
    s = template.slot_entity.shape[0]
    return dataclasses.replace(
        template,
        maps=maps,
        maps_pcf=maps_pcf,
        light_mats=vec[:s * 16].reshape(s, 4, 4),
        slot_entity=vec[s * 16:s * 17].astype(jnp.int32),
        slot_face=vec[s * 17:s * 18].astype(jnp.int32),
        cursor=counters[0],
        tick=counters[1],
    )


def create_shadow_state(resolution: int = SHADOW_RES,
                        budget: int = SHADOW_BUDGET,
                        pcf_scale: int = 1) -> ShadowState:
    return ShadowState(
        maps=jnp.ones((budget, resolution, resolution), jnp.float32),
        maps_pcf=jnp.ones((budget, resolution * resolution, N_PCF),
                          jnp.float32),
        light_mats=jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32),
                                    (budget, 4, 4)),
        slot_entity=jnp.full(budget, -1, jnp.int32),
        slot_face=jnp.zeros(budget, jnp.int32),
        cursor=jnp.int32(0),
        tick=jnp.int32(0),
        resolution=resolution,
        pcf_scale=pcf_scale,
    )


def neighborhood_stack(depth: jnp.ndarray) -> jnp.ndarray:
    """(R, R) depth -> (R*R, N_PCF) 3x3 neighborhoods (cols 0:9),
    edge-clamped (the GLSL border-clamp semantics) — pure shifts, no
    gathers."""
    r = depth.shape[0]
    padded = jnp.pad(depth, 1, mode="edge")
    cols = [
        padded[1 + dy:1 + dy + r, 1 + dx:1 + dx + r]
        for dy in (-1, 0, 1) for dx in (-1, 0, 1)
    ]
    cols += [jnp.full((r, r), jnp.inf, jnp.float32)] * (N_PCF - 9)
    return jnp.stack(cols, axis=-1).reshape(r * r, N_PCF)


# cube face directions / ups, GL order +X -X +Y -Y +Z -Z
_FACE_DIRS = jnp.array(
    [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]],
    jnp.float32,
)
_FACE_UPS = jnp.array(
    [[0, -1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1], [0, -1, 0], [0, -1, 0]],
    jnp.float32,
)


# ---------------------------------------------------------------------------
# light cameras
# ---------------------------------------------------------------------------
def light_proj_view(world: World, entity: jnp.ndarray,
                    ortho_extent: float | None = None,
                    near: float = 1.0, far: float | None = None,
                    face: jnp.ndarray | int = 0) -> jnp.ndarray:
    """proj_view for a light entity, selected by its sortable bucket.

    directional: ortho box looking along light_direction from the light's
    position; spot: perspective along light_direction with the light's fov;
    point: one 90-degree cube ``face`` (+X -X +Y -Y +Z -Z), rendered one
    face per frame (shadow_flow.rs:140-358 semantics, with the reference's
    6-face schedule applied to point lights).

    The camera volume is FITTED to the light (the reference derives its
    shadow camera from draw distances + the light's neighborhood,
    shadow_flow.rs:140-260): with ``ortho_extent``/``far`` left None, a
    light with ``light_radius`` r > 0 gets ortho half-extent r and far 2r
    (directional: receivers lie within r of the light, casters up to r
    further along the beam), and perspective far r (spot/point influence
    ends at the radius cutoff). Lights without a radius fall back to the
    legacy 200/600 box. Casters still outside the fitted volume are counted
    in ``shadow_caster_outside_volume`` (Engine.render_drop_stats)."""
    e = jnp.clip(entity, 0, world.capacity - 1)
    pos = world["position"][e]
    is_dir = world["sortable"][e] == R.SORTABLE_DIRECTIONAL
    is_point = world["sortable"][e] == R.SORTABLE_POINT

    radius = world["light_radius"][e]
    has_r = radius > 0.0
    if ortho_extent is None:
        ortho_extent = jnp.where(has_r, radius, jnp.float32(200.0))
    if far is None:
        ortho_far = jnp.where(has_r, 2.0 * radius, jnp.float32(600.0))
        persp_far = jnp.where(has_r, radius, jnp.float32(600.0))
    else:
        ortho_far = persp_far = jnp.float32(far)
    # spot cones narrower than the radius keep full depth; guard far > near
    ortho_far = jnp.maximum(ortho_far, jnp.float32(near) + 1.0)
    persp_far = jnp.maximum(persp_far, jnp.float32(near) + 1.0)

    direction = world["light_direction"][e]
    dlen = jnp.linalg.norm(direction)
    direction = jnp.where(dlen > 1e-6, direction / jnp.maximum(dlen, 1e-6),
                          jnp.array([0.0, -1.0, 0.0]))
    face = jnp.asarray(face, jnp.int32)
    direction = jnp.where(is_point, _FACE_DIRS[face], direction)
    # avoid a degenerate up vector
    up = jnp.where(jnp.abs(direction[1]) > 0.99,
                   jnp.array([1.0, 0.0, 0.0]), jnp.array([0.0, 1.0, 0.0]))
    up = jnp.where(is_point, _FACE_UPS[face], up)
    view = T.look_at(pos, pos + direction, up)

    fov = jnp.clip(world["light_fov"][e], 0.2, 3.0)
    # spot cameras widen to cover the light's OUTER cutoff cone (+5% margin
    # for AABB extents at the cone edge): everything that cone lights can
    # be shadowed, so the camera must see it all (shadow_flow.rs:211-260
    # derives the spot camera from the light's own geometry). A cutoff of
    # 0 (unset column) keeps the user's light_fov.
    cos_outer = world["light_cutoff"][e][1]
    cone_fov = 2.0 * jnp.arccos(jnp.clip(cos_outer, -0.999, 0.999)) * 1.05
    fov = jnp.where((cos_outer > 1e-3) & ~is_dir & ~is_point,
                    jnp.clip(jnp.maximum(fov, cone_fov), 0.2, 3.0), fov)
    fov = jnp.where(is_point, jnp.float32(jnp.pi / 2), fov)  # cube face 90deg
    persp = T.perspective(fov, 1.0, near, persp_far)
    ortho = T.orthographic(-ortho_extent, ortho_extent, -ortho_extent,
                           ortho_extent, near, ortho_far)
    proj = jnp.where(is_dir, ortho, persp)
    return T.mm44(proj, view)


def casters_outside_volume(world: World, light_entity: jnp.ndarray,
                           proj_view: jnp.ndarray) -> jnp.ndarray:
    """int32 count of shadow-relevant casters the light camera cannot see —
    the 'every truncation is counted' contract applied to the shadow volume
    (the reference avoids the truncation by construction, fitting the camera
    to the neighborhood, shadow_flow.rs:140-260; here the fitted camera
    should drive this to zero and any regression shows up as a counter).

    Relevant casters per light kind: within ``light_radius`` of the light
    (fallback 200 for radius-less lights), with a model, excluding the light
    entity itself; spot lights additionally restrict to the outer cutoff
    cone (a blocker must lie on an apex-to-receiver segment, which never
    leaves the cone). Point lights count zero by construction — their six
    cube faces tile the full sphere."""
    from render_engine_tpu.world import culling

    cap = world.capacity
    e = jnp.clip(light_entity, 0, cap - 1)
    pos = world["position"][e]
    radius = world["light_radius"][e]
    radius = jnp.where(radius > 0.0, radius, jnp.float32(200.0))
    sortable = world["sortable"][e]
    mn, mx = world["aabb_min"], world["aabb_max"]
    caster = (world.alive & (world["model_id"] >= 0)
              & (jnp.arange(cap) != e))
    relevant = caster & culling.within_distance(pos, mn, mx, radius)

    is_spot = sortable == R.SORTABLE_SPOT
    is_point = sortable == R.SORTABLE_POINT
    direction = world["light_direction"][e]
    direction = direction / jnp.maximum(jnp.linalg.norm(direction), 1e-6)
    cos_outer = world["light_cutoff"][e][1]
    center = 0.5 * (mn + mx)
    to_c = center - pos[None]
    dist = jnp.maximum(jnp.linalg.norm(to_c, axis=-1), 1e-6)
    in_cone = jnp.sum(to_c * direction[None], axis=-1) / dist >= cos_outer
    relevant = relevant & jnp.where(is_spot & (cos_outer > 1e-3),
                                    in_cone, True)
    relevant = relevant & ~is_point

    from render_engine_tpu.math import transforms as T_

    in_vol = culling.aabb_in_frustum(T_.frustum_planes(proj_view), mn, mx)
    return jnp.sum((relevant & ~in_vol).astype(jnp.int32))


# ---------------------------------------------------------------------------
# scheduling: <=1 new map per frame, visible lights first, evict the departed
# ---------------------------------------------------------------------------
def choose_light(shadow: ShadowState, world: World,
                 camera_position: jnp.ndarray,
                 neighborhood: float = 800.0):
    """Pick (slot, light_entity, any) for this frame's single map render.

    Priority (find_next_light_to_have_shadow_map, shadow_flow.rs:364-447):
    nearby shadow-casting lights without a current slot, else refresh the
    round-robin slot."""
    is_light = world.alive & (world["sortable"] != R.SORTABLE_DEFAULT)
    near = (
        jnp.sum((world["position"] - camera_position[None]) ** 2, axis=-1)
        <= neighborhood * neighborhood
    )
    candidate = is_light & near

    # slots each candidate already owns (point lights need 6 cube faces,
    # one rendered per frame; others need 1)
    cap = world.capacity
    owned_count = jnp.zeros(cap, jnp.int32)
    for s in range(shadow.slot_entity.shape[0]):
        ent = shadow.slot_entity[s]
        owned_count = owned_count + (
            (jnp.arange(cap) == ent) & (ent >= 0)
        ).astype(jnp.int32)
    needed = jnp.where(world["sortable"] == R.SORTABLE_POINT, 6, 1)
    unmapped = candidate & (owned_count < needed)

    any_unmapped = jnp.any(unmapped)
    pick_new = jnp.argmax(unmapped)  # first unmapped nearby light
    pick_face = owned_count[pick_new]  # next cube face for point lights

    # eviction: slots whose light left the neighborhood free up
    budget = shadow.slot_entity.shape[0]
    slot_ent = shadow.slot_entity
    slot_ok = jnp.zeros(budget, bool)
    for s in range(budget):
        ent = jnp.clip(slot_ent[s], 0, cap - 1)
        alive_near = candidate[ent] & (slot_ent[s] >= 0)
        slot_ok = slot_ok.at[s].set(alive_near)
    slot_ent = jnp.where(slot_ok, slot_ent, -1)

    free = slot_ent < 0
    any_free = jnp.any(free)
    first_free = jnp.argmax(free)
    rr_slot = shadow.cursor % budget
    slot = jnp.where(any_unmapped & any_free, first_free, rr_slot)
    light = jnp.where(
        any_unmapped & any_free,
        pick_new,
        jnp.clip(slot_ent[rr_slot], 0, cap - 1),
    )
    face = jnp.where(any_unmapped & any_free, pick_face,
                     shadow.slot_face[rr_slot])
    do_render = (any_unmapped & any_free) | (slot_ent[rr_slot] >= 0)
    shadow = dataclasses.replace(
        shadow, slot_entity=slot_ent, cursor=shadow.cursor + 1
    )
    return shadow, slot, light, face, do_render


def render_shadow_map(
    shadow: ShadowState,
    world: World,
    camera,
    bank,
    *,
    max_tris: int = 16384,
    raster_cfg: RasterConfig | None = None,
    interval: int = 1,
    lov_bias: int = 0,
    caster_mask=None,
) -> ShadowState:
    """One frame's shadow update: choose a light, depth-raster its view into
    its slot (the shadow render system, render_flow.rs:267-308,1111-1178).

    ``caster_mask``: optional user control over what casts shadows — a
    bool[CAP] mask or a trace-time callable ``fn(world) -> bool[CAP]``
    (the shadow render system's user draw fns, load_models.rs shadow draw
    registration: the reference lets users decide what the shadow pass
    draws). None = every model-bearing entity casts.

    ``interval``: render a new map every N-th frame instead of every frame.
    The reference's budget is AT MOST one new map per frame
    (shadow_flow.rs:111-133) — with every slot mapped it refreshes each
    light round-robin, so maps are always schedule-stale; a larger interval
    stretches that staleness (demo: each of 2 lights refreshes every
    2*interval frames) and halves the per-frame shadow cost. Skipped frames
    run only the tick increment (lax.cond — the whole batch build + raster
    is in the untaken branch). Deterministic: the schedule is a pure
    function of (state, tick)."""
    if interval > 1:
        bumped = dataclasses.replace(shadow, tick=shadow.tick + 1)
        return jax.lax.cond(
            shadow.tick % interval == 0,
            lambda: _render_shadow_map_now(
                bumped, world, camera, bank, max_tris=max_tris,
                raster_cfg=raster_cfg, lov_bias=lov_bias,
                caster_mask=caster_mask),
            lambda: bumped,
        )
    return _render_shadow_map_now(
        dataclasses.replace(shadow, tick=shadow.tick + 1), world, camera,
        bank, max_tris=max_tris, raster_cfg=raster_cfg, lov_bias=lov_bias,
        caster_mask=caster_mask)


def shadow_raster_cfg(max_tris: int) -> RasterConfig:
    """Default raster config of the shadow depth pass — shared with the
    engine's drop diagnostics so the counted binning budgets are exactly
    the ones the pass runs with. tile_budget 160: with exact culling
    delivering the full caster set, the demo's second star still dropped
    142 candidates at 64-96 and ~12 at 128 (sized per window and per
    light, debug_logs/diag_budgets.py); the shadow raster runs only every
    `interval`-th frame, so the wider table is cheap."""
    return RasterConfig(tile_budget=160, global_budget=16,
                        pair_budget=4 * max_tris)


def _render_shadow_map_now(
    shadow: ShadowState,
    world: World,
    camera,
    bank,
    *,
    max_tris: int,
    raster_cfg: RasterConfig | None = None,
    lov_bias: int = 0,
    caster_mask=None,
) -> ShadowState:
    cfg = raster_cfg or shadow_raster_cfg(max_tris)
    res = shadow.resolution
    # depth raster through the platform switch: the same compiled tile
    # kernel as the frame on the GPU, the jnp golden path on the CPU
    from render_engine_tpu.render.frame import pick_rasterizer

    rasterizer = pick_rasterizer("auto")
    shadow, slot, light, face, do_render = choose_light(
        shadow, world, camera.position
    )
    pv = light_proj_view(world, light, face=face)

    # the shadow pass's own (coarser) LoV — shadow_render_system_lov
    # semantics (render_thread.rs:97-104): silhouettes at 1024^2 don't
    # need full-detail geometry, and the light frustum usually covers far
    # more instances than the camera's
    if callable(caster_mask):
        caster_mask = caster_mask(world)
    batch = build_triangle_batch(
        world, bank, camera, max_tris=max_tris,
        apply_lov=True, proj_view=pv, depth_only=True, lov_bias=lov_bias,
        instance_mask=caster_mask,
    )
    batch = to_screen(batch, res, res)
    depth, _ = rasterizer(batch, res, res, cfg)

    new_maps = shadow.maps.at[slot].set(
        jnp.where(do_render, depth, shadow.maps[slot])
    )
    new_pcf = shadow.maps_pcf.at[slot].set(
        jnp.where(do_render, neighborhood_stack(depth),
                  shadow.maps_pcf[slot])
    )
    new_mats = shadow.light_mats.at[slot].set(
        jnp.where(do_render, pv, shadow.light_mats[slot])
    )
    new_ents = shadow.slot_entity.at[slot].set(
        jnp.where(do_render, light.astype(jnp.int32), shadow.slot_entity[slot])
    )
    new_faces = shadow.slot_face.at[slot].set(
        jnp.where(do_render, face.astype(jnp.int32), shadow.slot_face[slot])
    )
    return dataclasses.replace(
        shadow, maps=new_maps, maps_pcf=new_pcf, light_mats=new_mats,
        slot_entity=new_ents, slot_face=new_faces,
    )


# ---------------------------------------------------------------------------
# PCF lookup for the lighting pass
# ---------------------------------------------------------------------------
def pcf_factor(shadow: ShadowState, slot: jnp.ndarray,
               world_pos: jnp.ndarray) -> jnp.ndarray:
    """3x3 PCF shadow term in [0,1] for pixels (H, W, 3) against one slot's
    map (second_pass_frag.glsl:141-207). Outside the light frustum -> lit
    (the border-clamp reasoning in the GLSL).

    ONE row gather from the precomputed (R*R, 9) neighborhood stack per
    pixel — the 9 taps arrive as one contiguous 36-byte row."""
    res = shadow.resolution
    mat = shadow.light_mats[slot]
    homo = jnp.concatenate(
        [world_pos, jnp.ones(world_pos.shape[:-1] + (1,), jnp.float32)],
        axis=-1,
    )
    clip = jnp.einsum("ij,...j->...i", mat, homo, precision=T.MM_PRECISION)
    w = clip[..., 3:4]
    ndc = clip[..., :3] / jnp.where(jnp.abs(w) > 1e-9, w, 1.0)
    # the shadow raster samples pixel centers at +0.5, so texel i covers
    # [i, i+1): map ndc to continuous pixel coords and offset by -0.5 so
    # round() lands on the covering texel (no half-texel skew)
    u = (ndc[..., 0] * 0.5 + 0.5) * res - 0.5
    v = (0.5 - ndc[..., 1] * 0.5) * res - 0.5
    z = ndc[..., 2]
    inside = (
        (jnp.abs(ndc[..., 0]) <= 1.0)
        & (jnp.abs(ndc[..., 1]) <= 1.0)
        & (z <= 1.0)
        & (w[..., 0] > 0.0)
    )

    ui = jnp.clip(jnp.round(u).astype(jnp.int32), 0, res - 1)
    vi = jnp.clip(jnp.round(v).astype(jnp.int32), 0, res - 1)
    taps = shadow.maps_pcf[slot][vi * res + ui]  # one aligned row gather
    lit = jnp.mean(
        ((z - PCF_BIAS)[..., None] <= taps[..., :9]).astype(jnp.float32),
        axis=-1,
    )
    return jnp.where(inside, lit, 1.0)[..., None]


def pcf_factor_from_clip(shadow: ShadowState, slot: int, cx, cy, cz, cw):
    """PCF term from LIGHT-CLIP coordinates (..., broadcastable) — the
    fused path's fast entry. The camera unprojection cancels projectively:
    with m = light_mat @ inv_proj_view, light NDC = normalize(m @ ndc_cam)
    because the intermediate world w divides out (and keeps its sign for
    visible pixels, whose camera-unproject w is positive). Callers
    transform camera NDC by the COMPOSED m (full f32, the bf16 pitfall)
    and never materialize world positions — ~10 fewer ops per shadow slot
    per frame than pcf_factor. Tap selection/bias math is identical to
    pcf_factor, so factors agree up to FP reassociation at exact texel
    boundaries."""
    res = shadow.resolution
    inv = 1.0 / jnp.where(jnp.abs(cw) > 1e-9, cw, 1.0)
    nx, ny, z = cx * inv, cy * inv, cz * inv
    u = (nx * 0.5 + 0.5) * res - 0.5
    v = (0.5 - ny * 0.5) * res - 0.5
    inside = ((jnp.abs(nx) <= 1.0) & (jnp.abs(ny) <= 1.0)
              & (z <= 1.0) & (cw > 0.0))
    ui = jnp.clip(jnp.round(u).astype(jnp.int32), 0, res - 1)
    vi = jnp.clip(jnp.round(v).astype(jnp.int32), 0, res - 1)
    taps = shadow.maps_pcf[slot][vi * res + ui]
    lit = jnp.mean(
        ((z - PCF_BIAS)[..., None] <= taps[..., :9]).astype(jnp.float32),
        axis=-1,
    )
    return jnp.where(inside, lit, 1.0)


def slot_factors(shadow: ShadowState, world_pos: jnp.ndarray) -> jnp.ndarray:
    """(BUDGET, *spatial) PCF factors of every slot at the given world
    positions (..., h, w, 3). Inactive slots (no owning light) skip their
    gather entirely via lax.cond and return all-lit. With
    ``shadow.pcf_scale`` > 1, factors compute on a strided pixel subset and
    nearest-upsample back."""
    budget = shadow.slot_entity.shape[0]
    k = shadow.pcf_scale
    wp = world_pos
    if k > 1:
        wp = world_pos[..., ::k, ::k, :]
    ones = jnp.ones(wp.shape[:-1], jnp.float32)
    outs = []
    for s in range(budget):
        outs.append(jax.lax.cond(
            shadow.slot_entity[s] >= 0,
            lambda s=s: pcf_factor(shadow, s, wp)[..., 0],
            lambda: ones,
        ))
    f = jnp.stack(outs)
    if k > 1:
        f = jnp.repeat(jnp.repeat(f, k, axis=-2), k, axis=-1)
        want = world_pos.shape[:-1]
        f = f[..., :want[-2], :want[-1]]
    return f


def make_shadow_factor(shadow: ShadowState, world: World, lights_entity_map):
    """Build the shadow_factor callback for lighting.shade.

    ``lights_entity_map``: dict kind -> (N,) entity indices as uploaded into
    the LightArrays (so slot lookup matches light identity). The per-slot
    factor images are computed ONCE per world_pos array (not per light) and
    cached across the shade loops."""
    budget = shadow.slot_entity.shape[0]
    cache: dict = {}

    def factor(kind: str, i: int, world_pos):
        ents = lights_entity_map.get(kind)
        if ents is None:
            return 1.0
        key = id(world_pos)
        if key not in cache:
            cache[key] = slot_factors(shadow, world_pos)
        slots = cache[key]
        ent = ents[i]
        out = jnp.ones(world_pos.shape[:-1] + (1,), jnp.float32)
        for s in range(budget):
            hit = (shadow.slot_entity[s] == ent) & (ent >= 0)
            term = slots[s][..., None]
            # multiplicative combine: a light owning several slots (cube
            # faces) shadows a pixel if ANY covering face says shadowed;
            # faces whose frustum misses the pixel return 1 (neutral)
            out = jnp.where(hit, out * term, out)
        return out

    return factor
