"""Geometry stage: world + model bank -> the frame's screen-space triangles.

Replaces the reference's instance-data sort + glDrawElementsInstanced path
(src/flows/render_flow.rs:603-933 sort_world_section_active_entities /
add_entities, src/exports/rendering.rs:270-386 draw_model_with_sortable_index):
instead of writing per-instance bytes into mapped buffers and issuing draw
calls per (model, sortable) range, we materialize one fixed-budget flat
triangle list for the whole frame:

  1. frustum-cull entities (per-entity AABB test),
  2. pick each entity's level-of-view bank entry by camera distance
     (the ModelId bit-25-31 LoV adjustment, model_definitions.rs:31-49),
  3. expand (entity, model) -> triangles with a cumsum + searchsorted
     "ragged repeat" (static shape, budget ``max_tris``),
  4. transform to clip space (one big batched matmul),
  5. emit screen-space vertices + per-triangle attributes for the raster.

Everything is static-shape; triangles beyond the budget are dropped
(counted, so callers can grow the budget — the same budgeted-conservatism
contract as the reference's fixed buffer sizes,
default_render_system.rs:77-84).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from render_engine_tpu.ecs import registry as R
from render_engine_tpu.ecs.world import World
from render_engine_tpu.math import transforms as T
from render_engine_tpu.models.bank import ModelBank
from render_engine_tpu.world import culling


@partial(
    jax.tree_util.register_dataclass,
    data_fields=[
        "xy", "z", "inv_w", "world_pos", "normal", "uv",
        "material", "entity", "valid", "transparent", "total_requested",
    ],
    meta_fields=[],
)
@dataclasses.dataclass(frozen=True)
class TriangleBatch:
    """The frame's triangles in screen space (budgeted to T rows)."""

    xy: jnp.ndarray  # (T, 3, 2) pixel coords (x right, y down)
    z: jnp.ndarray  # (T, 3) NDC depth in [-1, 1]
    inv_w: jnp.ndarray  # (T, 3) 1/clip_w for perspective correction
    world_pos: jnp.ndarray  # (T, 3, 3)
    normal: jnp.ndarray  # (T, 3, 3) world-space, unnormalized per-vertex
    uv: jnp.ndarray  # (T, 3, 2)
    material: jnp.ndarray  # (T,) int32
    entity: jnp.ndarray  # (T,) int32 source entity
    valid: jnp.ndarray  # (T,) bool
    transparent: jnp.ndarray  # (T,) bool — forward-pass triangles
    total_requested: jnp.ndarray  # scalar int32: pre-budget triangle count

    @property
    def budget(self) -> int:
        return self.xy.shape[0]


def build_triangle_batch(
    world: World,
    bank: ModelBank,
    camera,
    *,
    max_tris: int,
    instance_mask: jnp.ndarray | None = None,
    apply_lov: bool = True,
    proj_view: jnp.ndarray | None = None,
    systems=None,
    depth_only: bool = False,
    lov_bias: int = 0,
) -> TriangleBatch:
    """Cull, LoV-select, and expand instances into screen triangles.

    ``instance_mask`` restricts which entities are considered (e.g. a shadow
    pass over one light's neighborhood); default = all alive.
    ``proj_view`` overrides the camera matrix (light cameras for shadows).
    ``systems``: an optional render_system.CompiledSystems — entities whose
    model is bound to no system are not drawn, LoV is gated per system, and
    alpha_scale uniforms route triangles to the transparency pass (the
    per-render-system draw routing of render_flow.rs:317-334, as data).
    ``depth_only``: skip normals/uvs/materials/transparency — the shadow
    raster only consumes positions (the reference's depth-only shadow
    shader, render_flow.rs:267-308); the skipped gathers + the slimmer
    near-clip save ~1 ms/frame at the shadow pass's budget.
    """
    cap = world.capacity
    pv = camera.proj_view() if proj_view is None else proj_view
    planes = T.frustum_planes(pv)

    vis = world.alive & (world["model_id"] >= 0)
    if instance_mask is not None:
        vis = vis & instance_mask
    msys = None
    if systems is not None:
        nm = systems.model_system.shape[0]
        msys = systems.model_system[
            jnp.clip(world["model_id"], 0, nm - 1)
        ]
        vis = vis & (msys >= 0)
    vis = vis & culling.aabb_in_frustum(
        planes, world["aabb_min"], world["aabb_max"]
    )

    # level-of-view selection by camera distance (entity-center distance —
    # the reference used section-center distance, render_flow.rs:872-933)
    mid = world["model_id"]
    if apply_lov:
        dist = jnp.linalg.norm(
            world["position"] - camera.position[None], axis=-1
        )
        lov_mid = bank.lov_model_id(mid, dist, camera.draw_distance,
                                    band_bias=lov_bias)
        if msys is None:
            mid = lov_mid
        else:  # per-system casts_lov gate
            ns = systems.sys_lov.shape[0]
            lov_on = systems.sys_lov[jnp.clip(msys, 0, ns - 1)] > 0.5
            mid = jnp.where(lov_on & (msys >= 0), lov_mid, mid)
    mid_safe = jnp.clip(mid, 0, bank.num_models - 1)

    # ragged expansion: entity -> its triangle rows. The row->entity map is
    # a scatter + cumsum instead of searchsorted (XLA lowers vectorized
    # binary search to a sequential WHILE loop — measured ~2.6 ms/frame):
    # scatter +1 at each visible entity's start offset, cumsum, subtract 1.
    # Entities with zero triangles share a start with their successor; the
    # accumulated bumps skip them correctly.
    counts = jnp.where(vis, bank.tri_count[mid_safe], 0)
    offsets = jnp.cumsum(counts)  # inclusive
    starts = offsets - counts
    total = offsets[cap - 1] if cap > 0 else jnp.int32(0)

    t_ids = jnp.arange(max_tris, dtype=jnp.int32)
    bump_at = jnp.where(vis & (starts < max_tris), starts, max_tris)
    bumps = jnp.zeros(max_tris, jnp.int32).at[bump_at].add(1, mode="drop")
    rank = jnp.cumsum(bumps) - 1  # visible-entity rank owning each row
    # rank -> entity id (ranks follow entity-index order)
    vis_rank = jnp.cumsum(vis.astype(jnp.int32)) - 1
    ent_of_rank = jnp.zeros(cap, jnp.int32).at[
        jnp.where(vis, vis_rank, cap)
    ].set(jnp.arange(cap, dtype=jnp.int32), mode="drop")
    ent = ent_of_rank[jnp.clip(rank, 0, cap - 1)]
    valid = t_ids < total

    # per-ENTITY attributes as ONE packed f32 row gather (quat 4 | scale 3 |
    # pos 3 | flags | tri start | lov tri offset): separate gathers cost 3
    # f32 row gathers + 3 scalar-memory int gathers (S(1) layouts, ~5x) per
    # batch. f32 exactness: flag bits and bank offsets are < 2^24 by
    # construction, and a START value is only ever CONSUMED for rows whose
    # entity expanded within the budget (bump_at keeps starts >= max_tris
    # out of rank), so consumed starts are < max_tris < 2^24 — huge
    # pre-budget cumsum values may round in the table but are never read.
    ent_table = jnp.concatenate(
        [
            world["orientation"], world["scale"], world["position"],
            world["flags"].astype(jnp.float32)[:, None],
            starts.astype(jnp.float32)[:, None],
            bank.tri_offset[mid_safe].astype(jnp.float32)[:, None],
        ],
        axis=1,
    )  # (CAP, 13)
    erow = ent_table[ent]  # (T, 13)
    quat = erow[:, 0:4]
    scale = erow[:, 4:7]
    pos_e = erow[:, 7:10]
    ent_flags = erow[:, 10].astype(jnp.int32)
    tri_within = t_ids - erow[:, 11].astype(jnp.int32)
    tri_idx = erow[:, 12].astype(jnp.int32) + tri_within
    tri_idx = jnp.clip(tri_idx, 0, bank.num_triangles - 1)

    # gather model-space geometry (vertex ids + material ride one packed
    # f32 row instead of separate int-typed gathers)
    trow = bank.tri_packed[tri_idx]  # (T, 5): v0 v1 v2 material transp
    tv = trow[:, 0:3].astype(jnp.int32)
    if depth_only:
        # shadow pass reads positions only — keep the narrow table
        v_obj = bank.vertices[tv]  # (T, 3, 3)
    else:
        # pos|normal|uv ride ONE packed row: a third of the gather rows
        # of the three separate same-index gathers (rows are what row
        # gathers pay for, not bytes — see docs/STATUS.md perf ledger)
        vrow = bank.vert_packed[tv]  # (T, 3, 8)
        v_obj = vrow[..., 0:3]

    # object -> world (per-entity TRS, composed on the fly — (T,4,4)
    # matrices are never materialized, see kinematics.refresh_transforms)
    w_pos = (
        T.quat_rotate(quat[:, None, :], v_obj * scale[:, None, :])
        + pos_e[:, None, :]
    )  # (T, 3, 3)

    if depth_only:
        t = max_tris
        n_obj = uv = None
        material = jnp.zeros(t, jnp.int32)
        w_nrm = jnp.zeros((t, 3, 3), jnp.float32)
        uv = jnp.zeros((t, 3, 2), jnp.float32)
        transparent = jnp.zeros(t, bool)
    else:
        n_obj = vrow[..., 3:6]
        uv = vrow[..., 6:8]
        material = trow[:, 3].astype(jnp.int32)
        # normal transform for TRS: n' = R @ (n / scale) (inverse-transpose
        # of R S without a matrix inverse)
        safe_scale = jnp.where(jnp.abs(scale) > 1e-12, scale, 1.0)
        w_nrm = T.quat_rotate(quat[:, None, :],
                              n_obj / safe_scale[:, None, :])

    # world -> clip -------------------------------------------------------
    ones = jnp.ones(w_pos.shape[:-1] + (1,), jnp.float32)
    homo = jnp.concatenate([w_pos, ones], axis=-1)  # (T, 3, 4)
    clip = jnp.einsum("ij,tnj->tni", pv, homo,
                      precision=T.MM_PRECISION)  # (T, 3, 4)

    if not depth_only:
        # transparency routing: material alpha < 1 or a dissolve map (per-
        # pixel alpha, fifth texture pair — any mapped pixel may dissolve,
        # so the whole triangle takes the forward pass) — both STATIC per
        # material, so they ride tri_packed column 4 (no per-batch
        # mat_alpha / mat_texture_diss gathers: those land in scalar
        # memory, ~0.17 ms each on the device trace) — plus entity
        # FLAG_TRANSPARENT and render-system alpha_scale uniforms below 1
        # (ent_flags rides the packed entity row gathered above)
        transparent = (trow[:, 4] > 0.5) | (
            (ent_flags & R.FLAG_TRANSPARENT) != 0
        )
        if msys is not None:
            ns = systems.sys_table.shape[0]
            ascale = systems.sys_table[jnp.clip(msys, 0, ns - 1), 5]
            transparent = transparent | (
                (ascale[ent] < 1.0) & (msys[ent] >= 0))

    # near-plane clipping: triangles crossing z_clip = -w are re-cut
    # (vectorized; second triangles from quad cases reuse unused budget
    # rows — see _near_clip)
    (clip, w_pos, w_nrm, uv, material, ent, transparent,
     valid) = _near_clip(
        clip, w_pos, w_nrm, uv, material, ent, transparent, valid,
        depth_only=depth_only,
    )

    w = clip[..., 3]
    valid = valid & jnp.all(w > 1e-6, axis=-1)
    inv_w = 1.0 / jnp.where(jnp.abs(w) > 1e-9, w, 1.0)
    ndc = clip[..., :3] * inv_w[..., None]  # (T, 3, 3)

    # viewport transform (y down, pixel centers at integer + 0.5)
    width = jnp.float32(0.0)  # placeholder replaced below by caller dims
    del width
    xy_ndc = ndc[..., :2]
    z = ndc[..., 2]
    valid = valid & jnp.all(jnp.isfinite(xy_ndc), axis=(-2, -1))

    return TriangleBatch(
        xy=xy_ndc,  # NDC here; to_screen() converts once dims are known
        z=z,
        inv_w=inv_w,
        world_pos=w_pos,
        normal=w_nrm,
        uv=uv,
        material=material,
        entity=ent,
        valid=valid,
        transparent=transparent,
        total_requested=total,
    )


def _near_clip(clip, w_pos, w_nrm, uv, material, ent, transparent, valid,
               depth_only: bool = False):
    """Vectorized near-plane clipping (the GL clipper's z_clip >= -w case).

    Per triangle, classify vertices by signed distance s = z_clip + w:
      * 3 inside: unchanged.
      * 1 outside: the crossing produces a quad; the first sub-triangle
        replaces the row, the second is scattered into an UNUSED budget row
        (valid == False). Quads beyond the free-row supply are dropped —
        the engine's usual budgeted conservatism.
      * 2 outside: the single clipped triangle replaces the row.
      * 0 inside: dropped.

    Attributes interpolate with the clip-space parameter t, which equals
    the world-space edge parameter because clip coords are affine in world
    position.
    """
    # PERF: all per-vertex attributes travel as ONE packed (T, 3, 12) array
    # [clip4 | pos3 | nrm3 | uv2] so the rot/lerp/select/scatter passes are
    # one fused op each instead of four (the separate (T,3,2..4) arrays'
    # scatters cost ~2.7 ms/frame at 24k tris, dominated by per-op overhead
    # and trailing-small-dim padding). Depth-only passes (shadow maps) carry
    # just the clip coords: (T, 3, 4).
    if depth_only:
        big = clip
    else:
        big = jnp.concatenate([clip, w_pos, w_nrm, uv], axis=-1)
    nch = big.shape[-1]

    s = clip[..., 2] + clip[..., 3]  # (T, 3) signed distance to near plane
    inside = s > 0.0
    n_in = jnp.sum(inside.astype(jnp.int32), axis=-1)  # (T,)

    # canonical rotation: bring the "odd vertex out" to position 0
    # (the single outside vertex when n_in == 2; the single inside vertex
    # when n_in == 1). jnp.roll is a cheap shuffle, not a gather.
    odd = jnp.where(
        n_in == 2, jnp.argmin(inside, axis=-1), jnp.argmax(inside, axis=-1)
    )  # (T,)

    def rot(a):
        r1 = jnp.roll(a, -1, axis=1)
        r2 = jnp.roll(a, -2, axis=1)
        o = odd.reshape((-1,) + (1,) * (a.ndim - 1))
        return jnp.where(o == 1, r1, jnp.where(o == 2, r2, a))

    big_r = rot(big)
    s_r = rot(s[..., None])[..., 0]

    eps = 1e-12
    t1 = s_r[:, 0] / jnp.where(
        jnp.abs(s_r[:, 0] - s_r[:, 1]) > eps, s_r[:, 0] - s_r[:, 1], 1.0)
    t2 = s_r[:, 0] / jnp.where(
        jnp.abs(s_r[:, 0] - s_r[:, 2]) > eps, s_r[:, 0] - s_r[:, 2], 1.0)

    # intersections on edges 0-1 and 0-2 (linear in every attribute:
    # clip coords are affine in world position, so one t serves all)
    a_v1 = big_r[:, 0] + t1[:, None] * (big_r[:, 1] - big_r[:, 0])
    a_v2 = big_r[:, 0] + t2[:, None] * (big_r[:, 2] - big_r[:, 0])
    # n_in == 2 (v0 outside): tri A = (a01, v1, v2); tri B = (a01, v2, a02)
    tri_a2 = jnp.stack([a_v1, big_r[:, 1], big_r[:, 2]], axis=1)
    tri_b2 = jnp.stack([a_v1, big_r[:, 2], a_v2], axis=1)
    # n_in == 1 (v0 inside): tri A = (v0, a01, a02)
    tri_a1 = jnp.stack([big_r[:, 0], a_v1, a_v2], axis=1)

    crosses2 = valid & (n_in == 2)  # quad case
    crosses1 = valid & (n_in == 1)
    keep = valid & (n_in == 3)
    new_valid = keep | crosses2 | crosses1

    sel2 = crosses2[:, None, None]
    sel1 = crosses1[:, None, None]
    big_o = jnp.where(sel2, tri_a2, jnp.where(sel1, tri_a1, big_r))

    # scatter the quad second-triangles into unused budget rows
    t_budget = clip.shape[0]
    free = ~valid
    free_rank = jnp.cumsum(free.astype(jnp.int32)) - 1  # rank among free rows
    n_free = free_rank[-1] + 1 if t_budget else jnp.int32(0)
    extra_rank = jnp.cumsum(crosses2.astype(jnp.int32)) - 1
    # destination row for extra e = index of the e-th free row
    dest_ok = crosses2 & (extra_rank < n_free)
    # scatter: for each source row with dest_ok, find its destination.
    # Build the free-slot index list (first T entries; clipped scatter)
    free_slots = jnp.nonzero(free, size=t_budget, fill_value=t_budget)[0]
    dest = jnp.where(
        dest_ok, free_slots[jnp.clip(extra_rank, 0, t_budget - 1)], t_budget
    )  # rows without an extra scatter to t_budget -> dropped

    # scatter flat (T, 3*nch) rows: the (T, 3, nch) layout pads its trailing
    # dims ~10x and its scatter ran ~0.9 ms; a contiguous row scatter stays
    # on the vector path
    flat = 3 * nch
    big_o = big_o.reshape(t_budget, flat).at[dest].set(
        tri_b2.reshape(t_budget, flat), mode="drop"
    ).reshape(t_budget, 3, nch)
    # per-tri metadata rides one (T, 4) f32 row scatter (ids < 2^24: exact)
    meta = jnp.stack(
        [
            material.astype(jnp.float32),
            ent.astype(jnp.float32),
            transparent.astype(jnp.float32),
            dest_ok.astype(jnp.float32),  # validity of the scattered copy
        ],
        axis=-1,
    )
    meta0 = meta.at[:, 3].set(new_valid.astype(jnp.float32))
    meta_o = meta0.at[dest].set(meta, mode="drop")

    if depth_only:
        clip_o, pos_o, nrm_o, uv_o = big_o, w_pos, w_nrm, uv
    else:
        clip_o, pos_o, nrm_o, uv_o = (
            big_o[..., 0:4], big_o[..., 4:7], big_o[..., 7:10],
            big_o[..., 10:12]
        )
    material = meta_o[:, 0].astype(jnp.int32)
    ent = meta_o[:, 1].astype(jnp.int32)
    transparent = meta_o[:, 2] > 0.5
    new_valid = meta_o[:, 3] > 0.5

    return (clip_o, pos_o, nrm_o, uv_o, material, ent, transparent,
            new_valid)


def to_screen(batch: TriangleBatch, width: int, height: int) -> TriangleBatch:
    """Convert NDC xy to pixel coordinates for a target of (height, width)."""
    x = (batch.xy[..., 0] * 0.5 + 0.5) * jnp.float32(width)
    y = (0.5 - batch.xy[..., 1] * 0.5) * jnp.float32(height)
    return dataclasses.replace(batch, xy=jnp.stack([x, y], axis=-1))


def triangle_tangents(batch: TriangleBatch):
    """Per-triangle tangent frame for normal mapping: ``(tangent (T, 3),
    handedness (T,))`` from world-space edges and UV deltas (the standard
    per-face derivation the reference's asset contract implies for its
    NORMAL_INDEX texture role, model_definitions.rs:77-81; the reference
    packs-but-never-samples it, so this engine goes one role
    further). Degenerate UV mappings return a zero tangent — consumers
    keep the geometric normal there."""
    p = batch.world_pos  # (T, 3, 3)
    uv = batch.uv  # (T, 3, 2)
    e1 = p[:, 1] - p[:, 0]
    e2 = p[:, 2] - p[:, 0]
    du1 = uv[:, 1, 0] - uv[:, 0, 0]
    dv1 = uv[:, 1, 1] - uv[:, 0, 1]
    du2 = uv[:, 2, 0] - uv[:, 0, 0]
    dv2 = uv[:, 2, 1] - uv[:, 0, 1]
    det = du1 * dv2 - du2 * dv1
    r = jnp.where(jnp.abs(det) > 1e-12,
                  1.0 / jnp.where(jnp.abs(det) > 1e-12, det, 1.0), 0.0)
    tan = (e1 * dv2[:, None] - e2 * dv1[:, None]) * r[:, None]
    bit = (e2 * du1[:, None] - e1 * du2[:, None]) * r[:, None]
    n_geo = jnp.cross(e1, e2)
    handed = jnp.where(
        jnp.sum(jnp.cross(n_geo, tan) * bit, axis=-1) < 0.0, -1.0, 1.0
    ).astype(jnp.float32)
    return tan, handed


def perturb_normal(n, tan, handed, sample):
    """Tangent-space normal-map application, shape-polymorphic over the
    pixel layout: ``n`` (..., 3) unit interpolated normal, ``tan`` (..., 3)
    per-face tangent (unnormalized; zero = no-op), ``handed`` (...,)
    bitangent handedness, ``sample`` (..., 3) texel in [0, 1]. Returns the
    perturbed unit normal; pixels with a degenerate tangent keep ``n``.
    Shared by the jnp golden path, the tiled XLA path, and the fused
    override block so all paths agree bit-for-bit on the math."""
    t = tan - n * jnp.sum(n * tan, axis=-1, keepdims=True)
    tl = jnp.linalg.norm(t, axis=-1, keepdims=True)
    ok = tl[..., 0] > 1e-8
    t = t / jnp.where(tl > 1e-8, tl, 1.0)
    b = jnp.cross(n, t) * handed[..., None]
    m = sample * 2.0 - 1.0
    p = m[..., 0:1] * t + m[..., 1:2] * b + m[..., 2:3] * n
    pl_ = jnp.linalg.norm(p, axis=-1, keepdims=True)
    p = p / jnp.where(pl_ > 1e-12, pl_, 1.0)
    return jnp.where(ok[..., None], p, n)
