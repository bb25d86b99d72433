"""Kinematics integration + transform/AABB refresh.

Vectorized port of the reference's semantics in update_positions
(src/flows/logic_flow.rs:308-448): v += a*dt, p += v*dt; angular velocity +=
angular acceleration*dt, orientation advances by the angular velocity —
generating HasMoved/HasRotated markers. The per-entity change requests and
per-section rayon chunking dissolve into masked array ops.

Transform/AABB refresh mirrors the reference's batched end-of-frame pass
(entity_change_helpers.rs:217-323: collect dirty entities, recompute
TransformationMatrix and tree AABB once), including the translation-only fast
path (matrix column-3 patch) — which here is simply that the full TRS
recompute is already one fused op, so no special case is needed.
"""

from __future__ import annotations

import jax.numpy as jnp

from render_engine_tpu.ecs import registry as R
from render_engine_tpu.ecs.world import World
from render_engine_tpu.math import transforms as T


def integrate(world: World, dt, mask) -> tuple[World, jnp.ndarray, jnp.ndarray]:
    """Advance kinematics for entities in ``mask``. Returns
    (world, moved_mask, rotated_mask) and sets HAS_MOVED/HAS_ROTATED flags."""
    dt = jnp.float32(dt)

    # linear ------------------------------------------------------------
    kin = mask & world.has_components("position", "velocity")
    has_acc = world.has_components("acceleration")
    vel = world["velocity"]
    vel = jnp.where((kin & has_acc)[:, None],
                    vel + world["acceleration"] * dt, vel)
    pos = world["position"]
    new_pos = jnp.where(kin[:, None], pos + vel * dt, pos)
    moved = kin & jnp.any(vel != 0.0, axis=-1)

    # angular -----------------------------------------------------------
    rot = mask & world.has_components("orientation", "ang_vel")
    has_aacc = world.has_components("ang_acc")
    ang_vel = world["ang_vel"]
    ang_vel = jnp.where((rot & has_aacc)[:, None],
                        ang_vel + world["ang_acc"] * dt, ang_vel)
    dq = T.quat_from_rotvec(ang_vel * dt)
    quat = world["orientation"]
    new_quat = jnp.where(
        rot[:, None], T.quat_normalize(T.quat_mul(dq, quat)), quat
    )
    rotated = rot & jnp.any(ang_vel != 0.0, axis=-1)

    flags = world["flags"]
    flags = jnp.where(moved, flags | R.FLAG_HAS_MOVED, flags)
    flags = jnp.where(rotated, flags | R.FLAG_HAS_ROTATED, flags)

    world = world.replace(
        position=new_pos, velocity=vel, orientation=new_quat,
        ang_vel=ang_vel, flags=flags,
    )
    return world, moved, rotated


def refresh_transforms(world: World, model_aabb_min, model_aabb_max,
                       dirty) -> World:
    """Recompute world AABBs where ``dirty``.

    ``model_aabb_min/max``: (num_models, 3) object-space AABBs from the model
    bank; entities with model_id < 0 get a unit box at their position
    (the user/camera entity's camera-coupled AABB, pipeline.rs:125-144).

    PERF NOTE: the reference materializes a TransformationMatrix per entity;
    here a (CAP, 4, 4) array would be written and re-read every tick for
    no consumer. TRS therefore composes ON THE FLY wherever needed
    (here via direct quaternion rotation of the 8 AABB corners; in the
    geometry stage per vertex). The ``transform`` component column remains
    for user reads via ``world_transforms`` but is not maintained per frame.
    """
    mid = jnp.clip(world["model_id"], 0, model_aabb_min.shape[0] - 1)
    obj_mn = model_aabb_min[mid]
    obj_mx = model_aabb_max[mid]
    no_model = world["model_id"] < 0
    half = jnp.float32(0.5)
    obj_mn = jnp.where(no_model[:, None], jnp.full(3, -half), obj_mn)
    obj_mx = jnp.where(no_model[:, None], jnp.full(3, half), obj_mx)

    # AABB of the rotated box via |R| columns — exact, and avoids
    # materializing (CAP, 8, 3) corners. For center c, half-extent h, rotation R,
    # scale s: center' = R(s*c) + p;  half' = sum_j |R e_j| * s_j * h_j.
    quat = world["orientation"]
    scale = world["scale"]
    c_obj = 0.5 * (obj_mn + obj_mx)
    h_obj = 0.5 * (obj_mx - obj_mn)
    ex = jnp.array([1.0, 0.0, 0.0], jnp.float32)
    ey = jnp.array([0.0, 1.0, 0.0], jnp.float32)
    ez = jnp.array([0.0, 0.0, 1.0], jnp.float32)
    r0 = jnp.abs(T.quat_rotate(quat, jnp.broadcast_to(ex, scale.shape)))
    r1 = jnp.abs(T.quat_rotate(quat, jnp.broadcast_to(ey, scale.shape)))
    r2 = jnp.abs(T.quat_rotate(quat, jnp.broadcast_to(ez, scale.shape)))
    sh = jnp.abs(scale) * h_obj
    half_w = (r0 * sh[:, 0:1] + r1 * sh[:, 1:2] + r2 * sh[:, 2:3])
    center_w = T.quat_rotate(quat, scale * c_obj) + world["position"]
    w_mn = center_w - half_w
    w_mx = center_w + half_w
    return world.replace(
        aabb_min=jnp.where(dirty[:, None], w_mn, world["aabb_min"]),
        aabb_max=jnp.where(dirty[:, None], w_mx, world["aabb_max"]),
    )


def world_transforms(world: World, indices=None) -> jnp.ndarray:
    """Materialize TRS matrices on demand (the TransformationMatrix read
    path for user logic; not part of the per-frame hot loop)."""
    if indices is None:
        pos, quat, scale = (world["position"], world["orientation"],
                            world["scale"])
    else:
        pos = world["position"][indices]
        quat = world["orientation"][indices]
        scale = world["scale"][indices]
    return T.compose_trs(pos, quat, scale)


def handle_out_of_bounds(world: World, policies_by_type: dict,
                         types) -> tuple[World, jnp.ndarray, jnp.ndarray]:
    """Out-of-bounds handling (logic_flow.rs:271-301 +
    entity_change_helpers.rs:325-351): clamp / mark / delete per type policy.
    Returns (world, kill_mask, oob_mask) — ``oob_mask`` feeds the per-type
    user OutOfBoundsLogic callbacks in the step (logic_components.rs:15-18)."""
    cfg = world.config
    lo = jnp.asarray(cfg.world_min, jnp.float32)
    hi = lo + jnp.float32(cfg.world_length)
    pos = world["position"]
    oob = world.alive & jnp.any((pos < lo) | (pos > hi), axis=-1)

    from render_engine_tpu.logic import types as LT

    clamp_mask = jnp.zeros_like(oob)
    kill_mask = jnp.zeros_like(oob)
    mark_mask = jnp.zeros_like(oob)
    for t in types:
        tm = oob & (world["type_id"] == t.index)
        policy = policies_by_type.get(t.index, t.out_of_bounds)
        if policy == LT.OOB_DELETE:
            kill_mask = kill_mask | tm
        elif policy == LT.OOB_MARK:
            mark_mask = mark_mask | tm
        else:
            clamp_mask = clamp_mask | tm
    # untyped entities clamp
    untyped = oob & (world["type_id"] < 0)
    clamp_mask = clamp_mask | untyped

    new_pos = jnp.where(clamp_mask[:, None], jnp.clip(pos, lo, hi), pos)
    flags = world["flags"]
    flags = jnp.where(mark_mask | kill_mask, flags | R.FLAG_OUT_OF_BOUNDS, flags)
    world = world.replace(position=new_pos, flags=flags)
    return world, kill_mask, oob
