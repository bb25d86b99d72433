"""World-tick tests: kinematics semantics, visibility gating, out-of-bounds,
collisions, per-type logic dispatch, spawns, camera coupling."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from render_engine_tpu.ecs import changes as C
from render_engine_tpu.ecs import registry as R
from render_engine_tpu.ecs import world as W
from render_engine_tpu.logic import collision as COL
from render_engine_tpu.logic import kinematics as K
from render_engine_tpu.logic.step import make_step
from render_engine_tpu.logic.types import (EntityType, InputState, OOB_DELETE,
                                           OOB_MARK)
from render_engine_tpu.math.camera import CameraBuilder
from render_engine_tpu.world import grid as G

UNIT_MODEL_AABB = (
    jnp.full((1, 3), -0.5, jnp.float32),
    jnp.full((1, 3), 0.5, jnp.float32),
)


def base_world(capacity=32, world_len=256.0):
    return W.create_world(
        W.WorldConfig(capacity=capacity, world_length=world_len,
                      section_length=16.0)
    )


def far_camera():
    # camera far away in +z corner looking at origin region, huge logic radius
    return (
        CameraBuilder()
        .with_position(128.0, 128.0, 128.0)
        .with_fov_degrees(90.0)
        .with_near_far(0.1, 1000.0)
        .with_draw_distance(1000.0)
        .build()
    )


class TestKinematics:
    def test_integration_semantics(self):
        """v += a*dt then p += v*dt (semi-implicit Euler, matching
        logic_flow.rs:366-448)."""
        w = base_world()
        w, _ = W.spawn_host(
            w, 1,
            position=np.array([[10.0, 10.0, 10.0]], np.float32),
            velocity=np.array([[1.0, 0.0, 0.0]], np.float32),
            acceleration=np.array([[0.0, 2.0, 0.0]], np.float32),
        )
        mask = jnp.asarray(w.alive)
        w2, moved, _ = K.integrate(w, 0.5, mask)
        np.testing.assert_allclose(w2["velocity"][0], [1.0, 1.0, 0.0])
        np.testing.assert_allclose(w2["position"][0], [10.5, 10.5, 10.0])
        assert bool(moved[0])
        assert bool(w2.flag_set(R.FLAG_HAS_MOVED)[0])

    def test_rotation_integration(self):
        w = base_world()
        w, _ = W.spawn_host(
            w, 1,
            position=np.zeros((1, 3), np.float32),
            orientation=np.array([[1.0, 0, 0, 0]], np.float32),
            ang_vel=np.array([[0.0, np.pi, 0.0]], np.float32),
        )
        w2, _, rotated = K.integrate(w, 0.5, jnp.asarray(w.alive))
        assert bool(rotated[0])
        from render_engine_tpu.math import transforms as T
        v = T.quat_rotate(w2["orientation"][0], jnp.array([1.0, 0.0, 0.0]))
        # rotated by pi/2 about +y: +x -> -z
        np.testing.assert_allclose(v, [0.0, 0.0, -1.0], atol=1e-5)

    def test_masked_entities_do_not_move(self):
        w = base_world()
        w, _ = W.spawn_host(
            w, 2,
            position=np.zeros((2, 3), np.float32),
            velocity=np.ones((2, 3), np.float32),
        )
        mask = jnp.zeros(32, bool).at[0].set(True)
        w2, moved, _ = K.integrate(w, 1.0, mask)
        assert bool(moved[0]) and not bool(moved[1])
        np.testing.assert_allclose(w2["position"][1], [0, 0, 0])

    def test_refresh_transforms_updates_aabb(self):
        w = base_world()
        w, _ = W.spawn_host(
            w, 1,
            position=np.array([[5.0, 6.0, 7.0]], np.float32),
            scale=np.array([[2.0, 2.0, 2.0]], np.float32),
            model_id=np.array([0], np.int32),
        )
        dirty = jnp.asarray(w.alive)
        w2 = K.refresh_transforms(w, *UNIT_MODEL_AABB, dirty)
        np.testing.assert_allclose(w2["aabb_min"][0], [4.0, 5.0, 6.0])
        np.testing.assert_allclose(w2["aabb_max"][0], [6.0, 7.0, 8.0])
        # TRS matrices materialize on demand only — check the read path
        m = K.world_transforms(w2, np.array([0]))
        np.testing.assert_allclose(m[0, :3, 3], [5.0, 6.0, 7.0])


class TestOutOfBounds:
    def test_clamp_and_delete_policies(self):
        w = base_world(world_len=64.0)
        w, _ = W.spawn_host(
            w, 3,
            position=np.array(
                [[70.0, 1, 1], [-3.0, 1, 1], [5.0, 5, 5]], np.float32),
            type_id=np.array([0, 1, 0], np.int32),
        )
        types = (
            EntityType("clampy", 0),
            EntityType("delety", 1, out_of_bounds=OOB_DELETE),
        )
        w2, kill, oob = K.handle_out_of_bounds(w, {}, types)
        np.testing.assert_allclose(w2["position"][0], [64.0, 1, 1])
        assert bool(kill[1])
        assert not bool(kill[0]) and not bool(kill[2])
        assert bool(oob[0]) and bool(oob[1]) and not bool(oob[2])

    def test_user_oob_callback_mark_then_custom(self):
        """The reference's OutOfBoundsLogic flow (logic_components.rs:15-18
        via entity_change_helpers.rs:325-351): the policy marks the entity,
        then the user's per-type callback handles it — here a wrap-around
        teleport to the far side of the world, with the other type's
        entities untouched."""
        def wrap(world, mask, cs):
            lo = jnp.asarray(world.config.world_min, jnp.float32)
            hi = lo + jnp.float32(world.config.world_length)
            span = hi - lo
            wrapped = lo + jnp.mod(world["position"] - lo, span)
            return C.with_update(cs, "position", wrapped, mask)

        w = base_world(world_len=64.0)
        w, _ = W.spawn_host(
            w, 3,
            position=np.array(
                [[70.0, 1, 1], [70.0, 2, 2], [5.0, 5, 5]], np.float32),
            velocity=np.array(
                [[1.0, 0, 0], [1.0, 0, 0], [0.0, 0, 0]], np.float32),
            type_id=np.array([0, 1, 0], np.int32),
            model_id=np.zeros(3, np.int32),
        )
        w = K.refresh_transforms(w, *UNIT_MODEL_AABB, jnp.asarray(w.alive))
        types = (
            EntityType("wrappy", 0, out_of_bounds=OOB_MARK,
                       out_of_bounds_logic=wrap),
            EntityType("clampy", 1),
        )
        step = jax.jit(make_step(types, logic_radius=1e6))
        cam = far_camera().with_position(jnp.array([64.0, 1.0, 1.0]))
        w2, _ = step(w, cam, InputState.idle(), 0.1, *UNIT_MODEL_AABB)
        # type 0 at x=70.1 after integration: marked, then wrapped to 6.1
        assert bool(w2.flag_set(R.FLAG_OUT_OF_BOUNDS)[0])
        np.testing.assert_allclose(np.asarray(w2["position"][0]),
                                   [70.1 - 64.0, 1, 1], atol=1e-5)
        # type 1 has no callback: default clamp policy, no marker
        np.testing.assert_allclose(np.asarray(w2["position"][1]),
                                   [64.0, 2, 2], atol=1e-5)
        assert not bool(w2.flag_set(R.FLAG_OUT_OF_BOUNDS)[1])
        # in-bounds entity of the callback type is untouched
        np.testing.assert_allclose(np.asarray(w2["position"][2]), [5, 5, 5])


class TestCollisions:
    def _collide_world(self):
        w = base_world()
        pos = np.array(
            [[10.0, 10, 10], [10.4, 10, 10], [100.0, 100, 100]], np.float32)
        w, _ = W.spawn_host(
            w, 3, position=pos,
            type_id=np.array([0, 1, 1], np.int32),
            flags=np.full(3, int(R.FLAG_COLLIDABLE), np.uint32),
        )
        w = w.replace(aabb_min=w["position"] - 0.5, aabb_max=w["position"] + 0.5)
        return w

    def test_find_collisions(self):
        w = self._collide_world()
        g = G.build_grid(w)
        qmask = jnp.asarray(w.alive)
        res = COL.find_collisions(w, g, jnp.array([10.0, 10.0, 10.0]), qmask)
        other_any, has_any = res.first_hit_of_type(w, -1)
        hits = np.asarray(has_any)
        assert hits[0] and hits[1] and not hits[2]
        other, has = res.first_hit_of_type(w, 1)
        assert bool(has[0]) and int(other[0]) == 1
        other0, has0 = res.first_hit_of_type(w, 0)
        assert bool(has0[1]) and int(other0[1]) == 0

    def test_camera_cutoff(self):
        w = self._collide_world()
        g = G.build_grid(w)
        far_cam_pos = jnp.array([500.0, 500.0, 500.0])
        res = COL.find_collisions(w, g, far_cam_pos, jnp.asarray(w.alive))
        _, has = res.first_hit_of_type(w, -1)
        assert not np.asarray(has).any()

    def test_hits_topk_multiple_neighbors(self):
        """Per-pair delivery: an entity overlapping TWO neighbors reports
        both in separate slots (logic_flow.rs:537-655 fires per pair)."""
        w = base_world()
        pos = np.array(
            [[10.0, 10, 10], [10.3, 10, 10], [9.7, 10, 10]], np.float32)
        w, _ = W.spawn_host(
            w, 3, position=pos,
            type_id=np.array([0, 1, 2], np.int32),
            flags=np.full(3, int(R.FLAG_COLLIDABLE), np.uint32),
        )
        w = w.replace(aabb_min=w["position"] - 0.5,
                      aabb_max=w["position"] + 0.5)
        g = G.build_grid(w)
        res = COL.find_collisions(w, g, jnp.array([10.0, 10.0, 10.0]),
                                  jnp.asarray(w.alive))
        others, mask, otypes, dropped = res.hits_topk(w, 4)
        m0 = np.asarray(mask[0])
        o0 = np.asarray(others[0])
        assert m0[0] and m0[1] and not m0[2:].any()
        assert {int(o0[0]), int(o0[1])} == {1, 2}
        assert int(dropped) == 0
        # other_type carries the contact's type id (compacted from the
        # candidate rows — no re-gather); unmasked slots are -1
        t0 = np.asarray(otypes[0])
        types_np = np.asarray(w["type_id"])
        assert t0[0] == types_np[o0[0]] and t0[1] == types_np[o0[1]]
        assert (np.asarray(otypes)[~np.asarray(mask)] == -1).all()
        # all three entities mutually overlap: 6 directed pairs total.
        # k=1 keeps one contact each and counts the 3 dropped pairs.
        _, mask1, _, dropped1 = res.hits_topk(w, 1)
        assert np.asarray(mask1).sum() == 3  # one slot each
        assert int(dropped1) == 3

    def test_large_entity_collides_from_any_side(self):
        """An entity spanning 5 grid cells still collides with small
        entities two cells away on every axis — in BOTH directions (small
        query finds it via the global candidate columns; the large mover
        brute-forces every entity). Reference handles any size via coarser
        tree levels (bounding_box_tree_v2.rs:21-109, 563-678)."""
        w = base_world()  # section_length 16
        center = np.array([128.0, 128, 128], np.float32)
        offsets = np.array([[39.5, 0, 0], [-39.5, 0, 0], [0, 39.5, 0],
                            [0, -39.5, 0], [0, 0, 39.5], [0, 0, -39.5]],
                           np.float32)
        pos = np.concatenate([center[None], center[None] + offsets])
        w, _ = W.spawn_host(
            w, 7, position=pos,
            type_id=np.array([9] + [1] * 6, np.int32),
            flags=np.full(7, int(R.FLAG_COLLIDABLE), np.uint32),
        )
        half = np.full((w.capacity, 1), 0.5, np.float32)
        half[0] = 40.0  # spans [88, 168]: 5 cells of 16
        w = w.replace(aabb_min=w["position"] - half,
                      aabb_max=w["position"] + half)
        g = G.build_grid(w)
        res = COL.find_collisions(w, g, jnp.asarray(center),
                                  jnp.asarray(w.alive))
        # every small entity finds the large one (2 cells away -> the
        # 27-cell window alone would miss it)
        other, has = res.first_hit_of_type(w, 9)
        for i in range(1, 7):
            assert bool(has[i]) and int(other[i]) == 0, f"side {i}"
        # the large mover reports all 6 contacts through its slots
        others, mask, otypes, dropped = res.hits_topk(w, 6)
        assert np.asarray(mask[0]).sum() == 6
        assert set(np.asarray(others[0]).tolist()) == {1, 2, 3, 4, 5, 6}
        # large-mover rows carry types too (brute-force table path)
        assert (np.asarray(otypes[0]) == 1).all()
        assert int(dropped) == 0
        assert int(res.large_dropped) == 0
        # a starved large budget is counted, not silent
        res1 = COL.find_collisions(w, g, jnp.asarray(center),
                                   jnp.asarray(w.alive), large_budget=0)
        assert res1.lquery.shape[0] == 0
        res2 = COL.find_collisions(
            w, g, jnp.asarray(center),
            jnp.asarray(w.alive & (w["type_id"] != 1)), large_budget=0)
        # with the machinery off and only the big entity large, nothing
        # breaks shape-wise (behavioural gap is the documented trade)
        assert res2.hit.shape[1] == res1.hit.shape[1]

    def test_large_budget_overflow_counted(self):
        w = base_world()
        pos = np.array([[100.0, 100, 100], [200.0, 200, 200]], np.float32)
        w, _ = W.spawn_host(
            w, 2, position=pos, type_id=np.zeros(2, np.int32),
            flags=np.full(2, int(R.FLAG_COLLIDABLE), np.uint32),
        )
        w = w.replace(aabb_min=w["position"] - 30.0,
                      aabb_max=w["position"] + 30.0)
        g = G.build_grid(w)
        res = COL.find_collisions(w, g, jnp.array([100.0, 100, 100]),
                                  jnp.asarray(w.alive), large_budget=1)
        assert int(res.large_dropped) == 1

    def test_query_budget_compaction(self):
        """Queries beyond the budget drop (highest indices first);
        within-budget behaviour is unchanged."""
        w = self._collide_world()
        g = G.build_grid(w)
        res = COL.find_collisions(
            w, g, jnp.array([10.0, 10.0, 10.0]), jnp.asarray(w.alive),
            query_budget=1,
        )
        _, has = res.first_hit_of_type(w, -1)
        assert bool(has[0])  # lowest index kept
        assert not bool(has[1])  # dropped by the budget


class TestFullStep:
    def test_step_moves_visible_entities_only(self):
        w = base_world()
        w, _ = W.spawn_host(
            w, 2,
            position=np.array([[100.0, 100, 100], [5.0, 5, 5]], np.float32),
            velocity=np.array([[1.0, 0, 0], [1.0, 0, 0]], np.float32),
            type_id=np.zeros(2, np.int32),
            model_id=np.zeros(2, np.int32),
        )
        w = K.refresh_transforms(w, *UNIT_MODEL_AABB, jnp.asarray(w.alive))
        # camera near entity 0 with a small logic sphere; entity 1 is far
        # away, outside both frustum (looking at +x away from it) and sphere
        cam = (
            CameraBuilder()
            .with_position(90.0, 100.0, 100.0)
            .with_yaw_pitch_degrees(0.0, 0.0)  # looking +x toward entity 0
            .with_near_far(0.1, 50.0)
            .with_draw_distance(50.0)
            .build()
        )
        step = jax.jit(make_step((EntityType("thing", 0),), logic_radius=20.0))
        w2, _ = step(w, cam, InputState.idle(), 0.5, *UNIT_MODEL_AABB)
        np.testing.assert_allclose(w2["position"][0], [100.5, 100, 100])
        np.testing.assert_allclose(w2["position"][1], [5.0, 5, 5])  # gated

    def test_always_execute_logic_overrides_culling(self):
        w = base_world()
        w, _ = W.spawn_host(
            w, 1,
            position=np.array([[5.0, 5, 5]], np.float32),
            velocity=np.array([[2.0, 0, 0]], np.float32),
            type_id=np.zeros(1, np.int32),
            flags=np.array([int(R.FLAG_ALWAYS_LOGIC)], np.uint32),
        )
        w = K.refresh_transforms(w, *UNIT_MODEL_AABB, jnp.asarray(w.alive))
        cam = far_camera().with_position(jnp.array([200.0, 200.0, 200.0]))
        cam = dataclasses.replace(cam, draw_distance=10.0)
        step = jax.jit(make_step((EntityType("thing", 0),), logic_radius=10.0))
        w2, _ = step(w, cam, InputState.idle(), 1.0, *UNIT_MODEL_AABB)
        np.testing.assert_allclose(w2["position"][0], [7.0, 5, 5])

    def test_static_entities_skip_logic(self):
        w = base_world()
        w, _ = W.spawn_host(
            w, 1,
            position=np.array([[5.0, 5, 5]], np.float32),
            velocity=np.array([[2.0, 0, 0]], np.float32),
            type_id=np.zeros(1, np.int32),
            flags=np.array([int(R.FLAG_STATIC)], np.uint32),
        )
        w = K.refresh_transforms(w, *UNIT_MODEL_AABB, jnp.asarray(w.alive))
        step = jax.jit(make_step((EntityType("thing", 0),), logic_radius=1e6))
        w2, _ = step(w, far_camera(), InputState.idle(), 1.0, *UNIT_MODEL_AABB)
        np.testing.assert_allclose(w2["position"][0], [5.0, 5, 5])

    def test_per_type_logic_dispatch(self):
        """Spin logic applied to type 0 only."""
        def spin(world, dt, mask, cs):
            vals = jnp.broadcast_to(
                jnp.array([0.0, 1.0, 0.0]), (world.capacity, 3))
            return C.with_update(cs, "ang_vel", vals, mask)

        w = base_world()
        w, _ = W.spawn_host(
            w, 2,
            position=np.full((2, 3), 5.0, np.float32),
            type_id=np.array([0, 1], np.int32),
        )
        w = K.refresh_transforms(w, *UNIT_MODEL_AABB, jnp.asarray(w.alive))
        step = jax.jit(make_step(
            (EntityType("spinner", 0, logic=spin), EntityType("inert", 1)),
            logic_radius=1e6,
        ))
        w2, _ = step(w, far_camera(), InputState.idle(), 0.1, *UNIT_MODEL_AABB)
        np.testing.assert_allclose(w2["ang_vel"][0], [0, 1, 0])
        np.testing.assert_allclose(w2["ang_vel"][1], [0, 0, 0])

    def test_collision_callback_impulse(self):
        """The demo's wormhole collision: ship gets a velocity impulse
        (reference src/space_logic/solar_system/user.rs:17-50)."""
        def ship_hit(world, other_idx, mask, cs):
            is_wormhole = world["type_id"][other_idx] == 1
            m = mask & is_wormhole
            vals = jnp.broadcast_to(
                jnp.array([0.0, 0.0, 50.0]), (world.capacity, 3))
            return C.with_update(cs, "velocity", vals, m)

        w = base_world()
        w, _ = W.spawn_host(
            w, 2,
            position=np.array([[10.0, 10, 10], [10.2, 10, 10]], np.float32),
            velocity=np.array([[0.5, 0, 0], [0, 0, 0]], np.float32),
            type_id=np.array([0, 1], np.int32),
            model_id=np.zeros(2, np.int32),
            flags=np.array([int(R.FLAG_COLLIDABLE), int(R.FLAG_COLLIDABLE)],
                           np.uint32),
        )
        w = K.refresh_transforms(w, *UNIT_MODEL_AABB, jnp.asarray(w.alive))
        cam = far_camera().with_position(jnp.array([10.0, 10.0, 20.0]))
        step = jax.jit(make_step(
            (EntityType("ship", 0, collision=ship_hit),
             EntityType("wormhole", 1)),
            logic_radius=1e6,
        ))
        w2, _ = step(w, cam, InputState.idle(), 0.1, *UNIT_MODEL_AABB)
        np.testing.assert_allclose(w2["velocity"][0], [0, 0, 50.0])

    def test_per_pair_collision_callbacks(self):
        """One ship overlapping a wormhole AND a mine in the SAME frame
        gets both contacts delivered (per-pair semantics,
        logic_flow.rs:537-655): the wormhole sets velocity, the mine sets
        ang_vel — both must land, regardless of slot order. Two identical
        runs stay bit-identical."""
        def ship_hit(world, other_idx, mask, cs, other_type=None):
            # the engine passes other_type= to callbacks that accept it
            # (compacted from candidate rows); the wormhole filter uses it
            # while the mine filter re-gathers — both paths must agree for
            # BOTH effects below to land
            assert other_type is not None
            worm = mask & (other_type == 1)
            mine = mask & (world["type_id"][other_idx] == 2)
            vel = jnp.broadcast_to(jnp.array([0.0, 0.0, 50.0]),
                                   (world.capacity, 3))
            spin = jnp.broadcast_to(jnp.array([0.0, 9.0, 0.0]),
                                    (world.capacity, 3))
            cs = C.with_update(cs, "velocity", vel, worm)
            return C.with_update(cs, "ang_vel", spin, mine)

        w = base_world()
        w, _ = W.spawn_host(
            w, 3,
            position=np.array([[10.0, 10, 10], [10.2, 10, 10],
                               [9.8, 10, 10]], np.float32),
            velocity=np.array([[0.5, 0, 0], [0, 0, 0], [0, 0, 0]],
                              np.float32),
            type_id=np.array([0, 1, 2], np.int32),
            model_id=np.zeros(3, np.int32),
            flags=np.full(3, int(R.FLAG_COLLIDABLE), np.uint32),
        )
        w = K.refresh_transforms(w, *UNIT_MODEL_AABB, jnp.asarray(w.alive))
        cam = far_camera().with_position(jnp.array([10.0, 10.0, 20.0]))
        step = jax.jit(make_step(
            (EntityType("ship", 0, collision=ship_hit),
             EntityType("wormhole", 1), EntityType("mine", 2)),
            logic_radius=1e6,
        ))
        w2, _ = step(w, cam, InputState.idle(), 0.1, *UNIT_MODEL_AABB)
        np.testing.assert_allclose(w2["velocity"][0], [0, 0, 50.0])
        np.testing.assert_allclose(np.asarray(w2["ang_vel"][0])[1], 9.0)
        # bit-determinism across runs of the same step
        w3, _ = step(w, cam, InputState.idle(), 0.1, *UNIT_MODEL_AABB)
        for name in ("position", "velocity", "ang_vel"):
            np.testing.assert_array_equal(np.asarray(w2[name]),
                                          np.asarray(w3[name]))

    def test_spawn_inside_step(self):
        def emitter(world, dt, mask, cs):
            row = jnp.arange(2) == 0
            return C.queue_spawn(
                cs, world.config.registry, row,
                position=jnp.broadcast_to(jnp.array([1.0, 2.0, 3.0]), (2, 3)),
                type_id=jnp.full(2, 5, jnp.int32),
            )

        w = base_world()
        w, _ = W.spawn_host(w, 1, position=np.full((1, 3), 5.0, np.float32),
                            type_id=np.zeros(1, np.int32))
        w = K.refresh_transforms(w, *UNIT_MODEL_AABB, jnp.asarray(w.alive))
        step = jax.jit(make_step(
            (EntityType("emitter", 0, logic=emitter),),
            logic_radius=1e6, spawn_budget=2,
        ))
        w2, _ = step(w, far_camera(), InputState.idle(), 0.1, *UNIT_MODEL_AABB)
        assert int(w2.count_alive()) == 2
        assert int(jnp.sum(w2.of_type(5))) == 1

    def test_camera_follows_user_entity(self):
        w = base_world()
        w, _ = W.spawn_host(
            w, 1,
            position=np.array([[30.0, 40, 50]], np.float32),
            velocity=np.array([[10.0, 0, 0]], np.float32),
            type_id=np.zeros(1, np.int32),
            flags=np.array([int(R.FLAG_USER) | int(R.FLAG_ALWAYS_LOGIC)],
                           np.uint32),
        )
        w = K.refresh_transforms(w, *UNIT_MODEL_AABB, jnp.asarray(w.alive))
        step = jax.jit(make_step((EntityType("ship", 0),), logic_radius=1e6))
        w2, cam2 = step(w, far_camera(), InputState.idle(), 1.0,
                        *UNIT_MODEL_AABB)
        np.testing.assert_allclose(cam2.position, w2["position"][0])

    def test_determinism_same_inputs_same_bits(self):
        """Bit-determinism: the foundation of record/replay."""
        def jitter(world, dt, mask, rng, cs):
            noise = jax.random.normal(rng, (world.capacity, 3)) * 0.1
            return C.with_update(cs, "velocity",
                                 world["velocity"] + noise, mask)

        w = base_world()
        w, _ = W.spawn_host(
            w, 4,
            position=np.random.default_rng(3).uniform(
                0, 50, (4, 3)).astype(np.float32),
            velocity=np.ones((4, 3), np.float32),
            type_id=np.zeros(4, np.int32),
        )
        w = K.refresh_transforms(w, *UNIT_MODEL_AABB, jnp.asarray(w.alive))
        step = jax.jit(make_step(
            (EntityType("drifter", 0, random_logic=jitter),),
            logic_radius=1e6,
        ))

        def run(world):
            cam = far_camera()
            for i in range(5):
                world, cam = step(world, cam, InputState.idle(seed=i), 0.1,
                                  *UNIT_MODEL_AABB)
            return world

        w_a, w_b = run(w), run(w)
        for k in w_a.comps:
            np.testing.assert_array_equal(
                np.asarray(w_a.comps[k]), np.asarray(w_b.comps[k]),
                err_msg=f"component {k} diverged",
            )


class TestRandomCollision:
    def test_random_collision_fires_deterministically(self):
        """random_collision (load_models.rs:76-95): collision callback with
        the frame rng; same recorded seed => same result on replay."""
        def bounce(world, other_idx, mask, rng, cs):
            kick = jax.random.uniform(rng, (3,), minval=-1.0, maxval=1.0)
            vals = jnp.broadcast_to(kick * 10.0, (world.capacity, 3))
            return C.with_update(cs, "velocity", vals, mask)

        def build():
            w = base_world()
            w, _ = W.spawn_host(
                w, 2,
                position=np.array([[10.0, 10, 10], [10.2, 10, 10]],
                                  np.float32),
                velocity=np.array([[0.5, 0, 0], [0, 0, 0]], np.float32),
                type_id=np.array([0, 1], np.int32),
                model_id=np.zeros(2, np.int32),
                flags=np.full(2, int(R.FLAG_COLLIDABLE), np.uint32),
            )
            return K.refresh_transforms(w, *UNIT_MODEL_AABB,
                                        jnp.asarray(w.alive))

        step = jax.jit(make_step(
            (EntityType("ball", 0, random_collision=bounce),
             EntityType("wall", 1)),
            logic_radius=1e6,
        ))
        cam = far_camera().with_position(jnp.array([10.0, 10.0, 20.0]))
        inp = InputState.idle(seed=1234)
        w1, _ = step(build(), cam, inp, 0.1, *UNIT_MODEL_AABB)
        w2, _ = step(build(), cam, inp, 0.1, *UNIT_MODEL_AABB)
        # fired: velocity changed from kinematics-only prediction
        assert not np.allclose(np.asarray(w1["velocity"][0]), [0.5, 0, 0])
        # deterministic under the same recorded seed
        np.testing.assert_array_equal(np.asarray(w1["velocity"]),
                                      np.asarray(w2["velocity"]))
        # different seed -> different kick
        w3, _ = step(build(), cam, InputState.idle(seed=99), 0.1,
                     *UNIT_MODEL_AABB)
        assert not np.array_equal(np.asarray(w1["velocity"][0]),
                                  np.asarray(w3["velocity"][0]))
