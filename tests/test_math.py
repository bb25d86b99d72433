"""Math core tests: AABB ops, transforms, camera, frustum planes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from render_engine_tpu.math import aabb, transforms as T
from render_engine_tpu.math.camera import Camera, CameraBuilder


class TestAABB:
    def test_from_points(self):
        pts = jnp.array([[[0.0, 1.0, 2.0], [3.0, -1.0, 0.5], [1.0, 0.0, 7.0]]])
        mn, mx = aabb.from_points(pts)
        np.testing.assert_allclose(mn[0], [0.0, -1.0, 0.5])
        np.testing.assert_allclose(mx[0], [3.0, 1.0, 7.0])

    def test_translate_combine(self):
        mn, mx = jnp.zeros(3), jnp.ones(3)
        mn2, mx2 = aabb.translate(mn, mx, jnp.array([5.0, 0.0, 0.0]))
        np.testing.assert_allclose(mn2, [5.0, 0.0, 0.0])
        cm, cx = aabb.combine(mn, mx, mn2, mx2)
        np.testing.assert_allclose(cm, [0.0, 0.0, 0.0])
        np.testing.assert_allclose(cx, [6.0, 1.0, 1.0])

    def test_intersects(self):
        mn_a = jnp.array([[0.0, 0.0, 0.0], [0.0, 0.0, 0.0]])
        mx_a = jnp.array([[1.0, 1.0, 1.0], [1.0, 1.0, 1.0]])
        mn_b = jnp.array([[0.5, 0.5, 0.5], [2.0, 2.0, 2.0]])
        mx_b = jnp.array([[2.0, 2.0, 2.0], [3.0, 3.0, 3.0]])
        hit = aabb.intersects(mn_a, mx_a, mn_b, mx_b)
        assert bool(hit[0]) and not bool(hit[1])

    def test_corners_count_and_extremes(self):
        mn, mx = jnp.array([-1.0, -2.0, -3.0]), jnp.array([1.0, 2.0, 3.0])
        cs = aabb.corners(mn, mx)
        assert cs.shape == (8, 3)
        np.testing.assert_allclose(jnp.min(cs, axis=0), mn)
        np.testing.assert_allclose(jnp.max(cs, axis=0), mx)

    def test_transform_matches_brute_force(self):
        mn, mx = jnp.array([-1.0, 0.0, 2.0]), jnp.array([1.0, 1.0, 3.0])
        q = T.quat_from_axis_angle(jnp.array([0.0, 1.0, 0.0]), jnp.float32(0.7))
        m = T.compose_trs(jnp.array([4.0, 5.0, 6.0]), q, jnp.array([2.0, 1.0, 0.5]))
        got_mn, got_mx = aabb.transform(mn, mx, m)
        moved = T.apply_transform(m, aabb.corners(mn, mx))
        np.testing.assert_allclose(got_mn, jnp.min(moved, axis=0), rtol=1e-5)
        np.testing.assert_allclose(got_mx, jnp.max(moved, axis=0), rtol=1e-5)

    def test_out_of_bounds(self):
        mn = jnp.array([[1.0, 1.0, 1.0], [-1.0, 1.0, 1.0]])
        mx = mn + 1.0
        oob = aabb.out_of_bounds(mn, mx, jnp.zeros(3), jnp.full(3, 10.0))
        assert not bool(oob[0]) and bool(oob[1])

    def test_distances(self):
        mn, mx = jnp.zeros(3), jnp.full(3, 2.0)
        p = jnp.array([5.0, 1.0, 1.0])
        exact = aabb.exact_distance_to_point(mn, mx, p)
        np.testing.assert_allclose(exact, 3.0, rtol=1e-6)
        conservative = aabb.distance_to_point(mn, mx, p)
        assert float(conservative) <= float(exact) + 1e-6


class TestQuaternions:
    def test_axis_angle_roundtrip_vs_matrix(self):
        axis = jnp.array([0.0, 0.0, 1.0])
        q = T.quat_from_axis_angle(axis, jnp.float32(np.pi / 2))
        v = jnp.array([1.0, 0.0, 0.0])
        rotated = T.quat_rotate(q, v)
        np.testing.assert_allclose(rotated, [0.0, 1.0, 0.0], atol=1e-6)
        m = T.quat_to_matrix(q)
        np.testing.assert_allclose(m @ v, rotated, atol=1e-6)

    def test_zero_axis_is_identity(self):
        q = T.quat_from_axis_angle(jnp.zeros(3), jnp.float32(1.0))
        v = jnp.array([1.0, 2.0, 3.0])
        np.testing.assert_allclose(T.quat_rotate(q, v), v, atol=1e-6)

    def test_quat_mul_composition(self):
        qa = T.quat_from_axis_angle(jnp.array([0.0, 1.0, 0.0]), jnp.float32(0.3))
        qb = T.quat_from_axis_angle(jnp.array([1.0, 0.0, 0.0]), jnp.float32(0.5))
        v = jnp.array([0.2, -1.0, 2.0])
        lhs = T.quat_rotate(T.quat_mul(qa, qb), v)
        rhs = T.quat_rotate(qa, T.quat_rotate(qb, v))
        np.testing.assert_allclose(lhs, rhs, atol=1e-5)

    def test_rotvec(self):
        rv = jnp.array([0.0, np.pi / 2, 0.0])
        q = T.quat_from_rotvec(rv)
        np.testing.assert_allclose(
            T.quat_rotate(q, jnp.array([1.0, 0.0, 0.0])),
            [0.0, 0.0, -1.0], atol=1e-6,
        )

    def test_batched(self):
        axes = jnp.array([[0.0, 0.0, 1.0], [0.0, 1.0, 0.0]])
        angles = jnp.array([0.1, 0.2])
        q = T.quat_from_axis_angle(axes, angles)
        assert q.shape == (2, 4)
        m = T.quat_to_matrix(q)
        assert m.shape == (2, 3, 3)


class TestTransforms:
    def test_compose_trs(self):
        t = jnp.array([1.0, 2.0, 3.0])
        q = T.quat_identity()
        s = jnp.array([2.0, 2.0, 2.0])
        m = T.compose_trs(t, q, s)
        p = T.apply_transform(m, jnp.array([[1.0, 1.0, 1.0]]))
        np.testing.assert_allclose(p[0], [3.0, 4.0, 5.0], atol=1e-6)

    def test_translation_update_fast_path(self):
        m = T.compose_trs(
            jnp.zeros(3),
            T.quat_from_axis_angle(jnp.array([0.0, 1.0, 0.0]), jnp.float32(0.4)),
            jnp.ones(3),
        )
        m2 = T.translation_update(m, jnp.array([7.0, 8.0, 9.0]))
        full = T.compose_trs(
            jnp.array([7.0, 8.0, 9.0]),
            T.quat_from_axis_angle(jnp.array([0.0, 1.0, 0.0]), jnp.float32(0.4)),
            jnp.ones(3),
        )
        np.testing.assert_allclose(m2, full, atol=1e-6)

    def test_perspective_maps_near_far(self):
        m = T.perspective(jnp.float32(np.pi / 2), 1.0, 1.0, 100.0)
        for z, expect in [(-1.0, -1.0), (-100.0, 1.0)]:
            clip = m @ jnp.array([0.0, 0.0, z, 1.0])
            ndc = clip[2] / clip[3]
            np.testing.assert_allclose(ndc, expect, atol=1e-5)

    def test_look_at_view_space(self):
        eye = jnp.array([0.0, 0.0, 5.0])
        v = T.look_at(eye, jnp.zeros(3), jnp.array([0.0, 1.0, 0.0]))
        # Looking at origin from +z: origin should be at z=-5 in view space.
        p = v @ jnp.array([0.0, 0.0, 0.0, 1.0])
        np.testing.assert_allclose(p[:3], [0.0, 0.0, -5.0], atol=1e-6)


class TestCameraFrustum:
    def _cam(self):
        return (
            CameraBuilder()
            .with_position(0.0, 0.0, 0.0)
            .with_yaw_pitch_degrees(-90.0, 0.0)  # looking down -Z
            .with_fov_degrees(90.0)
            .with_aspect(1.0)
            .with_near_far(0.1, 100.0)
            .build()
        )

    def test_direction(self):
        cam = self._cam()
        np.testing.assert_allclose(cam.direction(), [0.0, 0.0, -1.0], atol=1e-6)

    def test_frustum_contains_points(self):
        cam = self._cam()
        planes = cam.frustum_planes()

        def inside(p):
            d = planes[:, :3] @ jnp.asarray(p, jnp.float32) + planes[:, 3]
            return bool(jnp.all(d >= 0))

        assert inside([0.0, 0.0, -10.0])  # straight ahead
        assert not inside([0.0, 0.0, 10.0])  # behind
        assert not inside([0.0, 0.0, -200.0])  # past far plane
        assert not inside([50.0, 0.0, -10.0])  # far off to the side
        assert inside([5.0, 5.0, -10.0])  # within the 90 deg cone

    def test_pitch_clamp(self):
        cam = self._cam().rotated(jnp.float32(0.0), jnp.float32(10.0))
        assert float(cam.pitch) <= float(89.0 * np.pi / 180) + 1e-6

    def test_float_position_inertia(self):
        cam = self._cam()
        moved = cam.float_position(jnp.array([1.0, 0.0, 0.0]), jnp.float32(1.0))
        assert float(moved.position[0]) > 0.0
        # no accel => decays
        coasted = moved.float_position(jnp.zeros(3), jnp.float32(1.0))
        assert float(coasted.velocity[0]) < float(moved.velocity[0])

    def test_serialize_roundtrip(self):
        cam = self._cam().rotated(jnp.float32(0.2), jnp.float32(-0.1))
        cam = cam.float_position(jnp.array([0.0, 1.0, 0.0]), jnp.float32(0.5))
        data = cam.serialize()
        cam2 = self._cam().apply_serialized(data)
        np.testing.assert_allclose(cam2.serialize(), data)

    def test_camera_is_jittable(self):
        cam = self._cam()

        @jax.jit
        def f(c: Camera):
            return c.float_position(jnp.array([0.0, 0.0, -1.0]), 0.1).proj_view()

        m = f(cam)
        assert m.shape == (4, 4)
        assert np.isfinite(np.asarray(m)).all()


class TestMatmulPrecision:
    """A DEFAULT-precision f32 matmul may run in reduced precision on an
    accelerator (TF32 on NVIDIA tensor cores, bf16 passes elsewhere), which
    catastrophically cancels in the Gribb-Hartmann far-plane extraction
    (r3 - r2 of proj@view is tiny, then normalized): reduced precision
    moves the far plane by many world units, silently culling casters
    deep inside a light volume. mm44/inv44 and the precision-pinned
    einsums keep coordinate math exact on EVERY backend; this test asserts
    the plane math matches an f64 reference wherever the suite runs."""

    def test_far_plane_matches_f64(self):
        from render_engine_tpu.world import culling

        pos = np.array([1000.0, 1000.0, 880.0], np.float32)
        d = np.array([0.0, -0.3, 1.0], np.float64)
        d /= np.linalg.norm(d)
        persp = np.asarray(T.perspective(jnp.float32(2.1), 1.0, 1.0,
                                         jnp.float32(400.0)))
        view = np.asarray(T.look_at(jnp.asarray(pos),
                                    jnp.asarray(pos + d.astype(np.float32)),
                                    jnp.asarray(np.array([0.0, 1.0, 0.0],
                                                         np.float32))))
        pv = T.mm44(jnp.asarray(persp), jnp.asarray(view))
        planes = np.asarray(T.frustum_planes(pv))

        r = persp.astype(np.float64) @ view.astype(np.float64)
        pl64 = np.stack([r[3] + r[0], r[3] - r[0], r[3] + r[1], r[3] - r[1],
                         r[3] + r[2], r[3] - r[2]])
        pl64 /= np.linalg.norm(pl64[:, :3], axis=-1, keepdims=True)
        # f32 round-off through the pinned compose stays under 1e-2 world
        # units even on the cancellation-amplified far plane
        np.testing.assert_allclose(planes, pl64, atol=1e-2)

        # a caster 290 units down the axis, 0.37 rad off it, must test
        # inside (the configuration a reduced-precision compose drops)
        ax = d
        lat = np.cross(ax, [0.0, 1.0, 0.0])
        lat /= np.linalg.norm(lat)
        ang = np.arccos(0.93)
        c = pos + (290 * np.cos(ang) * ax + 290 * np.sin(ang) * lat).astype(
            np.float32)
        mn = jnp.asarray((c - 7)[None].astype(np.float32))
        mx = jnp.asarray((c + 7)[None].astype(np.float32))
        assert bool(culling.aabb_in_frustum(T.frustum_planes(pv), mn, mx)[0])

    def test_inv44_roundtrip(self):
        cam = (CameraBuilder()
               .with_position(900.0, 1000.0, 800.0)
               .with_yaw_pitch_degrees(-90.0, -10.0)
               .with_fov_degrees(63.0)
               .with_aspect(16 / 9)
               .with_near_far(0.5, 2000.0)
               .build())
        pv = cam.proj_view()
        # compare against the f64 inverse, scaled: pv is ill-conditioned
        # (translations ~1e3, far/near 4e3), so an absolute identity check
        # overstates achievable f32 accuracy; the pinned inverse must
        # match f64 to f32 round-off relative to the inverse's own scale
        inv64 = np.linalg.inv(np.asarray(pv).astype(np.float64))
        err = np.abs(np.asarray(T.inv44(pv)) - inv64)
        assert err.max() <= 1e-4 * np.abs(inv64).max()
