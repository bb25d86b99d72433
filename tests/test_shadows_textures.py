"""Shadow-map and texture-atlas tests."""

import dataclasses

import jax.numpy as jnp
import numpy as np

from render_engine_tpu.ecs import registry as R
from render_engine_tpu.ecs import world as W
from render_engine_tpu.logic import kinematics as K
from render_engine_tpu.math.camera import CameraBuilder
from render_engine_tpu.models import primitives
from render_engine_tpu.models.bank import ModelBankBuilder
from render_engine_tpu.render import shadows as SH
from render_engine_tpu.render.textures import (
    TextureAtlasBuilder,
    sample_atlas,
)
from render_engine_tpu.render.raster_jnp import RasterConfig, render_gbuffer
from render_engine_tpu.render.geometry import build_triangle_batch, to_screen


def make_bank():
    bb = ModelBankBuilder()
    m = bb.add_material(albedo=(1.0, 1.0, 1.0))
    bb.add_model("cube", primitives.cube(2.0), material=m)
    return bb.finalize()


class TestShadowState:
    def _world_with_light_and_blocker(self):
        bank = make_bank()
        cfg = W.WorldConfig(capacity=16, world_length=256.0,
                            section_length=32.0)
        w = W.create_world(cfg)
        # spot light above looking down; a cube between light and ground
        w, _ = W.spawn_host(
            w, 2,
            position=np.array([[64.0, 40.0, 64.0], [64.0, 20.0, 64.0]],
                              np.float32),
            model_id=np.array([-1, 0], np.int32),
            sortable=np.array([R.SORTABLE_SPOT, R.SORTABLE_DEFAULT], np.int32),
            light_direction=np.array([[0.0, -1.0, 0.0], [0, 0, 0]], np.float32),
            light_fov=np.array([1.2, 0.0], np.float32),
        )
        w = K.refresh_transforms(w, bank.aabb_min, bank.aabb_max,
                                 jnp.asarray(w.alive))
        return w, bank

    def test_render_shadow_map_fills_slot(self):
        w, bank = self._world_with_light_and_blocker()
        cam = (CameraBuilder().with_position(64.0, 25.0, 80.0)
               .with_draw_distance(500.0).build())
        shadow = SH.create_shadow_state(resolution=64, budget=2)
        shadow = SH.render_shadow_map(shadow, w, cam, bank, max_tris=64,
                                      raster_cfg=RasterConfig(
                                          tile_budget=16, global_budget=8))
        ents = np.asarray(shadow.slot_entity)
        assert (ents >= 0).any()
        slot = int(np.argmax(ents >= 0))
        m = np.asarray(shadow.maps[slot])
        # the blocker cube writes depths < 1 somewhere in the map
        assert (m < 1.0).any()

    def test_pcf_shadowing(self):
        """A point under the blocker is shadowed; a point beside it is lit."""
        w, bank = self._world_with_light_and_blocker()
        cam = (CameraBuilder().with_position(64.0, 25.0, 80.0)
               .with_draw_distance(500.0).build())
        shadow = SH.create_shadow_state(resolution=128, budget=2)
        shadow = SH.render_shadow_map(shadow, w, cam, bank, max_tris=64,
                                      raster_cfg=RasterConfig(
                                          tile_budget=16, global_budget=8))
        slot = int(np.argmax(np.asarray(shadow.slot_entity) >= 0))
        pts = jnp.array([
            [[64.0, 5.0, 64.0], [80.0, 5.0, 64.0]],
        ])  # (1, 2, 3): under the cube / off to the side
        f = np.asarray(SH.pcf_factor(shadow, jnp.int32(slot), pts))
        assert f[0, 0, 0] < 0.5  # occluded by the cube
        assert f[0, 1, 0] > 0.5  # lit

    def test_eviction_when_light_leaves(self):
        w, bank = self._world_with_light_and_blocker()
        cam = (CameraBuilder().with_position(64.0, 25.0, 80.0)
               .with_draw_distance(500.0).build())
        shadow = SH.create_shadow_state(resolution=32, budget=2)
        shadow = SH.render_shadow_map(shadow, w, cam, bank, max_tris=64)
        assert (np.asarray(shadow.slot_entity) >= 0).any()
        # move camera far away: light leaves the neighborhood -> slot frees
        far_cam = cam.with_position(jnp.array([5000.0, 5000.0, 5000.0]))
        shadow2, slot, light, face, do = SH.choose_light(shadow, w,
                                                         far_cam.position)
        assert (np.asarray(shadow2.slot_entity) == -1).all()


    def test_user_caster_mask_controls_shadow_pass(self):
        """caster_mask is the user's shadow draw control (the reference
        registers user shadow draw fns, load_models.rs): excluding the
        blocker leaves the map empty; a trace-time callable works too."""
        w, bank = self._world_with_light_and_blocker()
        cam = (CameraBuilder().with_position(64.0, 25.0, 80.0)
               .with_draw_distance(500.0).build())
        cfg = RasterConfig(tile_budget=16, global_budget=8)

        def render(mask):
            shadow = SH.create_shadow_state(resolution=64, budget=2)
            return SH.render_shadow_map(shadow, w, cam, bank, max_tris=64,
                                        raster_cfg=cfg, caster_mask=mask)

        with_blocker = render(None)
        slot = int(np.argmax(np.asarray(with_blocker.slot_entity) >= 0))
        assert (np.asarray(with_blocker.maps[slot]) < 1.0).any()
        # exclude everything -> empty depth map, schedule unchanged
        none_cast = render(jnp.zeros(w.capacity, bool))
        assert (np.asarray(none_cast.maps[slot]) == 1.0).all()
        assert (np.asarray(none_cast.slot_entity)
                == np.asarray(with_blocker.slot_entity)).all()
        # callable form: casters = entities below y 30 (the blocker)
        fn_cast = render(lambda world: world["position"][:, 1] < 30.0)
        np.testing.assert_array_equal(np.asarray(fn_cast.maps[slot]),
                                      np.asarray(with_blocker.maps[slot]))

    def test_directional_camera_fits_light_radius(self):
        """A caster 300 units off the beam axis of a radius-400 directional
        light (outside the legacy 200-unit ortho box) still casts: the
        camera volume is fitted to light_radius (shadow_flow.rs:140-260
        derives the camera from the light's neighborhood), and the
        outside-volume counter is zero. With the legacy constants forced,
        the same caster is invisible to the camera AND counted."""
        bank = make_bank()
        cfg = W.WorldConfig(capacity=16, world_length=2048.0,
                            section_length=256.0)
        w = W.create_world(cfg)
        lpos = np.array([1024.0, 600.0, 1024.0], np.float32)
        # caster ~304 from the light: 300 lateral, 50 down the beam
        cpos = lpos + np.array([300.0, -50.0, 0.0], np.float32)
        w, _ = W.spawn_host(
            w, 2,
            position=np.stack([lpos, cpos]),
            model_id=np.array([-1, 0], np.int32),
            # the 800-unit ortho box maps to 128 px: scale the 2-unit cube
            # up so its footprint covers pixel centers
            scale=np.array([[1.0, 1, 1], [20.0, 20, 20]], np.float32),
            sortable=np.array([R.SORTABLE_DIRECTIONAL, R.SORTABLE_DEFAULT],
                              np.int32),
            light_direction=np.array([[0.0, -1.0, 0.0], [0, 0, 0]],
                                     np.float32),
            light_radius=np.array([400.0, 0.0], np.float32),
        )
        w = K.refresh_transforms(w, bank.aabb_min, bank.aabb_max,
                                 jnp.asarray(w.alive))
        pv = SH.light_proj_view(w, jnp.int32(0))
        assert int(SH.casters_outside_volume(w, jnp.int32(0), pv)) == 0
        cam = (CameraBuilder().with_position(float(lpos[0]), 500.0, 1100.0)
               .with_draw_distance(1000.0).build())
        shadow = SH.create_shadow_state(resolution=128, budget=1)
        shadow = SH.render_shadow_map(shadow, w, cam, bank, max_tris=64,
                                      raster_cfg=RasterConfig(
                                          tile_budget=16, global_budget=8))
        assert int(shadow.slot_entity[0]) == 0
        assert (np.asarray(shadow.maps[0]) < 1.0).any()  # the caster wrote
        # legacy constants: the caster escapes the box and is counted
        pv_old = SH.light_proj_view(w, jnp.int32(0), ortho_extent=200.0,
                                    far=600.0)
        assert int(SH.casters_outside_volume(w, jnp.int32(0), pv_old)) == 1

    def test_spot_camera_widens_to_outer_cutoff(self):
        """The demo's stars have a 1.0 rad outer cutoff but light_fov 1.2
        (0.6 half-angle): the camera must widen to the cone or lit pixels
        near the cone edge can never be shadowed."""
        bank = make_bank()
        cfg = W.WorldConfig(capacity=16, world_length=512.0,
                            section_length=64.0)
        w = W.create_world(cfg)
        lpos = np.array([256.0, 200.0, 256.0], np.float32)
        # caster inside the outer cone (0.8 rad off-axis) but outside a
        # 0.6-half-angle camera, 100 units out
        off = np.array([np.sin(0.8), -np.cos(0.8), 0.0]) * 100.0
        w, _ = W.spawn_host(
            w, 2,
            position=np.stack([lpos, lpos + off.astype(np.float32)]),
            model_id=np.array([-1, 0], np.int32),
            sortable=np.array([R.SORTABLE_SPOT, R.SORTABLE_DEFAULT],
                              np.int32),
            light_direction=np.array([[0.0, -1.0, 0.0], [0, 0, 0]],
                                     np.float32),
            light_fov=np.array([1.2, 0.0], np.float32),
            light_cutoff=np.tile(
                np.array([[np.cos(0.6), np.cos(1.0)]], np.float32), (2, 1)),
            light_radius=np.array([400.0, 0.0], np.float32),
        )
        w = K.refresh_transforms(w, bank.aabb_min, bank.aabb_max,
                                 jnp.asarray(w.alive))
        pv = SH.light_proj_view(w, jnp.int32(0))
        assert int(SH.casters_outside_volume(w, jnp.int32(0), pv)) == 0
        # the unexpanded camera (cutoff cleared) misses the caster
        w_nocut = w.replace(light_cutoff=jnp.zeros_like(w["light_cutoff"]))
        pv_narrow = SH.light_proj_view(w_nocut, jnp.int32(0))
        from render_engine_tpu.math import transforms as T
        from render_engine_tpu.world import culling
        inside = culling.aabb_in_frustum(
            T.frustum_planes(pv_narrow), w["aabb_min"], w["aabb_max"])
        assert not bool(inside[1])

    def test_update_interval_skips_frames(self):
        """interval=2: maps render on even ticks only; skipped frames just
        bump the tick (the headline demo's stretched round-robin)."""
        w, bank = self._world_with_light_and_blocker()
        cam = (CameraBuilder().with_position(64.0, 25.0, 80.0)
               .with_draw_distance(500.0).build())
        cfg = RasterConfig(tile_budget=16, global_budget=8)
        sh = SH.create_shadow_state(resolution=64, budget=2)
        sh = SH.render_shadow_map(sh, w, cam, bank, max_tris=64,
                                  raster_cfg=cfg, interval=2)  # tick 0: runs
        assert int(sh.tick) == 1
        c1 = int(sh.cursor)
        assert (np.asarray(sh.slot_entity) >= 0).any()
        sh = SH.render_shadow_map(sh, w, cam, bank, max_tris=64,
                                  raster_cfg=cfg, interval=2)  # tick 1: skips
        assert int(sh.tick) == 2
        assert int(sh.cursor) == c1  # choose_light did not run
        sh = SH.render_shadow_map(sh, w, cam, bank, max_tris=64,
                                  raster_cfg=cfg, interval=2)  # tick 2: runs
        assert int(sh.cursor) == c1 + 1


class TestCubeShadows:
    def test_point_light_fills_faces_over_frames(self):
        """A point light claims one cube face per frame (the reference's
        6-face one-per-frame schedule, shadow_flow.rs:267-358)."""
        bank = make_bank()
        cfg = W.WorldConfig(capacity=8, world_length=256.0,
                            section_length=32.0)
        w = W.create_world(cfg)
        w, _ = W.spawn_host(
            w, 2,
            position=np.array([[64.0, 40.0, 64.0], [80.0, 40.0, 64.0]],
                              np.float32),
            model_id=np.array([-1, 0], np.int32),
            sortable=np.array([R.SORTABLE_POINT, R.SORTABLE_DEFAULT],
                              np.int32),
        )
        w = K.refresh_transforms(w, bank.aabb_min, bank.aabb_max,
                                 jnp.asarray(w.alive))
        cam = (CameraBuilder().with_position(64.0, 45.0, 80.0)
               .with_draw_distance(500.0).build())
        shadow = SH.create_shadow_state(resolution=32, budget=6)
        for _ in range(6):
            shadow = SH.render_shadow_map(shadow, w, cam, bank, max_tris=64)
        ents = np.asarray(shadow.slot_entity)
        faces = np.asarray(shadow.slot_face)
        assert (ents == 0).sum() == 6  # light 0 owns all six slots
        assert sorted(faces.tolist()) == [0, 1, 2, 3, 4, 5]

    def test_cube_face_shadows_blocker_direction(self):
        """The blocker sits +X of the light: the +X face map records it and
        PCF reports shadow behind it; the -X side stays lit."""
        bank = make_bank()
        cfg = W.WorldConfig(capacity=8, world_length=256.0,
                            section_length=32.0)
        w = W.create_world(cfg)
        w, _ = W.spawn_host(
            w, 2,
            position=np.array([[64.0, 40.0, 64.0], [72.0, 40.0, 64.0]],
                              np.float32),
            model_id=np.array([-1, 0], np.int32),
            sortable=np.array([R.SORTABLE_POINT, R.SORTABLE_DEFAULT],
                              np.int32),
        )
        w = K.refresh_transforms(w, bank.aabb_min, bank.aabb_max,
                                 jnp.asarray(w.alive))
        cam = (CameraBuilder().with_position(64.0, 45.0, 80.0)
               .with_draw_distance(500.0).build())
        shadow = SH.create_shadow_state(resolution=64, budget=6)
        for _ in range(6):
            shadow = SH.render_shadow_map(shadow, w, cam, bank, max_tris=64)
        factor = SH.make_shadow_factor(shadow, w,
                                       {"point": jnp.array([0], jnp.int32)})
        pts = jnp.array([[[90.0, 40.0, 64.0], [40.0, 40.0, 64.0]]])
        f = np.asarray(factor("point", 0, pts))
        assert f[0, 0, 0] < 0.5  # behind the blocker (+X)
        assert f[0, 1, 0] > 0.5  # the -X side is lit


class TestTextures:
    def test_atlas_roundtrip_and_scale(self):
        bb = TextureAtlasBuilder(layer_size=16)
        img = np.zeros((8, 8, 3), np.float32)
        img[:, :, 0] = 1.0  # red, half-size -> packed 8x8 rect
        tid = bb.add_image(img)
        atlas = bb.finalize()
        np.testing.assert_allclose(np.asarray(atlas.uv_rect[tid]),
                                   [7.0, 7.0, 0.0, 0.0])
        got = np.asarray(sample_atlas(
            atlas, jnp.int32(tid), jnp.array([[0.5, 0.5]])))
        np.testing.assert_allclose(got[0], [1.0, 0.0, 0.0], atol=1e-5)

    def test_atlas_shelf_packing_minimizes_waste(self):
        """Several small images SHARE one layer (the reference's
        minimize-wasted-space array selection, texture_array.rs:224-256,
        strengthened to sub-rect packing) and each samples its own pixels
        with no bleed across rect borders."""
        bb = TextureAtlasBuilder(layer_size=32)
        colors = [(1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0),
                  (1.0, 1.0, 0.0)]
        tids = []
        for c in colors:
            img = np.broadcast_to(np.asarray(c, np.float32),
                                  (16, 16, 3)).copy()
            tids.append(bb.add_image(img))
        atlas = bb.finalize()
        # 4 x 16x16 fit exactly in one 32x32 layer
        assert atlas.layers.shape[0] == 1
        assert atlas.wasted_fraction() < 0.15
        uv = jnp.array([[0.5, 0.5]])
        for tid, c in zip(tids, colors):
            got = np.asarray(sample_atlas(atlas, jnp.int32(tid), uv))
            np.testing.assert_allclose(got[0], c, atol=1e-5)
        # edges of each rect stay pure (no neighbor bleed)
        for tid, c in zip(tids, colors):
            for u, v in [(0.0, 0.0), (0.999, 0.0), (0.0, 0.999),
                         (0.999, 0.999)]:
                got = np.asarray(sample_atlas(
                    atlas, jnp.int32(tid), jnp.array([[u, v]])))
                np.testing.assert_allclose(got[0], c, atol=1e-5,
                                           err_msg=f"tid {tid} uv {u},{v}")

    def test_checkerboard_sampling(self):
        bb = TextureAtlasBuilder(layer_size=32)
        tid = bb.add_checkerboard(a=(1, 1, 1), b=(0, 0, 0), cells=2)
        atlas = bb.finalize()
        # cell centers: (0.25,0.75)->white-ish, (0.75,0.75)->black-ish
        # (v is flipped in the sampler: uv (0,1) = image top)
        uv = jnp.array([[0.25, 0.75], [0.75, 0.75]])
        got = np.asarray(sample_atlas(atlas, jnp.full(2, tid, jnp.int32), uv))
        assert got[0].mean() > 0.9
        assert got[1].mean() < 0.1

    def test_textured_resolve(self):
        bb = ModelBankBuilder()
        tb = TextureAtlasBuilder(layer_size=16)
        img = np.zeros((16, 16, 3), np.float32)
        img[:, :, 2] = 1.0  # blue texture
        tid = tb.add_image(img)
        atlas = tb.finalize()
        m = bb.add_material(albedo=(1.0, 0.0, 0.0), texture=tid)
        bb.add_model("quad", primitives.quad(1.0), material=m)
        bank = bb.finalize()

        cfg = W.WorldConfig(capacity=4, world_length=128.0, section_length=16.0)
        w = W.create_world(cfg)
        w, _ = W.spawn_host(w, 1,
                            position=np.array([[64.0, 64.0, 59.0]], np.float32),
                            model_id=np.array([0], np.int32))
        w = K.refresh_transforms(w, bank.aabb_min, bank.aabb_max,
                                 jnp.asarray(w.alive))
        cam = (CameraBuilder().with_position(64.0, 64.0, 64.0)
               .with_yaw_pitch_degrees(-90.0, 0.0).with_fov_degrees(60.0)
               .with_aspect(4.0).with_near_far(0.1, 100.0)
               .with_draw_distance(100.0).build())
        batch = to_screen(build_triangle_batch(w, bank, cam, max_tris=8),
                          128, 32)
        gb = render_gbuffer(batch, bank, 32, 128,
                            RasterConfig(tile_budget=8, global_budget=4),
                            atlas=atlas)
        center = np.asarray(gb.albedo)[16, 64]
        np.testing.assert_allclose(center, [0.0, 0.0, 1.0], atol=1e-4)


class TestFusedTexturingAndSpecular:
    def _scene(self, specular=1.0):
        from render_engine_tpu.math.camera import CameraBuilder

        ab = TextureAtlasBuilder(layer_size=32)
        tex = ab.add_checkerboard(a=(1, 0, 0), b=(0, 0, 1), cells=4)
        atlas = ab.finalize()
        bb = ModelBankBuilder()
        m = bb.add_material(albedo=(1.0, 1.0, 1.0), texture=tex,
                            specular=specular)
        plain = bb.add_material(albedo=(0.4, 0.8, 0.4), specular=specular)
        bb.add_model("quad", primitives.quad(3.0), material=m)
        bb.add_model("ball", primitives.uv_sphere(1.2, 6, 8), material=plain)
        bank = bb.finalize()
        cfg = W.WorldConfig(capacity=8, world_length=64.0,
                            section_length=8.0)
        w = W.create_world(cfg)
        w, _ = W.spawn_host(
            w, 3,
            position=np.array([[30.0, 32.0, 27.0], [34.0, 32.0, 28.0],
                               [32.0, 33.5, 29.5]], np.float32),
            model_id=np.array([0, 1, -1], np.int32),
            sortable=np.array([0, 0, R.SORTABLE_POINT], np.int32),
            light_diffuse=np.array(
                [[0, 0, 0], [0, 0, 0], [1.0, 1.0, 0.9]], np.float32),
            light_specular=np.array(
                [[0, 0, 0], [0, 0, 0], [1.0, 1.0, 1.0]], np.float32),
            light_atten=np.array(
                [[0, 0], [0, 0], [0.05, 0.01]], np.float32),
        )
        w = K.refresh_transforms(w, bank.aabb_min, bank.aabb_max,
                                 jnp.asarray(w.alive))
        cam = (CameraBuilder().with_position(32.0, 32.0, 33.0)
               .with_yaw_pitch_degrees(-90.0, 0.0).with_fov_degrees(70.0)
               .with_aspect(4.0).with_near_far(0.1, 50.0)
               .with_draw_distance(50.0).build())
        return w, bank, cam, atlas

    def _settings(self, **kw):
        from render_engine_tpu.render.frame import RenderSettings

        return RenderSettings(
            width=128, height=32, max_tris=256, backend="tiled",
            raster=RasterConfig(tile_budget=48, max_tiles_per_tri=8,
                                global_budget=16, chunk=4),
            max_point_lights=4, **kw,
        )

    def test_fused_atlas_matches_tall_path(self):
        from render_engine_tpu.render.frame import render_frame

        w, bank, cam, atlas = self._scene()
        s_f = self._settings(fused_shading=True,
                             texture_transparent=True)
        s_t = self._settings(fused_shading=False)
        a = np.asarray(render_frame(w, cam, bank, s_f, atlas=atlas))
        b = np.asarray(render_frame(w, cam, bank, s_t, atlas=atlas))
        diff = np.abs(a - b).max(axis=-1)
        assert diff.max() < 0.03, f"max diff {diff.max():.4f}"
        # the checkerboard is visible (red and blue texels both present)
        assert (a[..., 0] > 0.3).any() and (a[..., 2] > 0.3).any()

    def test_specular_strength_changes_highlight(self):
        from render_engine_tpu.render.frame import render_frame

        w0, bank0, cam, atlas = self._scene(specular=0.0)
        w5, bank5, _, _ = self._scene(specular=5.0)
        s = self._settings(fused_shading=True)
        img0 = np.asarray(render_frame(w0, cam, bank0, s, atlas=atlas))
        img5 = np.asarray(render_frame(w5, cam, bank5, s, atlas=atlas))
        # stronger material specular -> brighter highlights somewhere
        assert img5.max() > img0.max() + 0.05

    def test_obj_mtl_specular_and_texture_roundtrip(self, tmp_path):
        """OBJ+MTL with Ks + map_Kd loads through add_obj into the atlas."""
        from render_engine_tpu.demo.space_scene import _write_station_asset

        obj = _write_station_asset(str(tmp_path))
        ab = TextureAtlasBuilder(layer_size=64)
        bb = ModelBankBuilder()
        mid = bb.add_obj("station", obj, atlas_builder=ab)
        bank = bb.finalize()
        atlas = ab.finalize()
        # two 64x64 textures (panels diffuse + bumps normal map), one per
        # shelf-packed layer
        assert atlas is not None and atlas.layers.shape[0] == 2
        assert int(bank.tri_count[mid]) == 12
        # the hull material carries Ks=0.6, the diffuse layer, and the
        # map_Bump normal map
        mat = int(np.asarray(bank.tri_material)[int(bank.tri_offset[mid])])
        assert abs(float(bank.mat_specular[mat]) - 0.6) < 1e-6
        assert int(bank.mat_texture[mat]) == 0
        assert int(bank.mat_texture_norm[mat]) >= 0
        assert bank.has_normal_maps()

    @staticmethod
    def _write_obj(dirname, mtl_body):
        """A unit quad OBJ with the given MTL body."""
        import os

        with open(os.path.join(dirname, "m.mtl"), "w") as fh:
            fh.write(mtl_body)
        obj = os.path.join(dirname, "quad.obj")
        with open(obj, "w") as fh:
            fh.write("mtllib m.mtl\n"
                     "v -1 -1 0\nv 1 -1 0\nv 1 1 0\nv -1 1 0\n"
                     "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\n"
                     "vn 0 0 1\n"
                     "usemtl skin\n"
                     "f 1/1/1 2/2/1 3/3/1\nf 1/1/1 3/3/1 4/4/1\n")
        return obj

    def test_mtl_both_maps_roundtrip(self, tmp_path):
        """map_Kd AND map_Ks load into separate atlas layers and land in
        the material's texture ROW (the reference packs five texture pairs
        per vertex, model_definitions.rs:71-148; here diffuse+specular per
        material)."""
        import os

        s = 16
        diff = np.full((s, s, 3), 200, np.uint8)
        spec = np.zeros((s, s, 3), np.uint8)
        spec[:, : s // 2] = 255  # left half shiny
        emis = np.full((s, s, 3), 128, np.uint8)
        for name, img in (("diff.ppm", diff), ("spec.ppm", spec),
                          ("emis.ppm", emis)):
            with open(os.path.join(str(tmp_path), name), "wb") as fh:
                fh.write(b"P6\n%d %d\n255\n" % (s, s) + img.tobytes())
        obj = self._write_obj(
            str(tmp_path),
            "newmtl skin\nKd 1 1 1\nKs 0.5 0.5 0.5\nKe 2 2 2\n"
            "map_Kd diff.ppm\nmap_Ks spec.ppm\nmap_Ke emis.ppm\n")
        ab = TextureAtlasBuilder(layer_size=16)
        bb = ModelBankBuilder()
        bb.add_obj("quad", obj, atlas_builder=ab)
        bank = bb.finalize()
        atlas = ab.finalize()
        assert atlas.layers.shape[0] == 3
        mat = int(np.asarray(bank.tri_material)[0])
        row = np.asarray(bank.mat_textures[mat])
        assert row[0] == 0 and row[1] == 1 and row[2] == 2
        assert (row[3:] == -1).all()
        assert bank.has_specular_maps() and bank.has_emissive_maps()
        assert abs(float(bank.mat_specular[mat]) - 0.5) < 1e-6
        assert abs(float(bank.mat_emissive[mat]) - 2.0) < 1e-6

    def test_missing_texture_uses_error_material(self, tmp_path):
        """A missing map_Kd file falls back LOUDLY to the diffuse-role
        error texture instead of crashing (the reference's SIX named error
        colors, one per texture role, helper_constructs.rs:2-12: diffuse
        is blue)."""
        import warnings

        from render_engine_tpu.render.textures import sample_atlas

        obj = self._write_obj(
            str(tmp_path),
            "newmtl skin\nKd 1 1 1\nmap_Kd does_not_exist.png\n")
        ab = TextureAtlasBuilder(layer_size=16)
        bb = ModelBankBuilder()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            bb.add_obj("quad", obj, atlas_builder=ab)
        assert any("error texture" in str(w.message) for w in caught)
        bank = bb.finalize()
        atlas = ab.finalize()
        mat = int(np.asarray(bank.tri_material)[0])
        tid = int(bank.mat_texture[mat])
        assert tid == ab.error_texture("diffuse")
        # each role has its own loud checkerboard color (reference table)
        got = np.asarray(sample_atlas(
            atlas, jnp.full(1, tid, jnp.int32),
            jnp.array([[1.0 / 32.0, 1.0 - 1.0 / 32.0]])))
        np.testing.assert_allclose(
            got[0], TextureAtlasBuilder.ERROR_COLORS["diffuse"], atol=1e-3)
        assert (ab.error_texture("specular")
                != ab.error_texture("diffuse"))

    def test_emissive_map_modulates_glow_all_paths(self):
        """The emissive map's red channel scales the per-pixel emissive
        brightness (third texture pair) in the jnp golden path, the tall
        pallas path, and the fused kernel — a half-bright checkerboard map
        makes part of the quad glow dimmer, all three paths agreeing."""
        import dataclasses as dc

        from render_engine_tpu.render.frame import RenderSettings, render_frame
        from render_engine_tpu.math.camera import CameraBuilder

        ab = TextureAtlasBuilder(layer_size=16)
        etid = ab.add_checkerboard(a=(1.0, 1.0, 1.0), b=(0.25, 0.25, 0.25),
                                   cells=2)
        atlas = ab.finalize()
        bb = ModelBankBuilder()
        m = bb.add_material(albedo=(1.0, 0.5, 0.2), emissive=0.9,
                            texture_emissive=etid)
        bb.add_model("quad", primitives.quad(3.0), material=m)
        bank = bb.finalize()
        assert bank.has_emissive_maps()
        cfg = W.WorldConfig(capacity=4, world_length=64.0,
                            section_length=8.0)
        w = W.create_world(cfg)
        w, _ = W.spawn_host(
            w, 1, position=np.array([[32.0, 32.0, 28.0]], np.float32),
            model_id=np.array([0], np.int32))
        w = K.refresh_transforms(w, bank.aabb_min, bank.aabb_max,
                                 jnp.asarray(w.alive))
        cam = (CameraBuilder().with_position(32.0, 32.0, 33.0)
               .with_yaw_pitch_degrees(-90.0, 0.0).with_fov_degrees(70.0)
               .with_aspect(4.0).with_near_far(0.1, 50.0)
               .with_draw_distance(50.0).build())

        def settings(backend, fused):
            return RenderSettings(
                width=128, height=32, max_tris=64, backend=backend,
                raster=RasterConfig(tile_budget=16, max_tiles_per_tri=8,
                                    global_budget=8, chunk=4),
                fused_shading=fused, texture_tile_budget=1.0)

        outs = []
        for backend, fused in (("jnp", False), ("tiled", False),
                               ("tiled", True)):
            outs.append(np.asarray(render_frame(
                w, cam, bank, settings(backend, fused), atlas=atlas)))
        img = outs[0]
        covered = img.sum(axis=-1) > 0
        vals = img[covered][:, 0]  # red channel of the glowing quad
        # checkerboard emissive: bright cells ~0.9, dim cells ~0.225
        assert vals.max() > 0.8 and vals.min() < 0.3
        for o in outs[1:]:
            diff = np.abs(o - img).max(axis=-1)
            assert (diff > 0.03).mean() < 0.01

    def test_dissolve_map_modulates_alpha_all_paths(self):
        """The dissolve map (MTL map_d, fifth texture pair) is per-pixel
        alpha: a dissolve-mapped material always takes the transparent
        forward pass, and the map's red channel multiplies the blend
        alpha — jnp golden, tall pallas, and fused kernel agree."""
        from render_engine_tpu.render.frame import RenderSettings, render_frame
        from render_engine_tpu.math.camera import CameraBuilder

        ab = TextureAtlasBuilder(layer_size=16)
        dtid = ab.add_checkerboard(a=(1.0, 1.0, 1.0), b=(0.2, 0.2, 0.2),
                                   cells=2)
        atlas = ab.finalize()
        bb = ModelBankBuilder()
        # alpha 1.0: ONLY the dissolve map makes this transparent;
        # emissive 1.0 makes t_lit == albedo so the blended pixel is
        # exactly alpha * albedo over the black background
        m = bb.add_material(albedo=(1.0, 0.3, 0.3), emissive=1.0,
                            texture_dissolve=dtid)
        bb.add_model("quad", primitives.quad(3.0), material=m)
        bank = bb.finalize()
        assert bank.has_dissolve_maps()
        cfg = W.WorldConfig(capacity=4, world_length=64.0,
                            section_length=8.0)
        w = W.create_world(cfg)
        w, _ = W.spawn_host(
            w, 1, position=np.array([[32.0, 32.0, 28.0]], np.float32),
            model_id=np.array([0], np.int32))
        w = K.refresh_transforms(w, bank.aabb_min, bank.aabb_max,
                                 jnp.asarray(w.alive))
        cam = (CameraBuilder().with_position(32.0, 32.0, 33.0)
               .with_yaw_pitch_degrees(-90.0, 0.0).with_fov_degrees(70.0)
               .with_aspect(4.0).with_near_far(0.1, 50.0)
               .with_draw_distance(50.0).build())

        def settings(backend, fused):
            return RenderSettings(
                width=128, height=32, max_tris=64, backend=backend,
                raster=RasterConfig(tile_budget=16, max_tiles_per_tri=8,
                                    global_budget=8, chunk=4),
                fused_shading=fused, texture_tile_budget=1.0)

        outs = []
        for backend, fused in (("jnp", False), ("tiled", False),
                               ("tiled", True)):
            outs.append(np.asarray(render_frame(
                w, cam, bank, settings(backend, fused), atlas=atlas)))
        img = outs[0]
        covered = img.sum(axis=-1) > 0.05
        vals = img[covered][:, 0]  # red = alpha * 1.0 over black
        assert vals.max() > 0.9 and vals.min() < 0.3, (
            f"dissolve checkerboard missing: {vals.min()}..{vals.max()}")
        for o in outs[1:]:
            diff = np.abs(o - img).max(axis=-1)
            assert (diff > 0.03).mean() < 0.01

    def test_mtl_map_d_wires_through_loader(self, tmp_path):
        """map_d + the d opacity scalar load through the real OBJ loader
        into the dissolve slot (tobj material contract parity)."""
        img = np.full((8, 8, 3), 128, np.uint8)
        ppm = tmp_path / "holes.ppm"
        ppm.write_bytes(b"P6\n8 8\n255\n" + img.tobytes())
        (tmp_path / "m.mtl").write_text(
            "newmtl a\nKd 0.5 0.5 0.5\nd 0.7\nmap_d holes.ppm\n")
        (tmp_path / "q.obj").write_text(
            "mtllib m.mtl\nv -1 -1 0\nv 1 -1 0\nv 1 1 0\n"
            "vt 0 0\nvt 1 0\nvt 1 1\nvn 0 0 1\n"
            "usemtl a\nf 1/1/1 2/2/1 3/3/1\n")
        ab = TextureAtlasBuilder(layer_size=16)
        bb = ModelBankBuilder()
        bb.add_obj("q", str(tmp_path / "q.obj"), atlas_builder=ab)
        bank = bb.finalize()
        assert bank.has_dissolve_maps()
        mat = int(np.asarray(bank.tri_material)[0])
        assert int(bank.mat_texture_diss[mat]) >= 0
        assert abs(float(bank.mat_alpha[mat]) - 0.7) < 1e-6

    def test_specular_map_modulates_highlight_all_paths(self):
        """The spec map's red channel scales the per-pixel specular term in
        the jnp golden path, the tall pallas path, and the fused kernel —
        all three agree, and a black spec map kills the highlight a white
        one produces."""
        import dataclasses as dc

        from render_engine_tpu.render.frame import RenderSettings, render_frame
        from render_engine_tpu.math.camera import CameraBuilder

        def build(spec_white):
            ab = TextureAtlasBuilder(layer_size=16)
            val = 1.0 if spec_white else 0.0
            stid = ab.add_image(np.full((16, 16, 3), val, np.float32))
            atlas = ab.finalize()
            bb = ModelBankBuilder()
            m = bb.add_material(albedo=(0.3, 0.3, 0.3), specular=5.0,
                                texture_specular=stid)
            bb.add_model("ball", primitives.uv_sphere(1.2, 6, 8), material=m)
            bank = bb.finalize()
            cfg = W.WorldConfig(capacity=8, world_length=64.0,
                                section_length=8.0)
            w = W.create_world(cfg)
            w, _ = W.spawn_host(
                w, 2,
                position=np.array([[32.0, 32.0, 28.0], [32.0, 33.0, 30.5]],
                                  np.float32),
                model_id=np.array([0, -1], np.int32),
                sortable=np.array([0, R.SORTABLE_POINT], np.int32),
                light_diffuse=np.array([[0, 0, 0], [1.0, 1.0, 1.0]],
                                       np.float32),
                light_specular=np.array([[0, 0, 0], [1.0, 1.0, 1.0]],
                                        np.float32),
                light_atten=np.array([[0, 0], [0.05, 0.01]], np.float32),
            )
            w = K.refresh_transforms(w, bank.aabb_min, bank.aabb_max,
                                     jnp.asarray(w.alive))
            cam = (CameraBuilder().with_position(32.0, 32.0, 33.0)
                   .with_yaw_pitch_degrees(-90.0, 0.0).with_fov_degrees(70.0)
                   .with_aspect(4.0).with_near_far(0.1, 50.0)
                   .with_draw_distance(50.0).build())
            return w, bank, cam, atlas

        def settings(backend, fused):
            return RenderSettings(
                width=128, height=32, max_tris=256, backend=backend,
                raster=RasterConfig(tile_budget=48, max_tiles_per_tri=8,
                                    global_budget=16, chunk=4),
                max_point_lights=4, fused_shading=fused,
                texture_tile_budget=1.0)

        w_w, bank_w, cam, atlas_w = build(True)
        w_b, bank_b, _, atlas_b = build(False)
        outs_w, outs_b = [], []
        for backend, fused in (("jnp", False), ("tiled", False),
                               ("tiled", True)):
            s = settings(backend, fused)
            outs_w.append(np.asarray(
                render_frame(w_w, cam, bank_w, s, atlas=atlas_w)))
            outs_b.append(np.asarray(
                render_frame(w_b, cam, bank_b, s, atlas=atlas_b)))
        # white spec map keeps the strong highlight; black kills it
        for iw, ib in zip(outs_w, outs_b):
            assert iw.max() > ib.max() + 0.1
        # the three paths agree on both scenes
        for outs in (outs_w, outs_b):
            for o in outs[1:]:
                diff = np.abs(o - outs[0]).max(axis=-1)
                assert (diff > 0.03).mean() < 0.01
