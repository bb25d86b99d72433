"""The tiled Pallas frame path (interpret mode on CPU) vs the jnp path."""

import dataclasses

import numpy as np
import jax.numpy as jnp

from render_engine_tpu.ecs import registry as R
from render_engine_tpu.ecs import world as W
from render_engine_tpu.logic import kinematics as K
from render_engine_tpu.math.camera import CameraBuilder
from render_engine_tpu.models import primitives
from render_engine_tpu.models.bank import ModelBankBuilder
from render_engine_tpu.render import skybox as SB
from render_engine_tpu.render.frame import RenderSettings, render_frame
from render_engine_tpu.render.raster_jnp import RasterConfig

H, WIDTH = 32, 128


def scene():
    bb = ModelBankBuilder()
    red = bb.add_material(albedo=(1.0, 0.1, 0.1))
    glow = bb.add_material(albedo=(1.0, 0.9, 0.6), emissive=4.0)
    glass = bb.add_material(albedo=(0.2, 0.9, 0.4), alpha=0.4)
    cube = bb.add_model("cube", primitives.cube(1.5), material=red)
    star = bb.add_model("star", primitives.uv_sphere(0.7, 6, 8),
                        material=glow)
    pane = bb.add_model("pane", primitives.quad(2.0), material=glass)
    bank = bb.finalize()

    cfg = W.WorldConfig(capacity=16, world_length=128.0, section_length=16.0)
    w = W.create_world(cfg)
    w, _ = W.spawn_host(
        w, 4,
        position=np.array(
            [[62.0, 64.0, 58.0], [66.0, 64.0, 58.0],
             [64.0, 65.5, 57.0], [64.0, 64.0, 60.5]], np.float32),
        model_id=np.array([cube, star, cube, pane], np.int32),
        sortable=np.array(
            [0, R.SORTABLE_POINT, 0, 0], np.int32),
        light_diffuse=np.array(
            [[0, 0, 0], [1.0, 0.9, 0.8], [0, 0, 0], [0, 0, 0]], np.float32),
        light_atten=np.array(
            [[0, 0], [0.05, 0.01], [0, 0], [0, 0]], np.float32),
    )
    w = K.refresh_transforms(w, bank.aabb_min, bank.aabb_max,
                             jnp.asarray(w.alive))
    cam = (CameraBuilder().with_position(64.0, 64.0, 64.0)
           .with_yaw_pitch_degrees(-90.0, 0.0).with_fov_degrees(60.0)
           .with_aspect(WIDTH / H).with_near_far(0.1, 100.0)
           .with_draw_distance(100.0).build())
    return w, bank, cam


def settings(backend):
    return RenderSettings(
        width=WIDTH, height=H, max_tris=256, backend=backend,
        raster=RasterConfig(tile_budget=32, max_tiles_per_tri=8,
                            global_budget=16, chunk=4),
        max_point_lights=4, fused_shading=False,
    )


class TestTiledFramePath:
    def test_matches_jnp_path(self):
        w, bank, cam = scene()
        stars = SB.make_starfield(128, seed=5)
        img_p = np.asarray(render_frame(w, cam, bank, settings("tiled"),
                                        cubemap=stars))
        img_j = np.asarray(render_frame(w, cam, bank, settings("jnp"),
                                        cubemap=stars))
        assert img_p.shape == img_j.shape == (H, WIDTH, 3)
        # different implementations: allow shared-edge pixel flips, compare
        # the bulk of the image tightly
        diff = np.abs(img_p - img_j).max(axis=-1)
        assert (diff < 2e-2).mean() > 0.98, f"max diff {diff.max():.4f}"
        np.testing.assert_allclose(np.median(diff), 0.0, atol=1e-5)

    def test_tiled_path_emissive_and_transparency(self):
        w, bank, cam = scene()
        img = np.asarray(render_frame(w, cam, bank, settings("tiled")))
        assert np.isfinite(img).all()
        # emissive star visible at right of center (clipped bright)
        assert img.max() > 0.9
        # transparent pane tints the region it covers
        assert (img[..., 1] > img[..., 2]).any()

    def test_fused_shading_matches_tiled_path(self):
        """The fused interp+lighting kernel reproduces the XLA tall path.

        The scene's ONLY light is a point light (packed-table row after the
        empty dir segment), so this also guards the pack_lights prefix
        compaction: dropping it shows up as a large max diff over covered
        pixels, not just a few stray ones."""
        w, bank, cam = scene()
        stars = SB.make_starfield(128, seed=5)
        s = settings("tiled")
        s_fused = dataclasses.replace(s, fused_shading=True)
        img_a = np.asarray(render_frame(w, cam, bank, s, cubemap=stars))
        img_b = np.asarray(render_frame(w, cam, bank, s_fused,
                                        cubemap=stars))
        diff = np.abs(img_a - img_b).max(axis=-1)
        assert (diff < 1e-2).mean() > 0.995, f"max diff {diff.max():.4f}"
        # the bulk comparison above tolerates shared-edge flips; the max
        # bound below is what actually guarantees no light was dropped
        assert diff.max() < 0.05, (
            f"max diff {diff.max():.4f}: fused path diverges from XLA "
            "shading (dropped light?)")
        np.testing.assert_allclose(np.median(diff), 0.0, atol=1e-5)

    def test_varying_shininess_parity_and_effect(self):
        """Varying MTL Ns: the quantized (spec, Ns) packed channel keeps
        every path in agreement, and a higher exponent visibly tightens
        the highlight (less total specular energy at equal strength)."""
        def build(ns_a, ns_b):
            bb = ModelBankBuilder()
            ma = bb.add_material(albedo=(0.6, 0.6, 0.6), specular=2.0,
                                 shininess=ns_a)
            mb = bb.add_material(albedo=(0.6, 0.6, 0.6), specular=2.0,
                                 shininess=ns_b)
            cube_a = bb.add_model("a", primitives.cube(1.5), material=ma)
            cube_b = bb.add_model("b", primitives.cube(1.5), material=mb)
            bank = bb.finalize()
            cfg = W.WorldConfig(capacity=8, world_length=128.0,
                                section_length=16.0)
            w = W.create_world(cfg)
            w, _ = W.spawn_host(
                w, 3,
                position=np.array([[62.0, 64.0, 58.0], [66.0, 64.0, 58.0],
                                   [64.0, 66.0, 57.0]], np.float32),
                model_id=np.array([cube_a, cube_b, cube_a], np.int32),
                sortable=np.array([0, 0, R.SORTABLE_POINT], np.int32),
                light_diffuse=np.array(
                    [[0, 0, 0], [0, 0, 0], [1.0, 1.0, 1.0]], np.float32),
                light_specular=np.array(
                    [[0, 0, 0], [0, 0, 0], [1.0, 1.0, 1.0]], np.float32),
                light_atten=np.array(
                    [[0, 0], [0, 0], [0.02, 0.002]], np.float32),
            )
            w = K.refresh_transforms(w, bank.aabb_min, bank.aabb_max,
                                     jnp.asarray(w.alive))
            cam = (CameraBuilder().with_position(64.0, 64.0, 64.0)
                   .with_yaw_pitch_degrees(-90.0, 0.0)
                   .with_fov_degrees(60.0).with_aspect(WIDTH / H)
                   .with_near_far(0.1, 100.0)
                   .with_draw_distance(100.0).build())
            return w, bank, cam

        w, bank, cam = build(8.0, 512.0)
        assert bank.uniform_shininess() is None
        img_j = np.asarray(render_frame(w, cam, bank, settings("jnp")))
        img_p = np.asarray(render_frame(w, cam, bank, settings("tiled")))
        s_fused = dataclasses.replace(settings("tiled"),
                                      fused_shading=True)
        img_f = np.asarray(render_frame(w, cam, bank, s_fused))
        for other, name in ((img_p, "pallas"), (img_f, "fused")):
            diff = np.abs(img_j - other).max(axis=-1)
            assert (diff < 1e-2).mean() > 0.98, (
                f"{name} vs jnp max diff {diff.max():.4f}")
        # effect: same scene with BOTH cubes dull-wide (Ns 8) must carry
        # more specular energy than the mixed scene's Ns-512 cube region
        w2, bank2, _ = build(8.0, 8.0)
        img_w = np.asarray(render_frame(w2, cam, bank2, settings("jnp")))
        # right cube region (Ns 512 in mixed scene vs 8 in wide scene)
        assert img_w.sum() > img_j.sum() + 1e-3

    def test_tile_light_lists_bit_identical(self):
        """Per-tile light culling (light_tile_budget) is BIT-identical to
        the full per-tile light loop when no tile overflows: culled lights
        contribute exactly 0 (radius cutoff) and the list preserves table
        order. Scene: several radius-bounded point lights spread across
        the view + one directional (always in every list)."""
        w, bank, cam = scene()
        n = 4
        pos = np.array([[40.0, 64.0, 40.0], [90.0, 64.0, 40.0],
                        [64.0, 80.0, 50.0], [64.0, 50.0, 58.0]], np.float32)
        w, _ = W.spawn_host(
            w, n,
            position=pos,
            model_id=np.full(n, -1, np.int32),
            sortable=np.array([R.SORTABLE_POINT] * 3 + [R.SORTABLE_DIRECTIONAL],
                              np.int32),
            light_diffuse=np.tile(np.array([[0.9, 0.7, 0.5]], np.float32),
                                  (n, 1)),
            light_atten=np.tile(np.array([[0.05, 0.01]], np.float32),
                                (n, 1)),
            light_radius=np.array([12.0, 12.0, 9.0, 0.0], np.float32),
            light_direction=np.array(
                [[0, 0, 0], [0, 0, 0], [0, 0, 0], [0.3, -1.0, 0.2]],
                np.float32),
        )
        s = dataclasses.replace(settings("tiled"), fused_shading=True,
                                max_point_lights=8)
        s_tl = dataclasses.replace(s, light_tile_budget=8)
        a = np.asarray(render_frame(w, cam, bank, s))
        b = np.asarray(render_frame(w, cam, bank, s_tl))
        np.testing.assert_array_equal(a, b)

    def test_select_tile_lights_culls_and_counts(self):
        """The selection keeps a far-off bounded light out of most tiles,
        always includes dir/unbounded lights, and counts overflow exactly
        when the budget starves."""
        from render_engine_tpu.render import lighting as LG
        from render_engine_tpu.render.shade_pallas import (
            pack_lights,
            select_tile_lights,
        )

        w, bank, cam = scene()
        n = 3
        w, _ = W.spawn_host(
            w, n,
            # one light mid-view, one far outside the frustum, one dir
            position=np.array([[64.0, 64.0, 58.0], [64.0, 500.0, 64.0],
                               [0.0, 0.0, 0.0]], np.float32),
            model_id=np.full(n, -1, np.int32),
            sortable=np.array(
                [R.SORTABLE_POINT, R.SORTABLE_POINT,
                 R.SORTABLE_DIRECTIONAL], np.int32),
            light_diffuse=np.ones((n, 3), np.float32),
            light_atten=np.tile(np.array([[0.05, 0.01]], np.float32),
                                (n, 1)),
            light_radius=np.array([10.0, 10.0, 0.0], np.float32),
            light_direction=np.array(
                [[0, 0, 0], [0, 0, 0], [0.0, -1.0, 0.0]], np.float32),
        )
        s = settings("tiled")
        lights = LG.extract_lights(w, max_dir=4, max_point=8, max_spot=4)
        ltab, n_live = pack_lights(lights, 16)
        cfg = s.raster
        tiles_x = -(-WIDTH // cfg.tile_w)
        tiles_y = -(-H // cfg.tile_h)
        inv_pv = jnp.linalg.inv(cam.proj_view())
        tlist, tcount, dropped = select_tile_lights(
            ltab, n_live, cam.position, inv_pv, tiles_x, tiles_y,
            cfg.tile_h, cfg.tile_w, WIDTH, H, 0.0, budget=8)
        tc = np.asarray(tcount)
        # pre-existing scene point light (unbounded radius 0) + the dir
        # light + the unbounded... : every tile holds at least those
        # always-included lights
        assert (tc >= 2).all()
        # the 500-units-away bounded light reaches no tile: no tile lists
        # all 4 lights
        assert int(dropped) == 0
        assert tc.max() <= 3
        # starved budget: counts clamp and the overflow is reported
        _, tcount1, dropped1 = select_tile_lights(
            ltab, n_live, cam.position, inv_pv, tiles_x, tiles_y,
            cfg.tile_h, cfg.tile_w, WIDTH, H, 0.0, budget=1)
        assert np.asarray(tcount1).max() == 1
        assert int(dropped1) > 0

    def test_tiled_path_self_deterministic(self):
        w, bank, cam = scene()
        a = np.asarray(render_frame(w, cam, bank, settings("tiled")))
        b = np.asarray(render_frame(w, cam, bank, settings("tiled")))
        np.testing.assert_array_equal(a, b)

    def test_fused_shading_with_shadows_matches_tall_path(self):
        """Shadow-slot PCF factors inside the fused kernel reproduce the
        XLA tall path's make_shadow_factor result (opaque layer)."""
        from render_engine_tpu.render import shadows as SH

        w, bank, cam = scene()
        # render a shadow map for the scene's point light (row 1 entity)
        shadow = SH.create_shadow_state(resolution=64, budget=2)
        shadow = SH.render_shadow_map(shadow, w, cam, bank, max_tris=256,
                                      raster_cfg=settings("tiled").raster)
        s = settings("tiled")
        s_fused = dataclasses.replace(s, fused_shading=True)
        img_a = np.asarray(render_frame(w, cam, bank, s,
                                        shadow_state=shadow))
        img_b = np.asarray(render_frame(w, cam, bank, s_fused,
                                        shadow_state=shadow))
        diff = np.abs(img_a - img_b).max(axis=-1)
        assert diff.max() < 0.05, f"max diff {diff.max():.4f}"
        # and shadows actually darken something vs the no-shadow render
        img_ns = np.asarray(render_frame(w, cam, bank, s_fused))
        assert (img_b <= img_ns + 1e-5).all()

    def test_gather_tile_budgets_exact_when_unsaturated(self):
        """With tile budgets above actual occupancy, the compacted PCF and
        texture gathers reproduce the full-gather image exactly; a starved
        shadow budget only ever BRIGHTENS pixels (conservative-lit)."""
        from render_engine_tpu.render import shadows as SH

        w, bank, cam = scene()
        shadow = SH.create_shadow_state(resolution=64, budget=2)
        shadow = SH.render_shadow_map(shadow, w, cam, bank, max_tris=256,
                                      raster_cfg=settings("tiled").raster)
        s_full = dataclasses.replace(settings("tiled"), fused_shading=True)
        # the scene covers a minority of the 4 tiles; 0.75 is unsaturated
        s_budget = dataclasses.replace(s_full, shadow_tile_budget=0.75,
                                       texture_tile_budget=0.75)
        a = np.asarray(render_frame(w, cam, bank, s_full,
                                    shadow_state=shadow))
        b = np.asarray(render_frame(w, cam, bank, s_budget,
                                    shadow_state=shadow))
        np.testing.assert_allclose(a, b, atol=1e-6)
        # starved budget: shadows degrade to lit, never darker
        s_starved = dataclasses.replace(s_full, shadow_tile_budget=0.01)
        c = np.asarray(render_frame(w, cam, bank, s_starved,
                                    shadow_state=shadow))
        assert (c >= a - 1e-5).all()
