"""Render-system API tests: builder contract, multi-system G-buffer merge,
unlit emissive boost, per-system model routing."""

import jax.numpy as jnp
import numpy as np
import pytest

from render_engine_tpu.ecs import world as W
from render_engine_tpu.logic import kinematics as K
from render_engine_tpu.math.camera import CameraBuilder
from render_engine_tpu.models import primitives
from render_engine_tpu.models.bank import ModelBankBuilder
from render_engine_tpu.render.frame import RenderSettings
from render_engine_tpu.render.raster_jnp import RasterConfig
from render_engine_tpu.render.render_system import (
    RenderSystemBuilder,
    render_frame_systems,
)

H, WIDTH = 32, 128


def scene():
    bb = ModelBankBuilder()
    red = bb.add_material(albedo=(1.0, 0.0, 0.0))
    glow = bb.add_material(albedo=(0.5, 0.5, 0.5))
    cube = bb.add_model("cube", primitives.cube(1.5), material=red)
    star = bb.add_model("star", primitives.cube(1.5), material=glow)
    bank = bb.finalize()

    cfg = W.WorldConfig(capacity=8, world_length=128.0, section_length=16.0)
    w = W.create_world(cfg)
    w, _ = W.spawn_host(
        w, 2,
        position=np.array([[62.0, 64.0, 59.0], [66.0, 64.0, 59.0]],
                          np.float32),
        model_id=np.array([cube, star], np.int32),
    )
    w = K.refresh_transforms(w, bank.aabb_min, bank.aabb_max,
                             jnp.asarray(w.alive))
    cam = (CameraBuilder().with_position(64.0, 64.0, 64.0)
           .with_yaw_pitch_degrees(-90.0, 0.0).with_fov_degrees(60.0)
           .with_aspect(WIDTH / H).with_near_far(0.1, 100.0)
           .with_draw_distance(100.0).build())
    return w, bank, cam, cube, star


SETTINGS = RenderSettings(
    width=WIDTH, height=H, max_tris=64, backend="jnp",
    raster=RasterConfig(tile_budget=16, max_tiles_per_tri=8, global_budget=8,
                        chunk=4),
)


class TestBuilder:
    def test_requires_models(self):
        with pytest.raises(ValueError):
            RenderSystemBuilder("empty").build()

    def test_uniform_type_check(self):
        b = RenderSystemBuilder("x").with_models(0)
        with pytest.raises(TypeError):
            b.write_uniform("bad", object())
        b.write_uniform("brightness", 6.0)
        assert b.build().uniforms == (("brightness", 6.0),)

    def test_chain(self):
        rs = (RenderSystemBuilder("stars").with_models(1)
              .with_lighting(False).with_emissive_boost(6.0)
              .with_levels_of_view(False).build())
        assert rs.emissive_boost == 6.0 and not rs.lit and not rs.casts_lov


class TestMultiSystem:
    def test_two_systems_share_gbuffer(self):
        w, bank, cam, cube, star = scene()
        lit = RenderSystemBuilder("default").with_models(cube).build()
        stars = (RenderSystemBuilder("stars").with_models(star)
                 .with_lighting(False).with_emissive_boost(6.0).build())
        img = np.asarray(render_frame_systems(
            w, cam, bank, (lit, stars), SETTINGS))
        # cube center projects to ~px 53, star center to ~px 84
        left = img[H // 2, 50]
        assert left[0] > 0.0 and left[1] == 0.0  # red under diffuse floor
        # unlit boosted star — gray * 6 clipped to 1
        right = img[H // 2, 75]
        np.testing.assert_allclose(right, [1.0, 1.0, 1.0], atol=1e-5)

    def test_system_model_routing(self):
        """A system only draws its own models."""
        w, bank, cam, cube, star = scene()
        only_cube = RenderSystemBuilder("c").with_models(cube).build()
        img = np.asarray(render_frame_systems(
            w, cam, bank, (only_cube,), SETTINGS))
        right = img[H // 2, 75]
        assert right.sum() == 0.0  # star not drawn

    def test_single_system_matches_filter(self):
        w, bank, cam, cube, star = scene()
        both = RenderSystemBuilder("all").with_models(cube, star).build()
        img = np.asarray(render_frame_systems(
            w, cam, bank, (both,), SETTINGS))
        assert img[H // 2, 50].sum() > 0
        assert img[H // 2, 75].sum() > 0


class TestGoldenPathCallbacks:
    """DrawParam / custom shading / uniforms on render_frame_systems (the
    multi-system golden path) — same contracts as the compiled fast path."""

    def test_draw_callback_gates_and_skybox(self):
        w, bank, cam, cube, star = scene()
        white_sky = jnp.ones((6, 4, 4, 3), jnp.float32)

        def draw(dp):
            dp.draw_models(cube)  # star bound but not submitted
            dp.draw_skybox(False)

        sys_ = (RenderSystemBuilder("all").with_models(cube, star)
                .with_draw_function(draw).build())
        img = np.asarray(render_frame_systems(
            w, cam, bank, (sys_,), SETTINGS, cubemap=white_sky))
        assert (img[:, :WIDTH // 2, 0] > 0.0).any()  # cube drew
        assert img[0, 0].sum() == 0.0  # skybox toggled off -> clear

    def test_tint_uniform_applies(self):
        w, bank, cam, cube, star = scene()
        sys_ = (RenderSystemBuilder("all").with_models(cube, star)
                .write_uniform("albedo_tint", (0.0, 0.0, 1.0)).build())
        base = (RenderSystemBuilder("all").with_models(cube, star).build())
        a = np.asarray(render_frame_systems(w, cam, bank, (sys_,), SETTINGS))
        b = np.asarray(render_frame_systems(w, cam, bank, (base,), SETTINGS))
        # the tint kills the cube's red channel
        assert (b[:, :WIDTH // 2, 0] > a[:, :WIDTH // 2, 0] + 0.01).any()

    def test_custom_shading_on_own_pixels(self):
        w, bank, cam, cube, star = scene()

        def flat_green(sp):
            c = jnp.asarray(sp.uniforms["flat_rgb"], jnp.float32)
            return jnp.broadcast_to(c, sp.base_color.shape)

        shaded = (RenderSystemBuilder("n").with_models(cube)
                  .write_uniform("flat_rgb", (0.0, 1.0, 0.0))
                  .with_fragment_shading(flat_green).build())
        plain = RenderSystemBuilder("s").with_models(star).build()
        img = np.asarray(render_frame_systems(
            w, cam, bank, (shaded, plain), SETTINGS))
        cube_px = img[H // 2, 50]
        np.testing.assert_allclose(cube_px, [0.0, 1.0, 0.0], atol=1e-5)
        # the star system keeps default shading (gray, not green-only)
        star_region = img[:, WIDTH // 2:]
        assert (star_region[..., 0] > 0.0).any()


class TestCompiledSystems:
    """The Engine-integrated fast path: systems as data on one fused pass."""

    def _pallas_settings(self):
        return RenderSettings(
            width=WIDTH, height=H, max_tris=64, backend="tiled",
            fused_shading=False,
            raster=RasterConfig(tile_budget=16, max_tiles_per_tri=8,
                                global_budget=8, chunk=4),
        )

    def test_identity_systems_match_no_systems(self):
        from render_engine_tpu.render.frame import render_frame
        from render_engine_tpu.render.render_system import compile_systems

        w, bank, cam, cube, star = scene()
        ident = compile_systems(
            (RenderSystemBuilder("all")
             .with_models(*range(bank.num_models)).build(),), bank)
        s = self._pallas_settings()
        a = np.asarray(render_frame(w, cam, bank, s))
        b = np.asarray(render_frame(w, cam, bank, s, systems=ident))
        np.testing.assert_array_equal(a, b)

    def test_unrouted_models_not_drawn(self):
        from render_engine_tpu.render.frame import render_frame
        from render_engine_tpu.render.render_system import compile_systems

        w, bank, cam, cube, star = scene()
        only_star = compile_systems(
            (RenderSystemBuilder("s").with_models(star).build(),), bank)
        s = self._pallas_settings()
        img = np.asarray(render_frame(w, cam, bank, s, systems=only_star))
        # the red cube (left half) is not bound to any system -> background
        assert not (img[:, :WIDTH // 2, 0] > 0.3).any()
        # the star (right half) still draws (at the no-light diffuse
        # floor: 0.08 * albedo 0.5 = 0.04)
        assert (img[:, WIDTH // 2:, :] > 0.03).any()

    def test_unlit_boost_and_tint_uniform(self):
        from render_engine_tpu.render.frame import render_frame
        from render_engine_tpu.render.render_system import compile_systems

        w, bank, cam, cube, star = scene()
        systems = compile_systems((
            RenderSystemBuilder("lit").with_models(cube)
            .write_uniform("albedo_tint", (0.0, 0.0, 1.0)).build(),
            RenderSystemBuilder("glow").with_models(star)
            .with_lighting(False).with_emissive_boost(0.5).build(),
        ), bank)
        s = self._pallas_settings()
        img = np.asarray(render_frame(w, cam, bank, s, systems=systems))
        base = np.asarray(render_frame(w, cam, bank, s))
        # tint kills the cube's red channel
        assert (base[:, :WIDTH // 2, 0] > img[:, :WIDTH // 2, 0] + 0.01).any()
        # unlit star = albedo * 0.5 exactly where covered
        star_region = img[:, WIDTH // 2:, :]
        got = star_region[star_region[..., 0] > 0.1]
        if got.size:
            np.testing.assert_allclose(got[:, 0], 0.25, atol=1e-3)

    def test_unknown_uniform_rejected(self):
        from render_engine_tpu.render.render_system import compile_systems

        w, bank, cam, cube, star = scene()
        sys_ = (RenderSystemBuilder("x").with_models(cube)
                .write_uniform("brightness", 6.0).build())
        with pytest.raises(ValueError, match="unknown uniform"):
            compile_systems((sys_,), bank)

    def test_model_in_two_systems_rejected(self):
        from render_engine_tpu.render.render_system import compile_systems

        w, bank, cam, cube, star = scene()
        with pytest.raises(ValueError, match="two render systems"):
            compile_systems((
                RenderSystemBuilder("a").with_models(cube).build(),
                RenderSystemBuilder("b").with_models(cube).build(),
            ), bank)

    def test_draw_callback_gates_instances(self):
        """A system with a draw callback renders ONLY what the callback
        draws that frame (the reference renders only what the user's draw
        fn submits, render_system.rs:410-595): drawing just the cube makes
        the star vanish even though it is bound to the system."""
        from render_engine_tpu.render.frame import render_frame
        from render_engine_tpu.render.render_system import compile_systems

        w, bank, cam, cube, star = scene()

        def draw_cube_only(dp):
            dp.draw_models(cube)

        systems = compile_systems(
            (RenderSystemBuilder("all").with_models(cube, star)
             .with_draw_function(draw_cube_only).build(),), bank)
        img = np.asarray(render_frame(w, cam, bank, SETTINGS,
                                      systems=systems))
        assert (img[:, :WIDTH // 2, 0] > 0.0).any()  # cube drew
        assert img[:, WIDTH // 2:, :].sum() == 0.0  # star not submitted

    def test_draw_callback_traced_when_gate(self):
        """``when=`` takes traced conditions: the same compiled program
        draws or skips based on camera state, no retrace."""
        from render_engine_tpu.render.frame import render_frame
        from render_engine_tpu.render.render_system import compile_systems

        w, bank, cam, cube, star = scene()

        def draw_conditional(dp):
            # camera x > 100 is False for the scene camera (x = 64)
            dp.draw_models(cube, when=dp.get_camera().position[0] > 100.0)
            dp.draw_models(star, when=dp.get_camera().position[0] > 0.0)

        systems = compile_systems(
            (RenderSystemBuilder("all").with_models(cube, star)
             .with_draw_function(draw_conditional).build(),), bank)
        img = np.asarray(render_frame(w, cam, bank, SETTINGS,
                                      systems=systems))
        assert img[:, :WIDTH // 2, :].sum() == 0.0  # cube gated off
        assert (img[:, WIDTH // 2:, :] > 0.0).any()  # star gated on

    def test_draw_callback_sortable_filter(self):
        """draw_models(sortable=...) renders only instances in the given
        sortable buckets (the component_indexes filter of
        draw_model_with_sortable_index, rendering.rs:270-386)."""
        from render_engine_tpu.render.frame import render_frame
        from render_engine_tpu.render.render_system import compile_systems

        w, bank, cam, cube, star = scene()
        w = w.replace(sortable=jnp.asarray([3, 7] + [0] * (w.capacity - 2),
                                           jnp.int32))

        def draw_bucket3(dp):
            dp.draw_models(cube, star, sortable=3)

        systems = compile_systems(
            (RenderSystemBuilder("all").with_models(cube, star)
             .with_draw_function(draw_bucket3).build(),), bank)
        img = np.asarray(render_frame(w, cam, bank, SETTINGS,
                                      systems=systems))
        assert (img[:, :WIDTH // 2, 0] > 0.0).any()  # bucket 3 (cube)
        assert img[:, WIDTH // 2:, :].sum() == 0.0  # bucket 7 filtered

    def test_per_frame_uniform_write_matches_static(self):
        """A traced write_uniform('albedo_tint') equals the same tint
        compiled statically."""
        from render_engine_tpu.render.frame import render_frame
        from render_engine_tpu.render.render_system import compile_systems

        w, bank, cam, cube, star = scene()

        def tint_blue(dp):
            dp.draw_models(cube, star)
            # traced value: the tint comes from device data
            one = jnp.minimum(dp.get_ecs()["position"][0, 0] / 62.0, 1.0)
            dp.write_uniform("albedo_tint", jnp.stack(
                [one * 0.0, one * 0.0, one]))

        dyn = compile_systems(
            (RenderSystemBuilder("all").with_models(cube, star)
             .with_draw_function(tint_blue).build(),), bank)
        static = compile_systems(
            (RenderSystemBuilder("all").with_models(cube, star)
             .write_uniform("albedo_tint", (0.0, 0.0, 1.0)).build(),), bank)
        a = np.asarray(render_frame(w, cam, bank, SETTINGS, systems=dyn))
        b = np.asarray(render_frame(w, cam, bank, SETTINGS, systems=static))
        np.testing.assert_allclose(a, b, atol=1e-6)

    def test_per_frame_emissive_boost_replaces_buildtime_uniform(self):
        """write_uniform('emissive_boost', v) REPLACES a build-time
        emissive_boost uniform (GL uniform-write semantics): a system
        compiled with uniform 4.0 then written 0.5 per frame renders
        exactly like one compiled with 0.5 — on render_frame (fused
        draw-callback path) AND render_frame_systems (golden path)."""
        from render_engine_tpu.render.frame import render_frame
        from render_engine_tpu.render.render_system import compile_systems

        w, bank, cam, cube, star = scene()

        def mk(build_uniform, write):
            def draw(dp):
                dp.draw_models(cube, star)
                if write is not None:
                    dp.write_uniform("emissive_boost", jnp.float32(write))
            b = (RenderSystemBuilder("glow").with_models(cube, star)
                 .with_lighting(False).with_emissive_boost(2.0)
                 .with_draw_function(draw))
            if build_uniform is not None:
                b = b.write_uniform("emissive_boost", build_uniform)
            return compile_systems((b.build(),), bank)

        overwritten = mk(4.0, 0.5)   # build-time 4.0, per-frame 0.5
        direct = mk(0.5, None)       # compiled straight at 0.5
        a = np.asarray(render_frame(w, cam, bank, SETTINGS,
                                    systems=overwritten))
        b = np.asarray(render_frame(w, cam, bank, SETTINGS, systems=direct))
        np.testing.assert_allclose(a, b, atol=1e-6)
        ga = np.asarray(render_frame_systems(
            w, cam, bank, overwritten.src, SETTINGS))
        gb = np.asarray(render_frame_systems(
            w, cam, bank, direct.src, SETTINGS))
        np.testing.assert_allclose(ga, gb, atol=1e-6)
        np.testing.assert_allclose(a, ga, atol=1e-5)

    def test_draw_skybox_toggle(self):
        """DrawParam.draw_skybox(False) blanks the skybox to the clear
        color for that frame (toggle_rendering_skybox, rendering.rs:57-64),
        on both the XLA and the tiled Pallas path."""
        from render_engine_tpu.render.frame import render_frame
        from render_engine_tpu.render.render_system import compile_systems

        w, bank, cam, cube, star = scene()
        white_sky = jnp.ones((6, 4, 4, 3), jnp.float32)

        def build(skybox_on):
            def draw(dp):
                dp.draw_models(cube, star)
                dp.draw_skybox(skybox_on)
            return compile_systems(
                (RenderSystemBuilder("all").with_models(cube, star)
                 .with_draw_function(draw).build(),), bank)

        for settings in (SETTINGS, self._pallas_settings()):
            on = np.asarray(render_frame(w, cam, bank, settings,
                                         cubemap=white_sky,
                                         systems=build(True)))
            off = np.asarray(render_frame(w, cam, bank, settings,
                                          cubemap=white_sky,
                                          systems=build(False)))
            assert on[0, 0].sum() > 2.9  # white sky corner
            assert off[0, 0].sum() == 0.0  # clear color

    def test_draw_callback_input_gating(self):
        """Draw callbacks read the frame's input history through the
        engine (get_input_history, rendering.rs:234-237): a key held makes
        the system draw, released makes it vanish — same compiled program."""
        from render_engine_tpu.render.frame import render_frame
        from render_engine_tpu.render.render_system import compile_systems
        from render_engine_tpu.logic.types import InputState, KEY_W

        w, bank, cam, cube, star = scene()

        def draw_on_w(dp):
            inp = dp.get_input_history()
            dp.draw_models(cube, star, when=inp.keys[KEY_W])

        systems = compile_systems(
            (RenderSystemBuilder("all").with_models(cube, star)
             .with_draw_function(draw_on_w).build(),), bank)
        held = np.asarray(render_frame(
            w, cam, bank, SETTINGS, systems=systems,
            inputs=InputState.idle(0).with_keys(KEY_W)))
        released = np.asarray(render_frame(
            w, cam, bank, SETTINGS, systems=systems,
            inputs=InputState.idle(1)))
        assert (held > 0.0).any()
        assert released.sum() == 0.0

    def test_draw_unbound_model_rejected(self):
        from render_engine_tpu.render.frame import render_frame
        from render_engine_tpu.render.render_system import compile_systems

        w, bank, cam, cube, star = scene()

        def draw_wrong(dp):
            dp.draw_models(star)

        systems = compile_systems(
            (RenderSystemBuilder("c").with_models(cube)
             .with_draw_function(draw_wrong).build(),), bank)
        with pytest.raises(ValueError, match="not bound"):
            render_frame(w, cam, bank, SETTINGS, systems=systems)

    def test_draw_unknown_uniform_rejected(self):
        from render_engine_tpu.render.frame import render_frame
        from render_engine_tpu.render.render_system import compile_systems

        w, bank, cam, cube, star = scene()

        def draw_bad(dp):
            dp.draw_models(cube)
            dp.write_uniform("nonsense", 1.0)

        systems = compile_systems(
            (RenderSystemBuilder("c").with_models(cube)
             .with_draw_function(draw_bad).build(),), bank)
        with pytest.raises(ValueError, match="unknown uniform"):
            render_frame(w, cam, bank, SETTINGS, systems=systems)

    def test_custom_fragment_shading_applies(self):
        """A with_fragment_shading fn replaces the default deferred shading
        for ITS system's pixels only (the user shader-body half of the
        reference's DSL, system_information.rs:486-559): the cube system
        renders normal-visualization colors while the star system keeps the
        default result."""
        from render_engine_tpu.render.frame import render_frame
        from render_engine_tpu.render.render_system import compile_systems

        w, bank, cam, cube, star = scene()

        def show_normals(sp):
            return 0.5 * (sp.normal + 1.0)

        systems = compile_systems((
            RenderSystemBuilder("n").with_models(cube)
            .with_fragment_shading(show_normals).build(),
            RenderSystemBuilder("s").with_models(star).build(),
        ), bank)
        base = compile_systems((
            RenderSystemBuilder("n").with_models(cube).build(),
            RenderSystemBuilder("s").with_models(star).build(),
        ), bank)
        img = np.asarray(render_frame(w, cam, bank, SETTINGS,
                                      systems=systems))
        ref = np.asarray(render_frame(w, cam, bank, SETTINGS, systems=base))
        # cube faces the camera: normal ~(0,0,1) -> rgb ~(0.5, 0.5, 1.0)
        cube_px = img[H // 2, 50]
        np.testing.assert_allclose(cube_px, [0.5, 0.5, 1.0], atol=1e-3)
        # star pixels identical to the default-shaded reference
        np.testing.assert_array_equal(img[:, WIDTH // 2:],
                                      ref[:, WIDTH // 2:])

    def test_custom_shading_reads_uniforms(self):
        """Arbitrary uniform names flow to ShadeParam.uniforms — both
        build-time constants and per-frame DrawParam writes (traced)."""
        from render_engine_tpu.render.frame import render_frame
        from render_engine_tpu.render.render_system import compile_systems

        w, bank, cam, cube, star = scene()

        def flat_color(sp):
            c = jnp.asarray(sp.uniforms["flat_rgb"], jnp.float32)
            return jnp.broadcast_to(c, sp.base_color.shape)

        static = compile_systems((
            RenderSystemBuilder("f").with_models(cube, star)
            .write_uniform("flat_rgb", (0.0, 1.0, 0.0))
            .with_fragment_shading(flat_color).build(),), bank)
        img = np.asarray(render_frame(w, cam, bank, SETTINGS,
                                      systems=static))
        covered = img.sum(axis=-1) > 0
        assert covered.any()
        np.testing.assert_allclose(img[covered],
                                   [[0.0, 1.0, 0.0]] * covered.sum(),
                                   atol=1e-6)

        def draw(dp):
            dp.draw_models(cube, star)
            # traced per-frame value
            dp.write_uniform("flat_rgb", jnp.stack(
                [dp.get_camera().position[0] * 0.0,
                 jnp.float32(0.0), jnp.float32(1.0)]))

        dyn = compile_systems((
            RenderSystemBuilder("f").with_models(cube, star)
            .write_uniform("flat_rgb", (0.0, 1.0, 0.0))  # overridden
            .with_draw_function(draw)
            .with_fragment_shading(flat_color).build(),), bank)
        img2 = np.asarray(render_frame(w, cam, bank, SETTINGS, systems=dyn))
        np.testing.assert_allclose(img2[covered],
                                   [[0.0, 0.0, 1.0]] * covered.sum(),
                                   atol=1e-6)

    def test_custom_shading_tiled_matches_jnp(self):
        """The tiled Pallas (non-fused) path applies custom shading in its
        tall layout; results match the jnp golden path."""
        from render_engine_tpu.render.frame import render_frame
        from render_engine_tpu.render.render_system import compile_systems

        w, bank, cam, cube, star = scene()

        def warm(sp):
            return jnp.clip(sp.base_color * jnp.asarray([1.5, 1.0, 0.5]),
                            0.0, 1.0)

        systems = compile_systems((
            RenderSystemBuilder("w").with_models(cube, star)
            .with_fragment_shading(warm).build(),), bank)
        a = np.asarray(render_frame(w, cam, bank, SETTINGS,
                                    systems=systems))
        b = np.asarray(render_frame(w, cam, bank, self._pallas_settings(),
                                    systems=systems))
        np.testing.assert_allclose(a, b, atol=2e-3)

    def _fused_settings(self):
        return RenderSettings(
            width=WIDTH, height=H, max_tris=64, backend="tiled",
            fused_shading=True,
            raster=RasterConfig(tile_budget=16, max_tiles_per_tri=8,
                                global_budget=8, chunk=4),
        )

    def test_custom_shading_fused_matches_jnp(self):
        """Custom fragment shading runs ON the fused Pallas path (the
        production kernel) as a post-kernel hook and matches the XLA
        golden path — user shader bodies stay in THE pipeline like the
        reference's codegen splice (initialize_logic.rs:137-185)."""
        from render_engine_tpu.render.frame import render_frame
        from render_engine_tpu.render.render_system import compile_systems

        w, bank, cam, cube, star = scene()

        def fancy(sp):
            tone = jnp.asarray(sp.uniforms["tone"], jnp.float32)
            n = 0.5 * (sp.normal + 1.0)
            return jnp.clip(sp.base_color * tone + 0.2 * sp.albedo * n,
                            0.0, 1.0)

        systems = compile_systems((
            RenderSystemBuilder("w").with_models(cube, star)
            .write_uniform("tone", 0.8)
            .with_fragment_shading(fancy).build(),), bank)
        a = np.asarray(render_frame(w, cam, bank, SETTINGS,
                                    systems=systems))
        b = np.asarray(render_frame(w, cam, bank, self._fused_settings(),
                                    systems=systems))
        np.testing.assert_allclose(a, b, atol=2e-3)

    def test_custom_shading_fused_own_pixels_only(self):
        """On the fused path a shade fn rewrites only ITS system's pixels;
        the other system's pixels are bit-identical to a plain fused
        render."""
        from render_engine_tpu.render.frame import render_frame
        from render_engine_tpu.render.render_system import compile_systems

        w, bank, cam, cube, star = scene()

        def flat_green(sp):
            return jnp.broadcast_to(
                jnp.asarray([0.0, 1.0, 0.0], jnp.float32),
                sp.base_color.shape)

        shaded = compile_systems((
            RenderSystemBuilder("n").with_models(cube)
            .with_fragment_shading(flat_green).build(),
            RenderSystemBuilder("s").with_models(star).build(),
        ), bank)
        plain = compile_systems((
            RenderSystemBuilder("n").with_models(cube).build(),
            RenderSystemBuilder("s").with_models(star).build(),
        ), bank)
        s = self._fused_settings()
        img = np.asarray(render_frame(w, cam, bank, s, systems=shaded))
        ref = np.asarray(render_frame(w, cam, bank, s, systems=plain))
        # cube (left half) turned flat green where covered
        cube_cov = ref[:, :WIDTH // 2].sum(axis=-1) > 0
        assert cube_cov.any()
        np.testing.assert_allclose(
            img[:, :WIDTH // 2][cube_cov],
            [[0.0, 1.0, 0.0]] * int(cube_cov.sum()), atol=1e-6)
        # star half untouched
        np.testing.assert_array_equal(img[:, WIDTH // 2:],
                                      ref[:, WIDTH // 2:])

    def test_custom_shading_transparent_layer_all_paths(self):
        """User shader bodies shade the TRANSPARENT forward pass too (the
        reference's user transparency draw runs through the same generated
        program, render_system.rs:501): a shade fn visibly rewrites
        transparent pixels, identically on the jnp golden, tiled Pallas,
        and fused Pallas paths."""
        from render_engine_tpu.render.frame import render_frame
        from render_engine_tpu.render.render_system import compile_systems

        bb = ModelBankBuilder()
        solid = bb.add_material(albedo=(0.3, 0.3, 0.3))
        glass = bb.add_material(albedo=(0.2, 0.9, 0.4), alpha=0.5)
        cube = bb.add_model("cube", primitives.cube(1.5), material=solid)
        pane = bb.add_model("pane", primitives.quad(2.5), material=glass)
        bank = bb.finalize()
        cfg = W.WorldConfig(capacity=8, world_length=128.0,
                            section_length=16.0)
        w = W.create_world(cfg)
        w, _ = W.spawn_host(
            w, 2,
            position=np.array([[64.0, 64.0, 57.0], [64.0, 64.0, 60.0]],
                              np.float32),
            model_id=np.array([cube, pane], np.int32),
        )
        w = K.refresh_transforms(w, bank.aabb_min, bank.aabb_max,
                                 jnp.asarray(w.alive))
        cam = (CameraBuilder().with_position(64.0, 64.0, 64.0)
               .with_yaw_pitch_degrees(-90.0, 0.0).with_fov_degrees(60.0)
               .with_aspect(WIDTH / H).with_near_far(0.1, 100.0)
               .with_draw_distance(100.0).build())

        def magenta(sp):
            return jnp.broadcast_to(
                jnp.asarray([1.0, 0.0, 1.0], jnp.float32),
                sp.base_color.shape)

        shaded = compile_systems((
            RenderSystemBuilder("g").with_models(cube, pane)
            .with_fragment_shading(magenta).build(),), bank)
        plain = compile_systems((
            RenderSystemBuilder("g").with_models(cube, pane).build(),),
            bank)

        imgs = {}
        for name, s in (("jnp", SETTINGS),
                        ("pallas", self._pallas_settings()),
                        ("fused", self._fused_settings())):
            imgs[name] = np.asarray(render_frame(w, cam, bank, s,
                                                 systems=shaded))
        ref = np.asarray(render_frame(w, cam, bank, SETTINGS,
                                      systems=plain))
        # the pane covers the screen center in front of the cube; with the
        # opaque cube AND the pane both shaded magenta, a blended pixel is
        # 0.5*magenta + 0.5*magenta = pure magenta. Without transparent
        # shading it would blend magenta with the pane's green lit color.
        cy, cx = H // 2, WIDTH // 2
        for name in ("jnp", "pallas", "fused"):
            np.testing.assert_allclose(imgs[name][cy, cx], [1.0, 0.0, 1.0],
                                       atol=1e-5, err_msg=name)
        assert not np.allclose(ref[cy, cx], [1.0, 0.0, 1.0], atol=0.1)
        # different rasterizers flip exact shared-edge FP ties (the pane
        # quad's diagonal); compare the bulk tightly like the other
        # cross-path tests
        for name in ("pallas", "fused"):
            diff = np.abs(imgs["jnp"] - imgs[name]).max(axis=-1)
            assert (diff < 2e-3).mean() > 0.99, (
                f"{name}: max diff {diff.max():.4f}")
            np.testing.assert_allclose(np.median(diff), 0.0, atol=1e-5)

    def test_engine_demo_uses_systems(self, engine_factory):
        from render_engine_tpu.logic.types import InputState

        eng = engine_factory(width=128, height=32, capacity=64,
                             num_asteroids=6, max_tris=2048)
        eng.config.record_history = False
        assert eng.compiled_systems is not None
        assert eng.compiled_systems.names == ("default", "light_sources")
        img = eng.frame(InputState.idle(0), render=True)
        assert np.isfinite(np.asarray(img)).all()
        # the star (unlit boost 6 on emissive-1 material) saturates
        assert float(np.asarray(img).max()) > 0.9
