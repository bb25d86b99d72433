"""Engine-level integration: demo scene rendering, shadows enabled, image
determinism across engine instances."""

import numpy as np

from render_engine_tpu.demo.space_scene import space_config
from render_engine_tpu.logic.types import InputState, KEY_W
from render_engine_tpu.math.camera import CameraBuilder
from render_engine_tpu.runtime.engine import Engine

# same kwargs as test_replay.ENGINE_KW so the session-scoped engine cache
# shares one build across both modules
KW = dict(width=128, height=32, capacity=128, num_asteroids=10,
          max_tris=2048)


class TestDemoScene:
    def test_scene_population(self, engine_factory):
        eng = engine_factory(**KW)
        alive = int(np.asarray(eng.world.alive).sum())
        # 2 stars + 10 asteroids + wormhole + producer + station + user
        assert alive == 16

    def test_frame_renders_finite_image(self, engine_factory):
        eng = engine_factory(**KW)
        eng.config.record_history = False
        img = eng.frame(InputState.idle(0).with_keys(KEY_W), 1 / 30)
        a = np.asarray(img)
        assert a.shape == (32, 128, 3)
        assert np.isfinite(a).all()
        assert a.max() > 0.01  # skybox stars at least

    def test_image_deterministic_across_engines(self, engine_factory):
        a = engine_factory(**KW)
        b = engine_factory(slot=1, **KW)
        for e in (a, b):
            e.config.record_history = False
        ia = a.frame(InputState.idle(0), 1 / 30)
        ib = b.frame(InputState.idle(0), 1 / 30)
        np.testing.assert_array_equal(np.asarray(ia), np.asarray(ib))

    def test_mine_producer_spawns_over_time(self, engine_factory):
        eng = engine_factory(**KW)
        eng.config.record_history = False
        before = int(np.asarray(eng.world.alive).sum())
        # producer fires every MINE_SPAWN_PERIOD=4s; 5 frames of 1s
        for i in range(5):
            eng.frame(InputState.idle(i), dt=1.0, render=False)
        after = int(np.asarray(eng.world.alive).sum())
        assert after > before


class TestEngineShadows:
    def test_shadowed_frame_runs(self):
        cfg = space_config(**KW)
        cfg.enable_shadows = True
        cfg.shadow_resolution = 64
        cfg.shadow_max_tris = 1024
        camera = (
            CameraBuilder().with_position(1000.0, 1000.0, 1150.0)
            .with_yaw_pitch_degrees(-90.0, 0.0).with_fov_degrees(60.0)
            .with_aspect(4.0).with_near_far(0.5, 2000.0)
            .with_draw_distance(1500.0).build()
        )
        eng = Engine(cfg, camera=camera)
        eng.config.record_history = False
        img = eng.frame(InputState.idle(0), 1 / 30)
        assert np.isfinite(np.asarray(img)).all()
        assert eng.shadow_state is not None
        # a second frame rotates the round-robin cursor
        c0 = int(eng.shadow_state.cursor)
        eng.frame(InputState.idle(1), 1 / 30)
        assert int(eng.shadow_state.cursor) == c0 + 1

    def test_run_frames_rendered_matches_per_frame(self, engine_factory):
        """The scan-batched rendered loop (one dispatch for N frames)
        follows the same trajectory as N per-frame fused dispatches. The
        programs compile separately so XLA may round differently; compare
        with tolerance, not bit-equality (recorded runs never scan)."""
        a = engine_factory(**KW)
        b = engine_factory(slot=1, **KW)
        for e in (a, b):
            e.config.record_history = False
        n = 4
        ins = [InputState.idle(i).with_keys(KEY_W) for i in range(n)]
        img_a = None
        for i in range(n):
            img_a = a.frame(ins[i], 1 / 30)
        img_b = b.run_frames_rendered(ins, [1 / 30] * n)
        np.testing.assert_allclose(
            np.asarray(a.world["position"]), np.asarray(b.world["position"]),
            atol=1e-4)
        assert b.frame_index == n
        da = np.asarray(img_a)
        db = np.asarray(img_b)
        assert da.shape == db.shape
        # PCF/coverage thresholds can flip isolated pixels between the two
        # compilations; the images must agree except at such knife edges
        assert (np.abs(da - db) > 1e-2).mean() < 0.01

    def test_run_frames_rendered_updates_drop_counters(self, engine_factory):
        """The scan path must not leave _last_drops stale: drop_stats after
        run_frames_rendered reflects the scanned frames' step counters."""
        eng = engine_factory(**KW)
        eng.config.record_history = False
        ins = [InputState.idle(i) for i in range(3)]
        eng.run_frames_rendered(ins, [1 / 30] * 3)
        d = eng.drop_stats()
        # step counters present (values are scene-dependent; zero here)
        for k in ("spawn_dropped", "collision_query_dropped", "oob_killed"):
            assert k in d
        assert all(v >= 0 for v in d.values())
        # light-fitted shadow cameras see every relevant caster in the demo
        assert d.get("shadow_caster_outside_volume", 0) == 0


class TestSweepKnobs:
    def test_space_config_sweep_knobs(self):
        """The bench sweep knobs (BENCH_SHADOW_INTERVAL / BENCH_PCF_SCALE /
        BENCH_LIGHT_TILE_BUDGET) plumb through space_config; None keeps
        every existing default."""
        base = space_config(**KW)
        cfg = space_config(**KW, shadow_update_interval=3,
                           shadow_pcf_scale=4, light_tile_budget=16,
                           shadow_lov_bias=3)
        assert cfg.shadow_update_interval == 3
        assert cfg.shadow_pcf_scale == 4
        assert cfg.render.light_tile_budget == 16
        assert cfg.shadow_lov_bias == 3
        assert base.shadow_lov_bias == 2  # measured default
        # defaults untouched when the knobs stay None
        assert base.shadow_update_interval == 1  # tiny CI target cadence
        assert base.shadow_pcf_scale == 3  # the demo default
        assert base.render.light_tile_budget == 0

    def test_space_config_budget_knobs(self):
        """BENCH_SHADOW_SLOTS / BENCH_TILE_BUDGET plumb through, and the
        measured headline budget defaults hold (112 opaque + 64 transparent
        candidates per tile, diag_budgets.py sizing)."""
        base = space_config(**KW)
        cfg = space_config(**KW, shadow_slots=3, raster_tile_budget=128,
                           trans_tile_budget=96)
        assert cfg.shadow_slots == 3
        assert cfg.render.raster.tile_budget == 128
        # the lights benchmark config overrides this (run_benchmarks.py
        # doubles it to 128 for the 720p transparent-sphere stack)
        assert cfg.render.raster.trans_tile_budget == 96
        assert base.shadow_slots == 6  # CI keeps the reference budget
        assert base.render.raster.tile_budget == 112
        assert base.render.raster.trans_tile_budget == 64
