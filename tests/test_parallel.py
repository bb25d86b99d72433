"""Multi-device sharding tests on the 8-device virtual CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from render_engine_tpu.parallel.mesh import (
    make_mesh,
    shard_world,
    world_sharding,
)


@pytest.fixture
def eight_devices():
    """Skip unless JAX has 8 devices (decided at run time)."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")


needs_8 = pytest.mark.usefixtures("eight_devices")

# one engine config for every test here -> a single session-cached build
PAR_KW = dict(width=128, height=64, capacity=64, num_asteroids=8,
              max_tris=1024)


@needs_8
class TestMesh:
    def test_make_mesh(self):
        mesh = make_mesh(8)
        assert mesh.shape["world"] == 8

    def test_world_sharding_specs(self):
        from render_engine_tpu.ecs import world as W

        w = W.create_world(W.WorldConfig(capacity=64))
        mesh = make_mesh(8)
        sh = world_sharding(w, mesh)
        # per-entity arrays shard on dim 0; config-free leaves replicate
        pos_sh = sh.comps["position"]
        assert pos_sh.spec == P("world")

    def test_sharded_step_runs(self, engine_factory):
        """The full demo step executes over an 8-device mesh and XLA inserts
        whatever collectives the grid sort / collision gathers need."""
        from render_engine_tpu.logic.step import make_step
        from render_engine_tpu.logic.types import InputState

        eng = engine_factory(**PAR_KW)
        mesh = make_mesh(8)
        world = shard_world(eng.world, mesh)
        rep = NamedSharding(mesh, P())
        camera = jax.device_put(eng.camera, rep)
        bank = eng.bank

        step = make_step(tuple(eng.config.entity_types),
                         spawn_budget=eng.config.spawn_budget)
        fn = jax.jit(lambda w, c, i, d: step(w, c, i, d, bank.aabb_min,
                                             bank.aabb_max))
        w2, c2 = fn(world, camera, InputState.idle(0), jnp.float32(1 / 60))
        jax.block_until_ready(w2)
        assert int(jnp.sum(w2.alive)) == int(jnp.sum(eng.world.alive))
        assert np.isfinite(np.asarray(w2.comps["position"])).all()

    def test_sharded_step_scale_partitions_entity_axis(self, engine_factory):
        """BENCH-scale world (10k entities, capacity 16384) stepped over
        the 8-device mesh: the OUTPUT world's entity axis stays partitioned
        (capacity/8 rows per rank — XLA kept the computation sharded, not
        replicated) and matches the single-device step (VERDICT r4 #8:
        scale proof beyond the 22-entity parity scene)."""
        from render_engine_tpu.logic.step import make_step
        from render_engine_tpu.logic.types import InputState

        eng = engine_factory(width=128, height=64, capacity=16384,
                             num_asteroids=10000, max_tris=2048)
        bank = eng.bank
        step = make_step(tuple(eng.config.entity_types),
                         spawn_budget=eng.config.spawn_budget)
        fn = jax.jit(lambda w, c, i, d: step(w, c, i, d, bank.aabb_min,
                                             bank.aabb_max))
        w1, _ = fn(eng.world, eng.camera, InputState.idle(0),
                   jnp.float32(1 / 60))

        mesh = make_mesh(8)
        wsh = world_sharding(eng.world, mesh)
        world_sh = jax.device_put(eng.world, wsh)
        cam_sh = jax.device_put(eng.camera, NamedSharding(mesh, P()))
        fn8 = jax.jit(lambda w, c, i, d: step(w, c, i, d, bank.aabb_min,
                                              bank.aabb_max),
                      in_shardings=(wsh, NamedSharding(mesh, P()),
                                    NamedSharding(mesh, P()),
                                    NamedSharding(mesh, P())))
        with mesh:
            w8, _ = fn8(world_sh, cam_sh, InputState.idle(0),
                        jnp.float32(1 / 60))
            jax.block_until_ready(w8)
        pos8 = w8.comps["position"]
        shard_rows = pos8.addressable_shards[0].data.shape[0]
        assert shard_rows == eng.config.capacity // 8, (
            f"entity axis not partitioned: {shard_rows} rows/rank")
        np.testing.assert_allclose(
            np.asarray(pos8), np.asarray(w1.comps["position"]),
            rtol=1e-6, atol=1e-6)
        assert int(jnp.sum(w8.alive)) == int(jnp.sum(w1.alive))

    def test_sharded_matches_single_device(self, engine_factory):
        """Sharded step == single-device step (same math, collectives only
        move data)."""
        from render_engine_tpu.logic.step import make_step
        from render_engine_tpu.logic.types import InputState

        eng = engine_factory(**PAR_KW)
        bank = eng.bank
        step = make_step(tuple(eng.config.entity_types),
                         spawn_budget=eng.config.spawn_budget)
        fn = jax.jit(lambda w, c, i, d: step(w, c, i, d, bank.aabb_min,
                                             bank.aabb_max))
        w_single, _ = fn(eng.world, eng.camera, InputState.idle(0),
                         jnp.float32(1 / 60))

        mesh = make_mesh(8)
        world_sh = shard_world(eng.world, mesh)
        cam_sh = jax.device_put(eng.camera, NamedSharding(mesh, P()))
        w_mesh, _ = fn(world_sh, cam_sh, InputState.idle(0),
                       jnp.float32(1 / 60))
        for k in w_single.comps:
            np.testing.assert_allclose(
                np.asarray(w_single.comps[k]), np.asarray(w_mesh.comps[k]),
                rtol=1e-6, atol=1e-6, err_msg=f"component {k}",
            )


@needs_8
class TestShardedRender:
    def test_sharded_render_matches_single_chip_path(self, engine_factory):
        """render_frame_sharded (shard_map over tile rows) reproduces the
        single-chip tiled Pallas frame — same kernels, same image."""
        import dataclasses

        from render_engine_tpu.parallel.render import render_frame_sharded
        from render_engine_tpu.render.frame import render_frame

        eng = engine_factory(**PAR_KW)
        s = dataclasses.replace(eng.config.render, backend="tiled",
                                fused_shading=True)
        single = np.asarray(render_frame(
            eng.world, eng.camera, eng.bank, s, cubemap=eng.cubemap,
            systems=eng.compiled_systems, shadow_state=eng.shadow_state))

        mesh = make_mesh(8)
        world = shard_world(eng.world, mesh)
        cam = jax.device_put(eng.camera, NamedSharding(mesh, P()))
        bank, cubemap = eng.bank, eng.cubemap
        systems, shadow = eng.compiled_systems, eng.shadow_state

        fn = jax.jit(lambda w, c: render_frame_sharded(
            w, c, bank, s, mesh, cubemap=cubemap, shadow_state=shadow,
            systems=systems))
        with mesh:
            img = np.asarray(fn(world, cam))
        assert img.shape == single.shape
        diff = np.abs(img - single).max(axis=-1)
        assert diff.max() < 0.03, f"max diff {diff.max():.4f}"

    def test_sharded_tile_lights_match_single_chip(self, engine_factory):
        """Per-tile light culling under row sharding: each rank derives its
        tile pyramids from GLOBAL pixel coordinates (y_off), so the culled
        lists — and the image — match the single-chip run exactly."""
        import dataclasses

        from render_engine_tpu.parallel.render import render_frame_sharded
        from render_engine_tpu.render.frame import render_frame

        eng = engine_factory(**PAR_KW)
        s = dataclasses.replace(eng.config.render, backend="tiled",
                                fused_shading=True, light_tile_budget=8)
        s_full = dataclasses.replace(s, light_tile_budget=0)
        single = np.asarray(render_frame(
            eng.world, eng.camera, eng.bank, s, cubemap=eng.cubemap,
            systems=eng.compiled_systems, shadow_state=eng.shadow_state))
        # tile lists are bit-identical to the full loop (no overflow here)
        full = np.asarray(render_frame(
            eng.world, eng.camera, eng.bank, s_full, cubemap=eng.cubemap,
            systems=eng.compiled_systems, shadow_state=eng.shadow_state))
        np.testing.assert_array_equal(single, full)

        mesh = make_mesh(8)
        world = shard_world(eng.world, mesh)
        cam = jax.device_put(eng.camera, NamedSharding(mesh, P()))
        bank, cubemap = eng.bank, eng.cubemap
        systems, shadow = eng.compiled_systems, eng.shadow_state

        fn = jax.jit(lambda w, c: render_frame_sharded(
            w, c, bank, s, mesh, cubemap=cubemap, shadow_state=shadow,
            systems=systems))
        with mesh:
            img = np.asarray(fn(world, cam))
        diff = np.abs(img - single).max(axis=-1)
        assert diff.max() < 0.03, f"max diff {diff.max():.4f}"

    def test_sharded_draw_callbacks_match_single_chip(self, engine_factory):
        """DrawParam callbacks run in the outer sharded jit: gating +
        per-frame uniforms produce the same image as single chip, and the
        gated-out models vanish on both."""
        import dataclasses

        from render_engine_tpu.parallel.render import render_frame_sharded
        from render_engine_tpu.render.frame import render_frame
        from render_engine_tpu.render.render_system import (
            RenderSystemBuilder,
            compile_systems,
        )

        eng = engine_factory(**PAR_KW)
        star = eng.bank.model_index("star")

        def draw(dp):
            dp.draw_models(star)  # only the star draws this frame
            dp.write_uniform("albedo_tint", jnp.asarray([1.0, 0.5, 0.5]))

        systems = compile_systems(
            (RenderSystemBuilder("cb")
             .with_models(*range(eng.bank.num_models))
             .with_draw_function(draw).build(),), eng.bank)
        s = dataclasses.replace(eng.config.render, backend="tiled",
                                fused_shading=True)
        single = np.asarray(render_frame(
            eng.world, eng.camera, eng.bank, s, cubemap=eng.cubemap,
            systems=systems))

        mesh = make_mesh(8)
        world = shard_world(eng.world, mesh)
        cam = jax.device_put(eng.camera, NamedSharding(mesh, P()))
        bank, cubemap = eng.bank, eng.cubemap

        fn = jax.jit(lambda w, c: render_frame_sharded(
            w, c, bank, s, mesh, cubemap=cubemap, systems=systems))
        with mesh:
            img = np.asarray(fn(world, cam))
        diff = np.abs(img - single).max(axis=-1)
        assert diff.max() < 0.03, f"max diff {diff.max():.4f}"

    def test_sharded_custom_shading_matches_single_chip(self, engine_factory):
        """with_fragment_shading runs on the sharded fused path (per-rank
        post-kernel hook over GLOBAL pixel coordinates): the image matches
        the single-chip fused render with the same shade fn."""
        import dataclasses

        from render_engine_tpu.parallel.render import render_frame_sharded
        from render_engine_tpu.render.frame import render_frame
        from render_engine_tpu.render.render_system import (
            RenderSystemBuilder,
            compile_systems,
        )

        eng = engine_factory(**PAR_KW)

        def fancy(sp):
            tone = jnp.asarray(sp.uniforms["tone"], jnp.float32)
            n = 0.5 * (sp.normal + 1.0)
            return jnp.clip(sp.base_color * tone + 0.2 * sp.albedo * n,
                            0.0, 1.0)

        systems = compile_systems(
            (RenderSystemBuilder("cs")
             .with_models(*range(eng.bank.num_models))
             .write_uniform("tone", 0.8)
             .with_fragment_shading(fancy).build(),), eng.bank)
        s = dataclasses.replace(eng.config.render, backend="tiled",
                                fused_shading=True)
        single = np.asarray(render_frame(
            eng.world, eng.camera, eng.bank, s, cubemap=eng.cubemap,
            systems=systems))

        mesh = make_mesh(8)
        world = shard_world(eng.world, mesh)
        cam = jax.device_put(eng.camera, NamedSharding(mesh, P()))
        bank, cubemap = eng.bank, eng.cubemap

        fn = jax.jit(lambda w, c: render_frame_sharded(
            w, c, bank, s, mesh, cubemap=cubemap, systems=systems))
        with mesh:
            img = np.asarray(fn(world, cam))
        assert img.shape == single.shape
        diff = np.abs(img - single).max(axis=-1)
        assert diff.max() < 0.03, f"max diff {diff.max():.4f}"

    def test_sharded_render_with_atlas_matches(self, engine_factory):
        """The sharded render threads the texture atlas: per-rank UV
        interpolation + atlas row gathers reproduce the single-chip
        textured image (the demo scene includes a textured OBJ station)."""
        import dataclasses

        from render_engine_tpu.parallel.render import render_frame_sharded
        from render_engine_tpu.render.frame import render_frame

        eng = engine_factory(**PAR_KW)
        assert eng.atlas is not None, "demo scene should carry an atlas"
        s = dataclasses.replace(eng.config.render, backend="tiled",
                                fused_shading=True, texture_tile_budget=1.0)
        single = np.asarray(render_frame(
            eng.world, eng.camera, eng.bank, s, cubemap=eng.cubemap,
            atlas=eng.atlas, systems=eng.compiled_systems,
            shadow_state=eng.shadow_state))

        mesh = make_mesh(8)
        world = shard_world(eng.world, mesh)
        cam = jax.device_put(eng.camera, NamedSharding(mesh, P()))
        bank, cubemap, atlas = eng.bank, eng.cubemap, eng.atlas
        systems, shadow = eng.compiled_systems, eng.shadow_state

        fn = jax.jit(lambda w, c: render_frame_sharded(
            w, c, bank, s, mesh, cubemap=cubemap, atlas=atlas,
            shadow_state=shadow, systems=systems))
        with mesh:
            img = np.asarray(fn(world, cam))
        assert img.shape == single.shape
        diff = np.abs(img - single).max(axis=-1)
        assert diff.max() < 0.03, f"max diff {diff.max():.4f}"
