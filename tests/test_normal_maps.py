"""Normal-mapping (fourth texture pair): MTL wiring + shading on all
render paths.

The reference's material contract names a NORMAL_INDEX texture role and
error-placeholders it (model_definitions.rs:77-81, 106-119) but its shader
never samples it (first_pass_frag.glsl:58-75); here the role is live — a
tangent-space normal map perturbs the G-buffer normal before lighting."""

import dataclasses

import jax.numpy as jnp
import numpy as np

from render_engine_tpu.ecs import registry as R
from render_engine_tpu.ecs import world as W
from render_engine_tpu.logic import kinematics as K
from render_engine_tpu.math.camera import CameraBuilder
from render_engine_tpu.models import primitives
from render_engine_tpu.models.bank import ModelBankBuilder
from render_engine_tpu.render.frame import RenderSettings, render_frame
from render_engine_tpu.render.raster_jnp import RasterConfig
from render_engine_tpu.render.textures import TextureAtlasBuilder


def _normal_texel(v):
    """Encode a (3,) tangent-space normal as a texel in [0, 1]."""
    v = np.asarray(v, np.float32)
    v = v / np.linalg.norm(v)
    return (v + 1.0) * 0.5


def _scene(normal_map=None):
    """A lit quad facing the camera; a dir light from up-left so a tangent
    tilt visibly changes the diffuse term. Returns (world, bank, cam,
    atlas)."""
    ab = TextureAtlasBuilder(layer_size=16)
    ntid = -1
    if normal_map is not None:
        ntid = ab.add_image(np.broadcast_to(
            np.asarray(normal_map, np.float32), (16, 16, 3)).copy())
    atlas = ab.finalize()
    bb = ModelBankBuilder()
    m = bb.add_material(albedo=(0.8, 0.8, 0.8), texture_normal=ntid)
    bb.add_model("quad", primitives.quad(3.0), material=m)
    bank = bb.finalize()
    cfg = W.WorldConfig(capacity=4, world_length=64.0, section_length=8.0)
    w = W.create_world(cfg)
    w, _ = W.spawn_host(
        w, 2,
        position=np.array([[32.0, 32.0, 28.0], [0.0, 0.0, 0.0]], np.float32),
        model_id=np.array([0, -1], np.int32),
        sortable=np.array([R.SORTABLE_DEFAULT, R.SORTABLE_DIRECTIONAL],
                          np.int32),
        light_direction=np.array([[0, 0, 0], [0.6, -0.6, -0.52]],
                                 np.float32),
        light_diffuse=np.array([[0, 0, 0], [0.9, 0.9, 0.9]], np.float32),
    )
    w = K.refresh_transforms(w, bank.aabb_min, bank.aabb_max,
                             jnp.asarray(w.alive))
    cam = (CameraBuilder().with_position(32.0, 32.0, 33.0)
           .with_yaw_pitch_degrees(-90.0, 0.0).with_fov_degrees(70.0)
           .with_aspect(4.0).with_near_far(0.1, 50.0)
           .with_draw_distance(50.0).build())
    return w, bank, cam, atlas


def _settings(backend, fused):
    return RenderSettings(
        width=128, height=32, max_tris=64, backend=backend,
        raster=RasterConfig(tile_budget=16, max_tiles_per_tri=8,
                            global_budget=8, chunk=4),
        fused_shading=fused, texture_tile_budget=1.0)


_PATHS = (("jnp", False), ("tiled", False), ("tiled", True))


class TestNormalMaps:
    def test_flat_map_is_identity_all_paths(self):
        """A flat (0.5, 0.5, 1) normal map decodes to m = (0, 0, 1) and
        must leave shading untouched on every path."""
        w, bank, cam, atlas = _scene(normal_map=(0.5, 0.5, 1.0))
        w2, bank2, cam2, _ = _scene(normal_map=None)
        assert bank.has_normal_maps() and not bank2.has_normal_maps()
        for backend, fused in _PATHS:
            s = _settings(backend, fused)
            a = np.asarray(render_frame(w, cam, bank, s, atlas=atlas))
            b = np.asarray(render_frame(w2, cam2, bank2, s, atlas=atlas))
            np.testing.assert_allclose(a, b, atol=1e-5,
                                       err_msg=f"{backend} fused={fused}")

    def test_tilted_map_changes_shading_and_paths_agree(self):
        """A uniformly tilted map changes the lit color of a flat quad
        (the whole point of the feature); the jnp golden path, the tall
        pallas path, and the fused kernel agree on the result."""
        w, bank, cam, atlas = _scene(
            normal_map=_normal_texel([0.55, 0.0, 0.835]))
        flat_w, flat_bank, _, flat_atlas = _scene(
            normal_map=(0.5, 0.5, 1.0))
        outs = []
        for backend, fused in _PATHS:
            s = _settings(backend, fused)
            outs.append(np.asarray(render_frame(w, cam, bank, s,
                                                atlas=atlas)))
        tilted = outs[0]
        flat = np.asarray(render_frame(flat_w, cam, flat_bank,
                                       _settings("jnp", False),
                                       atlas=flat_atlas))
        covered = flat.sum(axis=-1) > 0
        assert covered.any()
        # the tilt turns the quad toward/away from the up-left light:
        # a clearly visible brightness change on covered pixels
        delta = np.abs(tilted[covered] - flat[covered]).max()
        assert delta > 0.05, f"tilt changed shading by only {delta}"
        for o, (backend, fused) in zip(outs[1:], _PATHS[1:]):
            diff = np.abs(o - tilted).max(axis=-1)
            assert (diff > 0.03).mean() < 0.01, \
                f"{backend} fused={fused}: max {diff.max():.4f}"
            assert diff.max() < 0.06, f"{backend} fused={fused}"

    def test_mtl_map_bump_wires_through_loader(self, tmp_path):
        """map_Bump in an MTL loads into the atlas as the material's
        normal map through the real OBJ loader (bump/norm spellings too);
        a missing file lands on the NAMED normal error texture
        (helper_constructs.rs:2-12 parity)."""
        import warnings

        tex = np.broadcast_to(_normal_texel([0.3, 0.3, 0.9]),
                              (8, 8, 3)).astype(np.float32)
        ppm = tmp_path / "bumps.ppm"
        u8 = (tex * 255 + 0.5).astype(np.uint8)
        ppm.write_bytes(b"P6\n8 8\n255\n" + u8.tobytes())
        (tmp_path / "m.mtl").write_text(
            "newmtl a\nKd 0.5 0.5 0.5\nmap_Bump bumps.ppm\n"
            "newmtl b\nKd 0.5 0.5 0.5\nbump missing.ppm\n")
        (tmp_path / "q.obj").write_text(
            "mtllib m.mtl\n"
            "v -1 -1 0\nv 1 -1 0\nv 1 1 0\nv -1 1 0\n"
            "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\nvn 0 0 1\n"
            "usemtl a\nf 1/1/1 2/2/1 3/3/1\n"
            "usemtl b\nf 1/1/1 3/3/1 4/4/1\n")
        ab = TextureAtlasBuilder(layer_size=16)
        bb = ModelBankBuilder()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the missing.ppm fallback
            bb.add_obj("q", str(tmp_path / "q.obj"), atlas_builder=ab)
        bank = bb.finalize()
        assert bank.has_normal_maps()
        norm_ids = np.asarray(bank.mat_texture_norm)
        # both materials carry a normal map id (material b = error texture)
        assert (norm_ids >= 0).sum() == 2
        err = ab.error_texture("normal")
        assert err in norm_ids.tolist()
