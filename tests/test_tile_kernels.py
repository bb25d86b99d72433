"""The tile raster and fused shade kernels (Pallas through Triton, interpret
mode on the CPU) and the winner-row gather resolve, against the plain
references: raster_jnp.rasterize_depth_winner, a direct winner gather, and
lighting.shade."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from render_engine_tpu.math import transforms as T
from render_engine_tpu.render import lighting as L
from render_engine_tpu.render import raster_pallas as RP
from render_engine_tpu.render.geometry import build_triangle_batch, to_screen
from render_engine_tpu.render.raster_jnp import (
    RasterConfig,
    rasterize_depth_winner,
)
from render_engine_tpu.render.shade_pallas import fused_shade
from tests.test_render import manual_batch

CFG = RasterConfig(tile_budget=16, trans_tile_budget=8, max_tiles_per_tri=8,
                   global_budget=8, chunk=4)


def classes(batch):
    return jnp.where(batch.valid, jnp.where(batch.transparent, 2.0, 1.0),
                     0.0).astype(jnp.float32)


def raster_both(batch, h, w, cfg=CFG):
    d1, w1 = rasterize_depth_winner(batch, h, w, cfg)
    d2, w2 = RP.rasterize_depth_winner_pallas(batch, h, w, cfg)
    return (np.asarray(d1), np.asarray(w1)), (np.asarray(d2), np.asarray(w2))


class TestTileRaster:
    def test_empty_tiles_stay_clear(self):
        """Tiles without candidates run zero loop iterations: depth 1,
        winner -1, exactly as the reference."""
        batch = manual_batch([[[4.0, 4.0], [20.0, 4.0], [4.0, 20.0]]])
        (d1, w1), (d2, w2) = raster_both(batch, 32, 384)
        np.testing.assert_array_equal(w1, w2)
        np.testing.assert_array_equal(d1, d2)
        assert (w2[:, 128:] == -1).all() and (d2[:, 128:] == 1.0).all()
        assert (w2[:8, :128] >= 0).any()

    def test_global_list_covers_every_tile(self):
        # wider than max_tiles_per_tri tiles: binned to the global list
        big = [[-50.0, -50.0], [900.0, -50.0], [-50.0, 200.0]]
        batch = manual_batch([big], z=[[0.2] * 3])
        (d1, w1), (d2, w2) = raster_both(batch, 64, 512)
        np.testing.assert_array_equal(w1, w2)
        np.testing.assert_allclose(d1, d2, atol=1e-6)
        assert (w2 == 0).mean() > 0.9

    def test_transparent_window(self):
        """Transparent candidates march in their own window of the same
        launch: both layers match separately masked reference rasters."""
        rng = np.random.default_rng(7)
        tris = rng.uniform(0, 250, (8, 3, 2)).astype(np.float32)
        zs = rng.uniform(-0.9, 0.9, (8, 3)).astype(np.float32)
        batch = manual_batch(tris, z=zs, budget=8)
        batch = dataclasses.replace(batch, transparent=jnp.asarray(
            np.array([1, 0, 1, 1, 0, 1, 0, 1], bool)))
        d, w, td, tw_ = RP.rasterize_two_pass_pallas(batch, 32, 256, CFG)
        d1, w1 = rasterize_depth_winner(batch, 32, 256, CFG,
                                        ~batch.transparent)
        d2, w2 = rasterize_depth_winner(batch, 32, 256, CFG,
                                        batch.transparent)
        np.testing.assert_array_equal(np.asarray(w), np.asarray(w1))
        np.testing.assert_array_equal(np.asarray(tw_), np.asarray(w2))
        np.testing.assert_allclose(np.asarray(td), np.asarray(d2), atol=1e-6)
        assert (np.asarray(tw_) >= 0).any()

    @pytest.mark.parametrize("band", [1, 2])
    def test_row_band_offset(self, band):
        """A row band rasterized with band-local triangle y (the sharded
        frame's per-rank body) equals the same rows of the full image."""
        rng = np.random.default_rng(3 + band)
        tris = rng.uniform(0, 128, (6, 3, 2)).astype(np.float32)
        zs = rng.uniform(-0.9, 0.9, (6, 3)).astype(np.float32)
        batch = manual_batch(tris, z=zs)
        _, (d_full, w_full) = raster_both(batch, 32, 128)
        y0 = 8 * band
        local = dataclasses.replace(
            batch, xy=batch.xy - jnp.array([0.0, float(y0)], jnp.float32))
        d_b, w_b = RP.rasterize_depth_winner_pallas(local, 16, 128, CFG)
        np.testing.assert_array_equal(np.asarray(w_b),
                                      w_full[y0:y0 + 16])
        # shifted coordinates round differently in the last bit
        np.testing.assert_allclose(np.asarray(d_b), d_full[y0:y0 + 16],
                                   atol=1e-6)

    def test_loops_are_bounded_by_the_counts(self):
        """Rows past each segment's valid count are never marched: a
        covering, nearer triangle planted right after every tile's valid
        prefix (and in the uncounted global list) must not win a pixel."""
        small = [[0.0, 0.0], [16.0, 0.0], [0.0, 16.0]]
        big = [[-10.0, -10.0], [300.0, -10.0], [-10.0, 300.0]]
        batch = manual_batch([small, big], z=[[0.5] * 3, [-0.9] * 3])
        tx, ty = 1, 4
        k = CFG.tile_budget + CFG.trans_tile_budget + CFG.global_budget
        cand = np.full((tx * ty, k), -1, np.int32)
        counts = np.zeros((tx * ty, 3), np.int32)
        cand[0, :2] = [0, 1]  # tile 0: small counted, big not
        counts[0, 0] = 1
        cand[1:, 0] = 1  # other tiles: big present, count 0
        cand[:, CFG.tile_budget] = 1  # transparent window, count 0
        cand[:, CFG.tile_budget + CFG.trans_tile_budget] = 1  # global
        _, w, _ = RP._launch(batch, 32, 128, CFG, classes(batch),
                             two_pass=False, cand=jnp.asarray(cand),
                             counts=jnp.asarray(counts))
        w = np.asarray(RP._untile(w, ty, tx, 8, 128, 32, 128))
        only_small = dataclasses.replace(
            batch, valid=jnp.asarray(np.array([1] + [0] * 7, bool)))
        _, w_ref = rasterize_depth_winner(only_small, 32, 128, CFG)
        np.testing.assert_array_equal(w[:8], np.asarray(w_ref)[:8])
        assert (w[:8] == 0).any() and not (w == 1).any()
        assert (w[8:] == -1).all()

    def test_candidate_rows_layout(self):
        """Raster rows: x0 y0 x1 y1 x2 y2 z0 z1 z2 class tri_id, padded to
        RAST_COLS."""
        batch = manual_batch([[[1.0, 2.0], [3.0, 4.0], [5.0, 6.0]]],
                             z=[[0.1, 0.2, 0.3]])
        tri_class = classes(batch)
        data, counts = RP._prepare_candidates(batch, CFG, 1, 4, tri_class)
        assert data.shape == (4, CFG.tile_budget + CFG.trans_tile_budget
                              + CFG.global_budget, RP.RAST_COLS)
        np.testing.assert_allclose(
            np.asarray(data[0, 0, :11]),
            [1, 2, 3, 4, 5, 6, 0.1, 0.2, 0.3, 1.0, 0.0], atol=1e-7)
        assert (np.asarray(data[..., 11:]) == 0).all()
        assert np.asarray(counts).shape == (4, 3)


class TestGatherResolve:
    def test_matches_direct_winner_gather(self):
        rng = np.random.default_rng(0)
        nt, th, tw, k, a = 3, 8, 128, 12, 48
        rows = rng.normal(size=(nt, k, a)).astype(np.float32)
        slot = rng.integers(-1, k, size=(nt, th, tw)).astype(np.int32)
        got = np.asarray(RP.resolve_attributes(jnp.asarray(slot),
                                               jnp.asarray(rows)))
        assert got.shape == (a, nt, th, tw)
        t_idx = np.arange(nt)[:, None, None]
        want = rows[t_idx, np.maximum(slot, 0)]  # (nt, th, tw, a)
        want = np.where((slot >= 0)[..., None], want, 0.0)
        np.testing.assert_array_equal(got, np.moveaxis(want, -1, 0))

    def test_gbuffer_matches_resolve_gbuffer(self):
        """Gather resolve + channel interpolation == raster_jnp's per-pixel
        resolve on the same winners."""
        from render_engine_tpu.render.raster_jnp import resolve_gbuffer
        from tests.test_frame_tiled import H, WIDTH, scene, settings

        w, bank, cam = scene()
        s = settings("tiled")
        batch = to_screen(build_triangle_batch(w, bank, cam,
                                               max_tris=s.max_tris),
                          WIDTH, H)
        gb, _, _, _ = RP.render_gbuffers_pallas(
            batch, bank, H, WIDTH, s.raster, proj_view=cam.proj_view())
        ref = resolve_gbuffer(batch, bank, gb.depth, gb.tri_id)
        cov = np.asarray(gb.tri_id) >= 0
        assert cov.any()
        for f in ("normal", "albedo"):
            np.testing.assert_allclose(np.asarray(getattr(gb, f)),
                                       np.asarray(getattr(ref, f)),
                                       atol=1e-5)
        np.testing.assert_array_equal(np.asarray(gb.material),
                                      np.asarray(ref.material))
        np.testing.assert_allclose(np.asarray(gb.position)[cov],
                                   np.asarray(ref.position)[cov],
                                   rtol=1e-3, atol=1e-3)


class TestFusedShade:
    def test_matches_lighting_shade(self):
        """The fused shade kernel's opaque layer == lighting.shade over the
        gather-resolved G-buffer (same winners, same light table)."""
        from tests.test_frame_tiled import H, WIDTH, scene, settings

        w, bank, cam = scene()
        s = settings("tiled")
        cfg = s.raster
        batch = to_screen(build_triangle_batch(w, bank, cam,
                                               max_tris=s.max_tris),
                          WIDTH, H)
        tx, ty = -(-WIDTH // cfg.tile_w), -(-H // cfg.tile_h)
        tri_class = classes(batch)
        cand, counts = RP._candidate_table(batch, cfg, tx, ty, tri_class)
        rows = RP._gather_candidate_rows(
            RP._packed_tri_table(batch, bank, tri_class), cand)
        d, wn, so, td, _, st = RP._launch(batch, H, WIDTH, cfg, tri_class,
                                          two_pass=True, cand=cand,
                                          counts=counts)
        lights = L.extract_lights(w, max_dir=s.max_dir_lights,
                                  max_point=s.max_point_lights,
                                  max_spot=s.max_spot_lights)
        inv_pv = T.inv44(cam.proj_view())
        shin = bank.uniform_shininess()
        out = fused_shade(rows, so, st, d, td, lights, cam.position, inv_pv,
                          tx, WIDTH, H, spec_packed=shin is None,
                          shin_const=shin if shin is not None else 64.0)
        assert out.shape == (8, tx * ty, cfg.tile_h, cfg.tile_w)

        def untile(a):
            return RP._untile(a, ty, tx, cfg.tile_h, cfg.tile_w, H, WIDTH)

        ch = jnp.stack([untile(c) for c in
                        RP.resolve_attributes(so, rows)])
        gbuf, extras = RP._gbuffer_from_channels(
            ch, untile(d), untile(wn), H, WIDTH, inv_pv,
            spec_packed=shin is None)
        ref = np.asarray(L.shade(
            gbuf, lights, bank, cam.position,
            background=jnp.zeros((H, WIDTH, 3), jnp.float32),
            emissive_image=extras["emissive"],
            specular_image=extras["specular"],
            shininess_image=extras.get("shininess")))
        lit = np.stack([np.asarray(untile(out[c])) for c in range(3)], -1)
        cov = np.asarray(gbuf.covered())
        assert cov.sum() > 20
        np.testing.assert_allclose(lit[cov], ref[cov], atol=2e-5)
        flags = np.asarray(untile(out[7]))
        np.testing.assert_array_equal(np.mod(flags, 2.0) >= 1.0, cov)
