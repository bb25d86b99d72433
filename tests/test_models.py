"""Model bank + OBJ/MTL loader tests (model_storage.rs loader parity)."""

import numpy as np
import jax.numpy as jnp

from render_engine_tpu.models import primitives
from render_engine_tpu.models.bank import ModelBankBuilder
from render_engine_tpu.models.obj_loader import load_obj


class TestPrimitives:
    def test_cube_geometry(self):
        v, n, uv, f = primitives.cube(2.0)
        assert v.shape == (24, 3) and f.shape == (12, 3)
        np.testing.assert_allclose(np.abs(v).max(), 1.0)
        np.testing.assert_allclose(np.linalg.norm(n, axis=1), 1.0)

    def test_sphere_radius(self):
        v, n, uv, f = primitives.uv_sphere(0.5, 8, 12)
        np.testing.assert_allclose(np.linalg.norm(v, axis=1), 0.5, atol=1e-5)
        assert len(f) > 0

    def test_asteroid_deterministic(self):
        a = primitives.asteroid(1.0, seed=3)
        b = primitives.asteroid(1.0, seed=3)
        np.testing.assert_array_equal(a[0], b[0])
        c = primitives.asteroid(1.0, seed=4)
        assert not np.array_equal(a[0], c[0])

    def test_skybox_winding_flipped(self):
        _, n_out, _, f_out = primitives.cube(2.0)
        _, n_in, _, f_in = primitives.skybox_cube()
        np.testing.assert_array_equal(n_in, -n_out)


class TestBankPacking:
    def test_offsets_and_aabbs(self):
        bb = ModelBankBuilder()
        a = bb.add_model("a", primitives.cube(1.0))
        b = bb.add_model("b", primitives.uv_sphere(2.0, 6, 8))
        bank = bb.finalize()
        assert int(bank.tri_offset[a]) == 0
        assert int(bank.tri_count[a]) == 12
        assert int(bank.tri_offset[b]) == 12
        np.testing.assert_allclose(bank.aabb_min[a], [-0.5] * 3)
        np.testing.assert_allclose(bank.aabb_max[b], [2.0] * 3, atol=1e-5)
        assert bank.model_index("b") == b
        # global triangle vertex ids index into the packed vertex buffer
        assert int(bank.tri_v.max()) < bank.vertices.shape[0]

    def test_error_material_zero(self):
        bb = ModelBankBuilder()
        bb.add_model("m", primitives.quad(1.0))
        bank = bb.finalize()
        np.testing.assert_allclose(bank.mat_albedo[0], [1.0, 0.0, 1.0])


class TestObjLoader:
    def _write(self, tmp_path, name, text):
        p = tmp_path / name
        p.write_text(text)
        return str(p)

    def test_triangle_with_mtl(self, tmp_path):
        self._write(tmp_path, "m.mtl", """
newmtl red
Kd 0.9 0.1 0.2
""")
        path = self._write(tmp_path, "t.obj", """
mtllib m.mtl
v 0 0 0
v 1 0 0
v 0 1 0
vt 0 0
vt 1 0
vt 0 1
vn 0 0 1
usemtl red
f 1/1/1 2/2/1 3/3/1
""")
        v, n, uv, f, tri_mat, mats = load_obj(path)
        assert f.shape == (1, 3)
        np.testing.assert_allclose(n[0], [0, 0, 1])
        np.testing.assert_allclose(uv[1], [1, 0])
        assert mats[tri_mat[0]]["name"] == "red"
        np.testing.assert_allclose(mats[tri_mat[0]]["kd"], [0.9, 0.1, 0.2])

    def test_quad_fan_triangulation(self, tmp_path):
        path = self._write(tmp_path, "q.obj", """
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
f 1 2 3 4
""")
        v, n, uv, f, tri_mat, mats = load_obj(path)
        assert f.shape == (2, 3)  # fan: (0,1,2), (0,2,3)
        # missing normals get face normals
        np.testing.assert_allclose(np.abs(n[:, 2]), 1.0, atol=1e-6)

    def test_negative_indices(self, tmp_path):
        path = self._write(tmp_path, "neg.obj", """
v 0 0 0
v 1 0 0
v 0 1 0
f -3 -2 -1
""")
        v, n, uv, f, tri_mat, mats = load_obj(path)
        assert f.shape == (1, 3)
        np.testing.assert_allclose(v[f[0, 1]], [1, 0, 0])

    def test_bank_add_obj(self, tmp_path):
        path = self._write(tmp_path, "t.obj", """
v 0 0 0
v 1 0 0
v 0 1 0
f 1 2 3
""")
        bb = ModelBankBuilder()
        mid = bb.add_obj("tri", path)
        bank = bb.finalize()
        assert int(bank.tri_count[mid]) == 1

    def test_shininess_ns_parsed(self, tmp_path):
        """MTL Ns -> per-material specular exponent; map_Ns -> the sixth
        texture column (the reference's SHININESS_INDEX role,
        model_definitions.rs:77-81). Unset Ns defaults to the reference's
        hardcoded 64.0 (second_pass_frag.glsl:66)."""
        self._write(tmp_path, "m.mtl", """
newmtl shiny
Kd 0.9 0.9 0.9
Ns 250
newmtl dull
Kd 0.5 0.5 0.5
""")
        path = self._write(tmp_path, "t.obj", """
mtllib m.mtl
v 0 0 0
v 1 0 0
v 0 1 0
v 1 1 0
usemtl shiny
f 1 2 3
usemtl dull
f 2 4 3
""")
        bb = ModelBankBuilder()
        bb.add_obj("two", path)
        bank = bb.finalize()
        tm = np.asarray(bank.tri_material)
        shin = np.asarray(bank.mat_shininess)
        assert shin[tm[0]] == 250.0
        assert shin[tm[1]] == 64.0
        assert bank.uniform_shininess() is None  # varying scene
        assert bank.mat_textures.shape[1] == 6
        # default-Ns-only bank stays uniform (compile-time constant path)
        bb2 = ModelBankBuilder()
        bb2.add_material(albedo=(1, 0, 0))
        bb2.add_model("c", primitives.cube(1.0))
        assert bb2.finalize().uniform_shininess() == 64.0

    def test_spec_shin_codec_exact(self):
        """pack_spec_shin/unpack_spec_shin round-trips exactly on the
        quantization grid (f32-exact packed integers below 2^23)."""
        from render_engine_tpu.models.bank import (
            pack_spec_shin,
            unpack_spec_shin,
        )

        spec = jnp.asarray(
            np.round(np.linspace(0.0, 3.9, 64) * 1024.0) / 1024.0,
            jnp.float32)
        shin = jnp.asarray(np.round(np.linspace(1, 2047, 64)), jnp.float32)
        s2, h2 = unpack_spec_shin(pack_spec_shin(spec, shin))
        np.testing.assert_array_equal(np.asarray(s2), np.asarray(spec))
        np.testing.assert_array_equal(np.asarray(h2), np.asarray(shin))


class TestNativeObjParser:
    """The C++ parse core (native/obj_loader.cpp) against the Python
    parser — the Python implementation is the semantic specification, so
    every array and the material table must match exactly."""

    GNARLY = """
# comment line
mtllib none_missing.mtl
mtllib m.mtl
v 0 0 0
v 1 0 0
v 0 1 0
v 1 1 0
vt 0 0
vt 1 0
vt 0 1
vn 0 0 1
usemtl red
f 1/1/1 2/2/1 3/3/1
f 1/1/1 2/2 4
usemtl blue
f -4//-1 -3 -1
f 1 2 3 4
usemtl red
f 2 3 4
"""

    MTL = """
newmtl red
Kd 0.9 0.1 0.2
Ks 0.5 0.5 0.5
map_Kd tex.png
newmtl blue
Kd 0.1 0.1 0.9
map_Ks spec.png
"""

    def _both(self, tmp_path):
        import os

        from render_engine_tpu.models import obj_loader as OL
        from render_engine_tpu.native.build import obj_native

        (tmp_path / "m.mtl").write_text(self.MTL)
        p = tmp_path / "g.obj"
        p.write_text(self.GNARLY)
        if obj_native() is None:
            import pytest

            pytest.skip("native toolchain unavailable")
        native = OL._load_obj_native(str(p))
        assert native is not None, "native parse rejected a valid file"
        os.environ["RE_NATIVE"] = "0"
        try:
            py = OL.load_obj(str(p))
        finally:
            os.environ.pop("RE_NATIVE", None)
        v, n, uv, tris, tri_slot, mats = native
        n = OL._fill_missing_normals(v, n.copy(), tris)
        return (v, n, uv, tris, tri_slot, mats), py

    def test_native_matches_python_exactly(self, tmp_path):
        nat, py = self._both(tmp_path)
        for a, b, what in zip(nat[:5], py[:5],
                              ("v", "n", "uv", "tris", "tri_mat")):
            np.testing.assert_array_equal(a, b, err_msg=what)
        assert len(nat[5]) == len(py[5])
        for ma, mb in zip(nat[5], py[5]):
            assert ma["name"] == mb["name"]
            np.testing.assert_array_equal(ma["kd"], mb["kd"])
            assert ma["map_kd"] == mb["map_kd"]
            assert ma["ks"] == mb["ks"]
            assert ma["map_ks"] == mb["map_ks"]

    def test_native_rejects_malformed_and_falls_back(self, tmp_path):
        from render_engine_tpu.models import obj_loader as OL
        from render_engine_tpu.native.build import obj_native

        if obj_native() is None:
            import pytest

            pytest.skip("native toolchain unavailable")
        p = tmp_path / "bad.obj"
        p.write_text("v 0 0 0\nf 1 2 9\n")  # out-of-range index
        assert OL._load_obj_native(str(p)) is None
