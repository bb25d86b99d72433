"""Model bank: all geometry packed into one set of device arrays.

Redesign of the reference's ModelBankOwner/ModelBank (src/models/
model_storage.rs:16-466) and ModelId LoV packing (model_definitions.rs:10-59):

  * per-model VBOs + dirty "models changed -> reupload VRAM" flags  ->
    everything concatenated once into global arrays; renderers gather by
    per-model (tri_offset, tri_count). Nothing is re-uploaded per frame.
  * ModelId with the level-of-view index packed into bits 25-31  ->  an
    explicit ``lov_table (M, L)`` mapping (model, band) -> bank entry, with
    band fractions of draw distance matching the reference's 5 default bands
    at 10/15/20/25/30% (prelude/default_render_system.rs:239-256,
    NUMBER_DEFAULT_LEVEL_VIEWS = 5).
  * TextureLocation's 5 packed texture pairs -> a per-material table row
    (albedo rgb, emissive, alpha, texture id).

The builder is host-side numpy; ``finalize()`` freezes to jnp arrays in a
pytree the jitted render step closes over.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

NUM_LOV_BANDS = 5  # reference NUMBER_DEFAULT_LEVEL_VIEWS
# Band END thresholds as fractions of draw distance. The reference's
# create_level_of_views (default_render_system.rs:240-255) ACCUMULATES its
# 10/15/20/25/30% increments, so the default bands end at 10/25/45/70/100%
# of the render distance and the last band ends exactly at the far plane
# (far_draw_distance == render_distance there, camera_object.rs:211-214).
# Beyond the last band the coarsest geometry is used — the reference's
# out-of-range fallback (model_definitions.rs:42-47), reachable here only
# when a camera's far plane exceeds its draw_distance. Scenes can tune
# these via EngineConfig.lov_fractions (the custom_level_of_view
# analogue, model_storage.rs:294-298).
DEFAULT_LOV_FRACTIONS = (0.10, 0.25, 0.45, 0.70, 1.00)

# Reference-parity default Blinn-Phong exponent (second_pass_frag.glsl:66).
DEFAULT_SHININESS = 64.0


def pack_spec_shin(spec, shin):
    """Quantize-pack (specular strength, shininess exponent) into ONE f32
    channel for varying-shininess scenes: strength in 1/1024 steps over
    [0, 4), exponent integer-rounded into [1, 2047]. The packed value is
    an integer below 2^23, so the f32 round-trip is exact and the
    winner-row resolve transports it losslessly. Every path (jnp golden, tiled
    XLA, fused Pallas) consumes the SAME quantized values (mat_*_eff), so
    path parity is bit-exact."""
    sq = jnp.round(jnp.clip(spec, 0.0, 4.0 - 1.0 / 1024.0) * 1024.0)
    hq = jnp.round(jnp.clip(shin, 1.0, 2047.0))
    return hq * 4096.0 + sq


def unpack_spec_shin(packed):
    """Inverse of pack_spec_shin -> (strength, exponent). Division by the
    power-of-two base and the floor are exact in f32."""
    hq = jnp.floor(packed * (1.0 / 4096.0))
    sq = packed - hq * 4096.0
    return sq * (1.0 / 1024.0), hq


@partial(
    jax.tree_util.register_dataclass,
    data_fields=[
        "vertices", "normals", "uvs", "tri_v", "tri_material",
        "tri_offset", "tri_count", "vtx_offset",
        "aabb_min", "aabb_max",
        "mat_albedo", "mat_emissive", "mat_alpha", "mat_specular",
        "mat_shininess", "mat_textures",
        "lov_table", "lov_fractions",
    ],
    meta_fields=["names"],
)
@dataclasses.dataclass(frozen=True)
class ModelBank:
    vertices: jnp.ndarray  # (V, 3)
    normals: jnp.ndarray  # (V, 3)
    uvs: jnp.ndarray  # (V, 2)
    tri_v: jnp.ndarray  # (F, 3) int32, global vertex ids
    tri_material: jnp.ndarray  # (F,) int32 into material table
    tri_offset: jnp.ndarray  # (M,) int32
    tri_count: jnp.ndarray  # (M,) int32
    vtx_offset: jnp.ndarray  # (M,) int32 (bookkeeping)
    aabb_min: jnp.ndarray  # (M, 3) object-space AABB
    aabb_max: jnp.ndarray  # (M, 3)
    mat_albedo: jnp.ndarray  # (K, 3)
    mat_emissive: jnp.ndarray  # (K,) 0 = lit, >0 = emissive brightness
    mat_alpha: jnp.ndarray  # (K,) 1 = opaque
    # per-material specular strength multiplying the Blinn-Phong specular
    # term — the gAlbedoSpec alpha-channel semantics
    # (first_pass_frag.glsl:84, second_pass_frag.glsl:127-133)
    mat_specular: jnp.ndarray  # (K,)
    # per-material Blinn-Phong specular exponent (MTL ``Ns`` — the scalar
    # half of the reference's SHININESS_INDEX texture role,
    # model_definitions.rs:77-81). Default 64.0, the reference's hardcoded
    # exponent (second_pass_frag.glsl:66). Consumed on every shading path;
    # when all materials share one value the paths use it as a
    # compile-time constant (see uniform_shininess).
    mat_shininess: jnp.ndarray  # (K,)
    # per-material texture ROW — the reference packs 5 texture (array,
    # layer) pairs per vertex (model_definitions.rs:71-148); here the row
    # lives per MATERIAL: [diffuse, specular, emissive, normal, dissolve,
    # shininess], -1 = unset. Column 0 (diffuse) drives albedo sampling;
    # column 1 multiplies the scalar specular strength (gAlbedoSpec.a
    # semantics); column 2 multiplies the scalar emissive brightness;
    # column 5 (MTL map_Ns) is loaded and error-textured for parity with
    # the reference's packing but not yet sampled per pixel — the
    # reference's own second pass never samples it either (its exponent
    # is the hardcoded 64.0, second_pass_frag.glsl:66,87,110).
    mat_textures: jnp.ndarray  # (K, 6) int32 atlas texture ids
    lov_table: jnp.ndarray  # (M, NUM_LOV_BANDS + 1) int32 bank entries
    lov_fractions: jnp.ndarray  # (NUM_LOV_BANDS,) of draw distance
    names: tuple  # (M,) model names, static

    @property
    def tri_packed(self) -> jnp.ndarray:
        """(F, 5) f32 [v0 v1 v2 material transparent]: the geometry stage's
        per-triangle gather as ONE f32 row instead of several int-typed
        gathers (ids stay far below 2^24 so the round-trip is exact). Column 4 is the STATIC half of the
        transparency routing — material alpha < 1 or a dissolve map
        (geometry.py consumes it instead of re-gathering mat_alpha /
        mat_texture_diss per batch row: two ~0.17 ms scalar-memory gathers
        on the device trace; here the bank rides the jitted frame as a
        constant, so the per-material gather chain constant-folds and the
        channel is width-free on the existing row gather). Built per trace
        — a concat of bank constants, negligible. Note the clip below
        mirrors the geometry stage's downstream mat_safe clamping (an
        out-of-range id — unreachable through the builder — inherits
        material 0's transparency rather than faulting); column 3 keeps
        the raw id on purpose so the clamp happens exactly once per
        consumer."""
        mat_safe = jnp.clip(self.tri_material, 0,
                            self.mat_alpha.shape[0] - 1)
        transp = ((self.mat_alpha[mat_safe] < 1.0)
                  | (self.mat_textures[mat_safe, 4] >= 0))
        return jnp.concatenate(
            [self.tri_v.astype(jnp.float32),
             self.tri_material.astype(jnp.float32)[:, None],
             transp.astype(jnp.float32)[:, None]],
            axis=1,
        )

    @property
    def vert_packed(self) -> jnp.ndarray:
        """(V, 8) f32 [pos 3 | normal 3 | uv 2]: the lit geometry stage's
        per-vertex gather as ONE row. Random row gathers are latency-bound
        per ROW (~10 ns regardless of width), so one 8-wide gather beats
        the three same-index gathers of vertices/normals/uvs it replaces
        at a third of the rows. Built per trace — a constant-folded
        concat. The depth-only (shadow) path keeps the narrow
        ``vertices`` table: it never reads normals/uvs, so the extra
        bytes would be pure waste there."""
        return jnp.concatenate([self.vertices, self.normals, self.uvs],
                               axis=1)

    @property
    def mat_texture(self) -> jnp.ndarray:
        """(K,) diffuse texture id view (-1 = solid color) — column 0 of
        ``mat_textures``; the pre-multi-texture consumers read this."""
        return self.mat_textures[:, 0]

    @property
    def mat_texture_spec(self) -> jnp.ndarray:
        """(K,) specular-map texture id view (-1 = none)."""
        return self.mat_textures[:, 1]

    @property
    def mat_texture_emis(self) -> jnp.ndarray:
        """(K,) emissive-map texture id view (-1 = none)."""
        return self.mat_textures[:, 2]

    def has_specular_maps(self) -> bool:
        """Trace-time gate: True if any material carries a specular map, so
        frame builders can skip the spec-map sampling channels entirely for
        scenes without one. The bank is closed over by the jitted frame
        programs (never a jit argument), so ``mat_textures`` is concrete
        even while tracing — but it must be read WITHOUT jnp ops (a jnp
        slice of a constant inside a trace yields a tracer)."""
        import numpy as _np

        return bool((_np.asarray(self.mat_textures)[:, 1] >= 0).any())

    @property
    def mat_texture_norm(self) -> jnp.ndarray:
        """Per-material tangent-space normal-map texture id (column 3)."""
        return self.mat_textures[:, 3]

    def has_normal_maps(self) -> bool:
        """Trace-time gate like ``has_specular_maps`` for column 3."""
        import numpy as _np

        return bool((_np.asarray(self.mat_textures)[:, 3] >= 0).any())

    @property
    def mat_texture_diss(self) -> jnp.ndarray:
        """Per-material dissolve (alpha) map texture id (column 4)."""
        return self.mat_textures[:, 4]

    def has_dissolve_maps(self) -> bool:
        """Trace-time gate like ``has_specular_maps`` for column 4."""
        import numpy as _np

        return bool((_np.asarray(self.mat_textures)[:, 4] >= 0).any())

    def has_emissive_maps(self) -> bool:
        """Trace-time gate like ``has_specular_maps`` for column 2."""
        import numpy as _np

        return bool((_np.asarray(self.mat_textures)[:, 2] >= 0).any())

    @property
    def mat_texture_shin(self) -> jnp.ndarray:
        """Per-material shininess (specular exponent) map id (column 5,
        MTL map_Ns — the reference's SHININESS_INDEX role)."""
        return self.mat_textures[:, 5]

    def has_shininess_maps(self) -> bool:
        """Trace-time gate like ``has_specular_maps`` for column 5."""
        import numpy as _np

        return bool((_np.asarray(self.mat_textures)[:, 5] >= 0).any())

    def uniform_shininess(self):
        """Trace-time gate: the single shared specular exponent when every
        material agrees (the overwhelmingly common case — the reference
        hardcodes ONE exponent for the whole scene), else None. Uniform
        scenes keep the exponent as a compile-time constant on every
        shading path (XLA strength-reduces the constant pow; the packed
        attribute channel stays pure specular strength). Varying scenes
        switch channel 34 to the quantized (spec, shininess) packing —
        see pack_spec_shin."""
        import numpy as _np

        s = _np.asarray(self.mat_shininess)
        if s.size == 0 or bool((s == s[0]).all()):
            return float(s[0]) if s.size else 64.0
        return None

    @property
    def mat_specular_eff(self) -> jnp.ndarray:
        """Specular strengths as every shading path consumes them: raw
        when shininess is uniform, quantized (1/1024 steps) otherwise so
        the packed-channel paths and the per-material-gather paths agree
        bit-for-bit."""
        if self.uniform_shininess() is not None:
            return self.mat_specular
        return unpack_spec_shin(
            pack_spec_shin(self.mat_specular, self.mat_shininess))[0]

    @property
    def mat_shininess_eff(self) -> jnp.ndarray:
        """Shininess exponents as consumed (integer-rounded when varying,
        matching the packed channel's decode)."""
        if self.uniform_shininess() is not None:
            return self.mat_shininess
        return unpack_spec_shin(
            pack_spec_shin(self.mat_specular, self.mat_shininess))[1]

    @property
    def mat_spec_shin_packed(self) -> jnp.ndarray:
        """(K,) f32 packed (specular strength, shininess) per material for
        attribute channel 34 in varying-shininess scenes (exact in f32:
        the packed integer stays below 2^23)."""
        return pack_spec_shin(self.mat_specular, self.mat_shininess)

    @property
    def num_models(self) -> int:
        return len(self.names)

    @property
    def num_triangles(self) -> int:
        return self.tri_v.shape[0]

    def model_index(self, name: str) -> int:
        return self.names.index(name)

    def lov_model_id(self, model_id, distance, draw_distance, band_bias=0):
        """Vectorized (model, camera distance) -> bank entry with the LoV
        band applied (the ModelId bit-packing replacement). ``model_id``
        int32 (N,), ``distance`` f32 (N,). ``band_bias`` shifts every
        selection toward coarser bands — the shadow pass's own LoV
        (the reference's shadow_render_system_lov,
        src/threads/render_thread.rs:97-104, load_models.rs:27)."""
        frac = distance / jnp.float32(draw_distance)
        band = jnp.searchsorted(self.lov_fractions, frac, side="right")
        band = jnp.clip(band + band_bias, 0, NUM_LOV_BANDS)  # L = beyond last
        safe = jnp.clip(model_id, 0, self.lov_table.shape[0] - 1)
        return jnp.where(
            model_id >= 0,
            self.lov_table[safe, band],
            model_id,
        )


class ModelBankBuilder:
    """Host-side accumulation of meshes + materials, then freeze."""

    def __init__(self, lov_fractions=DEFAULT_LOV_FRACTIONS):
        self._v, self._n, self._uv = [], [], []
        self._tri, self._tri_mat = [], []
        self._models = []  # (name, vtx_off, tri_off, tri_count, mn, mx)
        self._mats = []  # dict(albedo, emissive, alpha, texture)
        self._lov = {}  # model index -> list of (band model indices)
        self._lov_fractions = tuple(lov_fractions)
        # material 0: the error material — the reference keeps an
        # error-texture array of named colors (helper_constructs.rs:2-12)
        self.add_material(albedo=(1.0, 0.0, 1.0))

    # ----------------------------------------------------------- materials
    def add_material(self, albedo=(1.0, 1.0, 1.0), emissive=0.0, alpha=1.0,
                     texture=-1, specular=1.0, texture_specular=-1,
                     texture_emissive=-1, texture_normal=-1,
                     texture_dissolve=-1, shininess=DEFAULT_SHININESS,
                     texture_shininess=-1) -> int:
        """``texture``: diffuse atlas texture id (-1 = solid ``albedo``);
        ``texture_specular``: specular map whose red channel multiplies
        ``specular`` per pixel; ``texture_emissive``: emissive map whose
        red channel multiplies ``emissive`` per pixel;
        ``texture_normal``: tangent-space normal map perturbing the
        G-buffer normal; ``texture_dissolve``: per-pixel alpha map (MTL
        map_d) multiplying ``alpha`` — a dissolve-mapped material always
        takes the transparent forward pass (-1 = none). All five of the
        reference's per-vertex texture pairs
        (model_definitions.rs:71-148), stored per material."""
        self._mats.append(
            dict(albedo=np.asarray(albedo, np.float32),
                 emissive=float(emissive), alpha=float(alpha),
                 texture=int(texture), specular=float(specular),
                 texture_specular=int(texture_specular),
                 texture_emissive=int(texture_emissive),
                 texture_normal=int(texture_normal),
                 texture_dissolve=int(texture_dissolve),
                 shininess=float(shininess),
                 texture_shininess=int(texture_shininess))
        )
        return len(self._mats) - 1

    # -------------------------------------------------------------- models
    def add_model(self, name, mesh, material: int | None = None,
                  tri_material=None) -> int:
        """Register a mesh. Either one ``material`` id for all triangles or
        a per-triangle ``tri_material`` array (ids from add_material)."""
        v, n, uv, f = mesh
        if material is None and tri_material is None:
            material = 0
        vtx_off = sum(len(x) for x in self._v)
        tri_off = sum(len(x) for x in self._tri)
        self._v.append(np.asarray(v, np.float32))
        self._n.append(np.asarray(n, np.float32))
        self._uv.append(np.asarray(uv, np.float32))
        self._tri.append(np.asarray(f, np.int32) + vtx_off)
        if tri_material is not None:
            self._tri_mat.append(np.asarray(tri_material, np.int32))
        else:
            self._tri_mat.append(np.full(len(f), material, np.int32))
        mn = v.min(axis=0) if len(v) else np.zeros(3, np.float32)
        mx = v.max(axis=0) if len(v) else np.zeros(3, np.float32)
        self._models.append((name, vtx_off, tri_off, len(f), mn, mx))
        return len(self._models) - 1

    def add_obj(self, name, path, atlas_builder=None) -> int:
        """Load an OBJ with its MTL materials (the tobj path,
        model_storage.rs:116-266): Kd diffuse colors, Ks specular strength,
        and — when an ``atlas_builder`` (render.textures.TextureAtlasBuilder)
        is given — map_Kd texture images loaded relative to the OBJ into
        atlas layers."""
        import os

        from render_engine_tpu.models.obj_loader import load_obj

        v, n, uv, f, tri_mat, mats = load_obj(path)
        base = os.path.dirname(os.path.abspath(path))
        ids = []
        for m in mats:
            tex = spec_tex = emis_tex = norm_tex = diss_tex = shin_tex = -1
            if atlas_builder is not None:
                # missing files land on the loud error texture inside
                # add_image_file (helper_constructs.rs:2-12 parity)
                if m.get("map_kd"):
                    tex = atlas_builder.add_image_file(
                        os.path.join(base, m["map_kd"]))
                if m.get("map_ks"):
                    spec_tex = atlas_builder.add_image_file(
                        os.path.join(base, m["map_ks"]), kind="specular")
                if m.get("map_ke"):
                    emis_tex = atlas_builder.add_image_file(
                        os.path.join(base, m["map_ke"]), kind="emissive")
                if m.get("map_bump"):
                    norm_tex = atlas_builder.add_image_file(
                        os.path.join(base, m["map_bump"]), kind="normal")
                if m.get("map_d"):
                    diss_tex = atlas_builder.add_image_file(
                        os.path.join(base, m["map_d"]), kind="dissolve")
                if m.get("map_ns"):
                    shin_tex = atlas_builder.add_image_file(
                        os.path.join(base, m["map_ns"]), kind="shininess")
            ids.append(self.add_material(
                albedo=m["kd"], specular=m.get("ks", 1.0),
                emissive=m.get("ke", 0.0), alpha=m.get("d", 1.0),
                shininess=m.get("ns", DEFAULT_SHININESS),
                texture=tex,
                texture_specular=spec_tex, texture_emissive=emis_tex,
                texture_normal=norm_tex, texture_dissolve=diss_tex,
                texture_shininess=shin_tex))
        remap = np.asarray(ids, np.int32)[tri_mat]
        return self.add_model(name, (v, n, uv, f), tri_material=remap)

    def set_levels_of_view(self, model: int, band_models: list[int]):
        """Per-band bank entries, nearest first; padded with the last entry
        to NUM_LOV_BANDS + 1 (the reference's per-model LoV registry,
        render_system.rs:603-625)."""
        chain = list(band_models)
        while len(chain) < NUM_LOV_BANDS + 1:
            chain.append(chain[-1])
        self._lov[model] = chain[: NUM_LOV_BANDS + 1]

    # ------------------------------------------------------------ finalize
    def finalize(self) -> ModelBank:
        if not self._models:
            raise ValueError("empty model bank")
        v = np.concatenate(self._v)
        n = np.concatenate(self._n)
        uv = np.concatenate(self._uv)
        tri = np.concatenate(self._tri)
        tri_mat = np.concatenate(self._tri_mat)
        m = len(self._models)
        lov = np.zeros((m, NUM_LOV_BANDS + 1), np.int32)
        for i in range(m):
            lov[i] = self._lov.get(i, [i] * (NUM_LOV_BANDS + 1))
        return ModelBank(
            vertices=jnp.asarray(v),
            normals=jnp.asarray(n),
            uvs=jnp.asarray(uv),
            tri_v=jnp.asarray(tri),
            tri_material=jnp.asarray(tri_mat),
            tri_offset=jnp.asarray([x[2] for x in self._models], jnp.int32),
            tri_count=jnp.asarray([x[3] for x in self._models], jnp.int32),
            vtx_offset=jnp.asarray([x[1] for x in self._models], jnp.int32),
            aabb_min=jnp.asarray(np.stack([x[4] for x in self._models])),
            aabb_max=jnp.asarray(np.stack([x[5] for x in self._models])),
            mat_albedo=jnp.asarray(np.stack([d["albedo"] for d in self._mats])),
            mat_emissive=jnp.asarray([d["emissive"] for d in self._mats],
                                     jnp.float32),
            mat_alpha=jnp.asarray([d["alpha"] for d in self._mats], jnp.float32),
            mat_specular=jnp.asarray([d.get("specular", 1.0) for d in self._mats],
                                     jnp.float32),
            mat_shininess=jnp.asarray(
                [d.get("shininess", DEFAULT_SHININESS) for d in self._mats],
                jnp.float32),
            mat_textures=jnp.asarray(
                [[d["texture"], d.get("texture_specular", -1),
                  d.get("texture_emissive", -1),
                  d.get("texture_normal", -1),
                  d.get("texture_dissolve", -1),
                  d.get("texture_shininess", -1)]
                 for d in self._mats], jnp.int32),
            lov_table=jnp.asarray(lov),
            lov_fractions=jnp.asarray(self._lov_fractions, jnp.float32),
            names=tuple(x[0] for x in self._models),
        )
