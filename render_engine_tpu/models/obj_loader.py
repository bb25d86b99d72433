"""Wavefront OBJ (+ MTL) loading, host-side numpy.

Parity with the reference's tobj-based loader (src/models/model_storage.rs:
116-266): triangulated faces, per-mesh material with diffuse color (only the
diffuse channel is consumed, model_storage.rs:190-193 — MTL ``Kd`` or a
texture map name), vertices/normals/texcoords unified per face-vertex.

Returns the same mesh tuple shape as primitives: (vertices, normals, uvs,
triangles), plus per-triangle material indices and a material table.
"""

from __future__ import annotations

import os

import numpy as np


def load_mtl(path: str) -> dict:
    """Parse an MTL file -> {name: {"kd": (3,), "map_kd": str|None,
    "ks": float, "map_ks": str|None, "ke": float, "map_ke": str|None,
    "map_bump": str|None, "ns": float, "map_ns": str|None}}
    (the tobj material fields the reference consumes,
    model_storage.rs:190-193, plus the specular/emissive/normal/shininess
    map slots of its per-vertex texture pairs, model_definitions.rs:71-148;
    the normal map accepts the map_Bump / bump / norm spellings). ``ns``
    defaults to 64.0 — the reference's hardcoded Blinn-Phong exponent
    (second_pass_frag.glsl:66)."""
    mats = {}
    cur = None
    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            if parts[0] == "newmtl":
                cur = parts[1]
                mats[cur] = {"kd": np.array([1.0, 1.0, 1.0], np.float32),
                             "map_kd": None, "ks": 1.0, "map_ks": None,
                             "ke": 0.0, "map_ke": None, "map_bump": None,
                             "map_d": None, "d": 1.0,
                             "ns": 64.0, "map_ns": None}
            elif cur is not None and parts[0] == "Kd":
                mats[cur]["kd"] = np.array(parts[1:4], np.float32)
            elif cur is not None and parts[0] == "Ks":
                # specular color -> scalar strength (gAlbedoSpec.a role)
                mats[cur]["ks"] = float(np.mean(
                    np.array(parts[1:4], np.float32)))
            elif cur is not None and parts[0] == "Ke":
                # emissive color -> scalar brightness (the engine's
                # emissive-bypass semantics)
                mats[cur]["ke"] = float(np.mean(
                    np.array(parts[1:4], np.float32)))
            elif cur is not None and parts[0] == "Ns":
                # specular exponent (the shininess role's scalar half)
                mats[cur]["ns"] = float(parts[1])
            elif cur is not None and parts[0] == "map_Kd":
                mats[cur]["map_kd"] = parts[-1]
            elif cur is not None and parts[0] == "map_Ks":
                mats[cur]["map_ks"] = parts[-1]
            elif cur is not None and parts[0] == "map_Ke":
                mats[cur]["map_ke"] = parts[-1]
            elif cur is not None and parts[0] == "map_Ns":
                mats[cur]["map_ns"] = parts[-1]
            elif cur is not None and parts[0] in ("map_Bump", "map_bump",
                                                  "bump", "norm"):
                mats[cur]["map_bump"] = parts[-1]
            elif cur is not None and parts[0] == "map_d":
                mats[cur]["map_d"] = parts[-1]
            elif cur is not None and parts[0] == "d":
                mats[cur]["d"] = float(parts[1])
    return mats


def _load_obj_native(path: str):
    """Parse via the C++ core (native/obj_loader.cpp) — tobj-speed parsing
    for large assets; None when the native library is unavailable or the
    file trips a parse guard (caller falls back to the Python parser).
    Material resolution replays the Python semantics over the returned
    usemtl/mtllib records: each first-use name resolves against the latest
    successfully-loaded mtllib at that point."""
    import ctypes

    from render_engine_tpu.native.build import obj_native

    lib = obj_native()
    if lib is None:
        return None
    handle = lib.obj_parse(os.fsencode(path))
    if not handle:
        return None
    try:
        c = ctypes
        nv, nf = c.c_int64(), c.c_int64()
        n_names, n_libs = c.c_int32(), c.c_int32()
        names_len, libs_len = c.c_int64(), c.c_int64()
        lib.obj_counts(handle, c.byref(nv), c.byref(nf), c.byref(n_names),
                       c.byref(n_libs), c.byref(names_len),
                       c.byref(libs_len))
        v = np.empty((nv.value, 3), np.float32)
        n = np.empty((nv.value, 3), np.float32)
        uv = np.empty((nv.value, 2), np.float32)
        tris = np.empty((nf.value, 3), np.int32)
        tri_slot = np.empty(nf.value, np.int32)
        names_buf = ctypes.create_string_buffer(max(names_len.value, 1))
        libs_buf = ctypes.create_string_buffer(max(libs_len.value, 1))
        name_lib = np.empty(max(n_names.value, 1), np.int32)
        fp = c.POINTER(c.c_float)
        ip = c.POINTER(c.c_int32)
        lib.obj_copy(handle,
                     v.ctypes.data_as(fp), n.ctypes.data_as(fp),
                     uv.ctypes.data_as(fp), tris.ctypes.data_as(ip),
                     tri_slot.ctypes.data_as(ip), names_buf,
                     name_lib.ctypes.data_as(ip), libs_buf)
    finally:
        lib.obj_free(handle)

    lib_tokens = (libs_buf.raw[:libs_len.value].decode().split("\0")[:-1]
                  if libs_len.value else [])
    names = (names_buf.raw[:names_len.value].decode().split("\0")[:-1]
             if names_len.value else [])

    # replay the Python parser's mtllib/usemtl timing: ``mtl`` holds the
    # latest EXISTING mtllib's table at each point in the file
    mtl_at: list = []  # effective table after lib k
    eff: dict = {}
    for tok in lib_tokens:
        mpath = os.path.join(os.path.dirname(path), tok)
        if os.path.exists(mpath):
            eff = load_mtl(mpath)
        mtl_at.append(eff)
    materials = [{"name": "__default__",
                  "kd": np.array([1.0, 1.0, 1.0], np.float32),
                  "map_kd": None, "ks": 1.0, "map_ks": None,
                  "ke": 0.0, "map_ke": None, "map_bump": None,
                  "map_d": None, "d": 1.0, "ns": 64.0, "map_ns": None}]
    for i, name in enumerate(names):
        k = int(name_lib[i])
        info = (mtl_at[k] if 0 <= k < len(mtl_at) else {}).get(name, {})
        materials.append({
            "name": name,
            "kd": np.asarray(info.get("kd", [1.0, 1.0, 1.0]), np.float32),
            "map_kd": info.get("map_kd"),
            "ks": float(info.get("ks", 1.0)),
            "map_ks": info.get("map_ks"),
            "ke": float(info.get("ke", 0.0)),
            "map_ke": info.get("map_ke"),
            "map_bump": info.get("map_bump"),
            "map_d": info.get("map_d"),
            "d": float(info.get("d", 1.0)),
            "ns": float(info.get("ns", 64.0)),
            "map_ns": info.get("map_ns"),
        })
    return v, n, uv, tris, tri_slot, materials


def _fill_missing_normals(v, n, tris):
    """Area-weighted face-normal fill for corners without a vn record —
    shared by the native and Python parse paths."""
    if len(tris) and (np.linalg.norm(n, axis=1) < 1e-8).any():
        f = np.asarray(tris, np.int32)
        e1 = v[f[:, 1]] - v[f[:, 0]]
        e2 = v[f[:, 2]] - v[f[:, 0]]
        fn = np.cross(e1, e2)
        fn /= np.maximum(np.linalg.norm(fn, axis=1, keepdims=True), 1e-12)
        acc = np.zeros_like(n)
        for c in range(3):
            np.add.at(acc, f[:, c], fn)
        missing = np.linalg.norm(n, axis=1) < 1e-8
        lens = np.maximum(np.linalg.norm(acc, axis=1, keepdims=True), 1e-12)
        n[missing] = (acc / lens)[missing]
    return n


def load_obj(path: str):
    """Load an OBJ file.

    Returns ``(vertices, normals, uvs, triangles, tri_material, materials)``
    where ``tri_material`` is int32 (F,) indexing ``materials`` (a list of
    {"name", "kd", "map_kd"} dicts; index 0 is a default white material when
    the file declares none).

    The parse core runs natively (native/obj_loader.cpp via ctypes, built
    on first use) with this Python implementation as both the semantic
    specification and the fallback; RE_NATIVE=0 forces the fallback.
    """
    native = _load_obj_native(path)
    if native is not None:
        v, n, uv, tris, tri_slot, materials = native
        n = _fill_missing_normals(v, n.copy(), tris)
        return v, n, uv, tris, tri_slot, materials
    positions, normals_raw, uvs_raw = [], [], []
    corner_map: dict = {}
    out_v, out_n, out_uv = [], [], []
    tris, tri_mat = [], []
    materials = [{"name": "__default__",
                  "kd": np.array([1.0, 1.0, 1.0], np.float32),
                  "map_kd": None, "ks": 1.0, "map_ks": None,
                  "ke": 0.0, "map_ke": None, "map_bump": None,
                  "map_d": None, "d": 1.0, "ns": 64.0, "map_ns": None}]
    mat_index = {"__default__": 0}
    cur_mat = 0
    mtl: dict = {}

    def corner(token: str) -> int:
        if token in corner_map:
            return corner_map[token]
        f = token.split("/")
        vi = int(f[0])
        vi = vi - 1 if vi > 0 else len(positions) + vi
        ti = None
        if len(f) > 1 and f[1]:
            t = int(f[1])
            ti = t - 1 if t > 0 else len(uvs_raw) + t
        ni = None
        if len(f) > 2 and f[2]:
            n = int(f[2])
            ni = n - 1 if n > 0 else len(normals_raw) + n
        idx = len(out_v)
        out_v.append(positions[vi])
        out_uv.append(uvs_raw[ti] if ti is not None else [0.0, 0.0])
        out_n.append(normals_raw[ni] if ni is not None else [0.0, 0.0, 0.0])
        corner_map[token] = idx
        return idx

    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            tag = parts[0]
            if tag == "v":
                positions.append([float(x) for x in parts[1:4]])
            elif tag == "vn":
                normals_raw.append([float(x) for x in parts[1:4]])
            elif tag == "vt":
                uvs_raw.append([float(parts[1]), float(parts[2])])
            elif tag == "mtllib":
                mpath = os.path.join(os.path.dirname(path), parts[1])
                if os.path.exists(mpath):
                    mtl = load_mtl(mpath)
            elif tag == "usemtl":
                name = parts[1]
                if name not in mat_index:
                    info = mtl.get(name, {})
                    materials.append({
                        "name": name,
                        "kd": np.asarray(
                            info.get("kd", [1.0, 1.0, 1.0]), np.float32),
                        "map_kd": info.get("map_kd"),
                        "ks": float(info.get("ks", 1.0)),
                        "map_ks": info.get("map_ks"),
                        "ke": float(info.get("ke", 0.0)),
                        "map_ke": info.get("map_ke"),
                        "map_bump": info.get("map_bump"),
                        "map_d": info.get("map_d"),
                        "d": float(info.get("d", 1.0)),
                        "ns": float(info.get("ns", 64.0)),
                        "map_ns": info.get("map_ns"),
                    })
                    mat_index[name] = len(materials) - 1
                cur_mat = mat_index[name]
            elif tag == "f":
                ids = [corner(t) for t in parts[1:]]
                for k in range(1, len(ids) - 1):  # fan triangulation
                    tris.append([ids[0], ids[k], ids[k + 1]])
                    tri_mat.append(cur_mat)

    v = np.asarray(out_v, np.float32).reshape(-1, 3)
    n = _fill_missing_normals(
        v, np.asarray(out_n, np.float32).reshape(-1, 3), tris)
    return (
        v,
        n.astype(np.float32),
        np.asarray(out_uv, np.float32).reshape(-1, 2),
        np.asarray(tris, np.int32).reshape(-1, 3),
        np.asarray(tri_mat, np.int32),
        materials,
    )
