"""Skybox: cubemap sampling per background pixel.

Replaces the reference's skybox path (CubeMap upload cubemap.rs:57-125, the
mat3(view) + xyww depth trick first_pass_vertex.glsl / render_system.rs:
483-499, and the stencil==0 second-pass draw): instead of rasterizing an
inward cube, background pixels compute their camera ray directly and sample
the cubemap — same result, no geometry, one fused op.
"""

from __future__ import annotations

import jax.numpy as jnp

from render_engine_tpu.math import transforms as T
import numpy as np


def pixel_ray_directions(camera, height: int, width: int) -> jnp.ndarray:
    """World-space ray direction through every pixel center, (H, W, 3)."""
    fwd = camera.direction()
    up0 = jnp.array([0.0, 1.0, 0.0], jnp.float32)
    right = jnp.cross(fwd, up0)
    right = right / jnp.linalg.norm(right)
    up = jnp.cross(right, fwd)
    t = jnp.tan(0.5 * jnp.float32(camera.fov_y))
    x_ndc = (jnp.arange(width, dtype=jnp.float32) + 0.5) / width * 2.0 - 1.0
    y_ndc = 1.0 - (jnp.arange(height, dtype=jnp.float32) + 0.5) / height * 2.0
    d = (
        fwd[None, None]
        + x_ndc[None, :, None] * (t * camera.aspect) * right[None, None]
        + y_ndc[:, None, None] * t * up[None, None]
    )
    return d / jnp.linalg.norm(d, axis=-1, keepdims=True)


def sample_cubemap(cubemap: jnp.ndarray, dirs: jnp.ndarray) -> jnp.ndarray:
    """Bilinear cubemap sample. ``cubemap``: (6, S, S, 3) faces ordered
    +X, -X, +Y, -Y, +Z, -Z (the GL convention the reference uploads in,
    cubemap.rs:57-125); ``dirs``: (..., 3) unit vectors. Shares _face_uv
    with the row sampler so the two stay exactly equivalent."""
    face, u, v = _face_uv(dirs)
    s = cubemap.shape[1]
    uf = (u * 0.5 + 0.5) * (s - 1)
    vf = (v * 0.5 + 0.5) * (s - 1)
    u0 = jnp.clip(jnp.floor(uf).astype(jnp.int32), 0, s - 1)
    v0 = jnp.clip(jnp.floor(vf).astype(jnp.int32), 0, s - 1)
    u1 = jnp.clip(u0 + 1, 0, s - 1)
    v1 = jnp.clip(v0 + 1, 0, s - 1)
    fu = (uf - u0)[..., None]
    fv = (vf - v0)[..., None]

    c00 = cubemap[face, v0, u0]
    c01 = cubemap[face, v0, u1]
    c10 = cubemap[face, v1, u0]
    c11 = cubemap[face, v1, u1]
    return (
        c00 * (1 - fu) * (1 - fv)
        + c01 * fu * (1 - fv)
        + c10 * (1 - fu) * fv
        + c11 * fu * fv
    )


# ---------------------------------------------------------------------------
# Row-gather cubemap sampler
# ---------------------------------------------------------------------------
# A generic per-pixel bilinear sample is four scattered taps; the atlas
# path's fix applies verbatim: precompute every texel's 2x2 bilinear
# footprint as ONE contiguous 64-byte row, then a full-screen sample is a
# single row gather instead of four scattered taps. Costs 5.3x the
# cubemap's memory.

import dataclasses
from functools import partial

import jax


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["rows"],
    meta_fields=["size"],
)
@dataclasses.dataclass(frozen=True)
class CubemapRows:
    rows: jnp.ndarray  # (6*S*S, 16): [c00 c01 c10 c11 | pad] per texel
    size: int


def cubemap_rows(cubemap: jnp.ndarray) -> CubemapRows:
    """Precompute the 2x2-footprint row table for (6, S, S, 3) faces —
    pure shifts (edge-clamped within each face, matching sample_cubemap's
    u1/v1 clamp)."""
    c = np.asarray(cubemap, np.float32)
    s = c.shape[1]
    right = np.concatenate([c[:, :, 1:], c[:, :, -1:]], axis=2)
    down = np.concatenate([c[:, 1:], c[:, -1:]], axis=1)
    downright = np.concatenate([right[:, 1:], right[:, -1:]], axis=1)
    rows = np.concatenate(
        [c, right, down, downright,
         np.zeros(c.shape[:-1] + (4,), np.float32)], axis=-1
    ).reshape(6 * s * s, 16)
    return CubemapRows(rows=jnp.asarray(rows), size=s)


def _face_uv(dirs):
    """Shared face-selection + per-face [-1, 1] uv math (GL orientation)."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    ax, ay, az = jnp.abs(x), jnp.abs(y), jnp.abs(z)
    is_x = (ax >= ay) & (ax >= az)
    is_y = (ay > ax) & (ay >= az)
    face = jnp.where(
        is_x,
        jnp.where(x >= 0, 0, 1),
        jnp.where(is_y, jnp.where(y >= 0, 2, 3), jnp.where(z >= 0, 4, 5)),
    )
    ma = jnp.maximum(jnp.where(is_x, ax, jnp.where(is_y, ay, az)), 1e-9)
    u = jnp.where(
        is_x,
        jnp.where(x >= 0, -z, z),
        jnp.where(is_y, x, jnp.where(z >= 0, x, -x)),
    ) / ma
    v = jnp.where(
        is_x, -y, jnp.where(is_y, jnp.where(y >= 0, z, -z), -y)
    ) / ma
    return face, u, v


def sample_cubemap_rows(cm: CubemapRows, dirs: jnp.ndarray) -> jnp.ndarray:
    """Bilinear cubemap sample matching ``sample_cubemap`` exactly, via one
    row gather per pixel."""
    face, u, v = _face_uv(dirs)
    s = cm.size
    uf = (u * 0.5 + 0.5) * (s - 1)
    vf = (v * 0.5 + 0.5) * (s - 1)
    u0 = jnp.clip(jnp.floor(uf), 0.0, s - 1.0)
    v0 = jnp.clip(jnp.floor(vf), 0.0, s - 1.0)
    fu = (uf - u0)[..., None]
    fv = (vf - v0)[..., None]
    flat = (face * (s * s) + v0.astype(jnp.int32) * s
            + u0.astype(jnp.int32))
    r = cm.rows[flat]  # one contiguous row gather
    return (
        r[..., 0:3] * (1 - fu) * (1 - fv)
        + r[..., 3:6] * fu * (1 - fv)
        + r[..., 6:9] * (1 - fu) * fv
        + r[..., 9:12] * fu * fv
    )


def background_for(camera, cubemap, height: int, width: int,
                   clear_color=(0.0, 0.0, 0.0)) -> jnp.ndarray:
    """(H, W, 3) background for any skybox kind: Starfield splats (demo
    default, O(N) scatter), CubemapRows (one row gather per pixel), a raw
    (6, S, S, 3) cubemap (4-tap gathers — CPU/golden only), or the clear
    color."""
    if isinstance(cubemap, Starfield):
        return starfield_background(camera, cubemap, height, width)
    if isinstance(cubemap, CubemapRows):
        return sample_cubemap_rows(
            cubemap, pixel_ray_directions(camera, height, width))
    if cubemap is not None:
        return sample_cubemap(
            cubemap, pixel_ray_directions(camera, height, width))
    return jnp.broadcast_to(
        jnp.asarray(clear_color, jnp.float32), (height, width, 3))


# ---------------------------------------------------------------------------
# Star-geometry skybox: gather-free background for the space demo
# ---------------------------------------------------------------------------
# Per-pixel cubemap gathers cost a full-screen gather; a starfield is
# really N point
# lights at infinity, so we project the N directions and SCATTER 2x2 splats
# into the background — O(N) instead of O(H*W) work, and sharper stars.


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["dirs", "colors"],
    meta_fields=[],
)
@dataclasses.dataclass(frozen=True)
class Starfield:
    dirs: jnp.ndarray  # (N, 3) unit directions
    colors: jnp.ndarray  # (N, 3) linear color


def make_starfield(n_stars: int = 2400, seed: int = 7) -> Starfield:
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n_stars, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    brightness = rng.uniform(0.25, 1.0, (n_stars, 1)).astype(np.float32)
    tint = rng.uniform(0.85, 1.0, (n_stars, 3)).astype(np.float32)
    return Starfield(
        dirs=jnp.asarray(d, jnp.float32),
        colors=jnp.asarray(brightness * tint),
    )


SPACE_BASE_COLOR = (0.004, 0.005, 0.012)


def starfield_background(camera, stars: Starfield, height: int, width: int,
                         base_color=SPACE_BASE_COLOR) -> jnp.ndarray:
    """(H, W, 3) background: deep-space base + scattered star splats."""
    fwd = camera.direction()
    up0 = jnp.array([0.0, 1.0, 0.0], jnp.float32)
    right = jnp.cross(fwd, up0)
    right = right / jnp.linalg.norm(right)
    up = jnp.cross(right, fwd)
    # view-space components
    dx = jnp.matmul(stars.dirs, right, precision=T.MM_PRECISION)
    dy = jnp.matmul(stars.dirs, up, precision=T.MM_PRECISION)
    dz = jnp.matmul(stars.dirs, fwd,
                    precision=T.MM_PRECISION)  # positive = in front
    t = jnp.tan(0.5 * jnp.float32(camera.fov_y))
    safe = jnp.where(dz > 1e-6, dz, 1.0)
    ndc_x = dx / (safe * t * camera.aspect)
    ndc_y = dy / (safe * t)
    px = ((ndc_x * 0.5 + 0.5) * width).astype(jnp.int32)
    py = ((0.5 - ndc_y * 0.5) * height).astype(jnp.int32)
    ok = (dz > 1e-6) & (px >= 0) & (px < width - 1) & (py >= 0) & (
        py < height - 1
    )
    pxs = jnp.where(ok, px, width + 8)  # out-of-range -> dropped
    pys = jnp.where(ok, py, height + 8)

    bg = jnp.broadcast_to(
        jnp.asarray(base_color, jnp.float32), (height, width, 3)
    )
    for oy in (0, 1):  # 2x2 splat
        for ox in (0, 1):
            w_ = 1.0 if (ox == 0 and oy == 0) else 0.45
            bg = bg.at[pys + oy, pxs + ox].max(stars.colors * w_,
                                               mode="drop")
    return bg


def starfield_cubemap(size: int = 256, stars_per_face: int = 400,
                      seed: int = 7) -> jnp.ndarray:
    """Procedural space skybox for the demo (the reference's 6-face space
    textures, space_logic/skybox.rs, are assets we do not copy)."""
    rng = np.random.default_rng(seed)
    faces = np.zeros((6, size, size, 3), np.float32)
    faces[:] = np.array([0.004, 0.005, 0.012])  # deep-space blue-black
    for f in range(6):
        xs = rng.integers(0, size, stars_per_face)
        ys = rng.integers(0, size, stars_per_face)
        brightness = rng.uniform(0.3, 1.0, stars_per_face).astype(np.float32)
        tint = rng.uniform(0.85, 1.0, (stars_per_face, 3)).astype(np.float32)
        faces[f, ys, xs] = brightness[:, None] * tint
    return jnp.asarray(faces)
