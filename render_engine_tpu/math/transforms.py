"""Rotations (quaternion / axis-angle), TRS composition, projections.

Replaces the reference's nalgebra-glm math and its per-entity
TransformationMatrix recomputation (reference
src/helper_things/entity_change_helpers.rs:217-262,
src/exports/entity_transformer.rs:77-143). Everything broadcasts over leading
batch axes: composing 100k entity matrices is one fused op.

Conventions (we own them — this is not a GL port, but we keep GL clip space so
the reference's frustum/PCF math carries over unchanged):
  * column vectors: p' = M @ p, matrices are (..., 4, 4) float32.
  * right-handed world, +Y up, camera looks down -Z in view space.
  * clip space: GL-style, NDC in [-1, 1]^3 after perspective divide.
  * quaternions stored (w, x, y, z).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# A float32 matmul at DEFAULT precision may run in reduced precision on an
# accelerator (TF32 on NVIDIA tensor cores keeps ~10 mantissa bits). That
# silently corrupts COORDINATE math: a `proj @ view` composed in reduced
# precision moves the Gribb-Hartmann far plane (r3 - r2, catastrophic
# cancellation at far/near = 400) by many world units and flips
# aabb_in_frustum for casters well inside the volume. Every matrix compose /
# point transform here pins full f32 (HIGHEST) — their FLOPs are trivial,
# the error is not.
MM_PRECISION = jax.lax.Precision.HIGHEST


def mm44(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """4x4 (or batched) matrix compose at full f32 precision — use this for
    every proj/view/light matrix product instead of ``a @ b``."""
    return jnp.matmul(a, b, precision=MM_PRECISION)


def inv44(m: jnp.ndarray) -> jnp.ndarray:
    """Matrix inverse with its internal products pinned to full f32 —
    ``jnp.linalg.inv`` at DEFAULT precision inherits the bf16 rounding."""
    with jax.default_matmul_precision("float32"):
        return jnp.linalg.inv(m)


# ---------------------------------------------------------------------------
# Quaternions
# ---------------------------------------------------------------------------


def quat_identity(shape=()) -> jnp.ndarray:
    q = jnp.zeros(shape + (4,), jnp.float32)
    return q.at[..., 0].set(1.0)


def quat_from_axis_angle(axis: jnp.ndarray, angle: jnp.ndarray) -> jnp.ndarray:
    """Unit quaternion for rotation of ``angle`` radians about ``axis``.

    ``axis`` (...,3) need not be normalized (zero axis => identity); ``angle``
    (...,). This is the jnp analogue of the reference's Rotation component
    (axis + angle, reference src/exports/movement_components.rs).
    """
    n = jnp.linalg.norm(axis, axis=-1, keepdims=True)
    safe = jnp.where(n > 1e-12, n, 1.0)
    u = jnp.where(n > 1e-12, axis / safe, 0.0)
    half = 0.5 * angle[..., None]
    return jnp.concatenate([jnp.cos(half), jnp.sin(half) * u], axis=-1)


def quat_from_rotvec(rotvec: jnp.ndarray) -> jnp.ndarray:
    """Quaternion from a rotation vector (axis * radians), (...,3)->(...,4)."""
    angle = jnp.linalg.norm(rotvec, axis=-1)
    return quat_from_axis_angle(rotvec, angle)


def quat_mul(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Hamilton product a*b (apply b first, then a)."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return jnp.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        axis=-1,
    )


def quat_normalize(q: jnp.ndarray) -> jnp.ndarray:
    n = jnp.linalg.norm(q, axis=-1, keepdims=True)
    return q / jnp.where(n > 1e-12, n, 1.0)


def quat_to_matrix(q: jnp.ndarray) -> jnp.ndarray:
    """(...,4) -> (...,3,3) rotation matrix."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = jnp.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        axis=-1,
    )
    return m.reshape(m.shape[:-1] + (3, 3))


def quat_rotate(q: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Rotate vectors (...,3) by quaternions (...,4)."""
    qv = q[..., 1:]
    w = q[..., :1]
    t = 2.0 * jnp.cross(qv, v)
    return v + w * t + jnp.cross(qv, t)


# ---------------------------------------------------------------------------
# Affine composition
# ---------------------------------------------------------------------------


def compose_trs(translation, quat, scale) -> jnp.ndarray:
    """T @ R @ S as a (..., 4, 4) matrix.

    Matches the reference's entity matrix composition order
    (entity_transformer.rs:77-143: translate, then rotate, then scale).
    """
    rot = quat_to_matrix(quat)  # (...,3,3)
    rs = rot * scale[..., None, :]  # scale columns
    batch = jnp.broadcast_shapes(rs.shape[:-2], translation.shape[:-1])
    m = jnp.zeros(batch + (4, 4), jnp.float32)
    m = m.at[..., :3, :3].set(rs)
    m = m.at[..., :3, 3].set(translation)
    m = m.at[..., 3, 3].set(1.0)
    return m


def apply_transform(matrix, points) -> jnp.ndarray:
    """Apply (...,4,4) affine to (...,N,3) points -> (...,N,3)."""
    rot = matrix[..., :3, :3]
    trans = matrix[..., :3, 3]
    return jnp.einsum("...ij,...nj->...ni", rot, points,
                      precision=MM_PRECISION) + trans[..., None, :]


def translation_update(matrix, new_translation) -> jnp.ndarray:
    """Patch only column 3 — the reference's translation-only fast path
    (entity_change_helpers.rs:276-323)."""
    return matrix.at[..., :3, 3].set(new_translation)


# ---------------------------------------------------------------------------
# View / projection
# ---------------------------------------------------------------------------


def look_at(eye, target, up) -> jnp.ndarray:
    """Right-handed look-at view matrix, (4,4)."""
    eye = jnp.asarray(eye, jnp.float32)
    f = target - eye
    f = f / jnp.linalg.norm(f)
    up = jnp.asarray(up, jnp.float32)
    s = jnp.cross(f, up)
    s = s / jnp.linalg.norm(s)
    u = jnp.cross(s, f)
    m = jnp.eye(4, dtype=jnp.float32)
    m = m.at[0, :3].set(s)
    m = m.at[1, :3].set(u)
    m = m.at[2, :3].set(-f)
    m = m.at[0, 3].set(-jnp.dot(s, eye, precision=MM_PRECISION))
    m = m.at[1, 3].set(-jnp.dot(u, eye, precision=MM_PRECISION))
    m = m.at[2, 3].set(jnp.dot(f, eye, precision=MM_PRECISION))
    return m


def perspective(fov_y_rad, aspect, near, far) -> jnp.ndarray:
    """GL-style perspective projection, NDC z in [-1, 1]."""
    t = 1.0 / jnp.tan(0.5 * jnp.asarray(fov_y_rad, jnp.float32))
    m = jnp.zeros((4, 4), jnp.float32)
    m = m.at[0, 0].set(t / aspect)
    m = m.at[1, 1].set(t)
    m = m.at[2, 2].set((far + near) / (near - far))
    m = m.at[2, 3].set(2.0 * far * near / (near - far))
    m = m.at[3, 2].set(-1.0)
    return m


def orthographic(left, right, bottom, top, near, far) -> jnp.ndarray:
    """GL-style orthographic projection (used by directional-light shadow
    cameras, reference src/flows/shadow_flow.rs:140-204)."""
    m = jnp.eye(4, dtype=jnp.float32)
    m = m.at[0, 0].set(2.0 / (right - left))
    m = m.at[1, 1].set(2.0 / (top - bottom))
    m = m.at[2, 2].set(-2.0 / (far - near))
    m = m.at[0, 3].set(-(right + left) / (right - left))
    m = m.at[1, 3].set(-(top + bottom) / (top - bottom))
    m = m.at[2, 3].set(-(far + near) / (far - near))
    return m


def direction_from_yaw_pitch(yaw_rad, pitch_rad) -> jnp.ndarray:
    """Camera forward vector from yaw/pitch (radians), GL convention:
    yaw = -90deg looks down -Z. Mirrors reference camera_object.rs mouse-look."""
    cy, sy = jnp.cos(yaw_rad), jnp.sin(yaw_rad)
    cp, sp = jnp.cos(pitch_rad), jnp.sin(pitch_rad)
    d = jnp.stack([cy * cp, sp, sy * cp], axis=-1)
    return d / jnp.linalg.norm(d, axis=-1, keepdims=True)


# ---------------------------------------------------------------------------
# Frustum planes
# ---------------------------------------------------------------------------


def frustum_planes(proj_view: jnp.ndarray) -> jnp.ndarray:
    """Extract 6 clip planes (Gribb-Hartmann) from P @ V, shape (6, 4).

    A point p is inside plane i iff dot(planes[i, :3], p) + planes[i, 3] >= 0.
    Mirrors the reference's RenderFrustumCuller plane extraction
    (src/culling/render_frustum_culler.rs:18-119).
    Order: left, right, bottom, top, near, far.
    """
    r0, r1, r2, r3 = proj_view[0], proj_view[1], proj_view[2], proj_view[3]
    planes = jnp.stack(
        [r3 + r0, r3 - r0, r3 + r1, r3 - r1, r3 + r2, r3 - r2], axis=0
    )
    n = jnp.linalg.norm(planes[:, :3], axis=-1, keepdims=True)
    return planes / jnp.where(n > 1e-12, n, 1.0)
