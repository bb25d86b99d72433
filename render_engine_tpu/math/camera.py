"""Camera: a jit-friendly pytree with a host-side builder.

Capability parity with the reference camera (src/exports/camera_object.rs:
position/direction via yaw-pitch, perspective or orthographic projection,
mouse rotation with pitch clamps :221-260, inertial ``float_position``
movement :174-180, ``SerializableCameraInfo`` for replay :48-53, and the full
``CameraBuilder`` :271-581).

Array-native design: the camera is an immutable dataclass of jnp scalars/vectors
registered as a pytree, so it can be carried through the jitted frame step and
recorded bit-exactly in the replay log (serialize = flatten to one f32 vector).
All mutation helpers return a new Camera.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from render_engine_tpu.math import transforms as T

PERSPECTIVE = 0
ORTHOGRAPHIC = 1


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["position", "yaw", "pitch", "velocity"],
    meta_fields=[
        "fov_y", "aspect", "near", "far", "draw_distance",
        "projection_kind", "ortho_half_extent", "movement_factor",
    ],
)
@dataclasses.dataclass(frozen=True)
class Camera:
    # -- dynamic state (traced; recorded per frame for replay) --
    position: jnp.ndarray  # (3,)
    yaw: jnp.ndarray  # scalar, radians
    pitch: jnp.ndarray  # scalar, radians
    velocity: jnp.ndarray  # (3,) inertial velocity (float_position)
    # -- static configuration (trace-time constants) --
    fov_y: float = 0.7853982  # 45 deg
    aspect: float = 16.0 / 9.0
    near: float = 0.1
    far: float = 1000.0
    draw_distance: float = 1000.0
    projection_kind: int = PERSPECTIVE
    ortho_half_extent: float = 100.0
    movement_factor: float = 0.9  # inertial decay per step

    # -- derived ---------------------------------------------------------
    def direction(self) -> jnp.ndarray:
        return T.direction_from_yaw_pitch(self.yaw, self.pitch)

    def view_matrix(self) -> jnp.ndarray:
        return T.look_at(
            self.position,
            self.position + self.direction(),
            jnp.array([0.0, 1.0, 0.0], jnp.float32),
        )

    def projection_matrix(self) -> jnp.ndarray:
        if self.projection_kind == ORTHOGRAPHIC:
            h = self.ortho_half_extent
            return T.orthographic(-h, h, -h / self.aspect, h / self.aspect,
                                  self.near, self.far)
        return T.perspective(self.fov_y, self.aspect, self.near, self.far)

    def proj_view(self) -> jnp.ndarray:
        return T.mm44(self.projection_matrix(), self.view_matrix())

    def frustum_planes(self) -> jnp.ndarray:
        return T.frustum_planes(self.proj_view())

    # -- mutation (pure) --------------------------------------------------
    def with_position(self, position) -> "Camera":
        return dataclasses.replace(self, position=jnp.asarray(position, jnp.float32))

    def rotated(self, d_yaw, d_pitch) -> "Camera":
        """Mouse-look with pitch clamped to +/- 89 deg
        (reference camera_object.rs:221-260)."""
        limit = jnp.float32(89.0 * jnp.pi / 180.0)
        return dataclasses.replace(
            self,
            yaw=self.yaw + d_yaw,
            pitch=jnp.clip(self.pitch + d_pitch, -limit, limit),
        )

    def float_position(self, accel, dt) -> "Camera":
        """Inertial movement: velocity integrates accel then decays by
        movement_factor (reference camera_object.rs:174-180)."""
        vel = (self.velocity + accel * dt) * jnp.float32(self.movement_factor)
        return dataclasses.replace(
            self, velocity=vel, position=self.position + vel * dt
        )

    def force_hard_position(self, position) -> "Camera":
        """Snap to a position, zeroing inertia — the per-frame camera/user
        coupling (reference logic_flow.rs:257-258)."""
        return dataclasses.replace(
            self,
            position=jnp.asarray(position, jnp.float32),
            velocity=jnp.zeros(3, jnp.float32),
        )

    # -- serialization for the replay log ---------------------------------
    def serialize(self) -> jnp.ndarray:
        """Dynamic state as one (8,) f32 vector (SerializableCameraInfo
        analogue). Static config is part of the initial snapshot instead."""
        return jnp.concatenate(
            [self.position, self.yaw[None], self.pitch[None], self.velocity]
        ).astype(jnp.float32)

    def apply_serialized(self, data: jnp.ndarray) -> "Camera":
        return dataclasses.replace(
            self,
            position=data[0:3],
            yaw=data[3],
            pitch=data[4],
            velocity=data[5:8],
        )


class CameraBuilder:
    """Host-side builder mirroring the reference's CameraBuilder chain
    (camera_object.rs:271-581)."""

    def __init__(self):
        self._kw = {}
        self._position = (0.0, 0.0, 0.0)
        self._yaw = -90.0  # degrees, looking down -Z
        self._pitch = 0.0

    def with_position(self, x, y, z):
        self._position = (x, y, z)
        return self

    def with_yaw_pitch_degrees(self, yaw, pitch):
        self._yaw, self._pitch = yaw, pitch
        return self

    def with_fov_degrees(self, fov):
        self._kw["fov_y"] = float(fov) * 3.14159265358979 / 180.0
        return self

    def with_aspect(self, aspect):
        self._kw["aspect"] = float(aspect)
        return self

    def with_near_far(self, near, far):
        self._kw["near"], self._kw["far"] = float(near), float(far)
        return self

    def with_draw_distance(self, d):
        self._kw["draw_distance"] = float(d)
        return self

    def with_orthographic(self, half_extent):
        self._kw["projection_kind"] = ORTHOGRAPHIC
        self._kw["ortho_half_extent"] = float(half_extent)
        return self

    def with_movement_factor(self, f):
        self._kw["movement_factor"] = float(f)
        return self

    def build(self) -> Camera:
        to_rad = 3.14159265358979 / 180.0
        return Camera(
            position=jnp.asarray(self._position, jnp.float32),
            yaw=jnp.float32(self._yaw * to_rad),
            pitch=jnp.float32(self._pitch * to_rad),
            velocity=jnp.zeros(3, jnp.float32),
            **self._kw,
        )
