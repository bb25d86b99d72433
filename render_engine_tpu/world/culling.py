"""Visibility culling: frustum and distance tests over entity AABBs.

Array-native redesign of the reference culling stack:

  * ``RenderFrustumCuller`` (src/culling/render_frustum_culler.rs:18-119):
    6 planes from proj*view, 8-corner in/out AABB test  ->  the vectorized
    p-vertex test here (exact for AABBs, cheaper than 8 corners).
  * ``LogicFrustumCuller`` (src/culling/logic_frustum_culler.rs:8-47):
    omnidirectional distance sphere around the camera so off-screen-but-near
    entities still step  ->  ``within_distance``.
  * ``VisibleWorldFlow`` (src/flows/visible_world_flow.rs:40-145) culled
    *sections* and only then entities; here we test every entity AABB in
    one fused vector op — O(CAP) vectorized beats section bookkeeping at any
    population the engine targets, and the result is exact rather than
    conservative.

The logic step uses ``active_mask`` = (frustum OR near-sphere) visibility,
matching the union the reference takes in pipeline.rs:222-229.
"""

from __future__ import annotations

import jax.numpy as jnp


def aabb_in_frustum(planes: jnp.ndarray, mn: jnp.ndarray, mx: jnp.ndarray) -> jnp.ndarray:
    """True where an AABB intersects the frustum. ``planes``: (6,4) from
    ``transforms.frustum_planes``; ``mn``/``mx``: (N,3). P-vertex test:
    the AABB is outside iff its most-positive vertex w.r.t. some plane is
    below that plane."""
    normals = planes[:, :3]  # (6,3)
    d = planes[:, 3]  # (6,)
    pv = jnp.where(normals[None, :, :] >= 0.0, mx[:, None, :], mn[:, None, :])
    dist = jnp.sum(pv * normals[None], axis=-1) + d[None]  # (N,6)
    return jnp.all(dist >= 0.0, axis=-1)


def within_distance(
    center: jnp.ndarray, mn: jnp.ndarray, mx: jnp.ndarray, radius
) -> jnp.ndarray:
    """True where an AABB is within ``radius`` of ``center`` (exact
    point-to-box distance). The logic-sphere culler."""
    clamped = jnp.clip(center[None, :], mn, mx)
    d2 = jnp.sum((clamped - center[None, :]) ** 2, axis=-1)
    return d2 <= jnp.float32(radius) ** 2


def visible_mask(world, camera, logic_radius=None) -> jnp.ndarray:
    """Union of render-frustum and logic-sphere visibility over alive
    entities (pipeline.rs:222-229)."""
    mn, mx = world["aabb_min"], world["aabb_max"]
    planes = camera.frustum_planes()
    vis = aabb_in_frustum(planes, mn, mx)
    if logic_radius is not None:
        vis = vis | within_distance(camera.position, mn, mx, logic_radius)
    return world.alive & vis
