"""Axis-aligned bounding boxes as (min, max) jnp array pairs.

Capability parity with the reference's ``StaticAABB`` (reference
src/world/bounding_volumes/aabb.rs:7-140: translate / combine / intersect /
scale / transform / 8-corner extraction) and its helper functions (reference
src/helper_things/aabb_helper_functions.rs:9-72: calculate_aabb,
aabb_out_of_bounds, conservative distance_to_aabb via bounding sphere).

Design: instead of an AABB struct of three min/max ranges, an AABB here is a
pair of ``(..., 3)`` float32 arrays ``(mn, mx)``. All ops broadcast over the
leading axes, so "transform every entity's AABB" is a single vectorized call —
the array-native idiom replacing the reference's per-entity method calls.
"""

from __future__ import annotations

import jax.numpy as jnp

from render_engine_tpu.math import transforms as T


def from_points(points: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """AABB of a point cloud. ``points``: (..., N, 3) -> ((...,3), (...,3)).

    Mirrors reference aabb_helper_functions.rs:9-31 (calculate_aabb).
    """
    return jnp.min(points, axis=-2), jnp.max(points, axis=-2)


def translate(mn, mx, offset):
    """Shift an AABB. Mirrors StaticAABB::translate (aabb.rs)."""
    return mn + offset, mx + offset


def combine(mn_a, mx_a, mn_b, mx_b):
    """Smallest AABB containing both. Mirrors StaticAABB::combine."""
    return jnp.minimum(mn_a, mn_b), jnp.maximum(mx_a, mx_b)


def intersects(mn_a, mx_a, mn_b, mx_b) -> jnp.ndarray:
    """Boolean overlap test (closed intervals). Mirrors StaticAABB::intersect.

    Broadcasts: (N,3) vs (M,3) inputs must be pre-broadcast by the caller
    (e.g. mn_a[:, None] vs mn_b[None, :] for an N x M pairwise test).
    """
    return jnp.all((mn_a <= mx_b) & (mn_b <= mx_a), axis=-1)


def contains_point(mn, mx, p) -> jnp.ndarray:
    return jnp.all((mn <= p) & (p <= mx), axis=-1)


def corners(mn, mx) -> jnp.ndarray:
    """The 8 corners, shape (..., 8, 3). Mirrors StaticAABB 8-corner extraction."""
    # Binary choice of min/max per axis for the 8 combinations.
    mn = mn[..., None, :]
    mx = mx[..., None, :]
    sel = jnp.array(
        [
            [0, 0, 0], [0, 0, 1], [0, 1, 0], [0, 1, 1],
            [1, 0, 0], [1, 0, 1], [1, 1, 0], [1, 1, 1],
        ],
        dtype=jnp.float32,
    )
    return mn * (1.0 - sel) + mx * sel


def transform(mn, mx, matrix) -> tuple[jnp.ndarray, jnp.ndarray]:
    """AABB of this AABB under a 4x4 affine transform (8-corner method).

    ``matrix``: (..., 4, 4) applied as column-vector convention (M @ p).
    Mirrors StaticAABB::transform.
    """
    cs = corners(mn, mx)  # (..., 8, 3)
    rot = matrix[..., :3, :3]
    trans = matrix[..., :3, 3]
    moved = jnp.einsum("...ij,...nj->...ni", rot, cs,
                       precision=T.MM_PRECISION) + trans[..., None, :]
    return from_points(moved)


def center(mn, mx) -> jnp.ndarray:
    return 0.5 * (mn + mx)


def half_extent(mn, mx) -> jnp.ndarray:
    return 0.5 * (mx - mn)


def bounding_sphere_radius(mn, mx) -> jnp.ndarray:
    """Radius of the sphere enclosing the AABB (conservative)."""
    return jnp.linalg.norm(half_extent(mn, mx), axis=-1)


def distance_to_point(mn, mx, p) -> jnp.ndarray:
    """Conservative center-distance minus bounding-sphere radius, clamped >= 0.

    Mirrors reference aabb_helper_functions.rs:52-72 (distance_to_aabb),
    which deliberately uses the bounding sphere rather than the exact
    closest-point distance.
    """
    d = jnp.linalg.norm(center(mn, mx) - p, axis=-1)
    return jnp.maximum(d - bounding_sphere_radius(mn, mx), 0.0)


def exact_distance_to_point(mn, mx, p) -> jnp.ndarray:
    """Exact point-to-AABB distance (0 inside)."""
    clamped = jnp.clip(p, mn, mx)
    return jnp.linalg.norm(p - clamped, axis=-1)


def out_of_bounds(mn, mx, world_min, world_max) -> jnp.ndarray:
    """True where an AABB sticks outside the world cube.

    Mirrors reference aabb_helper_functions.rs:33-50 (aabb_out_of_bounds).
    """
    return jnp.any((mn < world_min) | (mx > world_max), axis=-1)
