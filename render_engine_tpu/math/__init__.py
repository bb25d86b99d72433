"""Math core: AABBs, TRS transforms, projections, cameras.

Array-native replacement for the reference's nalgebra-glm usage plus its
bounding-volume module (reference src/world/bounding_volumes/aabb.rs,
src/world/dimension/range.rs, src/exports/camera_object.rs). Everything is
vectorized jnp over leading batch axes so a whole entity population is one op.
"""

from render_engine_tpu.math import aabb, camera, transforms  # noqa: F401
