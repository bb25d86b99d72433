"""Spatial world: uniform-grid section index + visibility culling.

Array-native redesign of the reference's BoundingBoxTree
(src/world/bounding_box_tree_v2.rs) and culling stack (src/culling/,
src/flows/visible_world_flow.rs). The multi-level hashmap-of-world-sections
becomes a sort-by-section-key index over the entity arrays; frustum/distance
culling becomes vectorized per-entity AABB tests (exact, one fused op — no
need for the reference's per-section conservative pass on a machine where
testing 100k AABBs costs microseconds).
"""

from render_engine_tpu.world.grid import GridIndex, build_grid, section_key  # noqa: F401
from render_engine_tpu.world import culling  # noqa: F401
