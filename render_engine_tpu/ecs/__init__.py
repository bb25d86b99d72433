"""Entity Component System as structure-of-arrays jnp state.

Array-native redesign of the reference ECS (src/objects/ecs.rs): instead of a
per-type byte blob + sparse map + free list, every component is a fixed-
capacity ``(CAP, ...)`` jnp array, entity liveness is a boolean mask, and the
per-entity "which components are written" bitset (ecs.rs:57) is a uint32
array. Queries become mask intersections; spawn/despawn become masked writes;
the whole store is a pytree that serializes losslessly for record/replay.
"""

from render_engine_tpu.ecs.registry import (  # noqa: F401
    BUILTIN_COMPONENTS,
    ComponentRegistry,
    ComponentSpec,
)
from render_engine_tpu.ecs.world import World, WorldConfig  # noqa: F401
