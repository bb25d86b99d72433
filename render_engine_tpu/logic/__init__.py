"""The world tick: kinematics, collisions, per-type logic dispatch.

Array-native redesign of the reference's LogicFlow (src/flows/logic_flow.rs)
and its deferred-change machinery: the whole tick is one jitted pure function
``world', camera' = step(world, camera, inputs, dt, rng)`` — rayon chunks,
change-request vectors and the adaptive serial/parallel scheduler
(cpu_usage_reducer.rs) all dissolve into fused vectorized ops.
"""

from render_engine_tpu.logic.types import EntityType, InputState  # noqa: F401
from render_engine_tpu.logic.step import make_step  # noqa: F401
