"""render_engine_tpu — a simulation & tiled deferred-render engine in JAX.

An accelerator-first engine (NVIDIA GPUs; the CPU for tests) with the
capabilities of the Rust/OpenGL reference
(Binyamin-Brion/render_engine): an entity-component system stepped as one jitted
world tick over structure-of-arrays jnp state, a spatial-hash world with frustum-
and distance-gated execution, user-defined render systems binding Pallas kernels
to model sets (tile-based software rasterizer emitting a G-buffer plus a fused
deferred-lighting pass with shadow maps and level-of-view geometry swapping), and
full gameplay record/playback with bit-deterministic replay.

The whole engine is a pure function per frame::

    world', frame_rgb, record = engine.step(world, inputs, dt)

so replay determinism (the reference's hardest-won feature, see
reference src/threads/history_thread.rs) comes for free: same inputs => same bits.
"""

__version__ = "0.1.0"

from render_engine_tpu.math import aabb, camera, transforms  # noqa: F401
from render_engine_tpu.ecs.world import World, WorldConfig  # noqa: F401
