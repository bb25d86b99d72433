"""Multi-device scaling: device meshes + sharded frame steps.

The reference is single-process/single-GPU (SURVEY.md section 2.5/2.6); its
concurrency story is threads + rayon. This engine instead shards the two big
axes over a ``jax.sharding.Mesh``:

  * the **entity axis** (CAP) — logic, culling, collision (the
    sequence-parallel analogue; SURVEY.md section 5 long-context mapping)
  * the **image rows** (H) — raster tiles and deferred lighting

XLA/GSPMD inserts the collectives (all-gathers where sharded triangles meet
sharded tiles); on a multi-GPU host they run over NVLink. Single-device
behaviour is unchanged: the same jitted step runs on a 1-device mesh.
"""

from render_engine_tpu.parallel.mesh import (  # noqa: F401
    make_mesh,
    shard_world,
    world_sharding,
)
