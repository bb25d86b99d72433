"""The World: one fixed-capacity SoA pytree holding every entity.

Array-native redesign of the reference ECS (src/objects/ecs.rs:61-745). The
mapping (see SURVEY.md section 7):

  * byte-blob columns + sparse maps  ->  ``(CAP, ...)`` jnp arrays per component
  * per-entity u32 component bitset (ecs.rs:57)  ->  ``comp_mask: uint32[CAP]``
  * free-list (ecs.rs:82-89)  ->  first-free-slot selection over ``~alive``
  * query = sparse-map intersection (ecs.rs:238-285)  ->  bitwise mask test
  * entity "type" component + reverse lookup (ecs.rs:65,481-492)
      ->  ``type_id: int32[CAP]`` and a vectorized equality mask
  * sortable components (ecs.rs:121-126)  ->  ``sortable: int32[CAP]`` buckets
  * Clone+Serialize for snapshot/replay  ->  the World IS a pytree; snapshot =
      ``jax.device_get`` of the leaves

Entity ids are simply array indices (the EntityId(u32) analogue, reference
src/objects/entity_id.rs). A despawned slot keeps its index until reused —
like the reference's free list, ids are recycled.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from render_engine_tpu.ecs import registry as R


@dataclasses.dataclass(frozen=True)
class WorldConfig:
    """Static world parameters (jit compile-time constants).

    ``world_length`` / ``section_length`` mirror the reference's 16,384-unit
    cube with atomic section length 64 (src/main.rs:48-51,
    src/exports/load_models.rs:52).
    """

    capacity: int = 1024
    world_min: tuple = (0.0, 0.0, 0.0)
    world_length: float = 16384.0
    section_length: float = 64.0
    registry: R.ComponentRegistry = dataclasses.field(
        default_factory=R.ComponentRegistry
    )

    def __hash__(self):
        return hash(
            (self.capacity, self.world_min, self.world_length,
             self.section_length, self.registry)
        )

    @property
    def grid_cells_per_axis(self) -> int:
        return max(1, int(round(self.world_length / self.section_length)))


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["alive", "comp_mask", "comps"],
    meta_fields=["config"],
)
@dataclasses.dataclass(frozen=True)
class World:
    alive: jnp.ndarray  # bool[CAP]
    comp_mask: jnp.ndarray  # uint32[CAP]
    comps: dict  # name -> (CAP, ...) array
    config: WorldConfig

    # ---------------------------------------------------------------- access
    def __getitem__(self, name: str) -> jnp.ndarray:
        return self.comps[name]

    def get(self, name: str) -> jnp.ndarray:
        return self.comps[name]

    def replace(self, **updates) -> "World":
        """Return a new World with the given component arrays replaced."""
        comps = dict(self.comps)
        top = {}
        for k, v in updates.items():
            if k in ("alive", "comp_mask"):
                top[k] = v
            else:
                if k not in comps:
                    raise KeyError(f"unknown component {k!r}")
                comps[k] = v
        return dataclasses.replace(self, comps=comps, **top)

    @property
    def capacity(self) -> int:
        return self.config.capacity

    # ---------------------------------------------------------------- queries
    def has_components(self, *names: str) -> jnp.ndarray:
        """alive & all named component bits set — the ECS query
        (ecs.rs:238-285) as one vectorized mask op."""
        bits = jnp.uint32(self.config.registry.bits(*names))
        return self.alive & ((self.comp_mask & bits) == bits)

    def of_type(self, type_index: int) -> jnp.ndarray:
        """Entities whose TypeIdentifier equals ``type_index``
        (the reverse entity_model_lookup, ecs.rs:481-492)."""
        return self.alive & (self.comps["type_id"] == type_index)

    def flag_set(self, flag) -> jnp.ndarray:
        return self.alive & ((self.comps["flags"] & flag) != 0)

    def user_index(self) -> jnp.ndarray:
        """Index of the dedicated user entity (ecs.rs:136-142,188-191)."""
        mask = self.flag_set(R.FLAG_USER)
        return jnp.argmax(mask)

    def count_alive(self) -> jnp.ndarray:
        return jnp.sum(self.alive)

    # --------------------------------------------------------------- sortable
    def sortable_mask(self, bucket: int) -> jnp.ndarray:
        """Entities in one sortable bucket (default / 3 light types),
        reference sorted_entities.rs:11-97."""
        return self.alive & (self.comps["sortable"] == bucket)


def create_world(config: WorldConfig) -> World:
    """Allocate an empty world: every slot dead, components at defaults."""
    cap = config.capacity
    comps = {}
    for spec in config.registry.specs:
        arr = jnp.full((cap,) + spec.shape, spec.default, dtype=spec.dtype)
        if spec.name == "orientation":
            arr = arr.at[:, 0].set(1.0)  # identity quats
        if spec.name == "transform":
            arr = jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (cap, 4, 4))
        comps[spec.name] = arr
    return World(
        alive=jnp.zeros(cap, bool),
        comp_mask=jnp.zeros(cap, jnp.uint32),
        comps=comps,
        config=config,
    )


# ---------------------------------------------------------------------------
# Host-side spawning (scene setup / instance registration).
# The jit-friendly in-step spawn path lives in ecs/changes.py.
# ---------------------------------------------------------------------------


def spawn_host(world: World, count: int, **values) -> tuple[World, np.ndarray]:
    """Spawn ``count`` entities with the given component values (host path).

    ``values[name]`` is broadcastable to (count,) + spec.shape. Returns the
    new world and the assigned entity indices. This is the analogue of
    instance registration at load time (reference pipeline.rs:186-208,
    entity_transformer.rs:55-75); it is NOT jittable — use ChangeSet spawns
    inside the step.
    """
    reg = world.config.registry
    alive = np.asarray(world.alive)
    free = np.flatnonzero(~alive)
    if len(free) < count:
        raise ValueError(
            f"world capacity exhausted: need {count} slots, have {len(free)}"
        )
    idx = free[:count]

    new_alive = world.alive.at[idx].set(True)
    mask_bits = 0
    comps = dict(world.comps)
    for name, val in values.items():
        if name not in reg:
            raise KeyError(f"unknown component {name!r}")
        spec = reg.specs[reg.slot(name)]
        val = np.broadcast_to(
            np.asarray(val, dtype=spec.dtype), (count,) + spec.shape
        )
        comps[name] = comps[name].at[idx].set(val)
        mask_bits |= reg.bit(name)
    new_mask = world.comp_mask.at[idx].set(jnp.uint32(mask_bits))
    new_world = dataclasses.replace(
        world, alive=new_alive, comp_mask=new_mask, comps=comps
    )
    return new_world, idx


def despawn(world: World, kill_mask: jnp.ndarray) -> World:
    """Kill entities where mask is True (jittable). Double-delete safe
    (cf. ecs.rs test :1328) — killing a dead slot is a no-op."""
    return dataclasses.replace(
        world,
        alive=world.alive & ~kill_mask,
        comp_mask=jnp.where(kill_mask, jnp.uint32(0), world.comp_mask),
    )


def snapshot(world: World) -> dict:
    """Full host-side snapshot (the analogue of bincode(ECS),
    reference history_thread.rs:175-182): numpy copies of every leaf."""
    return {
        "alive": np.asarray(world.alive),
        "comp_mask": np.asarray(world.comp_mask),
        "comps": {k: np.asarray(v) for k, v in world.comps.items()},
    }


def restore(config: WorldConfig, snap: dict) -> World:
    return World(
        alive=jnp.asarray(snap["alive"]),
        comp_mask=jnp.asarray(snap["comp_mask"]),
        comps={k: jnp.asarray(v) for k, v in snap["comps"].items()},
        config=config,
    )
