"""Deferred-mutation protocol: the jit-friendly EntityChange analogue.

The reference never mutates the ECS from logic callbacks; they return
``Vec<EntityChangeInformation>`` (a 13-variant enum: AddEntity, Modify,
Delete, MakeObjectStatic, WakeUp, Add/RemoveSortable, ... reference
src/objects/entity_change_request.rs:9-27) applied later by ``apply_change``
(src/helper_things/entity_change_helpers.rs:32-189).

Array-native redesign: a ``ChangeSet`` is a pytree of dense masked updates —
no dynamic-length lists, no serialization. Each variant maps to:

  * Modify(component)      -> (values, mask) pair per component name
  * Delete                 -> ``despawn_mask: bool[CAP]``
  * MakeObjectStatic/WakeUp-> flag set/clear masks on the ``flags`` component
  * Add/RemoveSortable     -> a masked update of ``sortable``
  * AddEntity              -> a fixed-budget ``SpawnBatch`` drained at frame
                              end (slots assigned by cumsum over free slots) —
                              the "dynamic entity population under jit"
                              strategy from SURVEY.md section 7.

Everything is jittable and composes: ``merge`` stacks two ChangeSets with
later-wins semantics, matching the reference's in-order application.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from render_engine_tpu.ecs import registry as R
from render_engine_tpu.ecs.world import World

# transitive owned-entity cascade depth = 2^ROUNDS (pointer doubling)
OWNED_CASCADE_ROUNDS = 5


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["count", "values", "comp_bits", "row_valid"],
    meta_fields=["budget"],
)
@dataclasses.dataclass(frozen=True)
class SpawnBatch:
    """Up to ``budget`` entity spawns. ``values[name]``: (budget,)+shape;
    ``comp_bits``: uint32[budget] which components each spawn writes;
    ``row_valid``: bool[budget] which rows are real spawn requests (rows
    need NOT be a packed prefix — callers may fill disjoint row sets
    across multiple queue_spawn calls); ``count`` = sum(row_valid)."""

    count: jnp.ndarray
    values: dict
    comp_bits: jnp.ndarray
    row_valid: jnp.ndarray
    budget: int


def empty_spawn_batch(config, budget: int) -> SpawnBatch:
    values = {}
    for spec in config.registry.specs:
        arr = jnp.full((budget,) + spec.shape, spec.default, dtype=spec.dtype)
        if spec.name == "orientation":
            arr = arr.at[:, 0].set(1.0)
        if spec.name == "transform":
            arr = jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (budget, 4, 4))
        values[spec.name] = arr
    return SpawnBatch(
        count=jnp.int32(0),
        values=values,
        comp_bits=jnp.zeros(budget, jnp.uint32),
        row_valid=jnp.zeros(budget, bool),
        budget=budget,
    )


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["updates", "set_flags", "clear_flags", "despawn_mask", "spawns"],
    meta_fields=[],
)
@dataclasses.dataclass(frozen=True)
class ChangeSet:
    updates: dict  # name -> (values (CAP,..), mask bool[CAP])
    set_flags: jnp.ndarray  # uint32[CAP]
    clear_flags: jnp.ndarray  # uint32[CAP]
    despawn_mask: jnp.ndarray  # bool[CAP]
    spawns: SpawnBatch | None


def empty_changeset(world: World, spawn_budget: int = 0) -> ChangeSet:
    cap = world.capacity
    return ChangeSet(
        updates={},
        set_flags=jnp.zeros(cap, jnp.uint32),
        clear_flags=jnp.zeros(cap, jnp.uint32),
        despawn_mask=jnp.zeros(cap, bool),
        spawns=empty_spawn_batch(world.config, spawn_budget)
        if spawn_budget
        else None,
    )


def with_update(cs: ChangeSet, name: str, values, mask) -> ChangeSet:
    """Queue a masked component write (the Modify variant)."""
    updates = dict(cs.updates)
    if name in updates:
        old_v, old_m = updates[name]
        exp = mask.reshape(mask.shape + (1,) * (values.ndim - 1))
        values = jnp.where(exp, values, old_v)
        mask = mask | old_m
    updates[name] = (values, mask)
    return dataclasses.replace(cs, updates=updates)


def with_despawn(cs: ChangeSet, mask) -> ChangeSet:
    return dataclasses.replace(cs, despawn_mask=cs.despawn_mask | mask)


def with_flags(cs: ChangeSet, set_mask=None, set_bits=0, clear_mask=None,
               clear_bits=0) -> ChangeSet:
    """MakeObjectStatic / WakeUp / marker-component changes."""
    sf, cf = cs.set_flags, cs.clear_flags
    if set_mask is not None:
        sf = jnp.where(set_mask, sf | jnp.uint32(set_bits), sf)
    if clear_mask is not None:
        cf = jnp.where(clear_mask, cf | jnp.uint32(clear_bits), cf)
    return dataclasses.replace(cs, set_flags=sf, clear_flags=cf)


def queue_spawn(cs: ChangeSet, registry: R.ComponentRegistry,
                row_mask: jnp.ndarray, **values) -> ChangeSet:
    """Queue up to budget spawns described per-row. ``row_mask``: bool[budget]
    marks which rows of ``values`` are real spawn requests this call.

    The AddEntity analogue (entity_change_request.rs AddEntity +
    entity_transformer.rs apply_choices): callers pass the final component
    values; slot assignment happens in ``apply_changeset``.
    """
    sp = cs.spawns
    if sp is None:
        raise ValueError("ChangeSet created without a spawn budget")
    bits = jnp.uint32(registry.bits(*values.keys()))
    new_vals = dict(sp.values)
    for name, val in values.items():
        exp = row_mask.reshape(row_mask.shape + (1,) * (val.ndim - 1))
        new_vals[name] = jnp.where(exp, val, sp.values[name])
    new_bits = jnp.where(row_mask, sp.comp_bits | bits, sp.comp_bits)
    new_valid = sp.row_valid | row_mask
    return dataclasses.replace(
        cs,
        spawns=dataclasses.replace(
            sp,
            values=new_vals,
            comp_bits=new_bits,
            row_valid=new_valid,
            count=jnp.sum(new_valid.astype(jnp.int32)),
        ),
    )


def with_add_reference(cs: ChangeSet, world: World, owner_mask: jnp.ndarray,
                       other: jnp.ndarray) -> ChangeSet:
    """Add a referenced (non-owning, read-only) entity edge per owner in
    ``owner_mask`` (ecs.rs add_referenced_entity, :171). ``other``:
    int32[CAP] the referenced id per owner row. Set semantics: duplicates
    are no-ops; owners with no free edge slot drop the add (fixed
    MAX_REF_EDGES budget)."""
    rows = world["ref_edges"]
    exists = jnp.any(rows == other[:, None], axis=1)
    free = rows == -1
    slot = jnp.argmax(free, axis=1)
    can = owner_mask & jnp.any(free, axis=1) & ~exists & (other >= 0)
    cols = jnp.arange(rows.shape[1], dtype=jnp.int32)
    new = jnp.where(
        (cols[None, :] == slot[:, None]) & can[:, None],
        other[:, None], rows,
    )
    return with_update(cs, "ref_edges", new, can)


def with_remove_reference(cs: ChangeSet, world: World,
                          owner_mask: jnp.ndarray,
                          other: jnp.ndarray) -> ChangeSet:
    """Remove a referenced-entity edge (ecs.rs remove_referenced_entity)."""
    rows = world["ref_edges"]
    hit = (rows == other[:, None]) & owner_mask[:, None]
    new = jnp.where(hit, -1, rows)
    return with_update(cs, "ref_edges", new, owner_mask)


def merge(a: ChangeSet, b: ChangeSet) -> ChangeSet:
    """Compose two ChangeSets, b taking precedence on overlapping writes
    (in-order application semantics of apply_change)."""
    out = a
    for name, (v, m) in b.updates.items():
        out = with_update(out, name, v, m)
    out = dataclasses.replace(
        out,
        set_flags=out.set_flags | b.set_flags,
        clear_flags=out.clear_flags | b.clear_flags,
        despawn_mask=out.despawn_mask | b.despawn_mask,
    )
    if b.spawns is not None and a.spawns is not None:
        raise ValueError("merging two ChangeSets that both carry spawns is "
                         "not supported; queue spawns into one set")
    if b.spawns is not None:
        out = dataclasses.replace(out, spawns=b.spawns)
    return out


def apply_changeset(world: World, cs: ChangeSet) -> World:
    """Apply a ChangeSet: masked writes, flags, despawns, then spawns.

    The jit-friendly ``apply_change`` (entity_change_helpers.rs:32-189).
    Transform/AABB refresh is NOT done here — the logic step recomputes them
    once per frame for all dirty entities (mirroring the reference's batched
    update_aabb_after_kinematic_change :217-262).
    """
    reg = world.config.registry
    comps = dict(world.comps)
    comp_mask = world.comp_mask
    for name, (values, mask) in cs.updates.items():
        old = comps[name]
        exp = mask.reshape(mask.shape + (1,) * (old.ndim - 1))
        comps[name] = jnp.where(exp, values, old)
        comp_mask = jnp.where(mask, comp_mask | jnp.uint32(reg.bit(name)),
                              comp_mask)

    flags = comps["flags"]
    flags = (flags | cs.set_flags) & ~cs.clear_flags
    comps["flags"] = flags

    # owned-entity cascade (the reference's owned_entities graph,
    # ecs.rs:70-71,145-181): children whose parent dies die too —
    # TRANSITIVELY within this frame, via pointer doubling: after round i
    # the ancestor array spans 2^(i+1) levels, so OWNED_CASCADE_ROUNDS
    # rounds resolve chains up to 2^ROUNDS deep in O(log depth) passes.
    parent = comps["parent"]
    cap = world.capacity
    dead = cs.despawn_mask
    anc = parent
    for _ in range(OWNED_CASCADE_ROUNDS):
        valid = anc >= 0
        anc_c = jnp.clip(anc, 0, cap - 1)
        # one f32 ROW gather per round instead of separate 1-D bool/int
        # gathers (ids < 2^24 round-trip f32 exactly)
        tbl = jnp.stack(
            [dead.astype(jnp.float32), anc.astype(jnp.float32)], axis=1)
        g = tbl[anc_c]
        dead = dead | (valid & (g[:, 0] > 0.5))
        anc = jnp.where(valid, g[:, 1].astype(jnp.int32), -1)
    despawn = dead & (world.alive | cs.despawn_mask)

    alive = world.alive & ~despawn
    comp_mask = jnp.where(despawn, jnp.uint32(0), comp_mask)

    world = dataclasses.replace(
        world, alive=alive, comp_mask=comp_mask, comps=comps
    )
    if cs.spawns is not None:
        # most frames spawn nothing: gate the full-world drain (a gather +
        # select over EVERY component array) behind a cond
        world = jax.lax.cond(
            cs.spawns.count > 0,
            lambda w: _drain_spawns(w, cs.spawns),
            lambda w: w,
            world,
        )
    return world


def _drain_spawns(world: World, sp: SpawnBatch) -> World:
    """Assign spawn rows to free slots (first-free order, like the
    reference's free list ecs.rs:82-89) with a scatter. Spawns beyond the
    free-slot count are dropped (capacity backpressure). Valid rows may be
    any subset of the budget (not just a prefix): they are compacted by
    rank before slot assignment."""
    alive = world.alive
    cap = world.capacity
    free = ~alive
    # rank of each free slot among free slots (0-based)
    rank = jnp.cumsum(free.astype(jnp.int32)) - 1
    # perm[k] = index of the k-th VALID spawn row (stable: row order kept)
    perm = jnp.argsort(jnp.where(sp.row_valid, 0, 1).astype(jnp.int32),
                       stable=True)
    # build mapping: for each world slot, which compacted spawn row lands
    landing_row = jnp.where(free, rank, cap)  # free slot i takes row rank[i]
    takes = free & (landing_row < sp.count)  # slots that receive a spawn
    src = perm[jnp.clip(landing_row, 0, sp.budget - 1)]

    comps = dict(world.comps)
    reg = world.config.registry
    for spec in reg.specs:
        name = spec.name
        gathered = sp.values[name][src]
        exp = takes.reshape(takes.shape + (1,) * (gathered.ndim - 1))
        comps[name] = jnp.where(exp, gathered, comps[name])
    new_alive = alive | takes
    new_mask = jnp.where(takes, sp.comp_bits[src], world.comp_mask)
    return dataclasses.replace(
        world, alive=new_alive, comp_mask=new_mask, comps=comps
    )
