"""Uniform spatial grid over the world cube, as a sorted section-key index.

Array-native replacement for the reference's BoundingBoxTree
(src/world/bounding_box_tree_v2.rs:330-1398). The mapping:

  * ``UniqueWorldSectionId{level,x,z,y}`` (:21-109)  ->  a packed int32
    section key ``kx + G*(ky + G*kz)`` from the entity's *position* at one
    atomic level. The reference's coarser levels exist because a hashmap
    needs one home cell per entity; here neighbor *windows* over the sorted
    key array answer every query, so one level suffices as long as
    ``section_length`` >= the largest entity diameter (the same role the
    atomic length plays in the reference, load_models.rs:52).
  * ``SharedWorldSectionId`` (entities straddling borders, :112-155)  ->
    nothing: straddlers are found by the 27-neighbor window + an exact AABB
    test, which is cheaper than maintaining shared-section sets.
  * entity->section / section->entities lookups (:329-347)  ->  ``argsort``
    of keys + ``searchsorted`` windows (build once per frame).
  * ``find_related_entities`` vertical walk (:950-1048)  ->
    ``neighbor_candidates``: gather a fixed per-cell budget from the 27
    surrounding cells.
  * out-of-bounds clamping (:1384-1397)  ->  key clamping in ``section_key``.
  * per-cell fitted AABBs with cost cap (:1055-1130)  ->  not needed;
    culling tests entity AABBs directly (world/culling.py).

Everything is static-shape and jittable; ``build_grid`` is O(CAP log CAP) on
the sort, which XLA lowers to a fast on-device key sort.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from render_engine_tpu.ecs.world import World, WorldConfig


def section_key(position: jnp.ndarray, config: WorldConfig) -> jnp.ndarray:
    """Packed section key for positions (..., 3) -> int32 (...).

    Out-of-world positions clamp to the boundary cell, mirroring the
    reference's clamp-into-bounds (bounding_box_tree_v2.rs:1384-1397).
    """
    g = config.grid_cells_per_axis
    cell = (position - jnp.asarray(config.world_min, jnp.float32)) / jnp.float32(
        config.section_length
    )
    k = jnp.clip(cell.astype(jnp.int32), 0, g - 1)
    return k[..., 0] + g * (k[..., 1] + g * k[..., 2])


def unpack_key(key: jnp.ndarray, config: WorldConfig) -> jnp.ndarray:
    g = config.grid_cells_per_axis
    kx = key % g
    ky = (key // g) % g
    kz = key // (g * g)
    return jnp.stack([kx, ky, kz], axis=-1)


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["perm", "sorted_keys", "keys"],
    meta_fields=[],
)
@dataclasses.dataclass(frozen=True)
class GridIndex:
    """Per-frame section index: ``perm`` sorts entities by section key
    (dead entities sort to the end with key INT32_MAX)."""

    perm: jnp.ndarray  # int32[CAP] entity index in sorted order
    sorted_keys: jnp.ndarray  # int32[CAP]
    keys: jnp.ndarray  # int32[CAP] per-entity (unsorted) key; dead = MAX

    @property
    def capacity(self) -> int:
        return self.perm.shape[0]


_DEAD_KEY = jnp.iinfo(jnp.int32).max


def build_grid(world: World) -> GridIndex:
    """Sort the entity axis by section key — the whole "tree build"."""
    keys = section_key(world["position"], world.config)
    keys = jnp.where(world.alive, keys, _DEAD_KEY)
    perm = jnp.argsort(keys, stable=True).astype(jnp.int32)
    return GridIndex(perm=perm, sorted_keys=keys[perm], keys=keys)


def neighbor_cell_keys(key: jnp.ndarray, config: WorldConfig) -> jnp.ndarray:
    """The 27 cells around each key, (...,) -> (..., 27) (clamped at world
    edges, so border cells self-duplicate — see ``first_occurrence_mask``)."""
    g = config.grid_cells_per_axis
    coords = unpack_key(key, config)  # (..., 3)
    offs = jnp.stack(
        jnp.meshgrid(*(jnp.arange(-1, 2, dtype=jnp.int32),) * 3, indexing="ij"),
        axis=-1,
    ).reshape(27, 3)
    n = jnp.clip(coords[..., None, :] + offs, 0, g - 1)  # (..., 27, 3)
    return n[..., 0] + g * (n[..., 1] + g * n[..., 2])


def first_occurrence_mask(nk: jnp.ndarray) -> jnp.ndarray:
    """(..., 27) keys -> bool (..., 27): True only at each key's FIRST
    occurrence in the window. Edge clamping makes border cells repeat (a
    corner cell appears 8x); without this mask every candidate in such a
    cell would be reported once per duplicate — fatal for per-PAIR collision
    delivery, which must see each neighbor exactly once."""
    n = nk.shape[-1]
    eq = nk[..., :, None] == nk[..., None, :]  # [..., j, j']
    idx = jnp.arange(n, dtype=jnp.int32)
    earlier = idx[None, :] < idx[:, None]  # [j, j'] : j' before j
    return ~jnp.any(eq & earlier, axis=-1)


def neighbor_candidates(
    grid: GridIndex,
    query_keys: jnp.ndarray,
    config: WorldConfig,
    per_cell_budget: int = 8,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Candidate entity ids near each query cell — ``find_related_entities``
    (bounding_box_tree_v2.rs:950-1048) as a static-shape gather.

    Returns ``(cand, valid)`` of shape (Q, 27 * per_cell_budget): entity
    indices drawn from each of the 27 neighbor cells (up to the per-cell
    budget; overflow beyond the budget in one cell is dropped — callers pick
    ``section_length``/budget so real scenes stay under it, the same kind of
    budgeted conservatism as the reference's 500-combine AABB cap
    :1055-1130).
    """
    from render_engine_tpu.utils.search import searchsorted_merge

    nk = neighbor_cell_keys(query_keys, config)  # (Q, 27)
    # one merge-search covers both window edges: keys are ints, so
    # side="right" of k == side="left" of k+1 (and k+1 cannot overflow:
    # keys are bounded by G^3 << INT32_MAX)
    both = searchsorted_merge(
        grid.sorted_keys, jnp.stack([nk, nk + 1], axis=0)
    )
    starts, ends = both[0], both[1]
    b = per_cell_budget
    j = jnp.arange(b, dtype=jnp.int32)  # (b,)
    slot = starts[..., None] + j  # (Q, 27, b)
    valid = (slot < ends[..., None]) & first_occurrence_mask(nk)[..., None]
    slot = jnp.clip(slot, 0, grid.capacity - 1)
    cand = grid.perm[slot]  # (Q, 27, b)
    q = query_keys.shape[0]
    return cand.reshape(q, 27 * b), valid.reshape(q, 27 * b)


def neighbor_candidate_rows(
    grid: GridIndex,
    query_keys: jnp.ndarray,
    config: WorldConfig,
    sorted_rows: jnp.ndarray,
    per_cell_budget: int = 8,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Like ``neighbor_candidates`` but returns pre-packed f32 attribute ROWS
    instead of entity ids: ``sorted_rows`` is a (CAP, C) f32 table already
    permuted into sorted-key order (``table[grid.perm]``).

    PERF: one contiguous row gather replaces gathering ids and then one
    gather per component (ids/alive/types).
    Returns ``(rows (Q, 27*b, C), valid (Q, 27*b))``.
    """
    from render_engine_tpu.utils.search import searchsorted_merge

    nk = neighbor_cell_keys(query_keys, config)  # (Q, 27)
    both = searchsorted_merge(
        grid.sorted_keys, jnp.stack([nk, nk + 1], axis=0)
    )
    starts, ends = both[0], both[1]
    b = per_cell_budget
    j = jnp.arange(b, dtype=jnp.int32)
    slot = starts[..., None] + j  # (Q, 27, b)
    cell_live = first_occurrence_mask(nk)  # drop clamped duplicate cells
    valid = (slot < ends[..., None]) & cell_live[..., None]
    slot = jnp.clip(slot, 0, grid.capacity - 1)
    q = query_keys.shape[0]
    rows = sorted_rows[slot.reshape(q, 27 * b)]  # (Q, 27*b, C)
    # per-cell budget overflow count (drop diagnostics; duplicate cells
    # excluded so one overflowing corner cell counts once)
    cell_dropped = jnp.sum(
        jnp.maximum(ends - starts - b, 0) * cell_live.astype(jnp.int32))
    return rows, valid.reshape(q, 27 * b), cell_dropped


def occupied_section_count(grid: GridIndex) -> jnp.ndarray:
    """Number of distinct occupied sections (diagnostics / HUD)."""
    sk = grid.sorted_keys
    is_live = sk != _DEAD_KEY
    new_run = jnp.concatenate(
        [is_live[:1], is_live[1:] & (sk[1:] != sk[:-1])]
    )
    return jnp.sum(new_run)
