"""Collision detection: grid candidate windows + vectorized AABB tests.

Array-native port of the reference's handle_collisions
(src/flows/logic_flow.rs:454-655): bucket moved entities by section, find
related entities via the tree, apply a camera-distance cutoff, AABB-intersect,
then invoke per-type collision callbacks with (self, other) asymmetry. Here:

  * candidate search  ->  ``grid.neighbor_candidates`` (27-cell windows over
    the sorted key index) — static shapes, one gather.
  * the 200-unit camera-distance cutoff (logic_flow.rs:553)  ->
    ``camera_cutoff`` mask.
  * per-pair callbacks  ->  per *query* entity: each moved+collidable entity
    learns the index of its first colliding neighbor (optionally filtered by
    the other's type), and the type's vectorized collision callback runs
    under that mask. Both members of a moved-moved pair are queries, so both
    sides get their callback — the reference's self/other asymmetry.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from render_engine_tpu.ecs import registry as R
from render_engine_tpu.ecs.world import World
from render_engine_tpu.world import grid as G

CAMERA_CUTOFF = 200.0  # same constant as logic_flow.rs collision cutoff


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["query", "query_valid", "cand", "cand_type", "hit",
                 "lquery", "lquery_valid", "lhit",
                 "query_dropped", "cell_dropped", "large_dropped"],
    meta_fields=[],
)
@dataclasses.dataclass(frozen=True)
class CollisionResult:
    """Compact candidate table over a fixed QUERY budget: ``query``
    int32[Q] entity ids actually checked this frame, ``cand`` int32[Q, K]
    neighbor ids, ``cand_type`` int32[Q, K] their type ids (carried from
    the packed candidate rows so callers need no re-gather), ``hit``
    bool[Q, K]. Queries are compacted (lowest entity index first) so the
    per-frame gather cost scales with the query budget, not the world
    capacity — the analogue of the reference only testing *moved* entities
    (logic_flow.rs:537-654).

    Entities LARGER than a grid cell (the reference stores these at coarser
    tree levels, bounding_box_tree_v2.rs:21-109) get a second, exact table:
    ``lquery`` int32[L] large movers with ``lhit`` bool[L, CAP] brute-force
    hits against every entity — the 27-cell window cannot bound their AABB,
    so they test everything. Small queries find large entities through
    global candidate columns appended to ``cand``. Rows are disjoint
    (large entities never enter ``query``), so the two tables merge by
    scatter."""

    query: jnp.ndarray
    query_valid: jnp.ndarray
    cand: jnp.ndarray
    cand_type: jnp.ndarray
    hit: jnp.ndarray
    lquery: jnp.ndarray  # int32[L] large query entity ids
    lquery_valid: jnp.ndarray  # bool[L]
    lhit: jnp.ndarray  # bool[L, CAP] brute-force hits
    query_dropped: jnp.ndarray  # int32 scalar: queries beyond the budget
    cell_dropped: jnp.ndarray  # int32 scalar: neighbors beyond cell budget
    large_dropped: jnp.ndarray  # int32 scalar: large entities beyond budget

    def any_hit(self) -> jnp.ndarray:
        """bool[CAP] scattered back to entity space (capacity from ids)."""
        raise NotImplementedError("use first_hit_of_type")

    def _tables(self, world: World):
        """Both (query, valid, cand, cand_type, ok) tables; the large
        table's candidate ids are just 0..CAP-1."""
        cap = world.capacity
        out = [(self.query, self.query_valid, self.cand, self.cand_type,
                self.hit & self.query_valid[:, None])]
        if self.lquery.shape[0] > 0:
            lcand = jnp.broadcast_to(
                jnp.arange(cap, dtype=jnp.int32)[None, :], self.lhit.shape)
            ltype = jnp.broadcast_to(world["type_id"][None, :],
                                     self.lhit.shape)
            out.append((self.lquery, self.lquery_valid, lcand, ltype,
                        self.lhit & self.lquery_valid[:, None]))
        return out

    def hits_topk(self, world: World, k: int
                  ) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray,
                             jnp.ndarray]:
        """(others int32[CAP, k], mask bool[CAP, k], other_type
        int32[CAP, k], dropped int32): the first ``k`` colliding neighbors
        per query entity, scattered back to entity space, plus the count of
        colliding pairs beyond slot ``k``. ``other_type`` carries each
        contact's type id compacted from the candidate rows — callbacks
        that filter by the other entity's type must use it instead of
        ``world["type_id"][other_idx]`` (a full-capacity 1-D int gather per
        callback slot; the type channel rides the SAME row scatter for
        free).

        This is the per-PAIR delivery of the reference's handle_collisions
        (logic_flow.rs:537-655): every colliding (self, other) pair fires
        the self type's callback once, so an entity touching a wormhole AND
        a mine in the same frame gets both callbacks — not just the first
        neighbor in slot order. Large-entity query rows merge in by scatter
        (disjoint from the compact rows by construction).

        Compact-then-scatter: each slot j is the column whose 1-based hit
        rank equals j+1 — k last-axis argmax reduces compact the (Q, K)
        table to (Q, k) per query ON-ROW, then ONE (Q, 3k) f32 row scatter
        (others | masks | contact types) lands the rows in entity space. The previous formulation scattered
        every (query, candidate) cell into a flat (CAP*k,) int32/bool pair
        — a ~229k-element 1-D element scatter; the row form is the
        (N, C) f32 row-table layout from the perf model."""
        cap = world.capacity
        payload = jnp.concatenate(
            [jnp.full((cap + 1, k), -1.0, jnp.float32),
             jnp.zeros((cap + 1, k), jnp.float32),
             jnp.full((cap + 1, k), -1.0, jnp.float32)], axis=-1)
        dropped = jnp.int32(0)
        for query, valid, cand, ctype, ok in self._tables(world):
            rank = jnp.cumsum(ok.astype(jnp.int32), axis=-1)  # 1-based
            oth, got, typ = [], [], []
            for j in range(k):
                hit_j = ok & (rank == j + 1)
                col = jnp.argmax(hit_j, axis=-1)
                has_j = jnp.any(hit_j, axis=-1)
                other_j = jnp.take_along_axis(
                    cand, col[:, None], axis=-1)[:, 0]
                type_j = jnp.take_along_axis(
                    ctype, col[:, None], axis=-1)[:, 0]
                # ids stay far below 2^24: the f32 round-trip is exact
                oth.append(jnp.where(has_j, other_j, -1)
                           .astype(jnp.float32))
                got.append(has_j.astype(jnp.float32))
                typ.append(jnp.where(has_j, type_j, -1)
                           .astype(jnp.float32))
            # (Q, 3k): others | masks | types in ONE row scatter
            rows = jnp.stack(oth + got + typ, axis=-1)
            dest = jnp.where(valid, query, cap)
            payload = payload.at[dest].set(rows, mode="drop")
            dropped = dropped + jnp.sum(
                jnp.maximum(rank[:, -1] - k, 0) * valid.astype(jnp.int32))
        others = payload[:cap, :k].astype(jnp.int32)
        masks = payload[:cap, k:2 * k] > 0.5
        otypes = payload[:cap, 2 * k:].astype(jnp.int32)
        return others, masks, otypes, dropped.astype(jnp.int32)

    def first_hit_of_type(self, world: World, type_index: int
                          ) -> tuple[jnp.ndarray, jnp.ndarray]:
        """(other_idx int32[CAP], mask bool[CAP]): first colliding neighbor
        whose type is ``type_index`` (or any type if ``type_index < 0``),
        scattered back to full entity space."""
        cap = world.capacity
        other = jnp.full(cap, -1, jnp.int32)
        has = jnp.zeros(cap, bool)
        for query, valid, cand, ctype, ok in self._tables(world):
            if type_index >= 0:
                ok = ok & (ctype == type_index)
            has_q = jnp.any(ok, axis=-1)
            first = jnp.argmax(ok, axis=-1)
            other_q = jnp.take_along_axis(cand, first[:, None],
                                          axis=-1)[:, 0]
            dest = jnp.where(valid, query, cap)
            other = other.at[dest].set(jnp.where(has_q, other_q, -1),
                                       mode="drop")
            has = has.at[dest].set(has_q, mode="drop")
        return other, has


def find_collisions(
    world: World,
    grid: G.GridIndex,
    camera_position: jnp.ndarray,
    query_mask: jnp.ndarray,
    per_cell_budget: int = 8,
    query_budget: int = 1024,
    large_budget: int = 8,
) -> CollisionResult:
    """AABB-overlap candidates for entities in ``query_mask`` (typically
    moved & CanCauseCollisions, plus the user entity when
    UserAlwaysCausesCollisions is set — logic_flow.rs:454-537), compacted
    to at most ``query_budget`` queries (overflow drops highest indices).

    ``large_budget``: entities whose AABB reaches further than half a grid
    cell from their position cannot rely on the 27-cell window (the
    reference stores them at coarser tree levels,
    bounding_box_tree_v2.rs:21-109, 563-678). Up to this many such entities
    are handled exactly: every query tests all of them (global candidate
    columns), and large MOVERS brute-force test every entity. Overflow is
    counted in ``large_dropped``. 0 disables the machinery (and silently
    reinstates the size assumption)."""
    cfg = world.config
    # camera cutoff (logic_flow.rs: collisions only near the camera)
    near_cam = (
        jnp.sum((world["position"] - camera_position[None]) ** 2, axis=-1)
        <= jnp.float32(CAMERA_CUTOFF) ** 2
    )
    q = query_mask & near_cam
    cap = world.capacity
    mn, mx = world["aabb_min"], world["aabb_max"]
    arange = jnp.arange(cap, dtype=jnp.int32)

    lb = min(large_budget, cap)
    if lb > 0:
        # "large" = the window-correctness bound fails: overlap implies
        # neighboring cells only while every halfspan <= section_length/2
        halfspan = jnp.maximum(world["position"] - mn,
                               mx - world["position"]).max(axis=-1)
        is_large = world.alive & (
            halfspan > jnp.float32(cfg.section_length) * 0.5)
        # large entities never use the compact window table: their pairs
        # deliver exclusively through the global columns / brute-force rows
        q = q & ~is_large
    else:
        is_large = jnp.zeros(cap, bool)

    qb = min(query_budget, cap)
    key = jnp.where(q, arange, cap)
    qidx = jnp.sort(key)[:qb]
    qvalid = qidx < cap
    qidx = jnp.clip(qidx, 0, cap - 1)

    # packed candidate rows: [entity, alive, type, aabb_min, aabb_max,
    # is_large] as f32 (ids/capacities stay far below 2^24, so the f32
    # round-trip is exact). ONE row gather replaces six scalar-memory
    # gathers — see grid.neighbor_candidate_rows.
    table = jnp.concatenate(
        [
            arange.astype(jnp.float32)[:, None],
            world.alive.astype(jnp.float32)[:, None],
            world["type_id"].astype(jnp.float32)[:, None],
            mn, mx,
            is_large.astype(jnp.float32)[:, None],
        ],
        axis=1,
    )  # (CAP, 10)
    rows, valid, cell_dropped = G.neighbor_candidate_rows(
        grid, grid.keys[qidx], cfg, table[grid.perm], per_cell_budget
    )  # (Q, K, 10)
    # channel-leading view: one transpose up front makes every channel a
    # contiguous (Q, K) plane instead of a strided [..., c] slice of the
    # (Q, K, 10) rows
    ch = jnp.moveaxis(rows, -1, 0)  # (10, Q, K)
    cand = ch[0].astype(jnp.int32)
    alive_c = ch[1] > 0.5
    ctype = ch[2].astype(jnp.int32)
    valid = valid & (cand != qidx[:, None]) & alive_c & qvalid[:, None]
    if lb > 0:
        valid = valid & ~(ch[9] > 0.5)  # large cands live in the columns

    # AABB intersect per axis on (Q, K) planes (no trailing vec3 axis)
    qmn, qmx = mn[qidx], mx[qidx]  # (Q, 3)
    hit = valid
    for a in range(3):
        hit = hit & (qmn[:, a:a + 1] <= ch[6 + a]) \
                  & (ch[3 + a] <= qmx[:, a:a + 1])
    query_dropped = jnp.maximum(jnp.sum(q.astype(jnp.int32)) - qb, 0)

    large_dropped = jnp.int32(0)
    if lb > 0:
        # compact the large entities (lowest indices first)
        lkey = jnp.where(is_large, arange, cap)
        lidx = jnp.sort(lkey)[:lb]
        lvalid = lidx < cap
        lidx = jnp.clip(lidx, 0, cap - 1)
        large_dropped = jnp.maximum(
            jnp.sum(is_large.astype(jnp.int32)) - lb, 0)

        # global candidate columns: every compact query tests every large
        # entity exactly (L extra columns on the window table)
        lmn, lmx = mn[lidx], mx[lidx]  # (L, 3)
        ghit = (qvalid[:, None] & lvalid[None, :]
                & (lidx[None, :] != qidx[:, None]))
        for a in range(3):
            ghit = ghit & (qmn[:, a:a + 1] <= lmx[None, :, a]) \
                        & (lmn[None, :, a] <= qmx[:, a:a + 1])
        cand = jnp.concatenate(
            [cand, jnp.broadcast_to(lidx[None, :], ghit.shape)], axis=1)
        ctype = jnp.concatenate(
            [ctype, jnp.broadcast_to(world["type_id"][lidx][None, :],
                                     ghit.shape)], axis=1)
        hit = jnp.concatenate([hit, ghit], axis=1)

        # large MOVERS brute-force every entity (their window can't bound
        # their AABB); rows are disjoint from the compact table
        lq = query_mask & near_cam & is_large
        lqkey = jnp.where(lq, arange, cap)
        lqidx = jnp.sort(lqkey)[:lb]
        lqvalid = lqidx < cap
        lqidx = jnp.clip(lqidx, 0, cap - 1)
        lq_mn, lq_mx = mn[lqidx], mx[lqidx]  # (L, 3)
        bhit = (lqvalid[:, None] & world.alive[None, :]
                & (arange[None, :] != lqidx[:, None]))
        for a in range(3):
            bhit = bhit & (lq_mn[:, a:a + 1] <= mx[None, :, a]) \
                        & (mn[None, :, a] <= lq_mx[:, a:a + 1])
        lquery, lquery_valid, lhit = lqidx, lqvalid, bhit
    else:
        lquery = jnp.zeros((0,), jnp.int32)
        lquery_valid = jnp.zeros((0,), bool)
        lhit = jnp.zeros((0, cap), bool)

    return CollisionResult(query=qidx, query_valid=qvalid, cand=cand,
                           cand_type=ctype, hit=hit,
                           lquery=lquery, lquery_valid=lquery_valid,
                           lhit=lhit,
                           query_dropped=query_dropped,
                           cell_dropped=cell_dropped,
                           large_dropped=large_dropped)


def collision_query_mask(world: World, moved: jnp.ndarray) -> jnp.ndarray:
    """Which entities initiate collision checks this frame."""
    collidable = world.flag_set(R.FLAG_COLLIDABLE)
    always_user = world.flag_set(R.FLAG_USER_ALWAYS_COLLIDES)
    return (moved & collidable) | (always_user & collidable)
