"""Vectorized binary search without the sequential WHILE.

``jnp.searchsorted`` can lower to a while-loop whose body is one fused
gather per step. Two replacements:

  * ``searchsorted_merge`` (preferred): two device sorts, zero gathers —
    sorting the targets INTO the table and counting sources replaces the
    per-step gathers of a binary search. Exact ``side="left"``
    semantics.
  * ``searchsorted_unrolled``: the plain unrolled binary search (one gather
    per step). Still ~matches jnp.searchsorted; kept for tiny inputs and as
    a cross-check.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp


def searchsorted_merge(sorted_arr: jnp.ndarray,
                       targets: jnp.ndarray) -> jnp.ndarray:
    """int32 side="left" insertion indices via merge, not binary search.

    Sort (value, tag) with targets tagged 0 and sources tagged 1 — stable,
    so every target lands BEFORE equal sources (side="left"). A target's
    insertion index is then (merged position) - (its rank among targets) =
    the number of sources strictly before it. A second key-sort (tag, id)
    routes each answer back to its query without any scatter/gather.
    """
    n = sorted_arr.shape[0]
    flat = targets.reshape(-1)
    m = flat.shape[0]
    if n == 0 or m == 0:
        return jnp.zeros(targets.shape, jnp.int32)
    keys = jnp.concatenate([sorted_arr, flat])
    tag = jnp.concatenate(
        [jnp.ones(n, jnp.int32), jnp.zeros(m, jnp.int32)]
    )
    qid = jnp.concatenate(
        [jnp.zeros(n, jnp.int32), jnp.arange(m, dtype=jnp.int32)]
    )
    skeys, stag, sqid = jax.lax.sort((keys, tag, qid), num_keys=2,
                                     is_stable=True)
    is_t = (stag == 0).astype(jnp.int32)
    trank = jnp.cumsum(is_t) - 1
    ins = jnp.arange(n + m, dtype=jnp.int32) - trank  # sources before pos
    # route answers back: sort by (tag, qid) — targets (tag 0) come first,
    # ordered by query id; slice the first m rows
    _, _, ins_by_q = jax.lax.sort((stag, sqid, ins), num_keys=2,
                                  is_stable=True)
    return ins_by_q[:m].reshape(targets.shape)


def searchsorted_unrolled(sorted_arr: jnp.ndarray, targets: jnp.ndarray,
                          side: str = "left") -> jnp.ndarray:
    """int32 insertion indices of ``targets`` into 1-D ``sorted_arr``.

    Bit-identical to ``jnp.searchsorted(sorted_arr, targets, side=side)``
    for any dtype with a total order on the stored values.
    """
    n = sorted_arr.shape[0]
    if n == 0:
        return jnp.zeros(targets.shape, jnp.int32)
    steps = max(1, math.ceil(math.log2(n + 1)))
    lo = jnp.zeros(targets.shape, jnp.int32)
    hi = jnp.full(targets.shape, n, jnp.int32)
    for _ in range(steps):
        active = lo < hi
        mid = (lo + hi) >> 1
        v = sorted_arr[jnp.clip(mid, 0, n - 1)]
        go_right = (v < targets) if side == "left" else (v <= targets)
        lo = jnp.where(active & go_right, mid + 1, lo)
        hi = jnp.where(active & ~go_right, mid, hi)
    return lo
