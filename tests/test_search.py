"""Unit tests for utils/search — the searchsorted replacements.

These are the perf-model primitives (jnp.searchsorted can lower to
a sequential while loop); grid binning and raster window fills depend on
their EXACT side="left" semantics, so pin them against np.searchsorted
directly, including duplicate-heavy and boundary inputs.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from render_engine_tpu.utils.search import (
    searchsorted_merge,
    searchsorted_unrolled,
)


def _cases(rng):
    yield np.sort(rng.uniform(-5, 5, 67).astype(np.float32)), \
        rng.uniform(-6, 6, 41).astype(np.float32)
    # duplicate-heavy: few distinct values in both table and targets
    tab = np.sort(rng.integers(0, 6, 64).astype(np.float32))
    yield tab, rng.integers(-1, 8, 33).astype(np.float32)
    # targets exactly on table values (the side="left" tie semantics)
    yield tab, tab[rng.integers(0, 64, 50)].copy()
    # extremes: everything below / above the table
    yield tab, np.full(7, -100.0, np.float32)
    yield tab, np.full(7, 100.0, np.float32)
    # int32 keys
    itab = np.sort(rng.integers(0, 1000, 128)).astype(np.int32)
    yield itab, rng.integers(-5, 1005, 77).astype(np.int32)


class TestSearchsortedMerge:
    def test_matches_numpy_side_left(self):
        rng = np.random.default_rng(7)
        for tab, tgt in _cases(rng):
            got = np.asarray(searchsorted_merge(jnp.asarray(tab),
                                                jnp.asarray(tgt)))
            want = np.searchsorted(tab, tgt, side="left")
            np.testing.assert_array_equal(got, want)
            assert got.dtype == np.int32

    def test_preserves_target_shape(self):
        rng = np.random.default_rng(3)
        tab = np.sort(rng.uniform(0, 1, 32).astype(np.float32))
        tgt = rng.uniform(0, 1, (5, 9)).astype(np.float32)
        got = searchsorted_merge(jnp.asarray(tab), jnp.asarray(tgt))
        assert got.shape == (5, 9)
        np.testing.assert_array_equal(
            np.asarray(got), np.searchsorted(tab, tgt.ravel()).reshape(5, 9))

    def test_empty_table_and_empty_targets(self):
        tab = jnp.zeros((0,), jnp.float32)
        tgt = jnp.asarray([1.0, 2.0], jnp.float32)
        np.testing.assert_array_equal(np.asarray(searchsorted_merge(tab, tgt)),
                                      [0, 0])
        got = searchsorted_merge(jnp.asarray([1.0, 2.0], jnp.float32),
                                 jnp.zeros((0,), jnp.float32))
        assert got.shape == (0,)


class TestSearchsortedUnrolled:
    def test_matches_numpy_both_sides(self):
        rng = np.random.default_rng(11)
        for tab, tgt in _cases(rng):
            for side in ("left", "right"):
                got = np.asarray(searchsorted_unrolled(
                    jnp.asarray(tab), jnp.asarray(tgt), side=side))
                np.testing.assert_array_equal(
                    got, np.searchsorted(tab, tgt, side=side))

    def test_single_element_table(self):
        tab = jnp.asarray([5.0], jnp.float32)
        tgt = jnp.asarray([4.0, 5.0, 6.0], jnp.float32)
        np.testing.assert_array_equal(
            np.asarray(searchsorted_unrolled(tab, tgt, side="left")),
            [0, 0, 1])
        np.testing.assert_array_equal(
            np.asarray(searchsorted_unrolled(tab, tgt, side="right")),
            [0, 1, 1])
