"""Scan / compact / radix library vs NumPy oracles (reference's
stream_compaction test strategy, SURVEY.md C17)."""

import numpy as np
import pytest

import jax.numpy as jnp

from project3_cuda_path_tracer_2025_tpu.ops import scan as scan_mod


def test_exclusive_scan_matches_oracle():
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.integers(0, 5, 1000), jnp.int32)
    out = scan_mod.exclusive_scan(x)
    expect = np.cumsum(np.asarray(x)) - np.asarray(x)
    np.testing.assert_array_equal(np.asarray(out), expect)


def test_compact_matches_oracle():
    rng = np.random.default_rng(3)
    vals = jnp.asarray(rng.integers(0, 100, 500), jnp.int32)
    flags = jnp.asarray(rng.random(500) > 0.6)
    packed, count = scan_mod.compact(vals, flags)
    v = np.asarray(vals)
    f = np.asarray(flags)
    assert int(count) == f.sum()
    np.testing.assert_array_equal(np.asarray(packed)[: f.sum()], v[f])
    # rejected tail is stable too
    np.testing.assert_array_equal(np.asarray(packed)[f.sum():], v[~f])


def test_radix_sort_stable():
    rng = np.random.default_rng(4)
    keys = rng.integers(0, 37, 400).astype(np.int32)
    perm = scan_mod.radix_sort_permutation(jnp.asarray(keys), num_bits=6)
    perm = np.asarray(perm)
    sorted_keys = keys[perm]
    assert (np.diff(sorted_keys) >= 0).all()
    # stability: equal keys keep original relative order
    for k in np.unique(keys):
        np.testing.assert_array_equal(
            perm[sorted_keys == k], np.sort(perm[sorted_keys == k])
        )


def test_radix_sort_full_width():
    rng = np.random.default_rng(5)
    keys = rng.integers(0, 2**31 - 1, 256).astype(np.int32)
    perm = np.asarray(scan_mod.radix_sort_permutation(jnp.asarray(keys), num_bits=31))
    np.testing.assert_array_equal(keys[perm], np.sort(keys, kind="stable"))


def test_naive_scan_matches_oracle():
    """Hillis-Steele flavor (reference stream_compaction/naive.cu:17-74)."""
    rng = np.random.default_rng(3)
    for n in (1, 2, 7, 128, 1000, 4097):
        x = jnp.asarray(rng.integers(0, 5, n), jnp.int32)
        np.testing.assert_array_equal(
            np.asarray(scan_mod.inclusive_scan_naive(x)),
            np.cumsum(np.asarray(x)),
        )
        np.testing.assert_array_equal(
            np.asarray(scan_mod.exclusive_scan_naive(x)),
            np.cumsum(np.asarray(x)) - np.asarray(x),
        )
