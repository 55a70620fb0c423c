"""Scan / compact / radix-sort primitives.

Rebuild of the reference's GPU-primitives library (``stream_compaction/``:
Blelloch scan ``efficient.cu:18-105``, compact = map-to-bool -> scan ->
scatter ``efficient.cu:163-224``, 32-pass LSB radix sort
``radix.cu:20-133``).  Like the reference's library these are first-class,
independently-tested components; the render loop's compaction
(``ops.compaction``) is built on the same scan.  The production scan is
``jnp.cumsum``, which XLA lowers to its own parallel scan on the GPU.
"""

from __future__ import annotations

import jax.numpy as jnp


# ---------------------------------------------------------------------------
# Scans
# ---------------------------------------------------------------------------

def exclusive_scan(x: jnp.ndarray) -> jnp.ndarray:
    """Exclusive prefix sum (``StreamCompaction::Efficient::scan`` parity)."""
    return jnp.cumsum(x) - x


def inclusive_scan(x: jnp.ndarray) -> jnp.ndarray:
    return jnp.cumsum(x)


def inclusive_scan_naive(x: jnp.ndarray) -> jnp.ndarray:
    """Hillis-Steele scan: ceil(log2 n) doubling passes, each adding the
    array to itself shifted by the pass offset.

    The third scan flavor of the reference's library
    (``stream_compaction/naive.cu:17-74``) next to the Blelloch tree and the
    thrust wrapper.  Each pass is one full-width shift + add (XLA fuses the
    ``pad``/``slice`` into the add) -- fine as an oracle; the O(n log n)
    work loses to the production scan just as ``naive`` loses to
    ``efficient`` in the reference's own benchmarks."""
    n = x.shape[0]
    offset = 1
    while offset < n:
        x = x + jnp.pad(x[: n - offset], (offset, 0))
        offset *= 2
    return x


def exclusive_scan_naive(x: jnp.ndarray) -> jnp.ndarray:
    """Exclusive Hillis-Steele scan (shift-right of the inclusive result,
    exactly the reference's ``naive.cu`` final shift)."""
    return jnp.pad(inclusive_scan_naive(x)[:-1], (1, 0))


# ---------------------------------------------------------------------------
# Compact (map-to-bool -> scan -> scatter), Efficient::compact parity
# ---------------------------------------------------------------------------

def compact_indices(flags: jnp.ndarray):
    """Returns (dest, count): dest[i] is the output slot of element i when
    flags[i], else the slot among the rejected tail (stable both sides --
    i.e. a stable-partition permutation, matching thrust::stable_partition
    semantics used by the render loop)."""
    f = flags.astype(jnp.int32)
    keep_rank = exclusive_scan(f)
    count = keep_rank[-1] + f[-1]
    drop_rank = exclusive_scan(1 - f)
    dest = jnp.where(flags, keep_rank, count + drop_rank)
    return dest, count


def compact(values: jnp.ndarray, flags: jnp.ndarray):
    """Front-pack values by flags (stable); returns (packed, count).
    Rejected elements appear after the packed prefix."""
    n = values.shape[0]
    dest, count = compact_indices(flags)
    out = jnp.zeros_like(values).at[dest].set(values)
    return out, count


# ---------------------------------------------------------------------------
# Radix sort: LSB passes of stable partition-by-bit (Radix::radixSort parity)
# ---------------------------------------------------------------------------

def radix_sort_permutation(
    keys: jnp.ndarray, num_bits: int = 32
) -> jnp.ndarray:
    """Stable ascending sort permutation of non-negative int32 keys via
    num_bits LSB->MSB split passes, each a scan-driven stable partition
    (the reference does 32 fixed passes; pass ``num_bits`` = bit width of
    the key domain, e.g. 6 for material ids < 64)."""
    n = keys.shape[0]
    perm = jnp.arange(n, dtype=jnp.int32)
    k = keys.astype(jnp.int32)

    def body(bit, carry):
        perm, k = carry
        zero = (k >> bit) & 1 == 0
        dest, _ = compact_indices(zero)
        perm = jnp.zeros_like(perm).at[dest].set(perm)
        k = jnp.zeros_like(k).at[dest].set(k)
        return perm, k

    for bit in range(num_bits):  # static unroll; num_bits is small
        perm, k = body(bit, (perm, k))
    return perm
