"""Wavefront state management: stream compaction + material sort.

The reference shrinks its live-path buffer with ``thrust::stable_partition``
(``src/pathtrace.cu:750-757``) and optionally groups work with
``thrust::stable_sort_by_key`` on material id (``:730-735``).  XLA needs
static shapes, so both become *permutations* of the full N-slot SoA state:

* ``compact_paths``: stable front-pack of live rays (prefix-sum ranks) +
  a live count.  Kernels still see N lanes, but trailing lanes are all-dead,
  which lets the wavefront's prefix tiers skip them, and the live count
  reproduces the reference's ``num_paths`` telemetry.
* ``sort_paths_by_material``: stable key sort with terminated rays keyed to a
  sentinel bucket past every real material.

Both are built on an exclusive scan (``ops.scan``).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ..utils.vec import Vec3
from . import scan as scan_ops
from .rays import Intersections, PathState


def _apply_permutation(
    paths: PathState, perm: jnp.ndarray, max_id: int = None
) -> PathState:
    """Apply ``perm`` to the whole path state with ONE packed [N, 11] f32
    row gather (stack + gather + unpack).  The int VALUE-cast is exact
    below 2**24 -- ``max_id`` must be the global pixel count under
    shard_map; past it the ints take an i32 gather."""
    n = paths.pixel.shape[0]
    ints_fit = max(n, max_id or 0) < (1 << 24)
    cols = [
        paths.origin.x, paths.origin.y, paths.origin.z,
        paths.direction.x, paths.direction.y, paths.direction.z,
        paths.color.x, paths.color.y, paths.color.z,
    ]
    if ints_fit:
        cols += [
            paths.pixel.astype(jnp.float32),
            paths.bounces.astype(jnp.float32),
        ]
    m = jnp.stack(cols, axis=1)[perm]
    if ints_fit:
        pixel = m[:, 9].astype(jnp.int32)
        bounces = m[:, 10].astype(jnp.int32)
    else:
        mi = jnp.stack([paths.pixel, paths.bounces], axis=1)[perm]
        pixel, bounces = mi[:, 0], mi[:, 1]
    return PathState(
        origin=Vec3(m[:, 0], m[:, 1], m[:, 2]),
        direction=Vec3(m[:, 3], m[:, 4], m[:, 5]),
        color=Vec3(m[:, 6], m[:, 7], m[:, 8]),
        pixel=pixel,
        bounces=bounces,
    )


def _apply_permutation_isect(isect: Intersections, perm: jnp.ndarray) -> Intersections:
    """ONE packed [N, 13] i32 row gather (like ``_apply_permutation``) --
    but BITCAST, not value-cast:
    f32 payloads ride as their exact bit patterns in i32 lanes (the int
    gather path neither rounds nor flushes denormals), so the permuted
    values are reproduced bit-for-bit.  The unpacked fields pass through
    ``optimization_barrier`` so downstream ``shade`` fusion/FMA contraction
    cannot re-associate across the repack -- that barrier is what preserves
    the material-sort toggle's bitwise A/B with the megakernel (a naive
    value-packed version measured 1-ulp diffs from changed fusion)."""
    f32 = [
        isect.t,
        isect.normal.x, isect.normal.y, isect.normal.z,
        isect.uv_u, isect.uv_v,
        isect.dpdu.x, isect.dpdu.y, isect.dpdu.z,
        isect.dpdv.x, isect.dpdv.y, isect.dpdv.z,
    ]
    cols = [jax.lax.bitcast_convert_type(c, jnp.int32) for c in f32]
    cols.append(isect.material_id)
    cols.append(isect.is_triangle.astype(jnp.int32))
    m = jnp.stack(cols, axis=1)[perm]
    back = [
        jax.lax.bitcast_convert_type(m[:, i], jnp.float32)
        for i in range(len(f32))
    ]
    out = Intersections(
        t=back[0],
        normal=Vec3(back[1], back[2], back[3]),
        material_id=m[:, 12],
        uv_u=back[4],
        uv_v=back[5],
        dpdu=Vec3(back[6], back[7], back[8]),
        dpdv=Vec3(back[9], back[10], back[11]),
        is_triangle=m[:, 13] != 0,
    )
    return jax.lax.optimization_barrier(out)


def front_pack_permutation(alive: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Stable partition permutation: live lanes first (original order), dead
    lanes after (original order).  Returns (perm, live_count).

    Built on ``ops.scan.compact_indices`` (the same layering as the
    reference, where ``stream_compaction/`` is the scan library and
    ``thrust::stable_partition`` the consumer)."""
    n = alive.shape[0]
    dest, live_count = scan_ops.compact_indices(alive)
    perm = jnp.zeros((n,), jnp.int32).at[dest].set(jnp.arange(n, dtype=jnp.int32))
    return perm, live_count


def compact_paths(
    paths: PathState, max_id: int = None
) -> Tuple[PathState, jnp.ndarray]:
    """thrust::stable_partition(PathAlive) equivalent (permutes, never
    drops -- finalGather still reads all N slots)."""
    perm, live = front_pack_permutation(paths.alive)
    return _apply_permutation(paths, perm, max_id=max_id), live


def sort_paths_by_material(
    paths: PathState,
    isect: Intersections,
    num_materials: int,
    max_id: int = None,
) -> Tuple[PathState, Intersections]:
    """thrust::stable_sort_by_key(CompareMat) equivalent: stable sort of
    (intersections, paths) by material id.  Missed/terminated rays keep the
    reference's key semantics (CompareMat sorts raw materialId; misses were
    zeroed by the per-bounce memset, so their key is whatever the
    intersection holds -- here 0 for misses, matching the memset)."""
    key = isect.material_id
    order = jnp.argsort(key, stable=True)
    return (
        _apply_permutation(paths, order, max_id=max_id),
        _apply_permutation_isect(isect, order),
    )
