"""Wavefront integrator: per-bounce stages with compaction / material sort.

Mirrors the reference architecture (``src/pathtrace.cu:696-771``): each bounce
is intersect -> [material sort] -> shade -> [stream compaction], with the
live count shrinking like the reference's ``num_paths``.  With static
shapes the "compaction" is a stable front-pack permutation and the sort is a
stable key-sort -- both realized with scans (see ``ops.compaction``).

This integrator exists for (a) A/B parity with the reference's toggles
(images must match the megakernel modulo RNG stream), (b) material-bucketed
dense shading, and (c) per-bounce telemetry.  RNG streams are keyed by PIXEL
(gathered through the permutation), so compaction/sort do NOT change the
image for a fixed (iteration, pixel, depth): the three integrator configs are
bit-identical, which the tests assert.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ..config import RenderConfig
from ..ops import camera as camera_ops
from ..ops import film as film_ops
from ..ops import shade as shade_ops
from ..ops.compaction import compact_paths, sort_paths_by_material
from ..ops.intersect import intersect_scene
from ..ops.rays import PathState
from ..scene.camera import CameraState
from ..scene.device import DeviceScene, SceneStatic
from ..utils import prng
from ..utils.vec import Vec3


def tier_sizes(n: int, tiers) -> list:
    """Prefix-tier row counts for an n-ray state: each configured divisor d
    yields an n/d prefix rounded UP to 256-row units (any multiple works;
    256 keeps tiers engageable at test-sized ray counts)."""
    npres = []
    unit = 256
    for div in sorted({int(d) for d in tiers}, reverse=True):
        npre = min(n, ((n // max(1, div) + unit - 1) // unit) * unit)
        if 0 < npre < n and npre not in npres:
            npres.append(npre)
    return npres


def run_tiered(paths: PathState, npres: list, body) -> PathState:
    """Run ``body`` (a whole-bounce function PathState -> PathState) over the
    smallest configured prefix holding every alive ray: a ``lax.cond`` chain
    tests the last alive position (rays are front-packed by the previous
    bounce's compaction) and the dead tail passes through untouched.  Falls
    back to the full state when the population exceeds every tier."""
    n = paths.pixel.shape[0]
    live_pos = jnp.max(
        jnp.where(paths.alive, jax.lax.iota(jnp.int32, n), -1)
    )
    tmap = jax.tree_util.tree_map

    def tier_at(npre):
        def branch(_):
            head = tmap(lambda a: a[:npre], paths)
            out = body(head)
            tail = tmap(lambda a: a[npre:], paths)
            return tmap(
                lambda a, b: jnp.concatenate([a, b], axis=0), out, tail
            )

        return branch

    chain = lambda _: body(paths)
    for npre in reversed(sorted(npres)):
        chain = (
            lambda _, npre=npre, nxt=chain: jax.lax.cond(
                live_pos < npre, tier_at(npre), nxt, None
            )
        )
    return chain(None)


def wavefront_iteration(
    dev: DeviceScene,
    static: SceneStatic,
    cfg: RenderConfig,
    cam: CameraState,
    film: Vec3,
    iteration: jnp.ndarray,
    base_key: jax.Array,
    shard: tuple | None = None,  # (global pixel ids [ln], global N) --
    #   run one chip's block inside shard_map; see megakernel_iteration
) -> Tuple[Vec3, jnp.ndarray]:
    depth = static.trace_depth
    if shard is None:
        n = n_global = static.pixel_count
        idx = None
    else:
        idx, n_global = shard
        n = idx.shape[0]

    ikey = prng.iteration_key(base_key, iteration)
    ckey = prng.stage_key(ikey, 0, 0)
    cam_u = (
        prng.uniforms(ckey, n, 4)
        if shard is None
        else prng.uniforms_at(ckey, idx, 4, n_global)
    )
    paths = camera_ops.generate_camera_rays(
        cam, static.width, static.height, depth, cam_u, idx=idx
    )

    # Prefix tiers (cfg.bounce_prefix_tiers): compaction packs every alive
    # ray into a front prefix, so the whole bounce -- intersect, sort, RNG,
    # shade, and the compaction itself -- can run over the smallest
    # configured tier holding the population (the dead tail passes through
    # untouched).  Gated on compaction being enabled: without packing there
    # is no prefix to slice.
    tiers = cfg.resolved_prefix_tiers()
    npres = tier_sizes(n, tiers) if tiers and cfg.stream_compaction else []

    def bounce(d, carry):
        paths, alive_counts = carry

        def stages(head):
            isect = intersect_scene(dev, static, head, cfg)

            if cfg.material_sorting:
                head, isect = sort_paths_by_material(
                    head, isect, static.num_materials, max_id=n_global
                )

            # Per-pixel RNG evaluated elementwise at each slot's pixel id: a
            # ray's random stream is permutation-invariant by construction
            # and no gather through the compaction/sort permutation is
            # needed (bit-identical to drawing in pixel order + gathering).
            su = prng.uniforms_at(
                prng.stage_key(ikey, d, 1), head.pixel, 3, n_global
            )
            head = shade_ops.shade(dev, static, head, isect, su, cfg)

            hn = head.pixel.shape[0]
            if cfg.stream_compaction == "adaptive":
                # Pack only when mostly dead: the permutation is pure
                # overhead on mostly-live bounces (static shapes; see
                # RenderConfig).  Image-identical either way (pixel-keyed
                # RNG); threshold is local to the engaged tier.
                hl = jnp.sum(head.alive.astype(jnp.int32))
                head = jax.lax.cond(
                    2 * hl < hn,
                    lambda p: compact_paths(p, max_id=n_global)[0],
                    lambda p: p,
                    head,
                )
            elif cfg.stream_compaction:
                head = compact_paths(head, max_id=n_global)[0]
            return head

        if npres:
            paths = run_tiered(paths, npres, stages)
        else:
            paths = stages(paths)
        live = jnp.sum(paths.alive.astype(jnp.int32))
        return paths, alive_counts.at[d].set(live)

    unroll = cfg.unroll_bounces if cfg.unroll_bounces is not None else True
    carry = (paths, jnp.zeros((depth,), jnp.int32))
    if unroll:
        for d in range(depth):
            carry = bounce(d, carry)
        paths, alive_counts = carry
    else:
        paths, alive_counts = jax.lax.fori_loop(0, depth, bounce, carry)

    film = film_ops.accumulate(
        film, paths, permuted=True, base=0 if shard is None else idx[0]
    )
    return film, alive_counts
