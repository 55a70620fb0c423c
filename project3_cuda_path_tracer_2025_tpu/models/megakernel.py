"""Megakernel integrator: one fused jit per spp iteration.

The reference's iteration driver (``pathtrace()``, ``src/pathtrace.cu:639-787``)
launches a kernel chain per bounce with host round-trips between launches.
Here the entire iteration -- raygen, trace_depth x (intersect + shade),
final gather -- is a single traced function: the bounce loop is unrolled
(trace_depth is static, <= ~16) so XLA fuses elementwise work across stage
boundaries, and the film never leaves the device.  This is the plain XLA
reference every other path is compared with.

Termination is the bounces mask (dead lanes are write-masked; in a closed
scene nearly all lanes stay live anyway, cf. the reference's closed-vs-open
study README.md:140-151).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ..config import RenderConfig
from ..ops import camera as camera_ops
from ..ops import film as film_ops
from ..ops import shade as shade_ops
from ..ops.intersect import intersect_scene
from ..scene.camera import CameraState
from ..scene.device import DeviceScene, SceneStatic
from ..utils import prng
from ..utils.vec import Vec3


def megakernel_iteration(
    dev: DeviceScene,
    static: SceneStatic,
    cfg: RenderConfig,
    cam: CameraState,
    film: Vec3,
    iteration: jnp.ndarray,  # traced scalar (1-based, like the reference)
    base_key: jax.Array,
    shard: tuple | None = None,  # (global pixel ids [ln], global N)
) -> Tuple[Vec3, jnp.ndarray]:
    """One full spp iteration. Returns (film', alive_counts[depth]).

    ``shard`` runs the iteration over one chip's pixel block inside a
    ``shard_map`` body (``parallel.shardmap``): all RNG draws evaluate the
    GLOBAL (pixel, depth) threefry streams at the local pixel ids
    (``prng.uniforms_at`` -- bit-identical to the single-chip slices), so
    the sharded film equals the single-chip film bit for bit."""
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

    def bounce(d, carry):
        paths, alive_counts = carry
        skey = prng.stage_key(ikey, d, 1)
        # Paths stay in pixel order: the local slice of the global
        # pixel-order stream.
        su = (
            prng.uniforms(skey, n, 3)
            if shard is None
            else prng.uniforms_at(skey, idx, 3, n_global)
        )
        isect = intersect_scene(dev, static, paths, cfg)
        paths = shade_ops.shade(dev, static, paths, isect, su, cfg)
        alive_counts = alive_counts.at[d].set(
            jnp.sum(paths.alive.astype(jnp.int32))
        )
        return paths, alive_counts

    # Loop lowering choice: Python unroll maximizes cross-bounce fusion at
    # the cost of an HLO ~depth x larger; fori_loop traces the bounce once
    # (fast compiles).  Auto unrolls.
    unroll = cfg.unroll_bounces if cfg.unroll_bounces is not None else True
    carry = (paths, jnp.zeros((depth,), jnp.int32))
    if unroll:
        for d in range(depth):
            carry = bounce(d, carry)
        paths, alive_counts = carry
    else:
        paths, alive_counts = jax.lax.fori_loop(0, depth, bounce, carry)

    film = film_ops.accumulate(film, paths)
    return film, alive_counts
