"""Whole-iteration prim kernel: one Pallas Triton program per spp iteration.

For scenes of analytic primitives only (no triangles, no textures), one
kernel launch runs raygen, ``trace_depth`` x (intersect + shade) and the
film accumulate.  Each program owns a 1-D block of ``BLOCK`` rays, one ray
per lane -- the reference's thread-per-path design
(``generateRayFromCamera`` -> ``computeIntersections`` ->
``kernShadeMaterialProper`` -> ``finalGather``, ``src/pathtrace.cu``) in a
single launch, with the path state held in registers from the first bounce
to the last.  The primitive transforms (``GeomConst``) and the material
table (``MaterialConst``) are Python constants that fold into the
instruction stream, so scene data costs no memory traffic.

The per-ray uniforms are drawn inside the kernel with the spelled-out
threefry hash at the same (key, counter) positions as ``prng.uniforms``,
so the draws are bit-identical to the XLA megakernel's; the kernel body
calls the same shape-agnostic building blocks (``intersect_scene`` with the
mesh branch statically skipped, ``shade.scatter_compose``), so the two
paths differ only by float re-association (tests/test_fused.py).

Per-block alive counts leave the kernel as a small ``[n_blocks, CW]``
output and are reduced outside it.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from ..config import RenderConfig
from ..scene.camera import CameraState
from ..scene.device import SceneStatic
from ..utils import prng
from ..utils import vec
from ..utils.mathutil import TWO_PI
from ..utils.vec import Vec3
from . import shade as shade_ops
from .intersect import intersect_scene
from .rays import PathState

# Rays per program and warps per program, chosen on the card (PERF.md).
BLOCK = 128
NUM_WARPS = 4

_CAM_WORDS = 16  # position, view, up, right (3 each), pixel_length (2), aperture, focal


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _const_material_params(static: SceneStatic, mid: jnp.ndarray):
    """Per-lane material parameters via a constant-folded select chain."""
    ms = static.material_consts
    f = jnp.float32

    def chain(get):
        out = jnp.full(mid.shape, get(ms[0]), f)
        for i in range(1, len(ms)):
            out = jnp.where(mid == i, f(get(ms[i])), out)
        return out

    albedo = Vec3(
        chain(lambda m: m.color[0]),
        chain(lambda m: m.color[1]),
        chain(lambda m: m.color[2]),
    )
    return (
        albedo,
        chain(lambda m: m.emittance),
        chain(lambda m: m.has_reflective),
        chain(lambda m: m.has_refractive),
        chain(lambda m: m.ior),
        chain(lambda m: m.roughness),
        chain(lambda m: m.metallic),
    )


def _iteration_kernel(
    static: SceneStatic,
    cfg: RenderConfig,
    block: int,
    cam_ref, key_ref, fr_in, fg_in, fb_in,
    fr_out, fg_out, fb_out, alive_out,
):
    depth = static.trace_depth
    n = static.pixel_count
    idx = pl.program_id(0) * block + jax.lax.iota(jnp.int32, block)
    in_range = idx < n
    flat = idx.astype(jnp.uint32)

    def draws(stage, k: int):
        # prng.uniforms(stage_key, n, k)[j] at this block's pixels.
        k0, k1 = key_ref[2 * stage], key_ref[2 * stage + 1]
        return [
            prng.bits_to_uniform(
                prng.threefry_bits_inline(k0, k1, jnp.uint32(j * n) + flat)
            )
            for j in range(k)
        ]

    # --- raygen (generateRayFromCamera parity; see ops/camera.py) ---------
    c = [cam_ref[j] for j in range(_CAM_WORDS)]
    position = Vec3(c[0], c[1], c[2])
    view = Vec3(c[3], c[4], c[5])
    up = Vec3(c[6], c[7], c[8])
    right = Vec3(c[9], c[10], c[11])
    plx, ply, aperture, focal = c[12], c[13], c[14], c[15]
    u = draws(0, 4)
    x = (idx % static.width).astype(jnp.float32)
    y = (idx // static.width).astype(jnp.float32)
    sx = plx * (x + u[0] - static.width * 0.5)
    sy = ply * (y + u[1] - static.height * 0.5)
    ray_dir = vec.normalize(view - right * sx - up * sy)
    focal_point = position + ray_dir * focal
    r = aperture * jnp.sqrt(u[2])
    theta = TWO_PI * u[3]
    origin = Vec3(
        position.x + r * jnp.cos(theta),
        position.y + r * jnp.sin(theta),
        jnp.full((block,), c[2], jnp.float32),
    )
    one = jnp.ones((block,), jnp.float32)
    paths = PathState(
        origin=origin,
        direction=vec.normalize(focal_point - origin),
        color=Vec3(one, one, one),
        pixel=idx,
        bounces=jnp.where(in_range, depth, 0).astype(jnp.int32),
    )

    # --- depth x (intersect + shade), state in registers -------------------
    # A loop, not a Python unroll: the body compiles once, which keeps the
    # Triton compile short; the bounce index picks its stage key at run time.
    lobes = shade_ops.lobes_present(static)
    lane = jax.lax.iota(jnp.int32, alive_out.shape[0])

    def bounce(d, carry):
        paths, counts = carry
        isect = intersect_scene(None, static, paths, cfg)
        mid = jnp.clip(isect.material_id, 0, static.num_materials - 1)
        albedo, emitt, refl, refr, ior, rough, metal = _const_material_params(
            static, mid
        )
        paths = shade_ops.scatter_compose(
            cfg, paths, isect, isect.normal,
            albedo, emitt, refl, refr, ior, rough, metal,
            draws(1 + d, 3),
            lobes=lobes,
        )
        alive = jnp.sum((paths.bounces > 0).astype(jnp.int32))
        return paths, jnp.where(lane == d, alive, counts)

    paths, counts = jax.lax.fori_loop(
        0, depth, bounce, (paths, jnp.zeros(lane.shape, jnp.int32))
    )

    # --- film accumulate (finalGather parity; padded lanes masked) --------
    mask = in_range.astype(jnp.float32)
    fr_out[...] = fr_in[...] + paths.color.x * mask
    fg_out[...] = fg_in[...] + paths.color.y * mask
    fb_out[...] = fb_in[...] + paths.color.z * mask
    alive_out[...] = counts


def fused_applicable(static: SceneStatic, cfg: RenderConfig) -> bool:
    return (
        not static.has_triangles
        and static.num_textures == 0
        and cfg.shader == "full"
    )


@functools.partial(
    jax.jit,
    static_argnames=("static", "cfg", "interpret", "block", "num_warps"),
    donate_argnums=(3,),
)
def fused_prim_iteration(
    static: SceneStatic,
    cfg: RenderConfig,
    cam: CameraState,
    film: Vec3,  # [N] planes, updated in place
    iteration: jnp.ndarray,  # traced scalar (1-based, like the reference)
    base_key: jax.Array,
    interpret: bool = False,
    block: int = BLOCK,
    num_warps: int = NUM_WARPS,
):
    """One full spp iteration in one kernel launch.

    Returns (film', alive_counts[depth])."""
    n = static.pixel_count
    depth = static.trace_depth
    ikey = prng.iteration_key(base_key, iteration)
    stage_keys = [prng.stage_key(ikey, 0, 0)] + [
        prng.stage_key(ikey, d, 1) for d in range(depth)
    ]
    keys = jnp.concatenate(
        [jax.random.key_data(k).astype(jnp.uint32) for k in stage_keys]
    )
    kw = _pow2_at_least(keys.shape[0])
    keys = jnp.pad(keys, (0, kw - keys.shape[0]))
    cam_vec = jnp.concatenate([
        cam.position, cam.view, cam.up, cam.right, cam.pixel_length,
        cam.aperture[None], cam.focal_dist[None],
    ]).astype(jnp.float32)

    n_blocks = -(-n // block)
    n_pad = n_blocks * block
    cw = _pow2_at_least(depth)
    planes = [jnp.pad(p, (0, n_pad - n)) for p in film]
    full = lambda size: pl.BlockSpec((size,), lambda i: (0,))
    blk = pl.BlockSpec((block,), lambda i: (i,))
    f32 = jax.ShapeDtypeStruct((n_pad,), jnp.float32)
    fr, fg, fb, alive = pl.pallas_call(
        functools.partial(_iteration_kernel, static, cfg, block),
        grid=(n_blocks,),
        in_specs=[full(_CAM_WORDS), full(kw), blk, blk, blk],
        out_specs=(blk, blk, blk, pl.BlockSpec((cw,), lambda i: (i,))),
        out_shape=(
            f32, f32, f32,
            jax.ShapeDtypeStruct((n_blocks * cw,), jnp.int32),
        ),
        input_output_aliases={2: 0, 3: 1, 4: 2},
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=num_warps),
        interpret=interpret,
        name="fused_prim_iteration",
    )(cam_vec, keys, *planes)

    film_out = Vec3(fr[:n], fg[:n], fb[:n])
    alive_counts = jnp.sum(alive.reshape(n_blocks, cw), axis=0)[:depth]
    return film_out, alive_counts
