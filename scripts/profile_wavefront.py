"""Per-stage wavefront-integrator profiling (VERDICT round-2 #3).

Times each bounce stage of the wavefront integrator in isolation on the
current backend -- raygen, prim intersect, shade, compaction (split into
scan/perm-build/apply), material sort -- by chaining K iterations of the
stage inside one jitted fori_loop (a fake data dependence defeats
loop-invariant hoisting) and device-syncing once.  Mirrors how the mesh
path was profiled in round 2.

    python scripts/profile_wavefront.py [--res 800 --k 32 --cpu]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--res", type=int, default=800)
    ap.add_argument("--k", type=int, default=32)
    ap.add_argument("--scene", default="scenes/cornell.json")
    args = ap.parse_args()

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
    import jax
    import jax.numpy as jnp

    from project3_cuda_path_tracer_2025_tpu.config import RenderConfig
    from project3_cuda_path_tracer_2025_tpu.ops import camera as camera_ops
    from project3_cuda_path_tracer_2025_tpu.ops import shade as shade_ops
    from project3_cuda_path_tracer_2025_tpu.ops.compaction import (
        _apply_permutation, compact_paths, front_pack_permutation,
        sort_paths_by_material,
    )
    from project3_cuda_path_tracer_2025_tpu.ops.intersect import intersect_scene
    from project3_cuda_path_tracer_2025_tpu.ops import scan as scan_ops
    from project3_cuda_path_tracer_2025_tpu.scene import (
        load_scene, set_resolution, build_device_scene, camera_state,
        derive_render_camera,
    )
    from project3_cuda_path_tracer_2025_tpu.utils import prng

    scene = set_resolution(load_scene(args.scene), args.res, args.res)
    dev, static = build_device_scene(scene)
    cfg = RenderConfig(integrator="wavefront")
    cam = camera_state(derive_render_camera(scene.state.camera))
    n = static.pixel_count
    k = args.k

    key = jax.random.PRNGKey(0)
    ikey = prng.iteration_key(key, jnp.int32(1))
    cam_u = prng.uniforms(prng.stage_key(ikey, 0, 0), n, 4)
    paths0 = camera_ops.generate_camera_rays(
        cam, static.width, static.height, static.trace_depth, cam_u
    )
    # A mid-bounce state (more realistic mix of dead/live) for stage timing.
    isect0 = jax.jit(lambda p: intersect_scene(dev, static, p, cfg))(paths0)
    su0 = prng.uniforms_at(prng.stage_key(ikey, 0, 1), paths0.pixel, 3, n)
    paths1 = jax.jit(
        lambda p, i, u: shade_ops.shade(dev, static, p, i, u, cfg)
    )(paths0, isect0, su0)

    def timed(name, fn, *arrs):
        f = jax.jit(fn)
        out = f(*arrs)  # compile
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        out = f(*arrs)
        jax.block_until_ready(out)
        ms = (time.perf_counter() - t0) * 1e3 / k
        print(f"{name:28s} {ms:8.3f} ms/bounce")
        return ms

    def chain(stage):
        """k applications with a fake dependence (p.origin.x += 0*out)."""

        def body(paths):
            for _ in range(k):
                paths = stage(paths)
            return paths

        return body

    def perturb(paths, s):
        s0 = jnp.asarray(s).ravel()[0].astype(jnp.float32)
        return paths._replace(
            origin=paths.origin._replace(x=paths.origin.x + 0.0 * s0)
        )

    # -- stages ------------------------------------------------------------
    def st_raygen(paths):
        p = camera_ops.generate_camera_rays(
            cam, static.width, static.height, static.trace_depth, cam_u
        )
        return perturb(p, paths.origin.x[0])

    def st_intersect(paths):
        i = intersect_scene(dev, static, paths, cfg)
        return perturb(paths, i.t)

    def st_shade(paths):
        i = intersect_scene(dev, static, paths, cfg)
        su = prng.uniforms_at(prng.stage_key(ikey, 1, 1), paths.pixel, 3, n)
        return shade_ops.shade(dev, static, paths, i, su, cfg)

    def st_scan_only(paths):
        dest, live = scan_ops.compact_indices(paths.alive)
        return perturb(paths, dest.astype(jnp.float32))

    def st_permbuild(paths):
        perm, live = front_pack_permutation(paths.alive)
        return perturb(paths, perm.astype(jnp.float32))

    def st_compact(paths):
        p, live = compact_paths(paths)
        return p

    def st_apply_only(paths):
        perm = jnp.argsort(paths.pixel)  # any permutation; times the apply
        return _apply_permutation(paths, perm)

    def st_matsort(paths):
        i = intersect_scene(dev, static, paths, cfg)
        p, i2 = sort_paths_by_material(paths, i, static.num_materials)
        return p

    def st_full_bounce(paths):
        i = intersect_scene(dev, static, paths, cfg)
        su = prng.uniforms_at(prng.stage_key(ikey, 1, 1), paths.pixel, 3, n)
        p = shade_ops.shade(dev, static, paths, i, su, cfg)
        p, live = compact_paths(p)
        return p

    print(f"n = {n} rays, k = {k} chained, backend = {jax.default_backend()}")
    timed("raygen", chain(st_raygen), paths1)
    timed("intersect (prims)", chain(st_intersect), paths1)
    timed("intersect+shade", chain(st_shade), paths1)
    timed("scan (compact_indices)", chain(st_scan_only), paths1)
    timed("perm build (scan+scatter)", chain(st_permbuild), paths1)
    timed("perm apply ([N,11] gather)", chain(st_apply_only), paths1)
    timed("compact (build+apply)", chain(st_compact), paths1)
    timed("material sort", chain(st_matsort), paths1)
    timed("FULL bounce (i+s+c)", chain(st_full_bounce), paths1)


if __name__ == "__main__":
    main()
