"""Prove that the renderer runs on an NVIDIA GPU through its normal entry points.

    python chip_smoke.py               # one GPU: phases 1-3
    python chip_smoke.py --devices 4   # four GPUs: the multi-device phase only

Phases (one process; any failed phase fails the script):

1. Goldens on the card: every ``tests/goldens/*.npz`` whose scene and assets
   load is rendered at its own size and compared with its committed CPU film
   at the tolerance of ``tests/test_goldens.py``.
2. Main path at full width: six scenes through ``Renderer`` with the default
   config at 800x800, depth 8 -- compile seconds, ms per spp after warm-up
   (timed with ``jax.block_until_ready``), per-depth alive counts and
   ``memory_analysis()``; the film must be finite and not black.
3. Kernels against the plain reference: the Pallas Triton prim kernel
   against the XLA megakernel at 800x800, 4 spp (film bounds below); the
   threaded-BVH walk against brute force on the first-bounce hits of 64k
   camera rays on the 5k and 200k meshes; brute force on the 5k mesh at
   800x800 as one program against the BVH film; no ``dot`` in any compiled
   render program.  (The kernel's speed against the default megakernel is
   measured by ``scripts/bench_prim_kernel.py``.)
4. ``--devices N``: ``parallel/shardmap.py`` in pixel- and sample-parallel
   mode on N GPUs, on ``cornell.json`` and ``cornell_mesh_5k.json`` at
   800x800, each compared with the one-GPU XLA film in the same process.

The script exits non-zero without printing a result when JAX finds no GPU.
Its last line is ``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import subprocess
import sys
import time
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))
SCENES = os.path.join(REPO, "scenes")
MAIN_SCENES = (
    "cornell.json",
    "cornell_dof.json",
    "cornell_transmissive_sphere.json",
    "cornell_mesh_5k.json",
    "cornell_mesh_5k_closed.json",
    "cornell_mesh_200k.json",
)
PRIM_SCENES = MAIN_SCENES[:3]
# The closed room's front wall stands between the camera and the room, so
# every camera ray hits the wall's outer face and its bounce escapes into
# the void: the faithful image is exactly black.
EXPECT_BLACK = {"cornell_mesh_5k_closed.json"}
# Film bounds of a kernel against its plain reference: the mean |diff| is at
# most MEAN_REL x the mean film value, and at most SPLIT_FRAC of the pixels
# differ by more than SPLIT_ABS (paths that split at a near-tie).
MEAN_REL, SPLIT_ABS, SPLIT_FRAC = 1e-5, 1e-3, 1e-3
TIMED_SPP = 4


def say(*parts) -> None:
    print(*parts, flush=True)


def film_array(r):
    import numpy as np

    return np.asarray(r.image(), np.float64)  # [H, W, 3], accumulated


def compare_films(label: str, got, want) -> bool:
    """Phase-3 bounds; pixels are compared on their largest channel diff."""
    import numpy as np

    diff = np.abs(got - want)
    mean_ok = diff.mean() <= MEAN_REL * want.mean()
    split = (diff.max(axis=-1) > SPLIT_ABS).mean()
    ok = bool(mean_ok and split <= SPLIT_FRAC and np.isfinite(got).all())
    say(
        f"  {label}: mean|d|={diff.mean():.3e} (bound {MEAN_REL * want.mean():.3e}) "
        f"max|d|={diff.max():.3e} split_pixels={split:.2e} "
        f"(bound {SPLIT_FRAC:.0e}) -> {'ok' if ok else 'FAIL'}"
    )
    return ok


def timed_ms_per_spp(r, spp: int = TIMED_SPP) -> float:
    import jax

    r.step()  # warm-up (compiled already)
    t0 = time.perf_counter()
    for _ in range(spp):
        r.step(sync=False)
    jax.block_until_ready(r.film)
    return (time.perf_counter() - t0) * 1e3 / spp


def phase_goldens(ctx) -> bool:
    import numpy as np

    from project3_cuda_path_tracer_2025_tpu.config import RenderConfig
    from project3_cuda_path_tracer_2025_tpu.models import Renderer
    from project3_cuda_path_tracer_2025_tpu.scene import load_scene, set_resolution

    ok, ran = True, 0
    for path in sorted(glob.glob(os.path.join(REPO, "tests", "goldens", "*.npz"))):
        name = os.path.basename(path)[:-4]
        g = np.load(path)
        scene_path = str(g["scene"]).replace("$REPO", REPO)
        if not os.path.exists(scene_path):
            say(f"  {name}: skipped, scene not in the tree")
            continue
        try:
            scene = load_scene(scene_path)
        except FileNotFoundError as e:
            say(f"  {name}: skipped, asset not in the tree ({e})")
            continue
        w, h, spp = int(g["width"]), int(g["height"]), int(g["spp"])
        r = Renderer(set_resolution(scene, w, h), RenderConfig(), seed=0)
        for _ in range(spp):
            r.step()
        got = np.asarray(r.image(), np.float32).reshape(-1, 3)
        want = g["film"]
        bad = ~np.isclose(got, want, rtol=2e-4, atol=2e-5)
        case_ok = bool(np.isfinite(got).all() and not bad.any())
        ok &= case_ok
        ran += 1
        say(
            f"  {name}: {w}x{h} {spp} spp path={ctx['path_of'](r)} "
            f"max|d|={np.abs(got - want).max():.3e} "
            f"outside_tol={int(bad.sum())}/{bad.size} -> {'ok' if case_ok else 'FAIL'}"
        )
    return ok and ran > 0


def phase_main_path(ctx) -> bool:
    import numpy as np

    from project3_cuda_path_tracer_2025_tpu.config import RenderConfig
    from project3_cuda_path_tracer_2025_tpu.models import Renderer

    ok = True
    for name in MAIN_SCENES:
        t0 = time.perf_counter()
        r = Renderer(os.path.join(SCENES, name), RenderConfig())
        setup_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        compiled = r.compile()
        compile_s = time.perf_counter() - t0
        ctx["programs"][name] = compiled.as_text()
        ms = timed_ms_per_spp(r)
        img = r.image_normalized()
        finite = bool(np.isfinite(img).all())
        if name in EXPECT_BLACK:
            lit_ok = img.max() == 0
        else:
            lit_ok = img.mean() > 0
        ok &= finite and bool(lit_ok)
        mem = compiled.memory_analysis()
        ctx["renderers"][name] = r
        say(json.dumps({
            "phase": "main_path", "scene": name, "path": ctx["path_of"](r),
            "width": r.static.width, "height": r.static.height,
            "depth": r.static.trace_depth, "triangles": r.static.num_triangles,
            "setup_s": round(setup_s, 3), "compile_s": round(compile_s, 3),
            "ms_per_spp": ms, "spp_timed": TIMED_SPP,
            "alive": [int(a) for a in r._alive_counts],
            "film_mean": float(img.mean()), "finite": finite,
            "memory": {
                k: getattr(mem, k, None) for k in (
                    "argument_size_in_bytes", "output_size_in_bytes",
                    "temp_size_in_bytes", "generated_code_size_in_bytes",
                )
            },
        }))
    return ok


def phase_kernels(ctx) -> bool:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from project3_cuda_path_tracer_2025_tpu.models import Renderer
    from project3_cuda_path_tracer_2025_tpu.ops.camera import generate_camera_rays
    from project3_cuda_path_tracer_2025_tpu.ops.intersect import (
        FLT_MAX, bvh_walk, mesh_intersect_brute,
    )
    from project3_cuda_path_tracer_2025_tpu.utils import prng
    from project3_cuda_path_tracer_2025_tpu.utils.vec import Vec3

    ok = True
    say("  prim kernel (Triton) vs XLA megakernel, 800x800, 4 spp, seed 0:")
    for name in PRIM_SCENES:
        tri = ctx["renderers"][name]
        if ctx["path_of"](tri) != "triton":
            say(f"  {name}: the default path is not the Triton kernel")
            ok = False
            continue
        xla = Renderer(tri.scene, ctx["xla_reference"])
        xla.compile()
        tri.reset()
        for _ in range(4):
            tri.step()
            xla.step()
        ok &= compare_films(name, film_array(tri), film_array(xla))
        if not (tri._alive_counts == xla._alive_counts).all():
            say(f"  {name}: alive counts {tri._alive_counts} vs {xla._alive_counts}")
            ok = False

    say("  threaded BVH vs brute force, first-bounce hits of 64k camera rays:")
    for name in ("cornell_mesh_5k.json", "cornell_mesh_200k.json"):
        r = ctx["renderers"][name]
        dev, static = r.dev, r.static
        n = static.pixel_count
        u = prng.uniforms(jax.random.PRNGKey(1), n, 4)
        rays = generate_camera_rays(r._cam_state, static.width, static.height, 1, u)
        eps = r.cfg.baby_epsilon
        walk = jax.jit(lambda ro, rd: bvh_walk(
            dev, static, ro, rd, jnp.ones(ro.x.shape, bool),
            jnp.full(ro.x.shape, FLT_MAX, jnp.float32), eps,
        ))
        brute = jax.jit(lambda ro, rd: mesh_intersect_brute(
            dev, static, ro, rd, jnp.ones(ro.x.shape, bool),
            jnp.full(ro.x.shape, FLT_MAX, jnp.float32), eps,
        ))
        _, full_steps = walk(rays.origin, rays.direction)
        sub = slice(0, n, max(1, n // 64000))
        ro = Vec3(*[c[sub] for c in rays.origin])
        rd = Vec3(*[c[sub] for c in rays.direction])
        bh, steps = walk(ro, rd)
        bf = brute(ro, rd)
        tri_h, tri_f = np.asarray(bh.tri), np.asarray(bf.tri)
        t_h, t_f = np.asarray(bh.t), np.asarray(bf.t)
        hit = tri_f >= 0
        same = tri_h == tri_f
        t_ok = np.allclose(t_h[hit], t_f[hit], rtol=1e-5, atol=0)
        case_ok = bool(same.all() and t_ok)
        ok &= case_ok
        say(json.dumps({
            "phase": "bvh_vs_brute", "scene": name, "rays": int(tri_f.size),
            "hits": int(hit.sum()), "tri_mismatch": int((~same).sum()),
            "t_within_1e-5": bool(t_ok), "walk_steps_64k": int(steps),
            "walk_steps_800x800_first_bounce": int(full_steps),
            "ok": case_ok,
        }))

    say("  brute force at 800x800 as one program (5k mesh, 1 spp) vs the BVH:")
    bvh = ctx["renderers"]["cornell_mesh_5k.json"]
    brute = Renderer(bvh.scene, ctx["xla_reference"].replace(bvh_acceleration=False))
    t0 = time.perf_counter()
    brute.compile()
    compile_s = time.perf_counter() - t0
    bvh.reset()
    bvh.step()
    t0 = time.perf_counter()
    brute.step()
    run_s = time.perf_counter() - t0
    ok &= compare_films("cornell_mesh_5k.json brute vs bvh", film_array(brute), film_array(bvh))
    say(json.dumps({
        "phase": "brute_800x800_one_program", "compile_s": round(compile_s, 3),
        "ms_per_spp": run_s * 1e3, "alive": [int(a) for a in brute._alive_counts],
    }))

    dots = {
        name: len(re.findall(r"\bdot\(", text))
        for name, text in ctx["programs"].items()
    }
    say(f"  dot instructions per compiled render program: {dots}")
    return ok and not any(dots.values())


def phase_devices(ctx, nd: int) -> bool:
    import jax

    from project3_cuda_path_tracer_2025_tpu.models import Renderer
    from project3_cuda_path_tracer_2025_tpu.scene import load_scene

    if len(jax.devices()) < nd:
        say(f"  needs {nd} GPUs, JAX sees {len(jax.devices())}")
        return False
    ok = True
    for name in ("cornell.json", "cornell_mesh_5k.json"):
        scene = load_scene(os.path.join(SCENES, name))
        one = Renderer(scene, ctx["xla_reference"])
        one.compile()
        for _ in range(nd):
            one.step()
        one_film = film_array(one)
        one_ms = timed_ms_per_spp(one, 4)
        for mode in ("pixel", "sample"):
            r = Renderer(
                scene, ctx["xla_reference"].replace(devices=nd, parallel_mode=mode)
            )
            t0 = time.perf_counter()
            r.compile()
            compile_s = time.perf_counter() - t0
            if mode == "pixel":
                for _ in range(nd):
                    r.step()
            else:
                r.step()  # one step = nd samples, one per device
            assert r.iteration == nd
            got = film_array(r)
            case_ok = compare_films(f"{name} {mode}x{nd} vs one GPU", got, one_film)
            ok &= case_ok
            step_ms = timed_ms_per_spp(r, 4)
            say(json.dumps({
                "phase": "devices", "scene": name, "mode": mode, "devices": nd,
                "compile_s": round(compile_s, 3),
                "ms_per_step": step_ms, "spp_per_step": r._spp_stride,
                "one_gpu_ms_per_spp": one_ms, "ok": case_ok,
            }))
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument(
        "--devices", type=int, default=1,
        help="N > 1 runs only the N-GPU phase and its comparison",
    )
    args = ap.parse_args(argv)

    import jax

    if jax.default_backend() != "gpu":
        print(
            f"chip_smoke: JAX found no GPU (default backend "
            f"{jax.default_backend()!r}); nothing runs elsewhere",
            file=sys.stderr,
        )
        return 1
    sys.path.insert(0, REPO)
    from project3_cuda_path_tracer_2025_tpu.ops import fused
    from project3_cuda_path_tracer_2025_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    from project3_cuda_path_tracer_2025_tpu.config import RenderConfig

    cache_dir = enable_compile_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    dev = jax.devices()[0]
    say(smi)
    say(f"device_kind: {dev.device_kind}")
    say(f"jax {jax.__version__}; XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}; "
        f"compile cache {cache_dir}")

    def path_of(r):
        if r.cfg.devices > 1:
            return f"shard_map:{r.cfg.parallel_mode}"
        if (
            r.cfg.integrator == "megakernel"
            and fused.fused_applicable(r.static, r.cfg)
            and r.cfg.resolved_fused_bounce()
        ):
            return "triton"
        return "xla"

    ctx = {
        "path_of": path_of, "renderers": {}, "programs": {},
        # The plain reference of phases 3 and 4: the XLA megakernel with its
        # bounce loop rolled -- the same arithmetic as the default unrolled
        # loop at a fraction of its compile time.  The kernel's speed against
        # the default megakernel is scripts/bench_prim_kernel.py's job.
        "xla_reference": RenderConfig(fused_bounce="off", unroll_bounces=False),
    }
    if args.devices > 1:
        phases = [("devices", lambda c: phase_devices(c, args.devices))]
    else:
        phases = [
            ("goldens", phase_goldens),
            ("main_path", phase_main_path),
            ("kernels", phase_kernels),
        ]
    failed = []
    for name, phase in phases:
        say(f"phase {name}:")
        t0 = time.perf_counter()
        try:
            ok = phase(ctx)
        except Exception:  # report the phase as failed and run the others
            traceback.print_exc()
            ok = False
        say(f"phase {name}: {'PASS' if ok else 'FAIL'} "
            f"({time.perf_counter() - t0:.1f} s)")
        if not ok:
            failed.append(name)
    if failed:
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1
    say(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
