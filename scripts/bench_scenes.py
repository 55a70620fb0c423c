"""Benchmark a set of scenes on the current backend; prints one JSON line per
config plus a summary.

Each config runs in its OWN subprocess, one after another (the parent never
touches JAX, so each child has the card to itself): a fault in one config
then only kills that config instead of poisoning every following run.

Covers the reference's benchmark matrix (BASELINE.md): cornell-class
diffuse, mesh+BVH (and optional brute-force A/B), material sorting A/B.
"""

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_INNER = r"""
import sys, os, json, time
sys.path.insert(0, {repo!r}); os.chdir({repo!r})
cfg_kw = json.loads({cfg_json!r})
spp, batch, res, cpu = {spp}, {batch}, {res}, {cpu}
if cpu:
    import jax; jax.config.update("jax_platforms", "cpu")
from project3_cuda_path_tracer_2025_tpu.config import RenderConfig
from project3_cuda_path_tracer_2025_tpu.models import Renderer
from project3_cuda_path_tracer_2025_tpu.scene import load_scene, set_resolution
import numpy as np
scene = load_scene({path!r})
if res:
    set_resolution(scene, res, res)
r = Renderer(scene, RenderConfig(spp_per_launch=batch, **cfg_kw))
r.step_many(batch)  # compile + warmup (AOT; device-synced)
t0 = time.perf_counter()
done = 0
while done < spp:
    done += batch
    r.step_many(batch, sync=done >= spp)  # one sync at the end
dt = time.perf_counter() - t0
ms = dt * 1e3 / done
rays = float(r._alive_counts.sum() + r.static.pixel_count)
print("RESULT " + json.dumps(dict(
    scene=os.path.basename({path!r}),
    tris=r.static.num_triangles,
    ms_per_frame=round(ms, 2),
    mrays_per_s=round(rays / (ms * 1e3), 1),
    depth_alive=[int(c) for c in r._alive_counts],
    finite=bool(np.isfinite(r.image()).all()),
    **cfg_kw,
)))
"""


def bench_scene(path, cfg_kw, spp=32, batch=16, res=None, cpu=False, timeout=1200):
    code = _INNER.format(
        repo=REPO,
        cfg_json=json.dumps(cfg_kw),
        spp=spp,
        batch=batch,
        res=res if res else None,
        cpu=cpu,
        path=path,
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=timeout
    )
    for line in out.stdout.splitlines():
        if line.startswith("RESULT "):
            return json.loads(line[len("RESULT "):])
    tail = (out.stderr or out.stdout).strip().splitlines()
    raise RuntimeError(tail[-1][:300] if tail else "no output")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--spp", type=int, default=32)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--quick", action="store_true", help="skip A/B + heavy configs")
    ap.add_argument("--res", type=int, default=None, help="square resolution override")
    args = ap.parse_args()

    runs = [
        ("scenes/cornell.json", {}),
        ("scenes/cornell_mesh_5k.json", {}),
        ("scenes/cornell_mesh_20k.json", {}),
        ("scenes/cornell_mesh_textured.json", {}),
        ("scenes/cornell_prim_textured.json", {}),
        ("scenes/cornell_mesh_80k.json", {}),
        ("scenes/cornell_mesh_200k.json", {}),  # cyrene-class heavy mesh
        ("scenes/cornell_mesh_500k.json", {}),  # 2.5x past the reference's largest
    ]
    if not args.quick:
        runs += [
            # the XLA megakernel on the prim room (auto = Triton kernel)
            ("scenes/cornell.json", {"fused_bounce": "off"}),
            # wavefront default = adaptive compaction + tiers
            ("scenes/cornell.json", {"integrator": "wavefront"}),
            (  # the reference's always-pack STREAM_COMPACTION parity config
                "scenes/cornell.json",
                {"integrator": "wavefront", "stream_compaction": True},
            ),
            (
                "scenes/cornell.json",
                {"integrator": "wavefront", "material_sorting": True},
            ),
            ("scenes/cornell_mesh_5k.json", {"bvh_acceleration": False}),
        ]

    results = []
    for path, kw in runs:
        try:
            r = bench_scene(
                path, kw, spp=args.spp, batch=args.batch, cpu=args.cpu,
                res=args.res,
            )
            results.append(r)
            print(json.dumps(r), flush=True)
        except Exception as e:
            print(json.dumps({"scene": path, "error": str(e)[:300]}), flush=True)

    print("== summary ==")
    for r in results:
        print(r)


if __name__ == "__main__":
    main()
