"""Render every scene in scenes/ end to end at low spp.

Each scene renders in its own subprocess (like bench_scenes.py, so one
fault can't poison the sweep), asserting a finite film and sane
brightness, and recording ms/frame.  Scenes whose assets are not in the
tree record a load error -- expected, not a failure.  ``--extra-dir`` adds
the JSON scenes of another directory (e.g. the reference's own suite).

    python scripts/scene_matrix.py [--cpu] [--spp 4] [--res 200] [--out F]
"""

import argparse
import glob
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

_INNER = r"""
import sys, os, json, time
sys.path.insert(0, {repo!r}); os.chdir({repo!r})
spp, batch, res, cpu = {spp}, {batch}, {res}, {cpu}
if cpu:
    import jax; jax.config.update("jax_platforms", "cpu")
from project3_cuda_path_tracer_2025_tpu.config import RenderConfig
from project3_cuda_path_tracer_2025_tpu.models import Renderer
from project3_cuda_path_tracer_2025_tpu.scene import load_scene, set_resolution
import numpy as np
try:
    scene = load_scene({path!r})
except Exception as e:
    print("RESULT " + json.dumps(dict(
        scene=os.path.basename({path!r}), load_error=str(e)[:160])))
    raise SystemExit(0)
if res:
    set_resolution(scene, res, res)
r = Renderer(scene, RenderConfig(spp_per_launch=batch))
r.step_many(batch)  # compile + warmup
t0 = time.perf_counter()
r.step_many(spp, sync=True)
ms = (time.perf_counter() - t0) * 1e3 / spp
img = r.image_normalized()
print("RESULT " + json.dumps(dict(
    scene=os.path.basename({path!r}),
    tris=r.static.num_triangles,
    prims=len(r.static.geoms),
    ms_per_frame=round(ms, 2),
    finite=bool(np.isfinite(img).all()),
    mean_rgb=[round(float(m), 5) for m in img.reshape(-1, 3).mean(0)],
    max_rgb=round(float(img.max()), 4),
)))
"""


def run_scene(path, spp, batch, res, cpu, timeout):
    code = _INNER.format(
        repo=REPO, spp=spp, batch=batch,
        res=res if res else None, cpu=cpu, path=path,
    )
    try:
        out = subprocess.run(
            [sys.executable, "-c", code], capture_output=True, text=True,
            timeout=timeout,
        )
    except subprocess.TimeoutExpired:
        return dict(scene=os.path.basename(path), error=f"timeout {timeout}s")
    for line in out.stdout.splitlines():
        if line.startswith("RESULT "):
            return json.loads(line[len("RESULT "):])
    tail = (out.stderr or out.stdout).strip().splitlines()
    return dict(
        scene=os.path.basename(path),
        error=(tail[-1][:300] if tail else "no output"),
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--res", type=int, default=None,
                    help="square res override (default: native)")
    ap.add_argument("--timeout", type=int, default=2400)
    ap.add_argument("--only", default=None)
    ap.add_argument("--out", default="chiprun_out/scene_matrix.json")
    ap.add_argument("--extra-dir", default=None)
    args = ap.parse_args()

    paths = sorted(glob.glob(os.path.join(REPO, "scenes", "*.json")))
    if args.extra_dir:
        paths += sorted(glob.glob(os.path.join(args.extra_dir, "*.json")))

    results = []
    n_bad = 0
    for p in paths:
        if args.only and args.only not in p:
            continue
        rec = run_scene(p, args.spp, args.batch, args.res, args.cpu,
                        args.timeout)
        # sanity: finite film, not black, not blown out.  The CLOSED box
        # pair member legitimately renders black: the reference places its
        # camera OUTSIDE the added front wall (EYE z=10.5, wall z=5), so
        # camera rays bounce off the unlit exterior and die (PARITY.md
        # round-3 closed-box study) -- faithful, not a failure.
        dark_ok = "closed" in rec["scene"]
        if "ms_per_frame" in rec:
            mean = sum(rec["mean_rgb"]) / 3.0
            rec["sane"] = bool(
                rec["finite"] and (1e-5 < mean < 5.0 or dark_ok)
            )
            n_bad += not rec["sane"]
        elif "load_error" in rec:
            rec["sane"] = None  # stripped assets: expected
        else:
            n_bad += 1
        print(json.dumps(rec), flush=True)
        results.append(rec)

    os.makedirs(os.path.dirname(os.path.join(REPO, args.out)), exist_ok=True)
    with open(os.path.join(REPO, args.out), "w") as f:
        json.dump(results, f, indent=1)
    rendered = sum("ms_per_frame" in r for r in results)
    skipped = sum("load_error" in r for r in results)
    print(f"# {rendered} rendered, {skipped} unloadable (stripped assets), "
          f"{n_bad} FAILED -> {args.out}")
    sys.exit(1 if n_bad else 0)


if __name__ == "__main__":
    main()
