"""Closed-vs-open box stream-compaction study (reference methodology).

The reference measures its compaction toggle on a scene pair differing only
by a front wall (``cornell_obj_phatphuck.json`` vs ``_closed.json``):
closed 148.7 ms vs open 109.7 ms with compaction on (README.md:138-151),
because closed-box rays rarely terminate so compaction has nothing to
remove.  This reruns that exact methodology with the static-shape
compaction (front-pack permutation) of the wavefront integrator, plus the
megakernel (mask-only termination) for context, on the procedural scene
pair ``cornell_mesh_5k.json`` / ``cornell_mesh_5k_closed.json``.

Prints one JSON line per (scene, config) and a summary; run on the GPU:
    python scripts/compaction_study.py [--res 800 --spp 32]
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from scripts.bench_scenes import bench_scene  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--spp", type=int, default=32)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--res", type=int, default=None)
    args = ap.parse_args()

    runs = []
    for scene in ("scenes/cornell_mesh_5k.json",
                  "scenes/cornell_mesh_5k_closed.json"):
        for cfg in (
            {"integrator": "wavefront", "stream_compaction": True},
            {"integrator": "wavefront", "stream_compaction": False},
            {},  # megakernel (mask-only termination), the production path
        ):
            runs.append((scene, cfg))

    results = []
    for path, kw in runs:
        try:
            r = bench_scene(path, kw, spp=args.spp, batch=args.batch,
                            cpu=args.cpu, res=args.res, timeout=2400)
            results.append(r)
            print(json.dumps(r), flush=True)
        except Exception as e:
            print(json.dumps({"scene": path, "error": str(e)[:300], **kw}),
                  flush=True)
    print("== summary ==")
    for r in results:
        print(r)


if __name__ == "__main__":
    main()
