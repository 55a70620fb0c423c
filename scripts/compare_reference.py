"""Render a scene and compare against a reference golden PNG (RMSE).

Usage:
  python scripts/compare_reference.py [scene.json] [--spp N] [--ref PNG]
                                      [--cpu] [--out DIR]

The comparison follows the reference output convention: accum/iters clamped
to [0,1], horizontally mirrored (our saved PNGs already mirror, so we compare
mirrored-to-golden directly).
"""

import argparse
import sys
import time

sys.path.insert(0, ".")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("scene", nargs="?", default="scenes/cornell.json")
    ap.add_argument("--spp", type=int, default=512)
    # The golden is the reference AUTHOR's 5000-spp render
    # (img/cornell.2025-09-25_23-38-19z.5000samp.png in the reference repo;
    # the instructor's REFERENCE_cornell.5000samp.png is ~25% darker because
    # it does not deposit depth-exhausted throughput; see CLAUDE.md parity
    # invariants).
    ap.add_argument("--ref", required=True, help="reference golden PNG")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--res", type=int, nargs=2, default=None)
    ap.add_argument("--integrator", default="megakernel")
    ap.add_argument("--aperture", type=float, default=None,
                    help="override the scene camera aperture (0 = pinhole control)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="img/compare")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    import numpy as np

    from project3_cuda_path_tracer_2025_tpu.config import RenderConfig
    from project3_cuda_path_tracer_2025_tpu.models import Renderer
    from project3_cuda_path_tracer_2025_tpu.scene import load_scene, set_resolution
    from project3_cuda_path_tracer_2025_tpu.utils import image_io

    scene = load_scene(args.scene)
    if args.res:
        set_resolution(scene, *args.res)
    if args.aperture is not None:
        scene.state.camera.aperture = args.aperture
    cfg = RenderConfig(integrator=args.integrator)
    r = Renderer(scene, cfg, seed=args.seed)

    t0 = time.time()
    r.step()
    print(f"compile+first step: {time.time()-t0:.1f}s", flush=True)
    res = r.render(spp=args.spp, out_dir=args.out, log_every=max(1, args.spp // 10))
    print(f"saved {res.path}")
    print(f"mean {res.stats.mean_ms:.2f} ms/frame over {res.iterations} iters")

    ours = image_io.film_to_u8(res.image, res.iterations, mirror=True).astype(float) / 255.0
    ref = image_io.read_png(args.ref).astype(float) / 255.0
    if ref.shape != ours.shape:
        print(f"shape mismatch ref {ref.shape} vs ours {ours.shape}; skipping RMSE")
        return
    diff = ours - ref
    rmse = float(np.sqrt((diff ** 2).mean()))
    print(f"RMSE vs {args.ref}: {rmse:.5f}")
    print(f"mean ours {ours.mean(axis=(0,1))} vs ref {ref.mean(axis=(0,1))}")
    print(f"abs-diff p50/p95/p99: {np.percentile(np.abs(diff), [50,95,99])}")


if __name__ == "__main__":
    main()
