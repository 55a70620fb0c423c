"""Image-parity control experiments (VERDICT round-1 item 3).

Round-1 compared our render of the SHIPPED cornell.json (diffuse sphere,
APERTURE 0.02) against the author's cornell.2025-09-25_23-38-19z.5000samp.png
and attributed the RMSE 0.040 residual to DoF.  The reference README at line
267 labels that golden "Transmissive material": it is the cornell box with a
TRANSMISSIVE sphere (the scene later shipped as cornell_transmissive_test's
material block), so round-1 was comparing different scenes.

This script runs the controls that close the question:
  1. A/A noise floor: two 5000-spp renders of cornell.json, different seeds.
  2. Scene-matched golden reconstruction: cornell + transmissive sphere
     (IOR 1.5) at several apertures vs the author's golden.
  3. The round-1 comparison repeated (diffuse cornell vs transmissive
     golden) for the record.

Round-4 addition (--trans-floor): the round-3 campaign compared the best
scene-matched render (RMSE 0.0155) against the A/A floor of the DIFFUSE
cornell (0.01255) -- but the golden's scene is the transmissive sphere at
APERTURE 0.8 (= the reference's scenes/cornell_transmissive_test.json,
whose camera block settles the round-3 "guessed parameter" question: the
aperture is 0.8 by the author's own file).  Transmissive paths carry more
variance at equal spp, so the operative floor is the A/A RMSE of THAT
scene.  --trans-floor measures it (two seeds, reference scene file), plus
an error decomposition (mean-shift vs residual) against the golden.

Usage: python scripts/parity_experiments.py --golden PNG [--ref-trans JSON]
           [--spp 5000] [--quick]
(PNG: the reference's img/cornell.2025-09-25_23-38-19z.5000samp.png; JSON:
its scenes/cornell_transmissive_test.json.)
Writes renders to renders/parity/ and a JSON summary to stdout +
renders/parity/summary.json.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CORNELL = "scenes/cornell.json"
TRANS = "scenes/cornell_transmissive_sphere.json"
OUT = "renders/parity"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--spp", type=int, default=5000)
    ap.add_argument("--quick", action="store_true", help="256 spp smoke mode")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--golden", required=True, help="the author's golden PNG")
    ap.add_argument("--ref-trans", default=None,
                    help="the reference's cornell_transmissive_test.json")
    ap.add_argument("--trans-floor", action="store_true",
                    help="run only the round-4 transmissive-floor controls")
    args = ap.parse_args()
    spp = 256 if args.quick else args.spp

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    import numpy as np

    from project3_cuda_path_tracer_2025_tpu.config import RenderConfig
    from project3_cuda_path_tracer_2025_tpu.models import Renderer
    from project3_cuda_path_tracer_2025_tpu.scene import load_scene
    from project3_cuda_path_tracer_2025_tpu.utils import image_io

    os.makedirs(OUT, exist_ok=True)
    golden = image_io.read_png(args.golden).astype(np.float64) / 255.0

    def render(scene_path, seed=0, aperture=None, tag=""):
        scene = load_scene(scene_path)
        if aperture is not None:
            scene.state.camera.aperture = aperture
        cfg = RenderConfig(spp_per_launch=64)
        r = Renderer(scene, cfg, seed=seed)
        t0 = time.time()
        r.render(spp=spp)
        wall = time.time() - t0
        img = image_io.film_to_u8(r.image(), r.iteration, mirror=True)
        img = img.astype(np.float64) / 255.0
        print(f"[{tag}] {spp} spp in {wall:.1f}s "
              f"({wall / spp * 1e3:.2f} ms/frame)", flush=True)
        return img

    def rmse(a, b):
        return float(np.sqrt(((a - b) ** 2).mean()))

    summary = {"spp": spp}

    if args.trans_floor:
        # Round-4 controls: the reference's OWN transmissive scene file
        # (aperture 0.8 is in the file -- not a guessed parameter), its A/A
        # floor, and a decomposition of the remaining golden residual.
        REF_TRANS = args.ref_trans
        t0 = render(REF_TRANS, seed=0, tag="ref-trans seed0")
        t1 = render(REF_TRANS, seed=1, tag="ref-trans seed1")
        summary["aa_rmse_trans"] = rmse(t0, t1)
        summary["ref_trans_vs_golden"] = rmse(t0, golden)
        summary["ref_trans_seed1_vs_golden"] = rmse(t1, golden)
        # decomposition: per-channel mean shift vs zero-mean residual
        shift = (t0 - golden).mean((0, 1))
        resid = (t0 - golden) - shift
        summary["golden_mean_shift"] = [round(float(x), 6) for x in shift]
        summary["golden_resid_rmse"] = rmse(resid, 0 * resid)
        # where does the residual sit?  center (sphere) vs border (walls)
        h, w, _ = t0.shape
        cy, cx = slice(h // 4, 3 * h // 4), slice(w // 4, 3 * w // 4)
        inner = (t0 - golden)[cy, cx]
        summary["golden_rmse_center"] = rmse(inner, 0 * inner)
        mask = np.ones((h, w, 3), bool)
        mask[cy, cx] = False
        summary["golden_rmse_border"] = float(
            np.sqrt(((t0 - golden)[mask] ** 2).mean())
        )
        image_io.write_png(
            os.path.join(OUT, f"ref_trans.{spp}samp.png"),
            (np.clip(t0, 0, 1) * 255).astype(np.uint8),
        )
        out_path = os.path.join(OUT, "summary_trans_floor.json")
        with open(out_path, "w") as f:
            json.dump(summary, f, indent=1)
        print(json.dumps(summary))
        return

    # 1. A/A noise floor
    a0 = render(CORNELL, seed=0, tag="cornell seed0")
    a1 = render(CORNELL, seed=1, tag="cornell seed1")
    summary["aa_rmse_cornell"] = rmse(a0, a1)
    print(f"A/A self-RMSE (cornell, {spp} spp, two seeds): "
          f"{summary['aa_rmse_cornell']:.5f}", flush=True)

    # 3. round-1 comparison for the record (diffuse scene vs trans golden)
    summary["diffuse_vs_golden"] = rmse(a0, golden)
    summary["diffuse_means"] = [round(float(x), 5) for x in a0.mean((0, 1))]
    summary["golden_means"] = [round(float(x), 5) for x in golden.mean((0, 1))]

    # 2. scene-matched reconstructions at candidate apertures
    for ap_v in (0.02, 0.4, 0.8, 0.0):
        img = render(TRANS, seed=0, aperture=ap_v, tag=f"trans ap={ap_v}")
        key = f"trans_ap{ap_v}_vs_golden"
        summary[key] = rmse(img, golden)
        summary[f"trans_ap{ap_v}_means"] = [
            round(float(x), 5) for x in img.mean((0, 1))
        ]
        print(f"transmissive sphere, aperture {ap_v}: RMSE vs golden = "
              f"{summary[key]:.5f}", flush=True)
        # keep the best-aperture render on disk for the docs
        image_io.write_png(
            os.path.join(OUT, f"cornell_trans_ap{ap_v}.{spp}samp.png"),
            (np.clip(img, 0, 1) * 255).astype(np.uint8),
        )

    with open(os.path.join(OUT, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
