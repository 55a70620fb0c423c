"""(Re)generate the committed golden films under tests/goldens/.

The bit-exactness test matrix proves every integrator/toggle combination
produces the SAME image -- but if all paths drifted together (an epsilon
edit, a BSDF formula change, an RNG rekeying), nothing would notice.  The
goldens lock ABSOLUTE behavior: tiny CPU renders at a fixed seed, compared
by tests/test_goldens.py with a tight tolerance.

Run only when an intentional behavior change invalidates them, then commit
the new .npz files together with the change that justifies them:

    python scripts/gen_goldens.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(REPO, "tests", "goldens")

# (name, scene path, width, height, spp) -- kept tiny so the whole set
# renders on one CPU core in ~a minute.  Coverage: diffuse+emissive
# (cornell), glass/Fresnel + the 1e-3 ray-advance epsilon (glass_test),
# Cook-Torrance (microfacet_test), pure mirror (reflective_test), and the
# full mesh pipeline -- OBJ load, BVH, traversal, texture + bump shading
# (mesh_textured).
MATRIX = [
    ("cornell", os.path.join(REPO, "scenes", "cornell.json"), 48, 48, 2),
    ("glass", "/root/reference/scenes/cornell_glass_test.json", 32, 32, 2),
    ("microfacet",
     "/root/reference/scenes/cornell_microfacet_test.json", 32, 32, 2),
    ("reflective",
     "/root/reference/scenes/cornell_reflective_test.json", 32, 32, 2),
    ("mesh_textured",
     os.path.join(REPO, "scenes", "cornell_mesh_textured.json"), 32, 32, 1),
    # The author's own quality anchor is the TRANSMISSIVE cornell
    # (/root/reference/README.md:267) and DoF (aperture > 0) is the other
    # historically-trickiest parity path -- both get absolute locks.
    ("transmissive",
     "/root/reference/scenes/cornell_transmissive_test.json", 32, 32, 2),
    ("dof", os.path.join(REPO, "scenes", "cornell_dof.json"), 32, 32, 2),
    # Ties the texture pipeline to REAL reference assets beyond wahoo.bmp:
    # a faithful proxy of cornell_obj_phatphuck_texture_test.json (same
    # materials/camera/walls) with the two surviving reference textures --
    # phat_phuck_tex1_albedo.png as albedo, tex2 standing in for the
    # stripped wood_normal.png bump map -- on a procedural mesh (the
    # phatphuck .obj itself is stripped from the mirror,
    # /root/reference/.MISSING_LARGE_BLOBS).
    ("phatphuck_proxy",
     os.path.join(REPO, "scenes", "cornell_phatphuck_proxy.json"), 32, 32, 1),
]


def render_film(path: str, w: int, h: int, spp: int) -> np.ndarray:
    from project3_cuda_path_tracer_2025_tpu.config import RenderConfig
    from project3_cuda_path_tracer_2025_tpu.models import Renderer
    from project3_cuda_path_tracer_2025_tpu.scene import load_scene
    from project3_cuda_path_tracer_2025_tpu.scene.loader import set_resolution

    scene = set_resolution(load_scene(path), w, h)
    r = Renderer(scene, RenderConfig(), seed=0)
    for _ in range(spp):
        r.step()
    film = r._flat_film()
    return np.stack(
        [np.asarray(film.x), np.asarray(film.y), np.asarray(film.z)], axis=1
    ).astype(np.float32)


def main():
    # --only NAME [NAME...]: regenerate a subset (e.g. newly added cases)
    # without rewriting untouched goldens.
    only = sys.argv[2:] if len(sys.argv) > 1 and sys.argv[1] == "--only" else None
    os.makedirs(GOLDEN_DIR, exist_ok=True)
    for name, path, w, h, spp in MATRIX:
        if only is not None and name not in only:
            continue
        film = render_film(path, w, h, spp)
        out = os.path.join(GOLDEN_DIR, f"{name}.npz")
        # Store the scene path (repo-relative via $REPO) so the test can
        # discover cases by globbing the goldens dir -- no duplicated matrix.
        portable = path.replace(REPO, "$REPO")
        np.savez_compressed(
            out, film=film, width=w, height=h, spp=spp, scene=portable
        )
        print(f"{name}: film [{film.shape[0]},3] sum={film.sum():.6f} -> {out}")


if __name__ == "__main__":
    main()
