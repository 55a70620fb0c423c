"""Golden-film regression tests: absolute behavior lock.

The bit-exactness matrix (test_integrators.py, test_fused.py) proves all
integrator/toggle combinations agree WITH EACH OTHER -- but a change that
shifts every path together (epsilon edits in ops/bsdf.py / config.py, BSDF
formula drift, RNG rekeying) would sail through it.  These tests compare
tiny fixed-seed CPU renders against films committed in tests/goldens/
(generated by scripts/gen_goldens.py), so any absolute behavior change
fails loudly and must be justified by regenerating the goldens in the same
commit.

Cases are DISCOVERED by globbing tests/goldens/*.npz; each golden carries
its own scene path (``scene`` key, ``$REPO``-relative) and render params,
so the generator's MATRIX is the single source of truth -- a regenerated
golden can never silently go uncompared.

Tolerance: the renders are deterministic on a fixed jax/XLA version; the
small allclose tolerance only absorbs cross-version fusion/rounding
differences.  Real regressions (the reference's own epsilon bug class,
reference ``README.md:377-394``) move many pixels by large amounts.
"""

import os
import pathlib

import numpy as np
import pytest

from project3_cuda_path_tracer_2025_tpu.config import RenderConfig
from project3_cuda_path_tracer_2025_tpu.models import Renderer
from project3_cuda_path_tracer_2025_tpu.scene import load_scene
from project3_cuda_path_tracer_2025_tpu.scene.loader import set_resolution

GOLDEN_DIR = pathlib.Path(__file__).parent / "goldens"
REPO = pathlib.Path(__file__).resolve().parent.parent

GOLDENS = sorted(GOLDEN_DIR.glob("*.npz"))


def test_goldens_exist():
    assert GOLDENS, (
        f"no goldens under {GOLDEN_DIR}; run scripts/gen_goldens.py and "
        "commit the result"
    )


@pytest.mark.parametrize(
    "golden_path", GOLDENS, ids=[p.stem for p in GOLDENS]
)
def test_golden_film(golden_path):
    g = np.load(golden_path)
    assert "scene" in g, (
        f"{golden_path} predates the self-describing format; regenerate "
        "with scripts/gen_goldens.py"
    )
    scene_path = str(g["scene"]).replace("$REPO", str(REPO))
    w, h, spp = int(g["width"]), int(g["height"]), int(g["spp"])
    if not os.path.exists(scene_path):
        pytest.skip(f"scene not available: {scene_path}")

    scene = set_resolution(load_scene(scene_path), w, h)
    r = Renderer(scene, RenderConfig(), seed=0)
    for _ in range(spp):
        r.step()
    film = r._flat_film()
    got = np.stack(
        [np.asarray(film.x), np.asarray(film.y), np.asarray(film.z)], axis=1
    ).astype(np.float32)

    want = g["film"]
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(
        got, want, rtol=2e-4, atol=2e-5,
        err_msg=(
            f"golden drift on {golden_path.stem}: if this change is "
            "INTENTIONAL, regenerate with scripts/gen_goldens.py and commit "
            "the new golden together with the justification"
        ),
    )
