"""Integrator equivalence and end-to-end render sanity.

The reference verifies its toggles by flipping #defines and eyeballing
(SURVEY.md section 4); here the A/B parity is exact: megakernel and wavefront
(with compaction/sorting on or off) must produce bit-identical films because
RNG streams are keyed by pixel, not lane.
"""

import numpy as np
import pytest

from project3_cuda_path_tracer_2025_tpu.config import RenderConfig
from project3_cuda_path_tracer_2025_tpu.models import Renderer
from project3_cuda_path_tracer_2025_tpu.scene import load_scene, set_resolution


@pytest.fixture(scope="module")
def cornell_small(scene_file):
    return set_resolution(load_scene(str(scene_file("cornell.json"))), 48, 48)


def _film(scene, cfg, spp=2, seed=0):
    r = Renderer(scene, cfg, seed=seed)
    for _ in range(spp):
        r.step()
    return r.image()


def test_megakernel_renders_sane(cornell_small):
    r = Renderer(cornell_small, RenderConfig())
    for _ in range(8):
        r.step()
    img = r.image_normalized()
    assert np.isfinite(img).all()
    assert img.mean() > 0.05  # lit scene
    assert img.max() > 1.0  # light source overshoots before clamping
    # red wall on the +x image side pre-mirror (see SURVEY C13)
    left = img[:, :8].mean(axis=(0, 1))
    right = img[:, -8:].mean(axis=(0, 1))
    assert left[1] > left[0]  # green side
    assert right[0] > right[1]  # red side
    # termination telemetry decays monotonically
    alive = r._alive_counts
    assert (np.diff(alive) <= 0).all()
    assert alive[-1] == 0  # depth exhausted


def test_wavefront_matches_megakernel_bitexact(cornell_small):
    base = _film(cornell_small, RenderConfig(integrator="megakernel"))
    # (compaction, material sort, prefix tiers): tiers engage at 48x48=2304
    # rays (n/2 -> 1280-row tier) once the population decays.
    for sc, ms, tiers in (
        (True, True, ()),
        (False, False, ()),
        ("adaptive", False, ()),
        (True, False, (4, 2)),
        ("adaptive", False, (4, 2)),
        (True, True, (4, 2)),  # material sort inside the tier head
    ):
        wf = _film(
            cornell_small,
            RenderConfig(
                integrator="wavefront",
                stream_compaction=sc,
                material_sorting=ms,
                bounce_prefix_tiers=tiers,
            ),
        )
        np.testing.assert_array_equal(
            wf, base, err_msg=f"compaction={sc} sorting={ms} tiers={tiers}"
        )


def test_seeds_decorrelate(cornell_small):
    a = _film(cornell_small, RenderConfig(), seed=0)
    b = _film(cornell_small, RenderConfig(), seed=1)
    assert not np.array_equal(a, b)
    # but statistics agree
    assert abs(a.mean() - b.mean()) / a.mean() < 0.05


def test_iterations_accumulate(cornell_small):
    r = Renderer(cornell_small, RenderConfig())
    r.step()
    one = r.image()
    r.step()
    two = r.image()
    assert two.mean() > one.mean() * 1.5  # film accumulates, not averages


def test_checkpoint_resume(cornell_small, tmp_path):
    r1 = Renderer(cornell_small, RenderConfig(), seed=3)
    for _ in range(3):
        r1.step()
    ck = str(tmp_path / "ck.npz")
    r1.checkpoint(ck)
    r1.step()

    r2 = Renderer(cornell_small, RenderConfig(), seed=99)
    r2.restore(ck)
    assert r2.iteration == 3
    r2.step()
    np.testing.assert_array_equal(r1.image(), r2.image())


def test_orbit_resets_accumulation(cornell_small):
    r = Renderer(cornell_small, RenderConfig())
    r.step()
    assert r.iteration == 1
    r.orbit_camera(dzoom=-1.0)
    assert r.iteration == 0
    assert r.image().sum() == 0.0


def test_glass_scene_renders(scene_file):
    scene = set_resolution(load_scene(str(scene_file("cornell_glass_test.json"))), 32, 32)
    r = Renderer(scene, RenderConfig())
    for _ in range(4):
        r.step()
    img = r.image_normalized()
    assert np.isfinite(img).all()
    assert img.mean() > 0.01


def test_microfacet_scene_renders(scene_file):
    scene = set_resolution(
        load_scene(str(scene_file("cornell_microfacet_test.json"))), 32, 32
    )
    r = Renderer(scene, RenderConfig())
    for _ in range(4):
        r.step()
    img = r.image_normalized()
    assert np.isfinite(img).all()
    assert img.mean() > 0.01


def test_mesh_scene_bvh_vs_brute_force(tmp_path):
    """BVH on/off must not change the image (reference A/B toggle)."""
    import json

    obj = tmp_path / "tetra.obj"
    obj.write_text(
        "v 0 0 0\nv 1 0 0\nv 0 1 0\nv 0 0 1\n"
        "f 1 3 2\nf 1 2 4\nf 1 4 3\nf 2 3 4\n"
    )
    scene_file = tmp_path / "scene.json"
    json.dump(
        {
            "Materials": {
                "light": {"TYPE": "Emitting", "RGB": [1, 1, 1], "EMITTANCE": 5.0},
                "white": {"TYPE": "Diffuse", "RGB": [0.9, 0.9, 0.9]},
            },
            "Camera": {
                "RES": [32, 32],
                "FOVY": 30.0,
                "ITERATIONS": 4,
                "DEPTH": 4,
                "FILE": "tetra",
                "EYE": [0.3, 0.4, 4.0],
                "LOOKAT": [0.3, 0.3, 0.0],
                "UP": [0, 1, 0],
                "APERTURE": 0.0,
            },
            "Objects": [
                {
                    "TYPE": "obj",
                    "PATH": "tetra.obj",
                    "MATERIAL": "white",
                    "TRANS": [0, 0, 0],
                    "ROTAT": [20, 30, 10],
                    "SCALE": [1, 1, 1],
                },
                {
                    "TYPE": "cube",
                    "MATERIAL": "light",
                    "TRANS": [0, 3, 0],
                    "ROTAT": [0, 0, 0],
                    "SCALE": [2, 0.2, 2],
                },
            ],
        },
        scene_file.open("w"),
    )
    scene = load_scene(str(scene_file))
    assert scene.num_triangles == 4
    a = _film(scene, RenderConfig(bvh_acceleration=True), spp=3)
    b = _film(scene, RenderConfig(bvh_acceleration=False), spp=3)
    # Same hits/BSDF math; tolerance covers XLA re-association between the
    # two differently-fused programs (observed <= 1 ulp).
    np.testing.assert_allclose(a, b, atol=1e-5)
    assert a.mean() > 0.001
