"""Whole-iteration prim kernel (ops/fused.py) vs the XLA megakernel.

The kernel runs in Pallas interpret mode here; the compiled Triton kernel
is compared with the megakernel at 800x800 by ``chip_smoke.py`` on the card
and by the ``gpu``-marked test below.
"""

import numpy as np
import pytest

from project3_cuda_path_tracer_2025_tpu.config import RenderConfig
from project3_cuda_path_tracer_2025_tpu.models import Renderer
from project3_cuda_path_tracer_2025_tpu.ops import fused
from project3_cuda_path_tracer_2025_tpu.scene import load_scene, set_resolution

PRIM_SCENES = ["cornell.json", "cornell_dof.json", "cornell_transmissive_sphere.json"]


@pytest.fixture(scope="module")
def cornell_tiny(scene_file):
    return set_resolution(load_scene(str(scene_file("cornell.json"))), 20, 20)


def _assert_films_match(a, b):
    # Same RNG bits and identical termination; the kernel re-associates a
    # few float ops (FMA contraction), so the tolerance is a few ulp.
    np.testing.assert_allclose(a.image(), b.image(), atol=1e-5)
    np.testing.assert_array_equal(a._alive_counts, b._alive_counts)


def test_fused_matches_unfused(cornell_tiny):
    """400 rays: two 256-ray blocks, the second one padded."""
    a = Renderer(cornell_tiny, RenderConfig(fused_bounce="off"))
    b = Renderer(cornell_tiny, RenderConfig(fused_bounce="on"))
    for _ in range(2):
        a.step()
        b.step()
    _assert_films_match(a, b)


@pytest.mark.parametrize("name", PRIM_SCENES[1:])
def test_fused_matches_unfused_scenes(scene_file, name):
    """Every other in-repo prim scene (DoF aperture, transmissive lobe) at
    a pixel count that is not a multiple of the block size."""
    s = set_resolution(load_scene(str(scene_file(name))), 17, 15)
    s.state.trace_depth = 4
    a = Renderer(s, RenderConfig(fused_bounce="off"))
    b = Renderer(s, RenderConfig(fused_bounce="on"))
    for _ in range(2):
        a.step()
        b.step()
    _assert_films_match(a, b)


@pytest.mark.parametrize("block, num_warps", [(128, 4), (512, 8)])
def test_fused_block_size_invariant(scene_file, block, num_warps):
    """The block size and warp count are tuning only: the per-depth alive
    counts (reduced from per-block partials) are the same and the film
    agrees to an ulp (the interpreter vectorizes each block size apart)."""
    import jax
    import jax.numpy as jnp

    s = set_resolution(load_scene(str(scene_file("cornell.json"))), 20, 20)
    s.state.trace_depth = 3
    r = Renderer(s, RenderConfig(fused_bounce="off"))
    args = (r._cam_state, r.film, jnp.int32(1), r._base_key)
    ref_film, ref_alive = fused.fused_prim_iteration(
        r.static, r.cfg, *args, interpret=True
    )
    r.film = r._new_film()
    args = (r._cam_state, r.film, jnp.int32(1), r._base_key)
    film, alive = fused.fused_prim_iteration(
        r.static, r.cfg, *args, interpret=True, block=block,
        num_warps=num_warps,
    )
    for x, y in zip(jax.device_get(film), jax.device_get(ref_film)):
        np.testing.assert_allclose(x, y, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(alive), np.asarray(ref_alive))


def test_fused_applicability_gates(cornell_tiny, repo_root):
    from project3_cuda_path_tracer_2025_tpu.scene import build_device_scene

    _, static = build_device_scene(cornell_tiny)
    assert fused.fused_applicable(static, RenderConfig())
    assert not fused.fused_applicable(static, RenderConfig(shader="fake"))

    # Mesh scene -> has_triangles -> the fused prim kernel must gate off.
    mesh = load_scene(str(repo_root / "scenes" / "cornell_mesh_5k.json"))
    _, mesh_static = build_device_scene(set_resolution(mesh, 8, 8))
    assert mesh_static.has_triangles
    assert not fused.fused_applicable(mesh_static, RenderConfig())


def test_fused_auto_off_on_cpu(cornell_tiny):
    """auto must not select the (interpreted, slow) kernel on CPU."""
    import time

    r = Renderer(cornell_tiny, RenderConfig(fused_bounce="auto"))
    t0 = time.perf_counter()
    r.step()
    elapsed = time.perf_counter() - t0
    assert np.isfinite(r.image()).all()
    # The interpreted kernel compiles for tens of seconds; the jnp path
    # (compile included) stays far under 30s even on a loaded box.  This
    # catches "auto" accidentally selecting Pallas-interpret on CPU.
    assert elapsed < 30.0, f"auto path took {elapsed:.1f}s on CPU - interpreted kernel?"


def test_tier_sizes_unit():
    """Tier arithmetic: divisors round UP to 256-row units, degenerate and
    full-size tiers are dropped, duplicates collapse."""
    from project3_cuda_path_tracer_2025_tpu.models.wavefront import tier_sizes

    assert tier_sizes(1024, (4, 2)) == [256, 512]
    assert tier_sizes(1024, (2, 2, 4)) == [256, 512]
    assert tier_sizes(1000, (2,)) == [512]
    assert tier_sizes(256, (2,)) == []  # rounds up to n -> no tier
    assert tier_sizes(1024, ()) == []
    assert tier_sizes(1024, (1,)) == []  # n/1 == n -> no tier
    assert tier_sizes(640000, (8, 4, 2)) == [80128, 160000, 320000]


@pytest.mark.gpu
def test_fused_compiled_matches_megakernel(gpu_device, scene_file):
    """The compiled Triton kernel on the card vs the XLA megakernel (its
    bounce loop rolled: the same arithmetic at a fraction of the compile)."""
    s = set_resolution(load_scene(str(scene_file("cornell.json"))), 64, 48)
    a = Renderer(s, RenderConfig(fused_bounce="off", unroll_bounces=False))
    b = Renderer(s, RenderConfig(fused_bounce="on"))
    for _ in range(2):
        a.step()
        b.step()
    _assert_films_match(a, b)
