"""Chunked dispatch (config.pixel_chunks): C sequential same-program
launches over pixel blocks == one launch (pixel-keyed RNG).  The
megakernel paths match bit-for-bit; the wavefront shard program fuses FMA
contraction differently than the full-frame program, so it matches to the
repo's standard 1e-6 fusion tolerance (same class as the shard_map tests).
Exists to bound the per-program ray count of a configuration that needs
it, such as the brute-force A/B at full resolution."""

import numpy as np
import pytest

from project3_cuda_path_tracer_2025_tpu.config import RenderConfig
from project3_cuda_path_tracer_2025_tpu.models import Renderer
from project3_cuda_path_tracer_2025_tpu.scene import load_scene, set_resolution


@pytest.mark.parametrize(
    "kw",
    [
        dict(bvh_acceleration=False),
        dict(integrator="wavefront"),
        dict(mesh_intersector="threaded"),
    ],
    ids=["brute", "wavefront", "threaded-bvh"],
)
def test_pixel_chunks_bitexact(repo_root, kw):
    mesh = "mesh_intersector" in kw or not kw.get("bvh_acceleration", True)
    scene_path = str(
        repo_root / "scenes" / ("cornell_mesh_5k.json" if mesh else "cornell.json")
    )
    s = set_resolution(load_scene(scene_path), 16, 16)
    s.state.trace_depth = 2
    a = Renderer(s, RenderConfig(**kw))
    b = Renderer(s, RenderConfig(pixel_chunks=4, **kw))
    a.step()
    b.step()
    np.testing.assert_allclose(a.image(), b.image(), atol=1e-6, rtol=0)
    # step_many in chunked mode loops host-side; identity must survive it
    a.step_many(2)
    b.step_many(2)
    np.testing.assert_allclose(a.image(), b.image(), atol=1e-6, rtol=0)


def test_pixel_chunks_must_divide(repo_root):
    s = set_resolution(load_scene(str(repo_root / "scenes" / "cornell.json")), 10, 10)
    with pytest.raises(ValueError, match="divide"):
        Renderer(s, RenderConfig(pixel_chunks=3))


def test_pixel_chunks_auto_resolution(repo_root):
    """No automatic chunking: the default is one program per iteration on
    every platform, and an explicit chunk count is taken as given."""
    assert RenderConfig().pixel_chunks == 1
    assert RenderConfig(bvh_acceleration=False).pixel_chunks == 1
    s = set_resolution(load_scene(str(repo_root / "scenes" / "cornell.json")), 8, 8)
    assert Renderer(s, RenderConfig(bvh_acceleration=False))._pixel_chunks == 1
    assert Renderer(s, RenderConfig(pixel_chunks=4))._pixel_chunks == 4
