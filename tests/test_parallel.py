"""Multi-chip data parallelism over the virtual 8-device CPU mesh."""

import numpy as np
import pytest

import jax


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 (virtual) devices")
def test_sharded_iteration_runs_and_matches(scene_file):
    import jax.numpy as jnp

    from project3_cuda_path_tracer_2025_tpu.config import RenderConfig
    from project3_cuda_path_tracer_2025_tpu.models import Renderer
    from project3_cuda_path_tracer_2025_tpu.parallel.mesh import dryrun
    from project3_cuda_path_tracer_2025_tpu.scene import load_scene, set_resolution

    film, alive, mesh = dryrun(8, str(scene_file("cornell.json")), 32, 32)
    assert mesh.shape == {"rays": 8}
    counts = np.asarray(alive)
    assert counts[0] > 0 and counts[-1] == 0

    # Sharded result == single-device result (same RNG streams).
    s = set_resolution(load_scene(str(scene_file("cornell.json"))), 32, 32)
    r = Renderer(s, RenderConfig())
    r.step()
    single = np.stack(
        [np.asarray(r.film.x), np.asarray(r.film.y), np.asarray(r.film.z)], -1
    )
    sharded = np.stack(
        [np.asarray(film.x), np.asarray(film.y), np.asarray(film.z)], -1
    )
    np.testing.assert_allclose(sharded, single, atol=1e-6)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 (virtual) devices")
def test_sharded_mesh_mxu_matches(repo_root):
    """Mesh scene through the threaded-BVH walk under ray-axis sharding
    (XLA's automatic partitioner) == single-device (same RNG streams)."""
    from project3_cuda_path_tracer_2025_tpu.config import RenderConfig
    from project3_cuda_path_tracer_2025_tpu.models import Renderer
    from project3_cuda_path_tracer_2025_tpu.parallel.mesh import dryrun
    from project3_cuda_path_tracer_2025_tpu.scene import load_scene, set_resolution

    scene_path = str(repo_root / "scenes" / "cornell_mesh_5k.json")
    film, alive, mesh = dryrun(8, scene_path, 16, 16, mesh_intersector="threaded")
    assert np.asarray(alive)[0] > 0

    s = set_resolution(load_scene(scene_path), 16, 16)
    r = Renderer(s, RenderConfig(mesh_intersector="threaded"))
    r.step()
    single = np.stack(
        [np.asarray(r.film.x), np.asarray(r.film.y), np.asarray(r.film.z)], -1
    )
    sharded = np.stack(
        [np.asarray(film.x), np.asarray(film.y), np.asarray(film.z)], -1
    )
    np.testing.assert_allclose(sharded, single, atol=1e-6)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 (virtual) devices")
def test_sharded_wavefront_matches(scene_file):
    """Wavefront integrator (compaction permutations + scatter-add film)
    under sharding == single-device wavefront."""
    from project3_cuda_path_tracer_2025_tpu.config import RenderConfig
    from project3_cuda_path_tracer_2025_tpu.models import Renderer
    from project3_cuda_path_tracer_2025_tpu.parallel.mesh import dryrun
    from project3_cuda_path_tracer_2025_tpu.scene import load_scene, set_resolution

    film, alive, mesh = dryrun(
        8, str(scene_file("cornell.json")), 16, 16, integrator="wavefront"
    )
    s = set_resolution(load_scene(str(scene_file("cornell.json"))), 16, 16)
    r = Renderer(s, RenderConfig(integrator="wavefront"))
    r.step()
    single = np.stack(
        [np.asarray(r.film.x), np.asarray(r.film.y), np.asarray(r.film.z)], -1
    )
    sharded = np.stack(
        [np.asarray(film.x), np.asarray(film.y), np.asarray(film.z)], -1
    )
    np.testing.assert_allclose(sharded, single, atol=1e-6)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 (virtual) devices")
def test_film_is_actually_sharded(scene_file):
    from project3_cuda_path_tracer_2025_tpu.parallel.mesh import dryrun

    film, _, mesh = dryrun(8, str(scene_file("cornell.json")), 32, 32)
    sharding = film.x.sharding
    # one distinct shard per device along the ray axis
    assert len(sharding.device_set) == 8


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 (virtual) devices")
def test_shardmap_pixel_parallel_bitexact(scene_file):
    """Production multi-chip path (shard_map over the ray axis) ==
    single-chip, bit for bit: every RNG draw evaluates the global
    (pixel, depth) stream at local pixel ids (prng.uniforms_at)."""
    import numpy as np

    from project3_cuda_path_tracer_2025_tpu.config import RenderConfig
    from project3_cuda_path_tracer_2025_tpu.models import Renderer
    from project3_cuda_path_tracer_2025_tpu.scene import load_scene, set_resolution

    s = set_resolution(load_scene(str(scene_file("cornell.json"))), 32, 32)
    a = Renderer(s, RenderConfig())
    b = Renderer(s, RenderConfig(devices=8, parallel_mode="pixel"))
    for _ in range(2):
        a.step()
        b.step()
    np.testing.assert_array_equal(a.image(), b.image())
    np.testing.assert_array_equal(a._alive_counts, b._alive_counts)
    assert len(b.film.x.sharding.device_set) == 8


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 (virtual) devices")
def test_shardmap_sample_parallel(scene_file):
    """Sample-parallel mode: one 8-chip step == 8 single-chip iterations
    (same iteration keys; film rows summed at save)."""
    import numpy as np

    from project3_cuda_path_tracer_2025_tpu.config import RenderConfig
    from project3_cuda_path_tracer_2025_tpu.models import Renderer
    from project3_cuda_path_tracer_2025_tpu.scene import load_scene, set_resolution

    s = set_resolution(load_scene(str(scene_file("cornell.json"))), 16, 16)
    a = Renderer(s, RenderConfig())
    for _ in range(8):
        a.step()
    b = Renderer(s, RenderConfig(devices=8, parallel_mode="sample"))
    b.step()
    assert b.iteration == 8
    np.testing.assert_allclose(b.image(), a.image(), atol=1e-5)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 (virtual) devices")
def test_shardmap_fused_kernels_sharded(scene_file, repo_root):
    """With the whole-iteration prim kernel forced on, the multi-device
    step still runs the XLA megakernel per device inside shard_map (the
    kernel is a single-device specialization): prim and mesh scenes match
    the single-device megakernel bit for bit."""
    import numpy as np

    from project3_cuda_path_tracer_2025_tpu.config import RenderConfig
    from project3_cuda_path_tracer_2025_tpu.models import Renderer
    from project3_cuda_path_tracer_2025_tpu.scene import load_scene, set_resolution

    s = set_resolution(load_scene(str(scene_file("cornell.json"))), 16, 16)
    a = Renderer(s, RenderConfig(fused_bounce="off"))
    b = Renderer(s, RenderConfig(fused_bounce="on", devices=8))
    for _ in range(2):
        a.step()
        b.step()
    np.testing.assert_array_equal(a.image(), b.image())

    m = set_resolution(load_scene(str(repo_root / "scenes" / "cornell_mesh_5k.json")), 16, 16)
    m.state.trace_depth = 3
    c = Renderer(m, RenderConfig())
    d = Renderer(m, RenderConfig(devices=8))
    c.step()
    d.step()
    np.testing.assert_array_equal(c.image(), d.image())


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 (virtual) devices")
@pytest.mark.parametrize("traversal", ["streamed", "binned"])
def test_shardmap_heavy_traversals_sharded(repo_root, traversal):
    """Mesh walks under shard_map match the single-device image: the
    threaded BVH ("streamed") and the brute-force oracle ("binned" -- the
    per-device program with no acceleration structure)."""
    import numpy as np

    from project3_cuda_path_tracer_2025_tpu.config import RenderConfig
    from project3_cuda_path_tracer_2025_tpu.models import Renderer
    from project3_cuda_path_tracer_2025_tpu.scene import load_scene, set_resolution

    m = set_resolution(
        load_scene(str(repo_root / "scenes" / "cornell_mesh_5k.json")), 16, 16
    )
    m.state.trace_depth = 2
    kw = dict(
        mesh_intersector="threaded" if traversal == "streamed" else "brute"
    )
    a = Renderer(m, RenderConfig(**kw))
    b = Renderer(m, RenderConfig(devices=8, **kw))
    a.step()
    b.step()
    np.testing.assert_allclose(a.image(), b.image(), atol=1e-6)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 (virtual) devices")
def test_shardmap_wavefront_bitexact(scene_file):
    """Wavefront (compaction permutations + scatter-add film with local
    pixel bases) under shard_map == single chip, bitwise."""
    import numpy as np

    from project3_cuda_path_tracer_2025_tpu.config import RenderConfig
    from project3_cuda_path_tracer_2025_tpu.models import Renderer
    from project3_cuda_path_tracer_2025_tpu.scene import load_scene, set_resolution

    s = set_resolution(load_scene(str(scene_file("cornell.json"))), 16, 16)
    a = Renderer(s, RenderConfig(integrator="wavefront"))
    b = Renderer(s, RenderConfig(integrator="wavefront", devices=8))
    a.step()
    b.step()
    np.testing.assert_array_equal(a.image(), b.image())


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 (virtual) devices")
def test_shardmap_checkpoint_roundtrip(scene_file, tmp_path):
    """Checkpoints are flat [N] films; they restore into any device layout
    (single -> sample-parallel here) without changing the image."""
    import numpy as np

    from project3_cuda_path_tracer_2025_tpu.config import RenderConfig
    from project3_cuda_path_tracer_2025_tpu.models import Renderer
    from project3_cuda_path_tracer_2025_tpu.scene import load_scene, set_resolution

    s = set_resolution(load_scene(str(scene_file("cornell.json"))), 16, 16)
    a = Renderer(s, RenderConfig())
    a.step()
    ck = str(tmp_path / "c.npz")
    a.checkpoint(ck)
    b = Renderer(s, RenderConfig(devices=8, parallel_mode="sample"))
    b.restore(ck)
    np.testing.assert_array_equal(b.image(), a.image())
    b.step()  # resumes: samples 2..9
    assert b.iteration == 9
