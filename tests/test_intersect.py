"""Intersection engine tests: analytic primitives vs closed-form cases,
Moller-Trumbore, and BVH-vs-brute-force equivalence (the reference's
BVH_ACCELERATION A/B oracle)."""

import numpy as np
import pytest

import jax.numpy as jnp

from project3_cuda_path_tracer_2025_tpu.config import RenderConfig
from project3_cuda_path_tracer_2025_tpu.ops.intersect import (
    box_intersection,
    mesh_intersect_brute,
    mesh_intersect_bvh,
    sphere_intersection,
    triangle_intersection,
    intersect_scene,
)
from project3_cuda_path_tracer_2025_tpu.ops.rays import PathState
from project3_cuda_path_tracer_2025_tpu.scene.device import GeomConst, build_device_scene
from project3_cuda_path_tracer_2025_tpu.scene.types import (
    GeomType,
    HostScene,
    Material,
    empty_triangle_arrays,
)
from project3_cuda_path_tracer_2025_tpu.utils import mathutil
from project3_cuda_path_tracer_2025_tpu.utils.vec import Vec3

CFG = RenderConfig()


def _geom(gtype, trans=(0, 0, 0), rot=(0, 0, 0), scale=(1, 1, 1), mat=0):
    m = mathutil.build_transformation_matrix(trans, rot, scale)
    t = lambda a: tuple(tuple(float(x) for x in row) for row in a)
    return GeomConst(
        gtype=int(gtype),
        material_id=mat,
        transform=t(m),
        inverse=t(np.linalg.inv(m)),
        inv_transpose=t(mathutil.inverse_transpose(m)),
    )


def _rays(origins, dirs):
    o = np.atleast_2d(np.asarray(origins, np.float32))
    d = np.asarray(dirs, np.float32)
    d = np.atleast_2d(d / np.linalg.norm(d, axis=-1, keepdims=True))
    return Vec3(*[jnp.asarray(o[:, i]) for i in range(3)]), Vec3(
        *[jnp.asarray(d[:, i]) for i in range(3)]
    )


def test_sphere_basic():
    g = _geom(GeomType.SPHERE, scale=(2, 2, 2))  # radius 1
    ro, rd = _rays([[0, 0, 5]], [[0, 0, -1]])
    t, p, n = sphere_intersection(g, ro, rd, CFG.ray_advance_epsilon)
    assert t[0] == pytest.approx(4.0, abs=1e-3)
    np.testing.assert_allclose(
        [p.x[0], p.y[0], p.z[0]], [0, 0, 1], atol=1e-3
    )
    np.testing.assert_allclose([n.x[0], n.y[0], n.z[0]], [0, 0, 1], atol=1e-4)


def test_sphere_from_inside():
    g = _geom(GeomType.SPHERE, scale=(2, 2, 2))
    ro, rd = _rays([[0, 0, 0]], [[0, 0, -1]])
    t, p, n = sphere_intersection(g, ro, rd, CFG.ray_advance_epsilon)
    assert t[0] == pytest.approx(1.0, abs=1e-3)
    # raw normal points outward at the hit point (flip happens globally)
    assert n.z[0] == pytest.approx(-1.0, abs=1e-4)


def test_sphere_miss():
    g = _geom(GeomType.SPHERE)
    ro, rd = _rays([[0, 2, 5]], [[0, 0, -1]])
    t, _, _ = sphere_intersection(g, ro, rd, CFG.ray_advance_epsilon)
    assert t[0] == -1.0
    # behind the origin
    ro, rd = _rays([[0, 0, 5]], [[0, 0, 1]])
    t, _, _ = sphere_intersection(g, ro, rd, CFG.ray_advance_epsilon)
    assert t[0] == -1.0


def test_box_basic():
    g = _geom(GeomType.CUBE, scale=(2, 2, 2))  # half extent 1
    ro, rd = _rays([[0, 0, 5]], [[0, 0, -1]])
    t, p, n = box_intersection(g, ro, rd, CFG.ray_advance_epsilon)
    assert t[0] == pytest.approx(4.0, abs=1e-3)
    np.testing.assert_allclose([n.x[0], n.y[0], n.z[0]], [0, 0, 1], atol=1e-5)


def test_box_inside_hits_far_face():
    g = _geom(GeomType.CUBE, scale=(2, 2, 2))
    ro, rd = _rays([[0, 0, 0]], [[0, 0, -1]])
    t, p, n = box_intersection(g, ro, rd, CFG.ray_advance_epsilon)
    assert t[0] == pytest.approx(1.0, abs=1e-3)


def test_box_rotated():
    g = _geom(GeomType.CUBE, rot=(0, 45, 0), scale=(2, 2, 2))
    ro, rd = _rays([[0, 0, 5]], [[0, 0, -1]])
    t, p, n = box_intersection(g, ro, rd, CFG.ray_advance_epsilon)
    # rotated cube's corner toward +z at sqrt(2)
    assert t[0] == pytest.approx(5 - np.sqrt(2), abs=1e-3)


def test_triangle_mt():
    v0 = Vec3(*[jnp.asarray([x], jnp.float32) for x in (-1.0, -1.0, 0.0)])
    v1 = Vec3(*[jnp.asarray([x], jnp.float32) for x in (1.0, -1.0, 0.0)])
    v2 = Vec3(*[jnp.asarray([x], jnp.float32) for x in (0.0, 1.0, 0.0)])
    ro, rd = _rays([[0, -0.2, 3]], [[0, 0, -1]])
    hit, t, u, v = triangle_intersection(ro, rd, v0, v1, v2, CFG.baby_epsilon)
    assert bool(hit[0])
    assert t[0] == pytest.approx(3.0, abs=1e-5)
    # miss outside
    ro, rd = _rays([[2, 2, 3]], [[0, 0, -1]])
    hit, *_ = triangle_intersection(ro, rd, v0, v1, v2, CFG.baby_epsilon)
    assert not bool(hit[0])
    # parallel ray (det ~ 0)
    ro, rd = _rays([[0, 0, 1]], [[1, 0, 0]])
    hit, *_ = triangle_intersection(ro, rd, v0, v1, v2, CFG.baby_epsilon)
    assert not bool(hit[0])


def _random_mesh_scene(rng, n_tris=64):
    """HostScene with a random triangle soup in [-1,1]^3."""
    from project3_cuda_path_tracer_2025_tpu.scene.bvh import build_bvh
    from project3_cuda_path_tracer_2025_tpu.scene.types import Camera, RenderState

    centers = rng.uniform(-1, 1, (n_tris, 3))
    offsets = rng.uniform(-0.25, 0.25, (n_tris, 2, 3))
    pos = np.stack(
        [centers, centers + offsets[:, 0], centers + offsets[:, 1]], axis=1
    ).astype(np.float32)
    tri = empty_triangle_arrays()
    tri["tri_positions"] = pos
    tri["tri_normals"] = np.zeros_like(pos)
    tri["tri_uvs"] = np.zeros((n_tris, 3, 2), np.float32)
    tri["tri_material_ids"] = (np.arange(n_tris) % 3).astype(np.int32)
    tri["tri_centroids"] = pos.mean(axis=1)
    tri["tri_dpdu"] = np.zeros((n_tris, 3), np.float32)
    tri["tri_dpdv"] = np.zeros((n_tris, 3), np.float32)

    cam = Camera(
        resolution=np.asarray([4, 4]),
        position=np.zeros(3),
        look_at=np.asarray([0, 0, -1.0]),
        view=np.asarray([0, 0, -1.0]),
        up=np.asarray([0, 1.0, 0]),
        right=np.asarray([1.0, 0, 0]),
        fov=np.asarray([45.0, 45.0]),
        pixel_length=np.asarray([0.01, 0.01]),
        aperture=0.0,
        focal_dist=1.0,
    )
    scene = HostScene(
        state=RenderState(camera=cam, iterations=1, trace_depth=4, image_name="t"),
        materials=[Material(color=np.ones(3) * 0.5) for _ in range(3)],
        geoms=[],
        textures=[],
        **tri,
    )
    scene.bvh = build_bvh(pos, tri["tri_centroids"], leaf_size=4, use_native=False)
    return scene


def test_bvh_matches_brute_force():
    rng = np.random.default_rng(7)
    scene = _random_mesh_scene(rng, n_tris=96)
    dev, static = build_device_scene(scene)

    n_rays = 256
    origins = rng.normal(size=(n_rays, 3))
    origins = 3.0 * origins / np.linalg.norm(origins, axis=1, keepdims=True)
    targets = rng.uniform(-0.8, 0.8, (n_rays, 3))
    dirs = targets - origins
    ro, rd = _rays(origins, dirs)
    active = jnp.ones((n_rays,), bool)
    t_lim = jnp.full((n_rays,), 3.4e38, jnp.float32)

    bh = mesh_intersect_bvh(dev, static, ro, rd, active, t_lim, CFG.baby_epsilon)
    bf = mesh_intersect_brute(dev, static, ro, rd, active, t_lim, CFG.baby_epsilon)

    hit_b = np.asarray(bh.tri) >= 0
    hit_f = np.asarray(bf.tri) >= 0
    np.testing.assert_array_equal(hit_b, hit_f)
    assert hit_b.sum() > 20  # scene dense enough to be meaningful
    np.testing.assert_allclose(
        np.asarray(bh.t)[hit_b], np.asarray(bf.t)[hit_f], rtol=1e-6
    )
    # same triangle chosen (ties are measure-zero with random data)
    np.testing.assert_array_equal(np.asarray(bh.tri)[hit_b], np.asarray(bf.tri)[hit_f])


def test_intersect_scene_normal_faces_ray():
    scene_geoms = (_geom(GeomType.SPHERE, scale=(2, 2, 2), mat=0),)

    from project3_cuda_path_tracer_2025_tpu.scene.device import (
        BVHTable,
        DeviceScene,
        MaterialTable,
        SceneStatic,
        TextureTable,
        TriangleTable,
    )

    # Minimal scene: ray from inside the sphere; flipped normal must face it.
    scene = HostScene(
        state=None,
        materials=[Material(color=np.ones(3))],
        geoms=[],
        textures=[],
        **empty_triangle_arrays(),
    )
    from project3_cuda_path_tracer_2025_tpu.scene.types import Camera, RenderState

    scene.state = RenderState(
        camera=Camera(
            resolution=np.asarray([2, 2]),
            position=np.zeros(3),
            look_at=np.asarray([0, 0, -1.0]),
            view=np.asarray([0, 0, -1.0]),
            up=np.asarray([0, 1.0, 0]),
            right=np.asarray([1.0, 0, 0]),
            fov=np.asarray([45.0, 45.0]),
            pixel_length=np.asarray([0.01, 0.01]),
            aperture=0.0,
            focal_dist=1.0,
        ),
        iterations=1,
        trace_depth=2,
        image_name="t",
    )
    dev, static = build_device_scene(scene)
    static = static.__class__(**{**static.__dict__, "geoms": scene_geoms})

    ro, rd = _rays([[0, 0, 0], [0, 0, 5]], [[0, 0, -1], [0, 0, -1]])
    paths = PathState(
        origin=ro,
        direction=rd,
        color=Vec3.full((2,), 1, 1, 1),
        pixel=jnp.arange(2, dtype=jnp.int32),
        bounces=jnp.full((2,), 4, jnp.int32),
    )
    isect = intersect_scene(dev, static, paths, CFG)
    t = np.asarray(isect.t)
    assert t[0] == pytest.approx(1.0, abs=1e-3)  # inside hit
    assert t[1] == pytest.approx(4.0, abs=1e-3)  # outside hit
    # both normals face the incoming rays (dot(dir, n) < 0)
    nz = np.asarray(isect.normal.z)
    assert nz[0] > 0  # ray dir -z from inside -> normal +z
    assert nz[1] > 0


def test_octant_layouts_vectorized_matches_walk():
    """The levelized octant-layout builder must equal the per-octant DFS
    walker exactly (all 8 pre-orders, miss links, leaf records)."""
    from project3_cuda_path_tracer_2025_tpu.scene.bvh import (
        _build_octant_layouts_walk,
        build_bvh,
        build_octant_layouts,
    )

    rng = np.random.default_rng(11)
    centers = rng.uniform(-1, 1, (300, 3))
    offsets = rng.uniform(-0.2, 0.2, (300, 2, 3))
    pos = np.stack(
        [centers, centers + offsets[:, 0], centers + offsets[:, 1]], axis=1
    )
    bvh = build_bvh(pos, pos.mean(axis=1), leaf_size=4, use_native=False)
    a = build_octant_layouts(bvh)
    b = _build_octant_layouts_walk(bvh)
    for f in ("aabb_min", "aabb_max", "miss", "start", "count"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


@pytest.mark.parametrize(
    "name", ["cornell_mesh_5k.json", "cornell_mesh_5k_closed.json", "cornell_mesh_20k.json"]
)
def test_bvh_matches_brute_in_repo_meshes(repo_root, name):
    """The threaded-BVH walk finds the same nearest triangle as brute force
    on the in-repo meshes: camera rays plus rays fanned out from the middle
    of the room, with no prim t-limit."""
    import jax

    from project3_cuda_path_tracer_2025_tpu.ops.camera import generate_camera_rays
    from project3_cuda_path_tracer_2025_tpu.ops.intersect import FLT_MAX
    from project3_cuda_path_tracer_2025_tpu.scene import (
        camera_state, derive_render_camera, load_scene, set_resolution,
    )
    from project3_cuda_path_tracer_2025_tpu.utils import prng

    scene = set_resolution(load_scene(str(repo_root / "scenes" / name)), 16, 16)
    dev, static = build_device_scene(scene)
    cam = camera_state(derive_render_camera(scene.state.camera))
    n = static.pixel_count
    key = jax.random.PRNGKey(7)
    cam_rays = generate_camera_rays(
        cam, static.width, static.height, 1, prng.uniforms(key, n, 4)
    )
    d = np.array(jax.random.normal(key, (3, n)), np.float32)
    d /= np.linalg.norm(d, axis=0)
    ro = Vec3(*[jnp.concatenate([c, jnp.full((n,), v, jnp.float32)])
                for c, v in zip(cam_rays.origin, (0.0, 5.0, 0.0))])
    rd = Vec3(*[jnp.concatenate([c, jnp.asarray(v)])
                for c, v in zip(cam_rays.direction, d)])
    active = jnp.ones((2 * n,), bool)
    t_lim = jnp.full((2 * n,), FLT_MAX, jnp.float32)
    bh = mesh_intersect_bvh(dev, static, ro, rd, active, t_lim, CFG.baby_epsilon)
    bf = mesh_intersect_brute(dev, static, ro, rd, active, t_lim, CFG.baby_epsilon)
    tri_h, tri_f = np.asarray(bh.tri), np.asarray(bf.tri)
    assert (tri_f >= 0).sum() > n // 8  # the fan really reaches the mesh
    np.testing.assert_array_equal(tri_h, tri_f)
    hit = tri_f >= 0
    np.testing.assert_allclose(
        np.asarray(bh.t)[hit], np.asarray(bf.t)[hit], rtol=1e-5
    )
