"""Intersection engine.

Parity targets:

* ``boxIntersectionTest`` (``src/intersections.cu:3-57``): slab test in
  object space (unit cube [-0.5, 0.5]^3), object-space direction normalized,
  returned t is the *world distance* |origin - hit point|, hit point advanced
  by the 1e-4 ray epsilon (``getPointOnRay``, ``src/intersections.h:29-32``).
* ``sphereIntersectionTest`` (``:59-109``): radius-0.5 unit sphere.
* ``intersectTriangle`` (``:112-145``): Moller-Trumbore with BABY_EPSILON
  cutoffs on determinant and t.
* ``computeIntersections`` (``src/pathtrace.cu:298-448``): nearest-hit
  resolution over analytic prims + mesh, final normal flip toward the ray.
* ``bvhMeshIntersectionTest`` (``src/intersections.cu:148-234``) -- but the
  per-thread 64-deep traversal stack becomes a *threaded* BVH walk: one
  monotonically increasing node cursor per ray (see ``scene/bvh.py``), with
  closest-hit pruning on AABB entry distance (a pure optimization: it never
  changes the nearest hit).

All functions are dense vector ops over [N] rays; analytic prims are unrolled
Python loops over static, constant-folded transforms.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import RenderConfig
from ..scene.device import DeviceScene, GeomConst, SceneStatic
from ..scene.types import GeomType
from ..utils import vec
from ..utils.vec import Vec3
from .rays import Intersections, PathState

FLT_MAX = 3.402823466e38  # Python float: safe to close over in Pallas kernels


def box_intersection(
    g: GeomConst, ro: Vec3, rd: Vec3, ray_eps: float
) -> tuple[jnp.ndarray, Vec3, Vec3]:
    """Returns (t_world [-1 = miss], world hit point, world normal)."""
    qo = vec.transform_point(g.inverse, ro)
    qd = vec.normalize(vec.transform_vector(g.inverse, rd))

    tmin = jnp.full_like(qo.x, -1e38)
    tmax = jnp.full_like(qo.x, 1e38)
    zero = jnp.zeros_like(qo.x)
    tmin_n = Vec3(zero, zero, zero)
    tmax_n = Vec3(zero, zero, zero)

    for axis in range(3):
        o = (qo.x, qo.y, qo.z)[axis]
        d = (qd.x, qd.y, qd.z)[axis]
        # Reference divides with no zero guard (src/intersections.cu:21-24);
        # IEEE inf/nan comparison semantics below match CUDA.  One reciprocal
        # replaces two divisions (VPU divides are the hot spot here).
        inv = 1.0 / d
        t1 = (-0.5 - o) * inv
        t2 = (0.5 - o) * inv
        ta = jnp.minimum(t1, t2)
        tb = jnp.maximum(t1, t2)
        sign = jnp.where(t2 < t1, 1.0, -1.0)
        n_axis = [zero, zero, zero]
        n_axis[axis] = sign
        n = Vec3(*n_axis)

        upd_min = (ta > 0) & (ta > tmin)
        tmin = jnp.where(upd_min, ta, tmin)
        tmin_n = vec.where(upd_min, n, tmin_n)
        upd_max = tb < tmax
        tmax = jnp.where(upd_max, tb, tmax)
        tmax_n = vec.where(upd_max, n, tmax_n)

    hit = (tmax >= tmin) & (tmax > 0)
    inside = tmin <= 0
    t_obj = jnp.where(inside, tmax, tmin)
    n_obj = vec.where(inside, tmax_n, tmin_n)

    p_obj = qo + qd * (t_obj - ray_eps)  # getPointOnRay
    p_world = vec.transform_point(g.transform, p_obj)
    normal = vec.normalize(vec.transform_vector(g.inv_transpose, n_obj))
    t_world = vec.length(ro - p_world)
    return jnp.where(hit, t_world, -1.0), p_world, normal


def sphere_intersection(
    g: GeomConst, ro: Vec3, rd: Vec3, ray_eps: float
) -> tuple[jnp.ndarray, Vec3, Vec3]:
    """Unit sphere (radius 0.5) in object space (src/intersections.cu:59-109)."""
    o = vec.transform_point(g.inverse, ro)
    d = vec.normalize(vec.transform_vector(g.inverse, rd))

    v_dot_d = vec.dot(o, d)
    radicand = v_dot_d * v_dot_d - (vec.dot(o, o) - 0.25)
    has_root = radicand >= 0

    sq = jnp.sqrt(jnp.maximum(radicand, 0.0))
    t1 = -v_dot_d + sq
    t2 = -v_dot_d - sq

    both_neg = (t1 < 0) & (t2 < 0)
    both_pos = (t1 > 0) & (t2 > 0)
    t_obj = jnp.where(both_pos, jnp.minimum(t1, t2), jnp.maximum(t1, t2))
    hit = has_root & ~both_neg

    p_obj = o + d * (t_obj - ray_eps)
    p_world = vec.transform_point(g.transform, p_obj)
    # Sphere normal: invTranspose * object-space point (not flipped here;
    # the global flip toward the ray happens in intersect_scene).
    normal = vec.normalize(vec.transform_vector(g.inv_transpose, p_obj))
    t_world = vec.length(ro - p_world)
    return jnp.where(hit, t_world, -1.0), p_world, normal


def triangle_intersection(
    ro: Vec3,
    rd: Vec3,
    v0: Vec3,
    v1: Vec3,
    v2: Vec3,
    baby_eps: float,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Moller-Trumbore; returns (hit mask, t, u, v)."""
    e1 = v1 - v0
    e2 = v2 - v0
    pvec = vec.cross(rd, e2)
    det = vec.dot(e1, pvec)
    det_ok = jnp.abs(det) >= baby_eps
    inv_det = 1.0 / jnp.where(det_ok, det, 1.0)

    tvec = ro - v0
    u = vec.dot(tvec, pvec) * inv_det
    qvec = vec.cross(tvec, e1)
    v = vec.dot(rd, qvec) * inv_det
    t = vec.dot(e2, qvec) * inv_det

    hit = (
        det_ok
        & (u >= 0.0)
        & (u <= 1.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > baby_eps)
    )
    return hit, t, u, v


class MeshHit(NamedTuple):
    t: jnp.ndarray  # best triangle t (FLT_MAX when none)
    tri: jnp.ndarray  # i32 best triangle index (-1 = none)
    u: jnp.ndarray
    v: jnp.ndarray


def mesh_intersect_bvh(
    dev: DeviceScene,
    static: SceneStatic,
    ro: Vec3,
    rd: Vec3,
    active: jnp.ndarray,
    t_limit: jnp.ndarray,
    baby_eps: float,
) -> MeshHit:
    """Threaded-BVH closest-hit over all rays (``bvh_walk`` without its
    step count)."""
    return bvh_walk(dev, static, ro, rd, active, t_limit, baby_eps)[0]


def bvh_walk(
    dev: DeviceScene,
    static: SceneStatic,
    ro: Vec3,
    rd: Vec3,
    active: jnp.ndarray,
    t_limit: jnp.ndarray,
    baby_eps: float,
) -> tuple[MeshHit, jnp.ndarray]:
    """Threaded-BVH closest-hit over all rays; returns (hit, loop steps).

    Traversal state per ray is one int32 node cursor that only moves forward
    in its direction octant's pre-order layout (near children first, see
    ``scene.bvh.build_octant_layouts``) -- no per-ray stack.  Each step does
    exactly TWO gathers: the packed 16-float node record and the leaf's
    [leaf_size, 12] triangle block; everything else is fusible elementwise
    math, keeping per-step dispatch cost flat.  Closest-hit pruning on AABB
    entry distance plus the ordered layout keeps the step count near the
    per-ray optimum; the loop exits when every ray's cursor reaches
    ``num_nodes``, so the loop step count is the slowest ray's.

    Semantics identical to ``bvhMeshIntersectionTest``
    (src/intersections.cu:148-234): same Moller-Trumbore epsilons, same
    closest-hit result (visit order only affects performance).
    """
    m = static.num_nodes
    n = ro.x.shape[0]
    k_leaf = static.leaf_size
    nodes = dev.bvh.nodes  # [8*M, 16]
    tris = dev.bvh.tris  # [T, 12]
    num_tris = static.num_triangles

    octant = (
        (rd.x < 0).astype(jnp.int32)
        + 2 * (rd.y < 0).astype(jnp.int32)
        + 4 * (rd.z < 0).astype(jnp.int32)
    )
    base = octant * m

    node0 = jnp.where(active, 0, m).astype(jnp.int32)
    best0 = MeshHit(
        t=t_limit.astype(jnp.float32),
        tri=jnp.full((n,), -1, jnp.int32),
        u=jnp.zeros((n,), jnp.float32),
        v=jnp.zeros((n,), jnp.float32),
    )

    inv_d = Vec3(1.0 / rd.x, 1.0 / rd.y, 1.0 / rd.z)
    karange = jnp.arange(k_leaf, dtype=jnp.int32)

    def cond(state):
        node, _, _ = state
        return jnp.any(node < m)

    def body(state):
        node, best, steps = state
        live = node < m
        nidx = jnp.clip(node, 0, m - 1)

        rec = nodes[base + nidx]  # [N, 16] single gather
        t1x = (rec[:, 0] - ro.x) * inv_d.x
        t1y = (rec[:, 1] - ro.y) * inv_d.y
        t1z = (rec[:, 2] - ro.z) * inv_d.z
        t2x = (rec[:, 3] - ro.x) * inv_d.x
        t2y = (rec[:, 4] - ro.y) * inv_d.y
        t2z = (rec[:, 5] - ro.z) * inv_d.z
        tlo = jnp.maximum(
            jnp.maximum(jnp.minimum(t1x, t2x), jnp.minimum(t1y, t2y)),
            jnp.minimum(t1z, t2z),
        )
        thi = jnp.minimum(
            jnp.minimum(jnp.maximum(t1x, t2x), jnp.maximum(t1y, t2y)),
            jnp.maximum(t1z, t2z),
        )
        # Entry-distance pruning vs current best t never changes the closest
        # hit; it only skips provably-farther subtrees.
        aabb_hit = (thi >= tlo) & (thi > 0.0) & (tlo < best.t)

        miss_link = rec[:, 6].astype(jnp.int32)
        start = rec[:, 7].astype(jnp.int32)
        count = rec[:, 8].astype(jnp.int32)
        is_leaf = count > 0
        do_leaf = live & aabb_hit & is_leaf

        # One gather for the whole leaf: [N, K, 12].
        tri_idx = jnp.clip(start[:, None] + karange[None, :], 0, num_tris - 1)
        blk = tris[tri_idx]
        v0 = blk[..., 0:3]
        e1 = blk[..., 3:6]
        e2 = blk[..., 6:9]
        d = jnp.stack([rd.x, rd.y, rd.z], -1)[:, None, :]  # [N, 1, 3]
        o = jnp.stack([ro.x, ro.y, ro.z], -1)[:, None, :]

        pvec = jnp.cross(d, e2)
        det = jnp.sum(e1 * pvec, -1)
        det_ok = jnp.abs(det) >= baby_eps
        inv_det = 1.0 / jnp.where(det_ok, det, 1.0)
        tvec = o - v0
        u = jnp.sum(tvec * pvec, -1) * inv_det
        qvec = jnp.cross(tvec, e1)
        v = jnp.sum(d * qvec, -1) * inv_det
        tt = jnp.sum(e2 * qvec, -1) * inv_det
        hit = (
            det_ok
            & (u >= 0.0)
            & (u <= 1.0)
            & (v >= 0.0)
            & (u + v <= 1.0)
            & (tt > baby_eps)
        )
        valid = do_leaf[:, None] & (karange[None, :] < count[:, None]) & hit
        ttm = jnp.where(valid & (tt > 0.0) & (tt < best.t[:, None]), tt, FLT_MAX)
        kbest = jnp.argmin(ttm, axis=1)
        cand_t = jnp.take_along_axis(ttm, kbest[:, None], 1)[:, 0]
        closer = cand_t < best.t
        sel = lambda a: jnp.take_along_axis(a, kbest[:, None], 1)[:, 0]
        best = MeshHit(
            t=jnp.where(closer, cand_t, best.t),
            tri=jnp.where(closer, sel(tri_idx), best.tri),
            u=jnp.where(closer, sel(u), best.u),
            v=jnp.where(closer, sel(v), best.v),
        )

        descend = live & aabb_hit & ~is_leaf
        nxt = jnp.where(descend, nidx + 1, miss_link)
        node = jnp.where(live, nxt, node)
        return node, best, steps + 1

    _, best, steps = jax.lax.while_loop(
        cond, body, (node0, best0, jnp.int32(0))
    )
    return best, steps


def mesh_intersect_brute(
    dev: DeviceScene,
    static: SceneStatic,
    ro: Vec3,
    rd: Vec3,
    active: jnp.ndarray,
    t_limit: jnp.ndarray,
    baby_eps: float,
) -> MeshHit:
    """Brute-force all-triangles sweep: the A/B oracle for BVH correctness
    (reference ``NAIVE_MESH_LOADING`` path, ``src/pathtrace.cu:365-395``).

    Triangles stream through the loop in packed [K, 9] blocks -- ONE
    contiguous ``dynamic_slice`` per step (no per-ray gathers), then K
    scalar-broadcast Moller-Trumbore tests unrolled inside the body so XLA
    fuses each block into a handful of [N]-wide elementwise kernels.
    Program size and memory are bounded by ceil(T/K) loop steps regardless
    of mesh size.
    Winner semantics are exactly the reference's sequential rule: strictly
    closer wins, so the lowest triangle index wins ties -- the unrolled
    in-order updates preserve this bit-for-bit."""
    n = ro.x.shape[0]
    t_cnt = static.num_triangles
    tris = dev.triangles
    best0 = MeshHit(
        t=t_limit.astype(jnp.float32),
        tri=jnp.full((n,), -1, jnp.int32),
        u=jnp.zeros((n,), jnp.float32),
        v=jnp.zeros((n,), jnp.float32),
    )

    K = 16
    t_pad = ((t_cnt + K - 1) // K) * K
    packed = jnp.stack(
        [
            tris.v0.x, tris.v0.y, tris.v0.z,
            tris.v1.x, tris.v1.y, tris.v1.z,
            tris.v2.x, tris.v2.y, tris.v2.z,
        ],
        axis=1,
    )  # [T, 9]
    packed = jnp.pad(packed, ((0, t_pad - t_cnt), (0, 0)))

    def body(j, best):
        blk = jax.lax.dynamic_slice_in_dim(packed, j * K, K)  # [K, 9]
        for k in range(K):
            row = blk[k]
            v0 = Vec3(row[0], row[1], row[2])
            v1 = Vec3(row[3], row[4], row[5])
            v2 = Vec3(row[6], row[7], row[8])
            hit, t, u, v = triangle_intersection(ro, rd, v0, v1, v2, baby_eps)
            idx = j * K + k
            ok = active & hit & (t > 0.0) & (t < best.t) & (idx < t_cnt)
            best = MeshHit(
                t=jnp.where(ok, t, best.t),
                tri=jnp.where(ok, idx, best.tri),
                u=jnp.where(ok, u, best.u),
                v=jnp.where(ok, v, best.v),
            )
        return best

    return jax.lax.fori_loop(0, t_pad // K, body, best0)


def intersect_scene(
    dev: DeviceScene,
    static: SceneStatic,
    paths: PathState,
    cfg: RenderConfig,
) -> Intersections:
    """Nearest-hit over analytic prims + mesh, with the reference's final
    normal flip toward the ray (``src/pathtrace.cu:423-446``)."""
    ro, rd = paths.origin, paths.direction
    shape = ro.x.shape  # shape-agnostic: [N] at top level, [block] in-kernel
    zero = jnp.zeros(shape, jnp.float32)

    t_min = jnp.full(shape, FLT_MAX)
    hit_any = jnp.zeros(shape, bool)
    normal = Vec3(zero, zero, zero)
    mat_id = jnp.full(shape, -1, jnp.int32)

    for g in static.geoms:
        if g.gtype == int(GeomType.CUBE):
            t, _, nrm = box_intersection(g, ro, rd, cfg.ray_advance_epsilon)
        else:
            t, _, nrm = sphere_intersection(g, ro, rd, cfg.ray_advance_epsilon)
        closer = (t > 0.0) & (t < t_min)
        t_min = jnp.where(closer, t, t_min)
        hit_any = hit_any | closer
        normal = vec.where(closer, nrm, normal)
        mat_id = jnp.where(closer, g.material_id, mat_id)

    is_tri = jnp.zeros(shape, bool)
    uv_u = zero
    uv_v = zero
    dpdu = Vec3(zero, zero, zero)
    dpdv = Vec3(zero, zero, zero)

    if static.has_triangles:
        active = paths.alive
        if cfg.resolved_mesh_intersector() == "threaded":
            mh = mesh_intersect_bvh(
                dev, static, ro, rd, active, t_min, cfg.baby_epsilon
            )
        else:
            mh = mesh_intersect_brute(
                dev, static, ro, rd, active, t_min, cfg.baby_epsilon
            )
        tri_hit = mh.tri >= 0

        w = 1.0 - mh.u - mh.v
        tidx = jnp.clip(mh.tri, 0, static.num_triangles - 1)
        tris = dev.triangles
        n0 = vec.select_gather(tris.n0, tidx)
        n1 = vec.select_gather(tris.n1, tidx)
        n2 = vec.select_gather(tris.n2, tidx)
        tri_uv_u = (
            tris.uv0u[tidx] * w + tris.uv1u[tidx] * mh.u + tris.uv2u[tidx] * mh.v
        )
        tri_uv_v = (
            tris.uv0v[tidx] * w + tris.uv1v[tidx] * mh.u + tris.uv2v[tidx] * mh.v
        )
        tri_dpdu = vec.select_gather(tris.dpdu, tidx)
        tri_dpdv = vec.select_gather(tris.dpdv, tidx)
        tri_mat = tris.material_id[tidx]

        tri_normal = vec.normalize(n0 * w + n1 * mh.u + n2 * mh.v)
        t_min = jnp.where(tri_hit, mh.t, t_min)
        hit_any = hit_any | tri_hit
        normal = vec.where(tri_hit, tri_normal, normal)
        mat_id = jnp.where(tri_hit, tri_mat, mat_id)
        is_tri = tri_hit
        uv_u = jnp.where(tri_hit, tri_uv_u, zero)
        uv_v = jnp.where(tri_hit, tri_uv_v, zero)
        dpdu = vec.where(tri_hit, tri_dpdu, dpdu)
        dpdv = vec.where(tri_hit, tri_dpdv, dpdv)

    # Flip normal to face the ray origin (src/pathtrace.cu:429-431).
    flip = vec.dot(rd, normal) > 0.0
    normal = vec.where(flip, -normal, normal)

    return Intersections(
        t=jnp.where(hit_any, t_min, -1.0),
        normal=normal,
        material_id=jnp.where(hit_any, mat_id, 0),
        uv_u=uv_u,
        uv_v=uv_v,
        dpdu=dpdu,
        dpdv=dpdv,
        is_triangle=is_tri,
    )
