"""Device scene: SoA jnp arrays + hashable static metadata.

The reference uploads its host vectors verbatim (AoS) in ``pathtraceInit``
(``src/pathtrace.cu:134-207``).  Here the upload step *restructures* for a vectorized walk:

* every vector quantity becomes a ``Vec3`` of flat ``[N]`` arrays,
* triangles are reordered into BVH-leaf order so each leaf's triangles are a
  contiguous run (kills one gather indirection during traversal),
* per-triangle normal fallback (reference checks per intersection,
  ``src/intersections.cu:202-207``) is resolved once at build time,
* textures become a single padded float32 stack with flat per-channel arrays
  for gather sampling,
* analytic primitives (handful per scene) are baked as *static* Python
  constants so their transforms constant-fold into the intersection kernels
  (no gathers, no memory traffic).

``DeviceScene`` is a pytree (jit-traceable); ``SceneStatic`` is frozen /
hashable and is closed over (static) by the compiled render functions.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Tuple

import jax.numpy as jnp
import numpy as np

from ..utils.vec import Vec3
from .textures import build_texture_stack
from .types import GeomType, HostScene


class GeomConst(NamedTuple):
    """One analytic primitive, fully static (nested float tuples hash)."""

    gtype: int  # GeomType value
    material_id: int
    transform: Tuple[Tuple[float, ...], ...]
    inverse: Tuple[Tuple[float, ...], ...]
    inv_transpose: Tuple[Tuple[float, ...], ...]


class MaterialConst(NamedTuple):
    """One material as static constants (for the whole-iteration prim
    kernel, where the whole table constant-folds into select chains)."""

    color: Tuple[float, float, float]
    emittance: float
    has_reflective: float
    has_refractive: float
    ior: float
    roughness: float
    metallic: float
    texture_id: int = -1
    bump_id: int = -1
    bump_scale: float = 0.0


@dataclass(frozen=True)
class SceneStatic:
    geoms: Tuple[GeomConst, ...]
    material_consts: Tuple[MaterialConst, ...]
    width: int
    height: int
    trace_depth: int
    iterations: int
    num_materials: int
    num_triangles: int
    num_nodes: int
    leaf_size: int
    num_textures: int
    tex_wmax: int
    tex_hmax: int
    image_name: str
    # Per-texture (width, height) as static ints: lets per-lane texture dims
    # resolve as constant select chains instead of device gathers.
    tex_dims: Tuple[Tuple[int, int], ...] = ()

    @property
    def has_triangles(self) -> bool:
        return self.num_triangles > 0

    @property
    def pixel_count(self) -> int:
        return self.width * self.height


class MaterialTable(NamedTuple):
    color: Vec3  # [M]
    emittance: jnp.ndarray
    has_reflective: jnp.ndarray
    has_refractive: jnp.ndarray
    ior: jnp.ndarray
    roughness: jnp.ndarray
    metallic: jnp.ndarray
    texture_id: jnp.ndarray  # i32, -1 = none
    bump_id: jnp.ndarray  # i32, -1 = none
    bump_scale: jnp.ndarray


class TriangleTable(NamedTuple):
    v0: Vec3
    v1: Vec3
    v2: Vec3
    n0: Vec3
    n1: Vec3
    n2: Vec3
    uv0u: jnp.ndarray
    uv0v: jnp.ndarray
    uv1u: jnp.ndarray
    uv1v: jnp.ndarray
    uv2u: jnp.ndarray
    uv2v: jnp.ndarray
    material_id: jnp.ndarray  # i32
    dpdu: Vec3
    dpdv: Vec3


class BVHTable(NamedTuple):
    """Packed, octant-ordered BVH for row-gather traversal.

    ``nodes``: [8*M, 16] float32 -- 8 direction-ordered threaded layouts
    (see ``scene.bvh.build_octant_layouts``); a ray walks the layout of its
    direction octant so subtrees are visited near-to-far and the closest-hit
    prune cuts the far side.  Row = one node record:
    cols 0-2 aabb_min, 3-5 aabb_max, 6 miss link, 7 leaf start, 8 leaf count
    (links/counts stored as exact small-integer floats so ONE f32 gather
    fetches the whole record -- per-field gathers cost ~10x more dispatches).

    ``tris``: [T, 12] float32 -- v0 (0-2), edge1 (3-5), edge2 (6-8) in
    BVH-leaf order, fetched as [N, leaf_size, 12] in a single gather.
    """

    nodes: jnp.ndarray  # [8*M, 16] f32
    tris: jnp.ndarray  # [T, 12] f32


class TextureTable(NamedTuple):
    """Padded texture stack as one RGBA row table.

    ``rgba``: [NT * Hmax * Wmax, 4] f32 -- one ROW per texel so a bilinear
    tap is a single row gather (4 row gathers per sample) instead of
    per-channel 1D gathers.

    ``grad``: [NT * Hmax * Wmax, 2] f32 -- per-texel wrapped forward
    differences of the height (red) channel: (h[y][x+1]-h[y][x],
    h[y-1][x]-h[y][x]).  Bilinear samples of these equal the reference's
    bump-map finite differences of bilinear height samples (distributivity
    of the shared interpolation weights), letting the hot path fetch bump
    gradients with ONE texel-quad gather instead of three height samples."""

    rgba: jnp.ndarray  # [NT * Hmax * Wmax, 4] f32
    grad: jnp.ndarray  # [NT * Hmax * Wmax, 2] f32
    width: jnp.ndarray  # [NT] i32
    height: jnp.ndarray  # [NT] i32
    # Packed hot-path rows: word0 = r | g<<8 | b<<16 (textures are forced
    # RGBA8, so u8 codes reconstruct the f32 stack exactly via /255);
    # word1 = (gdu*255+256) | (gdv*255+256)<<10 (grads are differences of
    # u8/255 heights, so *255 is integral to ~1e-5; reconstruction error
    # ~4e-8, far under the 2e-6 oracle gate).  8 B/texel-row instead of
    # 16+8 across two tables: when no material has distinct texture/bump
    # ids, albedo + bump gradients come from ONE texel-quad gather --
    # texel traffic is HBM-random-access bound, so bytes and row count
    # both halve (see ops.texture.sample_surface).
    packed: jnp.ndarray = None  # [NT * Hmax * Wmax, 2] i32


class DeviceScene(NamedTuple):
    materials: MaterialTable
    triangles: TriangleTable
    bvh: BVHTable
    textures: TextureTable


def _snap(x: float) -> float:
    """Snap rotation float-dust to exact constants so the trace-time
    constant folding in ``utils.vec`` triggers (cos(90 deg) in float64 is
    6.1e-17, not 0; the ~1e-16 relative change is far below f32 resolution)."""
    for target in (0.0, 1.0, -1.0):
        if abs(x - target) < 1e-12:
            return target
    return x


def _mat_tuple(m: np.ndarray) -> Tuple[Tuple[float, ...], ...]:
    return tuple(tuple(_snap(float(x)) for x in row) for row in np.asarray(m))


def _vec3_from(arr: np.ndarray) -> Vec3:
    a = jnp.asarray(np.ascontiguousarray(arr, np.float32))
    return Vec3(a[..., 0], a[..., 1], a[..., 2])


def build_device_scene(scene: HostScene) -> tuple[DeviceScene, SceneStatic]:
    geoms = tuple(
        GeomConst(
            gtype=int(g.type),
            material_id=int(g.material_id),
            transform=_mat_tuple(g.transform),
            inverse=_mat_tuple(g.inverse_transform),
            inv_transpose=_mat_tuple(g.inv_transpose),
        )
        for g in scene.geoms
    )

    # --- materials ------------------------------------------------------
    ms = scene.materials
    if not ms:
        raise ValueError("scene has no materials")
    color = np.stack([m.color for m in ms]).astype(np.float32)
    materials = MaterialTable(
        color=_vec3_from(color),
        emittance=jnp.asarray([m.emittance for m in ms], jnp.float32),
        has_reflective=jnp.asarray([m.has_reflective for m in ms], jnp.float32),
        has_refractive=jnp.asarray([m.has_refractive for m in ms], jnp.float32),
        ior=jnp.asarray([m.index_of_refraction for m in ms], jnp.float32),
        roughness=jnp.asarray([m.roughness for m in ms], jnp.float32),
        metallic=jnp.asarray([m.metallic for m in ms], jnp.float32),
        texture_id=jnp.asarray(
            [m.texture_id if m.has_texture else -1 for m in ms], jnp.int32
        ),
        bump_id=jnp.asarray(
            [m.bump_id if m.has_bump_map else -1 for m in ms], jnp.int32
        ),
        bump_scale=jnp.asarray([m.bump_scale for m in ms], jnp.float32),
    )

    # --- triangles (BVH-leaf order) --------------------------------------
    T = scene.num_triangles
    if T > 0:
        order = (
            scene.bvh.tri_indices.astype(np.int64)
            if scene.bvh is not None
            else np.arange(T)
        )
        pos = scene.tri_positions[order]
        nrm = scene.tri_normals[order].copy()
        uv = scene.tri_uvs[order]
        mat = scene.tri_material_ids[order]
        dpdu = scene.tri_dpdu[order]
        dpdv = scene.tri_dpdv[order]

        # Resolve the reference's per-intersection flat-normal fallback
        # (src/intersections.cu:202-207) once: if ANY vertex normal of a
        # triangle is ~zero, all three become the geometric normal.
        ln = np.linalg.norm(nrm, axis=-1)  # [T, 3]
        degenerate = (ln < 1e-6).any(axis=-1)
        if degenerate.any():
            e1 = pos[:, 1] - pos[:, 0]
            e2 = pos[:, 2] - pos[:, 0]
            gn = np.cross(e1, e2)
            gl = np.linalg.norm(gn, axis=-1, keepdims=True)
            gn = gn / np.maximum(gl, 1e-30)
            nrm[degenerate] = gn[degenerate][:, None, :]
    else:
        # One dummy degenerate triangle keeps all shapes non-empty; the
        # static ``has_triangles`` flag skips mesh code entirely.
        pos = np.zeros((1, 3, 3), np.float32)
        nrm = np.zeros((1, 3, 3), np.float32)
        nrm[:, :, 2] = 1.0
        uv = np.zeros((1, 3, 2), np.float32)
        mat = np.zeros((1,), np.int32)
        dpdu = np.zeros((1, 3), np.float32)
        dpdv = np.zeros((1, 3), np.float32)

    triangles = TriangleTable(
        v0=_vec3_from(pos[:, 0]),
        v1=_vec3_from(pos[:, 1]),
        v2=_vec3_from(pos[:, 2]),
        n0=_vec3_from(nrm[:, 0]),
        n1=_vec3_from(nrm[:, 1]),
        n2=_vec3_from(nrm[:, 2]),
        uv0u=jnp.asarray(uv[:, 0, 0]),
        uv0v=jnp.asarray(uv[:, 0, 1]),
        uv1u=jnp.asarray(uv[:, 1, 0]),
        uv1v=jnp.asarray(uv[:, 1, 1]),
        uv2u=jnp.asarray(uv[:, 2, 0]),
        uv2v=jnp.asarray(uv[:, 2, 1]),
        material_id=jnp.asarray(mat, jnp.int32),
        dpdu=_vec3_from(dpdu),
        dpdv=_vec3_from(dpdv),
    )

    # --- BVH --------------------------------------------------------------
    if scene.bvh is not None and T > 0:
        from .bvh import build_octant_layouts

        b = scene.bvh
        oct_b = build_octant_layouts(b)
        num_nodes = b.num_nodes
        leaf_size = b.leaf_size
        nodes = np.zeros((8, num_nodes, 16), np.float32)
        nodes[:, :, 0:3] = oct_b.aabb_min
        nodes[:, :, 3:6] = oct_b.aabb_max
        nodes[:, :, 6] = oct_b.miss.astype(np.float32)
        # Leaf `start` indexes tri_indices; triangles were reordered by that
        # permutation, so starts now index the triangle arrays directly.
        nodes[:, :, 7] = oct_b.start.astype(np.float32)
        nodes[:, :, 8] = oct_b.count.astype(np.float32)

        tris12 = np.zeros((T, 12), np.float32)
        tris12[:, 0:3] = pos[:, 0]
        tris12[:, 3:6] = pos[:, 1] - pos[:, 0]
        tris12[:, 6:9] = pos[:, 2] - pos[:, 0]
        bvh = BVHTable(
            nodes=jnp.asarray(nodes.reshape(8 * num_nodes, 16)),
            tris=jnp.asarray(tris12),
        )
    else:
        bvh = BVHTable(
            nodes=jnp.zeros((8, 16), jnp.float32),
            tris=jnp.zeros((1, 12), jnp.float32),
        )
        num_nodes = 0
        leaf_size = 4

    # --- textures ----------------------------------------------------------
    stack, wh = build_texture_stack(scene.textures)
    nt, hmax, wmax, _ = stack.shape
    grad = np.zeros((nt, hmax, wmax, 2), np.float32)
    for i in range(nt):
        w_i, h_i = int(wh[i, 0]), int(wh[i, 1])
        h_ch = stack[i, :h_i, :w_i, 0]
        grad[i, :h_i, :w_i, 0] = np.roll(h_ch, -1, axis=1) - h_ch
        grad[i, :h_i, :w_i, 1] = np.roll(h_ch, 1, axis=0) - h_ch
    u8 = np.clip(np.round(stack * 255.0), 0, 255).astype(np.uint32)
    word0 = u8[..., 0] | (u8[..., 1] << 8) | (u8[..., 2] << 16)
    gcode = (
        np.clip(np.round(grad * 255.0), -255, 255).astype(np.int32) + 256
    ).astype(np.uint32)
    word1 = gcode[..., 0] | (gcode[..., 1] << 10)
    packed = np.stack([word0, word1], axis=-1).view(np.int32)
    textures = TextureTable(
        rgba=jnp.asarray(stack.reshape(-1, 4)),
        grad=jnp.asarray(grad.reshape(-1, 2)),
        width=jnp.asarray(wh[:, 0], jnp.int32),
        height=jnp.asarray(wh[:, 1], jnp.int32),
        packed=jnp.asarray(packed.reshape(-1, 2)),
    )

    material_consts = tuple(
        MaterialConst(
            color=tuple(float(x) for x in m.color),
            emittance=float(m.emittance),
            has_reflective=float(m.has_reflective),
            has_refractive=float(m.has_refractive),
            ior=float(m.index_of_refraction),
            roughness=float(m.roughness),
            metallic=float(m.metallic),
            texture_id=int(m.texture_id) if m.has_texture else -1,
            bump_id=int(m.bump_id) if m.has_bump_map else -1,
            bump_scale=float(m.bump_scale),
        )
        for m in ms
    )

    static = SceneStatic(
        geoms=geoms,
        material_consts=material_consts,
        width=int(scene.state.camera.resolution[0]),
        height=int(scene.state.camera.resolution[1]),
        trace_depth=int(scene.state.trace_depth),
        iterations=int(scene.state.iterations),
        num_materials=len(ms),
        num_triangles=T,
        num_nodes=num_nodes,
        leaf_size=leaf_size,
        num_textures=len(scene.textures),
        tex_wmax=wmax,
        tex_hmax=hmax,
        image_name=scene.state.image_name,
        tex_dims=tuple((int(w), int(h)) for w, h in wh),
    )
    return (
        DeviceScene(materials, triangles, bvh, textures),
        static,
    )
