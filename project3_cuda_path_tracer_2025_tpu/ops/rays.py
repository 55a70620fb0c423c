"""Wavefront path state (SoA pytrees).

Counterparts of ``PathSegment`` (``src/sceneStructs.h:128-134``)
and ``ShadeableIntersection`` (``:147-157``): every field is a flat ``[N]``
array (``Vec3`` = three ``[N]`` arrays), N = W*H path slots that persist for
the whole iteration (termination is the ``bounces`` mask, not a shrinking
buffer).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from ..utils.vec import Vec3


class PathState(NamedTuple):
    origin: Vec3  # ray.origin
    direction: Vec3  # ray.direction (kept normalized)
    color: Vec3  # throughput, starts at (1,1,1)
    pixel: jnp.ndarray  # i32 pixel index (identity unless permuted)
    bounces: jnp.ndarray  # i32 remainingBounces; 0 = terminated

    @property
    def n(self) -> int:
        return self.pixel.shape[-1]

    @property
    def alive(self) -> jnp.ndarray:
        return self.bounces > 0


class Intersections(NamedTuple):
    t: jnp.ndarray  # f32; -1 = miss (reference convention)
    normal: Vec3  # surface normal, flipped toward the ray origin
    material_id: jnp.ndarray  # i32
    uv_u: jnp.ndarray  # f32 (0 for analytic prims)
    uv_v: jnp.ndarray
    dpdu: Vec3  # triangle tangent frame (0 for prims)
    dpdv: Vec3
    is_triangle: jnp.ndarray  # bool


def empty_intersections(n: int) -> Intersections:
    z = jnp.zeros((n,), jnp.float32)
    return Intersections(
        t=jnp.full((n,), -1.0, jnp.float32),
        normal=Vec3(z, z, z),
        material_id=jnp.zeros((n,), jnp.int32),
        uv_u=z,
        uv_v=z,
        dpdu=Vec3(z, z, z),
        dpdv=Vec3(z, z, z),
        is_triangle=jnp.zeros((n,), bool),
    )
