"""SoA 3-vector math.

The reference stores ``glm::vec3`` AoS throughout.  Here a 3-vector field
over N rays is a pytree of three flat ``[N]`` arrays, so every access is
contiguous.  All operations below are elementwise over the component arrays;
XLA fuses chains of them into single loops over device memory.

Component arrays can be any broadcastable shape (scalars work too), which
keeps the same code usable for single vectors and ray batches.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class Vec3(NamedTuple):
    """Structure-of-arrays 3-vector: three same-shape arrays (or scalars)."""

    x: jax.Array
    y: jax.Array
    z: jax.Array

    # -- construction -----------------------------------------------------
    @staticmethod
    def full(shape, vx, vy, vz, dtype=jnp.float32) -> "Vec3":
        return Vec3(
            jnp.full(shape, vx, dtype),
            jnp.full(shape, vy, dtype),
            jnp.full(shape, vz, dtype),
        )

    @staticmethod
    def zeros(shape, dtype=jnp.float32) -> "Vec3":
        # Three distinct buffers: callers may donate a Vec3 (e.g. the film),
        # and XLA rejects donating the same buffer twice.
        return Vec3(
            jnp.zeros(shape, dtype), jnp.zeros(shape, dtype), jnp.zeros(shape, dtype)
        )

    @staticmethod
    def from_scalar(vx, vy, vz, dtype=jnp.float32) -> "Vec3":
        return Vec3(
            jnp.asarray(vx, dtype), jnp.asarray(vy, dtype), jnp.asarray(vz, dtype)
        )

    @staticmethod
    def from_array(a) -> "Vec3":
        """From an array whose last axis is 3."""
        a = jnp.asarray(a)
        return Vec3(a[..., 0], a[..., 1], a[..., 2])

    def to_array(self) -> jax.Array:
        return jnp.stack([self.x, self.y, self.z], axis=-1)

    # -- arithmetic --------------------------------------------------------
    def __add__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)
        return Vec3(self.x + o, self.y + o, self.z + o)

    __radd__ = __add__

    def __sub__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)
        return Vec3(self.x - o, self.y - o, self.z - o)

    def __rsub__(self, o):
        return Vec3(o - self.x, o - self.y, o - self.z)

    def __mul__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x * o.x, self.y * o.y, self.z * o.z)
        return Vec3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x / o.x, self.y / o.y, self.z / o.z)
        return Vec3(self.x / o, self.y / o, self.z / o)

    def __neg__(self):
        return Vec3(-self.x, -self.y, -self.z)


def dot(a: Vec3, b: Vec3) -> jax.Array:
    return a.x * b.x + a.y * b.y + a.z * b.z


def cross(a: Vec3, b: Vec3) -> Vec3:
    return Vec3(
        a.y * b.z - a.z * b.y,
        a.z * b.x - a.x * b.z,
        a.x * b.y - a.y * b.x,
    )


def length(a: Vec3) -> jax.Array:
    return jnp.sqrt(dot(a, a))


def length2(a: Vec3) -> jax.Array:
    return dot(a, a)


def normalize(a: Vec3) -> Vec3:
    """glm::normalize semantics: no epsilon guard (0-vector -> nan/inf)."""
    inv = jax.lax.rsqrt(dot(a, a))
    return Vec3(a.x * inv, a.y * inv, a.z * inv)


def reflect(i: Vec3, n: Vec3) -> Vec3:
    """glm::reflect: I - 2*dot(N, I)*N."""
    d = dot(n, i)
    return i - n * (2.0 * d)


def refract(i: Vec3, n: Vec3, eta) -> Vec3:
    """glm::refract semantics: returns the zero vector on total internal
    reflection (k < 0), matching the TIR sentinel the reference relies on
    (``src/interactions.cu:159-165``)."""
    cosi = dot(n, i)
    k = 1.0 - eta * eta * (1.0 - cosi * cosi)
    tir = k < 0.0
    kc = jnp.sqrt(jnp.maximum(k, 0.0))
    out = i * eta - n * (eta * cosi + kc)
    zero = jnp.zeros_like(out.x)
    return Vec3(
        jnp.where(tir, zero, out.x),
        jnp.where(tir, zero, out.y),
        jnp.where(tir, zero, out.z),
    )


def where(mask, a: Vec3, b: Vec3) -> Vec3:
    return Vec3(
        jnp.where(mask, a.x, b.x),
        jnp.where(mask, a.y, b.y),
        jnp.where(mask, a.z, b.z),
    )


def select_gather(v: Vec3, idx) -> Vec3:
    """Gather lanes: v[idx] per component."""
    return Vec3(v.x[idx], v.y[idx], v.z[idx])


def clamp(v: Vec3, lo, hi) -> Vec3:
    return Vec3(
        jnp.clip(v.x, lo, hi), jnp.clip(v.y, lo, hi), jnp.clip(v.z, lo, hi)
    )


def lerp(a: Vec3, b: Vec3, t) -> Vec3:
    """glm::mix(a, b, t)."""
    return a + (b - a) * t


def max_component(v: Vec3) -> jax.Array:
    return jnp.maximum(v.x, jnp.maximum(v.y, v.z))


def _row_dot(coeffs, terms, bias=None):
    """sum(c * t) with TRACE-TIME folding of Python-float constants:
    0.0-coefficient terms vanish, 1.0 passes through, a 0.0 bias is dropped.

    Scene transforms are baked as Python floats (see ``scene.device``), and
    axis-aligned instances -- most of a cornell box -- have mostly-zero
    rotation rows, so this removes the majority of the per-primitive FLOPs.
    Exactness: adding a +0.0 term cannot change a finite result, so folded
    and unfolded paths agree bitwise on finite inputs.
    """
    acc = None
    for c, t in zip(coeffs, terms):
        if isinstance(c, (int, float)):
            if c == 0.0:
                continue
            term = t if c == 1.0 else (-t if c == -1.0 else c * t)
        else:
            term = c * t
        acc = term if acc is None else acc + term
    if bias is not None and not (isinstance(bias, (int, float)) and bias == 0.0):
        acc = bias if acc is None else acc + bias
    if acc is None:
        import jax.numpy as _jnp

        acc = _jnp.zeros_like(terms[0])
    return acc


def transform_point(m, p: Vec3) -> Vec3:
    """Apply a 4x4 row-major matrix (numpy constants or jnp [4,4]) to a point.

    Matches ``multiplyMV(m, vec4(p, 1))`` (``src/intersections.h:37-40``).
    ``m`` is indexed ``m[row][col]`` in the mathematical convention
    (column-vector on the right), i.e. m @ [x y z 1]^T.
    """
    xyz = (p.x, p.y, p.z)
    return Vec3(
        _row_dot(m[0][:3], xyz, m[0][3]),
        _row_dot(m[1][:3], xyz, m[1][3]),
        _row_dot(m[2][:3], xyz, m[2][3]),
    )


def transform_vector(m, v: Vec3) -> Vec3:
    """Apply a 4x4 matrix to a direction (w = 0): multiplyMV(m, vec4(v, 0))."""
    xyz = (v.x, v.y, v.z)
    return Vec3(
        _row_dot(m[0][:3], xyz),
        _row_dot(m[1][:3], xyz),
        _row_dot(m[2][:3], xyz),
    )
