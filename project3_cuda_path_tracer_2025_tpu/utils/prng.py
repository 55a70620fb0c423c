"""Counter-based RNG for path tracing.

The reference seeds a minstd LCG per (iteration, pixel, depth) via
``makeSeededRandomEngine`` (``src/pathtrace.cu:51-56``).  Here we use JAX's
counter-based threefry: a base key folded with (iteration, depth, stage)
produces a key whose per-lane draws are implicitly indexed by pixel, giving an
independent, reproducible stream per (iter, pixel, depth) with equivalent
statistics (bit-identity with the CUDA LCG is neither possible nor required --
acceptance is statistical RMSE at high spp, see BASELINE.md).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def iteration_key(base_key: jax.Array, iteration: jax.Array) -> jax.Array:
    """Key for one full spp iteration."""
    return jax.random.fold_in(base_key, iteration)


def stage_key(iter_key: jax.Array, depth, stage: int) -> jax.Array:
    """Key for one kernel stage at one bounce depth.

    ``stage`` disambiguates multiple consumers at the same depth
    (0 = camera raygen, 1 = shading).
    """
    return jax.random.fold_in(jax.random.fold_in(iter_key, depth), stage)


def uniforms(key: jax.Array, n: int, k: int) -> jax.Array:
    """Draw ``k`` independent U[0,1) arrays of shape [n] -> returns [k, n].

    [k, n] rather than [n, k] so each draw is a contiguous lanes-major row.
    """
    return jax.random.uniform(key, (k, n), dtype=jnp.float32)


def _threefry_bits_at(key: jax.Array, flat: jnp.ndarray) -> jnp.ndarray:
    """uint32 random bits at explicit flat counter positions -- bit-identical
    to ``jax.random.uniform(key, shape)``'s bits at the same flat indices
    (partitionable threefry: the 64-bit counter IS the flat index, so bits
    are a pure elementwise function of it; asserted in tests/test_prng.py).
    """
    from jax._src import prng as _jprng

    # The counter reconstruction below assumes the partitionable-threefry
    # layout (64-bit counter == flat index).  Under the legacy layout the
    # bits would be valid-but-DIFFERENT from uniforms(), silently breaking
    # the cross-integrator bit-identity invariant -- fail loudly instead.
    if not jax.config.jax_threefry_partitionable:
        raise RuntimeError(
            "uniforms_at requires jax_threefry_partitionable=True (the "
            "default in modern jax); enable it with "
            "jax.config.update('jax_threefry_partitionable', True)."
        )
    kd = jax.random.key_data(key)
    b1, b2 = _jprng.threefry2x32_p.bind(
        kd[0], kd[1], jnp.zeros_like(flat), flat
    )
    return b1 ^ b2


def threefry_bits_inline(k0, k1, flat) -> jnp.ndarray:
    """``_threefry_bits_at`` as inlineable uint32 vector ops.

    Pallas kernels cannot lower the ``threefry2x32_p`` primitive, so a
    kernel that draws its own per-pixel uniforms (``ops/fused.py``) needs
    the hash spelled out: the standard Threefry-2x32 schedule (5 x 4
    rounds, rotations (13,15,26,6)/(17,29,16,24), key
    injections every 4 rounds), applied at counter ``(0, flat)`` --
    bit-identical to jax's lowering of the primitive (asserted in
    tests/test_prng.py).  ``k0``/``k1`` may be scalars or broadcastable
    arrays; all arithmetic wraps in uint32."""
    k0 = k0.astype(jnp.uint32)
    k1 = k1.astype(jnp.uint32)
    flat = flat.astype(jnp.uint32)
    ks2 = k0 ^ k1 ^ jnp.uint32(0x1BD11BDA)
    ks = (k0, k1, ks2)
    rot = ((13, 15, 26, 6), (17, 29, 16, 24))

    x0 = jnp.zeros_like(flat) + ks[0]  # counter hi word is 0
    x1 = flat + ks[1]
    for i in range(5):
        for r in rot[i % 2]:
            x0 = x0 + x1
            x1 = (x1 << jnp.uint32(r)) | (x1 >> jnp.uint32(32 - r))
            x1 = x1 ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + jnp.uint32(i + 1)
    return x0 ^ x1


def bits_to_uniform(bits: jnp.ndarray) -> jnp.ndarray:
    """uint32 random bits -> U[0,1) f32, exactly as ``uniforms_at``."""
    u = jax.lax.bitcast_convert_type(
        (bits >> jnp.uint32(9)) | jnp.uint32(0x3F800000), jnp.float32
    ) - 1.0
    return jnp.maximum(0.0, u)


def uniforms_at(key: jax.Array, idx: jnp.ndarray, k: int, n: int) -> jax.Array:
    """The rows ``uniforms(key, n, k)[:, idx]`` WITHOUT the gather.

    Counter-based threefry makes each draw a pure elementwise function of its
    flat counter ``j * n + idx``, so a permuted integrator (wavefront
    compaction/sort) can
    evaluate a slot's per-PIXEL random stream in place -- this is what makes
    every integrator/toggle combination bit-identical (the reference reseeds
    per (iter, pixel, depth) the same way, ``src/pathtrace.cu:51-56``).
    It replaces a [n, k] row gather with ~40 int ops per lane, which XLA
    fuses into neighbors."""
    outs = []
    for j in range(k):
        flat = jnp.uint32(j * n) + idx.astype(jnp.uint32)
        bits = _threefry_bits_at(key, flat)
        u = jax.lax.bitcast_convert_type(
            (bits >> jnp.uint32(9)) | jnp.uint32(0x3F800000), jnp.float32
        ) - 1.0
        outs.append(jnp.maximum(0.0, u))
    return jnp.stack(outs)
