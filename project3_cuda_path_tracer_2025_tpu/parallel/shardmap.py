"""Multi-device rendering as ``shard_map`` over the ray axis (production path).

The whole iteration body runs INSIDE ``jax.shard_map``, so every device
executes the full single-device program on its local pixel block with local
shapes, and the only collective in the entire iteration is one tiny
``psum`` of the per-depth alive counts.  The mesh is the flat 1-D "rays"
axis of ``parallel.mesh.make_pixel_mesh``: devices joined all to all
(NVLink) need no topology in it.

Two modes (both bit-identical to single-chip, asserted in tests):

* ``pixel``  -- the N = W*H path slots are block-sharded across devices;
  each device renders its own pixel rows every iteration.  RNG stays
  bit-identical because every draw is ``prng.uniforms_at`` at GLOBAL
  (pixel, depth) counters -- a device evaluates exactly the slice of the
  global stream its pixels own, so film(pixel-parallel, nd devices) ==
  film(one device), bit for bit.
* ``sample`` -- every device renders the FULL frame at a different
  iteration number (device d of nd renders iterations d+1, d+1+nd, ...);
  the per-device films are summed on save.  nd devices advance the
  accumulator nd samples per step: film(sample-parallel, one step) ==
  film(one device, nd steps).

The scene tables are replicated (every device traverses the same read-only
geometry); there is no cross-device traffic per bounce -- by construction,
not by compiler luck.  SURVEY.md section 2.3: the reference is single-GPU;
this is the scale-out the CUDA architecture never had.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import RenderConfig
from ..models.megakernel import megakernel_iteration
from ..models.wavefront import wavefront_iteration
from ..scene.device import SceneStatic
from ..utils.vec import Vec3
from .mesh import make_pixel_mesh

AXIS = "rays"


def _iter_fn(cfg: RenderConfig):
    return (
        wavefront_iteration
        if cfg.integrator == "wavefront"
        else megakernel_iteration
    )


def sharded_film(static: SceneStatic, mesh: Mesh, mode: str) -> Vec3:
    """Fresh film with the layout the sharded step expects."""
    nd = mesh.devices.size
    if mode == "sample":
        # one full-frame accumulator row per device, summed at save
        z = jnp.zeros((nd, static.pixel_count), jnp.float32)
        sh = NamedSharding(mesh, P(AXIS, None))
    else:
        z = jnp.zeros((static.pixel_count,), jnp.float32)
        sh = NamedSharding(mesh, P(AXIS))
    put = lambda x: jax.device_put(x, sh)
    return Vec3(put(z), put(z), put(z))


def make_sharded_step(
    static: SceneStatic,
    cfg: RenderConfig,
    mesh: Mesh,
    mode: str = "pixel",
):
    """Build the multi-device step(dev, cam, film, iteration, key).

    Returns (jitted_step, traceable_step, spp_per_step): ``traceable_step``
    is the unjitted callable for embedding in a fori_loop (Renderer's
    ``step_many``); ``sample`` mode advances mesh-size samples per call
    (``iteration`` is the LAST global sample the call completes), ``pixel``
    mode advances 1.
    """
    nd = mesh.devices.size
    n = static.pixel_count
    iter_fn = _iter_fn(cfg)

    if mode == "pixel":
        if n % nd:
            raise ValueError(
                f"pixel-parallel mode needs devices | pixels ({nd} vs {n}); "
                "use parallel_mode='sample' for odd resolutions"
            )
        idx_global = jnp.arange(n, dtype=jnp.int32)

        def local(dev_l, cam, film, idx, iteration, key):
            f, alive = iter_fn(
                dev_l, static, cfg, cam, film, iteration, key,
                shard=(idx, n),
            )
            return f, jax.lax.psum(alive, AXIS)

        inner = jax.shard_map(
            local,
            mesh=mesh,
            # P() as a pytree prefix replicates the whole subtree (scene
            # tables, camera, scalars); per-ray arrays shard on the ray axis.
            in_specs=(P(), P(), P(AXIS), P(AXIS), P(), P()),
            out_specs=(P(AXIS), P()),
            check_vma=False,
        )

        def step(dev, cam, film, iteration, key):
            return inner(dev, cam, film, idx_global, iteration, key)

        return jax.jit(step, donate_argnums=(2,)), step, 1

    if mode != "sample":
        raise ValueError(f"unknown parallel_mode {mode!r}")

    def local_sample(dev_l, cam, film_row, iteration, key):
        # iteration is the LAST global sample this step will complete;
        # device d renders global iteration (iteration - nd + 1 + d) --
        # together the step advances the film by exactly nd samples.
        d = jax.lax.axis_index(AXIS)
        it = iteration - nd + 1 + d
        film_l = Vec3(film_row.x[0], film_row.y[0], film_row.z[0])
        f, alive = iter_fn(dev_l, static, cfg, cam, film_l, it, key)
        f = Vec3(f.x[None], f.y[None], f.z[None])
        return f, jax.lax.psum(alive, AXIS)

    inner = jax.shard_map(
        local_sample,
        mesh=mesh,
        in_specs=(P(), P(), P(AXIS, None), P(), P()),
        out_specs=(P(AXIS, None), P()),
        check_vma=False,
    )

    def step(dev, cam, film, iteration, key):
        return inner(dev, cam, film, iteration, key)

    return jax.jit(step, donate_argnums=(2,)), step, nd


def film_to_flat(film: Vec3, mode: str) -> Vec3:
    """Collapse the sharded film to the single-device [N] layout (save
    time: the only cross-device data movement in the whole pipeline)."""
    if mode == "sample":
        return Vec3(
            jnp.sum(film.x, axis=0), jnp.sum(film.y, axis=0),
            jnp.sum(film.z, axis=0),
        )
    return film
