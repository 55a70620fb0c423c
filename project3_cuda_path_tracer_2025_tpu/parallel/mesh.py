"""Multi-device scale-out: data parallelism over pixels/rays via jax.sharding.

The reference is strictly single-GPU (SURVEY.md section 2.3); path tracing is
embarrassingly parallel over rays, so the scale-out shards the N = W*H path
slots across a flat 1-D device mesh ("rays" axis).  Every device reaches
every other at the same rate (NVLink, all to all), so the mesh follows the
algorithm alone:

* every per-ray array (path state, film, RNG uniforms) is sharded on its ray
  axis,
* the scene tables (materials, triangles, BVH, textures) are replicated --
  each device traverses the same read-only BVH,
* within a bounce there is NO cross-device communication; the only
  collectives are the (tiny) alive-count psums for telemetry and the film
  gather at save time.

Dividing work by pixel keeps the film's scatter-add local to each shard, so
no ring/all-reduce is ever needed on the film itself.

This module uses XLA's AUTOMATIC partitioner (jit + shardings) on the jnp
integrator paths and serves as the sharding oracle in tests.  The
PRODUCTION multi-device path is ``parallel.shardmap``: the whole iteration
runs inside ``jax.shard_map`` per device, and it adds the sample-parallel
mode (each device renders different spp of the full frame, films summed on
save) for resolutions that don't divide evenly.  ``RenderConfig(devices=N)``
routes the Renderer/CLI through it.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import RenderConfig
from ..models.megakernel import megakernel_iteration
from ..models.wavefront import wavefront_iteration
from ..scene.camera import CameraState
from ..scene.device import DeviceScene, SceneStatic
from ..utils.vec import Vec3


def make_pixel_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """1-D mesh over the 'rays' axis."""
    if devices is None:
        devices = jax.devices()[: n_devices or len(jax.devices())]
    return Mesh(np.asarray(devices), axis_names=("rays",))


def shard_paths_spec() -> P:
    return P("rays")


def replicate_scene(dev: DeviceScene, mesh: Mesh) -> DeviceScene:
    rep = NamedSharding(mesh, P())
    return jax.tree.map(lambda x: jax.device_put(x, rep), dev)


def shard_film(film: Vec3, mesh: Mesh) -> Vec3:
    sh = NamedSharding(mesh, P("rays"))
    return jax.tree.map(lambda x: jax.device_put(x, sh), film)


def sharded_iteration(
    dev: DeviceScene,
    static: SceneStatic,
    cfg: RenderConfig,
    mesh: Mesh,
):
    """Build a jitted one-iteration step whose per-ray arrays are sharded
    over ``mesh``.  Megakernel state is purely elementwise + gathers from
    replicated tables, so XLA partitions it with zero per-bounce collectives;
    the returned alive counts are global (psum'd by XLA at the reduce)."""
    iter_fn = (
        wavefront_iteration if cfg.integrator == "wavefront" else megakernel_iteration
    )
    ray_sharding = NamedSharding(mesh, P("rays"))
    film_spec = Vec3(ray_sharding, ray_sharding, ray_sharding)

    def _step(cam: CameraState, film: Vec3, iteration, key):
        return iter_fn(dev, static, cfg, cam, film, iteration, key)

    return jax.jit(
        _step,
        donate_argnums=(1,),
        out_shardings=(film_spec, NamedSharding(mesh, P())),
    )


SCENE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "scenes", "cornell.json",
)


def dryrun(n_devices: int, scene_path: str = SCENE,
           width: int = 64, height: int = 64, integrator: str = "megakernel",
           **cfg_overrides) -> Tuple:
    """Compile + execute ONE sharded iteration on tiny shapes.

    Used by ``__graft_entry__.dryrun_multichip`` (validation on virtual CPU
    devices) and by the sharding tests.  ``cfg_overrides`` are forwarded to
    ``RenderConfig`` (e.g. ``mesh_intersector="brute"``).
    """
    from ..ops import film as film_ops
    from ..scene import build_device_scene, camera_state, derive_render_camera, load_scene, set_resolution

    scene = set_resolution(load_scene(scene_path), width, height)
    dev, static = build_device_scene(scene)
    cfg = RenderConfig(integrator=integrator, **cfg_overrides)
    mesh = make_pixel_mesh(n_devices)

    dev = replicate_scene(dev, mesh)
    film = shard_film(film_ops.new_film(static.pixel_count), mesh)
    cam = camera_state(derive_render_camera(scene.state.camera))

    step = sharded_iteration(dev, static, cfg, mesh)
    film, alive = step(cam, film, jnp.int32(1), jax.random.PRNGKey(0))
    jax.block_until_ready(film.x)
    return film, alive, mesh
