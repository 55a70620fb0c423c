"""High-level renderer: the counterpart of the reference's app shell.

Replaces ``main.cpp``'s GLFW/CUDA-GL loop with a headless device-resident
loop: scene -> device scene -> jitted iteration -> film -> PNG/HDR, plus
checkpoint/resume of (film, iteration, rng key) -- the restartable-render
feature the reference left unimplemented (INSTRUCTION.md:135).

Camera orbit parity: ``orbit()`` applies the reference's mouse controls and,
like ``runCuda`` (``src/main.cpp:423-453``), resets accumulation.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec

from ..config import RenderConfig, backend
from ..ops import film as film_ops
from ..ops import fused
from ..scene import load_scene
from ..scene.camera import CameraState, OrbitState, camera_state, derive_render_camera
from ..scene.device import build_device_scene
from ..scene.types import HostScene
from ..utils import compile_cache, image_io
from ..utils.timers import FrameStats
from ..utils.vec import Vec3
from .megakernel import megakernel_iteration
from .wavefront import wavefront_iteration


@dataclass
class RenderResult:
    image: np.ndarray  # [H, W, 3] accumulated (undivided)
    iterations: int
    stats: FrameStats
    alive_counts: np.ndarray  # [depth] from the last iteration
    path: Optional[str] = None


class Renderer:
    def __init__(
        self,
        scene: HostScene | str,
        cfg: RenderConfig = RenderConfig(),
        seed: int = 0,
    ) -> None:
        # Persistent XLA compile cache: scene-shaped programs compile once
        # per machine (mesh traversal programs are expensive to compile).
        compile_cache.enable_compile_cache()

        if isinstance(scene, str):
            scene = load_scene(
                scene, leaf_size=cfg.bvh_leaf_size, native_bvh=cfg.native_bvh
            )
        self.scene = scene
        self.cfg = cfg
        self.dev, self.static = build_device_scene(scene)
        self.orbit = OrbitState.from_camera(scene.state.camera)
        self._base_key = jax.random.PRNGKey(seed)
        self.iteration = 0
        self._spp_stride = 1  # spp advanced per dispatch (sample-parallel: N)
        self._mesh = None
        if cfg.devices > 1:
            from ..parallel import shardmap

            self._mesh = shardmap.make_pixel_mesh(cfg.devices)
            # Replicated once, so no step re-transfers the scene tables.
            self.dev = jax.device_put(
                self.dev, NamedSharding(self._mesh, PartitionSpec())
            )
        self.film: Vec3 = self._new_film()
        self.stats = FrameStats()
        self._alive_counts = np.zeros(self.static.trace_depth, np.int64)
        self._refresh_camera()

        self._build_step()

    @property
    def _alive_counts(self):
        """Per-depth alive-ray telemetry of the last dispatch.

        Stored raw (possibly a device array) and fetched to host lazily on
        first read, so ``step_many(sync=False)`` enqueues without a host
        sync for a [depth]-int fetch per batch."""
        raw = self._alive_raw
        if not isinstance(raw, np.ndarray):
            raw = np.asarray(raw)
            self._alive_raw = raw
        return raw

    @_alive_counts.setter
    def _alive_counts(self, value):
        self._alive_raw = value

    def _new_film(self) -> Vec3:
        if self._mesh is not None:
            from ..parallel import shardmap

            return shardmap.sharded_film(
                self.static, self._mesh, self.cfg.parallel_mode
            )
        return film_ops.new_film(self.static.pixel_count)

    def _build_step(self) -> None:
        """Build the jitted per-iteration step ``(dev, cam, film, iteration,
        key) -> (film', alive)``.  The device scene is an ARGUMENT, not a
        closure: closed-over arrays would be baked into the executable as
        constants (once per unrolled bounce), which bloats compile time and
        device memory on large meshes."""
        cfg_ = self.cfg
        static_ = self.static

        if self._mesh is not None:
            # Multi-device: the whole iteration runs inside shard_map on
            # local shapes; the whole-iteration prim kernel is a
            # single-device specialization and is not used here.
            from ..parallel import shardmap

            step, iter_fn, stride = shardmap.make_sharded_step(
                static_, cfg_, self._mesh, cfg_.parallel_mode
            )
            self._step = step
            self._iter_fn = iter_fn
            self._spp_stride = stride
            self._pixel_chunks = 1  # chunking never composes with shard_map
            self._step_many_cache = {}
            return
        iter_fn = (
            wavefront_iteration
            if cfg_.integrator == "wavefront"
            else megakernel_iteration
        )

        self._pixel_chunks = cfg_.pixel_chunks
        if self._pixel_chunks > 1:
            # Chunked dispatch: C sequential launches of ONE compiled
            # program over contiguous pixel blocks (the integrators' shard
            # path with a traced block-id vector).  Pixel-keyed RNG makes
            # this bit-identical to the unchunked step; it exists to bound
            # the per-program ray count (see config.pixel_chunks).
            n_g = static_.pixel_count
            chunks = self._pixel_chunks
            if n_g % chunks:
                raise ValueError(
                    f"pixel_chunks={chunks} must divide the pixel count {n_g}"
                )
            sz = n_g // chunks

            def _chunk(dev, cam, film_c, iteration, key, idx):
                return iter_fn(
                    dev, static_, cfg_, cam, film_c, iteration, key,
                    shard=(idx, n_g),
                )

            chunk_fn = jax.jit(_chunk, donate_argnums=(2,))
            idx_blocks = [
                jnp.arange(c * sz, (c + 1) * sz, dtype=jnp.int32)
                for c in range(chunks)
            ]

            def _step(dev, cam, film, iteration, key):
                xs, ys, zs = [], [], []
                alive = jnp.zeros((static_.trace_depth,), jnp.int32)
                for c in range(chunks):
                    sl = slice(c * sz, (c + 1) * sz)
                    film_c = Vec3(film.x[sl], film.y[sl], film.z[sl])
                    film_c, a = chunk_fn(
                        dev, cam, film_c, iteration, key, idx_blocks[c]
                    )
                    xs.append(film_c.x)
                    ys.append(film_c.y)
                    zs.append(film_c.z)
                    alive = alive + a
                film = Vec3(
                    jnp.concatenate(xs), jnp.concatenate(ys), jnp.concatenate(zs)
                )
                return film, alive

            self._step = _step  # host loop of per-chunk jits, NOT one jit
            self._iter_fn = _step
            self._step_many_cache = {}
            return

        if (
            cfg_.integrator == "megakernel"
            and fused.fused_applicable(static_, cfg_)
            and cfg_.resolved_fused_bounce()
        ):
            # Whole-iteration prim kernel (ops/fused.py); interpreted only
            # where a test forces it on the CPU.
            interpret = backend() == "cpu"

            def _step(dev, cam: CameraState, film: Vec3, iteration, key):
                return fused.fused_prim_iteration(
                    static_, cfg_, cam, film, iteration, key,
                    interpret=interpret,
                )

        else:

            def _step(dev, cam: CameraState, film: Vec3, iteration, key):
                return iter_fn(dev, static_, cfg_, cam, film, iteration, key)

        # Donate the film: it is threaded through every iteration in place.
        self._step = jax.jit(_step, donate_argnums=(2,))
        self._iter_fn = _step
        self._step_many_cache: dict[int, object] = {}

    def compile(self):
        """AOT-compile the single-iteration step so compile time stays out
        of the first timed step.  Returns the compiled program (its
        ``memory_analysis()`` and ``as_text()`` describe it)."""
        if self._pixel_chunks > 1:
            raise ValueError("a chunked step is a host loop of programs")
        args = (
            self.dev, self._cam_state, self.film,
            jnp.int32(self.iteration + self._spp_stride), self._base_key,
        )
        self._step = self._step.lower(*args).compile()
        return self._step

    # -- camera --------------------------------------------------------------
    def _refresh_camera(self) -> None:
        if self.cfg.spherical_camera_reconstruction:
            cam = derive_render_camera(self.scene.state.camera, self.orbit)
        else:
            cam = self.scene.state.camera
        self.render_camera = cam
        self._cam_state = camera_state(cam)

    def orbit_camera(self, dphi=0.0, dtheta=0.0, dzoom=0.0, look_at=None) -> None:
        """Orbit controls; resets accumulation like the reference
        (``src/main.cpp:423-425``)."""
        self.orbit.orbit(dphi=dphi, dtheta=dtheta, dzoom=dzoom)
        if look_at is not None:
            self.orbit.look_at = np.asarray(look_at, np.float64)
        self._refresh_camera()
        self.reset()

    def reset(self) -> None:
        self.iteration = 0
        self.film = self._new_film()
        self.stats = FrameStats()

    # -- rendering -------------------------------------------------------------
    def step(self, sync: bool = True) -> None:
        """Trace one spp iteration (reference: one ``pathtrace()`` frame).
        Sample-parallel multi-device advances ``cfg.devices`` spp per call.

        ``sync=False`` enqueues the dispatch without waiting for it: an
        interactive loop that displays a preview each frame gets its sync
        from the preview fetch instead, so 1-spp dispatches pipeline at
        device-compute rate (the reference's operating mode, one
        ``pathtrace()`` per frame, src/pathtrace.cu:639, where the GL draw
        provides the same natural sync)."""
        self.iteration += self._spp_stride
        t0 = time.perf_counter()
        self.film, alive = self._step(
            self.dev,
            self._cam_state,
            self.film,
            jnp.int32(self.iteration),
            self._base_key,
        )
        if sync:
            jax.block_until_ready(self.film)
        self.stats.add((time.perf_counter() - t0) * 1e3)
        self._alive_counts = alive if not sync else np.asarray(alive)
        if self.cfg.debug_nan_checks:
            self._check_finite()

    def _check_finite(self) -> None:
        """Debug-config runtime checking (the reference's analogue is the
        ERRORCHECK sync-after-every-launch, src/pathtrace.cu:26-49)."""
        for name, arr in (("film.r", self.film.x), ("film.g", self.film.y),
                          ("film.b", self.film.z)):
            bad = int(jnp.sum(~jnp.isfinite(arr)))
            if bad:
                raise FloatingPointError(
                    f"non-finite values in {name} after iteration "
                    f"{self.iteration}: {bad} lanes"
                )

    def _step_many_fn(self, k: int, example_args=None):
        """Jit a k-iteration loop (amortizes per-dispatch latency; the
        reference pays a full host round-trip per frame, src/pathtrace.cu:783).

        AOT-compiled on first use so the timed path never includes a
        compile."""
        if k not in self._step_many_cache:
            iter_fn = self._iter_fn
            depth = self.static.trace_depth
            stride = self._spp_stride

            def _many(dev, cam: CameraState, film: Vec3, it0, key):
                def body(i, carry):
                    film, _ = carry
                    return iter_fn(dev, cam, film, it0 + i * stride, key)

                init = (film, jnp.zeros((depth,), jnp.int32))
                return jax.lax.fori_loop(0, k, body, init)

            fn = jax.jit(_many, donate_argnums=(2,))
            if example_args is not None:
                fn = fn.lower(*example_args).compile()
            self._step_many_cache[k] = fn
        return self._step_many_cache[k]

    def step_many(self, k: int, sync: bool = True) -> None:
        """Trace k spp in one device dispatch.

        ``sync=False`` skips the per-call device sync: use it when chaining
        many batches back-to-back and sync once at the end
        (``jax.block_until_ready``) -- per-call wall stats are then enqueue
        times, not compute times."""
        stride = self._spp_stride
        # k is in spp; each dispatch advances stride spp (sample-parallel
        # traces one spp PER CHIP).  Round UP: sample-parallel can't trace
        # fewer than a stride, and truncating would silently deliver fewer
        # spp than requested -- callers track self.iteration, which always
        # reflects what actually ran.
        n_disp = max(1, -(-k // stride))
        if n_disp == 1 or self._pixel_chunks > 1:
            # Chunked mode steps from the host (jitting the chunk loop into
            # one fori program would rebuild exactly the oversized program
            # chunking exists to avoid).
            for i in range(n_disp):
                self.step(sync=sync and i == n_disp - 1)
            return
        args = (
            self.dev, self._cam_state, self.film,
            jnp.int32(self.iteration + stride), self._base_key,
        )
        fn = self._step_many_fn(n_disp, example_args=args)
        t0 = time.perf_counter()
        self.film, alive = fn(*args)
        if sync:
            jax.block_until_ready(self.film)
        spp_done = n_disp * stride
        dt_ms = (time.perf_counter() - t0) * 1e3 / spp_done
        for _ in range(spp_done):
            self.stats.add(dt_ms)
        self.iteration += spp_done
        # Raw device array -- fetched lazily on first telemetry read, so a
        # sync=False call enqueues without a host roundtrip.
        self._alive_counts = alive

    def render(
        self,
        spp: Optional[int] = None,
        out_dir: Optional[str] = None,
        hdr: bool = False,
        log_every: int = 0,
    ) -> RenderResult:
        total = spp if spp is not None else self.static.iterations
        batch = max(1, self.cfg.spp_per_launch)
        while self.iteration < total:
            self.step_many(min(batch, total - self.iteration))
            if log_every and (self.iteration % log_every == 0 or self.iteration == total):
                rays = float(self._alive_counts.sum() + self.static.pixel_count)
                print(
                    f"iter {self.iteration}/{total}  "
                    f"{self.stats.mean_ms:.2f} ms/frame  "
                    f"{self.stats.fps:.1f} FPS  "
                    f"{self.stats.mrays_per_s(rays):.1f} Mrays/s  "
                    f"depth-alive {self._alive_counts.tolist()}"
                )
        img = self.image()
        path = None
        if out_dir is not None:
            path = image_io.save_film(
                img,
                self.iteration,
                self.static.image_name,
                out_dir=out_dir,
                mirror=self.cfg.mirror_output,
                hdr=hdr,
            )
        return RenderResult(
            image=img,
            iterations=self.iteration,
            stats=self.stats,
            alive_counts=self._alive_counts,
            path=path,
        )

    def _flat_film(self) -> Vec3:
        if self._mesh is not None and self.cfg.parallel_mode == "sample":
            from ..parallel import shardmap

            return shardmap.film_to_flat(self.film, "sample")
        return self.film

    def image(self) -> np.ndarray:
        """Accumulated film as [H, W, 3] (host copy happens here only)."""
        return film_ops.to_host_image(
            self._flat_film(), self.static.width, self.static.height
        )

    def preview_image(self, out_h: int, out_w: int) -> np.ndarray:
        """[out_h, out_w, 3] normalized preview, downsampled ON DEVICE.

        The interactive loop's display is terminal-sized (~160x90 cells);
        the full 800^2 film is ~7.7 MB per frame while the preview is
        ~0.3 MB.  Uses
        the same nearest-neighbor grid as ``interactive.frame_to_ansi`` so
        the displayed cells are identical to the full-fetch path (asserted
        in tests/test_interactive.py)."""
        h, w = self.static.height, self.static.width
        ys = np.clip((np.arange(out_h) + 0.5) * h / out_h, 0, h - 1).astype(int)
        xs = np.clip((np.arange(out_w) + 0.5) * w / out_w, 0, w - 1).astype(int)
        key = (out_h, out_w)
        cache = getattr(self, "_preview_cache", None)
        if cache is None:
            cache = self._preview_cache = {}
        if key not in cache:
            ys_j, xs_j = jnp.asarray(ys), jnp.asarray(xs)

            @jax.jit
            def _preview(film, iters):
                img = jnp.stack(
                    [a.reshape(h, w)[ys_j][:, xs_j] for a in film], axis=-1
                )
                return img / jnp.maximum(1.0, iters)

            cache[key] = _preview
        small = cache[key](
            tuple(self._flat_film()), jnp.float32(max(1, self.iteration))
        )
        return np.asarray(small)

    def image_normalized(self) -> np.ndarray:
        return self.image() / max(1, self.iteration)

    def save(self, out_dir: str = "img", hdr: bool = False) -> str:
        return image_io.save_film(
            self.image(),
            max(1, self.iteration),
            self.static.image_name,
            out_dir=out_dir,
            mirror=self.cfg.mirror_output,
            hdr=hdr,
        )

    # -- checkpoint / resume ---------------------------------------------------
    def checkpoint(self, path: str) -> None:
        """Checkpoints are always the FLAT [N] accumulator (sample-parallel
        rows are summed first), so they move freely between single-chip and
        any multi-chip configuration."""
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        film = self._flat_film()
        np.savez_compressed(
            path,
            film_x=np.asarray(film.x),
            film_y=np.asarray(film.y),
            film_z=np.asarray(film.z),
            iteration=self.iteration,
            key=np.asarray(jax.random.key_data(self._base_key)),
        )

    def restore(self, path: str) -> None:
        d = np.load(path)
        film = Vec3(
            jnp.asarray(d["film_x"]), jnp.asarray(d["film_y"]), jnp.asarray(d["film_z"])
        )
        if self._mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            if self.cfg.parallel_mode == "sample":
                # Accumulation is additive: restore into chip row 0, zero the
                # rest -- the summed film is identical and every chip keeps
                # rendering its own future iterations.
                nd = self._mesh.devices.size
                pad = lambda x: jnp.concatenate(
                    [x[None], jnp.zeros((nd - 1, x.shape[0]), x.dtype)], axis=0
                )
                film = Vec3(pad(film.x), pad(film.y), pad(film.z))
                sh = NamedSharding(self._mesh, P("rays", None))
            else:
                sh = NamedSharding(self._mesh, P("rays"))
            film = Vec3(*[jax.device_put(a, sh) for a in film])
        self.film = film
        self.iteration = int(d["iteration"])
        self._base_key = jax.random.wrap_key_data(jnp.asarray(d["key"]))
