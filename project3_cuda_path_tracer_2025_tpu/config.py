"""Render configuration.

One runtime dataclass replaces the reference's three config layers
(compile-time ``#define`` toggles ``src/pathtrace.cu:20-24``, hardcoded
constants ``src/utilities.h:19-20`` / ``src/scene.cpp:470`` /
``src/intersections.cu:166``, and the JSON camera block).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """All knobs of the renderer, hashable so it can be a jit static arg.

    Feature toggles (reference ``src/pathtrace.cu:21-24``):

    * ``stream_compaction`` -- reference ``STREAM_COMPACTION``: in the
      wavefront integrator, front-pack live rays each bounce (prefix-sum
      permutation) so trailing blocks can be skipped.  In the megakernel
      integrator termination is a mask either way; the flag only controls the
      wavefront repacking.
    * ``material_sorting`` -- reference ``MATERIAL_SORTING``: stable-sort live
      rays by material id before shading so each material bucket is dense.
    * ``bvh_acceleration`` -- reference ``BVH_ACCELERATION``: traverse the
      threaded BVH; when False, brute-force every triangle (the A/B oracle,
      reference ``NAIVE_MESH_LOADING`` path ``src/pathtrace.cu:365-395``).
    """

    # Feature toggles (A/B parity with src/pathtrace.cu:21-24)
    # True = front-pack every bounce (the reference's STREAM_COMPACTION);
    # "adaptive" = front-pack only once the live fraction drops below 1/2,
    # decided per bounce on the device (lax.cond on the live count).
    # Images are identical either way -- compaction is a pure permutation
    # and RNG is pixel-keyed; every stage is static-shape, so packing a
    # mostly-live bounce costs a permutation and skips nothing.  Wavefront
    # profiling: scripts/profile_wavefront.py.  True/False remain as the
    # reference's parity toggles.
    stream_compaction: "bool | str" = "adaptive"
    material_sorting: bool = False
    bvh_acceleration: bool = True

    # Integrator family: "megakernel" (one fused jit, bounce loop unrolled,
    # masked termination) or "wavefront" (per-bounce stages with compaction /
    # material sort, mirroring the reference architecture).
    integrator: str = "megakernel"

    # Shader: "full" (kernShadeMaterialProper + scatterRay) or "fake" (the
    # reference's shadeFakeMaterial demo, src/pathtrace.cu:459-502).
    shader: str = "full"

    # Samples traced per launch (batched spp amortizes dispatch overhead; the
    # reference always traces 1 spp per frame).
    spp_per_launch: int = 1

    # Numerical constants -- load-bearing for image parity
    # (src/utilities.h:19-20, src/intersections.h:29-32).
    baby_epsilon: float = 1e-5
    larger_epsilon: float = 1e-3
    ray_advance_epsilon: float = 1e-4

    # BVH build/traversal (src/scene.cpp:470, src/intersections.cu:166).
    bvh_leaf_size: int = 4
    # Use the native C++ BVH builder when available (falls back to NumPy).
    native_bvh: bool = True

    # Whole-iteration prim kernel (ops/fused.py: raygen + every bounce +
    # film accumulate in one Pallas Triton program; applies to scenes with
    # no triangles/textures): "auto" (on the GPU), "on" (everywhere,
    # interpreted on CPU -- slow, tests only), "off".
    fused_bounce: str = "auto"

    # Mesh intersector selection:
    #   "auto"     -- the threaded BVH on every platform
    #   "threaded" -- octant-ordered threaded-BVH gather walk (jnp)
    #   "brute"    -- all-triangles sweep (the reference's NAIVE_MESH_LOADING
    #                 oracle); also selected by bvh_acceleration=False
    mesh_intersector: str = "auto"

    # Alive-prefix tiers for the WAVEFRONT integrator, as divisors of the
    # ray count: stream compaction packs every alive ray into a front
    # prefix, so a lax.cond chain runs the whole bounce over the smallest
    # configured tier holding the population, the dead tail passing
    # through untouched.  Bit-identical results (elementwise stages +
    # pixel-keyed RNG).  () disables tiering.  "auto" resolves through
    # ``resolved_prefix_tiers``: (4, 2) on an accelerator, () on CPU,
    # where the tier cond chain only multiplies compile time.
    bounce_prefix_tiers: "tuple | str" = "auto"

    # Split each iteration into C sequential same-shaped dispatches over
    # contiguous pixel blocks (the megakernel's shard path with a traced
    # block-id -- ONE compiled program, C launches).  Identical to
    # unchunked up to XLA fusion rounding (pixel-keyed RNG; megakernel
    # paths measure bit-exact, the wavefront shard program re-fuses FMA
    # contraction at <=1e-6 -- tests/test_chunked.py).
    # Purpose: bounding the per-program ray count of a configuration that
    # needs it (e.g. the brute-force A/B at large resolutions).  1 = off.
    pixel_chunks: int = 1

    # Multi-device scale-out (shard_map over a flat 1-D device mesh;
    # parallel/shardmap.py).
    #   devices = 1: single device (default).  devices = N: render across
    #   the first N jax devices.  parallel_mode:
    #   "pixel"  -- shard the W*H path slots (bit-identical to one device)
    #   "sample" -- each device renders the full frame at its own iteration
    #               number; films sum at save (one step advances N spp)
    devices: int = 1
    parallel_mode: str = "pixel"

    # Loop lowering: Python-unroll the bounce loop (better fusion, bigger
    # HLO) vs lax.fori_loop (compact HLO).  None = auto (unroll).
    unroll_bounces: Optional[bool] = None

    # Camera parity quirks.
    # The reference re-derives the render camera from spherical coordinates on
    # the first frame (src/main.cpp:423-444) instead of using EYE directly.
    spherical_camera_reconstruction: bool = True

    # Output parity: saveImage writes the PNG horizontally mirrored
    # (src/main.cpp:407).
    mirror_output: bool = True

    # Debugging: enable finite-value checks on path state each bounce.
    debug_nan_checks: bool = False

    def __post_init__(self):
        # Tier fields must be tuples: the config is a jit static arg
        # (hashable) and bench/CLI layers hand these in as JSON lists.
        if self.bounce_prefix_tiers != "auto" and not isinstance(
            self.bounce_prefix_tiers, tuple
        ):
            object.__setattr__(
                self, "bounce_prefix_tiers", tuple(self.bounce_prefix_tiers)
            )
        if self.mesh_intersector not in ("auto", "threaded", "brute"):
            raise ValueError(
                f"mesh_intersector={self.mesh_intersector!r}: use "
                "'auto'/'threaded'/'brute'"
            )
        if self.fused_bounce not in ("auto", "on", "off"):
            raise ValueError(
                f"fused_bounce={self.fused_bounce!r}: use 'auto'/'on'/'off'"
            )
        # stream_compaction is bool | "adaptive", but sibling toggles use
        # "on"/"off" strings -- normalize those rather than letting a
        # truthy "off" silently ENABLE compaction, and reject the rest.
        sc = self.stream_compaction
        if isinstance(sc, str) and sc != "adaptive":
            if sc in ("on", "true", "1"):
                object.__setattr__(self, "stream_compaction", True)
            elif sc in ("off", "false", "0"):
                object.__setattr__(self, "stream_compaction", False)
            else:
                raise ValueError(
                    f"stream_compaction={sc!r}: use True/False/'adaptive'"
                )

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)

    def resolved_fused_bounce(self) -> bool:
        """Whether the whole-iteration prim kernel runs (where the scene
        admits it): "auto" turns it on on the GPU only."""
        if self.fused_bounce != "auto":
            return self.fused_bounce == "on"
        return backend() == "gpu"

    def resolved_mesh_intersector(self) -> str:
        """"threaded" or "brute" -- the same on every platform.
        ``bvh_acceleration=False`` selects the brute-force oracle, as the
        reference's toggle does."""
        if not self.bvh_acceleration or self.mesh_intersector == "brute":
            return "brute"
        return "threaded"

    def resolved_prefix_tiers(self) -> tuple:
        """``bounce_prefix_tiers`` with "auto" resolved: (4, 2) on an
        accelerator, () on CPU."""
        if self.bounce_prefix_tiers != "auto":
            return self.bounce_prefix_tiers
        return () if backend() == "cpu" else (4, 2)


PLATFORMS = ("cpu", "gpu", "tpu")


def backend() -> str:
    """The platform of JAX's default backend: "cpu", "gpu" or "tpu".

    Every "auto" setting of ``RenderConfig`` resolves through this one
    function.  A platform outside ``PLATFORMS`` is an error, not a guess."""
    import jax

    platform = jax.default_backend()
    if platform not in PLATFORMS:
        raise RuntimeError(
            f"unsupported JAX platform {platform!r}; expected one of "
            f"{PLATFORMS}"
        )
    return platform
