"""Physically-based path tracer in JAX (XLA, with one Pallas Triton kernel).

A from-scratch rebuild of the capability set of the reference CUDA wavefront
path tracer (UPenn CIS-565 Project 3, ``sagescherrytree/Project3-CUDA-Path-Tracer-2025``)
as array programs that XLA compiles for the GPU:

* SoA path state: every per-ray quantity is a flat ``[N]`` array (``Vec3`` is a
  pytree of three ``[N]`` arrays) so every stage is a coalesced elementwise
  pass -- the reference is AoS ``PathSegment[]`` (``src/sceneStructs.h:128``).
* Static shapes everywhere: "stream compaction" (reference:
  ``thrust::stable_partition``, ``src/pathtrace.cu:750-757``) becomes an
  alive-mask plus an optional front-packing permutation driven by a prefix sum.
* Stackless threaded-BVH traversal (hit/miss skip links, one ``int32`` of
  traversal state per ray) replaces the reference's per-thread 64-deep stack
  (``src/intersections.cu:166``), so all rays advance in one vectorized loop.
* Counter-based threefry RNG keyed on (iteration, pixel, depth) replaces the
  seeded LCG stream (``src/pathtrace.cu:51-56``) with equivalent statistics.
* The film stays on device; host transfer only happens on save/checkpoint
  (the reference copies the full film D2H every frame, ``src/pathtrace.cu:783``).

Conventional import alias::

    import project3_cuda_path_tracer_2025_tpu as ptt
"""

from .config import RenderConfig
from .version import __version__

__all__ = ["RenderConfig", "__version__"]
