"""Single-cell benchmark: scenes/cornell.json at 800x800, depth 8, on one GPU.

Prints ONE JSON line:
  {"metric": "...", "value": N, "unit": "ms/frame", "vs_baseline": N, ...}

Baseline: the reference's closest published proxy for cornell-class scenes is
42.204 ms/frame (diffuse scene with stream compaction on an RTX 3060 Laptop,
reference README.md:133-136; see BASELINE.md).  ``vs_baseline`` is the
speedup factor baseline_ms / our_ms (>1 = faster than the reference).

Every timing ends in ``jax.block_until_ready``.  The line names the device
(platform, kind, count) and ``XLA_FLAGS``; without a GPU the script fails
instead of timing another backend.

    python bench.py            # BENCH_BATCH / BENCH_WARMUP / BENCH_REPS tune it
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

BASELINE_MS = 42.204  # reference README.md:133-136
SCENE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scenes", "cornell.json")
METRIC = "cornell.json 800x800 depth-8 ms/frame"


def main():
    import jax
    import numpy as np

    from project3_cuda_path_tracer_2025_tpu.config import RenderConfig
    from project3_cuda_path_tracer_2025_tpu.models import Renderer
    from project3_cuda_path_tracer_2025_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(json.dumps({
            "metric": METRIC, "value": None, "unit": "ms/frame",
            "vs_baseline": None, "error": f"no GPU (platform {dev.platform!r})",
        }))
        return 1
    enable_compile_cache()

    spp_per_launch = int(os.environ.get("BENCH_BATCH", "64"))
    warmup = int(os.environ.get("BENCH_WARMUP", "2"))
    reps = int(os.environ.get("BENCH_REPS", "4"))

    r = Renderer(SCENE, RenderConfig(spp_per_launch=spp_per_launch))

    # Warmup: compiles the batched program (step_many AOT-compiles).
    for _ in range(warmup):
        r.step_many(spp_per_launch)

    t0 = time.perf_counter()
    for i in range(reps):
        r.step_many(spp_per_launch, sync=(i == reps - 1))
    dt = time.perf_counter() - t0
    frames = reps * spp_per_launch
    ms_per_frame = dt * 1e3 / frames
    rays_per_frame = float(r._alive_counts.sum() + r.static.pixel_count)
    mrays = rays_per_frame / (ms_per_frame * 1e3)

    # Unbatched 1-spp dispatch, two operating points:
    #   * PIPELINED: dispatches enqueue back-to-back, one sync at the end --
    #     the steady-state frame rate of an interactive loop whose display
    #     fetch is the sync point (interactive.py runs exactly this way).
    #   * SYNC: a device sync every frame -- the interactive latency.
    from project3_cuda_path_tracer_2025_tpu.utils.timers import FrameStats

    r.compile()  # the single-step program, outside the timed window
    r.step()
    n_pipe = 32
    t3 = time.perf_counter()
    for _ in range(n_pipe):
        r.step(sync=False)
    jax.block_until_ready(r.film)
    unbatched_ms = (time.perf_counter() - t3) * 1e3 / n_pipe
    r.stats = FrameStats()
    for _ in range(8):
        r.step()
    unbatched_sync_ms = r.stats.mean_ms

    finite = bool(np.isfinite(r.image_normalized()).all())
    print(
        json.dumps(
            {
                "metric": METRIC,
                "value": ms_per_frame,
                "unit": "ms/frame",
                "vs_baseline": BASELINE_MS / ms_per_frame,
                "baseline_ms": BASELINE_MS,
                "mrays_per_s": mrays,
                "frames_timed": frames,
                "spp_per_launch": spp_per_launch,
                "unbatched_ms_per_frame": unbatched_ms,
                "unbatched_sync_ms_per_frame": unbatched_sync_ms,
                "film_finite": finite,
                "device": {
                    "platform": dev.platform,
                    "kind": dev.device_kind,
                    "count": len(jax.devices()),
                },
                "xla_flags": os.environ.get("XLA_FLAGS", ""),
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
