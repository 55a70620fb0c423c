"""Time the whole-iteration prim kernel against the XLA megakernel.

Renders each in-repo prim-only scene at its own size (800x800, depth 8)
through the XLA megakernel (``fused_bounce="off"``) and through the Pallas
Triton kernel (``ops/fused.py``) at several (rays per block, warps)
settings, all in one process on one GPU, in turns: XLA, every kernel
setting, XLA again.  Each timing is the median over rounds of ``--spp``
back-to-back iterations ended by ``jax.block_until_ready``.  Prints one
JSON line per (scene, path); the device and its power limit come first.

    python scripts/bench_prim_kernel.py [--spp 16] [--rounds 3]
        [--configs 128:4,256:4,512:8]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PRIM_SCENES = ("cornell.json", "cornell_dof.json", "cornell_transmissive_sphere.json")


def time_steps(step, state, spp: int, rounds: int):
    """Median ms per spp of ``step`` over ``rounds`` rounds of ``spp`` calls."""
    import jax
    import jax.numpy as jnp

    dev, cam, film, key = state
    it = 1
    film, _ = step(dev, cam, film, jnp.int32(it), key)  # warm-up
    jax.block_until_ready(film)
    per_round = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(spp):
            it += 1
            film, alive = step(dev, cam, film, jnp.int32(it), key)
        jax.block_until_ready(film)
        per_round.append((time.perf_counter() - t0) * 1e3 / spp)
    return statistics.median(per_round), per_round, alive


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--configs", default="128:4,256:4,512:8")
    ap.add_argument("--scenes", default=",".join(PRIM_SCENES))
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from project3_cuda_path_tracer_2025_tpu.config import RenderConfig
    from project3_cuda_path_tracer_2025_tpu.models import Renderer
    from project3_cuda_path_tracer_2025_tpu.ops import fused
    from project3_cuda_path_tracer_2025_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    if jax.default_backend() != "gpu":
        print("no GPU: this benchmark runs on the card only", file=sys.stderr)
        return 2
    enable_compile_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip()
    dev = jax.devices()[0]
    print(json.dumps({"nvidia_smi": smi, "device_kind": dev.device_kind}))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    configs = [tuple(int(v) for v in c.split(":")) for c in args.configs.split(",")]

    for name in args.scenes.split(","):
        r = Renderer(
            os.path.join(repo, "scenes", name), RenderConfig(fused_bounce="off")
        )
        xla = jax.jit(r._iter_fn, donate_argnums=(2,))
        runs = [("xla", xla)]
        for block, warps in configs:
            fn = jax.jit(
                lambda dev, cam, film, it, key, b=block, w=warps: fused.fused_prim_iteration(
                    r.static, r.cfg, cam, film, it, key, block=b, num_warps=w
                ),
                donate_argnums=(2,),
            )
            runs.append((f"triton:{block}:{warps}", fn))
        runs.append(("xla", xla))
        for label, fn in runs:
            state = (r.dev, r._cam_state, r._new_film(), r._base_key)
            t0 = time.perf_counter()
            fn.lower(*state[:3], jnp.int32(1), state[3]).compile()
            compile_s = time.perf_counter() - t0
            ms, per_round, alive = time_steps(fn, state, args.spp, args.rounds)
            print(json.dumps({
                "scene": name, "path": label, "ms_per_spp": ms,
                "rounds_ms_per_spp": per_round, "compile_s": compile_s,
                "alive": [int(a) for a in jax.device_get(alive)],
                "width": r.static.width, "height": r.static.height,
                "depth": r.static.trace_depth,
            }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
