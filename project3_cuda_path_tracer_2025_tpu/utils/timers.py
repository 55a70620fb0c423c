"""Performance timing utilities.

Counterpart of ``StreamCompaction::Common::PerformanceTimer``
(``stream_compaction/common.h:46-130``): wall-clock brackets around
``jax.block_until_ready`` plus simple running statistics, and a frame-average
readout mirroring the ImGui ms/frame counter (``src/main.cpp:288``) that is
the source of all reference benchmark numbers.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List

import jax


class PerformanceTimer:
    """start/stop CPU+device timer; device timing blocks on computation."""

    def __init__(self) -> None:
        self._t0 = None
        self.elapsed_ms = 0.0

    def start(self) -> None:
        if self._t0 is not None:
            raise RuntimeError("timer already started")
        self._t0 = time.perf_counter()

    def stop(self, *block_on) -> float:
        if self._t0 is None:
            raise RuntimeError("timer not started")
        jax.block_until_ready(block_on)
        self.elapsed_ms = (time.perf_counter() - self._t0) * 1e3
        self._t0 = None
        return self.elapsed_ms


@dataclass
class FrameStats:
    """Running ms/frame average (the reference's perf oracle)."""

    times_ms: List[float] = field(default_factory=list)

    def add(self, ms: float) -> None:
        self.times_ms.append(ms)

    @property
    def mean_ms(self) -> float:
        return sum(self.times_ms) / max(1, len(self.times_ms))

    @property
    def fps(self) -> float:
        m = self.mean_ms
        return 1000.0 / m if m > 0 else 0.0

    def mrays_per_s(self, rays_per_frame: float) -> float:
        m = self.mean_ms
        return rays_per_frame / (m * 1e3) if m > 0 else 0.0
