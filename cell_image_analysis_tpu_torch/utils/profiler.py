"""Throughput meters and stage timers.

Counterpart of `cell_image_analysis_tpu/utils/profiler.py`: `StageTimer`
wraps pipeline stages on the host's clock; `ThroughputMeter` accumulates
item counts.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass, field


@dataclass
class StageTimer:
    totals: dict = field(default_factory=lambda: defaultdict(float))
    counts: dict = field(default_factory=lambda: defaultdict(int))

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> dict:
        return {
            name: {"total_s": self.totals[name], "calls": self.counts[name],
                   "mean_s": self.totals[name] / max(self.counts[name], 1)}
            for name in self.totals
        }

    def report(self) -> str:
        lines = ["stage timings:"]
        for name, s in sorted(self.summary().items(), key=lambda kv: -kv[1]["total_s"]):
            lines.append(f"  {name:<28} {s['total_s']:8.3f}s  ({s['calls']} calls, "
                         f"{s['mean_s']*1e3:.1f} ms/call)")
        return "\n".join(lines)


@dataclass
class ThroughputMeter:
    items: int = 0
    seconds: float = 0.0
    _t0: float | None = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, n_items: int):
        assert self._t0 is not None
        self.seconds += time.perf_counter() - self._t0
        self.items += n_items
        self._t0 = None

    @property
    def rate(self) -> float:
        return self.items / self.seconds if self.seconds > 0 else 0.0
