"""Spans, counters, stage timers and throughput meters.

Counterpart of `cell_image_analysis_tpu/utils/profiler.py`, with the port's
own spans and counters:

- `span(name)`: a named range of the host's work.  Off (no
  `torch.profiler` session in the process) it costs one flag read and
  returns a shared no-op context.  On, it opens
  `torch.profiler.record_function(name)`, so the range sits in the trace
  beside the device's activity, and appends (name, start and end on
  `time.perf_counter_ns`, the enclosing span, the batch id, an argument)
  to a bounded in-memory record.  It creates no device work;
- `count(name, n)`: integer counters the host already holds, always on;
- `summary()` / `reset()`: the record by span name, and the counters;
- `StageTimer`: pipeline stages on the host's clock, each also a span;
- `ThroughputMeter`: item counts over host seconds;
- `trace(log_dir)`: a block under `torch.profiler`, written as a Chrome
  trace; `write_summary(path)` writes `summary()` as JSON.

Spans are opened and closed by the thread that screens; a span left open
by a generator that is closed late takes itself off the stack wherever it
lies.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import NamedTuple

import torch.autograd.profiler as _autograd_profiler
from torch.profiler import record_function

SPAN_CAPACITY = 200_000


class Span(NamedTuple):
    """One recorded span; `parent` is the index of the enclosing span in
    the record, -1 for a root."""

    name: str
    start_ns: int
    end_ns: int
    parent: int
    batch: int | None
    arg: str | None


class _Record:
    """The spans of the process's profiler sessions since the last
    `reset()`, at most `SPAN_CAPACITY` of them, and the counters."""

    def __init__(self):
        self.spans: list = []          # [name, start_ns, end_ns, parent, batch, arg]
        self.stack: list = []          # indices of the open spans
        self.counters: dict = defaultdict(int)
        self.dropped = 0


_RECORD = _Record()
_BATCH_IDS = itertools.count(1)
_OFF = contextlib.nullcontext()


class _OpenSpan:
    __slots__ = ("entry", "index", "rf")

    def __init__(self, name: str, batch: int | None, arg):
        self.entry = [name, 0, 0, -1, batch, None if arg is None else str(arg)]
        self.index = -1
        self.rf = record_function(name, self.entry[5])

    def __enter__(self):
        self.rf.__enter__()
        rec, e = _RECORD, self.entry
        if rec.stack:
            e[3] = rec.stack[-1]
            if e[4] is None:
                e[4] = rec.spans[e[3]][4]
        if len(rec.spans) < SPAN_CAPACITY:
            self.index = len(rec.spans)
            rec.spans.append(e)
            rec.stack.append(self.index)
        else:
            rec.dropped += 1
        e[1] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.entry[2] = time.perf_counter_ns()
        stack = _RECORD.stack
        if self.index >= 0 and self.index in stack:
            if stack[-1] == self.index:
                stack.pop()
            else:
                stack.remove(self.index)
        self.rf.__exit__(*exc)
        return False


def span(name: str, batch: int | None = None, arg=None):
    """A context manager naming the host's work inside it `name`: a no-op
    outside a `torch.profiler` session; inside one a `record_function`
    range and an entry of the record.  `batch` sets the batch id (else the
    enclosing span's), `arg` is kept as a string beside the name."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _OpenSpan(name, batch, arg)


def count(name: str, n: int = 1) -> None:
    """Adds `n` to the counter `name` (always on)."""
    _RECORD.counters[name] += n


def new_batch() -> int:
    """A batch id, unique in the process."""
    return next(_BATCH_IDS)


def records() -> list:
    """The recorded spans (`Span`), in the order they were opened."""
    return [Span(*e) for e in _RECORD.spans]


def counters(since: dict | None = None) -> dict:
    """The counters, less the counts of `since` (an earlier `counters()`)
    where given; counters that did not move are left out."""
    since = since or {}
    return {k: n - since.get(k, 0) for k, n in _RECORD.counters.items()
            if n != since.get(k, 0)}


def reset() -> None:
    """Clears the span record and the counters."""
    global _RECORD
    _RECORD = _Record()


def summary() -> dict:
    """{'spans': {name: {calls, host_ms, self_ms, host_ms_a_batch,
    self_ms_a_batch}}, 'counters', 'batches', 'dropped'}: the closed spans
    by name (self: a span's length less its children's), over the number
    of distinct batch ids in the record (per batch: None without one)."""
    spans = _RECORD.spans
    child = [0] * len(spans)
    for _, t0, t1, parent, _, _ in spans:
        if parent >= 0 and t1:
            child[parent] += t1 - t0
    batches = len({e[4] for e in spans if e[4] is not None})
    by_name: dict = {}
    for i, (name, t0, t1, _, _, _) in enumerate(spans):
        if not t1:
            continue
        s = by_name.setdefault(name, {"calls": 0, "host_ms": 0.0, "self_ms": 0.0})
        s["calls"] += 1
        s["host_ms"] += (t1 - t0) * 1e-6
        s["self_ms"] += (t1 - t0 - child[i]) * 1e-6
    for s in by_name.values():
        s["host_ms_a_batch"] = s["host_ms"] / batches if batches else None
        s["self_ms_a_batch"] = s["self_ms"] / batches if batches else None
    return {"spans": by_name, "counters": counters(), "batches": batches,
            "dropped": _RECORD.dropped}


def counters_report(counts: dict) -> str:
    """The counters `counts`, one a line, sorted by name."""
    lines = ["counters:"]
    lines += [f"  {name:<28} {n}" for name, n in sorted(counts.items())]
    return "\n".join(lines)


@dataclass
class StageTimer:
    """Host seconds by stage, with no synchronize: a stage's time is its
    enqueue and whatever it waited for.  Each stage is also a `span`."""

    totals: dict = field(default_factory=lambda: defaultdict(float))
    counts: dict = field(default_factory=lambda: defaultdict(int))

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            with span(name):
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
        lines = ["stage timings (host seconds):"]
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


@contextlib.contextmanager
def trace(log_dir: str | None):
    """A `torch.profiler` trace of the block (the host, and the card where
    there is one), written into `log_dir` as a Chrome trace
    `trace_<pid>_<ns>.json` when the block ends, also when it raises; the
    exception goes on.  The block's spans are in the trace and in the
    record (`summary()`).  `None` or "" does nothing."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def write_summary(path: str) -> None:
    """`summary()` as JSON at `path`."""
    with open(path, "w") as f:
        json.dump(summary(), f, indent=1, sort_keys=True)
