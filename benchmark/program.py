"""The system under test: the port's screening entry, built from a
configuration and a cell's capacities.

This module and the backends' `backends/<backend>/system.py` are the
modules of the benchmark that import the program
(`cell_image_analysis_tpu_torch`).  It builds what `cli screen` builds for
every batch: the segmentation backend that the configuration names
(`backends/<backend>/system.py`) over its weight files, the scoring state,
and `score_frames_fused_start` / `score_frames_fused_wait` with the
backend's `exact_twin()` as the overflow fallback, behind a counter that
the benchmark owns.  The port's counters and span record
(`utils/profiler`) are read through it too.
"""

from __future__ import annotations

import numpy as np

from benchmark import backends
from benchmark.reference.models import checked_weights


class CountedFallback:
    """The exact twin, counting its calls (one a batch that fell back),
    with the twin's routing flags."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0
        for flag in ("returns_mask", "returns_overflow", "runs_props"):
            if hasattr(fn, flag):
                setattr(self, flag, getattr(fn, flag))

    def __call__(self, segs):
        self.calls += 1
        return self.fn(segs)


class System:
    """`start(segs, greens)` enqueues a (B, H, W) float32 batch on the
    device and returns its handle; `wait(handle)` returns (scores, stats);
    `fallback.calls` counts the batches re-run through the exact twin."""

    def __init__(self, config: dict, workload: dict, root: str, device):
        from cell_image_analysis_tpu_torch.io.artifacts import scoring_params_from_numpy
        from cell_image_analysis_tpu_torch.pipeline import scoring
        from cell_image_analysis_tpu_torch.utils import profiler

        self._start, self._wait = scoring.score_frames_fused_start, scoring.score_frames_fused_wait
        self._profiler = profiler
        seg = dict(config["segmentation"], **workload["segmentation"])
        build = backends.module(seg["backend"], "system").build
        paths = checked_weights(config["weights"], root)
        self.backend = build(seg, {k: p for k, p in paths.items() if k != "scoring"}, device)
        self.fallback = CountedFallback(self.backend.exact_twin())
        with np.load(paths["scoring"]) as z:
            self.model, self.params = scoring_params_from_numpy({k: z[k] for k in z.files},
                                                                device=device)
        sc, fused = config["scoring"], dict(workload["fused"])
        fused["caps"] = tuple(fused["caps"])
        self.kw = dict(fused, **config["qc"], min_votes=sc["min_votes"],
                       out_size=sc["out_size"], clip_limit=sc["clip_limit"],
                       fallback_segment_fn=self.fallback)

    def start(self, segs, greens) -> dict:
        return self._start(self.model, self.params, segs, greens, self.backend, **self.kw)

    def wait(self, handle: dict) -> tuple:
        return self._wait(handle)

    def counters(self, since: dict | None = None) -> dict:
        """The port's counters (`utils/profiler.counters`), less `since`."""
        return self._profiler.counters(since)

    def reset_record(self) -> None:
        """Clears the port's span record and counters."""
        self._profiler.reset()

    def span_summary(self) -> dict:
        """The port's recorded spans by name (`utils/profiler.summary`)."""
        return self._profiler.summary()["spans"]

    def warm_twin(self, segs, greens) -> tuple:
        """One batch through the exact twin, as a fallback runs it."""
        kw = {k: v for k, v in self.kw.items() if k != "fallback_segment_fn"}
        return self._wait(self._start(self.model, self.params, segs, greens, self.fallback.fn,
                                      **kw))


def handle_cells(handle: dict, stats: dict, crop_capacity: int) -> tuple:
    """(heights, widths) int64 numpy of the scored cells of a handle that
    `wait` took (the exact twin's pass where the batch fell back): the
    bounding-box sides the CLAHE kernel read, in the rows' order.

    `wait` returns no bounding boxes, so they are read from the handle's
    host copy, whose layout is the port's own (`pipeline/scoring._decode`:
    B geometry counts, then N = B x cell_capacity heights, widths, valid
    flags, label ids and areas).  The read is checked against the rows
    `wait` returned, and raises where they disagree: the layout has
    changed, and the sides cannot be read."""
    h = handle.get("rerun", handle)
    B, ccap, _ = h["shape"]
    n = B * ccap
    ints = h["ints"].numpy()
    if ints.ndim != 1 or ints.shape[0] < B + 5 * n:
        raise RuntimeError(f"handle_cells: the handle's host copy holds {ints.shape} ints, "
                           f"fewer than the {B + 5 * n} of the layout the benchmark reads, so "
                           "clahe_cells_roofline cannot be read")
    heights, widths, valid, label_ids, area = (ints[B + k * n:B + (k + 1) * n].astype(np.int64)
                                               for k in range(5))
    keep = valid == 1
    heights, widths = heights[keep], widths[keep]
    problems = []
    if not np.isin(valid, (0, 1)).all():
        problems.append("valid flags other than 0 and 1")
    if keep.sum() != len(stats["area"]):
        problems.append(f"{int(keep.sum())} valid slots for {len(stats['area'])} rows")
    elif not (np.array_equal(area[keep], stats["area"])
              and np.array_equal(label_ids[keep], stats["label_ids"])):
        problems.append("areas or label ids that differ from the rows'")
    elif not (heights * widths >= area[keep]).all():
        problems.append("a box smaller than its cell")
    if ((heights < 1) | (heights > crop_capacity) | (widths < 1) | (widths > crop_capacity)).any():
        problems.append(f"sides outside 1..{crop_capacity}")
    if problems:
        raise RuntimeError("handle_cells: the handle's host copy does not hold the layout "
                           "the benchmark reads (" + "; ".join(problems) + "), so "
                           "clahe_cells_roofline cannot be read")
    return heights, widths
