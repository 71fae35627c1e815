"""One run of one cell: set-up, the measured window, the traced window, the
check against the reference, the metrics and the result line.

Everything that belongs to one configuration, traffic mix, cell or metric
is data found by name: `BENCHMARK.json` at the root, `configs/<config>.json`
(named by the manifest), `traffic/<traffic>.json`,
`workloads/<cell>.json`, `metrics/<metric>.py` and the segmentation
backend's `backends/<backend>/` under this folder.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "cell_image_analysis_tpu")


def process_seconds() -> float:
    """Seconds since this process started (Linux /proc; else since this
    module was imported)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED


_IMPORTED = time.perf_counter()


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name (before the first dot) is, whole,
    one of FORBIDDEN."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".", 1)[0] in FORBIDDEN})


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(root: str, name: str) -> SimpleNamespace:
    """The manifest, the cell `name`, its configuration, traffic and
    workload files, and the manifest's metric entries that the cell
    reports (end-to-end and per-layer)."""
    manifest = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: {sorted(cells)}")
    cell = cells[name]
    conf = {c["name"]: c for c in manifest["configs"]}[cell["config"]]

    def reported(entries):
        return [m for m in entries if name in m.get("workloads", [name])]

    return SimpleNamespace(
        cell=cell, config=load_json(os.path.join(root, conf["file"])),
        traffic=load_json(os.path.join(HERE, "traffic", f"{cell['traffic']}.json")),
        workload=load_json(os.path.join(HERE, "workloads", f"{name}.json")),
        end_to_end=reported(manifest["end_to_end"]), per_layer=reported(manifest["per_layer"]))


def metric_reader(name: str):
    """`read(ctx)` of metrics/<name>.py."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Loop:
    """The closed loop of the screener: start batch i+1, then wait on
    batch i, so that at most two batches are pending.  Each batch is the
    next draw of pool indices; its record (a dict) keeps the indices, the
    clock readings, the host seconds inside start and wait, the result,
    its cells and whether it fell back."""

    def __init__(self, system, segs, greens, draws, crop_capacity: int, spans: bool = False):
        self.system, self.segs, self.greens, self.draws = system, segs, greens, draws
        self.crop_capacity, self.spans = crop_capacity, spans

    def _span(self, name):
        return torch.profiler.record_function(name) if self.spans else contextlib.nullcontext()

    def start(self) -> dict:
        idx = next(self.draws)
        t0 = time.perf_counter()
        sel = torch.as_tensor(idx, device=self.segs.device)
        segs, greens = self.segs.index_select(0, sel), self.greens.index_select(0, sel)
        t1 = time.perf_counter()
        with self._span("bench.start"):
            handle = self.system.start(segs, greens)
        return dict(frames=idx, t_start=t0, start_host_s=time.perf_counter() - t1, handle=handle)

    def wait(self, b: dict) -> dict:
        """Waits on batch b and drops its handle (the device memory it
        holds); in a traced window keeps the scored cells' crop sides."""
        from benchmark import program

        calls = self.system.fallback.calls
        t0 = time.perf_counter()
        with self._span("bench.wait"):
            scores, stats = self.system.wait(b["handle"])
        b["t_end"] = time.perf_counter()
        handle = b.pop("handle")
        b.update(wait_host_s=b["t_end"] - t0, cells=len(stats["area"]),
                 fell_back=self.system.fallback.calls > calls, result=(scores, stats))
        if self.spans:
            b["heights"], b["widths"] = program.handle_cells(handle, stats,
                                                             self.crop_capacity)
        return b

    def run(self, seconds: float | None = None, batches: int | None = None) -> list:
        """Whole batches until `seconds` have passed since the first start
        (then the pending one is finished) or `batches` have run."""
        done, cur = [], self.start()
        t0 = cur["t_start"]
        while True:
            more = (batches is None or len(done) + 1 < batches)
            nxt = self.start() if more else None
            done.append(self.wait(cur))
            if nxt is None:
                return done
            if seconds is not None and done[-1]["t_end"] - t0 >= seconds:
                done.append(self.wait(nxt))
                return done
            cur = nxt


def traced_window(loop: Loop, n_batches: int, device) -> tuple:
    """`n_batches` through the loop under torch.profiler (host and device),
    the device idle at both ends; (batches, reduced trace or None)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from benchmark import trace

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    loop.spans = True
    _sync(device)
    with profile(activities=acts) as prof:
        with record_function(trace.WINDOW_SPAN):
            batches = loop.run(batches=n_batches)
            _sync(device)
    loop.spans = False
    return batches, trace.reduce(trace.collect(prof))


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def measure(c: SimpleNamespace, seed: int, seconds: float, traced: bool, device,
            root: str, pool_workers: int = 4, system_factory=None) -> dict:
    """One run of the cell `c` (from `load_cell`) on `device`; returns the
    result line as a dict.  `system_factory(config, workload, root,
    device)` builds the system under test (default: `program.System`)."""
    from benchmark import backends, check, program, work
    from benchmark.reference.screen import Reference
    from benchmark.traffic.frames import batch_draws, make_pool

    backends.directory(c.config["segmentation"]["backend"])
    cuda = device.type == "cuda"
    clock = {"start": process_seconds()}
    pool = make_pool(c.traffic, workers=pool_workers)
    clock["pool"] = process_seconds()
    segs = torch.as_tensor(pool[..., 2].astype(np.float32)).to(device)
    greens = torch.as_tensor(pool[..., 1].astype(np.float32)).to(device)
    system = (system_factory or program.System)(c.config, c.workload, root, device)
    clock["system"] = process_seconds()
    draws = batch_draws(seed, c.traffic)
    loop = Loop(system, segs, greens, draws, c.config["qc"]["crop_capacity"])
    loop.run(batches=c.workload["warmup_batches"])
    system.warm_twin(segs[:c.traffic["frame_batch"]], greens[:c.traffic["frame_batch"]])
    _sync(device)
    setup_s = process_seconds()
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)

    counted = system.counters()
    batches = loop.run(seconds=seconds)
    counted = system.counters(since=counted)
    _sync(device)
    window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    window_s = batches[-1]["t_end"] - batches[0]["t_start"]

    red, traced_batches, spans = None, [], None
    if traced:
        system.reset_record()
        tb, red = traced_window(loop, c.workload["trace_batches"], device)
        traced_batches = [{k: v for k, v in b.items() if k != "result"} for b in tb]
        spans = system.span_summary()
    memory_peak = max(setup_peak, window_peak,
                      torch.cuda.max_memory_allocated(device) if cuda else 0)
    clock["window_end"] = process_seconds()

    # the check: a sample of the window's batches, drawn from the seed
    rng = np.random.default_rng([seed % 2 ** 64, 2])
    picks = rng.choice(len(batches), size=min(c.workload["sample_batches"], len(batches)),
                       replace=False)
    sample = [(pool[batches[i]["frames"]], batches[i]["result"]) for i in sorted(picks)]
    for b in batches:
        b.pop("result")
    del system, loop, segs, greens, pool
    if cuda:
        torch.cuda.empty_cache()
    ref = Reference(c.config, c.workload, root, device)
    numbers = check.compare([(got, ref.screen(frames)) for frames, got in sample])
    clock["reference_end"] = process_seconds()
    correct, checks = check.verdict(numbers, c.workload["limits"])

    ctx = SimpleNamespace(config=c.config, traffic=c.traffic, workload=c.workload,
                          device_type=device.type, seconds=window_s, batches=batches, setup_s=setup_s,
                          window_peak_bytes=window_peak, trace=red,
                          traced_batches=traced_batches, counters=counted, spans=spans)
    metrics = {}
    for m in (c.per_layer if traced else c.end_to_end):
        value = metric_reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else device.type,
           "count": c.cell["chips"], "memory_peak_bytes": int(memory_peak)}
    line = {"correct": bool(correct), "attempted": len(batches), "failed": 0,
            "metrics": metrics, "device": dev}
    if traced and red is not None:
        dev.update(busy_s=red["busy_s"], window_s=red["window_s"])
        line["breakdown"] = {"device_ops": red["device_ops"], "idle_gaps": red["idle_gaps"]}
    line["seconds"] = {k: round(v, 3) for k, v in clock.items()}
    line["counts"] = {k: numbers[k] for k in ("cells_program", "cells_reference",
                                              "cells_matched")}
    if traced_batches:
        line["counts"]["cells_by_clahe_bucket"] = work.clahe_buckets(
            np.concatenate([b["heights"] for b in traced_batches]),
            np.concatenate([b["widths"] for b in traced_batches]),
            c.workload["fused"]["caps"], c.config["qc"]["crop_capacity"])
    line["checks"] = checks
    return line
