#!/usr/bin/env python3
"""Multi-process dry run of the port: processes joined by `torch.distributed`,
each with its own shards of one global mesh (`parallel.distributed`).

Counterpart of `scripts/dryrun_dcn.py` (2 `jax.distributed` processes x 4
virtual devices).  The launcher spawns fresh interpreters (`subprocess`,
never `fork`: CUDA does not survive a fork) on a free localhost port, each
with a timeout; a worker that fails or times out stops the others and
fails the run.  With a CUDA device it builds the kernels first, so that the
workers find them built.  Each worker makes the same checks as JAX's
dryrun, in the same order, against its own single-process run:

1. `counts`: the masked anomaly counts of 64 seed-made flags, each process
   holding its rows over its shards, summed over the processes
   (`masked_anomaly_rate(mesh=)`, `all_reduce_counts`);
2. `score_cells`: the four detectors' anomaly counts (`cell_counts`) of
   64 seed-made cells, each process scoring its rows over its shards and
   the counts summed over the processes, equal the single-process counts;
3. `fused`: `score_frames_fused` on 8 seed-made frames of 128^2 (4 cells
   each; the threshold backend, which runs the CC kernel) over the global
   mesh: the same cells (frame_index and areas equal), floats within 1e-5
   (the sorted reconstruction MSE too), predictions and rates equal.

`--checks` may add `overflow`: frames whose run-table flag fires in one
process's frames only; every process must re-run through the exact twin
(counted in each), and the result must equal the twin's own run.
`--stardist FRAMES.npz` runs instead the StarDist main path
(`utils/bench.stardist_backend`, `STARDIST_KW`, the committed scoring
asset) on the frames of the file (`segs`, `greens`), a warm-up run then a
timed one, and writes the result; its caller compares it.

Each worker writes `OUT/rank{r}.json` (what it checked and counted, wall
seconds, kernel launches, peak device memory) and `OUT/rank{r}.npz` (the
global mesh's scores and statistics, which every process holds).

    python scripts/dryrun_dist_torch.py                       # 2 x 4, cuda:0, gloo
    python scripts/dryrun_dist_torch.py --device cpu          # 2 x 4, CPU, gloo
    python scripts/dryrun_dist_torch.py --local-shards 2
    python scripts/dryrun_dist_torch.py --local-shards 2 --stardist F.npz

The workers run on cuda:0 unless `--device` names another device; without
a GPU the launcher exits 2 unless `--device cpu` is given.  Imports nothing
of the JAX package.  `--backend nccl` puts rank r on cuda:r (NCCL refuses
two ranks on one GPU).
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

STORE = os.path.join(REPO, "assets", "screening_store_synthetic")
N_PROCS = 2                     # dryrun_dcn.py's processes
THREADS = 2                     # torch threads a worker
N_ROWS = 64                     # dryrun_dcn.py's flags and cells
N_FRAMES, FRAME_SIZE, FRAME_CELLS = 8, 128, 4
FUSED_KW = dict(chunk=8, cell_capacity=16, label_capacity=64)
# `overflow`: 8 frames of 256^2 with 6 cells each, at a run capacity that
# frame 4 alone overflows (the second of two processes' first frame)
OVERFLOW_SIZE, OVERFLOW_KW = 256, dict(chunk=16, cell_capacity=32, rcap=6, label_capacity=1024)
CHECKS = ("counts", "score_cells", "fused")
KERNELS = ("winograd", "segsum", "clahe_kernel", "cc", "kthvalue")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_workers(argvs: list, timeout: float, log_dir: str, on_start=None) -> list:
    """Runs one process a command line of `argvs`, each writing its output
    to `log_dir/worker{i}.log`; when one exits with a non-zero code, or
    `timeout` seconds pass, the others are killed.  `on_start(procs, logs)`
    runs once they are started.  Returns each process's exit code (None
    where it was killed)."""
    logs = [os.path.join(log_dir, f"worker{i}.log") for i in range(len(argvs))]
    files = [open(p, "w") for p in logs]
    try:
        procs = [subprocess.Popen(a, stdout=f, stderr=subprocess.STDOUT)
                 for a, f in zip(argvs, files)]
        if on_start is not None:
            on_start(procs, logs)
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs):
            failed = any(p.returncode not in (None, 0) for p in procs)
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.05)
        rcs = []
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
                rcs.append(None)
            else:
                rcs.append(p.returncode)
        return rcs
    finally:
        for f in files:
            f.close()


def launch(args, argv: list) -> int:
    if args.device.startswith("cuda"):
        from cell_image_analysis_tpu_torch.ops.cuda import _build

        _build.library()     # built once here, not by every worker at once
    port = free_port()
    own = list(argv)
    out = args.out or tempfile.mkdtemp(prefix="dryrun_dist_")
    if not args.out:
        own += ["--out", out]
    os.makedirs(out, exist_ok=True)
    argvs = [[sys.executable, os.path.abspath(__file__), *own, "--worker", str(r),
              "--port", str(port)] for r in range(N_PROCS)]
    t0 = time.perf_counter()
    rcs = run_workers(argvs, args.timeout, out)
    wall = time.perf_counter() - t0
    ok = all(rc == 0 for rc in rcs)
    for r, rc in enumerate(rcs):
        with open(os.path.join(out, f"worker{r}.log")) as f:
            tail = "\n".join(f.read().strip().splitlines()[-12:])
        if r == 0 or rc != 0:
            print(f"[worker {r} rc={rc}]\n{tail}")
    print(f"dryrun_dist_torch: {N_PROCS} processes x {args.local_shards} shards on "
          f"{args.device} ({args.backend}), {wall:.1f} s: {'OK' if ok else 'FAILED'}")
    return 0 if ok else 1


# ---------------------------------------------------------------- worker --

def _device(args):
    import torch

    if args.backend == "nccl":
        dev = torch.device("cuda", args.worker)
        torch.cuda.set_device(dev)
        return dev
    return torch.device(args.device)


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _launches() -> dict:
    import importlib

    return {k: importlib.import_module(f"cell_image_analysis_tpu_torch.ops.cuda.{k}").LAUNCHES
            for k in KERNELS}


def _reset_launches() -> None:
    import importlib

    for k in KERNELS:
        importlib.import_module(f"cell_image_analysis_tpu_torch.ops.cuda.{k}").LAUNCHES = 0


def dryrun_cells() -> np.ndarray:
    """The 64 cells of check 2: 48 normal and 16 mutant `make_cells`."""
    from cell_image_analysis_tpu_torch.utils.synthetic import make_cells

    rng = np.random.default_rng(0)
    return np.concatenate([make_cells(rng, 48), make_cells(rng, 16, mutant=True)])[..., None]


def dryrun_frames(cells=None, size: int = FRAME_SIZE, seed: int = 2) -> tuple:
    """(segs, greens) float32 of `make_frame`s from one rng: N_FRAMES of
    FRAME_CELLS cells by default, else one frame an entry of `cells`."""
    from cell_image_analysis_tpu_torch.utils.synthetic import make_frame

    rng = np.random.default_rng(seed)
    cells = cells or (FRAME_CELLS,) * N_FRAMES
    fr = np.stack([make_frame(rng, size=size, n_cells=n) for n in cells])
    return fr[..., 2].astype(np.float32), fr[..., 1].astype(np.float32)


def assert_sharded_equal(ref: tuple, got: tuple, what: str) -> None:
    """The port's contract for sharded results: frame_index and areas
    equal, floats within 1e-5, predictions and rates equal."""
    (r, rs), (o, os_) = ref, got
    for k in ("frame_index", "area", "label_ids"):
        if not np.array_equal(rs[k], os_[k]):
            raise AssertionError(f"{what}: {k} differs")
    if r.keys() != o.keys():
        raise AssertionError(f"{what}: keys {sorted(r)} against {sorted(o)}")
    for k in r:
        if k.endswith("_rate") or k.endswith("_predictions"):
            ok = np.array_equal(np.asarray(r[k]), np.asarray(o[k]))
        else:
            ok = np.allclose(o[k], r[k], rtol=0, atol=1e-5)
        if not ok:
            raise AssertionError(f"{what}: {k} differs")


def detector_counts(scores: dict) -> list:
    return [int(np.sum(scores.get(f"{d}_predictions", np.zeros(0)) == -1))
            for d in ("conservative", "moderate", "ensemble", "fft")]


def _check_counts(g, dev, args, model, params, result: dict) -> None:
    import torch

    from cell_image_analysis_tpu_torch.parallel.distributed import (
        all_reduce_counts,
        process_local_rows,
    )
    from cell_image_analysis_tpu_torch.parallel.sharding import masked_anomaly_rate, shard_batch

    rng = np.random.default_rng(7)
    scores = rng.normal(size=(N_ROWS,)).astype(np.float32)
    valid = rng.uniform(size=(N_ROWS,)) > 0.25
    flags = (scores > 0.5) & valid
    preds = torch.as_tensor(np.where(flags, -1, 1).astype(np.int32))
    lp, lv = (process_local_rows(t, g) for t in (preds, torch.as_tensor(valid)))
    rate = masked_anomaly_rate(shard_batch(g.local, lp), shard_batch(g.local, lv), mesh=g)
    got = all_reduce_counts([int(((lp == -1) & lv).sum()), int(lv.sum())]).tolist()
    want = [int(flags.sum()), int(valid.sum())]
    if got != want or rate != want[0] / want[1]:
        raise AssertionError(f"counts: {got}, rate {rate}; the whole batch {want}")
    result["counts"] = dict(anomalies=got[0], valid=got[1], rate=rate)


def cell_counts(model, params, cells, g=None) -> list:
    """`detector_counts` of `score_cells` on the (n, 64, 64, 1) `cells`: on
    the device of `params`, or with a global mesh `g`, `cells` being this
    process's rows, scored over its own shards (zero-padded, the padding
    not counted) and the counts summed over every process (each process
    must call)."""
    from cell_image_analysis_tpu_torch.parallel.distributed import all_reduce_counts
    from cell_image_analysis_tpu_torch.parallel.sharding import replicate, shard_batch
    from cell_image_analysis_tpu_torch.pipeline.scoring import compute_anomaly_scores

    if g is None:
        return detector_counts(compute_anomaly_scores(model, params, cells))
    parts = shard_batch(g.local, cells)
    valid = np.arange(sum(p.shape[0] for p in parts)) < cells.shape[0]
    scores = compute_anomaly_scores(replicate(g.local, model), replicate(g.local, params),
                                    parts, valid=valid)
    return all_reduce_counts(detector_counts(scores)).tolist()


def _check_score_cells(g, dev, args, model, params, result: dict) -> None:
    import torch

    from cell_image_analysis_tpu_torch.parallel.distributed import process_local_rows

    cells = torch.as_tensor(dryrun_cells())
    ref = cell_counts(model, params, cells)
    got = cell_counts(model, params, process_local_rows(cells, g), g)
    if got != ref:
        raise AssertionError(f"score_cells counts over the processes {got}, one process {ref}")
    result["score_cells"] = dict(counts=list(got), cells=N_ROWS)


def _fused(model, params, segs, greens, fn, dev, **kw):
    import torch

    from cell_image_analysis_tpu_torch.pipeline.scoring import score_frames_fused

    s, gr = (torch.as_tensor(a, device=dev) for a in (segs, greens))
    return score_frames_fused(model, params, s, gr, fn, **kw)


def _check_fused(g, dev, args, model, params, result: dict) -> tuple:
    from cell_image_analysis_tpu_torch.models.segmentation import ThresholdBackend

    segs, greens = dryrun_frames()
    backend = ThresholdBackend()
    kw = dict(FUSED_KW, fallback_segment_fn=backend.exact_twin())
    ref = _fused(model, params, segs, greens, backend, dev, **kw)
    _sync(dev)
    _reset_launches()
    t0 = time.perf_counter()
    got = _fused(model, params, segs, greens, backend, dev, mesh=g, **kw)
    _sync(dev)
    wall = time.perf_counter() - t0
    launches = _launches()
    n = len(got[1]["area"])
    if n == 0 or n != len(ref[1]["area"]):
        raise AssertionError(f"fused: {n} cells over the processes, {len(ref[1]['area'])} in one")
    assert_sharded_equal(ref, got, "fused")
    if not np.allclose(np.sort(got[0]["reconstruction_mse"]),
                       np.sort(ref[0]["reconstruction_mse"]), rtol=0, atol=1e-5):
        raise AssertionError("fused: the sorted reconstruction MSE differs by more than 1e-5")
    result["fused"] = dict(cells=n, counts=detector_counts(got[0]), seconds=wall,
                           launches=launches)
    return got


class _Counted:
    """A segment_fn that counts its calls (the exact twin: no flag, so the
    pixel regionprops)."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, x):
        self.calls += 1
        return self.fn(x)


def _check_overflow(g, dev, args, model, params, result: dict) -> None:
    import torch

    from cell_image_analysis_tpu_torch.models.segmentation import ThresholdBackend
    from cell_image_analysis_tpu_torch.ops.extract import stage_a
    from cell_image_analysis_tpu_torch.parallel.distributed import (
        all_reduce_counts,
        process_local_rows,
    )

    segs, greens = dryrun_frames((6,) * N_FRAMES, size=OVERFLOW_SIZE)
    backend = ThresholdBackend()
    local = [torch.as_tensor(process_local_rows(a, g), device=dev) for a in (segs, greens)]
    _, ovf, _ = stage_a(backend, *local, {k: v for k, v in OVERFLOW_KW.items() if k != "chunk"})
    mine = bool(ovf.any())
    if int(all_reduce_counts([int(mine)])[0]) != 1:
        raise AssertionError("overflow: the flag must fire in one process's frames only")
    twin = _Counted(backend.exact_twin())
    got = _fused(model, params, segs, greens, backend, dev, mesh=g, fallback_segment_fn=twin,
                 **OVERFLOW_KW)
    reran = int(all_reduce_counts([int(twin.calls > 0)])[0])
    if reran != g.world:
        raise AssertionError(f"overflow: {reran} of {g.world} processes re-ran through the twin")
    ref = _fused(model, params, segs, greens, backend.exact_twin(), dev, mesh=g, **OVERFLOW_KW)
    for a, b in zip(ref, got):
        if a.keys() != b.keys() or any(not np.array_equal(a[k], b[k]) for k in a):
            raise AssertionError("overflow: the fallback's result is not the twin's")
    result["overflow"] = dict(flag_here=mine, twin_calls=twin.calls, cells=len(got[1]["area"]))


def _stardist(g, dev, args, result: dict) -> tuple:
    import torch
    import warnings

    from cell_image_analysis_tpu_torch.io.artifacts import load_scoring_params
    from cell_image_analysis_tpu_torch.utils.bench import STARDIST_KW, stardist_backend

    with np.load(args.stardist) as f:
        segs, greens = f["segs"], f["greens"]
    backend = stardist_backend(device=dev)
    model, params = load_scoring_params(device=dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        _fused(model, params, segs, greens, backend, dev, mesh=g, **STARDIST_KW)   # warm-up
        _sync(dev)
        _reset_launches()
        t0 = time.perf_counter()
        got = _fused(model, params, segs, greens, backend, dev, mesh=g, **STARDIST_KW)
        _sync(dev)
        wall = time.perf_counter() - t0
    launches = _launches()
    if any("capacity overflow" in str(w.message) for w in seen):
        raise AssertionError("stardist: a capacity flag fired")
    result["stardist"] = dict(cells=len(got[1]["area"]), frames=int(segs.shape[0]),
                              counts=detector_counts(got[0]), seconds=wall, launches=launches)
    return got


def worker(args) -> int:
    import torch

    from cell_image_analysis_tpu_torch.io.artifacts import (
        build_scoring_params,
        load_screening_artifacts,
    )
    from cell_image_analysis_tpu_torch.parallel import distributed
    from cell_image_analysis_tpu_torch.parallel.mesh import virtual_mesh

    torch.set_num_threads(THREADS)
    dev = _device(args)
    distributed.initialize(args.worker, N_PROCS, f"tcp://localhost:{args.port}",
                           args.backend, timeout_s=args.timeout)
    print(f"worker {args.worker}: initialized ({args.backend}, {dev})", flush=True)
    g = distributed.global_mesh(virtual_mesh(dev, args.local_shards))
    result = dict(rank=g.rank, world=g.world, device=str(dev), backend=args.backend,
                  global_shards=g.shape["data"])
    if dev.type == "cuda":
        result["device_name"] = torch.cuda.get_device_name(dev)
    got = None
    if args.stardist:
        got = _stardist(g, dev, args, result)
    else:
        model, params = build_scoring_params(*load_screening_artifacts(STORE), device=dev)
        for check in args.checks.split(","):
            t0 = time.perf_counter()
            out = {"counts": _check_counts, "score_cells": _check_score_cells,
                   "fused": _check_fused, "overflow": _check_overflow}[check](
                g, dev, args, model, params, result)
            got = out if check == "fused" else got
            print(f"worker {args.worker}: {check} OK in {time.perf_counter() - t0:.2f} s: "
                  f"{result[check]}", flush=True)
    result["peak_gib"] = (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                          if dev.type == "cuda" else None)
    with open(os.path.join(args.out, f"rank{args.worker}.json"), "w") as f:
        json.dump(result, f)
    if got is not None:
        scores, stats = got
        np.savez(os.path.join(args.out, f"rank{args.worker}.npz"),
                 **{f"scores/{k}": np.asarray(v) for k, v in scores.items()},
                 **{f"stats/{k}": v for k, v in stats.items()})
    distributed.shutdown()
    print(f"worker {args.worker}: {json.dumps(result)}", flush=True)
    return 0


def read_result(path: str) -> tuple:
    """(scores, stats) from a worker's `rank{r}.npz`."""
    with np.load(path) as f:
        scores = {k[7:]: (f[k].item() if f[k].ndim == 0 else f[k])
                  for k in f.files if k.startswith("scores/")}
        stats = {k[6:]: f[k] for k in f.files if k.startswith("stats/")}
    return scores, stats


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="every worker's device (default cuda:0; 'cpu' runs on the CPU)")
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    ap.add_argument("--local-shards", type=int, default=4)
    ap.add_argument("--checks", default=",".join(CHECKS))
    ap.add_argument("--stardist", default=None, help="an .npz of frames (segs, greens)")
    ap.add_argument("--out", default=None, help="directory for the workers' results")
    ap.add_argument("--timeout", type=float, default=120.0, help="seconds for the workers")
    ap.add_argument("--worker", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    argv = sys.argv[1:] if argv is None else list(argv)
    args = ap.parse_args(argv)
    from cell_image_analysis_tpu_torch.io.artifacts import resolve_device

    try:
        args.device = str(resolve_device(args.device or "cuda:0"))
    except RuntimeError as e:
        ap.exit(2, f"{ap.prog}: error: {e} (--device cpu)\n")
    if args.worker is not None:
        return worker(args)
    return launch(args, [*argv, "--device", args.device])


if __name__ == "__main__":
    sys.exit(main())
