"""Anomaly scoring and fused frame screening.

Counterpart of `cell_image_analysis_tpu/pipeline/scoring.py`:

- `score_cells`: CAE forward, reconstruction MSE/MAE, RobustScaler, PCA,
  the conservative and moderate RBF SVMs, the ensemble vote, the FFT
  features and the FFT SVM, for a (B, 64, 64, 1) batch of cells;
- `score_frames_fused`: the screening of a frame batch on one device —
  segmentation, stage A, size buckets (`size_buckets`: caps 64 and 96 at
  ns_cap 12, the full crop capacity at ns_cap 16), CLAHE once a bucket
  (one kernel launch on the GPU), then resize -> `score_cells` per chunk
  of it — returning the same `(scores, stats)` pair as the JAX
  `score_frames_fused_wait`.  It is `score_frames_fused_wait` of
  `score_frames_fused_start`: the first enqueues segmentation and stage A
  and returns a handle, the second does the host's part, so a caller keeps
  one batch in flight;
- `compute_anomaly_scores`: `score_cells` on host cells, as a dict.

With a `parallel.distributed.GlobalMesh` (processes joined by
`torch.distributed`), `score_frames_fused_start` takes the global batch,
which every process holds, and runs its own process's frames on its own
shards; `score_frames_fused_wait` takes the overflow decision over every
process (one process falling back alone would leave the others waiting in
the next collective) and all-gathers the scored rows with global frame
indices, so that every process returns the whole batch's result, as JAX's
decode of the all-gathered buffer does.  Every process must make the same
calls.

Stage A (`ops.extract.stage_a`) takes the segment_fn's label maps through
one of JAX `_stage_a_one`'s two label routes, by its `runs_props` flag:
the run-length regionprops (every backend's main route) or the pixel
regionprops (the exact twins'); stage B is CLAHE a size bucket
(`ops.extract.clahe_buckets`) and `_chunk_rows` (resize, `score_cells`)
`chunk` cells at a time, each bucket's last chunk padded to `chunk` rows;
on the card each chunk is one
replay of a CUDA graph captured once a bucket cap (`_ChunkGraph`).  When a
capacity flag fires in any frame (a run table's `rcap`, or a flag the
segment_fn returns with `returns_overflow`), the whole batch re-runs
through `fallback_segment_fn`, the exact twin; without one the port warns
as JAX does.  The port checks the flags before stage B, JAX after it: the
result is the same.

Each half is a root span of `utils.profiler` (`scoring.start`,
`scoring.wait`), and the layers under them are its children: the
segmentation backend's, `extract.stage_a`, `scoring.copy_out`;
`scoring.flags`, `scoring.fallback`, one `extract.bucket` a size bucket
(`clahe.bucket`, then a chunk's `stage_b.replay` on the card, its
`resize.chunk` and `scoring.score_cells` elsewhere), `scoring.fetch`.
The counters `chunks`, `stage_b.graph_chunks` (the chunks replayed),
`stage_b.eager_chunks` (the others) and `stage_b.captures` (graphs
captured) say how often the graphs engage.  The start half draws the
batch id and the handle carries it, so both halves' spans share it.  The
first B ints of the handle's host copy are each frame's overflow
reasons, a bitmask (`ops.extract.OVERFLOW_REASONS`), nonzero where a
capacity flag fired; the counters `fallback.batches` and
`fallback.<reason>` read it.
"""

from __future__ import annotations

import functools
import warnings
from collections import OrderedDict
from contextlib import nullcontext
from typing import NamedTuple

import numpy as np
import torch

from cell_image_analysis_tpu_torch.models.ensemble import ensemble_votes
from cell_image_analysis_tpu_torch.models.svm import SVMParams, decision_function
from cell_image_analysis_tpu_torch.ops.clahe import bucket_caps
from cell_image_analysis_tpu_torch.ops.extract import (
    OVERFLOW_REASONS,
    clahe_buckets,
    stage_a_reasons,
)
from cell_image_analysis_tpu_torch.ops.fft_features import fft_features
from cell_image_analysis_tpu_torch.ops.resize import resize_cells
from cell_image_analysis_tpu_torch.utils.profiler import count, new_batch, span


class ScoringParams(NamedTuple):
    """The fitted scoring state (the CAE module is passed separately)."""

    scaler_center: torch.Tensor          # (2048,)
    scaler_scale: torch.Tensor           # (2048,)
    pca_mean: torch.Tensor               # (2048,)
    pca_components: torch.Tensor         # (K, 2048)
    svm_conservative: SVMParams
    svm_moderate: SVMParams
    ensemble_mse_threshold: torch.Tensor  # ()
    fft_scaler_center: torch.Tensor      # (F,)
    fft_scaler_scale: torch.Tensor       # (F,)
    svm_fft: SVMParams


class CellScores(NamedTuple):
    reconstruction_mse: torch.Tensor
    reconstruction_mae: torch.Tensor
    conservative_predictions: torch.Tensor  # int32 {+1, -1}
    moderate_predictions: torch.Tensor
    conservative_scores: torch.Tensor       # negated decision function
    moderate_scores: torch.Tensor
    ensemble_predictions: torch.Tensor
    fft_predictions: torch.Tensor
    fft_scores: torch.Tensor
    fft: torch.Tensor                       # (B, F)


def _pm1(d: torch.Tensor) -> torch.Tensor:
    return torch.where(d > 0, 1, -1).int()


@torch.inference_mode()
def score_cells(model, params: ScoringParams, X: torch.Tensor, min_votes: int = 2) -> CellScores:
    """Score a (B, 64, 64, 1) batch of preprocessed cells."""
    X = X.float()
    recon, encoded = model(X)
    diff = X - recon
    mse = torch.mean(diff * diff, dim=(1, 2, 3))
    mae = torch.mean(torch.abs(diff), dim=(1, 2, 3))

    feats = encoded.reshape(encoded.shape[0], -1)
    scaled = (feats - params.scaler_center) / params.scaler_scale
    reduced = torch.matmul(scaled - params.pca_mean, params.pca_components.T)
    d_cons = decision_function(params.svm_conservative, reduced)
    d_mod = decision_function(params.svm_moderate, reduced)
    p_cons, p_mod = _pm1(d_cons), _pm1(d_mod)
    votes = ensemble_votes(mse, p_cons, p_mod, params.ensemble_mse_threshold)
    p_ens = torch.where(votes >= min_votes, -1, 1).int()

    fft = fft_features(X)
    d_fft = decision_function(params.svm_fft,
                              (fft - params.fft_scaler_center) / params.fft_scaler_scale)
    return CellScores(
        reconstruction_mse=mse, reconstruction_mae=mae,
        conservative_predictions=p_cons, moderate_predictions=p_mod,
        conservative_scores=-d_cons, moderate_scores=-d_mod,
        ensemble_predictions=p_ens, fft_predictions=_pm1(d_fft), fft_scores=-d_fft,
        fft=fft,
    )


_FUSED_D = 9 + 16 + 8 + 3
_SCORE_KEYS = ("reconstruction_mse", "reconstruction_mae", "conservative_predictions",
               "moderate_predictions", "conservative_scores", "moderate_scores",
               "ensemble_predictions", "fft_predictions", "fft_scores")
_RATES = ("conservative", "moderate", "ensemble", "fft")


def _score_rows(s: CellScores) -> torch.Tensor:
    cols = [s.reconstruction_mse, s.reconstruction_mae, s.conservative_predictions,
            s.moderate_predictions, s.conservative_scores, s.moderate_scores,
            s.ensemble_predictions, s.fft_predictions, s.fft_scores]
    return torch.cat([torch.stack([c.float() for c in cols], dim=1), s.fft], dim=1)


def score_frames_fused(model, params: ScoringParams, segs: torch.Tensor, greens: torch.Tensor,
                       segment_fn, chunk: int = 256, caps: tuple = (64, 96), min_votes: int = 2,
                       out_size: int = 64, clip_limit: float = 0.02, mesh=None,
                       fallback_segment_fn=None, **candidate_kwargs) -> tuple:
    """Screen a (B, H, W) frame batch; returns (scores dict, stats dict) of
    numpy arrays, as JAX `score_frames_fused_wait`.  With a `mesh` the
    frames are split over its shards (see `score_frames_fused_start`)."""
    return score_frames_fused_wait(score_frames_fused_start(
        model, params, segs, greens, segment_fn, chunk=chunk, caps=caps, min_votes=min_votes,
        out_size=out_size, clip_limit=clip_limit, mesh=mesh,
        fallback_segment_fn=fallback_segment_fn, **candidate_kwargs))


def score_frames(model, params: ScoringParams, segs: torch.Tensor, greens: torch.Tensor,
                 segment_fn, chunk: int = 128, small_cap: int = 96, min_votes: int = 2,
                 out_size: int = 64, clip_limit: float = 0.02, mesh=None,
                 fallback_segment_fn=None, **candidate_kwargs) -> tuple:
    """The chunked form of `score_frames_fused` (JAX `score_frames`): two
    size buckets, cells with both sides <= `small_cap` and the rest at the
    full crop capacity, resized and scored `chunk` cells a call, returned
    when done.  The buckets only pad the layout, so it gives the fused
    path's results; with a `mesh` the frames are split over its shards."""
    return score_frames_fused(model, params, segs, greens, segment_fn, chunk=chunk,
                              caps=(small_cap,), min_votes=min_votes, out_size=out_size,
                              clip_limit=clip_limit, mesh=mesh,
                              fallback_segment_fn=fallback_segment_fn, **candidate_kwargs)


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """A host copy of `t`; from the card it goes into pinned memory without
    waiting (the caller records an event behind it)."""
    if t.device.type == "cpu":
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host


@torch.inference_mode()
def score_frames_fused_start(model, params: ScoringParams, segs: torch.Tensor,
                             greens: torch.Tensor, segment_fn, chunk: int = 256,
                             caps: tuple = (64, 96), min_votes: int = 2, out_size: int = 64,
                             clip_limit: float = 0.02, mesh=None, fallback_segment_fn=None,
                             batch_id: int | None = None, **candidate_kwargs) -> dict:
    """The dispatch half of `score_frames_fused`: enqueues segmentation and
    stage A of the batch, begins the copies of the small per-cell arrays
    that the host needs next (overflow flags, heights, widths, valid, the
    statistics) into pinned memory behind a CUDA event, and returns a
    pending handle without waiting for them.  `score_frames_fused_wait`
    takes the handle.  A caller with many batches starts batch k+1 before
    it waits on batch k, so that the host's part of k overlaps the device's
    stage A of k+1.

    With a `mesh` (`parallel.mesh`) the batch is padded with zero frames to
    a multiple of the mesh (they give no cell: the intensity gates fail on
    zeros), split into one part a shard, and each part goes through this
    single-device half on its shard's device, with the replicas of
    `model`, `params` and `segment_fn` there (`parallel.sharding.replicate`;
    pass them replicated to keep the copies): every shard runs the whole
    fused body on its own frames, with no exchange between shards.

    `batch_id` names the batch in the spans (`utils.profiler`); None draws
    a new one.  A shard's call and a fallback's re-run pass their batch's."""
    if batch_id is None:
        batch_id = new_batch()
        count("batches")
    with span("scoring.start", batch=batch_id):
        return _start(model, params, segs, greens, segment_fn, chunk, caps, min_votes, out_size,
                      clip_limit, mesh, fallback_segment_fn, batch_id, candidate_kwargs)


def _start(model, params, segs, greens, segment_fn, chunk, caps, min_votes, out_size,
           clip_limit, mesh, fallback_segment_fn, batch_id, candidate_kwargs) -> dict:
    common = dict(chunk=chunk, caps=caps, min_votes=min_votes, out_size=out_size,
                  clip_limit=clip_limit, candidate_kwargs=candidate_kwargs, batch=batch_id)
    from cell_image_analysis_tpu_torch.parallel.distributed import GlobalMesh, process_local_rows

    if isinstance(mesh, GlobalMesh):
        # zero frames to a multiple of the global shards, then this
        # process's rows of the batch, through its own shards
        n, pad = int(segs.shape[0]), (-int(segs.shape[0])) % mesh.shape["data"]
        padded = [torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))]) if pad else x
                  for x in (segs, greens)]
        local = [process_local_rows(x, mesh) for x in padded]
        pend = score_frames_fused_start(model, params, *local, segment_fn, chunk=chunk,
                                        caps=caps, min_votes=min_votes, out_size=out_size,
                                        clip_limit=clip_limit, mesh=mesh.local,
                                        fallback_segment_fn=fallback_segment_fn,
                                        batch_id=batch_id, **candidate_kwargs)
        pend.update(mesh=mesh, segs0=segs, greens0=greens, n_frames=n,
                    offset=mesh.rank * local[0].shape[0])
        return pend
    if mesh is not None:
        from cell_image_analysis_tpu_torch.parallel.sharding import replicate, shard_batch

        models, paramss, fns = (replicate(mesh, x) for x in (model, params, segment_fn))
        seg_parts, green_parts = shard_batch(mesh, segs), shard_batch(mesh, greens)
        shards = [score_frames_fused_start(m, p, s, g, fn, chunk=chunk, caps=caps,
                                           min_votes=min_votes, out_size=out_size,
                                           clip_limit=clip_limit, batch_id=batch_id,
                                           **candidate_kwargs)
                  for m, p, s, g, fn in zip(models, paramss, seg_parts, green_parts, fns)]
        return dict(common, model=model, params=params, segs0=segs, greens0=greens, mesh=mesh,
                    fallback_segment_fn=fallback_segment_fn, shards=shards,
                    n_frames=int(segs.shape[0]))
    cand, reasons, _ = stage_a_reasons(segment_fn, segs, greens, candidate_kwargs)
    B, ccap, full_cap = cand.crops.shape[:3]
    count("slots", B * ccap)
    with span("scoring.copy_out"):
        flat = [t.reshape(-1) for t in (cand.heights, cand.widths, cand.valid, cand.label_ids,
                                        cand.area)]
        # each frame's overflow reasons, the slots' ints, each frame's
        # geometry-passing labels
        ints = _to_host(torch.cat([reasons.int(), *(t.int() for t in flat),
                                   cand.n_geometry.int()]))
        floats = _to_host(torch.cat([t.reshape(-1).float() for t in (
            cand.eccentricity, cand.mean_intensity, cand.std_intensity)]))
        event = None
        if segs.device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(segs.device))
        crops = cand.crops.reshape(B * ccap, full_cap, full_cap).float().contiguous()
    return dict(
        common, model=model, params=params, segs0=segs, greens0=greens, mesh=None,
        fallback_segment_fn=fallback_segment_fn, crops=crops, heights=flat[0].int(),
        widths=flat[1].int(), ints=ints, floats=floats, event=event, shape=(B, ccap, full_cap))


def _overflowed(pend: dict) -> tuple:
    """Waits for the handle's host copies; (True if a capacity flag fired
    in any frame of any shard, of any process where the mesh spans them,
    the OR of this process's frames' overflow reasons)."""
    from cell_image_analysis_tpu_torch.parallel.distributed import GlobalMesh, any_process

    shards = pend.get("shards") or [pend]
    with span("scoring.flags"):
        for sh in shards:
            count("host_waits.flags")
            if sh["event"] is not None:
                sh["event"].synchronize()
    reasons = 0
    for sh in shards:
        reasons |= int(np.bitwise_or.reduce(sh["ints"][:sh["shape"][0]].numpy()))
    fired = reasons != 0
    return (any_process(fired) if isinstance(pend["mesh"], GlobalMesh) else fired), reasons


def _chunk_rows(model, params: ScoringParams, eq: torch.Tensor, heights: torch.Tensor,
                widths: torch.Tensor, out_size: int, min_votes: int) -> torch.Tensor:
    """The (C, D) score rows of C CLAHE'd crops `eq` (C, cap, cap) with
    sides (C,): resize, `score_cells`, `_score_rows`.  Stage B's chunk,
    eager or captured in a `_ChunkGraph`."""
    with span("resize.chunk"):
        cells = resize_cells(eq, heights, widths, out_size=out_size)
    with span("scoring.score_cells"):
        return _score_rows(score_cells(model, params, cells[..., None], min_votes=min_votes))


def _padded_chunk_rows(model, params: ScoringParams, eq: torch.Tensor, heights: torch.Tensor,
                       widths: torch.Tensor, chunk: int, out_size: int,
                       min_votes: int) -> torch.Tensor:
    """`_chunk_rows` of n <= chunk crops padded to `chunk` rows (zero crops
    of the full side), as a `_ChunkGraph` computes them; the n real rows."""
    n, cap = eq.shape[0], eq.shape[-1]
    if n < chunk:
        eq = torch.cat([eq, eq.new_zeros((chunk - n, cap, cap))])
        heights, widths = (torch.cat([s, s.new_full((chunk - n,), cap)])
                           for s in (heights, widths))
    return _chunk_rows(model, params, eq, heights, widths, out_size, min_votes)[:n]


class _ChunkGraph:
    """`_chunk_rows` of `chunk` crops at one bucket cap, captured once as a
    CUDA graph: static inputs (crops, and sides in two rows), the graph and
    its output rows.  A replay reads the model's and the params' memory, so
    it sees their in-place updates.  Rows past a short chunk keep the
    previous chunk's inputs (at first zero crops of the full side)."""

    def __init__(self, model, params: ScoringParams, chunk: int, cap: int, out_size: int,
                 min_votes: int, device: torch.device, stream, pool):
        self.eq = torch.zeros((chunk, cap, cap), dtype=torch.float32, device=device)
        self.sides = torch.full((2, chunk), cap, dtype=torch.int32, device=device)

        def body():
            return _chunk_rows(model, params, self.eq, self.sides[0], self.sides[1], out_size,
                               min_votes)

        # warm-up on the capture stream: cuDNN's and cuFFT's plans, the
        # FFT geometry, outside the capture
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            for _ in range(2):
                body()
        torch.cuda.current_stream(device).wait_stream(stream)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, pool=pool, stream=stream,
                              capture_error_mode="thread_local"):
            self.out = body()
        count("stage_b.captures")

    def replay(self, eq: torch.Tensor, sides: torch.Tensor) -> torch.Tensor:
        """The rows of n <= chunk crops `eq` (n, cap, cap) with `sides`
        (2, n) int32; valid until the next replay."""
        n = eq.shape[0]
        self.eq[:n].copy_(eq)
        self.sides[:, :n].copy_(sides)
        self.graph.replay()
        return self.out[:n]


class _GraphFamily(NamedTuple):
    """The chunk graphs of one (device, chunk, out_size, min_votes, model,
    params), a graph a bucket cap, in one memory pool; it holds the model
    and the params, so that their ids are not reused while it lives."""

    model: object
    params: ScoringParams
    pool: object
    graphs: dict


_GRAPH_FAMILIES: OrderedDict = OrderedDict()
_MAX_GRAPH_FAMILIES = 8


@functools.lru_cache(maxsize=None)
def _capture_stream(device: torch.device):
    """One side stream a device for every warm-up and capture: cuBLAS keeps
    a workspace (32 MiB on the H100) for each stream it runs on."""
    return torch.cuda.Stream(device)


def _chunk_graphs(pend: dict, device: torch.device, caps: tuple):
    """cap -> `_ChunkGraph` for each of `caps` on `device`, or None where
    the chunks run eagerly: CPU tensors, or a capture already under way.
    Every missing cap is captured at once, so a handle's first batch
    captures all its buckets, rare ones included."""
    model, params = pend["model"], pend["params"]
    if device.type != "cuda" or torch.cuda.is_current_stream_capturing():
        return None
    key = (device, pend["chunk"], pend["out_size"], pend["min_votes"], id(model), id(params))
    fam = _GRAPH_FAMILIES.pop(key, None)
    if fam is None:
        fam = _GraphFamily(model, params, torch.cuda.graph_pool_handle(), {})
    _GRAPH_FAMILIES[key] = fam
    while len(_GRAPH_FAMILIES) > _MAX_GRAPH_FAMILIES:
        _GRAPH_FAMILIES.popitem(last=False)
    with torch.cuda.device(device):
        for cap in caps:
            if cap not in fam.graphs:
                fam.graphs[cap] = _ChunkGraph(model, params, pend["chunk"], cap,
                                              pend["out_size"], pend["min_votes"], device,
                                              _capture_stream(device), fam.pool)
    return fam.graphs


def _bucket_rows(pend: dict) -> torch.Tensor:
    """Launches the size-bucket loop (CLAHE, then resize and `score_cells`
    `chunk` cells at a time) of one device's handle; returns its (N, D)
    score rows on the device.  Each bucket's last chunk is padded to
    `chunk` rows; on the card each chunk is a replay of its cap's
    `_ChunkGraph` (span `stage_b.replay`), elsewhere `_chunk_rows` runs
    eagerly, unpadded where the CAE is in train mode."""
    B, ccap, full_cap = pend["shape"]
    N = B * ccap
    heights_h, widths_h, valid_h = (pend["ints"][B + k * N:B + (k + 1) * N] for k in range(3))
    crops, heights, widths = pend["crops"], pend["heights"], pend["widths"]
    model, params, chunk = pend["model"], pend["params"], pend["chunk"]
    out_size, min_votes = pend["out_size"], pend["min_votes"]
    rows = torch.zeros((N, _FUSED_D), dtype=torch.float32, device=crops.device)
    # a CAE in train mode runs eagerly and unpadded: its BatchNorm
    # statistics would see the padding rows
    train = any(m.training for m in model.modules())
    graphs = None if train else _chunk_graphs(pend, crops.device,
                                              bucket_caps(pend["caps"], full_cap))
    with torch.cuda.device(crops.device) if graphs is not None else nullcontext():
        for idx, cap_b, eq_all in clahe_buckets(crops, heights, widths, heights_h, widths_h,
                                                valid_h.bool(), caps=pend["caps"],
                                                clip_limit=pend["clip_limit"]):
            if graphs is not None:
                sides = torch.stack([heights, widths])[:, idx]
            for start in range(0, idx.numel(), chunk):
                count("chunks")
                ids = idx[start:start + chunk]
                eq = eq_all[start:start + chunk]
                if graphs is not None:
                    count("stage_b.graph_chunks")
                    with span("stage_b.replay"):
                        rows[ids] = graphs[cap_b].replay(eq, sides[:, start:start + chunk])
                    continue
                count("stage_b.eager_chunks")
                rows[ids] = _padded_chunk_rows(model, params, eq, heights[ids], widths[ids],
                                               len(ids) if train else chunk, out_size,
                                               min_votes)
    return rows


def _decode(pend: dict, rows: torch.Tensor) -> tuple:
    """Fetches one device's valid rows (the one fetch): (packed score rows,
    (n, D) float32, stats dict), both numpy.  The stats' `bbox_height` and
    `bbox_width` are the sides of the crop box CLAHE read, from the host
    copy."""
    B, ccap, _ = pend["shape"]
    N = B * ccap
    ints, floats = pend["ints"], pend["floats"]
    heights_h, widths_h, valid_h, label_ids, area = (ints[B + k * N:B + (k + 1) * N]
                                                     for k in range(5))
    pool = torch.nonzero(valid_h.bool()).flatten()
    count("slots.valid", pool.numel())
    stats_h = dict(label_ids=label_ids, area=area, eccentricity=floats[:N],
                   mean_intensity=floats[N:2 * N], std_intensity=floats[2 * N:],
                   bbox_height=heights_h, bbox_width=widths_h)
    stats = {k: v[pool].numpy() for k, v in stats_h.items()}
    stats["frame_index"] = (pool // ccap).numpy()
    with span("scoring.fetch"):
        count("host_waits.fetch")
        packed = rows[pool.to(rows.device, non_blocking=True)].cpu().numpy()   # the one fetch
    return packed, stats


def _result(packed: np.ndarray, stats: dict) -> tuple:
    """(scores dict, stats dict); the scores are {} where no cell was found."""
    return ({}, stats) if packed.shape[0] == 0 else (_scores_dict(packed), stats)


def _scores_dict(packed: np.ndarray) -> dict:
    out = {k: packed[:, i] for i, k in enumerate(_SCORE_KEYS)}
    for k in _SCORE_KEYS:
        if k.endswith("_predictions"):
            out[k] = out[k].astype(np.int32)
    out["fft_features"] = packed[:, len(_SCORE_KEYS):]
    return _with_rates(out)


def _with_rates(out: dict) -> dict:
    for name in _RATES:
        out[f"{name}_anomaly_rate"] = float(np.mean(out[f"{name}_predictions"] == -1))
    return out


def _merge_shards(parts: list, b_local: int, n_frames: int, offset: int) -> tuple:
    """The shards' (packed, stats) in shard order, frame indices offset by
    offset + s * b_local (the process's first frame in the batch, and the
    shard's); the padding frames' rows (none in practice) are dropped."""
    packed = np.concatenate([p for p, _ in parts])
    stats = {k: np.concatenate([st[k] for _, st in parts]) for k in parts[0][1]}
    stats["frame_index"] = np.concatenate([st["frame_index"] + offset + s * b_local
                                           for s, (_, st) in enumerate(parts)])
    keep = stats["frame_index"] < n_frames
    return packed[keep], {k: v[keep] for k, v in stats.items()}


_INT_STATS = ("label_ids", "area", "frame_index", "bbox_height", "bbox_width")


def _gather_processes(packed: np.ndarray, stats: dict) -> tuple:
    """Every process's (packed, stats) in rank order (collectives: every
    process calls), the integer statistics sent as int64."""
    from cell_image_analysis_tpu_torch.parallel.distributed import process_allgather

    floats = [k for k in stats if k not in _INT_STATS]
    ints = process_allgather(np.stack([stats[k].astype(np.int64) for k in _INT_STATS], axis=1))
    flts = process_allgather(np.stack([stats[k] for k in floats], axis=1))
    got = {k: ints[:, i].astype(stats[k].dtype) for i, k in enumerate(_INT_STATS)}
    got.update({k: flts[:, i] for i, k in enumerate(floats)})
    return process_allgather(packed), {k: got[k] for k in stats}


@torch.inference_mode()
def score_frames_fused_wait(pend: dict) -> tuple:
    """The fetch half of `score_frames_fused`: waits for the handle's host
    copies, takes the overflow decision (the fallback re-runs the batch
    synchronously, on the mesh where there is one), runs the size-bucket
    loop (CLAHE, resize, `score_cells`) and fetches the scored rows once.
    Returns (scores dict, stats dict) of numpy arrays, as JAX
    `score_frames_fused_wait`.  On a mesh the flags of every shard are
    read first, then every shard's bucket loop is launched, then each
    shard's rows are fetched, and the shards merge with frame offsets; on
    a mesh that spans processes the flags of every process decide, and the
    processes' rows are all-gathered."""
    with span("scoring.wait", batch=pend.get("batch")):
        packed, stats = _wait(pend)
    count("cells.scored", packed.shape[0])
    return _result(packed, stats)


def _wait(pend: dict) -> tuple:
    """`score_frames_fused_wait`'s (packed rows, stats), numpy."""
    from cell_image_analysis_tpu_torch.parallel.distributed import GlobalMesh

    fired, reasons = _overflowed(pend)
    if fired:
        if pend["fallback_segment_fn"] is not None:
            count("fallback.batches")
            for bit, name in enumerate(OVERFLOW_REASONS):
                if reasons >> bit & 1:
                    count(f"fallback.{name}")
            # the handle keeps the re-run's for `frame_geometry`
            with span("scoring.fallback"):
                pend["rerun"] = score_frames_fused_start(
                    pend["model"], pend["params"], pend["segs0"], pend["greens0"],
                    pend["fallback_segment_fn"], chunk=pend["chunk"], caps=pend["caps"],
                    min_votes=pend["min_votes"], out_size=pend["out_size"],
                    clip_limit=pend["clip_limit"], mesh=pend["mesh"], batch_id=pend["batch"],
                    **pend["candidate_kwargs"])
                with span("scoring.wait"):
                    return _wait(pend["rerun"])
        count("overflow.no_fallback")
        warnings.warn(
            "score_frames_fused: capacity overflow with no fallback_segment_fn — "
            "candidate extraction may have dropped or corrupted cells; pass "
            "fallback_segment_fn or raise the capacity (rcap; for the StarDist "
            "backend also max_candidates, raster_m_cap and nms_max_pairs)",
            RuntimeWarning, stacklevel=2)
    shards = pend.get("shards")
    if shards is None:
        return _decode(pend, _bucket_rows(pend))
    rows = [_bucket_rows(sh) for sh in shards]
    parts = [_decode(sh, r) for sh, r in zip(shards, rows)]
    packed, stats = _merge_shards(parts, shards[0]["shape"][0], pend["n_frames"],
                                  pend.get("offset", 0))
    if isinstance(pend["mesh"], GlobalMesh):
        # every process sends, even one that holds padding frames only
        packed, stats = _gather_processes(packed, stats)
    return packed, stats


def frame_geometry(pend: dict) -> np.ndarray:
    """Each frame's geometry-passing labels in a handle that
    `score_frames_fused_wait` took (of the exact twin's pass where the
    batch fell back), as (B,) int32: stage A keeps the first
    `cell_capacity` of them, so a count at or above the capacity means the
    frame may have lost cells without a flag.  A handle of one device."""
    pend = pend.get("rerun", pend)
    if pend["mesh"] is not None:
        raise ValueError("frame_geometry: a handle of one device, not of a mesh")
    return pend["ints"][-pend["shape"][0]:].numpy()


def compute_anomaly_scores(model, params: ScoringParams, cells, valid=None,
                           min_votes: int = 2) -> dict:
    """`score_cells` on (n, 64, 64) or (n, 64, 64, 1) host cells, on the
    device of `params`, as a dict of numpy arrays with the reference's
    schema plus the ensemble and FFT entries.  `valid` optionally masks
    padding; rates are over the valid entries only.

    `cells` may be a sharded chunk instead, one tensor a shard
    (`parallel.sharding.shard_batch`), with `model` and `params` replicated
    over the same mesh (`parallel.sharding.replicate`): every shard is
    scored on its device before any is fetched, and the rows come back in
    shard order."""
    if not isinstance(cells, (list, tuple)):
        cells, model, params = [cells], [model], [params]
    X = [torch.as_tensor(np.asarray(c, dtype=np.float32) if not isinstance(c, torch.Tensor)
                         else c, device=p.pca_mean.device).float() for c, p in zip(cells, params)]
    X = [x[..., None] if x.dim() == 3 else x for x in X]
    if sum(x.shape[0] for x in X) == 0:
        return {}
    parts = [score_cells(m, p, x, min_votes=min_votes) for m, p, x in zip(model, params, X)]
    host = {k: np.concatenate([getattr(s, k).cpu().numpy() for s in parts])
            for k in (*_SCORE_KEYS, "fft")}
    v = np.ones(len(host["fft"]), bool) if valid is None else np.asarray(valid, bool)
    n = max(int(v.sum()), 1)
    out = {k: host[k][v] for k in _SCORE_KEYS}
    out["fft_features"] = host["fft"][v]
    for name in _RATES:
        out[f"{name}_anomaly_rate"] = float(np.sum((host[f"{name}_predictions"] == -1) & v) / n)
    return out

