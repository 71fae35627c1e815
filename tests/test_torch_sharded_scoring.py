"""PyTorch port: the mesh (`parallel.mesh`, `parallel.sharding`) and the
sharded scoring paths, on `virtual_mesh("cpu", 4)`.

- `make_mesh` and `make_mesh_2d` raise without a GPU; a virtual mesh's
  shape and devices; `virtual_mesh_2d`'s shape, axes and device grid equal
  JAX `make_mesh_2d`'s on 4 of its virtual CPU devices;
  `replicate` shares one copy a device, and the home copy is the object
  itself; `shard_batch` / `pad_to_multiple` zero-pad to a multiple;
  `masked_anomaly_rate` sums its counts over the shards;
- `score_frames_fused` and `score_frames` with a mesh, B = 3 (one zero
  padding frame), against the port without a mesh at
  `tests/test_sharded_scoring.py`'s contract (frame_index and areas equal,
  floats within 1e-5, predictions and rates equal), and against JAX's with
  a mesh of 4 of its virtual CPU devices (the same cells and areas, scores
  within 1e-4, predictions equal except within 1e-4 of a threshold:
  `utils.parity.compare_screens`, as `tests/test_torch_pipeline.py`);
  JAX's non-fused `score_frames` needs B a multiple of the mesh, so that
  comparison runs at B = 4;
- a batch whose run-table flag fires in one shard only re-runs the whole
  batch, every shard, through the exact twin: the result equals the twin's
  own sharded run;
- `compute_anomaly_scores` on a sharded chunk equals the unsharded call.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import jax_scoring, torch_threads

from cell_image_analysis_tpu_torch.io.artifacts import load_scoring_params
from cell_image_analysis_tpu_torch.models.segmentation import ThresholdBackend
from cell_image_analysis_tpu_torch.parallel import mesh as mesh_mod
from cell_image_analysis_tpu_torch.parallel.mesh import (
    make_mesh,
    make_mesh_2d,
    virtual_mesh,
    virtual_mesh_2d,
)
from cell_image_analysis_tpu_torch.parallel.sharding import (
    Replicated,
    masked_anomaly_rate,
    pad_to_multiple,
    replicate,
    shard_batch,
)
from cell_image_analysis_tpu_torch.pipeline.scoring import (
    compute_anomaly_scores,
    score_frames,
    score_frames_fused,
)
from cell_image_analysis_tpu_torch.utils.parity import compare_screens

torch_threads()

KW = dict(chunk=16, cell_capacity=32)
N_SHARDS = 4


def _frames(seed, n_cells):
    from cell_image_analysis_tpu.utils.synthetic import make_frame

    rng = np.random.default_rng(seed)
    f = np.stack([make_frame(rng, size=256, n_cells=n) for n in n_cells])
    return f[..., 2].astype(np.float32), f[..., 1].astype(np.float32)


@pytest.fixture(scope="module")
def scoring():
    return load_scoring_params(device="cpu")


def test_make_mesh_raises_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        virtual_mesh("cuda", 2)


def test_make_mesh_2d_raises_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh_2d((2, 2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        virtual_mesh_2d("cuda", (2, 2))


@pytest.mark.parametrize("shape, axes", [((2, 2), ("data", "model")), ((4, 1), ("x", "y")),
                                         ((1, 4), ("data", "model"))])
def test_make_mesh_2d_matches_jax(shape, axes):
    from cell_image_analysis_tpu.parallel.mesh import make_mesh_2d as jax_mesh_2d

    ref = jax_mesh_2d(shape, axes)
    got = virtual_mesh_2d("cpu", shape, axes)
    assert got.shape == dict(ref.shape) and list(got.shape) == list(ref.shape)
    assert got.axis_names == tuple(ref.axis_names)
    assert got.devices.shape == ref.devices.shape == shape
    assert all(d == torch.device("cpu") for d in got.devices.flat)
    with pytest.raises(ValueError):
        virtual_mesh_2d("cpu", shape, axes[:1])


def test_virtual_mesh_and_replicate(scoring):
    model, params = scoring
    mesh = virtual_mesh("cpu", N_SHARDS)
    assert mesh.shape == {"data": N_SHARDS} and mesh.home == torch.device("cpu")
    assert mesh.devices == (torch.device("cpu"),) * N_SHARDS and mesh.distinct == (mesh.home,)
    for obj in (model, params, ThresholdBackend()):
        reps = replicate(mesh, obj)
        assert isinstance(reps, Replicated) and len(reps) == N_SHARDS
        assert all(r is obj for r in reps)
        assert replicate(mesh, reps) is reps
    with pytest.raises(ValueError):
        replicate(virtual_mesh("cpu", 2), replicate(mesh, model))
    assert mesh_mod.canonical_device("cpu") == torch.device("cpu")


def test_shard_batch_pads_to_a_multiple():
    x = np.arange(5 * 2, dtype=np.float32).reshape(5, 2)
    parts = shard_batch(virtual_mesh("cpu", 4), x)
    assert [tuple(p.shape) for p in parts] == [(2, 2)] * 4
    assert torch.equal(torch.cat(parts)[:5], torch.from_numpy(x))
    assert not torch.cat(parts)[5:].any()
    padded, valid = pad_to_multiple(x, 4)
    assert padded.shape == (8, 2) and valid.tolist() == [True] * 5 + [False] * 3
    np.testing.assert_array_equal(padded, torch.cat(parts).numpy())


def test_masked_anomaly_rate_sums_over_the_shards():
    preds = [torch.tensor([-1, 1, -1]), torch.tensor([1, -1, -1])]
    valid = [torch.tensor([True, True, False]), torch.tensor([True, True, True])]
    assert masked_anomaly_rate(preds, valid) == 3 / 5
    assert masked_anomaly_rate(torch.cat(preds), torch.cat(valid)) == 3 / 5
    assert masked_anomaly_rate([torch.tensor([1])], [torch.tensor([False])]) == 0.0


def _assert_sharded_equal(ref, out):
    (r, rs), (o, os_) = ref, out
    np.testing.assert_array_equal(rs["frame_index"], os_["frame_index"])
    np.testing.assert_array_equal(rs["area"], os_["area"])
    assert r.keys() == o.keys()
    for k in r:
        if k.endswith("_rate"):
            assert r[k] == o[k], k
        elif k.endswith("_predictions"):
            np.testing.assert_array_equal(o[k], r[k], err_msg=k)
        else:
            np.testing.assert_allclose(o[k], r[k], atol=1e-5, err_msg=k)


def _assert_close_to_jax(ref, got, params, min_cells):
    report = compare_screens(ref, got, {}, float(params.ensemble_mse_threshold))
    assert report["n_cells"] >= min_cells
    for k in ("conservative", "moderate", "ensemble", "fft"):
        if not report["near_threshold"][k]:
            assert got[0][f"{k}_anomaly_rate"] == ref[0][f"{k}_anomaly_rate"], k


@pytest.mark.parametrize("fn", [score_frames_fused, score_frames])
def test_sharded_scoring_matches_unsharded_at_b3(fn, scoring):
    model, params = scoring
    segs, greens = (torch.from_numpy(a) for a in _frames(0, (8, 8, 8)))
    twin = ThresholdBackend().exact_twin()
    ref = fn(model, params, segs, greens, twin, **KW)
    out = fn(model, params, segs, greens, twin, mesh=virtual_mesh("cpu", N_SHARDS), **KW)
    assert len(ref[1]["area"]) >= 12 and ref[1]["frame_index"].max() == 2
    _assert_sharded_equal(ref, out)


@pytest.mark.parametrize("n_frames", [3, 4])
def test_sharded_fused_matches_jax_with_a_mesh(n_frames, scoring):
    from cell_image_analysis_tpu.models.segmentation import threshold_segment
    from cell_image_analysis_tpu.parallel.mesh import make_mesh as jax_mesh
    from cell_image_analysis_tpu.pipeline.scoring import score_frames as jax_score_frames
    from cell_image_analysis_tpu.pipeline.scoring import score_frames_fused as jax_fused

    model, params = scoring
    model_j, params_j = jax_scoring()
    segs, greens = _frames(1, (8,) * n_frames)
    mesh = virtual_mesh("cpu", N_SHARDS)
    twin = ThresholdBackend().exact_twin()
    args_t = (model, params, torch.from_numpy(segs), torch.from_numpy(greens), twin)
    args_j = (model_j, params_j, jnp.asarray(segs), jnp.asarray(greens), threshold_segment)
    ref = jax_fused(*args_j, mesh=jax_mesh(N_SHARDS), **KW)
    _assert_close_to_jax(ref, score_frames_fused(*args_t, mesh=mesh, **KW), params, 12)
    if n_frames % N_SHARDS == 0:
        ref = jax_score_frames(*args_j, mesh=jax_mesh(N_SHARDS), **KW)
        _assert_close_to_jax(ref, score_frames(*args_t, mesh=mesh, **KW), params, 12)


class _Recording:
    """A segment_fn wrapper that counts its calls and frames."""

    def __init__(self, fn):
        self.fn, self.frames = fn, []

    def __call__(self, x):
        self.frames.append(x.shape[0])
        return self.fn(x)


def test_overflow_in_one_shard_reruns_the_whole_batch(scoring):
    from cell_image_analysis_tpu_torch.ops.extract import stage_a

    model, params = scoring
    segs, greens = (torch.from_numpy(a) for a in _frames(1, (6, 6, 30, 6)))
    backend = ThresholdBackend()
    kw = dict(KW, rcap=5, label_capacity=1024)
    _, ovf, _ = stage_a(backend, segs, greens, {k: v for k, v in kw.items() if k != "chunk"})
    assert ovf.tolist() == [True, False, False, False]      # shard 0 only
    mesh = virtual_mesh("cpu", N_SHARDS)
    twin = _Recording(backend.exact_twin())
    got = score_frames_fused(model, params, segs, greens, backend, mesh=mesh,
                             fallback_segment_fn=twin, **kw)
    assert twin.frames == [1] * N_SHARDS                     # every shard re-ran
    ref = score_frames_fused(model, params, segs, greens, backend.exact_twin(), mesh=mesh, **kw)
    for a, b in zip(ref, got):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    with pytest.warns(RuntimeWarning, match="capacity overflow"):
        score_frames_fused(model, params, segs, greens, backend, mesh=mesh, **kw)


def test_compute_anomaly_scores_on_a_sharded_chunk(scoring):
    model, params = scoring
    cells = np.random.default_rng(3).uniform(size=(10, 64, 64)).astype(np.float32)
    mesh = virtual_mesh("cpu", N_SHARDS)
    padded, valid = pad_to_multiple(cells, 12)
    ref = compute_anomaly_scores(model, params, cells)
    got = compute_anomaly_scores(replicate(mesh, model), replicate(mesh, params),
                                 shard_batch(mesh, padded), valid=valid)
    assert ref.keys() == got.keys()
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], atol=1e-6, err_msg=k)
