"""PyTorch port: stage B's fixed-shape chunks (`pipeline/scoring._bucket_rows`).

Each size bucket's chunks are `chunk` rows, the last one padded; on the
card a chunk is one replay of a CUDA graph captured once a bucket cap
(`_ChunkGraph`), elsewhere the same function runs eagerly.

On the CPU:
- padding a chunk to `chunk` rows leaves its real rows within 1e-6 of the
  unpadded chunk's, and the predictions equal (as
  tests/test_torch_fused_pipelined.py holds the rows whatever the chunks);
- the eager route pads every short chunk in eval mode and none in train
  mode, and counts its chunks eager (`stage_b.eager_chunks`), none replayed;
- the FFT features from the geometry cached on the device equal those of
  the geometry copied at every call, and no copy is made after a device's
  first call.

On the card (marker `cuda`, skipped here):
- the graph route's rows equal the eager route's bit for bit at every cap
  (64, 96 and the full crop capacity), with a partial last chunk, and
  through `score_frames_fused`;
- a second batch replays without a new capture;
- an in-place weight update is seen by the next replay;
- a CAE in train mode takes the eager route.
"""

import numpy as np
import pytest
import torch

from cell_image_analysis_tpu_torch.io.artifacts import load_scoring_params
from cell_image_analysis_tpu_torch.models.segmentation import ThresholdBackend
from cell_image_analysis_tpu_torch.ops import fft_features as fft_mod
from cell_image_analysis_tpu_torch.ops.clahe import bucket_caps
from cell_image_analysis_tpu_torch.pipeline import scoring
from cell_image_analysis_tpu_torch.utils import profiler
from cell_image_analysis_tpu_torch.utils.synthetic import make_frame

torch.set_num_threads(1)      # one thread a test worker, as torch_port_helpers.torch_threads

CHUNK = 32
CAPS = (64, 96, 192)
THRESH = dict(label_capacity=4096, cell_capacity=128, fg_fraction=0.12, rcap=32, chunk=CHUNK,
              caps=(64, 96))
PRED = (2, 3, 6, 7)      # the prediction columns of a score row


def _crops(cap, n, seed, device="cpu"):
    """n CLAHE-like crops (n, cap, cap) in [0, 1], zero outside sides of
    12..cap px, and the sides (n,) int32."""
    g = torch.Generator().manual_seed(seed)
    h = torch.randint(12, cap + 1, (n,), generator=g, dtype=torch.int32)
    w = torch.randint(12, cap + 1, (n,), generator=g, dtype=torch.int32)
    eq = torch.rand((n, cap, cap), generator=g)
    p = torch.arange(cap)
    eq = eq * ((p[None, :, None] < h[:, None, None]) & (p[None, None, :] < w[:, None, None]))
    return eq.to(device), h.to(device), w.to(device)


def _frames(seed, n=2, size=256, n_cells=14, device="cpu"):
    rng = np.random.default_rng(seed)
    frames = np.stack([make_frame(rng, size=size, n_cells=n_cells) for _ in range(n)])
    return (torch.tensor(frames[..., 2].astype(np.float32), device=device),
            torch.tensor(frames[..., 1].astype(np.float32), device=device))


@pytest.fixture(scope="module")
def cpu_scoring():
    return load_scoring_params(device="cpu")


def test_bucket_caps_are_the_size_buckets():
    assert bucket_caps((96, 64), 192) == (64, 96, 192)
    assert bucket_caps((64, 96, 128), 96) == (64, 96)


@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("n", [1, 5, 31])
def test_padding_a_chunk_leaves_its_rows(cpu_scoring, cap, n):
    model, params = cpu_scoring
    eq, h, w = _crops(cap, n, seed=cap + n)
    with torch.inference_mode():
        got = scoring._padded_chunk_rows(model, params, eq, h, w, CHUNK, 64, 2)
        ref = scoring._chunk_rows(model, params, eq, h, w, 64, 2)
    assert got.shape == ref.shape == (n, scoring._FUSED_D)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[:, PRED].numpy(), ref[:, PRED].numpy())


@pytest.mark.parametrize("train", [False, True])
def test_the_eager_route_pads_in_eval_mode_only(cpu_scoring, monkeypatch, train):
    # train mode moves the BatchNorm statistics: a CAE of its own
    model, params = load_scoring_params(device="cpu") if train else cpu_scoring
    fn = ThresholdBackend()
    frames = _frames(5)
    want = scoring.score_frames_fused(model, params, *frames, fn, **THRESH)[0]
    chunks, chunk_rows = [], scoring._chunk_rows
    monkeypatch.setattr(scoring, "_chunk_rows",
                        lambda model, params, eq, *a: chunks.append(len(eq))
                        or chunk_rows(model, params, eq, *a))
    profiler.reset()
    model.train(train)
    scores, stats = scoring.score_frames_fused(model, params, *frames, fn, **THRESH)
    c = profiler.counters()
    assert len(stats["area"]) >= 10
    assert c["stage_b.eager_chunks"] == c["chunks"]
    assert "stage_b.graph_chunks" not in c and "stage_b.captures" not in c
    assert len(chunks) == c["chunks"] == sum(-(-v // CHUNK) for k, v in c.items()
                                            if k.startswith("cells.bucket_"))
    if train:
        assert sum(chunks) == len(stats["area"]) and min(chunks) < CHUNK
        return
    # each short chunk went in padded; the rows are what they were
    assert set(chunks) == {CHUNK}
    for k in want:
        np.testing.assert_array_equal(scores[k], want[k], err_msg=k)


def _geometry_copied_each_call(cells, radial_bins=16, angular_bins=8):
    """`fft_features` as it was before its geometry was cached: the host
    arrays copied to the cells' device at every call."""
    b, h, w = cells.shape
    dev = cells.device
    Fq = torch.fft.fftshift(torch.fft.fft2(cells.float()), dim=(-2, -1))
    power = torch.abs(Fq) ** 2
    dc, r_oh, a_oh, r_norm, high = (torch.as_tensor(a, device=dev) for a in
                                    fft_mod._geometry(h, w, radial_bins, angular_bins))
    ac_power = torch.where(dc, torch.zeros((), device=dev), power)
    total_safe = torch.clamp(ac_power.sum(dim=(-2, -1)), min=1e-20)
    flat = ac_power.reshape(b, h * w)
    radial = torch.matmul(flat, r_oh.reshape(h * w, -1)) / total_safe[:, None]
    angular = torch.matmul(flat, a_oh.reshape(h * w, -1)) / total_safe[:, None]
    centroid = (ac_power * r_norm).sum(dim=(-2, -1)) / total_safe
    high_freq = (torch.where(high, ac_power, torch.zeros((), device=dev)).sum(dim=(-2, -1))
                 / total_safe)
    return torch.cat([radial, angular, centroid[:, None], high_freq[:, None],
                      torch.log10(total_safe)[:, None]], dim=1)


@pytest.mark.parametrize("shape", [(64, 64), (48, 40)])
def test_fft_geometry_is_cached_a_device_and_shape(monkeypatch, shape):
    cells = torch.rand((6, *shape), generator=torch.Generator().manual_seed(1))
    copies = []
    as_tensor = torch.as_tensor

    def counting(*a, **k):
        copies.append(a[0].shape)
        return as_tensor(*a, **k)

    fft_mod._device_geometry.cache_clear()
    monkeypatch.setattr(torch, "as_tensor", counting)
    with torch.inference_mode():
        first = fft_mod.fft_features(cells)
    assert len(copies) == 5
    geometry = fft_mod._device_geometry(cells.device, *shape, 16, 8)
    assert not any(t.is_inference() for t in geometry)
    second = fft_mod.fft_features(cells[..., None])
    assert len(copies) == 5 and fft_mod._device_geometry(cells.device, *shape, 16, 8) is geometry
    monkeypatch.setattr(torch, "as_tensor", as_tensor)
    ref = _geometry_copied_each_call(cells)
    assert torch.equal(first, ref) and torch.equal(second, ref)


# ------------------------------------------------------------- the card --


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs and the CLAHE kernel have no CPU mode")
    return torch.device("cuda", 0)


def _handle(model, params, chunk=CHUNK):
    return dict(model=model, params=params, chunk=chunk, out_size=64, min_votes=2)


@pytest.mark.cuda
def test_graph_rows_equal_the_eager_rows_at_every_cap(dev):
    model, params = load_scoring_params(device=dev)
    n = CHUNK + 5                           # a full chunk, then a partial one
    with torch.inference_mode():
        graphs = scoring._chunk_graphs(_handle(model, params), dev, CAPS)
        assert sorted(graphs) == list(CAPS)
        for cap in CAPS:
            eq, h, w = _crops(cap, n, seed=cap, device=dev)
            for start in (0, CHUNK):
                part = slice(start, start + CHUNK)
                got = graphs[cap].replay(eq[part], torch.stack([h, w])[:, part]).clone()
                ref = scoring._padded_chunk_rows(model, params, eq[part], h[part], w[part],
                                                 CHUNK, 64, 2)
                assert got.shape == ref.shape
                assert torch.equal(got, ref), (cap, start)


def _eager(monkeypatch):
    """Stage B on the card without its graphs: the eager route."""
    monkeypatch.setattr(scoring, "_chunk_graphs", lambda *a: None)


@pytest.mark.cuda
def test_batches_replay_the_graphs_captured_once(dev, monkeypatch):
    model, params = load_scoring_params(device=dev)
    fn = ThresholdBackend()
    frames = _frames(5, device=dev)
    profiler.reset()
    first = scoring.score_frames_fused(model, params, *frames, fn, **THRESH)
    c1 = profiler.counters()
    assert c1["stage_b.captures"] == len(CAPS)          # every cap at the first batch
    assert c1["stage_b.graph_chunks"] == c1["chunks"] >= 1
    second = scoring.score_frames_fused(model, params, *_frames(6, device=dev), fn, **THRESH)
    c2 = profiler.counters(since=c1)
    assert "stage_b.captures" not in c2
    assert c2["stage_b.graph_chunks"] == c2["chunks"] >= 1
    c3 = profiler.counters()
    with monkeypatch.context() as m:
        _eager(m)
        eager = scoring.score_frames_fused(model, params, *frames, fn, **THRESH)
    c4 = profiler.counters(since=c3)
    assert c4["stage_b.eager_chunks"] == c4["chunks"] and "stage_b.graph_chunks" not in c4
    for k in eager[0]:
        np.testing.assert_array_equal(first[0][k], eager[0][k], err_msg=k)
    assert len(second[1]["area"]) >= 10


@pytest.mark.cuda
def test_a_replay_sees_an_in_place_weight_update(dev, monkeypatch):
    model, params = load_scoring_params(device=dev)
    fn = ThresholdBackend()
    frames = _frames(7, device=dev)
    before = scoring.score_frames_fused(model, params, *frames, fn, **THRESH)[0]
    with torch.no_grad():
        model.convs[0].weight.mul_(0.5)
        params.pca_components.mul_(0.75)
    c = profiler.counters()
    after = scoring.score_frames_fused(model, params, *frames, fn, **THRESH)[0]
    assert "stage_b.captures" not in profiler.counters(since=c)
    with monkeypatch.context() as m:
        _eager(m)
        eager = scoring.score_frames_fused(model, params, *frames, fn, **THRESH)[0]
    assert not np.array_equal(before["reconstruction_mse"], after["reconstruction_mse"])
    assert not np.array_equal(before["conservative_scores"], after["conservative_scores"])
    for k in eager:
        np.testing.assert_array_equal(after[k], eager[k], err_msg=k)


@pytest.mark.cuda
def test_a_cae_in_train_mode_takes_the_eager_route(dev):
    model, params = load_scoring_params(device=dev)
    fn = ThresholdBackend()
    model.train()
    profiler.reset()
    scores, stats = scoring.score_frames_fused(model, params, *_frames(5, device=dev), fn,
                                               **THRESH)
    c = profiler.counters()
    assert c["stage_b.eager_chunks"] == c["chunks"] >= 1 and len(stats["area"]) >= 10
    assert "stage_b.graph_chunks" not in c and "stage_b.captures" not in c
