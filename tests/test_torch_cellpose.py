"""PyTorch port: the Cellpose backend (`models.cellpose`, `ops.flows`,
`ops.cellpose_masks`, `models.segmentation.CellposeBackend`) against the
benchmark's plain reference (`benchmark/reference/cellpose.py`), on the CPU
at a test's size: CPnet at nbase 2-8-16-32-64 with seeded random weights
(BatchNorm statistics drawn too), 64^2 tiles, two 160^2 frames.

- the network to 1e-5 of the largest output (the port's 1x1 convs are
  matmuls, the reference's `F.conv2d`: float32 sums in another order);
  normalize99, the tiles, the taper and the blend equal;
- the flow following (`follow_flows_plain`) equal;
- the masks, the flow QC and the clean-up equal bit for bit given the same
  flows, and the QC's float64 errors to 1e-12 (sums in another order), on
  the random network's flows and on flows made from planted cells; holes
  and masks inside other masks' holes as Cellpose fills them;
- no seed capacity: a frame of 1,000 seeds gets them all; the exact twin
  (the same network on the pixel regionprops);
- the backend through `score_frames_fused_start` / `_wait` gives the cells
  of the reference's label maps; its spans and counters;
- `segment_frame` and `select_backend` refuse an unknown backend; `cli
  screen --backend cellpose` reads `--cellpose-weights`.

The test marked `cuda` holds the kernel (`csrc/follow_flows.cu`) to the
plain version on a 1024^2 field and skips without a card; on a GPU machine
run

    python -m pytest tests/test_torch_cellpose.py -q -m cuda
"""

import ast
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from torch_port_helpers import torch_threads

from cell_image_analysis_tpu_torch import cli
from cell_image_analysis_tpu_torch.config import CellposeConfig, SegConfig
from cell_image_analysis_tpu_torch.io.artifacts import (
    load_cellpose_weights,
    load_scoring_params,
    save_cellpose_weights,
)
from cell_image_analysis_tpu_torch.models import cellpose as cp
from cell_image_analysis_tpu_torch.models.segmentation import (
    CellposeBackend,
    segment_frame,
    select_backend,
)
from cell_image_analysis_tpu_torch.ops import cellpose_masks as cm
from cell_image_analysis_tpu_torch.ops.flows import (
    flow_field,
    follow_flows,
    follow_flows_plain,
    moving_points,
)
from cell_image_analysis_tpu_torch.pipeline.scoring import (
    score_frames_fused_start,
    score_frames_fused_wait,
)
from cell_image_analysis_tpu_torch.utils import profiler
from cell_image_analysis_tpu_torch.utils.synthetic import make_frame, make_frame_instances

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)
from benchmark.reference import cellpose as ref  # noqa: E402

torch_threads()

NBASE = (2, 8, 16, 32, 64)
CFG = CellposeConfig(tile=64, tile_chunk=16)
REF_CFG = dict(tile=64, tile_overlap=0.1, norm_pmin=1.0, norm_pmax=99.0, niter=200,
               cellprob_threshold=0.0, flow_threshold=0.4, min_size=15,
               max_size_fraction=0.4)
STAGE_A = dict(label_capacity=128, cell_capacity=128, rcap=32, chunk=32, caps=(64, 96))


def _random_arrays(seed: int = 3) -> dict:
    """Cellpose-named weights: PyTorch's default init from `seed`, BN
    statistics and affine drawn, the cell probability's bias set so that
    about half the pixels are cells and the flow outputs scaled up, so that
    the dynamics have points to move and masks to make."""
    model = cp.init_cpnet(seed, NBASE)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, cp._BC):
                c = m.bn_mean.shape[0]
                m.bn_mean.copy_(torch.randn(c, generator=g) * 0.1)
                m.bn_var.copy_(torch.rand(c, generator=g) + 0.5)
                m.bn_weight.copy_(torch.rand(c, generator=g) + 0.5)
                m.bn_bias.copy_(torch.randn(c, generator=g) * 0.1)
        model.output.weight[:2] *= 20
        y = cp.run_tiled(model.eval(), torch.as_tensor(_frames()), tile=64, tile_chunk=16)
        model.output.bias[2] -= float(y[..., 2].median())
    return cp.cellpose_state_to_numpy(model)


def _frames(seed: int = 0, n: int = 2, size: int = 160, cells: int = 6) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.stack([make_frame(rng, size=size, n_cells=cells)[..., 2]
                     for _ in range(n)]).astype(np.float32)


@pytest.fixture(scope="module")
def arrays():
    return _random_arrays()


@pytest.fixture(scope="module")
def model(arrays):
    return cp.build_cpnet(arrays, "cpu")


@pytest.fixture(scope="module")
def state(arrays):
    return {k: torch.as_tensor(v) for k, v in arrays.items()}


@pytest.fixture(scope="module")
def net_out(model, state):
    """(port (B, 3, H, W), reference (B, 3, H, W)) network outputs."""
    frames = _frames()
    got = cp.run_tiled(model, torch.as_tensor(frames), tile=64, tile_chunk=16)
    want = np.stack([ref.run_net(state, f, REF_CFG, "cpu") for f in frames])
    return got.permute(0, 3, 1, 2).numpy(), want


def _planted_flows(seed: int = 1) -> tuple:
    """(dP (B, 2, H, W), cellprob (B, H, W)) made from planted cells: 5 x
    their heat-diffusion flows and a +-2 cell probability, with noise."""
    rng = np.random.default_rng(seed)
    labs = np.stack([make_frame_instances(rng, size=160, n_cells=10, clustering=0.5)[1]
                     for _ in range(2)])
    mu, _ = cm.masks_to_flows(torch.as_tensor(labs))
    dP = (5 * mu.numpy() + rng.normal(0, 0.3, mu.shape)).astype(np.float32)
    prob = (np.where(labs > 0, 2.0, -2.0) + rng.normal(0, 0.5, labs.shape)).astype(np.float32)
    return dP, prob


def test_cpnet_matches_the_reference(model, state):
    x = np.random.default_rng(4).normal(size=(3, 2, 64, 64)).astype(np.float32)
    got = model(torch.as_tensor(x).permute(0, 2, 3, 1)).permute(0, 3, 1, 2).detach().numpy()
    want = ref.cpnet(state, torch.as_tensor(x)).numpy()
    assert got.shape == want.shape == (3, 3, 64, 64)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_the_fused_cpnet_matches_the_unfused_forward(model, monkeypatch):
    """Eval without grad: every 3x3 conv takes its BatchNorm, style term
    and ReLU as the conv's input prologue (32 of 32); the output equals,
    to 1e-6, the forward with each `_BC` as separate passes: x + style,
    the BatchNorm, the ReLU, then the conv."""
    import torch.nn.functional as F

    from cell_image_analysis_tpu_torch.ops import winograd

    calls, real = [], winograd.winograd_conv3x3

    def spy(x, W, bias=None, **kw):
        calls.append(kw.get("in_scale") is not None)
        return real(x, W, bias, **kw)

    def unfused(self, x, style=None):
        if style is not None:
            x = x + style[:, None, None, :]
        x = (x - self.bn_mean) / torch.sqrt(self.bn_var + cp.BN_EPS) * self.bn_weight
        x = x + self.bn_bias
        x = torch.relu(x) if self.relu else x
        k = self.weight.shape[-1]
        return F.conv2d(x.permute(0, 3, 1, 2), self.weight, self.bias,
                        padding=k // 2).permute(0, 2, 3, 1)

    x = torch.as_tensor(np.random.default_rng(5).normal(size=(3, 64, 64, 2)).astype(np.float32))
    monkeypatch.setattr(winograd, "winograd_conv3x3", spy)
    with torch.no_grad():
        fused = model(x)
        assert calls == [True] * 32
        monkeypatch.setattr(cp._BC, "forward", unfused)
        want = model(x)
    assert len(calls) == 32
    assert float((fused - want).abs().max()) <= 1e-6 * float(want.abs().max())


def test_the_layout_is_cyto3s():
    model = cp.CPnet()
    convs = [m for m in model.modules() if isinstance(m, cp._BC)]
    assert sum(m.weight.shape[-1] == 3 for m in convs) == 32
    assert sum(m.weight.shape[-1] == 1 for m in convs) == 9     # 8 projections, the output
    names = set(cp.cellpose_key_map().values())
    assert "upsample.up.res_up_3.conv.conv_3.full.weight" in names
    assert "downsample.down.res_down_0.proj.1.weight" in names
    assert len(names) == len(model.state_dict())


def test_weights_round_trip(arrays, tmp_path):
    path = str(tmp_path / "w.npz")
    save_cellpose_weights(path, arrays, {"steps": 3})
    back = load_cellpose_weights(path)
    assert set(back) == set(arrays)
    assert all(np.array_equal(back[k], arrays[k]) for k in arrays)
    assert cp.nbase_of(back) == NBASE
    with np.load(path) as z:
        assert "steps" in str(z["meta"])


def test_normalize99_equals_the_reference():
    frames = _frames(7)
    frames[1] = 5.0                                      # flat: zeros
    got = cp.normalize99(torch.as_tensor(frames)).numpy()
    for g, f in zip(got, frames):
        assert np.array_equal(g, ref.normalize99(f))
    assert not got[1].any()


@pytest.mark.parametrize("side,tile", [(1024, 224), (160, 64), (100, 224), (2048, 224)])
def test_tiles_equal_make_tiles(side, tile):
    (py, _), ys, xs, (th, tw) = cp.tiles_of(side, side, tile, 0.1)
    img, sy, _ = ref.pad_image_nd(np.zeros((2, side, side), np.float32))
    _, ysub, xsub = ref.make_tiles(img, tile, 0.1)
    assert sy.start == py[0] and img.shape[-1] == side + sum(py)
    assert sorted({a for a, _ in ysub}) == ys and sorted({a for a, _ in xsub}) == xs
    assert ysub[0][1] - ysub[0][0] == th and xsub[0][1] - xsub[0][0] == tw
    if side == 1024:
        assert ys == [0, 163, 326, 489, 652, 816] and th == 224
    assert np.array_equal(cp.taper_mask(th, tw), ref.taper_mask(th, tw))


def test_the_tiled_network_matches_the_reference(net_out):
    got, want = net_out
    assert got.shape == want.shape == (2, 3, 160, 160)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    assert 0.2 < (want[:, 2] > 0).mean() < 0.8


def test_follow_flows_plain_equals_the_reference(net_out):
    _, want = net_out
    dP, prob = torch.as_tensor(want[:, :2]).contiguous(), torch.as_tensor(want[:, 2]).contiguous()
    p, n_moving = follow_flows(dP, prob, 200)
    assert int(n_moving.min()) > 1000
    for b in range(2):
        pr, inds = ref.follow_flows(want[b, :2] * (want[b, 2] > 0) / 5., 200, "cpu")
        assert len(inds) == int(n_moving[b])
        assert np.array_equal(pr, p[b].numpy())


def _dynamics(dP: np.ndarray, prob: np.ndarray) -> dict:
    dPt, pt = torch.as_tensor(dP), torch.as_tensor(prob)
    p, n_moving = follow_flows(dPt, pt, 200)
    labels, seeds = cm.get_masks(p, pt > 0, n_moving)
    errors, n_iter = cm.flow_errors(labels, dPt)
    qc, _, _ = cm.remove_bad_flow_masks(labels, dPt, 0.4)
    final, _ = cm.fill_holes_and_remove_small(qc, 15)
    return dict(p=p, labels=labels, seeds=seeds, errors=errors, n_iter=n_iter, final=final)


@pytest.mark.parametrize("flows", ["network", "planted"])
def test_masks_qc_and_fill_equal_the_reference(net_out, flows):
    if flows == "network":
        dP, prob = net_out[1][:, :2].copy(), net_out[1][:, 2].copy()
    else:
        dP, prob = _planted_flows()
    got = _dynamics(dP, prob)
    kept = 0
    for b in range(2):
        masks, n_seeds = ref.get_masks(got["p"][b].numpy(), prob[b] > 0)
        assert n_seeds == int(got["seeds"][b])
        assert np.array_equal(masks, got["labels"][b].numpy())
        assert masks.max() > 0
        errors = ref.flow_error(masks, dP[b], "cpu")
        mine = got["errors"][b, 1:masks.max() + 1].numpy()
        assert np.abs(mine - errors).max() <= 1e-12 * np.abs(errors).max()
        final = ref.compute_masks(dP[b], prob[b], REF_CFG, "cpu")
        assert np.array_equal(final, got["final"][b].numpy())
        kept += final.max()
    if flows == "planted":
        assert kept == 20                              # every planted cell back


def test_masks_to_flows_equals_the_gpu_form():
    _, labs = make_frame_instances(np.random.default_rng(8), size=120, n_cells=8,
                                   clustering=0.6)
    mu, n_iter = cm.masks_to_flows(torch.as_tensor(labs[None]))
    want, want_iter = ref.masks_to_flows_gpu(labs.astype(np.int64), "cpu")
    assert int(n_iter[0]) == want_iter
    assert np.abs(mu[0].numpy() - want).max() <= 1e-12


def test_fill_holes_as_cellpose_fills_them():
    L = np.zeros((3, 40, 50), np.int32)
    L[0, 2:20, 2:20] = 3
    L[0, 5:10, 5:10] = 0                      # a hole of 3
    L[0, 12:16, 12:16] = 1                    # a mask inside 3, before it
    L[0, 25:35, 25:45] = 2
    L[0, 28:31, 28:31] = 4                    # a small mask inside 2, after it
    L[0, 30:33, 40:44] = 5                    # small
    L[1, 5:30, 5:30] = 1
    L[1, 10:20, 10:20] = 0
    L[1, 12:18, 12:18] = 2                    # in 1's hole, after it
    L[1, 0:3, 40:50] = 6                      # on the frame's edge
    L[2, 5:25, 5:25] = 7
    L[2, 10:20, 10:20] = 0                    # a ring with gaps in the numbering
    L[2, 14, 5] = 0
    got, removed = cm.fill_holes_and_remove_small(torch.as_tensor(L), 15)
    for b in range(3):
        assert np.array_equal(ref.fill_holes_and_remove_small_masks(L[b], 15), got[b].numpy())
    assert removed.tolist() == [2, 0, 0]


def test_get_masks_takes_every_seed():
    """Final positions that gather on a 6 px grid: ~1,100 seeds in one
    frame, 9 in the other; the table holds them all (no capacity)."""
    h = w = 200
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    dense = np.stack([yy // 6 * 6 + 3, xx // 6 * 6 + 3]).astype(np.float32)
    sparse = np.stack([yy // 70 * 70 + 35, xx // 70 * 70 + 35]).astype(np.float32)
    p = torch.as_tensor(np.stack([dense, sparse]))
    iscell = torch.ones((2, h, w), dtype=torch.bool)
    labels, seeds = cm.get_masks(p, iscell, torch.full((2,), h * w))
    assert int(seeds[0]) > 1000 and int(seeds[1]) == 9
    for b in range(2):
        masks, n_seeds = ref.get_masks(p[b].numpy(), iscell[b].numpy())
        assert n_seeds == int(seeds[b])
        assert np.array_equal(masks, labels[b].numpy())


def test_the_twin_is_the_network_on_pixel_regionprops(model, state):
    frames = _frames()
    backend = CellposeBackend(None, CFG, model=model)
    assert not getattr(backend, "returns_overflow", False) and backend.runs_props
    twin = backend.exact_twin()
    assert twin.cfg == CFG and twin.runs_props is False and twin.model is model
    labels = twin(torch.as_tensor(frames))
    assert torch.equal(labels, backend(torch.as_tensor(frames)))
    for b, f in enumerate(frames):
        assert np.array_equal(ref.labels(state, f, REF_CFG, "cpu"), labels[b].numpy())


def test_the_blend_weights_are_made_once_a_shape():
    first = cp.blend_weights(160, 160, 64, 0.1, torch.device("cpu"))
    assert cp.blend_weights(160, 160, 64, 0.1, torch.device("cpu")) is first
    (py, px), ys, xs, (th, tw) = cp.tiles_of(160, 160, 64, 0.1)
    navg = np.zeros((160 + sum(py), 160 + sum(px)))
    for y0 in ys:
        for x0 in xs:
            navg[y0:y0 + th, x0:x0 + tw] += ref.taper_mask(th, tw)
    assert np.array_equal(first[0].numpy(), ref.taper_mask(th, tw))
    assert np.array_equal(first[1].numpy(), navg)


class _ReferenceLabels:
    """A segment_fn that returns the reference's label maps: of its own
    network, or (`net`) of the port's network's output."""

    def __init__(self, state, cfg, net=None):
        self.state, self.cfg, self.net = state, cfg, net

    def __call__(self, segs):
        if self.net is None:
            return torch.as_tensor(np.stack([ref.labels(self.state, s, self.cfg, "cpu")
                                             for s in segs.numpy()]))
        y = cp.run_tiled(self.net, segs, tile=64, tile_chunk=16).permute(0, 3, 1, 2).numpy()
        return torch.as_tensor(np.stack([ref.compute_masks(v[:2], v[2], self.cfg, "cpu")
                                         for v in y]))


def test_the_backend_screens_the_reference_cells(model, state):
    from benchmark import check

    rng = np.random.default_rng(11)
    frames = np.stack([make_frame(rng, size=160, n_cells=6) for _ in range(2)])
    segs = torch.as_tensor(frames[..., 2].astype(np.float32))
    greens = torch.as_tensor(frames[..., 1].astype(np.float32))
    scoring = load_scoring_params(device="cpu")
    qc = dict(min_area=20, max_area=8000, border_margin=2, min_mean_intensity=0.5,
              min_std_intensity=0.1, max_eccentricity=0.999)
    # the random network's masks fail the flow QC: it is off here (0), so
    # that cells reach stage A
    backend = CellposeBackend(None, dataclasses.replace(CFG, flow_threshold=0.0), model=model)
    cfg = dict(REF_CFG, flow_threshold=0.0)

    def screen(fn, **kw):
        return score_frames_fused_wait(score_frames_fused_start(
            *scoring, segs, greens, fn, **kw, **STAGE_A, **qc))

    got = screen(backend, fallback_segment_fn=backend.exact_twin())
    # the reference's dynamics on the port network's output: the same cells
    same_net = screen(_ReferenceLabels(state, cfg, net=model))
    assert len(same_net[1]["area"]) > 5
    for k in ("frame_index", "label_ids", "area", "eccentricity", "mean_intensity"):
        assert np.array_equal(got[1][k], same_net[1][k]), k
    assert np.array_equal(got[0]["reconstruction_mse"], same_net[0]["reconstruction_mse"])
    # the whole reference: its network's float32 sums differ in the last
    # bits, which moves a final position across a pixel edge now and then
    # (a pixel that changes cell but keeps both areas: a gap of ~2e-5)
    numbers = check.compare([(got, screen(_ReferenceLabels(state, cfg)))])
    assert numbers["cells_unmatched_pct"] <= 10 and numbers["value_gap"] <= 1e-4


def test_a_cellpose_batch_records_its_spans_and_counters(model):
    frames = torch.as_tensor(_frames())
    backend = CellposeBackend(None, CFG, model=model)
    profiler.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        backend(frames)
    s = profiler.summary()
    # without the flow QC the random network's small masks reach the clean-up
    CellposeBackend(None, dataclasses.replace(CFG, flow_threshold=0.0), model=model)(frames)
    for name in ("cellpose.normalize", "cellpose.tiles", "cellpose.net",
                 "cellpose.follow_flows", "cellpose.masks", "cellpose.flow_qc",
                 "cellpose.fill"):
        assert s["spans"][name]["calls"] == 1, name
    c = s["counters"]
    assert c["cellpose.tiles"] == 2 * 16
    assert c["cellpose.points"] > 1000 and c["cellpose.seeds"] > 0
    assert c["cellpose.qc_iterations"] > 0
    assert c["cellpose.removed_flow"] > 0
    assert profiler.counters().get("cellpose.removed_small", 0) > 0
    recs = profiler.records()
    parent = {r.name: recs[r.parent].name for r in recs if r.parent >= 0}
    assert parent["cellpose.net"] == "cellpose.tiles"


def test_segment_frame_and_select_backend_refuse_an_unknown_backend(arrays, model):
    x = torch.as_tensor(_frames(n=1))
    with pytest.raises(ValueError, match="unknown segmentation backend"):
        segment_frame(x, SegConfig(backend="tresh"))
    with pytest.raises(ValueError, match="unknown segmentation backend"):
        select_backend(SegConfig(backend="cellpse"), 128, arrays, "cpu")
    with pytest.raises(ValueError, match="needs its CPnet"):
        segment_frame(x, SegConfig(backend="cellpose"))
    primary, twin, net = select_backend(SegConfig(backend="cellpose"), 128, arrays, "cpu")
    assert isinstance(primary, CellposeBackend) and primary.cfg == CellposeConfig()
    assert twin.runs_props is False and net is primary.model
    labels = segment_frame(x, SegConfig(backend="cellpose"), model)
    assert torch.equal(labels, CellposeBackend(None, model=model)(x))


def test_cli_screen_reads_the_cellpose_weights(arrays, tmp_path):
    import argparse

    path = str(tmp_path / "cp.npz")
    save_cellpose_weights(path, arrays)
    p = argparse.ArgumentParser()
    cli.add_screen_arguments(p)
    args = p.parse_args(["--models", "m", "--sample", "a=b", "--backend", "cellpose",
                         "--cellpose-weights", path])
    got = cli.load_unet(args)
    assert set(got) == set(arrays)
    assert "--cellpose-weights" in p.format_help()
    with pytest.raises(SystemExit):
        cli.load_unet(p.parse_args(["--models", "m", "--sample", "a=b", "--backend",
                                    "cellpose"]))


def test_the_trainer_steps_and_keeps_running_statistics():
    from cell_image_analysis_tpu_torch.train import cellpose_trainer as tr

    images, labels, flows = tr.synthetic_set(2, 96, 3, 1, "cpu")
    assert images.shape == (2, 96, 96) and flows.shape == (2, 2, 96, 96)
    background = (labels == 0)[:, None].expand_as(flows)
    assert labels.max() == 3 and flows[background].abs().max() == 0
    model, log = tr.fit_cpnet(images, labels, flows, steps=3, batch=2, tile=64, nbase=NBASE,
                              log_every=1)
    assert not model.training and len(log) == 3 and np.isfinite([v for _, v in log]).all()
    assert float(model.down[0].proj.bn_mean.abs().sum()) > 0          # momentum 0.05 updates
    assert tr.matched_share(np.array([[1, 1, 0], [0, 2, 2]]),
                            np.array([[3, 3, 0], [0, 0, 1]])) == (2, 2)


@pytest.mark.parametrize("path", ["scripts/make_cellpose_weights_torch.py",
                                  "cell_image_analysis_tpu_torch/train/cellpose_trainer.py",
                                  "benchmark/reference/cellpose.py"])
def test_new_files_import_no_jax(path):
    tree = ast.parse(open(os.path.join(_REPO, path)).read())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            mods.add(node.module)
    tops = {m.split(".")[0] for m in mods}
    assert not tops & {"jax", "jaxlib", "flax", "cell_image_analysis_tpu"}
    if path.startswith("benchmark"):
        assert "cell_image_analysis_tpu_torch" not in tops


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the follow_flows kernel)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_the_kernel_follows_as_the_plain_version(cuda_device):
    from cell_image_analysis_tpu_torch.ops.cuda import flows as launcher

    _, labs = make_frame_instances(np.random.default_rng(5), size=1024, n_cells=80)
    mu, _ = cm.masks_to_flows(torch.as_tensor(labs[None], device=cuda_device))
    rng = np.random.default_rng(6)
    dP = (5 * mu + torch.as_tensor(rng.normal(0, 0.3, mu.shape), device=cuda_device)).float()
    prob = (torch.as_tensor(np.where(labs > 0, 2.0, -2.0), device=cuda_device)[None]
            + torch.as_tensor(rng.normal(0, 0.5, labs.shape), device=cuda_device)).float()
    before = launcher.LAUNCHES
    got, n_moving = follow_flows(dP, prob, 200)
    torch.cuda.synchronize()
    assert launcher.LAUNCHES == before + 1
    want = follow_flows_plain(dP, prob, 200)
    moving = moving_points(flow_field(dP, prob))
    assert int(n_moving[0]) == int(moving.sum()) > 10000
    assert (got - want).abs().max().item() <= 1e-4
    same = (got.to(torch.int32) == want.to(torch.int32)).all(dim=1)[moving]
    assert same.float().mean().item() >= 0.9999
    assert torch.equal(got[:, :, ~moving[0]], want[:, :, ~moving[0]])
