"""PyTorch port: Cellpose-SAM (`models.vit_sam`, `ops.vit_attention`, the
Cellpose backend with the ViT, the low-rank weight format) against the
benchmark's plain reference (`benchmark/reference/cellpose_sam.py`), on the
CPU at a test's size: depth 2, width 64, 4 heads, a 64^2 tile with 8 px
patches (8 x 8 tokens), neck 32, tables of 27 and 127 rows, seeded weights.

- the ViT to float32 rounding of the reference's, tiles and whole frames;
  SAM's `get_rel_pos` and the attention's plain form exactly;
- one whole frame through `CellposeBackend` to the reference's labels (the
  flow QC off: a random network's flows fail it everywhere);
- the program's and the reference's loaders merge a low-rank file into the
  same weights bit for bit, and the low-rank training form computes what
  its merged weights compute;
- `run_tiled` with CPnet at its 224 tile is what it was;
- `cellpose_sam` through `select_backend`, `segment_frame` and `cli
  screen`; spans and counters; the op's gradient against the plain form's;
  the trainer on a low-rank ViT.

The tests marked `cuda` hold the fused kernel (`csrc/vit_attention.cu`) to
the plain form at 100 tiles x 16 heads (max relative error <= 1e-5), count
`vit.attention_fused`, hold the op's gradient on the card to the plain
form's and check that shapes the kernel does not take raise there; they
skip without a card.  On a GPU machine:

    python -m pytest tests/test_torch_cellpose_sam.py -q -m cuda
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
    LOW_RANK_SEED,
    load_cellpose_weights,
    save_cellpose_weights,
)
from cell_image_analysis_tpu_torch.models import cellpose as cp
from cell_image_analysis_tpu_torch.models import vit_sam
from cell_image_analysis_tpu_torch.models.segmentation import (
    CellposeBackend,
    segment_frame,
    select_backend,
)
from cell_image_analysis_tpu_torch.ops.cuda.vit_attention import key_permuted_vt
from cell_image_analysis_tpu_torch.ops.vit_attention import (
    VitAttentionFn,
    vit_attention,
    vit_attention_plain,
)
from cell_image_analysis_tpu_torch.train import cellpose_trainer as tr
from cell_image_analysis_tpu_torch.utils import profiler
from cell_image_analysis_tpu_torch.utils.synthetic import make_frame

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)
from benchmark.reference import cellpose as ref_cp  # noqa: E402
from benchmark.reference import cellpose_sam as ref  # noqa: E402

torch_threads()

WIDTHS = dict(dim=64, depth=2, heads=4, hidden=256, patch=8, tile=64, neck=32, rows=(27, 127))
CFG = CellposeConfig(tile=64, tile_chunk=16)
REF_CFG = dict(tile=64, tile_overlap=0.1, norm_pmin=1.0, norm_pmax=99.0, niter=200,
               cellprob_threshold=0.0, flow_threshold=0.4, min_size=15,
               max_size_fraction=0.4)


def _frames(seed: int = 0, n: int = 2, size: int = 160, cells: int = 6) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.stack([make_frame(rng, size=size, n_cells=cells)[..., 2]
                     for _ in range(n)]).astype(np.float32)


def _state_arrays(model) -> dict:
    return {k: v.detach().numpy().astype(np.float32) for k, v in model.state_dict().items()}


def _random_arrays(seed: int = 3) -> dict:
    """Cellpose-SAM-named weights: `init_vit_sam`, the tables, LayerNorms
    and biases drawn too, the flow outputs scaled up and the cell
    probability's bias set so that about half the pixels are cells."""
    model = vit_sam.init_vit_sam(seed, **WIDTHS)
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "rel_pos" in name or name.endswith("bias"):
                p.copy_(torch.randn(p.shape, generator=g) * 0.3)
            elif "norm" in name or "neck.1" in name or "neck.3" in name:
                p.copy_(torch.rand(p.shape, generator=g) + 0.5)
            elif name.startswith("encoder.blocks"):
                p.mul_(6.0)
        model.out.weight[:128] *= 20
        y = cp.run_tiled(model.eval(), torch.as_tensor(_frames()), tile=64, tile_chunk=16)
        model.out.bias[128:] -= float(y[..., 2].median())
    return _state_arrays(model)


@pytest.fixture(scope="module")
def arrays():
    return _random_arrays()


@pytest.fixture(scope="module")
def model(arrays):
    return vit_sam.build_vit_sam(arrays, "cpu")


@pytest.fixture(scope="module")
def state(arrays):
    return {k: torch.as_tensor(v) for k, v in arrays.items()}


def _close(got, want, tol=1e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def test_the_widths_come_from_the_weights(arrays):
    w = vit_sam.widths_of(arrays)
    assert w == dict(WIDTHS, nout=3, in_channels=3)
    assert vit_sam.is_vit_state(arrays) and not vit_sam.is_vit_state(
        cp.cellpose_state_to_numpy(cp.init_cpnet(0, (2, 8, 16, 32, 64))))
    assert vit_sam.rel_pos_rows(24) == tuple(127 if i in (5, 11, 17, 23) else 27
                                             for i in range(24))


def test_the_published_layout_is_cellpose_sams():
    shapes = {k: tuple(v.shape) for k, v in vit_sam.ViTSAM().state_dict().items()}
    assert shapes["encoder.patch_embed.proj.weight"] == (1024, 3, 8, 8)
    assert shapes["encoder.pos_embed"] == (1, 32, 32, 1024)
    assert shapes["encoder.blocks.23.attn.qkv.weight"] == (3072, 1024)
    assert shapes["encoder.blocks.5.attn.rel_pos_h"] == (127, 64)
    assert shapes["encoder.blocks.4.attn.rel_pos_w"] == (27, 64)
    assert shapes["encoder.blocks.0.mlp.lin1.weight"] == (4096, 1024)
    assert shapes["encoder.neck.0.weight"] == (256, 1024, 1, 1)
    assert shapes["encoder.neck.2.weight"] == (256, 256, 3, 3)
    assert shapes["out.weight"] == (192, 256, 1, 1)
    assert len([k for k in shapes if k.startswith("encoder.blocks.")]) == 24 * 14


@pytest.mark.parametrize("rows,size", [(27, 8), (127, 8), (15, 8), (127, 32), (27, 32)])
def test_get_rel_pos_is_sams(rows, size):
    table = torch.randn(rows, 16, generator=torch.Generator().manual_seed(rows))
    assert torch.equal(vit_sam.get_rel_pos(size, size, table), ref.get_rel_pos(size, size, table))


def test_the_plain_attention_is_sams():
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(6, 64, 16, generator=g) for _ in range(3))
    Rh, Rw = (torch.randn(15, 16, generator=g) for _ in range(2))
    attn = ref.add_decomposed_rel_pos((q * 0.25) @ k.transpose(-2, -1), q, Rh, Rw, (8, 8), (8, 8))
    want = attn.softmax(-1) @ v
    rel_h = torch.einsum("bhwc,hkc->bhwk", q.reshape(6, 8, 8, 16),
                         vit_sam.get_rel_pos(8, 8, Rh)).reshape(6, 64, 8)
    rel_w = torch.einsum("bhwc,wkc->bhwk", q.reshape(6, 8, 8, 16),
                         vit_sam.get_rel_pos(8, 8, Rw)).reshape(6, 64, 8)
    assert torch.equal(vit_attention_plain(q, k, v, rel_h, rel_w, 0.25), want)


def test_the_vit_matches_the_reference(model, state):
    x = torch.rand(3, 64, 64, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got = model(x).permute(0, 3, 1, 2)
        want = ref.vit_sam(state, x.permute(0, 3, 1, 2).contiguous())
    _close(got, want)
    # the readout's unfold is conv_transpose2d with the identity W2
    assert got.shape == (3, 3, 64, 64)


def test_the_tiled_vit_matches_the_reference(model, state):
    frames = _frames()
    got = cp.run_tiled(model, torch.as_tensor(frames), tile_chunk=16)
    want = np.stack([ref.run_net(state, f, REF_CFG, "cpu") for f in frames])
    _close(got.permute(0, 3, 1, 2).numpy(), want)


def test_the_backend_gives_the_references_labels(model, state):
    # a random network's flows fail the flow QC everywhere (the QC itself is
    # held to the reference in test_torch_cellpose.py): the QC is off here
    frame = _frames(seed=4, n=1)
    cfg = CellposeConfig(tile=64, tile_chunk=16, flow_threshold=0.0)
    got = CellposeBackend(None, cfg, model=model)(torch.as_tensor(frame))[0].numpy()
    want = ref.labels(state, frame[0], dict(REF_CFG, flow_threshold=0.0), "cpu")
    assert want.max() >= 20
    assert np.array_equal(got, want)


def _low_rank_file(tmp_path, rank: int = 3, base_seed: int = 77) -> tuple:
    model = vit_sam.low_rank_(vit_sam.init_vit_sam(5, **WIDTHS), rank, base_seed, seed=5)
    g = torch.Generator().manual_seed(9)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, vit_sam.LowRankLinear):
                mod.a.copy_(torch.randn(mod.a.shape, generator=g) * 0.05)
    arrays, large = vit_sam.low_rank_state_to_numpy(model)
    stored = {k: v.astype(np.float16) for k, v in arrays.items()}
    stored[LOW_RANK_SEED] = np.asarray(base_seed, np.int64)
    path = str(tmp_path / "sam.npz")
    save_cellpose_weights(path, stored, {"rank": rank})
    return path, model, large


def test_the_two_loaders_merge_the_same_weights(tmp_path):
    path, _, large = _low_rank_file(tmp_path)
    assert len(large) == 4 * WIDTHS["depth"]
    mine = load_cellpose_weights(path)
    theirs = ref.merged_arrays(path)
    assert sorted(mine) == sorted(theirs)
    for k, v in mine.items():
        assert v.dtype == np.float32
        assert np.array_equal(v, theirs[k].numpy()), k
    for name in large:
        assert mine[name].shape == vit_sam.ViTSAM(**WIDTHS).state_dict()[name].shape
    # a base is the fixed rule's: randn(shape) * 0.02 from base_seed + 4 block + part
    name = "encoder.blocks.1.mlp.lin1.weight"
    base = torch.randn((256, 64), generator=torch.Generator().manual_seed(77 + 6)) * 0.02
    assert torch.equal(vit_sam.base_matrix(name, (256, 64), 77), base)
    assert vit_sam.low_rank_index(name) == 6
    with pytest.raises(ValueError):
        vit_sam.low_rank_index("encoder.blocks.1.norm1.weight")


def test_the_low_rank_form_computes_its_merged_weights(tmp_path):
    path, lr_model, _ = _low_rank_file(tmp_path)
    # the stored factors are float16: run the training form on those values
    merged = vit_sam.build_vit_sam(load_cellpose_weights(path), "cpu")
    with torch.no_grad():
        for name, p in lr_model.named_parameters():
            p.copy_(p.half().float())
        x = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(2))
        _close(lr_model.eval()(x), merged(x), tol=1e-4)


def test_run_tiled_with_cpnet_keeps_its_224_tile():
    net = cp.init_cpnet(0, (2, 8, 16, 32, 64)).eval()
    assert (net.tile, net.in_channels) == (224, 2)
    frames = torch.as_tensor(_frames(n=1, size=300))
    got = cp.run_tiled(net, frames)
    assert torch.equal(got, cp.run_tiled(net, frames, tile=224))
    want = ref_cp.run_net({k: torch.as_tensor(v) for k, v in cp.cellpose_state_to_numpy(
        net).items()}, frames[0].numpy(), dict(REF_CFG, tile=224), "cpu")
    _close(got[0].permute(2, 0, 1).numpy(), want)


def test_the_backend_chooses_the_network_and_its_tile_from_the_weights(arrays):
    backend = CellposeBackend(arrays, CFG, device="cpu")
    assert isinstance(backend.model, vit_sam.ViTSAM)
    assert backend.exact_twin().model is backend.model
    cpnet = cp.cellpose_state_to_numpy(cp.init_cpnet(0, (2, 8, 16, 32, 64)))
    assert isinstance(CellposeBackend(cpnet, device="cpu").model, cp.CPnet)
    assert CellposeConfig().tile is None                        # the network's own tile
    frames = torch.as_tensor(_frames(n=1, size=96))
    own = CellposeConfig(tile_chunk=16, flow_threshold=0.0)
    assert torch.equal(CellposeBackend(None, own, model=backend.model)(frames),
                       CellposeBackend(None, dataclasses.replace(own, tile=64),
                                       model=backend.model)(frames))


def test_select_backend_and_segment_frame_take_cellpose_sam(arrays):
    seg = SegConfig(backend="cellpose_sam")
    published = _state_arrays(vit_sam.ViTSAM(dim=64, depth=1, heads=1, hidden=64, neck=16))
    primary, twin, net = select_backend(seg, 128, published, "cpu")
    assert isinstance(net, vit_sam.ViTSAM) and twin.model is net
    assert primary.cfg == CellposeConfig()
    # one backend under two names: the weights pick the network
    cpnet = cp.cellpose_state_to_numpy(cp.init_cpnet(0, (2, 8, 16, 32, 64)))
    assert isinstance(select_backend(seg, 128, cpnet, "cpu")[2], cp.CPnet)
    assert isinstance(select_backend(SegConfig(backend="cellpose"), 128, arrays, "cpu")[2],
                      vit_sam.ViTSAM)
    with pytest.raises(ValueError, match="needs its CPnet or ViT model"):
        segment_frame(torch.zeros(1, 64, 64), seg)
    labels = segment_frame(torch.as_tensor(_frames(n=1, size=256)), seg,
                           model=vit_sam.build_vit_sam(published, "cpu"))
    assert labels.shape == (1, 256, 256) and labels.dtype == torch.int32


def test_cli_screen_reads_cellpose_sam_weights(arrays, tmp_path):
    import argparse

    parser = argparse.ArgumentParser()
    cli.add_screen_arguments(parser)
    path = str(tmp_path / "sam.npz")
    save_cellpose_weights(path, arrays)
    args = parser.parse_args(["--models", "m", "--sample", "a=b", "--backend", "cellpose_sam",
                              "--cellpose-weights", path])
    got = cli.load_unet(args)
    assert sorted(got) == sorted(arrays) and vit_sam.is_vit_state(got)
    with pytest.raises(SystemExit):
        cli.load_unet(parser.parse_args(["--models", "m", "--sample", "a=b", "--backend",
                                         "cellpose_sam"]))


def test_a_vit_forward_records_its_spans_and_counters(model):
    profiler.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        with torch.no_grad():
            model(torch.zeros(3, 64, 64, 3))
    c = profiler.counters()
    assert (c["vit.tiles"], c["vit.tokens"], c["vit.attention_calls"]) == (3, 3 * 64, 2)
    assert c.get("vit.attention_fused", 0) == 0                 # the CPU's plain form
    spans = profiler.summary()["spans"]
    for name in ("vit.patch_embed", "vit.blocks", "vit.attention", "vit.mlp", "vit.neck",
                 "vit.readout"):
        assert name in spans, name
    assert spans["vit.attention"]["calls"] == 2
    profiler.reset()


def test_key_permuted_vt_is_the_kernels_order():
    v = torch.arange(2 * 16 * 3, dtype=torch.float32).reshape(2, 16, 3)
    vt = key_permuted_vt(v)
    assert vt.shape == (2, 3, 16) and vt.is_contiguous()
    order = [0, 2, 4, 6, 1, 3, 5, 7]
    for b in range(2):
        for d in range(3):
            want = [v[b, 8 * c + order[j], d] for c in range(2) for j in range(8)]
            assert vt[b, d].tolist() == want


def test_the_trainer_steps_a_low_rank_vit():
    rng = np.random.default_rng(0)
    images = torch.rand(2, 96, 96)
    labels = torch.as_tensor(rng.integers(0, 3, (2, 96, 96)), dtype=torch.int32)
    flows = torch.randn(2, 2, 96, 96)
    model = vit_sam.low_rank_(vit_sam.init_vit_sam(0, **WIDTHS), 2, 11)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    model, log = tr.fit_cellpose(model, images, labels, flows, steps=2, batch=2, log_every=1)
    after = model.state_dict()
    assert len(log) == 2 and not model.training
    for k in before:
        if k.endswith(".base"):                                 # the seeded bases stay
            assert torch.equal(before[k], after[k]), k
        elif k.endswith((".a", "pos_embed", "out.weight", "rel_pos_h")):
            assert not torch.equal(before[k], after[k]), k


def _grads(fn, ins, dout) -> list:
    ins = [t.detach().clone().requires_grad_(True) for t in ins]
    out = fn(*ins, 0.125)
    return [out.detach(), *torch.autograd.grad(out, ins, dout)]


def _grad_inputs(device, bh: int, seed: int, dtype=torch.float32) -> tuple:
    g = torch.Generator(device=device).manual_seed(seed)
    shapes = [(bh, 1024, 64)] * 3 + [(bh, 1024, 32)] * 2
    ins = [torch.randn(s, generator=g, device=device, dtype=dtype) for s in shapes]
    return ins, torch.randn(bh, 1024, 64, generator=g, device=device, dtype=dtype)


@pytest.mark.parametrize("seed", [0, 1])
def test_the_ops_gradient_is_the_plain_forms(seed):
    ins, dout = _grad_inputs("cpu", 2, seed, torch.float64)
    profiler.reset()
    got = _grads(vit_attention, ins, dout)
    assert profiler.counters()["vit.attention_calls"] == 1     # the backward is not a call
    want = _grads(vit_attention_plain, ins, dout)
    for a, b in zip(got, want):
        assert torch.allclose(a, b, rtol=0, atol=1e-12 * float(b.abs().max()))
    # a tensor that needs no grad gets none, and the forward is the op's own
    q, k, v, rel_h, rel_w = (t.detach().requires_grad_(i < 3) for i, t in enumerate(ins))
    out = VitAttentionFn.apply(q, k, v, rel_h, rel_w, 0.125)
    out.backward(dout)
    assert rel_h.grad is None and rel_w.grad is None and q.grad is not None
    profiler.reset()


@pytest.mark.parametrize("path", ["scripts/make_cellpose_sam_weights_torch.py",
                                  "cell_image_analysis_tpu_torch/models/vit_sam.py",
                                  "cell_image_analysis_tpu_torch/ops/vit_attention.py",
                                  "cell_image_analysis_tpu_torch/ops/cuda/vit_attention.py",
                                  "benchmark/reference/cellpose_sam.py",
                                  "benchmark/backends/cellpose_sam/reference.py",
                                  "benchmark/backends/cellpose_sam/counts.py"])
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
        pytest.skip("needs an NVIDIA GPU (the vit_attention kernel)")
    return torch.device("cuda", 0)


def _attention_inputs(device, bh: int = 1600, seed: int = 0) -> tuple:
    g = torch.Generator(device=device).manual_seed(seed)
    q, k, v = (torch.randn(bh, 1024, 64, generator=g, device=device) for _ in range(3))
    rel_h, rel_w = (torch.randn(bh, 1024, 32, generator=g, device=device) for _ in range(2))
    return q, k, v, rel_h, rel_w


@pytest.mark.cuda
def test_the_kernel_attends_as_the_plain_form(cuda_device):
    from cell_image_analysis_tpu_torch.ops.cuda import vit_attention as launcher

    q, k, v, rel_h, rel_w = _attention_inputs(cuda_device)      # 100 tiles x 16 heads
    profiler.reset()
    before = launcher.LAUNCHES
    with torch.no_grad():
        got = vit_attention(q, k, v, rel_h, rel_w, 0.125)
    torch.cuda.synchronize()
    assert launcher.LAUNCHES == before + 1
    c = profiler.counters()
    assert c["vit.attention_calls"] == c["vit.attention_fused"] == 1
    for s in range(0, 1600, 400):                               # the plain form in slices
        sl = slice(s, s + 400)
        want = vit_attention_plain(q[sl], k[sl], v[sl], rel_h[sl], rel_w[sl], 0.125)
        err = (got[sl] - want).abs().max() / want.abs().max()
        assert err.item() <= 1e-5, (s, err.item())
    profiler.reset()


@pytest.mark.cuda
def test_the_fused_vit_matches_the_plain_one(cuda_device, monkeypatch):
    from cell_image_analysis_tpu_torch.ops.cuda import vit_attention as launcher

    net = vit_sam.init_vit_sam(1, dim=128, depth=2, heads=2, hidden=256, neck=32)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if "rel_pos" in name:
                p.copy_(torch.randn(p.shape, generator=torch.Generator().manual_seed(3)) * 0.5)
    net = net.to(cuda_device).eval()
    x = torch.rand(4, 256, 256, 3, device=cuda_device)
    profiler.reset()
    with torch.no_grad():
        fused = net(x)
        assert profiler.counters()["vit.attention_fused"] == 2
        monkeypatch.setattr(launcher, "vit_attention_cuda", vit_attention_plain)
        plain = net(x)
    err = (fused - plain).abs().max() / plain.abs().max()
    assert err.item() <= 1e-5
    profiler.reset()


@pytest.mark.parametrize("seed", [0, 1])
def test_the_kernels_emulation_attends_as_the_plain_form(seed):
    from torch_port_helpers import vit_attention_kernel_emulation

    g = torch.Generator().manual_seed(seed)
    bh, n = 2, 256                                              # a key grid of 8 x 32 tokens
    q, k, v = (torch.randn(bh, n, 64, generator=g) * 2 for _ in range(3))
    rel_h, rel_w = torch.randn(bh, n, 8, generator=g), torch.randn(bh, n, 32, generator=g)
    got = vit_attention_kernel_emulation(q.numpy(), k.numpy(), key_permuted_vt(v).numpy(),
                                         rel_h.numpy(), rel_w.numpy(), 0.125)
    want = vit_attention_plain(q, k, v, rel_h, rel_w, 0.125).numpy()
    _close(got, want)


@pytest.mark.cuda
def test_the_ops_gradient_on_the_card_is_the_plain_forms(cuda_device):
    ins, dout = _grad_inputs(cuda_device, 32, 5)
    profiler.reset()
    got = _grads(vit_attention, ins, dout)
    assert profiler.counters()["vit.attention_fused"] == 1     # the forward is the kernel
    want = _grads(vit_attention_plain, ins, dout)
    for a, b in zip(got, want):
        err = (a - b).abs().max() / b.abs().max()
        assert err.item() <= 1e-5, err.item()
    profiler.reset()


@pytest.mark.cuda
def test_shapes_the_kernel_does_not_take_raise_on_the_card(cuda_device):
    q, k, v, rel_h, rel_w = _attention_inputs(cuda_device, bh=2)
    with torch.no_grad():
        with pytest.raises(ValueError, match="outside the kernel"):
            vit_attention(q[..., :32], k[..., :32], v[..., :32], rel_h, rel_w, 0.125)
        with pytest.raises(ValueError, match="outside the kernel"):         # a 64 x 16 grid
            vit_attention(q, k, v, rel_h.repeat(1, 1, 2), rel_w[..., :16], 0.125)
