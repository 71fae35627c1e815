"""PyTorch port: the hand-written CUDA kernels against their plain versions
on the GPU, at small and ragged shapes.  A CUDA kernel has no CPU mode, so
these skip without a GPU; on a GPU machine run

    python -m pytest tests/test_torch_cuda_kernels.py -q
"""

import numpy as np
import pytest
import torch

from torch_port_helpers import padded_crops, torch_threads

pytestmark = pytest.mark.cuda
torch_threads()


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


# (Ci, Co) of the U-Net's 13 3x3 convs, Conv_0 .. Conv_12
UNET_CONVS = [(1, 32), (32, 32), (32, 64), (64, 64), (64, 128), (128, 128), (128, 256),
              (256, 256), (384, 128), (128, 128), (192, 64), (64, 64), (64, 128)]
WINO_CASES = ([(1, 8, 8, 1, 32), (2, 18, 22, 5, 7), (1, 34, 66, 64, 130), (1, 33, 17, 16, 32)]
              + [(2, 20, 36, ci, co) for ci, co in UNET_CONVS]      # 10x18 tiles: ragged blocks
              + [(1, 66, 130, 32, 64), (1, 2, 2, 8, 32), (3, 2, 46, 24, 40), (1, 130, 2, 3, 1)])


@pytest.mark.parametrize("b,h,w,ci,co", WINO_CASES)
def test_winograd_kernel_matches_plain(dev, b, h, w, ci, co):
    from cell_image_analysis_tpu_torch.ops.cuda import winograd as launcher
    from cell_image_analysis_tpu_torch.ops.winograd import winograd_conv3x3, winograd_conv3x3_plain

    g = torch.Generator(device=dev).manual_seed(ci * co)
    x = torch.randn((b, h, w, ci), generator=g, device=dev)
    W = torch.randn((3, 3, ci, co), generator=g, device=dev) / (3 * ci ** 0.5)
    bias = torch.randn((co,), generator=g, device=dev)
    before = launcher.LAUNCHES
    y = winograd_conv3x3(x, W, bias)
    assert launcher.LAUNCHES == before + 1
    ref = winograd_conv3x3_plain(x, W, bias)
    assert y.shape == ref.shape
    assert float((y - ref).abs().max()) / float(ref.abs().max()) < 1e-5


def test_winograd_launcher_rejects_what_the_kernel_does_not_take(dev):
    from cell_image_analysis_tpu_torch.ops.cuda.winograd import winograd_conv3x3_cuda
    from cell_image_analysis_tpu_torch.ops.winograd import winograd_operands

    ops = winograd_operands(torch.randn((3, 3, 8, 40), device=dev))
    x = torch.randn((1, 8, 8, 8), device=dev)
    winograd_conv3x3_cuda(x, *ops)
    for bad in (x[..., :5], x[:, :7], x.double()):
        with pytest.raises((ValueError, TypeError)):
            winograd_conv3x3_cuda(bad, *ops)
    with pytest.raises(ValueError):
        winograd_conv3x3_cuda(x, ops[0][:1], ops[1], ops[2])        # one Co block of two
    with pytest.raises(ValueError):
        winograd_conv3x3_cuda(x.cpu(), *ops)


def test_segment_sum_kernel_matches_plain(dev):
    from cell_image_analysis_tpu_torch.ops.cuda import segsum as launcher
    from cell_image_analysis_tpu_torch.ops.segsum import segment_sums, segment_sums_plain

    rng = np.random.default_rng(0)
    seg = torch.tensor(rng.integers(-2, 40, size=5000).astype(np.int32), device=dev)
    data = torch.tensor(rng.integers(-10**9, 10**9, size=(5000, 6)), device=dev)
    before = launcher.LAUNCHES
    got = segment_sums(seg, data, 37)
    assert launcher.LAUNCHES == before + 1
    assert torch.equal(got, segment_sums_plain(seg, data, 37))
    with pytest.raises(TypeError):
        segment_sums(seg, data.float(), 37)


def _clahe_inputs(dev, cap, ns_cap, n_cells, seed, full_cap=192):
    """n_cells crops of random sides up to cap (ns_cap 12: no side of
    13-15), scattered over a larger (N, full_cap, full_cap) crop tensor
    with garbage around them, as stage A leaves them."""
    rng = np.random.default_rng(seed)
    sides = rng.integers(1, cap + 1, size=(n_cells, 2))
    if ns_cap == 12:
        sides = np.where((sides >= 13) & (sides <= 15), 16, sides)
    crops, hs, ws = padded_crops(rng, [tuple(s) for s in sides], full_cap)
    N = n_cells + n_cells // 2 + 3
    order = rng.permutation(N)[:n_cells]
    big = np.full((N, full_cap, full_cap), 3e8, np.float32)
    big[order] = crops
    heights, widths = np.ones(N, np.int32), np.ones(N, np.int32)
    heights[order], widths[order] = hs, ws
    return [torch.from_numpy(a).to(dev) for a in (big, order.astype(np.int32), heights, widths)]


@pytest.mark.parametrize("n_cells", [1, 32, 131, 132, 800])
@pytest.mark.parametrize("cap,ns_cap", [(64, 12), (96, 12), (192, 16)])
def test_clahe_kernel_bit_equal_to_plain(dev, cap, ns_cap, n_cells):
    """4 blocks a cell below one cell an SM (132 on an H100), else 2."""
    from cell_image_analysis_tpu_torch.ops.clahe import clahe_cells_plain
    from cell_image_analysis_tpu_torch.ops.cuda import clahe_kernel as launcher

    crops, ids, hs, ws = _clahe_inputs(dev, cap, ns_cap, n_cells, cap + n_cells)
    idx = ids.long()
    ref = clahe_cells_plain(crops[idx][:, :cap, :cap], hs[idx], ws[idx], ns_cap=ns_cap)
    before = launcher.LAUNCHES
    got = launcher.clahe_cells_cuda(crops, ids, hs, ws, cap, ns_cap=ns_cap)
    assert launcher.LAUNCHES == before + 1
    torch.cuda.synchronize()
    assert got.shape == (n_cells, cap, cap) and not bool(torch.isnan(got).any())
    assert torch.equal(got, ref)


def test_clahe_bucket_reads_crops_in_place(dev):
    from cell_image_analysis_tpu_torch.ops.clahe import clahe_bucket, clahe_cells
    from cell_image_analysis_tpu_torch.ops.cuda import clahe_kernel as launcher

    crops, ids, hs, ws = _clahe_inputs(dev, 96, 12, 40, 5)
    before_crops = crops.clone()
    idx = ids.long()
    ref = clahe_cells(crops[idx][:, :96, :96].cpu(), hs[idx].cpu(), ws[idx].cpu(), ns_cap=12)
    before = launcher.LAUNCHES
    got = clahe_bucket(crops, ids, hs, ws, 96, ns_cap=12)
    assert launcher.LAUNCHES == before + 1
    assert torch.equal(got.cpu(), ref)
    assert torch.equal(crops, before_crops)
    # clahe_cells on a CUDA tensor is the same kernel over all its cells
    again = clahe_cells(crops[idx][:, :96, :96], hs[idx], ws[idx], ns_cap=12)
    assert launcher.LAUNCHES == before + 2
    assert torch.equal(again.cpu(), ref)


def test_clahe_kernel_rejects_what_it_does_not_take(dev):
    from cell_image_analysis_tpu_torch.ops.cuda.clahe_kernel import clahe_cells_cuda

    crops = torch.rand((4, 96, 96), device=dev) * 100
    ids = torch.arange(4, dtype=torch.int32, device=dev)
    hw = torch.full((4,), 40, dtype=torch.int32, device=dev)
    clahe_cells_cuda(crops, ids, hw, hw, 64, ns_cap=12)
    for bad in (dict(crops=crops.double()), dict(ids=ids.long()), dict(hs=hw.float())):
        args = dict(crops=crops, ids=ids, hs=hw)
        args.update(bad)
        with pytest.raises(TypeError):
            clahe_cells_cuda(args["crops"], args["ids"], args["hs"], hw, 64, ns_cap=12)
    for kw in (dict(ns_cap=17), dict(cap=97)):
        with pytest.raises(ValueError):
            clahe_cells_cuda(crops, ids, hw, hw, **{"cap": 64, "ns_cap": 12, **kw})
    with pytest.raises(ValueError):
        clahe_cells_cuda(crops.transpose(1, 2), ids, hw, hw, 64)        # not contiguous
    with pytest.raises(ValueError):
        clahe_cells_cuda(crops.cpu(), ids, hw, hw, 64)
    # a cell above the bucket's capacity comes out NaN, nothing is written out of bounds
    hs = hw.clone()
    hs[2] = 80
    out = clahe_cells_cuda(crops, ids, hs, hw, 64, ns_cap=12)
    torch.cuda.synchronize()
    assert bool(torch.isnan(out[2]).all()) and not bool(torch.isnan(out[[0, 1, 3]]).any())


def _serpentine(h, w, step=2):
    """Rows 0, step, 2 step, ... full width, joined alternately at the right
    and the left end: one component that crosses every tile."""
    m = np.zeros((h, w), bool)
    m[::step] = True
    for i, r in enumerate(range(step, h, step)):
        m[r - step + 1:r, w - 1 if i % 2 == 0 else 0] = True
    return m


def _corner_touch(h=64, w=192):
    """Pairs of blocks that touch only diagonally across the kernel's 32 x 64
    tile edges: at a tile corner (both diagonals), across a row edge and
    across a column edge.  Eight components at connectivity 1, four at 2."""
    m = np.zeros((h, w), bool)
    m[28:32, 60:64] = m[32:36, 64:68] = True       # corner (32, 64), down-right
    m[28:32, 128:132] = m[32:36, 124:128] = True   # corner (32, 128), down-left
    m[26:32, 69:72] = m[32:36, 72:75] = True       # across the row edge in tile column 1
    m[10, 63] = m[11, 64] = True                   # across the column edge in tile row 0
    return m


def _cc_masks():
    rng = np.random.default_rng(4)
    yy, xx = np.mgrid[0:96, 0:96]
    serp = np.zeros((96, 96), bool)
    for i, r in enumerate(range(4, 92, 8)):
        serp[r, 4:92] = True
        serp[r:r + 9, 91 if i % 2 == 0 else 4] = True
    blobs = np.random.default_rng(5).random((3, 70, 200)) < 0.57
    blobs[1] = False            # an empty frame in the batch
    return {
        "1x1": (np.ones((1, 1, 1), bool), 1),
        "7x300": (rng.random((1, 7, 300)) < 0.6, 1),
        "2x129x257": (rng.random((2, 129, 257)) < 0.55, 2),
        "all_true": (np.ones((3, 64, 48), bool), 1),
        "checkerboard": (((yy + xx) % 2 == 0)[None], 2),
        "serpentine": (serp[None], 1),
        # sides of tile - 1, tile, tile + 1 around the kernel's 32 x 64 tile
        **{f"sides_{h}x{w}": (rng.random((2, h, w)) < 0.58, 2)
           for h, w in ((31, 63), (32, 64), (33, 65), (65, 129), (1, 200), (97, 1))},
        "corner_touch": (_corner_touch()[None], 2),
        "empty_frame_in_batch": (blobs, 2),
    }


@pytest.mark.parametrize("name", sorted(_cc_masks()))
def test_cc_kernel_matches_plain(dev, name):
    from cell_image_analysis_tpu_torch.ops.cc import label_components, label_components_plain
    from cell_image_analysis_tpu_torch.ops.cuda import cc as launcher

    mask_np, conn = _cc_masks()[name]
    mask = torch.from_numpy(mask_np).to(dev)
    for c in sorted({1, conn}):
        before = launcher.LAUNCHES
        got, count = label_components(mask, connectivity=c)
        assert launcher.LAUNCHES == before + 1
        ref, ref_count = label_components_plain(mask, connectivity=c)
        torch.cuda.synchronize()
        assert got.dtype == torch.int32 and got.shape == mask.shape
        assert count.dtype == torch.int32 and count.shape == (mask.shape[0],)
        assert torch.equal(got, ref), f"connectivity {c}"
        assert torch.equal(count, ref_count), f"connectivity {c}"
    if name == "checkerboard":   # one component at 8-connectivity
        assert int(got.max()) == 1 and int(count[0]) == 1
    if name == "corner_touch":
        assert int(label_components(mask, 1)[1][0]) == 8 and int(count[0]) == 4


@pytest.mark.parametrize("conn", [1, 2])
def test_cc_kernel_on_1024_frames_matches_scipy(dev, conn):
    """All true and a serpentine through every tile, where the plain sweeps
    would need ~half a million passes."""
    from scipy import ndimage as ndi

    from cell_image_analysis_tpu_torch.ops.cc import label_components
    from cell_image_analysis_tpu_torch.ops.cuda import cc as launcher

    host = np.stack([np.ones((1024, 1024), bool), _serpentine(1024, 1024)])
    before = launcher.LAUNCHES
    got, count = label_components(torch.from_numpy(host).to(dev), conn)
    assert launcher.LAUNCHES == before + 1
    for b in range(2):
        ref, n = ndi.label(host[b], structure=None if conn == 1 else np.ones((3, 3), bool))
        assert n == 1 and int(count[b]) == 1
        assert np.array_equal(got[b].cpu().numpy(), ref)


def test_cc_kernel_rejects_what_it_does_not_take(dev):
    from cell_image_analysis_tpu_torch.ops.cuda.cc import label_components_cuda

    mask = torch.rand((2, 40, 70), device=dev) < 0.5
    label_components_cuda(mask, 1)
    with pytest.raises(ValueError):
        label_components_cuda(mask.cpu(), 1)
    for bad in (mask.to(torch.uint8), mask[0]):
        with pytest.raises(TypeError):
            label_components_cuda(bad, 1)
    with pytest.raises(ValueError):
        label_components_cuda(mask.transpose(1, 2), 1)         # not contiguous
    with pytest.raises(ValueError):
        label_components_cuda(mask, 3)


@pytest.fixture
def second_dev():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs: the kernels run off the current device")
    assert torch.cuda.current_device() == 0
    return torch.device("cuda", 1)


@pytest.mark.parametrize("kernel", ["winograd", "segment_sum", "clahe", "cc"])
def test_kernel_on_a_device_that_is_not_current(second_dev, kernel):
    """Each kernel on `cuda:1` with `cuda:0` current, after a first launch
    on `cuda:0` (so that whatever a launcher remembers was remembered for
    another device), against its plain version; and a rejection of inputs
    on two devices."""
    from cell_image_analysis_tpu_torch.ops.cc import label_components, label_components_plain
    from cell_image_analysis_tpu_torch.ops.clahe import clahe_cells, clahe_cells_plain
    from cell_image_analysis_tpu_torch.ops.cuda.segsum import segment_sums_cuda
    from cell_image_analysis_tpu_torch.ops.segsum import segment_sums, segment_sums_plain
    from cell_image_analysis_tpu_torch.ops.winograd import winograd_conv3x3, winograd_conv3x3_plain

    rng = np.random.default_rng(1)
    for d in (torch.device("cuda", 0), second_dev):
        if kernel == "winograd":
            x = torch.tensor(rng.normal(size=(2, 20, 36, 64)).astype(np.float32), device=d)
            W = torch.tensor(rng.normal(size=(3, 3, 64, 128)).astype(np.float32) / 24, device=d)
            y, ref = winograd_conv3x3(x, W), winograd_conv3x3_plain(x, W)
            assert y.device == d
            assert float((y - ref).abs().max()) / float(ref.abs().max()) < 1e-5
        elif kernel == "segment_sum":
            seg = torch.tensor(rng.integers(-2, 40, size=5000).astype(np.int32), device=d)
            data = torch.tensor(rng.integers(-10**9, 10**9, size=(5000, 6)), device=d)
            got = segment_sums(seg, data, 37)
            assert got.device == d and torch.equal(got, segment_sums_plain(seg, data, 37))
            if d == second_dev:
                with pytest.raises(ValueError, match="one CUDA device"):
                    segment_sums_cuda(seg.to("cuda:0"), data, 37)
        elif kernel == "clahe":
            crops, hs, ws = padded_crops(rng, [(40, 50), (64, 17), (20, 20)], 64)
            t = [torch.tensor(a, device=d) for a in (crops, hs, ws)]
            got = clahe_cells(*t, ns_cap=12)
            assert got.device == d and torch.equal(got, clahe_cells_plain(*t, ns_cap=12))
        else:
            mask = torch.tensor(rng.random((2, 70, 130)) < 0.55, device=d)
            got, ref = label_components(mask), label_components_plain(mask)
            assert got[0].device == d
            assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
        assert torch.cuda.current_device() == 0
