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


@pytest.mark.parametrize("cap,ns_cap,sizes", [
    (64, 12, [(64, 64), (17, 23), (40, 12)]),
    (96, 16, [(96, 41), (15, 90), (50, 13)]),
    (192, 16, [(97, 41), (192, 192), (11, 64)]),
])
def test_clahe_kernel_bit_equal_to_cpu(dev, cap, ns_cap, sizes):
    from cell_image_analysis_tpu_torch.ops.clahe import clahe_cells
    from cell_image_analysis_tpu_torch.ops.cuda import clahe_kernel as launcher

    crops, hs, ws = padded_crops(np.random.default_rng(cap), sizes, cap)
    args = [torch.from_numpy(a) for a in (crops, hs, ws)]
    ref = clahe_cells(*args, ns_cap=ns_cap)
    before = launcher.LAUNCHES
    got = clahe_cells(*(a.to(dev) for a in args), ns_cap=ns_cap)
    assert launcher.LAUNCHES == before + 1
    assert torch.equal(got.cpu(), ref)


def test_clahe_kernel_rejects_oversized_tile_grid(dev):
    from cell_image_analysis_tpu_torch.ops.cuda.clahe_kernel import clahe_core_cuda

    z = torch.zeros((1, 512), dtype=torch.int32, device=dev)
    z4 = torch.zeros((1, 512, 4), dtype=torch.int32, device=dev)
    one = torch.ones(1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        clahe_core_cuda(z, z, z, z4, z4, one, one, n_tiles=17 * 17)


def _cc_masks():
    rng = np.random.default_rng(4)
    yy, xx = np.mgrid[0:96, 0:96]
    serp = np.zeros((96, 96), bool)
    for i, r in enumerate(range(4, 92, 8)):
        serp[r, 4:92] = True
        serp[r:r + 9, 91 if i % 2 == 0 else 4] = True
    return {
        "1x1": (np.ones((1, 1, 1), bool), 1),
        "7x300": (rng.random((1, 7, 300)) < 0.6, 1),
        "2x129x257": (rng.random((2, 129, 257)) < 0.55, 2),
        "all_true": (np.ones((3, 64, 48), bool), 1),
        "checkerboard": (((yy + xx) % 2 == 0)[None], 2),
        "serpentine": (serp[None], 1),
    }


@pytest.mark.parametrize("name", sorted(_cc_masks()))
def test_cc_kernel_matches_plain(dev, name):
    from cell_image_analysis_tpu_torch.ops.cc import cc_min_labels, cc_min_labels_plain
    from cell_image_analysis_tpu_torch.ops.cuda import cc as launcher

    mask_np, conn = _cc_masks()[name]
    mask = torch.from_numpy(mask_np).to(dev)
    for c in sorted({1, conn}):
        before = launcher.LAUNCHES
        got = cc_min_labels(mask, connectivity=c)
        assert launcher.LAUNCHES == before + 1
        ref = cc_min_labels_plain(mask, connectivity=c)
        torch.cuda.synchronize()
        assert got.dtype == torch.int32 and got.shape == mask.shape
        assert torch.equal(got, ref), f"connectivity {c}"
    if name == "checkerboard":   # one component at 8-connectivity, none larger at 4
        assert int(got.max()) == 1
