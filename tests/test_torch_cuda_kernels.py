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


@pytest.mark.parametrize("b,h,w,ci,co", [(1, 8, 8, 1, 32), (2, 18, 22, 5, 7), (1, 34, 66, 64, 130)])
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
    assert float((y - ref).abs().max()) / float(ref.abs().max()) < 1e-5


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
