"""PyTorch port: the ViT blocks' linears (`ops.vit_linear`, the 3xTF32
tensor-core GEMM `csrc/vit_linear.cu`) and their route through
`models.vit_sam`, on the CPU:

- `vit_linear` on CPU tensors is `F.linear` bit for bit, and the ViT's
  forward is what it was with `nn.Linear` calls, bit for bit;
- a depth-24 forward counts 96 `vit.linear_calls` (none fused on the CPU);
- the autograd route's gradients are `F.linear`'s;
- a numpy emulation of the kernel (`torch_port_helpers.
  vit_linear_kernel_emulation`: its swizzled stages, ldmatrix and
  descriptor addresses, split and product order, with the tensor cores'
  float32 sums rounded toward zero) is within 2x float32 `F.linear`'s own
  error of the float64 product at K = 4,096, where one chain over the whole
  of K is not.

The tests marked `cuda` hold the kernel to the float64 product at the four
linears of Cellpose-SAM's blocks (at most 2x cuBLAS float32's error on the
same inputs), count `vit.linear_fused`, hold the op's gradient on the card
to `F.linear`'s and check that shapes the kernel does not take raise; they
skip without a card.  On a GPU machine:

    python -m pytest tests/test_torch_vit_linear.py -q -m cuda
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from torch_port_helpers import torch_threads, vit_linear_kernel_emulation

from cell_image_analysis_tpu_torch.models import vit_sam
from cell_image_analysis_tpu_torch.ops.vit_linear import VitLinearFn, vit_linear, vit_linear_plain
from cell_image_analysis_tpu_torch.utils import profiler

torch_threads()

NARROW = dict(dim=64, heads=4, hidden=128, patch=8, tile=64, neck=32)
SAM_LINEARS = {"qkv": (1024, 3072), "proj": (1024, 1024), "lin1": (1024, 4096),
               "lin2": (4096, 1024)}                    # (K, N)


def _inputs(M, K, N, seed=0, device="cpu", dtype=torch.float32):
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(M, K, generator=g, device=device, dtype=dtype)
    w = torch.randn(N, K, generator=g, device=device, dtype=dtype) * 0.02
    b = torch.randn(N, generator=g, device=device, dtype=dtype) * 0.1
    return x, w, b


@pytest.mark.parametrize("shape,bias", [((2, 3, 5, 64), True), ((7, 96), False),
                                        ((4, 32, 32, 128), True)])
def test_on_the_cpu_it_is_f_linear_bit_for_bit(shape, bias):
    x, w, b = _inputs(int(np.prod(shape[:-1])), shape[-1], 48, seed=len(shape))
    x = x.reshape(shape)
    b = b if bias else None
    profiler.reset()
    with torch.no_grad():
        got = vit_linear(x, w, b)
    assert torch.equal(got, F.linear(x, w, b)) and torch.equal(got, vit_linear_plain(x, w, b))
    c = profiler.counters()
    assert c["vit.linear_calls"] == 1 and c.get("vit.linear_fused", 0) == 0
    profiler.reset()


def _parent_forward(model, x):
    """The forward with every block linear as the `nn.Linear` call the
    network made before `ops.vit_linear`."""
    real = vit_sam._linear
    vit_sam._linear = lambda layer, t: layer(t)
    try:
        return model(x)
    finally:
        vit_sam._linear = real


@pytest.mark.parametrize("seed", [0, 1])
def test_the_vits_cpu_forward_is_the_parents_bit_for_bit(seed):
    model = vit_sam.init_vit_sam(seed, depth=2, **NARROW).eval()
    x = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        assert torch.equal(model(x), _parent_forward(model, x))


def test_a_depth_24_forward_counts_96_linear_calls():
    model = vit_sam.init_vit_sam(0, depth=24, **NARROW).eval()
    profiler.reset()
    with torch.no_grad():
        model(torch.rand(1, 64, 64, 3))
    c = profiler.counters()
    assert c["vit.linear_calls"] == 96 and c.get("vit.linear_fused", 0) == 0
    assert c["vit.attention_calls"] == 24
    profiler.reset()


def test_the_low_rank_form_keeps_its_own_linears():
    model = vit_sam.low_rank_(vit_sam.init_vit_sam(0, depth=2, **NARROW), 2, 11)
    profiler.reset()
    with torch.no_grad():
        model(torch.rand(1, 64, 64, 3))
    assert profiler.counters().get("vit.linear_calls", 0) == 0
    profiler.reset()


@pytest.mark.parametrize("dtype,bias", [(torch.float64, True), (torch.float32, True),
                                        (torch.float64, False)])
def test_the_autograd_routes_gradients_are_f_linears(dtype, bias):
    x, w, b = _inputs(24, 64, 32, seed=3, dtype=dtype)
    x = x.reshape(2, 12, 64)
    b = b if bias else None
    dout = torch.randn(2, 12, 32, generator=torch.Generator().manual_seed(4), dtype=dtype)

    def grads(fn):
        ins = [t.detach().clone().requires_grad_(True) for t in (x, w, b) if t is not None]
        out = fn(*ins) if bias else fn(*ins, None)
        return [out.detach(), *torch.autograd.grad(out, ins, dout)]

    profiler.reset()
    got = grads(vit_linear)
    assert profiler.counters()["vit.linear_calls"] == 1          # the backward is not a call
    want = grads(F.linear)
    for a, c in zip(got, want):
        assert torch.equal(a, c)
    # a tensor that needs no grad gets none
    xs, ws = x.detach().requires_grad_(True), w.detach()
    out = VitLinearFn.apply(xs, ws, b)
    out.backward(dout)
    assert xs.grad is not None and ws.grad is None
    profiler.reset()


@pytest.mark.parametrize("seed", [0, 1])
def test_the_kernels_emulation_is_within_twice_float32s_error_at_k_4096(seed):
    x, w, b = (t.numpy() for t in _inputs(128, 4096, 128, seed=seed))
    want = x.astype(np.float64) @ w.astype(np.float64).T + b
    scale = np.abs(want).max()
    f32 = np.abs(F.linear(*(torch.as_tensor(t) for t in (x, w, b))).numpy() - want).max() / scale
    got = np.abs(vit_linear_kernel_emulation(x, w, b) - want).max() / scale
    assert got <= 2 * f32, (got, f32)
    # without the float32 sum once a stage, 1,536 products chained in the tensor cores
    chained = np.abs(vit_linear_kernel_emulation(x, w, b, promote=False) - want).max() / scale
    assert chained > 10 * f32, (chained, f32)


def test_the_emulations_index_arithmetic_is_the_plain_product():
    # two tiles each way at K = 64: exact small integers, so every path reads 0 error
    rng = np.random.default_rng(5)
    x = rng.integers(-8, 9, (256, 64)).astype(np.float32)
    w = rng.integers(-8, 9, (256, 64)).astype(np.float32)
    b = rng.integers(-8, 9, 256).astype(np.float32)
    np.testing.assert_array_equal(vit_linear_kernel_emulation(x, w, b), x @ w.T + b)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the vit_linear kernel)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SAM_LINEARS))
def test_the_kernel_is_within_twice_cublas_error_of_float64(cuda_device, name):
    from cell_image_analysis_tpu_torch.ops.cuda import vit_linear as launcher

    K, N = SAM_LINEARS[name]
    x, w, b = _inputs(8192, K, N, seed=7, device=cuda_device)
    x = x.reshape(8, 1024, K)
    profiler.reset()
    before = launcher.LAUNCHES
    with torch.no_grad():
        got = vit_linear(x, w, b)
    torch.cuda.synchronize()
    assert launcher.LAUNCHES == before + 1 and got.shape == (8, 1024, N)
    c = profiler.counters()
    assert c["vit.linear_calls"] == c["vit.linear_fused"] == 1
    want = F.linear(x.double(), w.double(), b.double())
    scale = want.abs().max()
    err = float((got.double() - want).abs().max() / scale)
    lib = float((F.linear(x, w, b).double() - want).abs().max() / scale)
    assert err <= 2 * lib, (err, lib)
    profiler.reset()


@pytest.mark.cuda
def test_the_ops_gradient_on_the_card_is_f_linears(cuda_device):
    x, w, b = _inputs(256, 128, 256, seed=9, device=cuda_device)
    dout = torch.randn(256, 256, device=cuda_device)
    ins = [t.detach().clone().requires_grad_(True) for t in (x, w, b)]
    profiler.reset()
    out = vit_linear(*ins)
    assert profiler.counters()["vit.linear_fused"] == 1        # the forward is the kernel
    got = torch.autograd.grad(out, ins, dout)
    want_ins = [t.detach().clone().requires_grad_(True) for t in (x, w, b)]
    want = torch.autograd.grad(F.linear(*want_ins), want_ins, dout)
    for a, c in zip(got, want):
        assert torch.equal(a, c)
    ref = F.linear(x.double(), w.double(), b.double())
    assert float((out.detach().double() - ref).abs().max() / ref.abs().max()) <= 1e-6
    profiler.reset()


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", [(100, 64, 128), (256, 48, 128), (256, 64, 96)])
def test_shapes_the_kernel_does_not_take_raise_on_the_card(cuda_device, M, K, N):
    x, w, b = _inputs(M, K, N, device=cuda_device)
    with torch.no_grad():
        with pytest.raises(ValueError, match="outside the kernel"):
            vit_linear(x, w, b)


@pytest.mark.cuda
def test_the_kernel_without_a_bias_adds_zero(cuda_device):
    x, w, _ = _inputs(256, 64, 128, seed=11, device=cuda_device)
    with torch.no_grad():
        got = vit_linear(x, w)
        assert torch.equal(got, vit_linear(x, w, torch.zeros(128, device=cuda_device)))
    ref = F.linear(x.double(), w.double())
    assert float((got.double() - ref).abs().max() / ref.abs().max()) <= 1e-6
