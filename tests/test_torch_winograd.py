"""PyTorch port: the Winograd conv op's plain version against the JAX
Winograd kernel (Pallas, interpret mode) and the JAX direct conv.  The
plain version is a float32 F.conv2d; the JAX kernel's 3-pass bf16
products sit at ~2^-17 relative, hence the 5e-5 bound of
tests/test_winograd.py.  The fused activations (input prologue, output
ReLU): the plain version and the kernel's emulation against the unfused
composition, at a shift that is positive, so that padding read as
relu(shift) would show."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import (
    WINO_ACT_CASES,
    torch_threads,
    wino_act_inputs,
    wino_act_unfused,
    winograd_3xtf32,
)

from cell_image_analysis_tpu_torch.ops.winograd import (
    winograd_conv3x3,
    winograd_conv3x3_plain,
    winograd_kernel_transform,
)

torch_threads()


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


@pytest.mark.parametrize(
    "b,h,w,ci,co,th,tw",
    [
        (1, 64, 64, 128, 128, 16, 16),
        (2, 64, 96, 64, 128, 16, 16),
        (1, 36, 40, 32, 64, 8, 8),
    ],
)
def test_plain_matches_jax_pallas_winograd(b, h, w, ci, co, th, tw):
    from cell_image_analysis_tpu.ops.pallas.winograd import winograd_conv3x3_pallas

    x = _rand((b, h, w, ci), 4, 0.5)
    W = _rand((3, 3, ci, co), 5, 1.0 / np.sqrt(9 * ci))
    bias = _rand((co,), 6, 0.1)
    ref = np.asarray(winograd_conv3x3_pallas(jnp.asarray(x), jnp.asarray(W), jnp.asarray(bias),
                                             th=th, tw=tw, interpret=True))
    y = winograd_conv3x3(torch.from_numpy(x), torch.from_numpy(W), torch.from_numpy(bias))
    assert y.shape == (b, h, w, co)
    assert float(np.abs(y.numpy() - ref).max()) / float(np.abs(ref).max()) < 5e-5


def test_plain_matches_jax_direct_conv_single_input_channel():
    # the U-Net's first conv (Ci = 1) goes through the op too
    x = _rand((2, 64, 64, 1), 0)
    W = _rand((3, 3, 1, 32), 1, 0.2)
    bias = _rand((32,), 2, 0.1)
    ref = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(W), (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision=jax.lax.Precision.HIGHEST) + bias)
    y = winograd_conv3x3(torch.from_numpy(x), torch.from_numpy(W), torch.from_numpy(bias))
    assert float(np.abs(y.numpy() - ref).max()) / float(np.abs(ref).max()) < 1e-5


def test_kernel_transform_matches_jax():
    from cell_image_analysis_tpu.ops.winograd import winograd_kernel_transform as jax_transform

    W = _rand((3, 3, 8, 16), 3)
    ref = np.asarray(jax_transform(jnp.asarray(W)))
    got = winograd_kernel_transform(torch.from_numpy(W)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_cpu_wrapper_is_the_plain_version_at_even_and_odd_sides():
    """The CPU wrapper is the plain version at even and at odd sides."""
    x = torch.from_numpy(_rand((1, 8, 10, 3), 7))
    W = torch.from_numpy(_rand((3, 3, 3, 5), 8))
    torch.testing.assert_close(winograd_conv3x3(x, W), winograd_conv3x3_plain(x, W),
                               rtol=0, atol=0)
    # the CUDA route pads odd sides to even (tests/test_torch_cuda_kernels.py);
    # the CPU route is the plain version
    x7 = torch.from_numpy(_rand((1, 7, 9, 3), 9))
    torch.testing.assert_close(winograd_conv3x3(x7, W), winograd_conv3x3_plain(x7, W),
                               rtol=0, atol=0)


# ---- the fused activations ------------------------------------------------


@pytest.mark.parametrize("case", WINO_ACT_CASES, ids=str)
def test_fused_plain_version_is_the_unfused_composition(case):
    """The op with an input prologue or an output ReLU (on the CPU: the
    plain version) against the activation, the conv and the ReLU as
    separate passes."""
    x, W, bias, kw = wino_act_inputs(case)
    got = winograd_conv3x3(x, W, bias, **kw)
    ref = wino_act_unfused(x, W, bias, **kw)
    assert got.shape == ref.shape == (*x.shape[:3], W.shape[-1])
    assert float((got - ref).abs().max()) <= 1e-6 * float(ref.abs().max())


@pytest.mark.parametrize("case", WINO_ACT_CASES, ids=str)
def test_kernel_emulation_of_the_prologue_pads_the_activated_input(case):
    """The CUDA route's design, emulated on the CPU: the even padding and
    Ci's zero channels, the prologue on in-frame pixels only, 3xTF32
    products.  The shift is positive, so a border or a padded row read as
    relu(shift) instead of 0 would miss the composition."""
    x, W, bias, kw = wino_act_inputs(case)
    got = winograd_3xtf32(x, W, bias, **kw)
    ref = wino_act_unfused(x, W, bias, **kw)
    assert float((got - ref).abs().max()) < 1e-5 * float(ref.abs().max())


@pytest.mark.parametrize("kw", [dict(in_scale=True), dict(in_shift=True),
                                dict(in_scale=True, in_shift=True, out_relu=True)], ids=str)
def test_the_op_refuses_a_half_prologue_or_both_activations(kw):
    """The prologue takes a scale and a shift, and a call takes it or the
    output ReLU: the kernel has no instance with both."""
    x, W, bias, full = wino_act_inputs((2, 6, 8, 3, 5, "image"))
    kw = {k: full[k] if k.startswith("in_") else v for k, v in kw.items()}
    with pytest.raises(ValueError, match="go together"):
        winograd_conv3x3(x, W, bias, **kw)


def test_activations_under_grad_run_around_the_fn():
    """Under grad the prologue is PyTorch ops around `WinogradConv3x3Fn`,
    and its gradients reach the scale and shift."""
    from cell_image_analysis_tpu_torch.ops.winograd import WinogradConv3x3Fn

    x, W, bias, kw = wino_act_inputs((2, 8, 10, 4, 6, "image"))
    scale = kw["in_scale"].clone().requires_grad_()
    shift = kw["in_shift"].clone().requires_grad_()
    y = winograd_conv3x3(x, W, bias, in_scale=scale, in_shift=shift)
    assert isinstance(y.grad_fn, WinogradConv3x3Fn._backward_cls)
    y.sum().backward()
    ref_scale = kw["in_scale"].clone().requires_grad_()
    ref_shift = kw["in_shift"].clone().requires_grad_()
    wino_act_unfused(x, W, bias, ref_scale, ref_shift).sum().backward()
    torch.testing.assert_close(scale.grad, ref_scale.grad, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(shift.grad, ref_shift.grad, rtol=1e-5, atol=1e-5)
