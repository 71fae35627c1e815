"""PyTorch port: the numerics of the 3xTF32 Winograd kernel on the CPU.

The CUDA kernel cannot run here, so its arithmetic is emulated in float32
torch (`torch_port_helpers.winograd_3xtf32`: the wrapper's padding and
TF32-split operands, the kernel's transforms and three products) and held
at 1e-5 of max|ref| against the JAX direct conv at HIGHEST precision, and
against the JAX Winograd kernel (Pallas, interpret mode) up to that
kernel's own bf16 error, at the U-Net's channel pairs.  The TF32 split itself is checked bit by bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import (
    torch_threads,
    unblock_filter,
    winograd_3xtf32,
    winograd_kernel_emulation,
)

from cell_image_analysis_tpu_torch.ops.winograd import (
    kernel_filter_layout,
    pad_input,
    tf32_round,
    tf32_split,
    winograd_kernel_transform,
    winograd_operands,
)

torch_threads()

# (Ci, Co) of the U-Net layers the kernel must serve, at small sides
UNET_PAIRS = [(1, 32), (32, 32), (384, 128), (192, 64), (256, 256)]


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _bits(a: torch.Tensor) -> np.ndarray:
    return a.contiguous().view(torch.int32).numpy().view(np.uint32)


def _case(b, h, w, ci, co, seed=0):
    x = np.maximum(_rand((b, h, w, ci), seed), 0)       # post-ReLU activations
    W = _rand((3, 3, ci, co), seed + 1, 1.0 / np.sqrt(9 * ci))
    bias = _rand((co,), seed + 2, 0.1)
    return x, W, bias


def _rel(y: np.ndarray, ref: np.ndarray) -> float:
    return float(np.abs(y - ref).max()) / float(np.abs(ref).max())


def test_tf32_round_zeroes_the_low_13_bits_and_rounds_ties_away_from_zero():
    x = torch.from_numpy(_rand((4096,), 0) * np.float32(1e3))
    hi, lo = tf32_split(x)
    assert not (_bits(hi) & 0x1FFF).any() and not (_bits(lo) & 0x1FFF).any()
    pats = np.array([
        0x3F801000,   # 1 + 2^-11: the tie between 1 and 1 + 2^-10 -> away (even would be 1)
        0xBF801000,   # its negative -> -(1 + 2^-10)
        0x3F800FFF,   # just below the tie -> 1
        0x3F803000,   # tie between 1 + 2^-10 and 1 + 2^-9 -> 1 + 2^-9
        0x3FFFF000,   # tie below 2: the carry reaches the exponent -> 2
        0x00001000,   # a subnormal tie -> 0x2000
        0x00000000, 0x80000000, 0x7F800000,   # 0, -0, inf stay
    ], dtype=np.uint32)
    want = np.array([0x3F802000, 0xBF802000, 0x3F800000, 0x3F804000, 0x40000000, 0x00002000,
                     0x00000000, 0x80000000, 0x7F800000], dtype=np.uint32)
    got = _bits(tf32_round(torch.from_numpy(pats.view(np.float32))))
    np.testing.assert_array_equal(got, want)


def test_tf32_split_keeps_float32_accuracy():
    rng = np.random.default_rng(1)
    x = (rng.normal(size=20000) * 10.0 ** rng.integers(-20, 20, size=20000)).astype(np.float32)
    hi, lo = tf32_split(torch.from_numpy(x))
    xd = x.astype(np.float64)
    assert np.all(np.abs(xd - hi.numpy()) <= 2.0 ** -11 * np.abs(xd))
    assert np.all(np.abs(xd - hi.numpy().astype(np.float64) - lo.numpy()) <= 2.0 ** -21 * np.abs(xd))


def test_winograd_operands_pad_channels_for_the_kernel():
    W = torch.from_numpy(_rand((3, 3, 5, 40), 2))
    U_hi, U_lo, bias = winograd_operands(W)
    assert U_hi.shape == U_lo.shape == (2, 1, 16, 2, 32, 4) and bias.shape == (40,)
    U = unblock_filter(U_hi)
    assert not U[:, 5:].any() and not U[..., 40:].any() and not bias.any()
    torch.testing.assert_close(U[:, :5, :40], tf32_round(winograd_kernel_transform(W)
                                                         .reshape(16, 5, 40)), rtol=0, atol=0)
    x = torch.from_numpy(_rand((2, 7, 9, 5), 3))
    xp = pad_input(x)
    assert xp.shape == (2, 8, 10, 8)
    torch.testing.assert_close(xp[:, :7, :9, :5], x, rtol=0, atol=0)
    assert not xp[:, 7:].any() and not xp[:, :, 9:].any() and not xp[..., 5:].any()


def test_kernel_filter_layout_puts_each_ring_stage_in_one_run():
    """U[k, ci, co] sits at [co // 32, ci // 8, k, ci % 8 // 4, co % 32, ci % 4]:
    one (Co block, Ci slice) stage is contiguous, K-major inside."""
    U = torch.arange(16 * 16 * 64, dtype=torch.float32).reshape(16, 16, 64)
    Ub = kernel_filter_layout(U)
    assert Ub.shape == (2, 2, 16, 2, 32, 4) and Ub.is_contiguous()
    for k, ci, co in [(0, 0, 0), (5, 3, 7), (15, 15, 63), (9, 12, 33), (2, 8, 31)]:
        assert Ub[co // 32, ci // 8, k, ci % 8 // 4, co % 32, ci % 4] == U[k, ci, co]
    torch.testing.assert_close(unblock_filter(Ub), U, rtol=0, atol=0)


def _highest(x, W, bias):
    return np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(W), (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        precision=jax.lax.Precision.HIGHEST) + bias)


@pytest.mark.parametrize("ci,co", UNET_PAIRS)
def test_3xtf32_emulation_matches_jax_pallas_winograd(ci, co):
    """The JAX kernel's bf16 hi/lo products sit at ~2^-17 relative (6.6e-6
    to 1.2e-5 of max|ref| here, against the HIGHEST direct conv), which is
    above 1e-5 at Ci = 1.  So the emulation is held within 1e-5 of the
    JAX kernel wherever that kernel is itself within 1e-5 of the direct
    conv, and always within 1e-6 more than the JAX kernel's own error."""
    from cell_image_analysis_tpu.ops.pallas.winograd import winograd_conv3x3_pallas

    x, W, bias = _case(1, 16, 12, ci, co, seed=ci + co)
    ref = np.asarray(winograd_conv3x3_pallas(jnp.asarray(x), jnp.asarray(W), jnp.asarray(bias),
                                             th=8, tw=8, interpret=True))
    exact = _highest(x, W, bias)
    y = winograd_3xtf32(torch.from_numpy(x), torch.from_numpy(W), torch.from_numpy(bias))
    assert y.shape == ref.shape
    assert _rel(y.numpy(), exact) < 1e-5
    assert _rel(y.numpy(), ref) < _rel(ref, exact) + 1e-6 < 5e-5
    assert _rel(y.numpy(), ref) < 1e-5 or _rel(ref, exact) >= 1e-5


@pytest.mark.parametrize("ci,co", UNET_PAIRS)
@pytest.mark.parametrize("h,w", [(16, 12), (7, 10)])
def test_3xtf32_emulation_matches_jax_direct_conv_highest(ci, co, h, w):
    x, W, bias = _case(2, h, w, ci, co, seed=3 * ci + co)
    ref = _highest(x, W, bias)
    y = winograd_3xtf32(torch.from_numpy(x), torch.from_numpy(W), torch.from_numpy(bias))
    assert y.shape == ref.shape
    assert _rel(y.numpy(), ref) < 1e-5


def test_dropping_the_filter_lo_half_fails_the_gate():
    """The gate tells 3xTF32 from products with a TF32-rounded filter."""
    x, W, bias = _case(1, 16, 16, 256, 64, seed=5)
    xp = pad_input(torch.from_numpy(x))
    U_hi, U_lo, b = winograd_operands(torch.from_numpy(W), torch.from_numpy(bias))
    ref = _highest(x, W, bias)
    three = winograd_kernel_emulation(xp, U_hi, U_lo, b)
    rounded = winograd_kernel_emulation(xp, U_hi, torch.zeros_like(U_lo), b)
    assert _rel(three.numpy(), ref) < 1e-5 < _rel(rounded.numpy(), ref)
