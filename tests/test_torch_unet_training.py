"""PyTorch port: U-Net training against the JAX package's.

- `WinogradConv3x3Fn` (the Winograd kernel's autograd route; on the CPU
  its plain version runs inside it) against `torch.autograd` of
  `F.conv2d` and against `jax.grad` of `lax.conv_general_dilated` (what
  JAX's U-Net training differentiates: its `pallas_call` has no VJP),
  within 1e-5 of each gradient's largest magnitude, at odd sides, Ci = 1
  and with x that needs no grad.
- The ground truth (`star_dist_gt`, `prob_gt`) bit-equal to JAX's; the
  grid-only rays bit-equal to the full map subsampled.
- The new max pool and upsample give the old forms' values bit for bit;
  their gradients and the clip's at ties equal `jax.grad`'s.
- One `unet_train_step` from one init against JAX's: the loss within 1e-6,
  each leaf's gradient within 5e-4 of `jax.grad`'s relative to its norm, an
  Adam step on identical gradients within an ulp of optax's update (2 ulp
  of the weight, the add's rounding included); 20 steps: loss
  histories within a measured gate.
- The port's U-Net payload read by the JAX package: the same forward
  within 1e-5.
Small shapes: 64^2 frames, base filters 4, head 16, 8 rays.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from torch_port_helpers import torch_threads

from cell_image_analysis_tpu_torch.io.artifacts import (
    load_unet_variables,
    save_unet_variables,
    unet_params_to_jax,
    unet_state_from_jax,
)
from cell_image_analysis_tpu_torch.models import unet as port_unet
from cell_image_analysis_tpu_torch.models.unet import StarDistUNet, init_unet
from cell_image_analysis_tpu_torch.ops.winograd import WinogradConv3x3Fn, winograd_conv3x3
from cell_image_analysis_tpu_torch.train import unet_trainer as ut

torch_threads()

ARCH = dict(n_rays=8, base_filters=4, head_filters=16)
GRAD_TOL = 1e-5      # WinogradConv3x3Fn against F.conv2d / jax.grad, of max |ref|
LEAF_TOL = 5e-4      # each leaf's gradient against jax.grad's, of its norm (PR 7's gate)
LOSS_TOL = 1e-6      # one step's loss
# one Adam step on identical gradients against optax's, in ulps of the
# largest of the old and the two new values: an ulp of the update, and the
# rounding of adding it (measured: 2 at most)
ADAM_ULP = 2
# 20 full-batch steps at lr 3e-3 from one init: measured 8.7e-7 relative at
# most (float32 reassociation between XLA's convs and torch's, carried
# through Adam); the gate leaves 11x
HISTORY_RTOL = 1e-5


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


# ------------------------------------------------------- WinogradConv3x3Fn --

@pytest.mark.parametrize("b,h,w,ci,co,x_grad", [
    (2, 16, 16, 4, 8, True),
    (1, 9, 13, 3, 5, True),      # odd H and W
    (2, 12, 10, 1, 6, False),    # Ci = 1, x needs no grad (the U-Net's Conv_0)
    (1, 7, 8, 6, 1, True),       # Co = 1 (dx's Ci' = 1 when the forward's Co is 1)
])
def test_winograd_fn_gradients_match_autograd_and_jax(b, h, w, ci, co, x_grad):
    x = _rand((b, h, w, ci), 1)
    W = _rand((3, 3, ci, co), 2, 1 / np.sqrt(9 * ci))
    bias = _rand((co,), 3, 0.1)
    dy = _rand((b, h, w, co), 4)

    def grads(fn):
        xt = torch.tensor(x, requires_grad=x_grad)
        Wt, bt = torch.tensor(W, requires_grad=True), torch.tensor(bias, requires_grad=True)
        y = fn(xt, Wt, bt)
        y.backward(torch.tensor(dy))
        return y.detach().numpy(), (xt.grad, Wt.grad.numpy(), bt.grad.numpy())

    y_fn, (gx, gW, gb) = grads(WinogradConv3x3Fn.apply)
    y_ref, (rx, rW, rb) = grads(lambda a, k, c: F.conv2d(
        a.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1).contiguous(), c,
        padding=1).permute(0, 2, 3, 1))

    def jax_conv(a, k, c):
        return jax.lax.conv_general_dilated(a, k, (1, 1), "SAME",
                                            dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                            precision=jax.lax.Precision.HIGHEST) + c

    _, vjp = jax.vjp(jax_conv, jnp.asarray(x), jnp.asarray(W), jnp.asarray(bias))
    jx, jW, jb = (np.asarray(g) for g in vjp(jnp.asarray(dy)))

    def close(a, ref):
        assert float(np.abs(a - ref).max()) <= GRAD_TOL * float(np.abs(ref).max())

    close(y_fn, y_ref)
    for got, ref_t, ref_j in ((gW, rW, jW), (gb, rb, jb)):
        close(got, ref_t)
        close(got, ref_j)
    if x_grad:
        close(gx.numpy(), rx.numpy())
        close(gx.numpy(), jx)
    else:
        assert gx is None


def test_winograd_conv3x3_routes_through_the_fn_only_under_grad():
    x = torch.tensor(_rand((1, 8, 8, 2), 0))
    W = torch.tensor(_rand((3, 3, 2, 4), 1), requires_grad=True)
    assert isinstance(winograd_conv3x3(x, W).grad_fn, WinogradConv3x3Fn._backward_cls)
    with torch.no_grad():
        assert winograd_conv3x3(x, W).grad_fn is None
    with torch.inference_mode():
        assert winograd_conv3x3(x, W).grad_fn is None
    assert winograd_conv3x3(x, W.detach()).grad_fn is None


def test_data_gradient_is_a_winograd_conv_of_the_flipped_filter(monkeypatch):
    """The Fn's forward and dx both go through the module-level
    `winograd_conv3x3` (what the smoke counts and holds against plain)."""
    from cell_image_analysis_tpu_torch.ops import winograd

    calls = []
    real = winograd.winograd_conv3x3

    def spy(x, W, bias=None):
        calls.append((tuple(x.shape), tuple(W.shape), torch.is_grad_enabled()))
        return real(x, W, bias)

    monkeypatch.setattr(winograd, "winograd_conv3x3", spy)
    x = torch.tensor(_rand((1, 6, 6, 2), 0), requires_grad=True)
    W = torch.tensor(_rand((3, 3, 2, 5), 1), requires_grad=True)
    winograd.WinogradConv3x3Fn.apply(x, W, None).sum().backward()
    assert calls == [((1, 6, 6, 2), (3, 3, 2, 5), False), ((1, 6, 6, 5), (3, 3, 5, 2), False)]


# ------------------------------------------------------------ ground truth --

def _labels(seed, size=64, n=5):
    from cell_image_analysis_tpu_torch.utils.synthetic import make_frame_instances

    return make_frame_instances(np.random.default_rng(seed), size=size, n_cells=n,
                                clustering=0.5, fg_d2=1.6)


@pytest.mark.parametrize("seed,size,n", [(0, 64, 5), (3, 80, 8)])
def test_ground_truth_bit_equal_to_jax(seed, size, n):
    from cell_image_analysis_tpu.train import unet_trainer as jut

    _, lab = _labels(seed, size, n)
    assert lab.max() > 0
    got, ref = ut.star_dist_gt(lab, n_rays=8), jut.star_dist_gt(lab, n_rays=8)
    assert got.dtype == ref.dtype and got.tobytes() == ref.tobytes()
    got, ref = ut.prob_gt(lab), jut.prob_gt(lab)
    assert got.dtype == ref.dtype and got.tobytes() == ref.tobytes()


@pytest.mark.parametrize("grid,shape", [(2, (64, 64)), (2, (37, 50)), (3, (40, 41))])
def test_grid_rays_equal_the_full_map_subsampled(grid, shape):
    _, lab = _labels(1, 64, 6)
    lab = np.ascontiguousarray(lab[:shape[0], :shape[1]])
    full = ut.star_dist_gt(lab, n_rays=8)[::grid, ::grid]
    got = ut.star_dist_gt(lab, n_rays=8, grid=grid)
    assert got.shape == full.shape and got.tobytes() == full.tobytes()


def test_training_batch_equals_jax():
    from cell_image_analysis_tpu.train import unet_trainer as jut

    img, lab = _labels(2)
    img = img[..., 2].astype(np.float32)
    got = ut.make_unet_training_batch(lab, img, grid=2, n_rays=8)
    ref = jut.make_unet_training_batch(lab, img, grid=2, n_rays=8)
    for a, r in zip(got, ref):
        assert a.dtype == r.dtype and a.tobytes() == np.asarray(r).tobytes()


# ------------------------------------------------- pool, upsample and clip --

def test_pool_and_upsample_give_the_old_forms_values():
    h = torch.tensor(_rand((2, 8, 12, 3), 5))
    h[0, 0, 0, 0] = h[0, 0, 1, 0] = h[0, 1, 0, 0] = 7.0       # a tie
    old_pool = h.reshape(2, 4, 2, 6, 2, 3).amax(dim=(2, 4))
    assert torch.equal(port_unet._maxpool2(h), old_pool)
    old_up = h.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    assert torch.equal(port_unet._up2(h), old_up)


def test_max_pool_gradient_at_ties_matches_flax():
    from flax import linen as nn

    x = np.ones((1, 4, 4, 2), np.float32)
    x[0, 2:, 2:, 1] = np.array([[0.5, 3.0], [3.0, 3.0]])      # a positive tie, not first
    x[0, :2, 2:, 0] = 2.0
    g_jax = np.asarray(jax.grad(lambda a: (nn.max_pool(a, (2, 2), strides=(2, 2),
                                                       padding="SAME") ** 2).sum())(
        jnp.asarray(x)))
    xt = torch.tensor(x, requires_grad=True)
    (port_unet._maxpool2(xt) ** 2).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), g_jax)
    assert g_jax[0, 0, 0, 0] == 2.0 and g_jax[0, 0, 1, 0] == 0.0      # first maximum only


def test_clip_gradient_at_the_bounds_matches_jnp_clip():
    lo, hi = ut.CLIP_EPS, 1 - ut.CLIP_EPS
    hi32 = np.float32(hi)
    assert hi32 == np.float32(1 - 2 ** -23)
    x = np.array([np.float32(lo), hi32, 0.5, 0.0, 1.0, np.nextafter(hi32, np.float32(0))],
                 np.float32)
    g_jax = np.asarray(jax.grad(lambda a: jnp.clip(a, lo, hi).sum())(jnp.asarray(x)))
    xt = torch.tensor(x, requires_grad=True)
    y = ut.clip_like_jax(xt, lo, hi)
    y.sum().backward()
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(jnp.clip(x, lo, hi)))
    np.testing.assert_array_equal(xt.grad.numpy(), g_jax)
    assert list(g_jax[:2]) == [0.5, 0.5]


# ---------------------------------------------------------------- the step --

def _jax_model():
    from cell_image_analysis_tpu.models.unet import StarDistUNet as JaxUNet

    return JaxUNet(**ARCH)


def _jax_loss_fn(model, imgs, gt_prob, gt_dist):
    """The loss of JAX's `unet_train_step` (a closure there), as it is."""
    def loss_fn(p):
        prob, dist = model.apply({"params": p}, imgs[..., None], train=True)
        eps = 1e-7
        prob = jnp.clip(prob, eps, 1 - eps)
        bce = -jnp.mean(gt_prob * jnp.log(prob) + (1 - gt_prob) * jnp.log(1 - prob))
        wd = jnp.mean(gt_prob[..., None] * jnp.abs(dist - gt_dist))
        return bce + 0.2 * wd, (bce, wd)
    return loss_fn


@pytest.fixture(scope="module")
def batch():
    frames, labels = ut.synthetic_training_set(2, 64, dense=True)
    return ut.training_tensors(frames, labels, n_rays=8, device="cpu")


def test_one_step_matches_jax(batch):
    import optax

    from cell_image_analysis_tpu.train.unet_trainer import unet_train_step as jax_step

    model = init_unet(0, device="cpu", **ARCH)
    params = jax.tree.map(jnp.asarray, unet_params_to_jax(model.state_dict()))
    jb = tuple(jnp.asarray(t.numpy()) for t in batch)
    (loss_j, (bce_j, wd_j)), g_j = jax.value_and_grad(
        _jax_loss_fn(_jax_model(), *jb), has_aux=True)(params)

    opt = ut.make_unet_optimizer(model, 3e-3)
    loss, bce, wd = ut.unet_loss(model, batch)
    loss.backward()
    loss, bce, wd = loss.detach(), bce.detach(), wd.detach()
    assert abs(float(loss) - float(loss_j)) <= LOSS_TOL
    assert abs(float(bce) - float(bce_j)) <= LOSS_TOL and abs(float(wd) - float(wd_j)) <= LOSS_TOL
    g_port = unet_params_to_jax({k: p.grad for k, p in model.named_parameters()})
    for name, leaves in g_port.items():
        for leaf, g in leaves.items():
            ref = np.asarray(g_j[name][leaf])
            assert np.linalg.norm(g - ref) <= LEAF_TOL * np.linalg.norm(ref), (name, leaf)

    # Adam on identical gradients (JAX's) against optax's update
    tx = optax.adam(3e-3)
    state = unet_state_from_jax(jax.tree.map(np.asarray, g_j))
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.grad = state[k].clone()
    opt.step()
    updates, _ = tx.update(g_j, tx.init(params), params)
    want = jax.tree.map(np.asarray, optax.apply_updates(params, updates))
    before = jax.tree.map(np.asarray, params)
    got = unet_params_to_jax(model.state_dict())
    for name, leaves in got.items():
        for leaf, a in leaves.items():
            w, p0 = want[name][leaf], before[name][leaf]
            ulp = np.spacing(np.maximum(np.maximum(np.abs(a), np.abs(w)), np.abs(p0)))
            assert (np.abs(a - w) <= ADAM_ULP * ulp).all(), (name, leaf)

    # JAX's own jitted step from the same init lands on the same loss
    params0 = jax.tree.map(jnp.asarray, unet_params_to_jax(
        init_unet(0, device="cpu", **ARCH).state_dict()))
    _, _, loss_s, _, _ = jax_step(_jax_model(), params0, tx.init(params0), jb, tx)
    assert abs(float(loss_s) - float(loss_j)) <= LOSS_TOL


def test_twenty_steps_match_jax(batch):
    import optax

    from cell_image_analysis_tpu.train.unet_trainer import unet_train_step as jax_step

    model = init_unet(1, device="cpu", **ARCH)
    params = jax.tree.map(jnp.asarray, unet_params_to_jax(model.state_dict()))
    tx = optax.adam(3e-3)
    opt_state = tx.init(params)
    jb = tuple(jnp.asarray(t.numpy()) for t in batch)
    opt = ut.make_unet_optimizer(model, 3e-3)
    hist_t, hist_j = [], []
    for _ in range(20):
        hist_t.append(float(ut.unet_train_step(model, opt, batch)[0]))
        params, opt_state, loss, _, _ = jax_step(_jax_model(), params, opt_state, jb, tx)
        hist_j.append(float(loss))
    np.testing.assert_allclose(hist_t, hist_j, rtol=HISTORY_RTOL, atol=0)
    assert hist_t[-1] < hist_t[0]


def test_train_step_returns_device_tensors_and_fit_unet_learns(batch):
    model = init_unet(2, device="cpu", **ARCH)
    opt = ut.make_unet_optimizer(model, 3e-3)
    out = ut.unet_train_step(model, opt, batch)
    assert all(isinstance(t, torch.Tensor) and t.grad_fn is None for t in out)
    frames, labels = ut.synthetic_training_set(2, 64, dense=True)
    history = []
    fitted = ut.fit_unet(frames, labels, epochs=15, lr=3e-3, n_rays=8, seed=2, device="cpu",
                         history=history)
    assert isinstance(fitted, StarDistUNet) and len(history) == 15
    assert float(history[-1][0]) < 0.8 * float(history[0][0])


def test_fit_unet_warm_starts_from_a_payload(tmp_path):
    start = init_unet(6, device="cpu", n_rays=8)      # fit_unet's width, as JAX's
    path = str(tmp_path / "start.pkl")
    save_unet_variables(path, start)
    frames, labels = ut.synthetic_training_set(1, 64, dense=True)
    state = unet_state_from_jax(load_unet_variables(path)["params"])
    same = ut.fit_unet(frames, labels, epochs=0, n_rays=8, device="cpu", init_state=state)
    assert all(torch.equal(a, b) for a, b in zip(same.state_dict().values(),
                                                 start.state_dict().values()))
    moved = ut.fit_unet(frames, labels, epochs=1, lr=3e-3, n_rays=8, device="cpu",
                        init_state=state)
    assert not torch.equal(moved.convs["Conv_0"].weight, start.convs["Conv_0"].weight)


# ------------------------------------------------------- init and payload --

def test_init_unet_draws_flax_default_distributions():
    a = init_unet(7, device="cpu")
    b = init_unet(7, device="cpu")
    assert all(torch.equal(p, q) for p, q in zip(a.state_dict().values(),
                                                 b.state_dict().values()))
    assert all(p.requires_grad for p in a.parameters())
    for name, conv in a.convs.items():
        co, ci, k, _ = conv.weight.shape
        assert not conv.bias.any()
        w = conv.weight.detach()
        if k == 3:
            limit = np.sqrt(6.0 / (9 * (ci + co)))
            assert float(w.abs().max()) <= limit
            if w.numel() > 5000:
                assert abs(float(w.std()) - limit / np.sqrt(3)) < 0.05 * limit
        else:
            std = np.sqrt(1.0 / ci) / .87962566103423978
            assert float(w.abs().max()) <= 2 * std
            assert abs(float(w.std()) - np.sqrt(1.0 / ci)) < 0.15 * np.sqrt(1.0 / ci)


def test_port_payload_read_by_jax_gives_the_same_forward(tmp_path):
    from cell_image_analysis_tpu.models.unet import StarDistUNet as JaxUNet
    from cell_image_analysis_tpu.utils.bench import load_synthetic_unet_variables

    model = init_unet(3, device="cpu", **ARCH)
    path = str(tmp_path / "unet.pkl")
    save_unet_variables(path, model, {"epochs": 0})
    variables = load_synthetic_unet_variables(path)
    x = np.random.default_rng(0).uniform(size=(2, 64, 64, 1)).astype(np.float32)
    prob_j, dist_j = JaxUNet(**ARCH).apply(variables, jnp.asarray(x))
    with torch.no_grad():
        prob_t, dist_t = model.forward_train(torch.tensor(x))
    np.testing.assert_allclose(prob_t.numpy(), np.asarray(prob_j), rtol=0, atol=1e-5)
    np.testing.assert_allclose(dist_t.numpy(), np.asarray(dist_j), rtol=0,
                               atol=1e-5 * float(np.abs(np.asarray(dist_j)).max()))
    back = StarDistUNet(**ARCH)
    back.load_state_dict(unet_state_from_jax(load_unet_variables(path)["params"]))
    assert all(torch.equal(p, q) for p, q in zip(back.state_dict().values(),
                                                 model.state_dict().values()))


def test_predict_instances_takes_no_grad_with_trainable_parameters():
    from cell_image_analysis_tpu_torch.config import SegConfig
    from cell_image_analysis_tpu_torch.models.stardist import predict_instances

    model = init_unet(4, device="cpu", **ARCH)
    seg = torch.tensor(np.random.default_rng(1).uniform(size=(1, 64, 64)).astype(np.float32))
    labels, _ = predict_instances(seg, model, SegConfig(n_rays=8, max_candidates=32))
    assert labels.grad_fn is None and not labels.requires_grad


def test_make_unet_weights_script_runs_on_the_cpu(tmp_path, monkeypatch, capsys):
    import importlib.util
    import os

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "make_unet_weights_torch", os.path.join(repo, "scripts", "make_unet_weights_torch.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    out = str(tmp_path / "u.pkl")
    assert script.main(["--dense", "--epochs", "2", "--frames", "1", "--size", "64",
                        "--device", "cpu", "--out", out]) == 0
    variables = load_unet_variables(out)
    assert variables["params"]["Conv_0"]["kernel"].shape == (3, 3, 1, 32)
    assert not os.path.exists(os.path.join(tmp_path, "assets"))

    # without a GPU and without --device cpu: exit 2 with the reason
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        script.main(["--epochs", "1", "--out", out])
    assert e.value.code == 2 and "no CUDA device" in capsys.readouterr().err
