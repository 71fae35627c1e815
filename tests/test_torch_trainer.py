"""PyTorch port: the CAE trainer (`train/trainer.py`, `train/checkpoint.py`,
`models/cae.py`'s train mode) against JAX (flax + optax) on the CPU.

- `KerasCallbackState` equals JAX's on the val-loss sequences of
  tests/test_keras_callbacks.py (which adjudicates JAX's against Keras).
- `train_test_split` equals sklearn's for many n, test sizes and seeds.
- From one init (JAX's, carried across as numpy): a train-mode forward
  (outputs within FWD_ATOL, new running statistics within 1e-6), every
  leaf's gradient (within GRAD_RTOL of `jax.grad`'s, relative to the
  leaf's norm: a wrong backward term is off by O(1)) and one Adam step
  on identical gradients (parameters within ADAM_ATOL, under a
  thousandth of the step) match flax + optax.
- `fit_cae` on 256 cells, 3 epochs, augmentation off, the same batches
  (numpy's permutation), ReduceLROnPlateau forced to cut every epoch:
  the lr history is equal and every loss / MAE within HIST_RTOL of JAX's.
  HIST_RTOL is 2e-3, not the 1e-4 of tests/test_checkpoint_resume.py: a
  single train-mode forward already differs by 1.5e-4 on the latent,
  because flax's BatchNorm takes the variance as E[x^2] - E[x]^2 over
  131,072 values with float32 reductions (JAX is 1.5e-4 from a float64
  forward there, the port 1.2e-5), and three epochs of Adam carry that to
  8.4e-4 (measured).
- A forced early stop (BatchNorm momentum 1, the lr cut to 0 after a
  stale epoch, so the val loss repeats exactly) stops both at the same
  epoch with the same lr history, and the restored best weights match
  JAX's, each leaf within BEST_RTOL of how far JAX's moved from the
  init.
- A run stopped after epoch 2 and resumed from its checkpoint equals an
  uninterrupted run bit for bit (history and weights).
"""

import dataclasses

import numpy as np
import pytest
import torch

from torch_port_helpers import torch_threads

from cell_image_analysis_tpu_torch.config import AugmentConfig, CAEConfig, TrainConfig
from cell_image_analysis_tpu_torch.io.artifacts import cae_state_from_jax, cae_state_to_jax
from cell_image_analysis_tpu_torch.models.cae import CAE, init_cae
from cell_image_analysis_tpu_torch.train import trainer
from cell_image_analysis_tpu_torch.train.trainer import (
    KerasCallbackState,
    make_optimizer,
    train_test_split,
)

torch_threads()

FWD_ATOL = 5e-4    # measured 4.0e-5 (recon), 1.5e-4 (latent)
GRAD_RTOL = 5e-4   # |g - g_jax| / |g_jax| a leaf; measured 2.4e-6 to 1.3e-4 over the 26 leaves
ADAM_ATOL = 1e-7   # one Adam step on identical gradients; measured 7.5e-9 (an ulp)
HIST_RTOL = 2e-3
# the restored best weights a leaf: |p - p_jax| / |p_jax - init|; measured
# 1.4e-6 to 3.1e-2 (Adam's per-weight normalisation turns gradient
# differences of 1e-4 on near-zero gradients into whole steps)
BEST_RTOL = 0.1
_OFF = dict(rotation_range=0, width_shift_range=0, height_shift_range=0, zoom_range=0,
            horizontal_flip=False, vertical_flip=False)

SEQUENCES = [
    list(np.linspace(1.0, 0.5, 12)),
    [1.0, 0.8, 0.6] + [0.6] * 12,
    [1.0, 0.9, 0.89995, 0.8999, 0.89985, 0.8998, 0.89975, 0.8997, 0.89965,
     0.8996, 0.89955, 0.8995],
    [1.0, 0.9, 0.95, 0.96, 0.97, 0.85, 0.95, 0.96, 0.97, 0.98, 0.8],
    [1.0] + [1.0 + 0.01 * i for i in range(40)],
]


def _drive(cls, seq, es_patience, rlr_patience, min_lr):
    cbs = cls(lr=1e-3, es_patience=es_patience, rlr_patience=rlr_patience, rlr_factor=0.5,
              rlr_min_lr=min_lr, rlr_min_delta=1e-4)
    trace = []
    for v in seq:
        out = cbs.on_epoch_end(float(v))
        trace.append((out, cbs.lr, cbs.es_wait, cbs.rlr_wait, cbs.best_val, cbs.rlr_best))
        if out[1]:
            break
    return trace


@pytest.mark.parametrize("seq_i", range(len(SEQUENCES)))
@pytest.mark.parametrize("es_patience,rlr_patience", [(10, 5), (3, 2), (5, 1)])
def test_callback_state_equals_jax(seq_i, es_patience, rlr_patience):
    from cell_image_analysis_tpu.train.trainer import KerasCallbackState as JaxState

    min_lr = 1e-6 if seq_i != 4 else 3e-4
    got = _drive(KerasCallbackState, SEQUENCES[seq_i], es_patience, rlr_patience, min_lr)
    ref = _drive(JaxState, SEQUENCES[seq_i], es_patience, rlr_patience, min_lr)
    assert got == ref


@pytest.mark.parametrize("test_size", [0.2, 0.25, 0.5])
@pytest.mark.parametrize("seed", [42, 0, 7])
def test_train_test_split_equals_sklearn(test_size, seed):
    from sklearn.model_selection import train_test_split as sk_split

    for n in (2, 3, 5, 10, 64, 99, 256, 257, 1001):
        X = np.arange(n * 2).reshape(n, 2)
        got_train, got_test = train_test_split(X, test_size=test_size, random_state=seed)
        ref_train, ref_test = sk_split(X, test_size=test_size, random_state=seed)
        np.testing.assert_array_equal(got_train, ref_train)
        np.testing.assert_array_equal(got_test, ref_test)
        t_train, t_test = train_test_split(torch.tensor(X), test_size=test_size,
                                           random_state=seed)
        assert np.array_equal(t_train.numpy(), ref_train) and np.array_equal(t_test.numpy(),
                                                                              ref_test)


def test_make_optimizer_is_keras_adam():
    model = init_cae(torch.Generator().manual_seed(0))
    opt = make_optimizer(CAEConfig(), model.parameters())
    group = opt.param_groups[0]
    assert isinstance(opt, torch.optim.Adam)
    assert group["lr"] == 1e-3 and group["betas"] == (0.9, 0.999) and group["eps"] == 1e-7


def test_init_is_glorot_uniform_with_zero_bias():
    model = init_cae(torch.Generator().manual_seed(3))
    conv = sum(9 * ci * co + co for ci, co in
               ((1, 32), (32, 64), (64, 32), (32, 32), (32, 64), (64, 32), (32, 1)))
    assert sum(p.numel() for p in model.parameters()) == conv + 2 * (32 + 64 + 32) * 2
    for conv in model.convs:
        co, ci = conv.weight.shape[:2]
        limit = np.sqrt(6.0 / (9 * (ci + co)))
        w = conv.weight.detach()
        assert float(w.abs().max()) <= limit and float(w.abs().max()) > 0.9 * limit
        assert float(conv.bias.detach().abs().max()) == 0.0
    again = init_cae(torch.Generator().manual_seed(3))
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                 again.state_dict().values()))


def _cells(n, seed=0):
    from cell_image_analysis_tpu.utils.synthetic import make_cells

    return make_cells(np.random.default_rng(seed), n)


def _jax_init(seed):
    import jax

    from cell_image_analysis_tpu.models.cae import init_cae as jax_init

    key = jax.random.PRNGKey(seed)
    key, init_key = jax.random.split(key)   # fit_cae's own init key
    model, variables = jax_init(init_key)
    return model, jax.tree.map(np.asarray, variables)


def _port_model(variables):
    m = CAE()
    m.load_state_dict(cae_state_from_jax(variables))
    return m


def _max_state_diff(a: dict, b: dict) -> float:
    return max(float((a[k].float() - b[k].float()).abs().max()) for k in a)


def test_train_forward_and_one_adam_step_match_flax_optax():
    import jax
    import jax.numpy as jnp
    import optax

    from cell_image_analysis_tpu import config as J
    from cell_image_analysis_tpu.train.trainer import make_optimizer as jax_opt

    x = _cells(32, seed=1)[..., None]
    xj = jnp.asarray(x)
    model, v = _jax_init(1)
    bs = jax.tree.map(jnp.asarray, v["batch_stats"])
    (rj, ej), upd = model.apply({"params": v["params"], "batch_stats": bs}, xj, train=True,
                                mutable=["batch_stats"])
    m = _port_model(v).train()
    rp, ep = m(torch.tensor(x))
    np.testing.assert_allclose(rp.detach().numpy(), np.asarray(rj), rtol=0, atol=FWD_ATOL)
    np.testing.assert_allclose(ep.detach().numpy(), np.asarray(ej), rtol=0, atol=FWD_ATOL)
    new_stats = cae_state_from_jax({"params": v["params"],
                                    "batch_stats": jax.tree.map(np.asarray, upd["batch_stats"])})
    for k, t in m.state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(t.numpy(), new_stats[k].numpy(), rtol=0, atol=1e-6)

    # the backward pass: each leaf's gradient against jax.grad of the same
    # loss (train/trainer.py's train_step, augmentation off)
    def loss_fn(p):
        (recon, _), _ = model.apply({"params": p, "batch_stats": bs}, xj, train=True,
                                    mutable=["batch_stats"])
        diff = xj - recon
        return jnp.mean(diff * diff)

    params = jax.tree.map(jnp.asarray, v["params"])
    loss_j, grads_j = jax.value_and_grad(loss_fn)(params)
    ref_grads = cae_state_from_jax({"params": jax.tree.map(np.asarray, grads_j),
                                    "batch_stats": v["batch_stats"]})
    m = _port_model(v).train()
    recon, _ = m(torch.tensor(x))
    diff = torch.tensor(x) - recon
    loss = torch.mean(diff * diff)
    loss.backward()
    assert abs(float(loss.detach()) - float(loss_j)) <= 1e-5 * abs(float(loss_j))
    names = [name for name, _ in m.named_parameters()]
    assert len(names) == 26
    for name, p in m.named_parameters():
        r = ref_grads[name]
        rel = float((p.grad - r).norm() / r.norm())
        assert rel < GRAD_RTOL, f"{name}: gradient {rel:.2e} from jax.grad's"

    # one Adam step on identical gradients (JAX's) against optax's
    tx = jax_opt(J.CAEConfig())
    updates, _ = tx.update(grads_j, tx.init(params), params)
    ref = cae_state_from_jax({"params": jax.tree.map(np.asarray,
                                                     optax.apply_updates(params, updates)),
                              "batch_stats": v["batch_stats"]})
    m = _port_model(v).train()
    opt = make_optimizer(CAEConfig(), m.parameters())
    for name, p in m.named_parameters():
        p.grad = ref_grads[name].clone()
    opt.step()
    for name, p in m.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(), rtol=0,
                                   atol=ADAM_ATOL, err_msg=name)
    moved = _max_state_diff(m.state_dict(), cae_state_from_jax(v))
    assert moved > 5e-4      # the step did move the weights


def _fit_both(monkeypatch, cells, jax_train, port_train, cae=None):
    from cell_image_analysis_tpu import config as J
    from cell_image_analysis_tpu.train.trainer import fit_cae as jax_fit

    cae = cae or {}
    _, v = _jax_init(jax_train.seed)
    monkeypatch.setattr(trainer, "init_cae", lambda generator, **kw: _with_momentum(
        _port_model(v), kw["bn_momentum"]).to(generator.device))
    _, jv, jh = jax_fit(cells, cae_cfg=J.CAEConfig(**cae), train_cfg=jax_train,
                        aug_cfg=J.AugmentConfig(**_OFF), verbose=False)
    model, state, ph = trainer.fit_cae(torch.tensor(cells), cae_cfg=CAEConfig(**cae),
                                       train_cfg=port_train, aug_cfg=AugmentConfig(**_OFF),
                                       verbose=False)
    import jax

    return jh.history, ph.history, cae_state_from_jax(jax.tree.map(np.asarray, jv)), state


def _with_momentum(model, momentum):
    for bn in model.bns:
        bn.momentum = momentum
    return model


def _train_cfgs(**kw):
    from cell_image_analysis_tpu import config as J

    return J.TrainConfig(**kw), TrainConfig(**kw)


def test_fit_cae_history_and_lr_cuts_match_jax(monkeypatch):
    jax_cfg, port_cfg = _train_cfgs(epochs=3, reduce_lr_patience=1, reduce_lr_min_delta=1.0)
    jh, ph, _, _ = _fit_both(monkeypatch, _cells(256), jax_cfg, port_cfg)
    assert ph["lr"] == jh["lr"] == [1e-3, 1e-3, 5e-4]
    for k in ("loss", "mae", "val_loss", "val_mae"):
        assert len(ph[k]) == 3
        np.testing.assert_allclose(ph[k], jh[k], rtol=HIST_RTOL, err_msg=k)
    assert ph["loss"][-1] < ph["loss"][0]


def test_forced_early_stop_matches_jax(monkeypatch):
    jax_cfg, port_cfg = _train_cfgs(epochs=6, early_stop_patience=2, reduce_lr_patience=1,
                                    reduce_lr_min_delta=1.0, reduce_lr_factor=0.0,
                                    reduce_lr_min_lr=0.0)
    jh, ph, jstate, pstate = _fit_both(monkeypatch, _cells(128, seed=2), jax_cfg, port_cfg,
                                       cae=dict(bn_momentum=1.0))
    assert len(ph["loss"]) == len(jh["loss"]) < 6          # both stopped, at the same epoch
    assert ph["lr"] == jh["lr"] and ph["lr"][-1] == 0.0
    assert ph["val_loss"][-1] == ph["val_loss"][-2]         # frozen weights: the same val loss
    np.testing.assert_allclose(ph["val_loss"], jh["val_loss"], rtol=HIST_RTOL)
    # the restored best weights: their distance from JAX's against how far
    # JAX's moved from the shared init
    init = cae_state_from_jax(_jax_init(jax_cfg.seed)[1])
    params = [k for k in jstate if "running" not in k]
    for k in params:
        rel = float((pstate[k] - jstate[k]).norm() / (jstate[k] - init[k]).norm())
        assert rel < BEST_RTOL, f"{k}: {rel:.2e} of JAX's move from the init"


def test_resume_equals_an_uninterrupted_run_bit_for_bit(tmp_path):
    cells = torch.tensor(_cells(96, seed=3))
    full = TrainConfig(epochs=4, batch_size=16)
    _, state_full, h_full = trainer.fit_cae(cells, train_cfg=full, verbose=False)
    ck = str(tmp_path / "ck")
    _, _, h1 = trainer.fit_cae(cells, train_cfg=dataclasses.replace(full, epochs=2),
                               verbose=False, checkpoint_dir=ck)
    _, state, h2 = trainer.fit_cae(cells, train_cfg=full, verbose=False, checkpoint_dir=ck,
                                   resume=True)
    assert h2.history["loss"][:2] == h1.history["loss"]
    assert h2.history == h_full.history
    assert all(torch.equal(state[k], state_full[k]) for k in state_full)


def test_resume_without_checkpoint_starts_fresh(tmp_path):
    _, _, h = trainer.fit_cae(torch.tensor(_cells(64, seed=4)),
                              train_cfg=TrainConfig(epochs=2, batch_size=32), verbose=False,
                              checkpoint_dir=str(tmp_path / "none"), resume=True)
    assert len(h.history["loss"]) == 2


def test_fit_cae_on_numpy_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: numpy cells train there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trainer.fit_cae(_cells(8), train_cfg=TrainConfig(epochs=1), verbose=False)


def test_state_round_trips_through_the_jax_layout():
    model = init_cae(torch.Generator().manual_seed(9))
    st = model.state_dict()
    back = cae_state_from_jax(cae_state_to_jax(st))
    assert set(back) == set(st) and all(torch.equal(back[k], st[k]) for k in st)
