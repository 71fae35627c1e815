"""PyTorch port: data-parallel CAE training, `fit_cae(mesh=...)`, on
`virtual_mesh("cpu", 4)`.

JAX's `tests/test_sharded_training.py` holds its mesh run to its
single-device run; this holds the port's the same way, at JAX's gates:
from one init (the port draws it from the same seeded generator either
way) and the same batches, 3 epochs on 80 cells at batch 16, the loss and
val-loss histories within rtol 2e-3 and every weight within atol 2e-2
(JAX's test: per-shard BatchNorm statistics, a missing gradient sum or a
wrong split diverge at the 1e-1 level).  Also:

- a sharded train-mode forward takes the whole batch's BatchNorm
  statistics: at every layer its mean and variance equal the unsharded
  forward's within 1e-6 (the first shard's own mean is more than 1e-3
  off), its output equals it within 1e-5, and the running statistics move
  as the unsharded ones do;
- in float64, 12 steps on the mesh equal 12 on one device within 1e-12
  (losses, relative; weights, absolute): in float32 the two runs drift
  apart as Adam and the batch statistics amplify the sums' order (842
  cells at batch 32 leave JAX's weight gate after 78 steps), in float64
  only a fault could move them;
- `all_reduce_sum`'s gradient is the sum of its outputs' gradients;
- batches of 10 and 18 split unevenly over 4 shards: every shard's rows
  weigh by their share of the batch (in float64, the loss and MAE within
  1e-12 of the unsharded step's, each leaf's gradient within 1e-10 of its
  norm);
- `ImprovedAnomalyDetectionTraining(mesh=)` and `cli train --mesh 2
  --device cpu` train on the mesh.
"""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

from torch_port_helpers import torch_threads

from cell_image_analysis_tpu_torch import cli
from cell_image_analysis_tpu_torch.config import AugmentConfig, CAEConfig, TrainConfig
from cell_image_analysis_tpu_torch.models import cae as cae_mod
from cell_image_analysis_tpu_torch.models.cae import all_reduce_sum, forward_sharded, init_cae
from cell_image_analysis_tpu_torch.parallel.mesh import virtual_mesh
from cell_image_analysis_tpu_torch.train import trainer
from cell_image_analysis_tpu_torch.train.augment import augment_batch
from cell_image_analysis_tpu_torch.train.trainer import fit_cae
from cell_image_analysis_tpu_torch.utils.synthetic import make_dataset

torch_threads()

N_SHARDS = 4


def _cells(n):
    from cell_image_analysis_tpu.utils.synthetic import make_cells

    return make_cells(np.random.default_rng(42), n)


def _train(mesh, cells, epochs=3):
    return fit_cae(torch.as_tensor(cells), cae_cfg=CAEConfig(),
                   train_cfg=TrainConfig(epochs=epochs, batch_size=16), aug_cfg=AugmentConfig(),
                   verbose=False, mesh=mesh)


def test_sharded_training_matches_single_device():
    cells = _cells(80)
    _, s_single, h_single = _train(None, cells)
    _, s_mesh, h_mesh = _train(virtual_mesh("cpu", N_SHARDS), cells)
    np.testing.assert_allclose(h_mesh.history["loss"], h_single.history["loss"], rtol=2e-3,
                               err_msg="train loss trajectories diverged")
    np.testing.assert_allclose(h_mesh.history["val_loss"], h_single.history["val_loss"],
                               rtol=2e-3)
    assert s_single.keys() == s_mesh.keys()
    for k in s_single:
        np.testing.assert_allclose(s_mesh[k].numpy(), s_single[k].numpy(), atol=2e-2,
                                   err_msg=k)


def _recorded_stats(monkeypatch):
    seen = []
    real = cae_mod._BatchNorm.normalize

    def record(self, x, mean, var):
        seen.append((mean.detach().clone(), var.detach().clone()))
        return real(self, x, mean, var)

    monkeypatch.setattr(cae_mod._BatchNorm, "normalize", record)
    return seen


def test_sharded_forward_takes_the_global_batch_statistics(monkeypatch):
    x = torch.as_tensor(_cells(16))[..., None]
    one, many = init_cae(torch.Generator().manual_seed(0)), init_cae(
        torch.Generator().manual_seed(0))
    one.train()
    many.train()
    seen = _recorded_stats(monkeypatch)
    ref, _ = one(x)
    n_layers = len(seen)
    outs = forward_sharded([many] * N_SHARDS, list(torch.tensor_split(x, N_SHARDS)))
    # every shard normalizes with the same statistics: those of the batch
    global_stats, shard_stats = seen[:n_layers], seen[n_layers:]
    assert len(shard_stats) == n_layers * N_SHARDS
    for i, (mean, var) in enumerate(global_stats):
        for mean_s, var_s in shard_stats[i * N_SHARDS:(i + 1) * N_SHARDS]:
            torch.testing.assert_close(mean_s, mean, rtol=1e-6, atol=1e-6)
            torch.testing.assert_close(var_s, var, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(torch.cat([o[0] for o in outs]), ref, rtol=0, atol=1e-5)
    for a, b in zip(one.bns, many.bns):
        torch.testing.assert_close(b.running_mean, a.running_mean, rtol=1e-6, atol=1e-8)
        torch.testing.assert_close(b.running_var, a.running_var, rtol=1e-6, atol=1e-8)
    # the first shard's own statistics are not the batch's
    with torch.no_grad():
        conv = torch.relu(one.convs[0](x[:4].permute(0, 3, 1, 2)))
    assert float((conv.mean(dim=(0, 2, 3)) - global_stats[0][0]).abs().max()) > 1e-3


def _float64_run(n_shards, cells, steps=12, bs=16):
    X = torch.as_tensor(cells)[..., None].double()
    model = init_cae(torch.Generator().manual_seed(0)).double()
    model.train()
    opt = trainer.make_optimizer(CAEConfig(), model.parameters())
    reps = trainer._Replicas(model, virtual_mesh("cpu", n_shards))
    gen, rng = torch.Generator().manual_seed(1), np.random.default_rng(2)
    losses = [float(trainer._step(reps, opt, X[rng.choice(len(X), bs, replace=False)], gen,
                                  AugmentConfig())[0]) for _ in range(steps)]
    return np.array(losses), model.state_dict()


def test_float64_mesh_run_equals_the_single_device_run():
    cells = _cells(64)
    losses_one, state_one = _float64_run(1, cells)
    losses_mesh, state_mesh = _float64_run(N_SHARDS, cells)
    np.testing.assert_allclose(losses_mesh, losses_one, rtol=1e-12, atol=0)
    for k in state_one:
        np.testing.assert_allclose(state_mesh[k].numpy(), state_one[k].numpy(), rtol=0,
                                   atol=1e-12, err_msg=k)


def test_all_reduce_sum_gradient():
    parts = [torch.tensor([1.0, 2.0], requires_grad=True) for _ in range(3)]
    outs = all_reduce_sum(parts, torch.device("cpu"))
    assert all(torch.equal(o, torch.tensor([3.0, 6.0])) for o in outs)
    (outs[0] * 1.0 + outs[1] * 2.0 + outs[2] * 3.0).sum().backward()
    for p in parts:
        assert torch.equal(p.grad, torch.tensor([6.0, 6.0]))


@pytest.mark.parametrize("bs", [10, 18])
def test_uneven_shards_weigh_by_their_share(bs):
    """In float64, so that only a fault could tell the sharded step from
    the unsharded one (float32 reassociation moves the conv biases'
    gradients, which BatchNorm leaves as small differences, by up to ~3e-3
    of their norm)."""
    cells = torch.as_tensor(_cells(bs))[..., None].double()
    aug = AugmentConfig()
    model = init_cae(torch.Generator().manual_seed(1)).double()
    opt = trainer.make_optimizer(CAEConfig(), model.parameters())
    reps = trainer._Replicas(model, virtual_mesh("cpu", N_SHARDS))
    grads = {}

    def keep_grads():
        grads.update({n: p.grad.clone() for n, p in model.named_parameters()})

    step = opt.step
    opt.step = lambda: (keep_grads(), step())
    loss, mae = trainer._step(reps, opt, cells, torch.Generator().manual_seed(5), aug)

    ref = init_cae(torch.Generator().manual_seed(1)).double()
    ref.train()
    batch = augment_batch(torch.Generator().manual_seed(5), cells, aug)
    recon, _ = ref(batch)
    ref_loss = torch.mean((batch - recon) ** 2)
    ref_loss.backward()
    torch.testing.assert_close(loss, ref_loss.detach(), rtol=1e-12, atol=0)
    torch.testing.assert_close(mae, torch.mean(torch.abs(batch - recon.detach())), rtol=1e-12,
                               atol=0)
    for n, p in ref.named_parameters():
        assert float((grads[n] - p.grad).norm()) <= 1e-10 * float(p.grad.norm()), n


def test_training_pipeline_and_cli_pass_the_mesh(tmp_path, monkeypatch):
    from cell_image_analysis_tpu_torch.pipeline import training

    meshes = []
    real = training.fit_cae

    def spy(*args, mesh=None, **kw):
        meshes.append(mesh)
        return real(*args, mesh=mesh, **kw)

    monkeypatch.setattr(training, "fit_cae", spy)
    folder = str(tmp_path / "train")
    make_dataset(folder, n_frames=3, size=256, n_cells=12, seed=1)
    out = str(tmp_path / "model")
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        rc = cli.main(["train", folder, "--output", out, "--backend", "threshold", "--device",
                       "cpu", "--mesh", "2", "--epochs", "1", "--batch-size", "8",
                       "--min-cells", "10", "--no-figures"])
    assert rc == 0, printed.getvalue()[-2000:]
    assert meshes == [virtual_mesh("cpu", 2)]
    assert "Epoch 1/1" in printed.getvalue() and os.path.exists(os.path.join(out, "scaler.pkl"))
    with pytest.raises(ValueError, match="first device"):
        training.ImprovedAnomalyDetectionTraining(str(tmp_path / "x"), device="cuda:1",
                                                  mesh=virtual_mesh("cpu", 2))
