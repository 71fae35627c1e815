"""CAE training loop with Keras-parity callbacks.

Counterpart of `cell_image_analysis_tpu/train/trainer.py`: an 80/20 split
(sklearn's `train_test_split` rule, seed 42), batches of 32,
steps_per_epoch = len(train) // 32, up to 100 epochs, MSE loss and MAE
metric, Adam (`make_optimizer`), and the three Keras callbacks as one
state machine (`KerasCallbackState`, the JAX package's, float32
comparisons included):

- EarlyStopping(monitor=val_loss, patience=10, restore_best_weights=True);
- ModelCheckpoint(save_best_only): a copy of the weights at each new best;
- ReduceLROnPlateau(factor=0.5, patience=5, min_lr=1e-6, min_delta=1e-4),
  which writes the new rate into the optimizer's param group.

`fit_cae` keeps JAX's resident design: the training set stays on the
device, each epoch ships only the (steps, bs) permutation (numpy's
`default_rng(seed).permutation`, so both packages see the same batches),
the epoch's losses accumulate on the device, and one host fetch an epoch
reads train loss, train MAE, val loss and val MAE together.  The init and
every step's augmentation parameters are drawn from one `torch.Generator`
on the CPU, seeded with `TrainConfig.seed` (the init's draws first), and
the parameters cross to the device in one pinned buffer without a wait
(`train.augment.warp_batch`): a seed gives the same init and the same
augmented batches on every device, as JAX's threefry draws do.  (CUDA's
Philox stream is not the CPU's mt19937, so a generator on the card would
train another problem than the CPU's from the same seed.)

With a mesh (`parallel.mesh`) the data parallelism of JAX's GSPMD run is
spelled out: the CAE is replicated over the mesh's devices (shards on one
device share a replica), each step's augmentation parameters are drawn
for the whole batch from the one generator, and the batch is split over
the shards, each warped and run on its device.  The
BatchNorm layers take the whole batch's statistics
(`models.cae.forward_sharded`), the loss is the whole batch's mean, so
each shard's gradient carries its share of the batch; the replicas'
gradients are added on the home device, Adam steps there and the new
weights are copied back.  Validation runs on the home device.  The run
equals the unsharded one up to the order of the sums.  Without a mesh the
same step runs on a mesh of one shard on the data's device.

The epochs run with cuDNN's deterministic algorithms (the flag is set for
each epoch and put back after it), so that a seed gives the same run on
the card each time; under cuDNN's default algorithms two card runs from
one init part by ~1e-2 after 249 steps.  It costs nothing measurable a
step (`scripts/probe_cae_draws.py`).
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from cell_image_analysis_tpu_torch.config import AugmentConfig, CAEConfig, TrainConfig
from cell_image_analysis_tpu_torch.io.artifacts import resolve_device
from cell_image_analysis_tpu_torch.models.cae import forward_sharded, init_cae
from cell_image_analysis_tpu_torch.parallel.mesh import virtual_mesh
from cell_image_analysis_tpu_torch.train.augment import sample_params, warp_batch


@dataclass
class History:
    """Keras-style history record."""

    history: dict = field(default_factory=lambda: {
        "loss": [], "mae": [], "val_loss": [], "val_mae": [], "lr": []
    })

    def append(self, **kw):
        for k, v in kw.items():
            self.history[k].append(float(v))


@dataclass
class KerasCallbackState:
    """EarlyStopping + ModelCheckpoint + ReduceLROnPlateau as one explicit
    state machine with Keras-exact semantics, monitor='val_loss', mode='min':

    - EarlyStopping(min_delta=0): improvement is strict `<`; wait resets on
      improvement, stop when wait >= patience.
    - ModelCheckpoint(save_best_only): save exactly when val improves.
    - ReduceLROnPlateau: improvement is `current < best - min_delta`; after
      `patience` stale epochs lr -> max(lr*factor, min_lr); wait resets only
      when the lr actually moved (Keras attempts a no-op reduction every
      epoch once lr sits at min_lr).
    """

    lr: float
    es_patience: int = 10
    rlr_patience: int = 5
    rlr_factor: float = 0.5
    rlr_min_lr: float = 1e-6
    rlr_min_delta: float = 1e-4
    best_val: float = np.inf
    es_wait: int = 0
    rlr_best: float = np.inf
    rlr_wait: int = 0

    def on_epoch_end(self, val_loss: float) -> tuple[bool, bool, bool]:
        """Returns (improved, stop, lr_reduced); on lr_reduced read the new
        rate from `.lr`."""
        # Keras 3 monitor_op is keras.ops.less: the comparison happens in
        # FLOAT32 (python-float logs are cast to f32 tensors), so values
        # within f32 eps of the best tie instead of improving
        improved = bool(np.float32(val_loss) < np.float32(self.best_val))
        if improved:
            self.best_val = val_loss
            self.es_wait = 0
        else:
            self.es_wait += 1
        stop = self.es_wait >= self.es_patience

        lr_reduced = False
        # Keras 3 negates min_delta for mode='min' and tests
        # `current - min_delta < best` — i.e. current + min_delta < best,
        # with the python-float64 sum then compared in f32 by keras.ops.less.
        # Same math as `current < best - min_delta` but NOT the same
        # rounding; sequences stepping by ~min_delta sit exactly on the edge
        if bool(np.float32(val_loss + self.rlr_min_delta)
                < np.float32(self.rlr_best)):
            self.rlr_best = val_loss
            self.rlr_wait = 0
        else:
            self.rlr_wait += 1
            if self.rlr_wait >= self.rlr_patience:
                new_lr = max(self.lr * self.rlr_factor, self.rlr_min_lr)
                if new_lr < self.lr:
                    self.lr = new_lr
                    lr_reduced = True
                    self.rlr_wait = 0
        return improved, stop, lr_reduced


def train_test_split(X, test_size: float, random_state: int):
    """sklearn's `train_test_split(X, test_size=..., random_state=...)`
    (ShuffleSplit's rule): perm = RandomState(random_state).permutation(n),
    n_test = ceil(test_size * n), test = perm[:n_test], train =
    perm[n_test:].  Returns (X[train], X[test])."""
    n = len(X)
    perm = np.random.RandomState(random_state).permutation(n)
    n_test = math.ceil(test_size * n)
    if isinstance(X, torch.Tensor):
        perm = torch.as_tensor(perm, device=X.device)
    return X[perm[n_test:]], X[perm[:n_test]]


def make_optimizer(cae_cfg: CAEConfig, params) -> torch.optim.Adam:
    """Adam with Keras' betas and epsilon; the lr lives in the param group."""
    return torch.optim.Adam(params, lr=cae_cfg.learning_rate, betas=(0.9, 0.999),
                            eps=cae_cfg.adam_eps)


def _set_lr(opt: torch.optim.Optimizer, lr: float) -> None:
    for group in opt.param_groups:
        group["lr"] = lr


def _copy_state(model: torch.nn.Module) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


@contextlib.contextmanager
def _cudnn_deterministic():
    """cuDNN's deterministic algorithms inside, the caller's setting after."""
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = was


def _epoch(step, models, X, perm, X_val) -> torch.Tensor:
    """One epoch of `step(batch) -> (loss, MAE)` over the (steps, bs) index
    tensor `perm` of the resident X (`models` in train mode), then the val
    evaluation of `models[0]` in eval mode; returns the device tensor
    (train loss, train MAE, val loss, val MAE)."""
    steps = perm.shape[0]
    losses = torch.empty(steps, device=X.device)
    maes = torch.empty(steps, device=X.device)
    for m in models:
        m.train()
    for s in range(steps):
        losses[s], maes[s] = step(X[perm[s]])
    model = models[0]
    model.eval()
    with torch.no_grad():
        recon, _ = model(X_val)
        diff = X_val - recon
        return torch.stack([losses.mean(), maes.mean(), torch.mean(diff * diff),
                            torch.mean(torch.abs(diff))])


class _Replicas:
    """The CAE's replicas over a mesh: `models[i]` is shard i's, `models[0]`
    the home one, which the optimizer owns; `others` are the distinct
    replicas on other devices."""

    def __init__(self, model: torch.nn.Module, mesh):
        from cell_image_analysis_tpu_torch.parallel.sharding import replicate

        self.mesh = mesh
        self.models = replicate(mesh, model)
        self.others = [r for r in dict.fromkeys(self.models) if r is not model]

    def add_grads(self) -> None:
        """Adds the other replicas' gradients into the home replica's."""
        home = self.models[0]
        for r in self.others:
            for p, q in zip(home.parameters(), r.parameters()):
                p.grad.add_(q.grad.to(p.device))

    @torch.no_grad()
    def sync(self) -> None:
        """Copies the home replica's weights and running statistics out."""
        state = self.models[0].state_dict()
        for r in self.others:
            for k, v in r.state_dict().items():
                v.copy_(state[k], non_blocking=True)


def _step(reps: _Replicas, opt, batch, generator, aug_cfg):
    """One step on the replicas' mesh: (loss, MAE) of the whole batch, on
    the home device."""
    devices = reps.mesh.devices
    params = sample_params(generator, batch.shape[0], aug_cfg)   # on the generator's device
    splits = [torch.tensor_split(t, len(devices)) for t in (batch, *params)]
    xs = [warp_batch(parts[0].to(d, non_blocking=True), parts[1:])
          for d, parts in zip(devices, zip(*splits))]
    opt.zero_grad(set_to_none=True)
    for r in reps.others:
        r.zero_grad(set_to_none=True)
    outs = forward_sharded(reps.models, xs)
    home, count = batch.device, batch.numel()
    diffs = [x - recon for x, (recon, _) in zip(xs, outs)]
    loss = sum((d * d).sum().to(home) for d in diffs) / count
    loss.backward()
    reps.add_grads()
    opt.step()
    reps.sync()
    with torch.no_grad():
        mae = sum(d.abs().sum().to(home) for d in diffs) / count
    return loss.detach(), mae


def fit_cae(
    cells,
    cae_cfg: CAEConfig = CAEConfig(),
    train_cfg: TrainConfig = TrainConfig(),
    aug_cfg: AugmentConfig = AugmentConfig(),
    verbose: bool = True,
    checkpoint_dir: Optional[str] = None,
    resume: bool = False,
    mesh=None,
):
    """Train the CAE on (N, 64, 64) or (N, 64, 64, 1) cell images: a
    tensor trains on its device, a numpy array on the card (it raises
    without one); with a `mesh` both train on the mesh, whose first device
    holds the data and the optimizer.

    Returns (model, state, history): the model holds the best-val weights
    (EarlyStopping's restore), `state` is a copy of its state dict and
    history mirrors Keras' History.history.
    """
    if mesh is not None:
        dev, X = mesh.home, torch.as_tensor(cells).float()
    elif isinstance(cells, torch.Tensor):
        dev, X = cells.device, cells.float()
    else:
        dev, X = resolve_device(None), torch.as_tensor(np.asarray(cells, np.float32))
    if X.dim() == 3:
        X = X[..., None]  # reference: np.expand_dims(cell_images, axis=-1)
    X_train, X_val = train_test_split(X, test_size=train_cfg.val_split,
                                      random_state=train_cfg.seed)
    # the training set stays resident on the device across epochs
    X_train, X_val = X_train.to(dev).contiguous(), X_val.to(dev).contiguous()
    bs = train_cfg.batch_size
    steps = max(1, len(X_train) // bs)

    # the draws come from the CPU whatever the device (module docstring)
    generator = torch.Generator().manual_seed(train_cfg.seed)
    model = init_cae(generator, input_size=X.shape[1],
                     encoder_filters=cae_cfg.encoder_filters,
                     decoder_filters=cae_cfg.decoder_filters,
                     bn_momentum=cae_cfg.bn_momentum, bn_epsilon=cae_cfg.bn_epsilon).to(dev)
    opt = make_optimizer(cae_cfg, model.parameters())
    history = History()
    lr = cae_cfg.learning_rate
    cbs = KerasCallbackState(
        lr=lr,
        es_patience=train_cfg.early_stop_patience,
        rlr_patience=train_cfg.reduce_lr_patience,
        rlr_factor=train_cfg.reduce_lr_factor,
        rlr_min_lr=train_cfg.reduce_lr_min_lr,
        rlr_min_delta=train_cfg.reduce_lr_min_delta,
    )
    best_state = _copy_state(model)
    start_epoch = 0
    rng = np.random.default_rng(train_cfg.seed)

    if resume and checkpoint_dir:
        from cell_image_analysis_tpu_torch.train.checkpoint import load_checkpoint

        ck = load_checkpoint(checkpoint_dir)
        if ck is not None:
            model.load_state_dict(ck["model"])
            opt.load_state_dict(ck["optimizer"])
            generator.set_state(ck["generator_state"])
            lr = cbs.lr = float(ck["lr"])
            _set_lr(opt, lr)
            cbs.best_val = float(ck["best_val"])
            best_state = {k: v.to(dev) for k, v in ck["best_model"].items()}
            cbs.es_wait, cbs.rlr_best, cbs.rlr_wait = (
                ck["es_wait"], float(ck["rlr_best"]), ck["rlr_wait"])
            history.history = {k: list(v) for k, v in ck["history"].items()}
            start_epoch = int(ck["epoch"]) + 1
            rng.bit_generator.state = ck["np_rng_state"]
            if verbose:
                print(f"Resuming training from epoch {start_epoch + 1}")
    # without a mesh the step runs on a mesh of one shard on `dev`
    mesh = virtual_mesh(dev, 1) if mesh is None else mesh
    if bs < mesh.shape["data"]:
        raise ValueError(f"batch size {bs} is smaller than the mesh")
    reps = _Replicas(model, mesh)

    def step(batch):
        return _step(reps, opt, batch, generator, aug_cfg)

    for epoch in range(start_epoch, train_cfg.epochs):
        perm = rng.permutation(len(X_train))[: steps * bs].reshape(steps, bs)
        with _cudnn_deterministic():
            metrics = _epoch(step, reps.models, X_train, torch.as_tensor(perm).to(dev), X_val)
        train_loss, train_mae, val_loss, val_mae = (
            float(v) for v in metrics.cpu().numpy())   # the one host fetch
        history.append(loss=train_loss, mae=train_mae, val_loss=val_loss, val_mae=val_mae, lr=lr)
        if verbose:
            print(
                f"Epoch {epoch + 1}/{train_cfg.epochs} - loss: {train_loss:.6f} - "
                f"mae: {train_mae:.6f} - val_loss: {val_loss:.6f} - val_mae: {val_mae:.6f}"
            )

        # Keras runs every callback's on_epoch_end even on the stopping
        # epoch, so the lr update applies before the break
        improved, stop, lr_reduced = cbs.on_epoch_end(val_loss)
        if improved:
            best_state = _copy_state(model)
        if lr_reduced:
            lr = cbs.lr
            _set_lr(opt, lr)
            if verbose:
                print(f"Epoch {epoch + 1}: ReduceLROnPlateau reducing lr to {lr:.2e}")
        if stop:
            if verbose:
                print(f"Epoch {epoch + 1}: early stopping (restoring best weights)")
            break

        if checkpoint_dir:
            from cell_image_analysis_tpu_torch.train.checkpoint import save_checkpoint

            save_checkpoint(checkpoint_dir, dict(
                epoch=epoch, model=model.state_dict(), optimizer=opt.state_dict(),
                generator_state=generator.get_state(), lr=lr, best_val=cbs.best_val,
                best_model=best_state, es_wait=cbs.es_wait, rlr_best=cbs.rlr_best,
                rlr_wait=cbs.rlr_wait, history=history.history,
                np_rng_state=rng.bit_generator.state,
            ))

    # EarlyStopping(restore_best_weights=True)
    model.load_state_dict(best_state)
    model.eval()
    return model, best_state, history
