"""Training of the Cellpose backend's networks (`models.cellpose.CPnet`,
`models.vit_sam.ViTSAM`) on synthetic frames, with Cellpose's loss.

The JAX package has no counterpart.  As MouseLand/cellpose `train.train_seg`
does: the targets are each instance's flows (the heat-diffusion flows of
`ops.cellpose_masks.masks_to_flows`, the GPU form, on the true labels)
and the cell mask; the loss is `MSE(y[:, :2], 5 flows) / 2 +
BCEWithLogits(y[:, 2], labels > 0)`; AdamW (weight decay 1e-5) on random
`tile`^2 crops with random flips, a linear warm-up and a tenth of the rate
over the last fifth of the steps; BatchNorm keeps running statistics with
momentum 0.05 for eval.

- `synthetic_set`: frames and true instance labels of
  `utils.synthetic.make_frame_instances` (the generator the benchmark's
  traffic copies), each frame's channel normalized as `run_tiled` does;
- `fit_cellpose`: the training loop of any Cellpose network (its
  `in_channels` and `tile`; the parameters that require grad); `fit_cpnet`
  runs it on a fresh CPnet;
- `self_check`: the share of planted cells that the trained backend
  finds again at IoU >= 0.5 on held-out frames.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from cell_image_analysis_tpu_torch.models.cellpose import init_cpnet, normalize99
from cell_image_analysis_tpu_torch.ops.cellpose_masks import masks_to_flows
from cell_image_analysis_tpu_torch.utils.synthetic import make_frame_instances


def synthetic_set(n_frames: int, size: int, n_cells: int, seed: int, device) -> tuple:
    """(images (N, H, W) float32 normalize99'd, labels (N, H, W) int32,
    flows (N, 2, H, W) float32) on `device`: `n_frames` frames of
    `make_frame_instances` from `np.random.default_rng(seed)` (cutoff 3,
    as the benchmark's traffic)."""
    rng = np.random.default_rng(seed)
    frames, labels = zip(*(make_frame_instances(rng, size=size, n_cells=n_cells, cutoff=3.0)
                           for _ in range(n_frames)))
    seg = torch.as_tensor(np.stack([f[..., 2] for f in frames]).astype(np.float32),
                          device=device)
    lab = torch.as_tensor(np.stack(labels), device=device)
    flows = torch.cat([masks_to_flows(lab[i:i + 1])[0] for i in range(n_frames)]).float()
    return normalize99(seg), lab, flows


def cellpose_loss(model, x: torch.Tensor, labels: torch.Tensor,
                  flows: torch.Tensor) -> torch.Tensor:
    """x (N, h, w, in_channels), labels (N, h, w), flows (N, 2, h, w)."""
    y = model(x)
    loss = F.mse_loss(y[..., :2], 5.0 * flows.permute(0, 2, 3, 1)) / 2.0
    return loss + F.binary_cross_entropy_with_logits(y[..., 2], (labels > 0).float())


def _batch(images, labels, flows, idx, tile: int, gen: torch.Generator, nchan: int) -> tuple:
    """Random tile^2 crops of the frames `idx`, each flipped at random
    (a flip negates its axis's flow), in channel 0 of `nchan` (the others
    zeros)."""
    n, h, w = images.shape
    xs, ls, fs = [], [], []
    for i in idx.tolist():
        r = int(torch.randint(0, h - tile + 1, (1,), generator=gen))
        c = int(torch.randint(0, w - tile + 1, (1,), generator=gen))
        im, lb = images[i, r:r + tile, c:c + tile], labels[i, r:r + tile, c:c + tile]
        fl = flows[i, :, r:r + tile, c:c + tile]
        if bool(torch.randint(0, 2, (1,), generator=gen)):
            im, lb, fl = im.flip(0), lb.flip(0), fl.flip(1) * fl.new_tensor([-1.0, 1.0])[:, None,
                                                                                       None]
        if bool(torch.randint(0, 2, (1,), generator=gen)):
            im, lb, fl = im.flip(1), lb.flip(1), fl.flip(2) * fl.new_tensor([1.0, -1.0])[:, None,
                                                                                       None]
        xs.append(im)
        ls.append(lb)
        fs.append(fl)
    x = torch.stack(xs)
    x = torch.cat([x[..., None], x.new_zeros(x.shape + (nchan - 1,))], dim=-1)
    return x, torch.stack(ls), torch.stack(fs)


def fit_cellpose(model, images, labels, flows, steps: int = 3000, batch: int = 8,
                 lr: float = 2e-3, tile: int | None = None, seed: int = 0,
                 log_every: int = 0) -> tuple:
    """(`model` in eval mode on the images' device, [(step, loss)] logged):
    AdamW on the parameters of `model` that require grad, over crops of
    `tile` (default the network's own) in its `in_channels`."""
    device = images.device
    model = model.to(device).train()
    tile = model.tile if tile is None else tile
    opt = torch.optim.AdamW([p for p in model.parameters() if p.requires_grad], lr=lr,
                            weight_decay=1e-5)
    gen = torch.Generator().manual_seed(seed)
    warm = max(1, min(100, steps // 10))
    log = []
    for step in range(steps):
        rate = lr * min(1.0, (step + 1) / warm) * (0.1 if step >= 0.8 * steps else 1.0)
        for g in opt.param_groups:
            g["lr"] = rate
        idx = torch.randint(0, images.shape[0], (batch,), generator=gen)
        x, lb, fl = _batch(images, labels, flows, idx, tile, gen, model.in_channels)
        loss = cellpose_loss(model, x, lb, fl)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        if log_every and (step % log_every == 0 or step == steps - 1):
            log.append((step, loss.item()))
            print(f"step {step}: loss {log[-1][1]:.4f}", flush=True)
    return model.eval(), log


def fit_cpnet(images, labels, flows, steps: int = 3000, batch: int = 8, lr: float = 2e-3,
              tile: int = 224, seed: int = 0, nbase=(2, 32, 64, 128, 256),
              log_every: int = 0) -> tuple:
    """(eval-mode CPnet on the images' device, [(step, loss)] logged)."""
    return fit_cellpose(init_cpnet(seed, nbase), images, labels, flows, steps=steps,
                        batch=batch, lr=lr, tile=tile, seed=seed, log_every=log_every)


def matched_share(true: np.ndarray, pred: np.ndarray, iou: float = 0.5) -> tuple:
    """(planted instances matched by a predicted one at IoU >= iou, planted
    instances) of two label maps."""
    nt, npred = int(true.max()), int(pred.max())
    if nt == 0:
        return 0, 0
    pair = np.bincount(true.reshape(-1).astype(np.int64) * (npred + 1) + pred.reshape(-1),
                       minlength=(nt + 1) * (npred + 1)).reshape(nt + 1, npred + 1)
    at, ap = pair.sum(1), pair.sum(0)
    inter = pair[1:, 1:]
    union = at[1:, None] + ap[None, 1:] - inter
    score = np.where(union > 0, inter / np.maximum(union, 1), 0.0)
    return int((score.max(axis=1, initial=0.0) >= iou).sum()), nt


def self_check(backend, n_frames: int = 4, size: int = 1024, n_cells: int = 80,
               seed: int = 999) -> dict:
    """The trained backend on held-out frames: {'matched', 'planted',
    'share', 'masks'}."""
    rng = np.random.default_rng(seed)
    matched = planted = masks = 0
    for _ in range(n_frames):
        frame, lab = make_frame_instances(rng, size=size, n_cells=n_cells, cutoff=3.0)
        seg = torch.as_tensor(frame[..., 2].astype(np.float32)[None], device=backend.device)
        pred = backend(seg)[0].cpu().numpy()
        m, n = matched_share(lab, pred)
        matched, planted, masks = matched + m, planted + n, masks + int(pred.max())
    return dict(matched=matched, planted=planted, share=matched / max(planted, 1), masks=masks)
