#!/usr/bin/env python3
"""Where two float64 CAE training runs, one shard against a mesh, part.

    python3 scripts/probe_mesh_f64.py [--epochs 3] [--trace 40] [--out build/probe_mesh_f64.json]

On one GPU: smoke phase 12 (e)'s float64 free runs. The cells are phase
10's: the 40 frames of phase 7's `wildtype` folder (`make_dataset`, 1024^2,
80 cells, in chunks of 8 with seeds 21, 1021, ...), extracted by
`ImprovedAnomalyDetectionTraining(PipelineConfig()).extract_batch` in
batches of 8.  `fit_cae`'s batches (batch 32), its init (a CPU generator
seeded with `TrainConfig.seed`) and augmentation draws (seed 1), one shard
against a virtual mesh of 4 on cuda:0, cuDNN deterministic, as the smoke
runs them.  With `--no-cudnn` the runs take PyTorch's own convolutions.

The two runs step in lockstep, so that each step of the first `--trace`
compares them where they stand: the relative loss difference; the ReLU
inputs whose sign differs and the max-pool choices that differ, a layer
each; each leaf's gradient, Adam's direction m_hat / (sqrt(v_hat) + eps)
and the update applied, as the largest difference over the first run's
largest value, and the gradient entries that are 0 in one run only; for
`convs.0.bias` (where the weights part most) the gradient, the direction
and the update of both runs, and in its channel whose direction differs
most the gradient, sqrt(v_hat) and direction; and where conv 0's ReLU
inputs change sign, their channels, those channels' biases in both runs,
the pre-activations there and the largest input in their 3x3 patches.
Printed: the relative loss difference where it first passes 1e-14, 1e-12,
..., the trace around the first step past 1e-12 and the per-step lines
above, with the `nvidia-smi` name and power limit; written to `--out` in
full.  Imports nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

WILDTYPE = (40, 21, 8)      # frames, seed, frames a chunk (chip_smoke.SAMPLES, CHUNK_FRAMES)
LEAF = "convs.0.bias"


def _rel(a, b) -> float:
    """The largest |a - b| over the largest |b| (0 where both are 0)."""
    scale = float(b.abs().max())
    return float((a - b).abs().max()) / scale if scale > 0 else float((a - b).abs().max())


def lockstep(dev, X_train, batches, meshes, aug, seed: int, trace: int) -> dict:
    """Trains one float64 CAE on each of `meshes` (two) over `batches`, one
    step of each in turn; returns the losses of both and, for the first
    `trace` steps, what differs between them (the module docstring)."""
    import torch
    import torch.nn.functional as F

    from cell_image_analysis_tpu_torch.config import CAEConfig
    from cell_image_analysis_tpu_torch.models import cae as cae_mod
    from cell_image_analysis_tpu_torch.models.cae import init_cae
    from cell_image_analysis_tpu_torch.train import trainer

    runs = []
    for m in meshes:
        model = init_cae(torch.Generator().manual_seed(seed)).to(dev, torch.float64)
        model.train()
        opt = trainer.make_optimizer(CAEConfig(), model.parameters())
        runs.append(dict(model=model, opt=opt, reps=trainer._Replicas(model, m),
                         gen=torch.Generator().manual_seed(1), losses=[]))
    names = [n for n, _ in runs[0]["model"].named_parameters()]
    beta1, beta2 = runs[0]["opt"].defaults["betas"]
    eps = runs[0]["opt"].defaults["eps"]
    seen = {}

    def conv_hook(mod, inp, out):
        seen.setdefault(("conv", id(mod)), []).append(out.detach())
        seen.setdefault(("input", id(mod)), []).append(inp[0].detach())

    def resample(self, i, h):
        if i < self.n_enc:
            out, idx = F.max_pool2d(h, 2, return_indices=True)
            seen.setdefault(("pool", i), []).append(idx)
            return out
        b, c, hh, ww = h.shape
        return h[:, :, :, None, :, None].expand(b, c, hh, 2, ww, 2).reshape(b, c, 2 * hh, 2 * ww)

    def root_v(opt, p):
        st = opt.state[p]
        return (st["exp_avg_sq"] / (1 - beta2 ** float(st["step"]))).sqrt()

    def direction(opt, p):
        st = opt.state[p]
        return st["exp_avg"] / (1 - beta1 ** float(st["step"])) / (root_v(opt, p) + eps)

    real = cae_mod.CAE.resample
    steps = []
    for k, i in enumerate(batches):
        record = k < trace
        taken = []
        for run in runs:
            model = run["model"]
            before = [p.detach().clone() for p in model.parameters()] if record else None
            seen.clear()
            hooks = ([c.register_forward_hook(conv_hook) for c in model.convs[:-1]]
                     if record else [])
            cae_mod.CAE.resample = resample if record else real
            try:
                loss, _ = trainer._step(run["reps"], run["opt"], X_train[i], run["gen"], aug)
            finally:
                cae_mod.CAE.resample = real
                for h in hooks:
                    h.remove()
            run["losses"].append(loss)
            if record:
                params = list(model.parameters())
                conv0 = model.convs[0]
                taken.append(dict(
                    loss=float(loss),
                    pre0=torch.cat(seen[("conv", id(conv0))]),
                    in0=torch.cat(seen[("input", id(conv0))]),
                    bias0=before[names.index(LEAF)],
                    relu=[torch.cat(seen[("conv", id(c))]) > 0 for c in model.convs[:-1]],
                    pool=[torch.cat(seen[("pool", j)]) for j in range(model.n_enc)],
                    grad=[p.grad.detach().clone() for p in params],
                    dir=[direction(run["opt"], p) for p in params],
                    upd=[p.detach() - b for p, b in zip(params, before)],
                    root_v=root_v(run["opt"], params[names.index(LEAF)])))
        if not record:
            continue
        a, b = taken[1], taken[0]       # mesh against one shard
        leaf = names.index(LEAF)
        flips0 = a["relu"][0] != b["relu"][0]
        detail = None
        if bool(flips0.any()):
            # conv 0's sign flips: their channels, each channel's bias in
            # both runs, the pre-activations there, and the largest input
            # in each flipped pixel's 3x3 patch
            where = flips0.nonzero()
            chans = where[:, 1].unique().tolist()
            patch = F.max_pool2d(b["in0"].abs(), 3, stride=1, padding=1)
            detail = dict(
                channels={int(c): int((where[:, 1] == c).sum()) for c in chans},
                bias={int(c): [float(t["bias0"][c]) for t in (b, a)] for c in chans},
                pre=[float(t["pre0"][flips0].abs().max()) for t in (b, a)],
                patch_max=float(patch[:, 0][flips0.any(dim=1)].max()))
        c = int((a["dir"][leaf] - b["dir"][leaf]).abs().argmax())
        steps.append(dict(
            conv0_flips=detail,
            # the channel of LEAF whose direction differs most: its
            # gradient, sqrt(v_hat) and direction in both runs
            leaf_channel=dict(channel=c, **{key: [float(t[key][leaf][c]) for t in (b, a)]
                                            for key in ("grad", "dir")},
                              root_v=[float(t["root_v"][c]) for t in (b, a)]),
            step=k + 1,
            loss=abs(a["loss"] - b["loss"]) / abs(b["loss"]),
            relu_flips=[int((x != y).sum()) for x, y in zip(a["relu"], b["relu"])],
            pool_flips=[int((x != y).sum()) for x, y in zip(a["pool"], b["pool"])],
            grad={n: _rel(x, y) for n, x, y in zip(names, a["grad"], b["grad"])},
            zero_once={n: int(((x == 0) != (y == 0)).sum())
                       for n, x, y in zip(names, a["grad"], b["grad"])},
            dir={n: _rel(x, y) for n, x, y in zip(names, a["dir"], b["dir"])},
            upd={n: _rel(x, y) for n, x, y in zip(names, a["upd"], b["upd"])},
            weights={n: float((p.detach() - q.detach()).abs().max()) for n, p, q in zip(
                names, runs[1]["model"].parameters(), runs[0]["model"].parameters())},
            leaf={key: [float(t[key][leaf].abs().max()) for t in (b, a)]
                  for key in ("grad", "dir", "upd")},
            leaf_diff={key: float((a[key][leaf] - b[key][leaf]).abs().max())
                       for key in ("grad", "dir", "upd")}))
    losses = [torch.stack(r["losses"]).cpu().numpy() for r in runs]
    states = [r["model"].state_dict() for r in runs]
    return dict(losses=losses, states=states, steps=steps)


def _worst(d: dict) -> str:
    n, v = max(d.items(), key=lambda kv: kv[1])
    return f"{n} {v:.1e}"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--trace", type=int, default=40, help="steps compared in full")
    ap.add_argument("--no-cudnn", action="store_true")
    ap.add_argument("--out", default=os.path.join("build", "probe_mesh_f64.json"))
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("probe_mesh_f64: no CUDA device", file=sys.stderr)
        return 1
    from cell_image_analysis_tpu_torch.config import AugmentConfig, PipelineConfig, TrainConfig
    from cell_image_analysis_tpu_torch.io.artifacts import load_unet_variables
    from cell_image_analysis_tpu_torch.io.ingest import frames_to_device
    from cell_image_analysis_tpu_torch.parallel.mesh import virtual_mesh
    from cell_image_analysis_tpu_torch.pipeline.training import ImprovedAnomalyDetectionTraining
    from cell_image_analysis_tpu_torch.train import trainer
    from cell_image_analysis_tpu_torch.utils.synthetic import make_frame

    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.enabled = not args.no_cudnn
    torch.backends.cudnn.deterministic = True
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()

    # phase 10's cells
    import tempfile

    tr = ImprovedAnomalyDetectionTraining(tempfile.mkdtemp(), PipelineConfig(),
                                          load_unet_variables(), device=dev)
    n_frames, seed, chunk = WILDTYPE
    cells = []
    for k in range(n_frames // chunk):
        rng = np.random.default_rng(seed + 1000 * k)
        frames = [make_frame(rng, size=1024, n_cells=80) for _ in range(chunk)]
        segs = frames_to_device([f[..., 2] for f in frames], dev)
        greens = frames_to_device([f[..., 1] for f in frames], dev)
        cells.append(tr.extract_batch(segs, greens)[0])
    cells = np.concatenate(cells)
    print(f"{len(cells)} cells from {n_frames} frames", flush=True)

    X = torch.as_tensor(cells, device=dev).reshape(-1, 64, 64, 1)
    cfg = TrainConfig(epochs=args.epochs)
    X_train, _ = trainer.train_test_split(X, cfg.val_split, cfg.seed)
    bs, rng = cfg.batch_size, np.random.default_rng(cfg.seed)
    steps = len(X_train) // bs
    batches = [torch.as_tensor(row, device=dev) for _ in range(cfg.epochs)
               for row in rng.permutation(len(X_train))[:steps * bs].reshape(steps, bs)]
    run = lockstep(dev, X_train.double(), batches, (virtual_mesh(dev, 1), virtual_mesh(dev, 4)),
                   AugmentConfig(), cfg.seed, args.trace)
    (l_one, l_mesh), (s_one, s_mesh) = run["losses"], run["states"]
    rel = np.abs(l_mesh - l_one) / np.abs(l_one)
    firsts = {f"{t:.0e}": (int(np.argmax(rel > t)) + 1 if (rel > t).any() else None)
              for t in (1e-14, 1e-12, 1e-10, 1e-8, 1e-6)}
    gaps = {k: float((s_mesh[k] - s_one[k]).abs().max()) for k in s_one}
    w, worst_w = max((v, k) for k, v in gaps.items())
    print(f"float64 free runs ({'cuDNN' if not args.no_cudnn else 'PyTorch own'} convolutions), "
          f"{len(batches)} steps: largest relative loss difference {rel.max():.3e}, weights "
          f"{w:.3e} (at {worst_w}); first step past each level {firsts}; at steps "
          + ", ".join(f"{k + 1}: {rel[k]:.1e}" for k in sorted({0, 9, 19, 29, 39, 49, len(rel) - 1})
                      if k < len(rel)) + f" [{smi}]", flush=True)
    first = firsts["1e-12"] or len(run["steps"])
    for s in run["steps"][max(first - 3, 0):first + 3]:
        g, d, u = (s["leaf"][k] for k in ("grad", "dir", "upd"))
        dg, dd, du = (s["leaf_diff"][k] for k in ("grad", "dir", "upd"))
        print(f"step {s['step']}: loss {s['loss']:.1e} apart; ReLU signs that differ "
              f"{s['relu_flips']}, max-pool choices {s['pool_flips']}; worst leaf: gradient "
              f"{_worst(s['grad'])}, Adam's direction {_worst(s['dir'])}, update "
              f"{_worst(s['upd'])}, weights after {_worst(s['weights'])}; gradient entries 0 "
              f"in one run only {sum(s['zero_once'].values())}; {LEAF}: |gradient| "
              f"{g[0]:.3e} / {g[1]:.3e} (diff {dg:.1e}), |direction| {d[0]:.3e} / {d[1]:.3e} "
              f"(diff {dd:.1e}), |update| {u[0]:.3e} / {u[1]:.3e} (diff {du:.1e})", flush=True)
    for s in run["steps"]:
        ch = s["leaf_channel"]
        print(f"step {s['step']}: {LEAF} channel {ch['channel']} (its direction differs most): "
              f"gradient {ch['grad'][0]:.3e} / {ch['grad'][1]:.3e}, sqrt(v_hat) "
              f"{ch['root_v'][0]:.3e} / {ch['root_v'][1]:.3e}, direction {ch['dir'][0]:.3e} / "
              f"{ch['dir'][1]:.3e}", flush=True)
        if s["conv0_flips"] is not None:
            f = s["conv0_flips"]
            print(f"step {s['step']}: conv 0's ReLU flips by channel {f['channels']}, the "
                  f"channel's bias (one shard / mesh) {f['bias']}, |pre-activation| at the "
                  f"flips up to {f['pre'][0]:.1e} / {f['pre'][1]:.1e}, largest input in their "
                  f"3x3 patches {f['patch_max']:.1e}", flush=True)
    result = dict(cells=len(cells), steps=len(batches), rel_max=float(rel.max()), weights=w,
                  worst_weight=worst_w, firsts=firsts, rel=rel.tolist(), smi=smi,
                  cudnn=not args.no_cudnn, trace=run["steps"])
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
