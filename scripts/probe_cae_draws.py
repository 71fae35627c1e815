#!/usr/bin/env python3
"""Where the CAE trainer's random draws come from, and what that does on the card.

    python3 scripts/probe_cae_draws.py [--epochs 12] [--cells 2048] [--steps 200]
                                       [--out build/probe_cae_draws.json]

The train bench's call, `fit_cae(make_cells(default_rng(3), 2048),
TrainConfig(epochs=12))` (`utils/bench.run_train_bench`), on one GPU, with
the init's and the augmentation's draws taken from one generator seeded
with `TrainConfig.seed` that the probe chooses, whatever `fit_cae` itself
would draw from (it replaces the trainer's `init_cae` and `sample_params`
for the run):

- (a) a generator on the card (CUDA's Philox stream);
- (b) a generator on the CPU (mt19937, the stream a CPU run draws);
- (c) as (b), with cuDNN's deterministic algorithms;
- (d) as (a), with cuDNN's deterministic algorithms.

Each run prints its per-epoch history (loss, val_loss, lr), the epoch it
stopped at and the epoch of its best val_loss, beside the history that the
same call gave on a CPU (`CPU_VAL_LOSS`).  Then the step's wall time on the
card (host clock over `--steps` steps of `train.trainer._step`, synchronized,
after 20 held ones): draws on the CPU against draws on the card, and cuDNN
deterministic against its default, each pair in turns (x, y, y, x, x, y, y, x); and the
first call in a step that waits on the device, if one does (one step under
`torch.cuda.set_sync_debug_mode("error")`), for each draw.  The
`nvidia-smi` name and power limit are printed beside the numbers.  Imports
nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# the same call on a CPU (the port, 2,048 cells, 12 epochs, all 12 run at
# lr 1e-3; ROADMAP.md Queue 3 item 1)
CPU_VAL_LOSS = (0.0367, 0.0406, 0.0421, 0.0312, 0.0257, 0.0253, 0.0122, 0.0208, 0.0097,
                0.0165, 0.0124, 0.0091)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=12)
    ap.add_argument("--cells", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--out", default=os.path.join("build", "probe_cae_draws.json"))
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("probe_cae_draws: no CUDA device", file=sys.stderr)
        return 1
    from cell_image_analysis_tpu_torch.config import AugmentConfig, CAEConfig, TrainConfig
    from cell_image_analysis_tpu_torch.models.cae import init_cae
    from cell_image_analysis_tpu_torch.parallel.mesh import virtual_mesh
    from cell_image_analysis_tpu_torch.train import augment, trainer
    from cell_image_analysis_tpu_torch.utils.synthetic import make_cells

    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    cfg = TrainConfig(epochs=args.epochs)
    X = torch.as_tensor(make_cells(np.random.default_rng(3), args.cells)[..., None], device=dev)

    def generator(draws: str):
        return torch.Generator(device=dev if draws == "card" else "cpu").manual_seed(cfg.seed)

    def fit(draws: str, deterministic: bool) -> dict:
        gen = generator(draws)
        real_init, real_sample = trainer.init_cae, trainer.sample_params
        trainer.init_cae = lambda generator, **kw: real_init(gen, **kw).to(dev)
        trainer.sample_params = lambda generator, n, acfg: real_sample(gen, n, acfg)
        torch.backends.cudnn.deterministic = deterministic
        try:
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            _, _, hist = trainer.fit_cae(X, train_cfg=cfg, verbose=False)
            torch.cuda.synchronize(dev)
            seconds = time.perf_counter() - t0
        finally:
            trainer.init_cae, trainer.sample_params = real_init, real_sample
            torch.backends.cudnn.deterministic = False
        h = hist.history
        val = h["val_loss"]
        n = min(len(val), len(CPU_VAL_LOSS))
        return dict(draws=draws, deterministic=deterministic, seconds=seconds,
                    epochs_run=len(val), best_epoch=int(np.argmin(val)) + 1,
                    loss=h["loss"], val_loss=val, lr=h["lr"],
                    val_rel_to_cpu=[abs(val[k] - CPU_VAL_LOSS[k]) / CPU_VAL_LOSS[k]
                                    for k in range(n)])

    runs = {}
    for tag, draws, det in (("a", "card", False), ("b", "cpu", False), ("c", "cpu", True),
                            ("d", "card", True)):
        r = runs[tag] = fit(draws, det)
        print(f"({tag}) draws on the {draws}, cuDNN deterministic {det}: {r['epochs_run']} "
              f"epochs run in {r['seconds']:.3f} s, best val_loss at epoch {r['best_epoch']}; "
              f"val_loss {[round(v, 5) for v in r['val_loss']]}; loss "
              f"{[round(v, 5) for v in r['loss']]}; lr {r['lr']}; relative to the CPU's "
              f"val_loss {[round(v, 3) for v in r['val_rel_to_cpu']]} [{smi}]", flush=True)
    print(f"the CPU's val_loss (the same call, all 12 epochs run): {list(CPU_VAL_LOSS)}")

    # the init each generator draws: the card's stream is not the CPU's
    inits = [init_cae(generator(d)).to(dev).state_dict() for d in ("card", "cpu")]
    init_gap = max(float((inits[0][k] - inits[1][k]).abs().max()) for k in inits[1])
    print(f"init from the card's generator against the CPU's: largest weight difference "
          f"{init_gap:.3e}")

    # the step's wall time: draws on the CPU against the card, cuDNN
    # deterministic against its default, in turns
    X_train, _ = trainer.train_test_split(X, cfg.val_split, cfg.seed)
    bs = cfg.batch_size
    rng = np.random.default_rng(0)
    idx = [torch.as_tensor(rng.choice(len(X_train), bs, replace=False), device=dev)
           for _ in range(args.steps + 20)]

    def step_ms(draws: str, deterministic: bool) -> float:
        model = init_cae(torch.Generator().manual_seed(0)).to(dev)
        opt = trainer.make_optimizer(CAEConfig(), model.parameters())
        reps = trainer._Replicas(model, virtual_mesh(dev, 1))
        gen = torch.Generator(device=dev if draws == "card" else "cpu").manual_seed(1)
        model.train()
        torch.backends.cudnn.deterministic = deterministic
        try:
            for i in idx[:20]:
                trainer._step(reps, opt, X_train[i], gen, AugmentConfig())
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            for i in idx[20:]:
                trainer._step(reps, opt, X_train[i], gen, AugmentConfig())
            torch.cuda.synchronize(dev)
            return (time.perf_counter() - t0) * 1e3 / args.steps
        finally:
            torch.backends.cudnn.deterministic = False

    draws_ms = {k: [] for k in ("cpu", "card")}
    for d in ("cpu", "card", "card", "cpu") * 2:
        draws_ms[d].append(step_ms(d, False))
    det_ms = {k: [] for k in (False, True)}
    for det in (False, True, True, False) * 2:
        det_ms[det].append(step_ms("cpu", det))

    # where a step waits on the device, if it does: one step under
    # torch.cuda's sync debug mode, after the held ones
    def first_sync(draws: str) -> str:
        model = init_cae(torch.Generator().manual_seed(0)).to(dev)
        opt = trainer.make_optimizer(CAEConfig(), model.parameters())
        reps = trainer._Replicas(model, virtual_mesh(dev, 1))
        gen = torch.Generator(device=dev if draws == "card" else "cpu").manual_seed(1)
        model.train()
        for i in idx[:3]:
            trainer._step(reps, opt, X_train[i], gen, AugmentConfig())
        torch.cuda.synchronize(dev)
        torch.cuda.set_sync_debug_mode("error")
        try:
            trainer._step(reps, opt, X_train[idx[3]], gen, AugmentConfig())
            return "none"
        except RuntimeError as e:
            frames = [f"{os.path.basename(f.filename)}:{f.lineno} {f.line}"
                      for f in traceback.extract_tb(e.__traceback__)]
            return f"{e}".splitlines()[0] + " at " + " <- ".join(reversed(frames[-3:]))
        finally:
            torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize(dev)

    syncs = {d: first_sync(d) for d in ("cpu", "card")}
    print(f"the first synchronizing call in a step: draws on the CPU: {syncs['cpu']}; on the "
          f"card: {syncs['card']}", flush=True)
    # the draw itself, on the host: sample_params for one batch
    gen = torch.Generator().manual_seed(2)
    t0 = time.perf_counter()
    for _ in range(1000):
        augment.sample_params(gen, bs, AugmentConfig())
    draw_us = (time.perf_counter() - t0) * 1e3
    print(f"step wall ms ({args.steps} steps of {bs} cells, in turns): draws on the CPU "
          f"{draws_ms['cpu']}, on the card {draws_ms['card']}; cuDNN default {det_ms[False]}, "
          f"deterministic {det_ms[True]} (draws on the CPU); sample_params on the CPU "
          f"{draw_us:.2f} us a batch [{smi}]", flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(dict(runs=runs, cpu_val_loss=CPU_VAL_LOSS, init_gap=init_gap,
                       step_ms_draws=draws_ms,
                       step_ms_deterministic={str(k): v for k, v in det_ms.items()},
                       sample_params_us=draw_us, first_sync=syncs, smi=smi,
                       torch=torch.__version__, cuda=torch.version.cuda), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
