"""The readings that the check's limits are set from, for one cell on the card.

    python benchmark/control.py --workload <cell> --seeds 11,12,... [--control 3]
        [--batches 3] [--out FILE.jsonl]

In one process: the cell's frame pool, then for every seed a short window
of `--batches` batches through the program in the closed loop of a run,
one batch sampled from the seed as a run samples it, and the check's
numbers of the program against the float32 reference (the lower
readings).  For the first `--control` seeds also the control: the
reference computed with TF32 on (the precision below the configuration's
float32 with TF32 off), put in the program's place and compared with the
float32 reference in the same way (the upper readings).  One JSON line a
seed, then the largest program reading and the smallest control reading
of each number.  The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark/control.py", description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--control", type=int, default=3, help="seeds that also run the control")
    ap.add_argument("--batches", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    from benchmark import check, harness, program
    from benchmark.reference.screen import Reference
    from benchmark.traffic.frames import batch_draws, make_pool

    if not torch.cuda.is_available():
        print("control.py: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda:0")
    c = harness.load_cell(ROOT, args.workload)
    system = program.System(c.config, c.workload, ROOT, device)
    ref = Reference(c.config, c.workload, ROOT, device)
    out = open(args.out, "w") if args.out else None
    worst, least = {}, {}
    pool = make_pool(c.traffic)
    segs = torch.as_tensor(pool[..., 2].astype(np.float32)).to(device)
    greens = torch.as_tensor(pool[..., 1].astype(np.float32)).to(device)
    for n, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        loop = harness.Loop(system, segs, greens, batch_draws(seed, c.traffic),
                            c.config["qc"]["crop_capacity"])
        batches = loop.run(batches=args.batches)
        rng = np.random.default_rng([seed % 2 ** 64, 2])
        b = batches[int(rng.choice(len(batches)))]
        frames = pool[b["frames"]]
        want = ref.screen(frames)
        row = {"seed": seed, "program": check.compare([(b["result"], want)])}
        if n < args.control:
            row["control"] = check.compare([(ref.screen(frames, use_tf32=True), want)])
        row["seconds"] = round(time.perf_counter() - t0, 2)
        for key, acc, fn in (("program", worst, max), ("control", least, min)):
            for k, v in row.get(key, {}).items():
                acc[k] = fn(acc.get(k, v), v)
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
        del loop, batches
    summary = json.dumps({"workload": args.workload, "lower": worst, "upper": least,
                          "card": harness.card_line()})
    print(summary)
    if out:
        out.write(summary + "\n")
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
