"""Run one cell of the benchmark once and print its result line.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell, its configuration, traffic and
metrics are found by name from `BENCHMARK.json` (see `harness.py`).  The
last line on standard output is one JSON object: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics with `--trace 0`, its
per-layer ones with `--trace 1`), `device`, with `--trace 1` also
`breakdown`, and last `checks`, each number compared beside its limit,
which are also the last lines on standard error.  Exits 2 without a
result where CUDA is not available or the cell needs more cards than
there are, and 3 where a module of JAX or of the JAX package is loaded
once the window has closed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark/run.py", description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every build and kernel cache at a fixed path inside the checkout
    cache = os.path.join(ROOT, "build", "bench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)

    from benchmark import harness

    cell = harness.load_cell(ROOT, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.cell["chips"]:
        print(f"{args.workload}: needs {cell.cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    line = harness.measure(cell, args.seed, args.seconds, bool(args.trace),
                           torch.device("cuda:0"), ROOT)
    found = harness.forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package are loaded: {found}", file=sys.stderr)
        return 3
    print(f"card: {harness.card_line()}", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
