#!/usr/bin/env python3
"""Ablations of the CC tile kernel (`csrc/cc_tile_labels.cu`) on one GPU.

    python3 scripts/cc_ablate.py [--frames-npy PATH]

Builds the kernel's source as it is and in variants, each a text patch of
the source that removes or changes one part, all with nvcc at once into
`build/cc_ablate/`, and times each variant's five kernels under
`ops.cuda.cc.label_components_cuda` on the threshold masks of the bench's
16 synthetic 1024^2 frames at connectivity 1 (torch.profiler device time
a call, `scripts/cc_split.kernel_ms`).  A variant that removes a part
gives wrong labels; only the unpatched build is checked against
`label_components_plain`.  What a part costs is the difference to the
unpatched build; the variants after "8 tiles a block" are candidate
changes rather than removals.  Prints the card's name and power limit
first.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "cell_image_analysis_tpu_torch", "csrc", "cc_tile_labels.cu")
OUT = os.path.join(REPO, "build", "cc_ablate")
VARIANTS = {
    "as built": [],
    "no unions in the tile": [("if (lane > 0 && R) {", "if (false) {")],
    "no flatten": [("for (int k = 0; k < n_runs; ++k) t.l[me + k] = find_local(t.l, me + k);",
                    "")],
    "tile passes build only": [("    body(a, build_tile(mask, a, h, w, conn, v, t));",
                                "    build_tile(mask, a, h, w, conn, v, t);")],
    "mask bits unused (all background)": [("quarters[idx] = (uint16_t)bits;",
                                           "quarters[idx] = 0;")],
    "byte-wise mask loads": [("const int vec = w % 16 == 0", "const int vec = 0 && w % 16 == 0")],
    "2 tiles a block": [("constexpr int TILES = 4,", "constexpr int TILES = 2,")],
    "8 tiles a block": [("constexpr int TILES = 4,", "constexpr int TILES = 8,")],
    # candidate changes
    "streaming mask loads": [("    v[k] = __ldg(", "    v[k] = __ldcs(")],
    "label rows unrolled by 4": [("    for (int k = 0; k < TH / 2; ++k) {",
                                  "#pragma unroll 4\n    for (int k = 0; k < TH / 2; ++k) {")],
    "pointer-jumping flatten": [(
        "for (int k = 0; k < n_runs; ++k) t.l[me + k] = find_local(t.l, me + k);",
        "for (bool moved = true; __any_sync(0xffffffffu, moved);) {\n"
        "    moved = false;\n"
        "    for (int k = 0; k < n_runs; ++k) {\n"
        "      const int up = t.l[me + k], top = t.l[up];\n"
        "      if (up != top) { t.l[me + k] = top; moved = true; }\n"
        "    }\n"
        "    __syncwarp();\n"
        "  }")],
    "12 blocks an SM": [("__global__ void __launch_bounds__(THREADS) cc_tile_local(",
                         "__global__ void __launch_bounds__(THREADS, 12) cc_tile_local("),
                        ("__global__ void __launch_bounds__(THREADS) cc_tile_write(",
                         "__global__ void __launch_bounds__(THREADS, 12) cc_tile_write(")],
}


def _module(name: str, path: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build_variants(nvcc: str, flags: list) -> dict:
    """{variant: path of its shared library}, compiled in parallel."""
    with open(SRC) as f:
        text = f.read()
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for i, (name, patches) in enumerate(VARIANTS.items()):
        src = text
        for old, new in patches:
            if src.count(old) != 1:
                raise RuntimeError(f"variant {name!r}: patch anchor not found once: {old!r}")
            src = src.replace(old, new)
        cu, so = os.path.join(OUT, f"v{i}.cu"), os.path.join(OUT, f"v{i}.so")
        with open(cu, "w") as f:
            f.write(src)
        procs[name] = (so, subprocess.Popen([nvcc, *flags, "-shared", "-o", so, cu],
                                            stderr=subprocess.PIPE, text=True))
    for name, (so, proc) in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"variant {name!r}: nvcc failed\n{proc.stderr.read()}")
    return {name: so for name, (so, _) in procs.items()}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames-npy", help="reuse the frames saved at this path (made and saved "
                                         "there when it does not exist)")
    args = ap.parse_args()
    sys.path.insert(0, REPO)

    import torch

    if not torch.cuda.is_available():
        print("cc_ablate: needs a CUDA device", file=sys.stderr)
        return 1
    smoke = _module("_ablate_smoke", os.path.join(REPO, "chip_smoke.py"))
    split = _module("_ablate_split", os.path.join(REPO, "scripts", "cc_split.py"))
    from cell_image_analysis_tpu_torch.models.segmentation import threshold_mask
    from cell_image_analysis_tpu_torch.ops.cc import label_components_plain
    from cell_image_analysis_tpu_torch.ops.cuda import _build
    from cell_image_analysis_tpu_torch.ops.cuda.cc import label_components_cuda
    from cell_image_analysis_tpu_torch.utils.synthetic import make_frame

    print(smoke.smi_line(), flush=True)
    libs = build_variants(_build._nvcc(), _build.NVCC_FLAGS)
    dev = torch.device("cuda", 0)
    if args.frames_npy and os.path.exists(args.frames_npy):
        frames = np.load(args.frames_npy)
    else:
        rng = np.random.default_rng(7)
        frames = np.stack([make_frame(rng, size=1024, n_cells=80) for _ in range(16)])
        if args.frames_npy:
            np.save(args.frames_npy, frames)
    masks = threshold_mask(torch.tensor(frames[..., 2].astype(np.float32), device=dev))
    ref = label_components_plain(masks, 1)
    for name, so in libs.items():
        lib = ctypes.CDLL(so)
        for fn, argtypes in _build._SIGNATURES.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        _build._LIB = lib          # label_components_cuda launches through this library
        if name == "as built":
            got = label_components_cuda(masks, 1)
            if not (torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])):
                raise AssertionError("the unpatched build differs from the plain version")
        ms = split.kernel_ms(torch, lambda: label_components_cuda(masks, 1))
        total = sum(ms.values())
        parts = ", ".join(f"{k.split('::')[-1].split('(')[0]} {v:.4f}"
                          for k, v in sorted(ms.items(), key=lambda kv: -kv[1]))
        print(f"{name}: device {total:.4f} ms ({parts})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
