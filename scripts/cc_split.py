#!/usr/bin/env python3
"""Where `label_components` spends its time on one GPU, kernel by kernel.

    python3 scripts/cc_split.py [--src DIR] [--frames-npy PATH]

Labels the threshold masks of the bench's 16 synthetic 1024^2 frames
(seed 7, 80 cells each; `threshold_mask` at its defaults, the masks of
`chip_smoke.py` phase 2) at connectivity 1 and 2 with the
`label_components` of the package under test, checks labels and counts
against `scipy.ndimage.label` on the host, and prints:

- the device time of one call in each kernel it launches, by kernel name
  (torch.profiler over 20 calls after a warm-up, divided by 20), and
  their sum;
- the call itself, CUDA events around it (median of 21 after a warm-up);
- for a package whose CC kernel writes raw min-index labels and leaves
  the compaction to 1..K to eager torch (`ops.cuda.cc.cc_min_labels_cuda`,
  up to 8e675ca): the raw-label wrapper call, its bool -> uint8 copy and
  the compaction alone, each the same two ways.  The compaction is
  `label_components`' own code at 8e675ca, copied here.

`--src DIR` times the `cell_image_analysis_tpu_torch` of another checkout
(an earlier commit unpacked with `git archive`), so that two versions run
on one card in one call.  `--frames-npy PATH` keeps the frames between
runs.  Needs a CUDA device; prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke():
    """This checkout's chip_smoke.py (timing helpers), loaded by path."""
    spec = importlib.util.spec_from_file_location("_cc_split_smoke",
                                                  os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kernel_ms(torch, fn, n: int = 20) -> dict:
    """Device ms of one call of `fn()` in each kernel it launches, by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.device_time_total / 1e3 / n for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.device_time_total > 0}


def compact_8e675ca(torch, raw):
    """`ops/cc.label_components` after its `cc_min_labels` call, at 8e675ca."""
    B, h, w = raw.shape
    raw = raw.reshape(B, -1)
    own = torch.arange(1, h * w + 1, dtype=torch.int32, device=raw.device)
    prefix = torch.cumsum(raw == own, dim=1).int()
    compact = torch.gather(prefix, 1, torch.clamp(raw - 1, min=0).long())
    return torch.where(raw > 0, compact, 0).reshape(B, h, w), prefix[:, -1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=REPO,
                    help="checkout whose cell_image_analysis_tpu_torch is timed")
    ap.add_argument("--frames-npy", help="reuse the frames saved at this path (made and saved "
                                         "there when it does not exist)")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))

    import torch
    from scipy import ndimage as ndi

    if not torch.cuda.is_available():
        print("cc_split: needs a CUDA device", file=sys.stderr)
        return 1
    smoke = _smoke()
    import cell_image_analysis_tpu_torch as pkg
    from cell_image_analysis_tpu_torch.models.segmentation import threshold_mask
    from cell_image_analysis_tpu_torch.ops import cc
    from cell_image_analysis_tpu_torch.ops.cuda import cc as cc_cuda
    from cell_image_analysis_tpu_torch.utils.synthetic import make_frame

    print(smoke.smi_line(), flush=True)
    print(f"package: {os.path.dirname(pkg.__file__)}", flush=True)
    dev = torch.device("cuda", 0)
    if args.frames_npy and os.path.exists(args.frames_npy):
        frames = np.load(args.frames_npy)
    else:
        rng = np.random.default_rng(7)
        frames = np.stack([make_frame(rng, size=1024, n_cells=80) for _ in range(16)])
        if args.frames_npy:
            np.save(args.frames_npy, frames)
    masks = threshold_mask(torch.tensor(frames[..., 2].astype(np.float32), device=dev))
    host = masks.cpu().numpy()
    raw_route = hasattr(cc_cuda, "cc_min_labels_cuda")

    def show(what, split, call):
        for name, ms in sorted(split.items(), key=lambda kv: -kv[1]):
            print(f"  {what}: {ms:.4f} ms  {name[:90]}")
        print(f"  {what}: device {sum(split.values()):.4f} ms in {len(split)} kernel(s), "
              f"call {call:.4f} ms (events)", flush=True)

    for conn in (1, 2):
        labels, count = cc.label_components(masks, conn)
        torch.cuda.synchronize()
        structure = None if conn == 1 else np.ones((3, 3), bool)
        for b in range(host.shape[0]):
            ref, n = ndi.label(host[b], structure=structure)
            if int(count[b]) != n or not np.array_equal(labels[b].cpu().numpy(), ref):
                raise AssertionError(f"connectivity {conn}, frame {b}: differs from scipy")
        print(f"connectivity {conn}: {tuple(masks.shape)} masks, "
              f"{float(masks.float().mean()):.4f} foreground, {int(count.sum())} components; "
              f"equal to scipy.ndimage.label", flush=True)
        fn = lambda: cc.label_components(masks, conn)   # noqa: E731
        show("label_components", kernel_ms(torch, fn), smoke.time_ms(fn, n=21))
        if raw_route:
            fn = lambda: cc_cuda.cc_min_labels_cuda(masks, conn)   # noqa: E731
            show("raw-label wrapper", kernel_ms(torch, fn), smoke.time_ms(fn, n=21))
            fn = lambda: masks.to(torch.uint8)   # noqa: E731
            show("bool -> uint8 copy", kernel_ms(torch, fn), smoke.time_ms(fn, n=21))
            raw = cc_cuda.cc_min_labels_cuda(masks, conn)
            fn = lambda: compact_8e675ca(torch, raw)   # noqa: E731
            show("compaction", kernel_ms(torch, fn), smoke.time_ms(fn, n=21))
    return 0


if __name__ == "__main__":
    sys.exit(main())
