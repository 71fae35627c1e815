"""Host-side ingest: threaded TIFF decode with bounded prefetch.

Counterpart of `cell_image_analysis_tpu/io/ingest.py`.  TIFF decode is
host-bound, so workers decode frames ahead of the device loop and a bounded
queue holds them.  One bad file does not end a run: it is skipped and
listed in `FrameStream.errors`.  The workers are plain numpy: no tensor is
made off the main thread.  `decode_seconds` sums the readers' time over
all workers.  `frames_to_device` stacks same-shape channels into one
device tensor.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field
from glob import glob
from typing import Callable, Iterator

import numpy as np

from cell_image_analysis_tpu_torch.io.tiff import imread


def frames_to_device(channels: list, device):
    """Same-shape host channels -> one (B, H, W) float32 tensor on `device`.
    For the card they are cast into pinned memory and copied without
    waiting, so the copy does not hold up a batch in flight."""
    import torch

    pinned = torch.device(device).type == "cuda"
    host = torch.empty((len(channels), *channels[0].shape), dtype=torch.float32,
                       pin_memory=pinned)
    buf = host.numpy()
    for i, c in enumerate(channels):
        buf[i] = c
    return host.to(device, non_blocking=True) if pinned else host


def list_tiffs(folder: str) -> list[str]:
    """Sorted *.tif glob: the folder contract."""
    return sorted(glob(os.path.join(folder, "*.tif")))


def split_channels(image: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Channel 2 -> segmentation, channel 1 -> analysis when there are >= 3
    channels; the single image otherwise."""
    if image.ndim == 3 and image.shape[-1] >= 3:
        return image[..., 2], image[..., 1]
    return image, image

@dataclass
class FrameStream:
    """Iterates (path, seg_channel, green_channel) with prefetch workers."""

    paths: list[str]
    n_workers: int = 2
    prefetch: int = 4
    reader: Callable[[str], np.ndarray] = imread
    errors: list = field(default_factory=list)
    decode_seconds: float = 0.0

    def __iter__(self) -> Iterator[tuple[str, np.ndarray, np.ndarray]]:
        if not self.paths:
            return
        n = len(self.paths)
        budget = threading.Semaphore(max(1, self.prefetch))  # bounds decoded-ahead frames
        idx_lock = threading.Lock()
        next_idx = [0]
        results: dict[int, object] = {}
        res_ready = threading.Condition()

        def worker():
            while True:
                budget.acquire()
                with idx_lock:
                    i = next_idx[0]
                    if i >= n:
                        budget.release()
                        return
                    next_idx[0] += 1
                path = self.paths[i]
                t0 = time.perf_counter()
                try:
                    img = self.reader(path)
                    item = (path, *split_channels(img))
                except Exception as e:  # skip-and-log per frame
                    self.errors.append((path, repr(e)))
                    item = None
                with res_ready:
                    self.decode_seconds += time.perf_counter() - t0
                    results[i] = item
                    res_ready.notify_all()

        threads = [threading.Thread(target=worker, daemon=True) for _ in range(max(1, self.n_workers))]
        for t in threads:
            t.start()
        try:
            for i in range(n):
                with res_ready:
                    while i not in results:
                        res_ready.wait()
                    item = results.pop(i)
                budget.release()  # consumer freed a slot
                if item is not None:
                    yield item
        finally:
            for t in threads:
                t.join(timeout=0.1)
