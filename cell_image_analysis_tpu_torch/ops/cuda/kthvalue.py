"""Launcher of `csrc/kthvalue_radix.cu` (see its header for the design)."""

from __future__ import annotations

import ctypes

import torch

from cell_image_analysis_tpu_torch.ops.cuda._build import check, library, stream_ptr

LAUNCHES = 0  # calls of the C entry point since the last reset (read by chip_smoke.py)
KERNELS_PER_CALL = 4  # kernels one call launches: kthvalue_radix_init and three passes
MAX_COLUMNS = 8  # output columns one call selects: the source's MAX_RANKS
BLOCKS_PER_SM = 4  # a pass's resident blocks on one SM (its launch bounds)
MIN_BLOCK_ELEMENTS = 16384  # a block's least share of a frame


def blocks_per_frame(frames: int, n: int, sms: int) -> int:
    """Blocks that share each frame of n elements: one wave of
    BLOCKS_PER_SM blocks on each of `sms` SMs over the whole batch, but no
    block with fewer than MIN_BLOCK_ELEMENTS elements, and at least one."""
    return max(1, min(sms * BLOCKS_PER_SM // frames, -(-n // MIN_BLOCK_ELEMENTS)))


def kth_smallest_cuda(flat: torch.Tensor, ks: tuple) -> torch.Tensor:
    """flat (B, N) float32 on a CUDA device, ranks `ks` in [0, N) ->
    (B, len(ks)) float32: column j holds the ks[j]-th smallest element of
    each row, bit for bit, without a host synchronisation."""
    global LAUNCHES
    if not flat.is_cuda:
        raise ValueError("kth_smallest_cuda: a CUDA tensor only")
    if flat.dtype != torch.float32 or flat.dim() != 2:
        raise TypeError(f"kth_smallest_cuda: (B, N) float32 only, got {flat.dtype} "
                        f"{tuple(flat.shape)}")
    B, n = flat.shape
    if not 0 < n < 2 ** 31 or B > 65535:
        raise ValueError(f"kth_smallest_cuda: (B, N) = {(B, n)} outside B <= 65535, "
                         f"0 < N < 2^31")
    if not all(0 <= k < n for k in ks):
        raise ValueError(f"kth_smallest_cuda: ranks {ks} outside [0, {n})")
    flat = flat.contiguous()
    out = torch.empty((B, len(ks)), dtype=torch.float32, device=flat.device)
    if B == 0 or not ks:
        return out
    sms = torch.cuda.get_device_properties(flat.device).multi_processor_count
    grid = blocks_per_frame(B, n, sms)
    lib = library()
    with torch.cuda.device(flat.device):
        for c0 in range(0, len(ks), MAX_COLUMNS):
            cols = ks[c0:c0 + MAX_COLUMNS]
            distinct = list(dict.fromkeys(cols))
            ranks = (ctypes.c_longlong * len(distinct))(*distinct)
            col_rank = (ctypes.c_int * len(cols))(*(distinct.index(k) for k in cols))
            scratch = torch.empty(lib.cia_kthvalue_radix_scratch_words(B, len(distinct)),
                                  dtype=torch.int32, device=flat.device)
            err = lib.cia_kthvalue_radix(
                flat.data_ptr(), n, B, grid, ranks, len(distinct), col_rank, len(cols),
                out.data_ptr() + 4 * c0, len(ks), scratch.data_ptr(), stream_ptr(flat.device))
            check(err, "kthvalue_radix")
            LAUNCHES += 1
    return out
