"""The port's Cellpose backend: cyto3's CPnet over the `cellpose` weight file."""

from __future__ import annotations

import dataclasses


def build(seg: dict, weights: dict, device):
    from cell_image_analysis_tpu_torch.config import CellposeConfig
    from cell_image_analysis_tpu_torch.io.artifacts import load_cellpose_weights
    from cell_image_analysis_tpu_torch.models.cellpose import nbase_of
    from cell_image_analysis_tpu_torch.models.segmentation import CellposeBackend

    arrays = load_cellpose_weights(weights["cellpose"])
    # the network's widths come from its weights; the configuration states them
    if tuple(seg["nbase"]) != tuple(nbase_of(arrays)):
        raise SystemExit(f"cellpose: the configuration's nbase {seg['nbase']} is not the "
                         f"weights' {nbase_of(arrays)}")
    fields = {f.name for f in dataclasses.fields(CellposeConfig)}
    cfg = CellposeConfig(**{k: v for k, v in seg.items() if k in fields})
    return CellposeBackend(arrays, cfg, device=device)
