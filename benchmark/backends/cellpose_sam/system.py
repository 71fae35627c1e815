"""The port's Cellpose backend with Cellpose-SAM's ViT over the `cellpose`
weight file."""

from __future__ import annotations

import dataclasses


def build(seg: dict, weights: dict, device):
    # first: a program without the ViT stops here, before any weight is read
    from cell_image_analysis_tpu_torch.models import vit_sam

    from cell_image_analysis_tpu_torch.config import CellposeConfig
    from cell_image_analysis_tpu_torch.io.artifacts import load_cellpose_weights
    from cell_image_analysis_tpu_torch.models.segmentation import CellposeBackend

    arrays = load_cellpose_weights(weights["cellpose"])
    # the network's widths come from its weights; the configuration states them
    got = vit_sam.widths_of(arrays)
    want = {k: seg["vit"][k] for k in got if k != "rows"}
    if {k: got[k] for k in want} != want or list(got["rows"]) != list(seg["vit"]["rows"]):
        raise SystemExit(f"cellpose_sam: the configuration's widths {seg['vit']} are not the "
                         f"weights' {got}")
    fields = {f.name for f in dataclasses.fields(CellposeConfig)}
    cfg = CellposeConfig(**{k: v for k, v in seg.items() if k in fields})
    return CellposeBackend(arrays, cfg, device=device)
