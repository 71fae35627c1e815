"""On the card: the control, the reference computed with TF32 on, put in
the program's place, fails the check at a test's size, and the program
passes it.  Skips without a GPU; `benchmark/control.py` takes the same
readings at each cell's own size."""

import numpy as np
import pytest

from benchmark import check, harness, program
from benchmark.reference.screen import Reference
from benchmark.tests.conftest import ROOT, tiny_cell
from benchmark.traffic.frames import batch_draws, make_pool


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["stardist_fluo.f1024_b16", "threshold_p90.f1024_b16"])
def test_control_fails_and_program_passes(cell, cuda_device):
    import torch

    c = tiny_cell(cell, size=1024, cells=80, pool=2, batch=2)
    c.workload["segmentation"].pop("max_candidates", None)
    c.workload = dict(c.workload, segmentation=dict(
        harness.load_cell(ROOT, cell).workload["segmentation"]))
    system = program.System(c.config, c.workload, ROOT, cuda_device)
    ref = Reference(c.config, c.workload, ROOT, cuda_device)
    pool = make_pool(c.traffic, workers=1)
    segs = torch.as_tensor(pool[..., 2].astype(np.float32)).to(cuda_device)
    greens = torch.as_tensor(pool[..., 1].astype(np.float32)).to(cuda_device)
    b = harness.Loop(system, segs, greens, batch_draws(21, c.traffic),
                     c.config["qc"]["crop_capacity"]).run(batches=1)[0]
    want = ref.screen(pool[b["frames"]])
    ok, checks = check.verdict(check.compare([(b["result"], want)]), c.workload["limits"])
    assert ok, checks
    control = ref.screen(pool[b["frames"]], use_tf32=True)
    ok, checks = check.verdict(check.compare([(control, want)]), c.workload["limits"])
    assert not ok, checks
