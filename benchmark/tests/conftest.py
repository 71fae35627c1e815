import copy
import os

import pytest
import torch

from benchmark import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def tiny_cell(name: str, size: int = 256, cells: int = 20, pool: int = 4, batch: int = 2):
    """The cell `name` cut to a CPU test's size: `pool` frames of size^2
    with `cells` cells, `batch` a batch, K 64 for StarDist."""
    c = harness.load_cell(ROOT, name)
    c.traffic = dict(c.traffic, size=size, cells_per_frame=cells, pool_frames=pool,
                     frame_batch=batch)
    c.workload = copy.deepcopy(c.workload)
    c.workload.update(warmup_batches=1, trace_batches=2)
    if "max_candidates" in c.workload["segmentation"]:
        c.workload["segmentation"].update(max_candidates=64)
    return c


@pytest.fixture
def cuda_device():
    """The card; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda:0")
