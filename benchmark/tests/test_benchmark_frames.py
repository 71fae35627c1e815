"""The frozen frame generator against the port's, and the batch draws."""

import itertools

import numpy as np
import pytest

from benchmark.traffic import frames

TRAFFIC = dict(pool_seed=5, size=256, cells_per_frame=20, mutant_fraction=0.0, clustering=0.0,
               background=80.0, noise=10.0, cutoff=3.0, pool_frames=4, frame_batch=2)


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 7])
def test_frame_equals_make_frame_instances(seed):
    from cell_image_analysis_tpu_torch.utils.synthetic import make_frame_instances

    want, _ = make_frame_instances(frames.frame_rng(seed, 3), size=256, n_cells=20)
    got = frames.pool_frame(seed, 3, TRAFFIC)
    assert got.dtype == np.uint16 and np.array_equal(got, want)


def test_pool_in_workers_equals_in_process():
    a = frames.make_pool(TRAFFIC, workers=2)
    b = frames.make_pool(TRAFFIC, workers=1)
    assert a.shape == (4, 256, 256, 3) and np.array_equal(a, b)


def test_draws_are_seeded_distinct_and_never_repeat():
    t = dict(TRAFFIC, pool_frames=4, frame_batch=2)
    a = list(itertools.islice(frames.batch_draws(9, t), 50))
    b = list(itertools.islice(frames.batch_draws(9, t), 50))
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert all(len(set(x.tolist())) == 2 for x in a)
    assert not any(np.array_equal(x, y) for x, y in zip(a, a[1:]))
