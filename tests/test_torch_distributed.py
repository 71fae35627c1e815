"""PyTorch port: the multi-process runtime (`parallel/distributed.py`) and
its launcher `scripts/dryrun_dist_torch.py`, in 2 gloo processes of 4
virtual CPU shards each (the counterpart of `scripts/dryrun_dcn.py`).

- The launcher's three checks pass (each worker holds its result against
  its own single-process run), and the result that every process holds is
  the same; it equals the port's single-process `score_frames_fused` in
  this process at `tests/test_torch_sharded_scoring.py`'s contract, and
  JAX's single-process `score_frames_fused` and `score_cells` counts, on
  the same seed-made inputs and the JAX store (read through each
  package's reader), at that file's JAX tolerances.
- A run-table flag that fires in one process's frames only re-runs every
  process through the exact twin, and nothing deadlocks.
- A worker killed mid-run fails the run within its timeout.
- Without a process group: rank 0 of 1; `process_local_rows` places
  process p's rows `[p*n/P, (p+1)*n/P)`; `initialize` takes only an
  explicit backend; a `GlobalMesh`'s data axis counts every process's
  shards.

Every spawn has a timeout of at most 120 s.
"""

import json
import os
import signal
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import torch_threads

from cell_image_analysis_tpu_torch.io.artifacts import (
    build_scoring_params,
    load_screening_artifacts,
)
from cell_image_analysis_tpu_torch.models.segmentation import ThresholdBackend
from cell_image_analysis_tpu_torch.parallel import distributed
from cell_image_analysis_tpu_torch.parallel.mesh import virtual_mesh
from cell_image_analysis_tpu_torch.pipeline.scoring import score_frames_fused
from cell_image_analysis_tpu_torch.utils.parity import compare_screens

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(_REPO, "scripts"))
import dryrun_dist_torch as dryrun  # noqa: E402

torch_threads()

TIMEOUT = 120


@pytest.fixture(scope="module")
def dryrun_out(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dryrun"))
    assert dryrun.main(["--out", out, "--device", "cpu", "--timeout", str(TIMEOUT)]) == 0
    return out


@pytest.fixture(scope="module")
def port_scoring():
    return build_scoring_params(*load_screening_artifacts(dryrun.STORE), device="cpu")


@pytest.fixture(scope="module")
def jax_scoring_store():
    from cell_image_analysis_tpu.io import artifacts as jax_artifacts

    loaded = jax_artifacts.load_screening_artifacts(dryrun.STORE)
    return loaded[0], jax_artifacts.build_scoring_params(*loaded)


def _results(out):
    out_files = [os.path.join(out, f"rank{r}.json") for r in range(2)]
    results = []
    for path in out_files:
        with open(path) as f:
            results.append(json.load(f))
    return results


def _ranks(out):
    return _results(out), [dryrun.read_result(os.path.join(out, f"rank{r}.npz"))
                           for r in range(2)]


def test_every_process_holds_the_same_result(dryrun_out):
    results, fused = _ranks(dryrun_out)
    assert [r["rank"] for r in results] == [0, 1]
    assert all(r["world"] == 2 and r["global_shards"] == 8 for r in results)
    for check in ("counts", "score_cells"):
        assert results[0][check] == results[1][check]
    for key in ("cells", "counts"):
        assert results[0]["fused"][key] == results[1]["fused"][key]
    (a, sa), (b, sb) = fused
    assert a.keys() == b.keys() and sa.keys() == sb.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for k in sa:
        np.testing.assert_array_equal(sa[k], sb[k], err_msg=k)


def test_masked_counts_equal_the_whole_batch(dryrun_out):
    results, _ = _ranks(dryrun_out)
    rng = np.random.default_rng(7)
    scores = rng.normal(size=(dryrun.N_ROWS,)).astype(np.float32)
    valid = rng.uniform(size=(dryrun.N_ROWS,)) > 0.25
    flags = (scores > 0.5) & valid
    assert results[0]["counts"] == dict(anomalies=int(flags.sum()), valid=int(valid.sum()),
                                        rate=int(flags.sum()) / int(valid.sum()))


def test_fused_over_processes_equals_one_process(dryrun_out, port_scoring):
    model, params = port_scoring
    segs, greens = dryrun.dryrun_frames()
    twin = ThresholdBackend().exact_twin()
    ref = score_frames_fused(model, params, torch.from_numpy(segs), torch.from_numpy(greens),
                             ThresholdBackend(), fallback_segment_fn=twin, **dryrun.FUSED_KW)
    got = _ranks(dryrun_out)[1][0]
    assert len(ref[1]["area"]) >= 10 and ref[1]["frame_index"].max() == dryrun.N_FRAMES - 1
    dryrun.assert_sharded_equal(ref, got, "two processes against one")


def test_fused_over_processes_matches_jax(dryrun_out, port_scoring, jax_scoring_store):
    from cell_image_analysis_tpu.models.segmentation import threshold_segment
    from cell_image_analysis_tpu.pipeline.scoring import score_frames_fused as jax_fused
    from cell_image_analysis_tpu.utils.bench import _threshold_mask_fn

    jmodel, jparams = jax_scoring_store
    segs, greens = dryrun.dryrun_frames()
    ref = jax_fused(jmodel, jparams, jnp.asarray(segs), jnp.asarray(greens), _threshold_mask_fn,
                    fallback_segment_fn=threshold_segment, **dryrun.FUSED_KW)
    got = _ranks(dryrun_out)[1][0]
    report = compare_screens(ref, got, {}, float(port_scoring[1].ensemble_mse_threshold))
    assert report["n_cells"] >= 10
    for k in ("conservative", "moderate", "ensemble", "fft"):
        if not report["near_threshold"][k]:
            assert got[0][f"{k}_anomaly_rate"] == ref[0][f"{k}_anomaly_rate"], k
    np.testing.assert_allclose(np.sort(got[0]["reconstruction_mse"]),
                               np.sort(np.asarray(ref[0]["reconstruction_mse"])), atol=1e-4)


def test_score_cells_counts_over_processes_match_jax(dryrun_out, port_scoring,
                                                   jax_scoring_store):
    from cell_image_analysis_tpu.pipeline.scoring import score_cells as jax_score_cells

    results, _ = _ranks(dryrun_out)
    cells = dryrun.dryrun_cells()
    model, params = port_scoring
    one = dryrun.cell_counts(model, params, torch.from_numpy(cells))
    assert list(one) == results[0]["score_cells"]["counts"] == results[1]["score_cells"]["counts"]
    jmodel, jparams = jax_scoring_store
    s = jax_score_cells(jmodel, jparams, jnp.asarray(cells))
    want = [int(np.sum(np.asarray(p) == -1)) for p in (
        s.conservative_predictions, s.moderate_predictions, s.ensemble_predictions,
        s.fft_predictions)]
    assert list(one) == want
    assert 0 < min(want) and max(want[:3]) < dryrun.N_ROWS    # not saturated


def test_overflow_in_one_process_reruns_every_process(tmp_path):
    out = str(tmp_path)
    assert dryrun.main(["--out", out, "--device", "cpu", "--checks", "overflow",
                        "--timeout", str(TIMEOUT)]) == 0
    results = _results(out)
    assert [r["overflow"]["flag_here"] for r in results] == [False, True]
    assert all(r["overflow"]["twin_calls"] == 4 for r in results)   # one a local shard


def test_a_killed_worker_fails_the_run_within_its_timeout(tmp_path):
    def kill_second(procs, logs):
        deadline = time.monotonic() + TIMEOUT
        while time.monotonic() < deadline and procs[1].poll() is None:
            with open(logs[1]) as f:
                if "initialized" in f.read():
                    break
            time.sleep(0.05)
        os.kill(procs[1].pid, signal.SIGKILL)

    port = dryrun.free_port()
    argvs = [[sys.executable, dryrun.__file__, "--out", str(tmp_path), "--device", "cpu",
              "--worker", str(r), "--port", str(port), "--timeout", str(TIMEOUT)]
             for r in range(2)]
    t0 = time.monotonic()
    rcs = dryrun.run_workers(argvs, TIMEOUT, str(tmp_path), on_start=kill_second)
    assert time.monotonic() - t0 < TIMEOUT
    assert rcs[1] == -signal.SIGKILL
    assert rcs[0] != 0          # failed on its own or was stopped (None)
    assert not os.path.exists(tmp_path / "rank0.json")


def test_without_a_process_group():
    assert distributed.process_index() == 0 and distributed.process_count() == 1
    distributed.shutdown()      # a no-op
    with pytest.raises(ValueError, match="backend"):
        distributed.initialize(0, 1, "tcp://localhost:1", "mpi")
    with pytest.raises(ValueError, match="rank"):
        distributed.initialize(2, 2, "tcp://localhost:1", "gloo")


def test_process_local_rows_and_the_global_shape():
    x = np.arange(12)
    meshes = [distributed.GlobalMesh(virtual_mesh("cpu", 2), p, 3) for p in range(3)]
    assert [distributed.process_local_rows(x, m).tolist() for m in meshes] == [
        [0, 1, 2, 3], [4, 5, 6, 7], [8, 9, 10, 11]]
    assert meshes[0].shape == {"data": 6}
    with pytest.raises(ValueError, match="pad"):
        distributed.process_local_rows(np.arange(10), meshes[0])
