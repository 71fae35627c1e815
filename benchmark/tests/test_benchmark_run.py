"""A whole run of each configuration on the CPU at a test's size: the port
against the reference, and the check seeing each fault a cell can have."""

import numpy as np
import pytest
import torch

from benchmark import harness, program
from benchmark.tests.conftest import ROOT, tiny_cell

torch.set_num_threads(4)
CPU = torch.device("cpu")


@pytest.mark.parametrize("cell", ["stardist_fluo.f1024_b16", "threshold_p90.f1024_b16"])
@pytest.mark.parametrize("traced", [False, True])
def test_run_is_correct_on_the_cpu(cell, traced):
    c = tiny_cell(cell)
    line = harness.measure(c, 2 ** 31 + 99, 1.0, traced, CPU, ROOT, pool_workers=1)
    assert line["correct"], line["checks"]
    assert line["counts"]["cells_matched"] >= 10
    names = {m["name"] for m in (c.per_layer if traced else c.end_to_end)}
    got = set(line["metrics"])
    # the device's metrics are read from the card only
    assert got == names - {"peak_gib", "device_idle_pct", "mfu", "unet_conv3x3_roofline",
                           "percentile_roofline", "clahe_cells_roofline"}
    assert list(line)[-1] == "checks"


class _Broken(program.System):
    """The port with a fault where its answers are produced."""

    fault = None

    def wait(self, handle):
        scores, stats = super().wait(handle)
        if self.fault == "half":
            # half of the batch left out
            keep = stats["frame_index"] < handle["shape"][0] // 2
            return ({k: v[keep] if isinstance(v, np.ndarray) else v for k, v in scores.items()},
                    {k: v[keep] for k, v in stats.items()})
        if self.fault == "altered":
            scores = dict(scores, reconstruction_mse=scores["reconstruction_mse"] * 1.01)
        if self.fault == "nothing":
            return {}, {k: v[:0] for k, v in stats.items()}
        return scores, stats


@pytest.mark.parametrize("fault", ["half", "altered", "nothing"])
def test_a_fault_of_the_timed_path_is_not_correct(fault):
    c = tiny_cell("threshold_p90.f1024_b16")

    def factory(*args):
        s = _Broken(*args)
        s.fault = fault
        return s

    line = harness.measure(c, 123, 0.5, False, CPU, ROOT, pool_workers=1, system_factory=factory)
    assert not line["correct"], line["checks"]


def test_forbidden_modules_compares_whole_top_level_names():
    names = ["cell_image_analysis_tpu_torch", "cell_image_analysis_tpu_torch.ops",
             "jaxtyping", "flaxen.x", "numpy"]
    assert harness.forbidden_modules(names) == []
    bad = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "cell_image_analysis_tpu",
           "cell_image_analysis_tpu.ops.nms"]
    assert harness.forbidden_modules(names + bad) == sorted(bad)


class _Repacked(program.System):
    """The port with its handle's host copy laid out otherwise than the
    benchmark reads it, after the wait has used it."""

    change = None

    def wait(self, handle):
        out = super().wait(handle)
        B, ccap, _ = handle["shape"]
        n = B * ccap
        ints = handle["ints"]
        if self.change == "shifted":
            handle["ints"] = torch.roll(ints, n)
        elif self.change == "swapped":
            # heights and areas trade places
            parts = list(ints[B:B + 5 * n].split(n))
            parts[0], parts[4] = parts[4], parts[0]
            handle["ints"] = torch.cat([ints[:B], *parts, ints[B + 5 * n:]])
        elif self.change == "cut":
            handle["ints"] = ints[:B + 3 * n]
        return out


@pytest.mark.parametrize("change", ["shifted", "swapped", "cut"])
def test_clahe_sides_from_a_moved_handle_layout_raise(change):
    c = tiny_cell("threshold_p90.f1024_b16")
    from benchmark.traffic.frames import batch_draws, make_pool

    frames = make_pool(c.traffic, workers=1)
    segs = torch.as_tensor(frames[..., 2].astype(np.float32))
    greens = torch.as_tensor(frames[..., 1].astype(np.float32))
    system = _Repacked(c.config, c.workload, ROOT, CPU)
    loop = harness.Loop(system, segs, greens, batch_draws(7, c.traffic),
                        c.config["qc"]["crop_capacity"], spans=True)
    system.change = None
    b = loop.run(batches=1)[0]
    assert b["cells"] > 0 and len(b["heights"]) == b["cells"]
    system.change = change
    with pytest.raises(RuntimeError, match="clahe_cells_roofline cannot be read"):
        loop.run(batches=1)
