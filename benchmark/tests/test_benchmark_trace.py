"""The trace reduction on a made-up session."""

import pytest

from benchmark import trace


def test_reduce_unions_clips_and_names_gaps():
    events = {
        "device": [("k1", 0.0, 30.0), ("k2", 20.0, 40.0), ("k1", 60.0, 80.0), ("k3", 95.0, 130.0)],
        "host": [(trace.WINDOW_SPAN, 10.0, 110.0), ("bench.wait", 40.0, 61.0),
                 ("aten::nonzero", 45.0, 50.0), ("bench.start", 80.0, 100.0)],
    }
    r = trace.reduce(events)
    assert r["window_s"] == pytest.approx(100e-6)
    # busy: [10, 40] + [60, 80] + [95, 110]
    assert r["busy_s"] == pytest.approx(65e-6)
    assert dict(r["device_ops"])["k1"] == pytest.approx(40e-6)
    gaps = dict(r["idle_gaps"])
    assert gaps["bench.wait / aten::nonzero"] == pytest.approx(20e-6)
    assert gaps["bench.start"] == pytest.approx(15e-6)
    assert trace.kernel_seconds(r["by_name"], ("k1", "k3")) == pytest.approx(55e-6)


def test_reduce_without_window_or_device_is_none():
    assert trace.reduce({"device": [("k", 0.0, 1.0)], "host": []}) is None
    assert trace.reduce({"device": [], "host": [(trace.WINDOW_SPAN, 0.0, 1.0)]}) is None
