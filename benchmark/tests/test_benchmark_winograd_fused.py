"""`winograd_fused_pct` on made-up counters: the share of the Winograd
kernel's launches with an activation fused beside the conv, and nothing
where there is nothing to read."""

from types import SimpleNamespace

import pytest

from benchmark import harness


def _read(counters):
    return harness.metric_reader("winograd_fused_pct")(SimpleNamespace(counters=counters))


@pytest.mark.parametrize("counters,want", [
    ({"winograd.launches": 1300, "winograd.fused": 1300}, 100.0),
    ({"winograd.launches": 64, "winograd.fused": 48, "cells.scored": 900}, 75.0),
    # launches, none fused
    ({"winograd.launches": 13}, 0.0)])
def test_reads_the_fused_share_of_the_launches(counters, want):
    assert _read(counters) == pytest.approx(want)


@pytest.mark.parametrize("counters", [None, {}, {"cells.scored": 5},
                                      # the parent: launches not counted
                                      {"chunks": 2740, "cells.scored": 900}])
def test_reads_nothing_without_launches(counters):
    assert _read(counters) is None
