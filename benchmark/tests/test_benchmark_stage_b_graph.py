"""`stage_b_graph_pct` on made-up counters: the share of stage B's chunks
replayed as a CUDA graph, and nothing where there is nothing to read."""

from types import SimpleNamespace

import pytest

from benchmark import harness


def _read(counters):
    return harness.metric_reader("stage_b_graph_pct")(SimpleNamespace(counters=counters))


def test_reads_the_replayed_share_of_the_chunks():
    assert _read({"chunks": 2740, "stage_b.graph_chunks": 2740}) == pytest.approx(100.0)
    assert _read({"chunks": 40, "stage_b.graph_chunks": 10, "stage_b.eager_chunks": 30,
                  "cells.scored": 900}) == pytest.approx(25.0)
    # every chunk eager, as on the CPU
    assert _read({"chunks": 40, "stage_b.eager_chunks": 40}) == 0.0


@pytest.mark.parametrize("counters", [None, {}, {"cells.scored": 5},
                                      # the parent: chunks, and no replay counted
                                      {"chunks": 2740, "cells.scored": 900}])
def test_reads_nothing_without_chunks_or_replays(counters):
    assert _read(counters) is None
