"""The reader of ``rollouter_graph_share.rollout`` on hand-built event lists
with hand-computed answers, and in a traced run of the tiny CPU rollout,
where the rollouter runs eagerly and the metric is left out."""

from __future__ import annotations

import pytest

from perfbench import core
from perfbench.run import _reader, execute
from test_perfbench_spans import MARKER, ctx_of, host, mirror
from tinybench import job, tiny_tree

CELL, METRIC = "slotformer_clevrer.rollout", "rollouter_graph_share.rollout"
GRAPH = "slotformer.rollouter.graph"


@pytest.mark.parametrize("replayed,want", [((0, 1), 100.0), ((1,), 50.0),
                                           ((), None)])
def test_rollouter_graph_share(replayed, want):
    """The share of the window's rollouter calls that hold a replay of the
    graph; the call straddling the window's start counts, the one after its
    end does not. Without the replay span (an older program) it reads
    None."""
    calls = [(900, 1500), (5000, 7000), (10500, 11000)]
    events = [host(MARKER, 1000, 10000)]
    for i, (s, e) in enumerate(calls):
        events.append(host("slotformer.rollouter", s, e))
        if i in replayed:
            events += [host(GRAPH, s + 50, e - 50), mirror(GRAPH, s + 60, e)]
    if replayed:  # a replay inside the call after the window's end
        events.append(host(GRAPH, 10600, 10900))
    cell = core.Cell(core.load_spec(), CELL)
    got = _reader(cell, METRIC).read(ctx_of(events, 2))
    assert got == (None if want is None else pytest.approx(want))


def test_traced_cpu_rollout_leaves_the_share_out(tmp_path):
    """On the CPU the rollouter takes its eager loop: no replay span, so the
    share is left out of the line and the run stays correct."""
    j = job(*tiny_tree(tmp_path), CELL, trace=True)
    result, checks = execute(j.cell, j.seed, j.seconds, True, j.device,
                             j.process_start)
    assert result["correct"], checks
    assert METRIC not in result["metrics"]
