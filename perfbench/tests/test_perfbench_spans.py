"""The readers of the program's spans (``metrics/spans.py``) on hand-built
event lists with hand-computed answers, and in traced runs of the tiny CPU
tree, where the device readers find nothing and return None."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from perfbench import core
from perfbench.metrics import spans as sp
from perfbench.run import _reader, execute
from tinybench import CELLS, job, tiny_tree

MARKER = "perfbench.window"
NEW = {"slotformer_clevrer.train": ["image_loss_ms.train"],
       "stosavi_clevrer.train": ["k1_backward_ms.train"],
       "slotformer_clevrer.rollout": ["rollouter_ms.rollout",
                                      "rollouter_idle.rollout"],
       "stosavi_clevrer.extract": ["frame_step_ms.extract",
                                   "host_prep_ms.extract"]}


class Event:
    def __init__(self, name, start, end, cuda=False, corr=0, note=False):
        self._name, self._start, self._dur = name, start, end - start
        self._dev = DeviceType.CUDA if cuda else DeviceType.CPU
        self._corr, self._note = corr, note

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._dur

    def device_type(self):
        return self._dev

    def correlation_id(self):
        return self._corr

    def is_user_annotation(self):
        return self._note


def host(name, s, e):
    return Event(name, s, e, note=True)


def launch(s, corr):
    return Event("cudaLaunchKernel", s, s + 20, corr=corr)


def kernel(s, e, corr, name="k"):
    return Event(name, s, e, cuda=True, corr=corr)


def mirror(name, s, e, note=True, corr=0):
    return Event(name, s, e, cuda=True, note=note, corr=corr)


def ctx_of(events, steps):
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: list(events))))
    return SimpleNamespace(window=SimpleNamespace(prof=prof), steps=steps,
                           trace=core.Trace(prof, MARKER))


# window [1000, 10000]; two rollouter calls launch three kernels; one
# kernel is launched between them; a frame step straddles the window's end;
# the spans' device mirrors (one flagged, one not, one with a launch's
# number) are no kernels
EVENTS = [
    host(MARKER, 1000, 10000),
    host("slotformer.rollouter", 1100, 3000), launch(1200, 11), launch(2500, 12),
    kernel(1500, 1800, 11), kernel(2600, 3200, 12),
    mirror("slotformer.rollouter", 1500, 3200, corr=11),
    launch(4000, 14), kernel(4100, 4300, 14),
    host("slotformer.rollouter", 5000, 7000), launch(5100, 13),
    kernel(5200, 5600, 13), mirror("slotformer.rollouter", 5200, 5600, note=False),
    host("savi.frame_step", 8000, 8500), launch(8100, 16), kernel(8200, 8400, 16),
    host("savi.frame_step", 9500, 10500), launch(9600, 15), kernel(9800, 10400, 15),
    host("extract.load", 500, 1100), host("extract.load", 6000, 6600),
    # an op shares a number with a launch: not a launch
    Event("aten::mm", 300, 400, corr=12),
]


def test_device_ranges_by_launch():
    ctx = ctx_of(EVENTS, steps=2)
    s = sp.spans(ctx)
    assert s.device("slotformer.rollouter") == [(1500, 3200), (5200, 5600)]
    assert s.device("savi.frame_step") == [(8200, 8400), (9800, 10000)]
    assert s.device("extract.load") == [] and s.device("k1.backward") == []
    assert sp.spans(ctx) is s  # reduced once a run
    # (1700 + 400) ns over 2 calls
    assert sp.device_ms_per_call(ctx, "slotformer.rollouter") == pytest.approx(1.05e-3)
    # busy 300 + 600 + 400 of 2100
    assert sp.device_idle(ctx, "slotformer.rollouter") == pytest.approx(
        100 * (1 - 1300 / 2100))
    assert sp.device_ms_mean(ctx, "savi.frame_step") == pytest.approx(2e-4)
    # host: [1000, 1100] clipped, [6000, 6600]; over 2 calls
    assert sp.host_ms_per_call(ctx, "extract.load") == pytest.approx(3.5e-4)


def test_nothing_linked_reads_none():
    """Without the calls that launched them, kernels belong to no span: the
    device readers find nothing, the host reader still reads."""
    events = [e for e in EVENTS if not e.name().startswith("cuda")]
    ctx = ctx_of(events, steps=2)
    assert sp.spans(ctx).device("slotformer.rollouter") == []
    assert sp.device_ms_mean(ctx, "savi.frame_step") is None
    assert sp.device_idle(ctx, "slotformer.rollouter") is None
    assert sp.host_ms_per_call(ctx, "extract.load") == pytest.approx(3.5e-4)


def test_trace_drops_the_mirrors_of_the_spans():
    """core.Trace counts the kernels and not the spans' device mirrors,
    flagged or not: the device's busy time is the kernels' alone."""
    ctx = ctx_of(EVENTS, steps=2)
    assert {n for _, _, n in ctx.trace.device} == {"k"}
    assert ctx.trace.busy_s == pytest.approx((300 + 600 + 200 + 400 + 200 + 200) * 1e-9)


def test_a_program_without_spans_reads_none():
    events = [e for e in EVENTS if not e.is_user_annotation()
              and e.name() not in sp.NAMES] + [host(MARKER, 1000, 10000)]
    ctx = ctx_of(events, steps=2)
    cell = core.Cell(core.load_spec(), "stosavi_clevrer.extract")
    for names in NEW.values():
        for name in names:
            assert _reader(cell, name).read(ctx) is None, name
    untraced = SimpleNamespace(trace=None, steps=3)
    assert sp.host_ms_per_call(untraced, "extract.load") is None


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return tiny_tree(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("name", CELLS)
def test_traced_cpu_run_reads_host_spans_only(tree, name):
    """On the CPU the host span of extraction is read; the device readers
    find no device and leave their metrics out."""
    j = job(*tree, name, trace=True)
    result, checks = execute(j.cell, j.seed, j.seconds, True, j.device,
                             j.process_start)
    assert result["correct"], checks
    printed = set(result["metrics"]) & set(NEW[name])
    assert printed == ({"host_prep_ms.extract"} if name.endswith("extract")
                       else set())
    if printed:
        assert result["metrics"]["host_prep_ms.extract"]["value"] > 0
