"""The benchmark's own counts, pinned against hand counts at tiny sizes,
and the reduction of a trace to busy time, idle gaps and device ops."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from perfbench import core
from perfbench.kinds import extract, rollout
from perfbench.yardstick import k1_bound_s, k1_work
from tinybench import job, tiny_tree


def test_k1_work_by_hand():
    # B=1, N=2, D=4, S=1, H=4, one round: weights 16 + 96 + 32 + 4 + 36
    nbytes, flops = k1_work(1, 2, 4, 1, 4, 1)
    assert nbytes == 4 * (16 + 4 + 184 + 4 + 2)
    assert flops == 32 + 32 + 192 + 64
    peak = {"hbm_bytes_per_s": 840.0, "float32_flop_per_s": 640.0}
    assert k1_bound_s(dict(B=1, N=2, D=4, S=1, H=4, iters=1), peak) == (1.0, "bytes")


def test_k1_bound_at_clevrer_b64():
    peak = {"hbm_bytes_per_s": 3.35e12, "float32_flop_per_s": 67e12}
    t, by = k1_bound_s(dict(B=64, N=4096, D=128, S=7, H=256, iters=2), peak)
    assert by == "bytes" and t == pytest.approx(0.0827e-3, rel=2e-3)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return tiny_tree(tmp_path_factory.mktemp("bench"))


def test_rollout_flops_by_hand(tree):
    """One rolled-out frame of the tiny SlotFormer (S=3, slots 16, d 32,
    2 heads, ffn 64, 2 layers, 3 frames of history) and its decode."""
    j = job(*tree, "slotformer_clevrer.rollout")
    j.cell.traffic.update(batch=1, rollout=1)
    L = 9  # tokens in the window
    layer = (2 * L * 32 * 96 + 2 * (2 * 2 * L * L * 16) + 2 * L * 32 * 32
             + 2 * 2 * L * 32 * 64)
    rollouter = 2 * L * 16 * 32 + 2 * layer + 2 * 3 * 32 * 16
    # transposed convolutions counted on their input: 2 * |w| * input pixels
    decoder = (2 * 4 * 64 * 16 + 3 * (2 * 16 * 8 * 25 * 64 + 2 * 8 * 8 * 25 * 256
                                     + 2 * 8 * 4 * 256))
    assert rollout.flops_per_call(j) == rollouter + decoder


def test_extract_flops_by_hand(tree):
    """One first frame of the tiny StoSAVi at 16x16 (channels 3, 8, 8;
    slots 3 x 16, MLP 32, 2 rounds)."""
    j = job(*tree, "stosavi_clevrer.extract")
    j.cell.traffic.update(batch=1, video_len=1, chunk_len=1)
    n = 256
    encoder = 2 * (8 * 3 * 25) * n + 2 * (8 * 8 * 25) * n + 2 * n * 4 * 8
    head = 2 * n * 8 * 16 + 2 * n * 16 * 16 + 2 * (2 * n * 16 * 16)
    sa_round = (2 * 3 * 16 * 16 + 2 * (2 * n * 16 * 3) + 2 * (2 * 3 * 16 * 48)
                + 2 * (2 * 3 * 16 * 32))
    assert extract.flops_per_call(j) == encoder + head + 2 * 3 * 16 * 32 + 2 * sa_round


class _Event:
    def __init__(self, name, start, dur, cuda):
        self._n, self._s, self._d, self._c = name, start, dur, cuda

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        from torch.autograd import DeviceType

        return DeviceType.CUDA if self._c else DeviceType.CPU


def _prof(events):
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))


def test_trace_reduction():
    ev = [_Event("perfbench.window", 0, 100, False),
          _Event("aten::conv2d", 0, 50, False),
          _Event("cudaLaunchKernel", 40, 5, False),
          _Event("aten::linear", 60, 40, False),
          _Event("k_a", 10, 20, True), _Event("k_b", 20, 20, True),  # overlap
          _Event("k_a", 70, 10, True),
          _Event("k_late", 95, 20, True)]  # cut at the window's end
    t = core.Trace(_prof(ev), "perfbench.window")
    assert t.window_s == pytest.approx(100e-9)
    assert t.busy == [(10, 40), (70, 80), (95, 100)]
    assert t.busy_s == pytest.approx(45e-9)
    assert t.kernel_seconds("k_a") == pytest.approx(30e-9)
    assert t.device_ops()[0] == ("k_a", pytest.approx(30e-9))
    gaps = dict(t.idle_gaps())
    # each gap goes to the innermost op at its middle: [0, 10) conv2d,
    # [40, 70) none (its middle 55 lies between conv2d and linear),
    # [80, 95) linear
    assert gaps == {"aten::conv2d": pytest.approx(10e-9),
                    "host outside any op": pytest.approx(30e-9),
                    "aten::linear": pytest.approx(15e-9)}
