"""Each traffic kind through the harness at tiny widths on the CPU: the
program agrees with the reference within the cells' limits, a lower
precision does not, and each fault the cell can have, planted in the
timed path, makes ``correct`` come out false.

Run: ``python -m pytest perfbench/tests -q`` from the repository root.
"""

from __future__ import annotations

import importlib
import json

import pytest
import torch

from perfbench import core
from perfbench.run import execute
from tinybench import CELLS, job, tiny_tree

from slotformer_tpu_torch.models import slotformer as sf_mod
from slotformer_tpu_torch.models.savi import StoSAVi
from slotformer_tpu_torch.runtime import method as method_mod
from slotformer_tpu_torch.runtime import schedules


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return tiny_tree(tmp_path_factory.mktemp("bench"))


def _run(tree, name, trace=False):
    j = job(*tree, name, trace=trace)
    return execute(j.cell, j.seed, j.seconds, trace, j.device, j.process_start)


@pytest.mark.parametrize("name", CELLS)
def test_cell_correct(tree, name):
    result, checks = _run(tree, name)
    assert result["correct"], checks
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(checks) == set(json.loads(
        (core.BENCH / "limits" / f"{name}.json").read_text()))


@pytest.mark.parametrize("name", CELLS)
def test_lower_precision_refused(tree, name):
    """The reference in bfloat16 in the program's place fails the limits."""
    j = job(*tree, name)
    kind = importlib.import_module(f"perfbench.kinds.{j.cell.traffic['kind']}")
    torch.manual_seed(j.seed)
    low = kind.control_readings(j, "bfloat16")["control"]
    ok, checks = core.judge(low, j.cell.limits)
    assert not ok, checks


FAULTS = {
    # training: the optimizer leaves the state unchanged
    ("train", "state_unchanged"): lambda mp: mp.setattr(
        schedules.ScheduledOptimizer, "step",
        lambda self, step: torch.zeros(())),
    # training: half of the batch left out, the mean over the rest
    ("train", "half_batch"): lambda mp: mp.setattr(
        method_mod.BaseMethod, "_to_device",
        _wrap(method_mod.BaseMethod._to_device,
              lambda out: {k: v[:max(v.shape[0] // 2, 1)] for k, v in out.items()})),
    # rollout: the rollouter returns its last frame, unchanged
    ("rollout", "state_unchanged"): lambda mp: mp.setattr(
        sf_mod.SlotRollouter, "forward",
        lambda self, x, n: x[:, -1:].expand(-1, n, -1, -1).contiguous()),
    # rollout: half of the batch left out (its rows copied over the rest)
    ("rollout", "half_batch"): lambda mp: mp.setattr(
        sf_mod.SlotFormer, "forward",
        _wrap_in(sf_mod.SlotFormer.forward,
                 lambda b: {"slots": _halve(b["slots"])})),
    # rollout: a frame altered where it is produced
    ("rollout", "answer_altered"): lambda mp: mp.setattr(
        sf_mod.SlotFormer, "rollout",
        _wrap(sf_mod.SlotFormer.rollout, _alter_frame)),
    # extraction: the slots not carried from one chunk to the next
    ("extract", "state_unchanged"): lambda mp: mp.setattr(
        StoSAVi, "encode",
        lambda self, img, prev_slots=None, pred_state=None, sample_eps=None,
        generator=None, _f=StoSAVi.encode: _f(self, img, None, None,
                                              sample_eps, generator)),
    ("extract", "half_batch"): lambda mp: mp.setattr(
        StoSAVi, "encode",
        lambda self, img, *a, _f=StoSAVi.encode, **k: _f(self, _halve(img), *a, **k)),
    ("extract", "answer_altered"): lambda mp: mp.setattr(
        StoSAVi, "encode",
        _wrap(StoSAVi.encode, lambda out: (out[0], out[1] + 1e-2 * (
            torch.arange(out[1].shape[1], device=out[1].device) == 0
        ).float()[None, :, None, None], *out[2:]))),
}


def _wrap(fn, post):
    def wrapped(*args, **kwargs):
        return post(fn(*args, **kwargs))
    return wrapped


def _wrap_in(fn, pre):
    def wrapped(self, batch, *args, **kwargs):
        return fn(self, pre(batch), *args, **kwargs)
    return wrapped


def _halve(x):
    h = max(x.shape[0] // 2, 1)
    return torch.cat([x[:h], x[:h]])[:x.shape[0]]


def _alter_frame(out):
    if isinstance(out, dict):
        out = dict(out)
        rc = out["recon_combined"].clone()
        rc[:, -1] += 1e-2
        out["recon_combined"] = rc
    return out


@pytest.mark.parametrize("kind,fault", sorted(FAULTS))
def test_fault_caught(tree, kind, fault, monkeypatch):
    name = {"train": CELLS[:2], "rollout": CELLS[2:3],
            "extract": CELLS[3:]}[kind]
    FAULTS[(kind, fault)](monkeypatch)
    for n in name:
        result, checks = _run(tree, n)
        assert not result["correct"], (n, checks)
