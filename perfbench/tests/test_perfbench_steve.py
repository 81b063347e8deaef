"""The training harness on the published STEVE recipe, at tiny widths on
the CPU: bf16 autocast (``precision``), a second learning-rate group
(``dec_lr``), token ids (the ``randint`` fill and the configuration's
``dims``), the pure-bfloat16 control and the faults of such a cell, and
``mfu`` against the precision's peak.

Run: ``python -m pytest perfbench/tests -q`` from the repository root.
"""

from __future__ import annotations

import hashlib
import json
import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch import nn

from perfbench import core
from perfbench.kinds import train
from perfbench.metrics.layer import mfu
from perfbench.reference.train import ADAM_EPS, BETAS, Trainer, lr_at
from perfbench.run import execute
from tinybench import REAL, SEED, STEVE, job, tiny_tree

from slotformer_tpu_torch.models.steve import STEVE as PortSTEVE
from slotformer_tpu_torch.runtime import method as method_mod
from slotformer_tpu_torch.runtime import schedules


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return tiny_tree(tmp_path_factory.mktemp("bench"))


def _run(tree, seed=SEED):
    j = job(*tree, STEVE, seed=seed)
    return execute(j.cell, j.seed, j.seconds, False, j.device, j.process_start)


# ------------------------------------------------------------ the trainer
class _Net(nn.Module):
    """Three top-level parts, as STEVE names them: a trained encoder, the
    token decoder (the ``dec_lr`` group) and a frozen dVAE."""

    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(3)
        self.enc = nn.Linear(6, 5)
        self.trans_decoder = nn.Linear(5, 4)
        self.dvae = nn.Linear(4, 4)
        with torch.no_grad():
            for q in self.parameters():
                q.copy_(torch.rand(q.shape, generator=g) - 0.5)

    def train_loss(self, batch, generator=None):
        y = self.dvae(self.trans_decoder(torch.relu(self.enc(batch["x"]))))
        return {"token_recon_loss": (y ** 2).mean() * 50.0}


P = {"lr": 1e-2, "dec_lr": 3e-2, "dec_lr_prefixes": ["trans_decoder"],
     "warmup_steps_pct": 0.34, "clip_grad": 0.05, "optimizer": "Adam",
     "token_recon_loss_w": 1.0}


class _Params(dict):
    __getattr__ = dict.__getitem__


def _batches(n):
    g = torch.Generator().manual_seed(5)
    return [{"x": torch.randn(8, 6, generator=g)} for _ in range(n)]


def test_two_groups_follow_build_optimizer():
    """Per-group clip, the decoder's own rate falling to 0, the frozen part
    left out: the reference trainer against the port's optimizer stack,
    step after step."""
    steps = 6
    ref, prog = _Net(), _Net()
    trainer = Trainer(ref, P, steps, frozen=("dvae",))
    opt = schedules.build_optimizer(_Params(P), prog, steps, frozen_prefixes=("dvae",))
    assert [len(g["params"]) for g in opt.optimizer.param_groups] == [2, 2]
    assert trainer.group == [0, 0, 1, 1]
    dec0 = prog.trans_decoder.weight.detach().clone()
    for i, batch in enumerate(_batches(steps)):
        out = trainer.step(batch, None)
        loss = prog.train_loss(batch)["token_recon_loss"]
        loss.backward()
        norm = opt.step(i)
        opt.zero_grad()
        assert out["grad_norm"] == pytest.approx(float(norm), rel=1e-5)
        for (n, a), b in zip(ref.named_parameters(), prog.parameters()):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7, msg=n)
        if i == 0:
            # the decoder's rate starts from its floor of 0
            assert torch.equal(prog.trans_decoder.weight, dec0)
    assert lr_at(steps, P, steps, P["dec_lr"], 0.0) == 0.0


def _old_step(tr: Trainer, batch):
    """The reference trainer's step before it held groups, as it was."""
    tr.model.train()
    losses = tr.model.train_loss(batch, None)
    total = sum(tr.weights.get(k, 1.0) * v for k, v in losses.items())
    grads = torch.autograd.grad(total, tr.params, allow_unused=True)
    grads = [torch.zeros_like(q) if g is None else g
             for q, g in zip(tr.params, grads)]
    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads)).float()
    clip = float(tr.p.get("clip_grad", -1.0) or -1.0)
    if clip > 0 and norm >= clip:
        grads = [g * (clip / norm) for g in grads]
    lr = lr_at(tr.t, tr.p, tr.total_steps)
    tr.t += 1
    b1, b2 = BETAS
    with torch.no_grad():
        for q, g, m, v in zip(tr.params, grads, tr.m, tr.v):
            m.lerp_(g, 1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = v.sqrt() / math.sqrt(1 - b2 ** tr.t) + ADAM_EPS
            q.addcdiv_(m, denom, value=-lr / (1 - b1 ** tr.t))
    return float(norm), grads


def test_one_group_bit_for_bit():
    p = {k: v for k, v in P.items() if k != "dec_lr"}
    new, old = _Net(), _Net()
    tn, to = Trainer(new, p, 6), Trainer(old, p, 6)
    assert set(tn.group) == {0}
    for batch in _batches(4):
        out = tn.step(batch, None)
        norm, grads = _old_step(to, batch)
        assert out["grad_norm"] == norm
        for g_new, g_old in zip(out["grads"].values(), grads):
            assert torch.equal(g_new, g_old)
        for a, b in zip(new.parameters(), old.parameters()):
            assert torch.equal(a, b)


# --------------------------------------------------------------- inputs
def test_randint_fill_from_the_seed():
    spec = {"token_id": ["int32", ["B", "T", "P"], ["randint", "V"]],
            "img": ["float32", ["B", 2], "uniform"]}
    dims = {"B": 3, "T": 2, "P": 5, "V": 7}
    a = core.make_batches(spec, dims, 2, SEED, torch.device("cpu"))
    b = core.make_batches(spec, dims, 2, SEED, torch.device("cpu"))
    c = core.make_batches(spec, dims, 2, SEED + 1, torch.device("cpu"))
    for x, y in zip(a, b):
        assert all(np.array_equal(x[k], y[k]) for k in spec)
    assert not np.array_equal(a[0]["token_id"], c[0]["token_id"])
    ids = np.concatenate([x["token_id"].ravel() for x in a])
    assert ids.dtype == np.int32 and ids.min() >= 0 and ids.max() < 7
    assert len(set(ids.tolist())) == 7
    assert core.make_batches({"t": ["int32", [4], ["randint", 3]]}, {}, 1, 1,
                             torch.device("cpu"))[0]["t"].max() < 3


def test_existing_specs_draw_as_before():
    """The float32 cells' batch specs draw the arrays they drew before the
    new fill (a digest taken with the harness as it was)."""
    dims = {"B": 4, "T": 3, "S": 3, "D": 16, "H": 16, "W": 16}
    h = hashlib.sha1()
    for name in ("stosavi_clevrer", "slotformer_clevrer"):
        tb = json.loads((REAL / "configs" / f"{name}.json").read_text())["train_batch"]
        for b in core.make_batches(tb, dims, 2, SEED, torch.device("cpu")):
            for k in sorted(b):
                h.update(k.encode())
                h.update(np.ascontiguousarray(b[k]).tobytes())
    assert h.hexdigest() == "be49d85155923e185397cb7ddf91d953a8fdab44"


def test_dims_of_the_configuration(tree):
    cell = core.Cell(tree[0], STEVE, bench_dir=tree[1])
    dims = core.batch_dims(cell, 4)
    assert dims["P"] == 16 and dims["V"] == 32 and dims["B"] == 4
    real = json.loads((REAL / "configs" / "steve_physion.json").read_text())
    assert real["dims"] == {"P": 1024, "V": 4096}


# ------------------------------------------------------- the cell and faults
def test_bfloat16_cell_trains_under_autocast_and_reads_correct(tree):
    j = job(*tree, STEVE)
    method = train.build_program(j)[0]
    assert method.use_fp16 and len(method.optimizer.optimizer.param_groups) == 2
    other = job(*tree, "stosavi_clevrer.train")
    assert not train.build_program(other)[0].use_fp16
    result, checks = _run(tree)
    assert result["correct"], checks
    assert set(checks) == {"loss_gap", "grad_gap", "change_gap", "exact_loss_gap",
                           "exact_grad_gap", "exact_change_gap"}


def test_reference_is_the_program_without_dropout(tree):
    """In float32 and with every dropout left out on both sides, the plain
    reference follows the program's three steps to rounding."""
    j = job(*tree, STEVE)
    j.cell.config["precision"] = "float32"
    torch.manual_seed(j.seed)
    method, _, pool = train.build_program(j)
    for m, a in train._dropouts(method.model):
        setattr(m, a, 0.0)
    rec = train.check_steps(j, method, pool)
    r = train.readings(rec, train.reference_steps(j, pool, rec, planted=("no_dropout",)))
    assert r["loss_gap"] < 1e-6 and r["grad_gap"] < 1e-5 and r["change_gap"] < 1e-4, r


def _one_rate(mp):
    step = schedules.ScheduledOptimizer.step

    def one(self, i):
        self.schedules = [self.schedules[0]] * len(self.schedules)
        return step(self, i)

    mp.setattr(schedules.ScheduledOptimizer, "step", one)


def _no_decoder_dropout(mp):
    loss = PortSTEVE.train_loss

    def no_dropout(self, batch, generator=None):
        for m, a in train._dropouts(self.trans_decoder):
            setattr(m, a, 0.0)
        return loss(self, batch, generator)

    mp.setattr(PortSTEVE, "train_loss", no_dropout)


def _half_batch(mp):
    to_device = method_mod.BaseMethod._to_device
    mp.setattr(method_mod.BaseMethod, "_to_device", lambda self, b: {
        k: v[:max(v.shape[0] // 2, 1)] for k, v in to_device(self, b).items()})


FAULTS = {
    "half_batch": _half_batch,
    "state_unchanged": lambda mp: mp.setattr(
        schedules.ScheduledOptimizer, "step", lambda self, step: torch.zeros(())),
    "one_rate": _one_rate,
    "decoder_dropout_left_out": _no_decoder_dropout,
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_caught(tree, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    result, checks = _run(tree)
    assert not result["correct"], checks


def test_pure_bfloat16_control_refused(tree):
    """The control of a bfloat16 cell is the reference wholly in bfloat16
    (weights, activations, Adam's state); the faults of the configuration
    are read beside it, and each fails the limits."""
    j = job(*tree, STEVE)
    torch.manual_seed(j.seed)
    r = train.control_readings(j)
    assert r["mode"] == "bfloat16_pure"
    assert train.faults(j.cell.config) == ["half_batch", "one_lr", "no_dropout"]
    assert train.faults(job(*tree, "stosavi_clevrer.train").cell.config) == ["half_batch"]
    assert core.judge(r["program"], j.cell.limits)[0], r
    for key in ("control", "fault_half_batch", "fault_one_lr", "fault_no_dropout"):
        assert not core.judge(r[key], j.cell.limits)[0], (key, r)
    exact = {k: v for k, v in j.cell.limits.items() if k.startswith("exact_")}
    assert core.judge(r["witness_autocast"], exact)[0], r
    float_cell = job(*tree, "stosavi_clevrer.train")
    assert train.CONTROL[float_cell.cell.config["precision"]] == "tf32"


# ------------------------------------------------------------------ mfu
def test_mfu_against_the_precision_peak():
    peak = {"float32_flop_per_s": 50.0, "bfloat16_flop_per_s": 1000.0}
    ctx = SimpleNamespace(trace=SimpleNamespace(window_s=2.0), peak=peak,
                          steps=4, flops_per_step=lambda: 100,
                          precision="float32")
    assert mfu(ctx) == pytest.approx(100.0 * 400 / 2.0 / 50.0)
    ctx.precision = "bfloat16"
    assert mfu(ctx) == pytest.approx(100.0 * 400 / 2.0 / 1000.0)
