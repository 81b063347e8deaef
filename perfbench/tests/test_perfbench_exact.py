"""The exact comparison of a bfloat16 training cell (every dropout inactive
on both sides, in set-up, beside the comparison in which the reference
draws its own dropout) on the tiny STEVE cell on the CPU, and the FLOPs of
a step, which leave out the masked half of STEVE's causal self-attention.

Run: ``python -m pytest perfbench/tests -q`` from the repository root.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench import core
from perfbench.kinds import train
from perfbench.run import execute, make_job
from test_perfbench_steve import FAULTS
from tinybench import SEED, STEVE, job, tiny_tree

THREE = {"loss_gap", "grad_gap", "change_gap"}
EXACT = {f"exact_{k}" for k in THREE}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return tiny_tree(tmp_path_factory.mktemp("bench"))


def _program(tree, seed=SEED):
    j = job(*tree, STEVE, seed=seed)
    torch.manual_seed(j.seed)
    method, _, pool = train.build_program(j)
    return j, method, pool


def _probs(model):
    return [getattr(m, a) for m, a in train._dropouts(model)]


# ------------------------------------------------------ the program's side
def test_exact_steps_leave_the_check_steps_as_they_were(tree):
    j, method, pool = _program(tree)
    plain = train.check_steps(j, method, pool)
    j, method, pool = _program(tree)
    probs = _probs(method.model)
    assert probs and any(p > 0 for p in probs)
    exact = train.exact_steps(j, method, pool)
    assert _probs(method.model) == probs and method.it == 0
    after = train.check_steps(j, method, pool)
    assert after["loss"] == plain["loss"]
    assert exact["loss"][0] != plain["loss"][0]
    for key in ("start", "end", "grad1"):
        for n, x in plain[key].items():
            assert torch.equal(after[key][n], x), (key, n)
    for (g, n), (g2, n2) in zip(plain["rng"], after["rng"]):
        assert torch.equal(g, g2) and torch.equal(n, n2)


def test_dropout_inactive_on_both_sides(tree):
    """The exact steps from two global RNG states, the noise generator's
    kept, give the same losses, on the program's side and on the
    reference's; with dropout drawn the reference's differ."""
    j, method, pool = _program(tree)
    torch.manual_seed(1)
    a = train.exact_steps(j, method, pool)
    torch.manual_seed(2)
    b = train.exact_steps(j, method, pool)
    assert a["loss"] == b["loss"]
    assert not torch.equal(a["rng"][0][0], b["rng"][0][0])
    off = ("no_dropout",)
    ra = train.reference_steps(j, pool, a, planted=off)
    rb = train.reference_steps(j, pool, b, planted=off)
    assert ra["loss"] == rb["loss"]
    assert train.reference_steps(j, pool, a)["loss"] != \
        train.reference_steps(j, pool, b)["loss"]


# ------------------------------------------------------------- the readings
@pytest.mark.parametrize("case", ["sound", "half_batch", "state_unchanged",
                                  "one_rate", "bfloat16_pure_control"])
def test_exact_readings_separate(tree, case, monkeypatch):
    """A sound program passes the exact limits (set from sound runs), and
    each fault, and the control, fails at least one exact number."""
    j = job(*tree, STEVE)
    exact_limits = {k: v for k, v in j.cell.limits.items() if k in EXACT}
    assert set(exact_limits) == EXACT
    if case == "bfloat16_pure_control":
        torch.manual_seed(j.seed)
        found = train.control_readings(j)["control"]
    else:
        if case != "sound":
            FAULTS[case](monkeypatch)
        checks = execute(j.cell, j.seed, j.seconds, False, j.device,
                         j.process_start)[1]
        found = {k: c["value"] for k, c in checks.items()}
    assert set(found) == THREE | EXACT
    ok = core.judge({k: found[k] for k in EXACT}, exact_limits)[0]
    assert ok == (case == "sound"), found


@pytest.mark.parametrize("name", ["stosavi_clevrer.train",
                                  "slotformer_clevrer.train"])
def test_float32_cells_read_as_before(tree, name):
    j = job(*tree, name)
    assert not train._exact(j.cell.config)
    result, checks = execute(j.cell, j.seed, j.seconds, False, j.device,
                             j.process_start)
    assert result["correct"] and set(checks) == THREE


# ------------------------------------------------------------------ FLOPs
def _tiny_steve(tree):
    cell = core.Cell(tree[0], STEVE, bench_dir=tree[1])
    return cell.config["params"], core.reference_module(cell)


def test_causal_self_attention_counted_over_the_lower_triangle(tree):
    """On the meta device, each decoder layer's self-attention products
    (logits and weighted sum, forward and both input gradients), less its
    share of ``masked_flops``, are those of the n (n + 1) / 2 pairs."""
    p, mod = _tiny_steve(tree)
    frames, b = p["n_sample_frames"], 2
    n = (p["resolution"][0] // p["dvae_dict"]["down_factor"]) ** 2
    d, layers = p["dec_dict"]["dec_d_model"], p["dec_dict"]["dec_num_layers"]
    with torch.device("meta"):
        ref = mod.build(p)
        batch = {"img": torch.empty(b, frames, *p["resolution"], 3),
                 "token_id": torch.empty(b, frames, n, dtype=torch.int32)}
    with FlopCounterMode(display=False) as counter:
        loss = ref.train_loss(batch)["token_recon_loss"]
        torch.autograd.grad(loss, list(ref.parameters()), allow_unused=True)
    counts = counter.get_flop_counts()
    products = [sum(c for op, c in ops.items() if str(op) == "aten.bmm")
                for name, ops in counts.items() if name.endswith("self_attn")
                and ".tf_dec.blocks." in name]
    assert len(products) == layers
    masked = mod.masked_flops(p, batch)
    causal = 3 * 2 * 2 * b * frames * d * n * (n + 1) // 2
    for full in products:
        assert full - masked // layers == causal


# flops_per_step at the configurations' full sizes (meta device): the
# float32 cells' as before; STEVE's less the masked pairs,
# 4 x 3 x 2 x 2 x 288 x 192 x (1024 x 1023 / 2) = 1390210449408
FULL_FLOPS = {"stosavi_clevrer": 12618324639744,
              "slotformer_clevrer": 21291759828992,
              "steve_physion": 10970685472768 - 1390210449408}


@pytest.mark.parametrize("name", sorted(FULL_FLOPS))
def test_full_size_counts(name):
    spec = core.load_spec()
    if name not in {c["name"] for c in spec["configs"]}:
        spec = json.loads(json.dumps(spec))
        spec["configs"].append({"name": name,
                                "file": f"perfbench/configs/{name}.json"})
    spec["workloads"] = [{"name": "x", "config": name, "traffic": "train",
                          "chips": 1}]
    cell = core.Cell(spec, "x")
    dims = core.batch_dims(cell, int(cell.config["params"]["train_batch_size"]))
    pool = [{k: np.empty([dims[d] if isinstance(d, str) else int(d)
                          for d in shape], dtype=dtype)
             for k, (dtype, shape, _) in cell.config["train_batch"].items()}]
    j = make_job(cell, SEED, 1.0, False, torch.device("cpu"), 0.0)
    assert train.flops_per_step(j, pool) == FULL_FLOPS[name]
