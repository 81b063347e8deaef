"""Traffic kind ``train``: the trainer's own step (``BaseMethod._train_step``
of the configuration's method) over a pool of distinct collated batches
made from the seed, at the configuration's published batch.

Set-up builds one method object (model, optimizer, noise generator) from
seeded weights, grafts what the method grafts from a file written from the
same weights, and takes its first ``check_steps`` steps through the same
call and feed as the window, on different batches; these are the warm-up.
The reference follows those steps from the same weights, batches and RNG
states, once the window has closed and the program's state is freed.

A configuration's ``precision`` (``float32`` or ``bfloat16``) is the one the
program trains in: ``bfloat16`` runs the trainer's own bf16 autocast
(``use_fp16``, as ``cli/train.py --fp16`` sets it). The reference stays
float32 with TF32 off; the control is the reference in TF32 for a float32
cell, and wholly in bfloat16 (weights, activations and Adam's state, no
float32 copy) for a bfloat16 one. Where the program draws dropout that the
reference cannot replay (inside a fused attention: a bfloat16 cell), the
reference draws its own, and the limits are set over that spread. Beside
that comparison such a cell gets an exact one: in set-up, before the check
steps, the same method takes ``check_steps`` steps with every dropout
inactive and is then put back as it was (``exact_steps``); the reference
follows them with its dropout left out, from the same weights, batches and
RNG states, and the readings carry the prefix ``exact_``.
"""

from __future__ import annotations

import copy
import gc
import os
import tempfile
import time
from types import SimpleNamespace

import torch

from ..core import batch_dims, make_batches, reference_module, seeded_reference
from ..program import port_model, port_params
from ..reference.train import BETAS, Trainer
from ..yardstick import count_flops
from .common import Spans, Window, peak_bytes, precision, synchronize


class _Loader:
    def __init__(self, batch_size: int, steps_per_epoch: int):
        self.batch_size = batch_size
        self._len = steps_per_epoch

    def __len__(self) -> int:
        return self._len


PRECISIONS = ("float32", "bfloat16")
# the control of each precision (``common.precision``)
CONTROL = {"float32": "tf32", "bfloat16": "bfloat16_pure"}


def _precision(cfg: dict) -> str:
    mode = cfg.get("precision", "float32")
    if mode not in PRECISIONS:
        raise ValueError(f"precision {mode!r}: the train kind runs {PRECISIONS}")
    return mode


def _exact(cfg: dict) -> bool:
    """Whether a configuration gets the exact comparison: one that trains
    in bfloat16, whose fused attention draws dropout the reference cannot
    replay."""
    return _precision(cfg) == "bfloat16"


def _rng_state(dev):
    return (torch.cuda.get_rng_state(dev) if torch.device(dev).type == "cuda"
            else torch.get_rng_state())


def _set_rng_state(dev, state) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.set_rng_state(state, dev)
    else:
        torch.set_rng_state(state)


def _dropouts(model) -> list:
    """(module, attribute) of every dropout probability of ``model``: each
    ``nn.Dropout``'s ``p``, and each float ``dropout`` that a fused
    attention reads."""
    out = []
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            out.append((m, "p"))
        elif isinstance(getattr(m, "dropout", None), float):
            out.append((m, "dropout"))
    return out


def _snapshot(model) -> dict:
    return {n: q.detach().to("cpu", copy=True).float()
            for n, q in model.named_parameters()}


def _leaf_gap(prog: dict, ref: dict) -> float:
    """The worst leaf's |‖prog‖ - ‖ref‖| over max(‖ref‖, the median leaf's
    ‖ref‖)."""
    norms = {n: float(ref[n].double().norm()) for n in ref}
    med = float(torch.tensor(sorted(norms.values())).median())
    worst = 0.0
    for n in ref:
        a = float(prog[n].double().norm())
        worst = max(worst, abs(a - norms[n]) / max(norms[n], med, 1e-30))
    return worst


def build_program(job):
    """(method, params, batch pool) of the cell, before any step."""
    cell, dev, seed = job.cell, job.device, job.seed
    cfg = cell.config
    params = port_params(cell)
    sd = seeded_reference(cell, seed, dev)[1]
    model = port_model(params, dev)
    job.mark("model")
    graft = cfg.get("graft")
    tmp = tempfile.mkdtemp(prefix="perfbench-")
    if graft:
        # the method grafts these weights from a file, as its users' runs do
        path = os.path.join(tmp, "graft.pth")
        torch.save({"state_dict": {k: v.cpu() for k, v in sd.items()
                                   if k.split(".")[0] in graft["prefixes"]}}, path)
        getattr(params, graft["dict"])[graft["key"]] = path
        rest = {k: v for k, v in sd.items()
                if k.split(".")[0] not in graft["prefixes"]}
        missing = model.load_state_dict(rest, strict=False).missing_keys
        if any(k.split(".")[0] not in graft["prefixes"] for k in missing):
            raise RuntimeError(f"weights missing: {missing}")
    else:
        model.load_state_dict(sd)
    from slotformer_tpu_torch import methods

    B = int(params.train_batch_size)
    dm = SimpleNamespace(train_loader=_Loader(B, int(cfg["steps_per_epoch"])),
                         val_loader=None)
    method = getattr(methods, cfg["method"])(
        model, dm, params, ckp_path=os.path.join(tmp, "ckp"), seed=seed,
        use_fp16=_precision(cfg) == "bfloat16")
    method.setup_state()
    job.mark("method")
    if graft:
        os.remove(getattr(params, graft["dict"])[graft["key"]])
    os.rmdir(tmp)
    pool = make_batches(cfg["train_batch"], batch_dims(cell, B),
                        int(cell.traffic["pool_batches"]), seed + 1, dev)
    job.mark("inputs")
    return method, params, pool


def check_steps(job, method, pool, mark: str = "step") -> dict:
    """The first steps through ``_train_step``: what the reference needs
    to follow them and what the comparison reads from them."""
    model = method.model
    dev = job.device
    n = int(job.cell.traffic["check_steps"])
    rec = {"start": _snapshot(model), "rng": [], "loss": []}
    for i in range(n):
        rec["rng"].append((_rng_state(dev), method.generator.get_state()))
        out = method._train_step(pool[i % len(pool)])
        rec["loss"].append(float(out["total_loss"]))
        if i == 0:
            state = method.optimizer.optimizer.state
            rec["grad1"] = {name: (state[q]["exp_avg"] / (1 - BETAS[0])).cpu()
                            for name, q in model.named_parameters()
                            if q in state}
        job.mark(f"{mark} {i + 1}")
    rec["end"] = _snapshot(model)
    return rec


def exact_steps(job, method, pool) -> dict:
    """``check_steps`` with every dropout of the program inactive, from the
    method as it stands; then the method is put back as it was: its
    weights, Adam's state, its step count (which sets the schedule), the
    global and the noise generator's RNG states and every dropout
    probability, so that the steps after these run as they would without
    them."""
    model, opt, dev = method.model, method.optimizer.optimizer, job.device
    weights = [q.detach().clone() for q in model.state_dict().values()]
    adam = copy.deepcopy(opt.state_dict())
    it, grad_norm = method.it, method._grad_norm
    rng, noise = _rng_state(dev), method.generator.get_state()
    probs = [(m, a, getattr(m, a)) for m, a in _dropouts(model)]
    try:
        for m, a, _ in probs:
            setattr(m, a, 0.0)
        return check_steps(job, method, pool, "exact step")
    finally:
        for m, a, p in probs:
            setattr(m, a, p)
        with torch.no_grad():
            for q, w in zip(model.state_dict().values(), weights):
                q.copy_(w)
        opt.load_state_dict(adam)
        method.it, method._grad_norm = it, grad_norm
        _set_rng_state(dev, rng)
        method.generator.set_state(noise)


def reference_steps(job, pool, rec, mode: str = "float32",
                    planted=()) -> dict:
    """The reference's steps from the same weights, batches and RNG states,
    in precision ``mode`` (``common.precision``), with the faults
    ``planted``: ``half_batch`` (only the first half of each batch's rows),
    ``one_lr`` (the ``dec_lr`` group trains at the main rate, in one group)
    and ``no_dropout`` (every dropout of the reference left out)."""
    cell, dev = job.cell, job.device
    cfg = cell.config
    rows = (pool[0][next(iter(pool[0]))].shape[0] // 2
            if "half_batch" in planted else None)
    ref = seeded_reference(cell, job.seed, dev)[0]
    if mode == "bfloat16_pure":
        ref = ref.to(torch.bfloat16)
    if "no_dropout" in planted:
        for m, a in _dropouts(ref):
            setattr(m, a, 0.0)
    p = cfg["params"]
    if "one_lr" in planted:
        p = {k: v for k, v in p.items() if k != "dec_lr"}
    total = int(p["max_epochs"]) * int(cfg["steps_per_epoch"])
    trainer = Trainer(ref, p, total, cfg.get("frozen_prefixes", ()))
    start = _snapshot(ref)
    out = {"loss": []}
    with precision(mode, dev):
        for i, (rng_global, rng_noise) in enumerate(rec["rng"]):
            _set_rng_state(dev, rng_global)
            gen = torch.Generator(device=dev)
            gen.set_state(rng_noise)
            batch = {k: torch.from_numpy(v[:rows]).to(dev)
                     for k, v in pool[i % len(pool)].items()}
            if mode == "bfloat16_pure":
                batch = {k: v.to(torch.bfloat16) if v.is_floating_point() else v
                         for k, v in batch.items()}
            step = trainer.step(batch, gen)
            out["loss"].append(step["total"])
            if i == 0:
                out["grad1"] = {k: g.float().cpu() for k, g in step["grads"].items()}
    out["start"], out["end"] = start, _snapshot(ref)
    return out


def readings(rec: dict, ref: dict) -> dict:
    """The numbers compared: the worst step's relative loss gap, the worst
    leaf's gap of the first gradient's norm, and of the norm of the
    parameters' change over the steps. Entries whose first reference
    gradient is under a thousandth of the median leaf's RMS gradient are
    nought to rounding (a key's bias under the softmax), and Adam moves
    them by round-off alone: they are left out of the change."""
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30)
                   for a, b in zip(rec["loss"], ref["loss"]))
    g1 = ref["grad1"]
    rms = sorted(float(g.double().pow(2).mean().sqrt()) for g in g1.values())
    floor = 1e-3 * rms[len(rms) // 2]
    moved = {n: g.abs() >= floor for n, g in g1.items()}
    change_p = {n: (rec["end"][n] - rec["start"][n])[moved[n]] for n in g1
                if moved[n].any()}
    change_r = {n: (ref["end"][n] - ref["start"][n])[moved[n]] for n in g1
                if moved[n].any()}
    return {
        "loss_gap": loss_gap,
        "grad_gap": _leaf_gap({n: rec["grad1"].get(n, torch.zeros(1))
                               for n in g1}, g1),
        "change_gap": _leaf_gap(change_p, change_r),
    }


def exact_readings(exact: dict, ref_exact: dict) -> dict:
    """``readings`` of the exact pair, each under the prefix ``exact_``."""
    return {f"exact_{k}": v for k, v in readings(exact, ref_exact).items()}


def flops_per_step(job, pool) -> int:
    """FLOPs of one training step (forward and backward) of the reference
    at the cell's shapes, counted on the meta device, less the reference's
    ``masked_flops`` where it has them: the work on query-key pairs that a
    causal mask zeroes, which a causal kernel does not do."""
    cfg = job.cell.config
    mod = reference_module(job.cell)
    with torch.device("meta"):
        ref = mod.build(cfg["params"])
        trainer = Trainer(ref, cfg["params"], 1, cfg.get("frozen_prefixes", ()))
        batch = {k: torch.empty(v.shape, dtype=torch.from_numpy(v[:1]).dtype)
                 for k, v in pool[0].items()}

    def step():
        ref.train()
        losses = ref.train_loss(batch, None)
        total = sum(trainer.weights.get(k, 1.0) * v for k, v in losses.items())
        torch.autograd.grad(total, trainer.params, allow_unused=True)

    masked = getattr(mod, "masked_flops", None)
    return count_flops(step) - (masked(cfg["params"], batch) if masked else 0)


def k1_calls(cell, steps: int, batch: int):
    """[(K1 call shape, calls)] of ``steps`` training steps."""
    sa = cell.config.get("slot_attention")
    if not sa:
        return []
    frames = int(cell.config["params"]["input_frames"])
    return [(dict(sa, B=batch), steps * frames)]


def run(job):
    method, params, pool = build_program(job)
    dev = job.device
    exact = exact_steps(job, method, pool) if _exact(job.cell.config) else None
    rec = check_steps(job, method, pool)
    synchronize(dev)
    setup_s = time.time() - job.process_start
    B = int(params.train_batch_size)
    n0 = len(rec["loss"])

    spans = Spans()
    if job.trace and torch.device(dev).type == "cuda":
        spans.wrap(method.model, "train_loss", "forward")
        spans.wrap(method.optimizer, "step", "optimizer")
    setup_peak = peak_bytes(dev)
    if torch.device(dev).type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    def step(i):
        method._train_step(pool[(n0 + i) % len(pool)])

    win = Window(dev, job.seconds, job.trace).run(step)
    peak = peak_bytes(dev)
    layer = None
    if job.trace:
        layer = SimpleNamespace(
            window=win, steps=win.steps,
            spans={"forward": spans.ms("forward"),
                   "backward": spans.between("forward", "optimizer"),
                   "optimizer": spans.ms("optimizer")},
            flops_per_step=lambda: flops_per_step(job, pool),
            k1_calls=k1_calls(job.cell, win.steps, B))
    del method, params
    gc.collect()
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    found = readings(rec, reference_steps(job, pool, rec))
    if exact is not None:
        found.update(exact_readings(exact, reference_steps(
            job, pool, exact, planted=("no_dropout",))))
    return SimpleNamespace(
        setup_s=setup_s,
        end_to_end={"train_clips_per_s": win.steps * B / win.elapsed,
                    "train_peak_mem_gib": peak / 2 ** 30},
        memory_peak_bytes=max(peak, setup_peak), attempted=win.steps, layer=layer,
        readings=found)


def faults(cfg: dict) -> list:
    """The reference-side faults a configuration can have: half the batch
    always, one rate where the params hold ``dec_lr``, and the dropout left
    out where the program trains in bfloat16 (whose fused attention draws
    dropout the reference cannot replay)."""
    return (["half_batch"] + (["one_lr"] if cfg["params"].get("dec_lr") is not None else [])
            + (["no_dropout"] if _exact(cfg) else []))


def control_readings(job, mode: str = "") -> dict:
    """One seed's readings, no window: the program's check steps, the
    control (the reference in precision ``mode``, by default the control of
    the configuration's precision) and each of the configuration's
    ``faults``, each against the float32 reference. Where the configuration
    gets the exact comparison, each of these also holds its ``exact_``
    readings, taken with its dropout inactive against the float32
    reference's with dropout left out, and ``witness_autocast`` holds those
    of the reference under the trainer's bf16 autocast, a stand-in for a
    sound bfloat16 program (no control)."""
    cfg = job.cell.config
    mode = mode or CONTROL[_precision(cfg)]
    method, params, pool = build_program(job)
    exact = exact_steps(job, method, pool) if _exact(cfg) else None
    rec = check_steps(job, method, pool)
    del method, params
    gc.collect()
    if torch.device(job.device).type == "cuda":
        torch.cuda.empty_cache()
    ref = reference_steps(job, pool, rec)
    out = {"program": readings(rec, ref), "mode": mode,
           "control": readings(reference_steps(job, pool, rec, mode), ref)}
    for fault in faults(cfg):
        out[f"fault_{fault}"] = readings(
            reference_steps(job, pool, rec, planted=(fault,)), ref)
    if exact is not None:
        off = ("no_dropout",)
        ref_x = reference_steps(job, pool, exact, planted=off)
        out["program"].update(exact_readings(exact, ref_x))
        out["control"].update(exact_readings(
            reference_steps(job, pool, exact, mode, off), ref_x))
        for fault in faults(cfg):
            # with its dropout left out, the reference's exact steps are ref_x
            steps = ref_x if fault == "no_dropout" else reference_steps(
                job, pool, exact, planted=(fault,) + off)
            out[f"fault_{fault}"].update(exact_readings(steps, ref_x))
        out["witness_autocast"] = exact_readings(
            reference_steps(job, pool, exact, "bfloat16", off), ref_x)
    if torch.device(job.device).type == "cuda":
        torch.cuda.empty_cache()
    return out
