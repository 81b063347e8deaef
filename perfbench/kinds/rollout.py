"""Traffic kind ``rollout``: evaluation rollouts as ``cli/test_vp.py``
drives them, one batch of slot histories a call: the model from the
test CLI's own ``adjust_params`` and ``build_model``, ``model({"slots":
...})`` in eval under ``torch.no_grad`` (rollout of ``rollout`` frames from
``history`` and their decode), without the metrics.

A frame is one rolled-out, decoded frame. The window keeps the outputs of
a sample of its calls, drawn from the seed, and the reference recomputes
them once the window has closed.
"""

from __future__ import annotations

import gc
import time
from types import SimpleNamespace

import numpy as np
import torch

from ..core import batch_dims, gap, make_batches, reference_module, seeded_reference
from ..program import port_model, port_params
from ..yardstick import count_flops
from .common import peak_bytes, precision, sampled_window, synchronize

KEYS = ("pred_slots", "recon_combined", "masks")


def build_program(job):
    cell, dev = job.cell, job.device
    from slotformer_tpu_torch.cli.test_vp import adjust_params

    t = cell.traffic
    params = adjust_params(port_params(cell), int(t["batch"]))
    if (params.input_frames, params.n_sample_frames) != (
            t["history"], t["history"] + t["rollout"]):
        raise ValueError("the traffic's history and rollout differ from "
                         "what test_vp sets for this dataset")
    sd = seeded_reference(cell, job.seed, dev)[1]
    model = port_model(params, dev)
    model.load_state_dict(sd)
    model.eval()
    job.mark("model")
    pool = make_batches(t["batch_spec"], batch_dims(cell, int(t["batch"])),
                        int(t["pool_batches"]), job.seed + 1, dev)

    @torch.no_grad()
    def forward(batch):
        slots = torch.from_numpy(np.ascontiguousarray(batch["slots"])).to(dev)
        return model({"slots": slots})

    return model, pool, forward


def reference_outputs(job, pool, idxs, mode: str = "float32") -> list:
    cell, dev = job.cell, job.device
    ref = seeded_reference(cell, job.seed, dev)[0].eval()
    with precision(mode, dev), torch.no_grad():
        return [{k: v.float().cpu() for k, v in ref.rollout_decode(
            torch.from_numpy(pool[i]["slots"]).to(dev),
            int(cell.traffic["rollout"])).items()} for i in idxs]


def readings(outs: list, refs: list) -> dict:
    """Worst sampled batch: rolled-out slots relative to their largest
    magnitude, frames and masks as absolute differences."""
    return {
        "slots_gap": max(gap(o["pred_slots"], r["pred_slots"]) for o, r in zip(outs, refs)),
        "frame_gap": max(float((o["recon_combined"].double() - r["recon_combined"].double()).abs().max())
                         for o, r in zip(outs, refs)),
        "mask_gap": max(float((o["masks"].double() - r["masks"].double()).abs().max())
                        for o, r in zip(outs, refs)),
    }


def flops_per_call(job) -> int:
    cell = job.cell
    t = cell.traffic
    mod = reference_module(cell)
    p = cell.config["params"]
    with torch.device("meta"):
        ref = mod.build(p).eval().requires_grad_(False)
        slots = torch.empty(int(t["batch"]), int(t["history"]),
                            p["slot_dict"]["num_slots"], p["slot_dict"]["slot_size"])
    return count_flops(lambda: ref.rollout_decode(slots, int(t["rollout"])))


def _window(job, forward, pool):
    """The window; (window, {call: (pool index, its outputs)}) of a sample."""
    def call(i):
        j = i % len(pool)
        out = forward(pool[j])
        return j, {k: out[k] for k in KEYS}

    return sampled_window(job, call)


def run(job):
    model, pool, forward = build_program(job)
    dev = job.device
    job.mark("inputs")
    for i, b in enumerate(pool[:int(job.cell.traffic["warmup_batches"])]):
        forward(b)
        synchronize(dev)
        job.mark(f"warm-up {i + 1}")
    setup_s = time.time() - job.process_start
    setup_peak = peak_bytes(dev)
    if torch.device(dev).type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    win, kept = _window(job, forward, pool)
    peak = peak_bytes(dev)
    t = job.cell.traffic
    frames = win.steps * int(t["batch"]) * int(t["rollout"])
    outs = [{k: v.cpu() for k, v in o.items()} for _, o in kept.values()]
    idxs = [j for j, _ in kept.values()]
    layer = None
    if job.trace:
        layer = SimpleNamespace(window=win, steps=win.steps, spans={},
                                flops_per_step=lambda: flops_per_call(job),
                                k1_calls=[])
    del model, forward, kept
    gc.collect()
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    refs = reference_outputs(job, pool, idxs)
    return SimpleNamespace(
        setup_s=setup_s,
        end_to_end={"infer_frames_per_s": frames / win.elapsed},
        memory_peak_bytes=max(peak, setup_peak), attempted=win.steps, layer=layer,
        readings=readings(outs, refs))


def control_readings(job, mode: str = "tf32") -> dict:
    """One seed's readings after a window: the program's sampled outputs
    and the control's (the reference in precision ``mode``), each against
    the float32 reference."""
    model, pool, forward = build_program(job)
    for b in pool[:int(job.cell.traffic["warmup_batches"])]:
        forward(b)
    win, kept = _window(job, forward, pool)
    outs = [{k: v.cpu() for k, v in o.items()} for _, o in kept.values()]
    idxs = [j for j, _ in kept.values()]
    del model, forward, kept
    gc.collect()
    refs = reference_outputs(job, pool, idxs)
    return {"program": readings(outs, refs),
            "mode": mode,
            "control": readings(reference_outputs(job, pool, idxs, mode), refs)}
