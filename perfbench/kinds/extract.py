"""Traffic kind ``extract``: offline slot extraction through
``cli/extract_slots.py::extract_video_slots``, one call a batch of whole
videos (``batch`` videos of ``video_len`` frames, chunks of ``chunk_len``
frames with the slots carried over, the CLI's defaults), over an in-memory
dataset of videos made from the seed.

A frame is one input frame encoded to slots. Each call's kernel noise comes
from a generator seeded with ``seed + call``. The window keeps a sample of
its calls' slots, drawn from the seed, and the reference encodes the same
videos with the same noise once the window has closed.
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


class Videos:
    """The dataset surface ``extract_video_slots`` reads: ``files``,
    ``get_video`` and ``load_video``."""

    def __init__(self, videos: np.ndarray, idxs):
        self.videos, self.idxs = videos, list(idxs)
        self.files = [f"video_{i:05d}.mp4" for i in self.idxs]
        self.load_video = False

    def get_video(self, j: int) -> dict:
        return {"video": self.videos[self.idxs[j]]}


def build_program(job):
    cell, dev = job.cell, job.device
    t = cell.traffic
    params = port_params(cell)
    params.load_mask = False
    sd = seeded_reference(cell, job.seed, dev)[1]
    model = port_model(params, dev)
    model.load_state_dict(sd)
    model.eval()
    job.mark("model")
    videos = make_batches(t["batch_spec"], batch_dims(cell, int(t["pool_videos"])),
                          1, job.seed + 1, dev)[0]["video"]
    from slotformer_tpu_torch.cli.extract_slots import extract_video_slots

    B = int(t["batch"])

    def call(i: int):
        idxs = [(i * B + k) % len(videos) for k in range(B)]
        out = extract_video_slots(model, Videos(videos, idxs), B,
                                  int(t["chunk_len"]), seed=job.seed + i)
        return idxs, [out[f"video_{j:05d}.mp4"] for j in idxs]

    return model, videos, call


def reference_outputs(job, videos, calls, mode: str = "float32") -> list:
    cell, dev = job.cell, job.device
    ref = seeded_reference(cell, job.seed, dev)[0].eval()
    out = []
    with precision(mode, dev), torch.no_grad():
        for i, idxs in calls:
            gen = torch.Generator(device=dev).manual_seed(job.seed + i)
            slots = ref.encode_video(torch.from_numpy(videos[idxs]).to(dev),
                                     int(cell.traffic["chunk_len"]), gen)
            out.append(slots.float().cpu().numpy())
    return out


def readings(outs: list, refs: list) -> dict:
    """Worst sampled video: its slots relative to their largest magnitude."""
    return {"slots_gap": max(gap(np.stack(o), r) for o, r in zip(outs, refs))}


def flops_per_call(job) -> int:
    cell = job.cell
    t = cell.traffic
    p = cell.config["params"]
    mod = reference_module(cell)
    with torch.device("meta"):
        ref = mod.build(p).eval().requires_grad_(False)
        video = torch.empty(int(t["batch"]), int(t["video_len"]),
                            p["resolution"][0], p["resolution"][1], 3)
    return count_flops(lambda: ref.encode_video(video, int(t["chunk_len"]), None))


def k1_calls(cell, calls: int):
    sa = cell.config.get("slot_attention")
    if not sa:
        return []
    t = cell.traffic
    chunk = int(t["chunk_len"])
    steps = -(-int(t["video_len"]) // chunk) * chunk  # the tail padded to a chunk
    return [(dict(sa, B=int(t["batch"])), calls * steps)]


def run(job):
    model, videos, call = build_program(job)
    dev = job.device
    t = job.cell.traffic
    job.mark("inputs")
    for i in range(int(t["warmup_batches"])):
        call(-1 - i)
        synchronize(dev)
        job.mark(f"warm-up {i + 1}")
    setup_s = time.time() - job.process_start
    setup_peak = peak_bytes(dev)
    if torch.device(dev).type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    win, kept = sampled_window(job, call)
    peak = peak_bytes(dev)
    frames = win.steps * int(t["batch"]) * int(t["video_len"])
    layer = None
    if job.trace:
        layer = SimpleNamespace(window=win, steps=win.steps, spans={},
                                flops_per_step=lambda: flops_per_call(job),
                                k1_calls=k1_calls(job.cell, win.steps))
    del model, call
    gc.collect()
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    calls = [(i, idxs) for i, (idxs, _) in kept.items()]
    refs = reference_outputs(job, videos, calls)
    return SimpleNamespace(
        setup_s=setup_s,
        end_to_end={"infer_frames_per_s": frames / win.elapsed},
        memory_peak_bytes=max(peak, setup_peak), attempted=win.steps, layer=layer,
        readings=readings([s for _, s in kept.values()], refs))


def control_readings(job, mode: str = "tf32") -> dict:
    """One seed's readings after a window: the program's sampled outputs
    and the control's (the reference in precision ``mode``), each against
    the float32 reference."""
    model, videos, call = build_program(job)
    for i in range(int(job.cell.traffic["warmup_batches"])):
        call(-1 - i)
    win, kept = sampled_window(job, call)
    del model, call
    gc.collect()
    calls = [(i, idxs) for i, (idxs, _) in kept.items()]
    refs = reference_outputs(job, videos, calls)
    outs = [s for _, s in kept.values()]
    return {"program": readings(outs, refs),
            "mode": mode,
            "control": readings(reference_outputs(job, videos, calls, mode), refs)}
