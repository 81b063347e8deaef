#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the repository root, one card

Phases, each printing one JSON line; a failing phase raises and the script
exits non-zero:

  1. device  - the card's name, ``nvidia-smi`` name and power limit; TF32 is
               switched off for matmuls and cuDNN convolutions, so every
               comparison below is float32 against float32.
  2. build   - compile every CUDA kernel from ``slotformer_tpu_torch/kernels/csrc``.
  3. kernel  - kernel K1 against its plain PyTorch version on the card at the
               CLEVRER extraction shape, a ragged N and S=8; times both.
  4. extract - the port's ``extract_video_slots`` with the full-width
               ``stosavi_clevrer`` config (random weights from a seed) over
               synthetic 64x64 videos, chunked with slot carry-over; checks
               the K1 launch count, and the same encode with K1 swapped for
               its plain version.
  5. rollout - ``SlotFormer.rollout(decode=True)`` at the full-width
               ``slotformer_clevrer`` config, B=16, 6 burn-in + 48 rollout
               steps, decoded to 64x64 (the shape ``bench.py`` times), then
               ``interleaved_rollout`` on the extracted slots.

Then the card's ``nvidia-smi`` line, the kernels line, and as the last line
``{"ok": true, "device": {...}}``. Without a CUDA device it exits 1 and
prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

# K1 tolerances. Both sides are float32 with TF32 off but sum in different
# orders: the attention is a softmax in [0, 1] (rounding ~1e-7), the slots
# are O(1) after two GRU/MLP rounds (rounding ~1e-6).
K1_SLOTS_ATOL, K1_ATTN_ATOL = 1e-4, 1e-5
# The extraction runs 24 recurrent frame steps, each feeding the last one's
# slots (through the predictor and the kernel head) into the next K1 call,
# so the per-call differences of ~1e-6 may accumulate.
EXTRACT_ATOL = 1e-4
# The rollout on the card against the same model on the CPU: 4 transformer
# layers over 2 autoregressive steps and the decoder, float32 on both.
ROLLOUT_ATOL = 1e-4
CONFIGS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "slotformer_tpu_torch", "configs")
# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM bytes/s and
# float32 FLOP/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def wall_s(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def k1_bound(B, N, D, S, H, iters):
    """Least time for K1's work: each input read once and each output
    written once over HBM, against its multiply-adds (logits, weighted sum,
    q projection, GRU, MLP) at the float32 peak."""
    weights = D * D + 6 * D * D + 2 * D * H + H + 9 * D
    nbytes = 4 * (2 * B * N * D + B * S * D + weights + B * S * D + B * N * S)
    flops = iters * (4 * B * N * S * D + 2 * B * S * D * D
                     + 12 * B * S * D * D + 4 * B * S * D * H)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def k1_inputs(B, N, D, S, H, seed):
    import torch

    from slotformer_tpu_torch.kernels import slot_attention as k1

    g = torch.Generator().manual_seed(seed)
    shapes = dict(wq=(D, D), w1=(D, H), b1=(H,), w2=(H, D))
    wp = {}
    for n in k1.WP_KEYS:
        shape = shapes.get(n, (D, D) if n.startswith("w_") else (D,))
        w = torch.randn(shape, generator=g)
        wp[n] = (w * shape[0] ** -0.5 if len(shape) == 2 else 0.1 * w).cuda()
    wp["q_ln_scale"] += 1.0
    wp["mlp_ln_scale"] += 1.0
    k, v, slots = (torch.randn(s, generator=g).cuda()
                   for s in ((B, N, D), (B, N, D), (B, S, D)))
    return k, v, slots, wp


def phase_kernel():
    from slotformer_tpu_torch.kernels import slot_attention as k1

    results = {}
    for tag, (B, N, D, S, H) in (("clevrer", (8, 4096, 128, 7, 256)),
                                 ("ragged_n", (8, 1000, 128, 5, 256)),
                                 ("eight_slots", (4, 4096, 128, 8, 256))):
        k, v, slots, wp = k1_inputs(B, N, D, S, H, seed=len(results))
        args = (k, v, slots, wp, 2, S, D ** -0.5, 1e-6)
        got = k1.fused_slot_attention(*args)
        want = k1.fused_slot_attention_plain(*args)
        err_slots = (got[0] - want[0]).abs().max().item()
        err_attn = (got[1] - want[1]).abs().max().item()
        ms = cuda_ms(lambda: k1.fused_slot_attention(*args))
        plain_ms = cuda_ms(lambda: k1.fused_slot_attention_plain(*args))
        bound_ms, bound_by = k1_bound(B, N, D, S, H, 2)
        ok = err_slots <= K1_SLOTS_ATOL and err_attn <= K1_ATTN_ATOL
        emit(phase="kernel", name="fused_slot_attention", case=tag,
             shape=dict(B=B, N=N, D=D, S=S, H=H, iterations=2),
             max_abs_err_slots=err_slots, max_abs_err_attn=err_attn,
             tol_slots=K1_SLOTS_ATOL, tol_attn=K1_ATTN_ATOL, ms=ms,
             plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, ok=ok)
        if not ok:
            raise AssertionError(f"K1 disagrees with its plain version ({tag})")
        results[tag] = dict(max_abs_err=max(err_slots, err_attn), ms=ms,
                            plain_ms=plain_ms, bound_ms=bound_ms,
                            bound_by=bound_by)
    return results["clevrer"]


def phase_extract():
    from unittest import mock

    import numpy as np
    import torch

    from slotformer_tpu_torch.cli.extract_slots import extract_video_slots
    from slotformer_tpu_torch.datasets import SyntheticVideoDataset
    from slotformer_tpu_torch.kernels import slot_attention as k1
    from slotformer_tpu_torch.models import build_model
    from slotformer_tpu_torch.models import slot_attention as sa_module
    from slotformer_tpu_torch.runtime import load_params

    params = load_params(os.path.join(CONFIGS, "stosavi_clevrer_params.py"))
    torch.manual_seed(0)
    model = build_model(params, device="cuda")
    n_videos, T, batch_size, chunk_len = 8, 24, 8, 12
    ds = SyntheticVideoDataset("val", num_videos=n_videos, video_len=T,
                               resolution=params.resolution)
    run = lambda: extract_video_slots(model, ds, batch_size, chunk_len, seed=0)  # noqa: E731
    run()  # warm-up: cuDNN algorithm choice, allocator
    k1.LAUNCHES = 0
    slots, dt = wall_s(run)
    launches = k1.LAUNCHES
    frame_steps = -(-n_videos // batch_size) * T
    with mock.patch.object(sa_module, "fused_slot_attention",
                           k1.fused_slot_attention_plain):
        plain = run()
    err = max(float(np.abs(slots[n] - plain[n]).max()) for n in slots)
    shapes_ok = all(s.shape == (T, 7, 128) and s.dtype == np.float32
                    for s in slots.values()) and len(slots) == n_videos
    finite = all(np.isfinite(s).all() for s in slots.values())
    ok = shapes_ok and finite and launches == frame_steps and err <= EXTRACT_ATOL
    emit(phase="extract", config="stosavi_clevrer", videos=n_videos, frames=T,
         batch_size=batch_size, chunk_len=chunk_len, seconds=dt,
         frames_per_s=n_videos * T / dt, k1_launches=launches,
         frame_steps=frame_steps, max_abs_err_vs_plain=err, tol=EXTRACT_ATOL,
         finite=finite, shapes_ok=shapes_ok, ok=ok)
    if not ok:
        raise AssertionError("extraction check failed")
    return slots, launches


def phase_rollout(slots_dict):
    import numpy as np
    import torch

    from slotformer_tpu_torch.cli.rollout_slots import interleaved_rollout
    from slotformer_tpu_torch.models import build_model
    from slotformer_tpu_torch.runtime import load_params

    params = load_params(os.path.join(CONFIGS, "slotformer_clevrer_params.py"))
    torch.manual_seed(1)
    model = build_model(params, device="cuda")
    B, history, pred_len = 16, 6, 48
    vids = np.stack([slots_dict[n] for n in sorted(slots_dict)])
    past = torch.from_numpy(np.concatenate([vids, vids])[:B, :history]).cuda()
    run = lambda: model.rollout(past, pred_len, decode=True, with_gt=False)  # noqa: E731
    with torch.inference_mode():
        run()  # warm-up
        out, dt = wall_s(run)
        small_gpu = model.rollout(past[:1], 2, decode=True, with_gt=False)
    cpu_model = build_model(params, device="cpu")
    cpu_model.load_state_dict(model.state_dict())
    with torch.inference_mode():
        small_cpu = cpu_model.rollout(past[:1].cpu(), 2, decode=True,
                                      with_gt=False)
    err = max((small_gpu[k].cpu() - small_cpu[k]).abs().max().item()
              for k in ("slots", "recon_combined"))
    shapes = {k: list(v.shape) for k, v in out.items()}
    shapes_ok = (shapes["recon_combined"] == [B, pred_len, 64, 64, 3]
                 and shapes["slots"] == [B, pred_len, 7, 128]
                 and shapes["masks"] == [B, pred_len, 7, 64, 64, 1])
    finite = all(torch.isfinite(v).all().item() for v in out.values())

    obs, target = 12, 24
    rolled = interleaved_rollout(model, slots_dict, obs, target, history,
                                 params.frame_offset, batch_size=8)
    rolled_ok = all(
        r.shape == (target, 7, 128) and np.isfinite(r).all()
        and np.array_equal(r[:obs], slots_dict[n][:obs])
        for n, r in rolled.items()) and len(rolled) == len(slots_dict)
    ok = shapes_ok and finite and rolled_ok and err <= ROLLOUT_ATOL
    emit(phase="rollout", config="slotformer_clevrer", batch=B,
         history=history, rollout=pred_len, seconds=dt,
         frames_per_s=B * pred_len / dt, shapes=shapes, finite=finite,
         max_abs_err_vs_cpu=err, tol=ROLLOUT_ATOL,
         interleaved=dict(videos=len(rolled), obs=obs, target=target,
                          frame_offset=params.frame_offset, ok=rolled_ok),
         ok=ok)
    if not ok:
        raise AssertionError("rollout check failed")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script runs the port on an NVIDIA GPU",
              file=sys.stderr)
        return 1
    from slotformer_tpu_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit(phase="device", kind=kind, count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
         matmul_tf32=False, cudnn_tf32=False)

    t0 = time.perf_counter()
    build.build()
    emit(phase="build", sources=list(build.KERNEL_SOURCES),
         seconds=time.perf_counter() - t0)

    k1_result = phase_kernel()
    slots, launches = phase_extract()
    phase_rollout(slots)

    print(smi, flush=True)
    emit(kernels=[dict(
        name="fused_slot_attention", route="cuda",
        source="slotformer_tpu_torch/kernels/csrc/slot_attention.cu",
        replaces="slotformer_tpu/ops/slot_attention_kernel.py:284",
        launches=launches, max_abs_err=k1_result["max_abs_err"],
        ms=k1_result["ms"], plain_ms=k1_result["plain_ms"],
        bound_ms=k1_result["bound_ms"], bound_by=k1_result["bound_by"],
        library_ms=None)])
    emit(ok=True, device=dict(platform="gpu", kind=kind,
                              count=torch.cuda.device_count()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
