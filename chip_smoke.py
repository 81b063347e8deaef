#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the repository root, one card

Phases, each printing one JSON line; a failing phase raises and the script
exits non-zero:

  1. device  - the card's name, ``nvidia-smi`` name and power limit; TF32 is
               switched off for matmuls and cuDNN convolutions, so every
               comparison below is float32 against float32.
  2. build   - compile every CUDA kernel from ``slotformer_tpu_torch/kernels/csrc``
               (one ``nvcc`` per source, all started together); prints each
               kernel's registers and spills as ``ptxas`` reports them.
  3. kernel  - kernel K1 against its plain PyTorch version on the card at the
               CLEVRER extraction shape, a ragged N, S=8 and the training
               batch (B=64); a second call must give the same bits; times
               both (K1 on weights packed beforehand, as the model calls
               it, and with the packing inside every call), K1 also with k
               and v cold in the L2 cache, the host's time to enqueue a
               call, and the split of K1's device time between its sweep and
               its slot-side kernels.
  4. kernel_update - kernel K2 against its plain version at the extraction
               shape, a ragged N with S=5 and the training batch, in values
               and in gradients through its ``autograd.Function``; a second
               call must give the same bits; times both, and the split
               between its sweep and its finishing pass; then drives K2's
               entry point once (forward and backward) with its launch
               count reset.
  5. extract - the port's ``extract_video_slots`` with the full-width
               ``stosavi_clevrer`` config (random weights from a seed) over
               synthetic 64x64 videos, chunked with slot carry-over; checks
               the K1 launch count, and the same encode with K1 swapped for
               its plain version; times the weight packing (once per
               encode) against the K1 calls.
  6. train   - StoSAVi training at the full-width ``stosavi_clevrer`` config
               on synthetic clips: one train step on the card against the
               same step on the CPU and against the card with K1 swapped for
               its plain version (losses and every gradient); then
               ``cli.train.run`` (what ``python -m slotformer_tpu_torch.cli.train``
               runs) for one epoch at B=64, checking the K1 launch count,
               finite losses and a checkpoint that reloads; then steps/s and
               a profiled step (forward/backward/optimizer split, the
               device idle share, K1 forward and backward shares).
  7. rollout - ``SlotFormer.rollout(decode=True)`` at the full-width
               ``slotformer_clevrer`` config, B=16, 6 burn-in + 48 rollout
               steps, decoded to 64x64 (the shape ``bench.py`` times), then
               ``interleaved_rollout`` on the extracted slots.

Then a line of constants for comparison (each kernel's time at the same case
before it was redesigned for the H100, measured by an earlier version of this
script on an NVIDIA H100 80GB HBM3 at 700 W; K1's included the weight packing
in every call), the card's ``nvidia-smi`` line, the kernels line (K1 at the
training shape, with its launches in ``fit``; K2 at the extraction shape, with
its launches through its entry point; every number measured in this run but
``bound_ms``, which is computed), and as the last line
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
# K2 (tests/test_pallas_ops.py's tolerances): the attention is a softmax in
# [0, 1]; the updates are weighted means of O(1) values over N pixels. Its
# gradients come from the same plain backward on both sides and differ only
# through the upstream gradients of the two forwards.
K2_ATTN_ATOL, K2_UPD_ATOL, K2_GRAD_RTOL, K2_GRAD_ATOL = 1e-5, 1e-4, 1e-4, 1e-5
# One StoSAVi train step, float32 on both sides: the losses, and each
# parameter's gradient relative to that gradient's largest entry. The sums
# (convolutions over 64x64 frames, N=4096 pixels per slot-attention round)
# run in other orders on the card and on the CPU, and the differences pass
# through 6 recurrent frame steps and back.
TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL = 1e-4, 1e-3
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


def kernel_split_ms(fn, parts, iters: int = 10):
    """Device ms per call of ``fn`` spent in the kernels whose name contains
    each of ``parts``, summed by ``torch.profiler``."""
    import torch
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return {p: sum(e.self_device_time_total for e in kernels if p in e.key)
            / 1e3 / iters for p in parts}


def host_enqueue_ms(fn, iters: int = 100) -> float:
    """Host ms per call of ``fn`` to check its input and enqueue its work,
    the device's time not waited for."""
    import torch

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e3 * dt / iters


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


def k2_bound(B, N, D, S):
    """Least time for K2's work: k and v read once, q read, attn and upd
    written once, against its 4*B*N*S*D FLOP at the float32 peak."""
    nbytes = 4 * (2 * B * N * D + B * S * D + B * N * S + B * S * D)
    flops = 4 * B * N * S * D
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
    import torch

    from slotformer_tpu_torch.kernels import slot_attention as k1

    results = {}
    for tag, (B, N, D, S, H) in (("clevrer", (8, 4096, 128, 7, 256)),
                                 ("ragged_n", (8, 1000, 128, 5, 256)),
                                 ("eight_slots", (4, 4096, 128, 8, 256)),
                                 ("train_batch", (64, 4096, 128, 7, 256))):
        k, v, slots, wp = k1_inputs(B, N, D, S, H, seed=len(results))
        args = (k, v, slots, wp, 2, S, D ** -0.5, 1e-6)
        got = k1.fused_slot_attention(*args)
        again = k1.fused_slot_attention(*args)
        want = k1.fused_slot_attention_plain(*args)
        torch.cuda.synchronize()
        bit_stable = all(torch.equal(a, b) for a, b in zip(got, again))
        err_slots = (got[0] - want[0]).abs().max().item()
        err_attn = (got[1] - want[1]).abs().max().item()
        packed = k1.pack_weights(wp)
        call = lambda: k1.fused_slot_attention(k, v, slots, packed, *args[4:])  # noqa: E731
        ms = cuda_ms(call)
        host_ms = host_enqueue_ms(call)
        unpacked_ms = cuda_ms(lambda: k1.fused_slot_attention(*args))
        plain_ms = cuda_ms(lambda: k1.fused_slot_attention_plain(*args))
        split = kernel_split_ms(
            call,
            ("fused_slot_attention_sweep_kernel", "fused_slot_attention_slot_kernel"))
        bound_ms, bound_by = k1_bound(B, N, D, S, H, 2)
        extra = {}
        if tag in ("clevrer", "train_batch"):
            # k and v cold in the 50 MB L2, as a caller that has just produced
            # the k and v of many frames finds them: rotate over input sets
            # of more than 100 MB in all
            n_sets = max(2, -(-120_000_000 // (2 * k.numel() * 4)))
            sets = [(torch.randn_like(k), torch.randn_like(v))
                    for _ in range(n_sets)]
            turn = iter(range(10 ** 9))

            def cold_call():
                kk, vv = sets[next(turn) % n_sets]
                k1.fused_slot_attention(kk, vv, slots, packed, *args[4:])

            extra["cold_l2_ms"] = cuda_ms(cold_call, iters=4 * n_sets)
            del sets
        ok = (err_slots <= K1_SLOTS_ATOL and err_attn <= K1_ATTN_ATOL
              and bit_stable)
        emit(phase="kernel", name="fused_slot_attention", case=tag,
             shape=dict(B=B, N=N, D=D, S=S, H=H, iterations=2),
             max_abs_err_slots=err_slots, max_abs_err_attn=err_attn,
             tol_slots=K1_SLOTS_ATOL, tol_attn=K1_ATTN_ATOL,
             bit_stable=bit_stable, ms=ms, host_enqueue_ms=host_ms,
             ms_packing_each_call=unpacked_ms,
             sweep_kernels_ms=split["fused_slot_attention_sweep_kernel"],
             slot_kernels_ms=split["fused_slot_attention_slot_kernel"],
             plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
             **extra, ok=ok)
        if not ok:
            raise AssertionError(f"K1 disagrees with its plain version or "
                                 f"with itself ({tag})")
        results[tag] = dict(max_abs_err=max(err_slots, err_attn), ms=ms,
                            plain_ms=plain_ms, bound_ms=bound_ms,
                            bound_by=bound_by)
    return results


def phase_kernel_update():
    import importlib

    import torch

    from slotformer_tpu_torch.kernels import slot_attention_update

    k2 = importlib.import_module(
        "slotformer_tpu_torch.kernels.slot_attention_update")
    results = {}
    for tag, (B, N, D, S) in (("clevrer", (8, 4096, 128, 7)),
                              ("ragged_n", (8, 1000, 128, 5)),
                              ("train_batch", (64, 4096, 128, 7))):
        g = torch.Generator().manual_seed(10 + len(results))
        k, v = (torch.randn(B, N, D, generator=g).cuda() for _ in range(2))
        q = (torch.randn(B, S, D, generator=g) * D ** -0.5).cuda()
        upd, attn = slot_attention_update(k, v, q)
        again = slot_attention_update(k, v, q)
        want_upd, want_attn = k2.slot_attention_update_plain(k, v, q)
        torch.cuda.synchronize()
        bit_stable = torch.equal(again[0], upd) and torch.equal(again[1], attn)
        err_upd = (upd - want_upd).abs().max().item()
        err_attn = (attn - want_attn).abs().max().item()

        def grads(fn):
            xs = [x.clone().requires_grad_(True) for x in (k, v, q)]
            u, a = fn(*xs)
            return torch.autograd.grad((u ** 2).sum() + (a ** 3).sum(), xs)

        got_g = grads(slot_attention_update)
        want_g = grads(k2.slot_attention_update_plain)
        err_grad = max((a - b).abs().max().item() for a, b in zip(got_g, want_g))
        grads_ok = all(torch.allclose(a, b, rtol=K2_GRAD_RTOL, atol=K2_GRAD_ATOL)
                       for a, b in zip(got_g, want_g))
        ms = cuda_ms(lambda: slot_attention_update(k, v, q))
        host_ms = host_enqueue_ms(lambda: slot_attention_update(k, v, q))
        plain_ms = cuda_ms(lambda: k2.slot_attention_update_plain(k, v, q))
        split = kernel_split_ms(
            lambda: slot_attention_update(k, v, q),
            ("slot_attention_update_sweep_kernel",
             "slot_attention_update_finish_kernel"))
        bound_ms, bound_by = k2_bound(B, N, D, S)
        ok = (err_upd <= K2_UPD_ATOL and err_attn <= K2_ATTN_ATOL and grads_ok
              and bit_stable)
        emit(phase="kernel_update", name="slot_attention_update", case=tag,
             shape=dict(B=B, N=N, D=D, S=S), max_abs_err_upd=err_upd,
             max_abs_err_attn=err_attn, max_abs_err_grads=err_grad,
             tol_upd=K2_UPD_ATOL, tol_attn=K2_ATTN_ATOL,
             tol_grads=dict(rtol=K2_GRAD_RTOL, atol=K2_GRAD_ATOL),
             bit_stable=bit_stable, ms=ms, host_enqueue_ms=host_ms,
             sweep_kernel_ms=split["slot_attention_update_sweep_kernel"],
             finish_kernel_ms=split["slot_attention_update_finish_kernel"],
             plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, ok=ok)
        if not ok:
            raise AssertionError(f"K2 disagrees with its plain version or "
                                 f"with itself ({tag})")
        results[tag] = dict(max_abs_err=max(err_upd, err_attn), ms=ms,
                            plain_ms=plain_ms, bound_ms=bound_ms,
                            bound_by=bound_by)

    # K2's own path: its entry point, as a user calls it, forward + backward
    B, N, D, S = 8, 4096, 128, 7
    g = torch.Generator().manual_seed(20)
    k, v = (torch.randn(B, N, D, generator=g).cuda().requires_grad_(True)
            for _ in range(2))
    q = (torch.randn(B, S, D, generator=g) * D ** -0.5).cuda().requires_grad_(True)
    k2.LAUNCHES = 0
    upd, attn = slot_attention_update(k, v, q)
    (upd.square().sum() + attn.square().sum()).backward()
    torch.cuda.synchronize()
    launches = k2.LAUNCHES
    finite = all(torch.isfinite(x).all().item()
                 for x in (upd, attn, k.grad, v.grad, q.grad))
    rows_ok = torch.allclose(attn.sum(-1), torch.ones(B, N, device="cuda"),
                             atol=1e-5)
    ok = launches == 1 and finite and rows_ok
    emit(phase="kernel_update", case="entry_point", shape=dict(B=B, N=N, D=D, S=S),
         launches=launches, finite=finite, attn_rows_sum_to_1=rows_ok, ok=ok)
    if not ok:
        raise AssertionError("K2 entry point check failed")
    return results, launches


def phase_extract(k1_ms):
    """``k1_ms``: one K1 call at the extraction shape, from the kernel phase."""
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
    slot_attention = model.cell.slot_attention
    with mock.patch.object(slot_attention, "packed_weights",
                           wraps=slot_attention.packed_weights) as packs:
        slots, dt = wall_s(run)
    launches = k1.LAUNCHES
    pack_calls = packs.call_count
    n_packs = 50
    _, pack_dt = wall_s(lambda: [slot_attention.packed_weights()
                                 for _ in range(n_packs)])
    frame_steps = -(-n_videos // batch_size) * T
    with mock.patch.object(sa_module, "fused_slot_attention",
                           k1.fused_slot_attention_plain):
        plain = run()
    err = max(float(np.abs(slots[n] - plain[n]).max()) for n in slots)
    shapes_ok = all(s.shape == (T, 7, 128) and s.dtype == np.float32
                    for s in slots.values()) and len(slots) == n_videos
    finite = all(np.isfinite(s).all() for s in slots.values())
    encodes = -(-n_videos // batch_size) * -(-T // chunk_len)
    ok = (shapes_ok and finite and launches == frame_steps
          and pack_calls == encodes and err <= EXTRACT_ATOL)
    emit(phase="extract", config="stosavi_clevrer", videos=n_videos, frames=T,
         batch_size=batch_size, chunk_len=chunk_len, seconds=dt,
         frames_per_s=n_videos * T / dt, k1_launches=launches,
         frame_steps=frame_steps, max_abs_err_vs_plain=err, tol=EXTRACT_ATOL,
         finite=finite, shapes_ok=shapes_ok,
         pack_weights=dict(calls=pack_calls, encodes=encodes,
                           ms_each=1e3 * pack_dt / n_packs,
                           ms_in_run=1e3 * pack_dt / n_packs * pack_calls),
         k1=dict(calls=launches, ms_each=k1_ms, ms_in_run=k1_ms * launches,
                 share_of_run=k1_ms * launches / (1e3 * dt)),
         ok=ok)
    if not ok:
        raise AssertionError("extraction check failed")
    return slots, launches


def _grad_errors(got, want):
    """Worst max|got - want| / max|want| over the parameters, and its name."""
    worst = (0.0, "")
    for name, w in want.items():
        rel = (got[name] - w).abs().max().item() / max(w.abs().max().item(), 1e-6)
        worst = max(worst, (rel, name))
    return worst


def phase_train():
    import tempfile
    from unittest import mock

    import numpy as np
    import torch
    from torch.autograd import DeviceType

    from slotformer_tpu_torch.cli import train as train_cli
    from slotformer_tpu_torch.datasets import build_dataset
    from slotformer_tpu_torch.kernels import slot_attention as k1
    from slotformer_tpu_torch.methods import build_method
    from slotformer_tpu_torch.models import build_model
    from slotformer_tpu_torch.models import slot_attention as sa_module
    from slotformer_tpu_torch.runtime import (BaseDataModule, latest_checkpoint,
                                              load_params)

    params = load_params(os.path.join(CONFIGS, "stosavi_clevrer_params.py"))
    # synthetic 64x64 clips (the CLEVRER videos are not in the repository):
    # 32 videos x 15 clip starts = 480 clips = 7 steps of 64
    params.dataset = "synthetic"
    params.num_videos_train = 32
    params.max_epochs = 1
    params.print_iter = 1  # a log line per step: the losses checked below
    weights = params.loss_weights()
    T = params.n_sample_frames

    # (a)/(b) one train step at B=2: card vs CPU, and K1 vs its plain version
    train_set, _ = build_dataset(params)
    img = np.stack([train_set[i]["img"] for i in (0, 100)])
    S, D = params.slot_dict["num_slots"], params.slot_dict["slot_size"]
    eps = np.random.default_rng(0).standard_normal((2, T, S, D)).astype(np.float32)
    torch.manual_seed(2)
    gpu = build_model(params, device="cuda")
    cpu = build_model(params, device="cpu")
    cpu.load_state_dict(gpu.state_dict())

    def one_step(model, device):
        model.train()
        model.zero_grad(set_to_none=True)
        losses = model.train_loss({"img": torch.from_numpy(img).to(device),
                                   "sample_eps": torch.from_numpy(eps).to(device)})
        sum(weights.get(n, 1.0) * v for n, v in losses.items()).backward()
        return ({n: v.item() for n, v in losses.items()},
                {n: p.grad.detach().cpu() for n, p in model.named_parameters()})

    l_cpu, g_cpu = one_step(cpu, "cpu")
    l_gpu, g_gpu = one_step(gpu, "cuda")
    with mock.patch.object(sa_module, "fused_slot_attention",
                           k1.fused_slot_attention_plain):
        l_plain, g_plain = one_step(gpu, "cuda")
    loss_err_cpu = max(abs(l_gpu[n] / l_cpu[n] - 1) for n in l_cpu)
    loss_err_plain = max(abs(l_gpu[n] / l_plain[n] - 1) for n in l_plain)
    grad_err_cpu, worst_cpu = _grad_errors(g_gpu, g_cpu)
    grad_err_plain, worst_plain = _grad_errors(g_gpu, g_plain)
    step_ok = (max(loss_err_cpu, loss_err_plain) <= TRAIN_LOSS_RTOL
               and max(grad_err_cpu, grad_err_plain) <= TRAIN_GRAD_RTOL)
    emit(phase="train", check="one_step", batch=2, losses_card=l_gpu,
         losses_cpu=l_cpu, loss_rel_err_vs_cpu=loss_err_cpu,
         loss_rel_err_vs_plain_k1=loss_err_plain,
         grad_rel_err_vs_cpu=grad_err_cpu, worst_param_vs_cpu=worst_cpu,
         grad_rel_err_vs_plain_k1=grad_err_plain,
         worst_param_vs_plain_k1=worst_plain, n_params=len(g_cpu),
         tol_loss_rtol=TRAIN_LOSS_RTOL, tol_grad_rel=TRAIN_GRAD_RTOL,
         ok=step_ok)
    if not step_ok:
        raise AssertionError("train step: card disagrees with the CPU or "
                             "with the plain K1")
    del gpu, cpu

    # (c) fit at B=64 through the CLI's code
    with tempfile.TemporaryDirectory() as ckp:
        params.seed = 0
        k1.LAUNCHES = 0
        method, fit_s = wall_s(lambda: train_cli.run(
            params, ckp, device="cuda", san_check_val_step=1))
        launches, steps = k1.LAUNCHES, method.it
        val_batches = 1 + len(method.val_loader)  # sanity check + epoch end
        expected = T * (steps + val_batches)
        with open(os.path.join(ckp, "log.jsonl")) as f:
            log = [json.loads(line) for line in f]
        train_log = [r for r in log if r["phase"] == "train"]
        finite = bool(train_log) and all(
            np.isfinite(r[k]) for r in log for k in r
            if k.endswith("loss") or k == "grad_norm")
        last = latest_checkpoint(ckp)
        torch.manual_seed(123)
        fresh = build_method(model=build_model(params, device="cuda"),
                             datamodule=BaseDataModule(params, *build_dataset(params)),
                             params=params, ckp_path=ckp)
        fresh.load_ckp(last)
        reloaded = fresh.it == steps and all(
            torch.equal(a, b) for a, b in zip(method.model.state_dict().values(),
                                              fresh.model.state_dict().values()))
        del fresh

        # steady-state steps/s, then one profiled step
        batch = next(iter(method.train_loader))
        method._train_step(batch)
        n_steps = 5
        _, dt = wall_s(lambda: [method._train_step(batch) for _ in range(n_steps)])
        model, opt = method.model, method.optimizer
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        with torch.profiler.profile(activities=acts) as prof:
            model.train()
            db = method._to_device(batch)
            ev[0].record()
            losses = model.train_loss(db, generator=method.generator)
            total = sum(weights.get(n, 1.0) * v for n, v in losses.items())
            ev[1].record()
            total.backward()
            ev[2].record()
            opt.step(method.it)
            opt.zero_grad()
            ev[3].record()
            torch.cuda.synchronize()
        fwd_ms, bwd_ms, opt_ms = (ev[i].elapsed_time(ev[i + 1]) for i in range(3))
        # device time of the kernels themselves (the CPU ops that launched
        # them carry the same time and are left out)
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA]
        device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        k1_ms = sum(e.self_device_time_total for e in kernels
                    if "fused_slot_attention_" in e.key) / 1e3
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
        top_kernels = [(e.key[:80], e.count, e.self_device_time_total / 1e3)
                       for e in top]
    ok = (steps == 7 and launches == expected and finite and reloaded
          and last is not None and last.endswith(f"model_{steps}.pth"))
    step_ms = fwd_ms + bwd_ms + opt_ms

    # K1's backward (autograd of its plain version) at the training shape,
    # once per frame step of the train step
    S, D, H = 7, 128, params.slot_dict["slot_mlp_size"]
    k, v, slots, wp = k1_inputs(64, 4096, D, S, H, seed=5)
    xs = [k, v, slots] + [wp[n] for n in k1.WP_KEYS]
    for x in xs:
        x.requires_grad_(True)
    out = k1.fused_slot_attention(k, v, slots, dict(zip(k1.WP_KEYS, xs[3:])),
                                  2, S, D ** -0.5, 1e-6)
    g_out = [torch.randn_like(o) for o in out]
    k1_bwd_ms = cuda_ms(lambda: torch.autograd.grad(out, xs, g_out,
                                                    retain_graph=True))
    emit(phase="train", check="fit", config="stosavi_clevrer", batch=64,
         frames_per_clip=T, steps=steps, fit_seconds=fit_s,
         k1_launches=launches, k1_launches_expected=expected,
         val_batches=val_batches, finite=finite, checkpoint=os.path.basename(last),
         reloaded=reloaded, last_train=train_log[-1] if train_log else None,
         steps_per_s=n_steps / dt, frames_per_s=n_steps * 64 * T / dt,
         profiled_step=dict(forward_ms=fwd_ms, backward_ms=bwd_ms,
                            optimizer_ms=opt_ms,
                            backward_share=bwd_ms / step_ms,
                            device_busy_ms=device_ms,
                            device_idle_share=1 - device_ms / step_ms,
                            k1_forward_kernel_ms=k1_ms,
                            k1_forward_share=k1_ms / step_ms,
                            k1_backward_ms=T * k1_bwd_ms,
                            k1_backward_share=T * k1_bwd_ms / step_ms,
                            top_kernels_name_count_ms=top_kernels),
         ok=ok)
    if not ok:
        raise AssertionError("training check failed")
    return launches


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
    ptxas = [line.strip() for name in build.KERNEL_SOURCES
             for line in build.build_log(name).splitlines()
             if "Compiling entry function" in line or "registers" in line
             or "spill" in line]
    emit(phase="build", sources=list(build.KERNEL_SOURCES),
         seconds=time.perf_counter() - t0, ptxas=ptxas)

    k1_results = phase_kernel()
    k2_results, k2_launches = phase_kernel_update()
    slots, extract_launches = phase_extract(k1_results["clevrer"]["ms"])
    train_launches = phase_train()
    phase_rollout(slots)

    # not measured here: what the earlier kernels took at the cases of the
    # kernels line (K1 with its weights packed inside every call, as
    # ms_packing_each_call above still times it)
    emit(phase="record", what="ms before the H100 redesign, same cases, NVIDIA "
         "H100 80GB HBM3 at 700 W, from this script's earlier version",
         previous_ms=dict(fused_slot_attention=2.276,
                          slot_attention_update=0.0911))
    print(smi, flush=True)
    k1, k2 = k1_results["train_batch"], k2_results["clevrer"]
    emit(kernels=[
        dict(name="fused_slot_attention", route="cuda",
             source="slotformer_tpu_torch/kernels/csrc/slot_attention.cu",
             replaces="slotformer_tpu/ops/slot_attention_kernel.py:284",
             case="train_batch", launches=train_launches,
             launches_by_path=dict(train=train_launches,
                                   extract=extract_launches),
             max_abs_err=k1["max_abs_err"], ms=k1["ms"],
             plain_ms=k1["plain_ms"], bound_ms=k1["bound_ms"],
             bound_by=k1["bound_by"], library_ms=None),
        dict(name="slot_attention_update", route="cuda",
             source="slotformer_tpu_torch/kernels/csrc/slot_attention_update.cu",
             replaces="slotformer_tpu/ops/slot_attention_kernel.py:87",
             case="clevrer", launches=k2_launches,
             launches_by_path=dict(entry_point=k2_launches),
             max_abs_err=k2["max_abs_err"], ms=k2["ms"],
             plain_ms=k2["plain_ms"], bound_ms=k2["bound_ms"],
             bound_by=k2["bound_by"], library_ms=None)])
    emit(ok=True, device=dict(platform="gpu", kind=kind,
                              count=torch.cuda.device_count()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
