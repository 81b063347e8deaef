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
               CLEVRER extraction shape, a ragged N, S=8, the training
               batch (B=64), the STEVE extraction shape (B=8, N=4096,
               D=192, S=6, H=384), STEVE's training batch (B=48) and OBJ3D
               SAVi's training batch (B=64, D=128, S=6, H=256); a
               second call must give the same bits; times
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
     decoder_conv - kernel K3, the SAVi decoder's 5x5 stride-1 layer on
               the tensor cores (three TF32 products a float32 product), at
               the rollout call's 2352 images of 64x64 and at PHYRE's
               128x128: its forward and its input gradient against float64,
               beside cuDNN's float32 (TF32 off) on the same inputs; ms of
               K3 (forward and input gradient) beside its bound, the plain
               version's and ``F.conv_transpose2d`` + ReLU's (the yardstick:
               cuDNN, TF32 off); K3's launches in one CLEVRER decoder
               forward and in one step of its input gradient.
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
               a profiled step (forward/backward/optimizer split, K1
               forward and backward shares). Its
               checkpoint encodes the videos of ``vqa``.
  7. rollout - ``SlotFormer.rollout(decode=True)`` at the full-width
               ``slotformer_clevrer`` config, B=16, 6 burn-in + 48 rollout
               steps, decoded to 64x64 (the shape ``bench.py`` times), then
               ``interleaved_rollout`` on the extracted slots.
  8. slots_file - ``extract_video_slots`` with a full-width StoSAVi (random
               weights from a seed) over a train and a val split of
               synthetic 48-frame 64x64 videos, through K1, written as the
               ``{'train': ..., 'val': ...}`` slots file with ``dump_obj``;
               the StoSAVi checkpoint is the source of the grafted decoder.
               Counts the K1 launches of this path.
  9. train_slotformer - SlotFormer training at the full-width
               ``slotformer_clevrer`` config (7 slots x 128, d_model 256, 4
               layers, 8 heads, 6 burn-in + 10 rollout frames at frame
               offset 2, B=128) on that slots file: one step at B=2 on the
               card against the same step on the CPU for the plain, chunked
               and custom-backward image-loss branches (losses, every
               rollouter gradient, and d(loss)/d(pred_slots) between the
               branches), the bf16 branch against the card's own float32
               value; then ``cli.train.run`` for two epochs with the loss
               decay ramp on (finite losses, the factor in the log, the
               decoder bit-equal to the grafted checkpoint's, a checkpoint
               that reloads); then steps/s, a profiled step (rollouter
               forward, image loss, backward, optimizer, the largest
               kernels) and the time and peak memory of a
               step under each image-loss branch.
 10. test_vp - ``cli.test_vp.main`` on the val slots and the checkpoint just
               trained, 6 + 42 frames, batch 8, masks on: every metric
               finite, the trajectory path ran, ``percept_dist`` labelled
               untrained; one ``pred_eval_step`` on the card against the
               same call on the CPU; rollout frames/s with and without the
               metrics.
 11. vqa     - the Aloe VQA head on CLEVRER-shaped data: 12 synthetic
               128-frame 64x64 videos encoded through K1 by the StoSAVi
               ``train`` trained, extended to 160 frames by
               ``cli.rollout_slots --task clevrer`` on the SlotFormer
               ``train_slotformer`` trained, question files of vocab words
               and every question type; then for both shipped configs
               (``aloe_clevrer_params``, ground-truth slots, and its
               ``-rollout`` twin): one B=2 step card against CPU with
               dropout off; ``cli.train.run`` at full width (12 layers,
               d144, 208 tokens) for one epoch of 3 steps at B=256 rows with
               ``VQAMethod``'s question-level validation; steps/s, a
               profiled step and which attention back ends take its call
               (head width 18, a key-padding mask, float32);
               ``cli.test_clevrer_vqa`` on the test split (every question
               answered) and on val (agreeing with the trainer's
               validation); eval rows/s.
     Several ranks share the one card over gloo (NCCL refuses two ranks on
     one device), each a spawned process that loads the kernels built above:
     ddp_savi - (a) StoSAVi at the full ``stosavi_clevrer`` width, one step
               of the global batch of 64 as 2 x 32 with the same
               ``sample_eps`` as one process's step at B=64: losses and
               ``grad_norm`` at 1e-5 relative, parameters at max |d| <
               1e-4, K1 6 launches a rank; (b) ``cli.train --ddp`` at
               world size 1 on NCCL, torchrun's environment set for the
               child: 2 steps, the checkpoint reloads.
     tp_slotformer - the full-width ``slotformer_clevrer`` SlotFormer at
               tp_size 2 (in the same two ranks as (a)): one step of 8
               clips with dropout 0 and ``vid_len`` differing across rows,
               at (a)'s limits; its checkpoint loads in one process with
               equal tensors, and one process's on the two ranks.
     dryrun_multichip - ``entry.dryrun_multichip(4)``: a 2 x 2 grid, the
               tiny SlotFormer's step against one process.
     steps_per_call - SlotFormer at full width, 6 steps at B=64 with
               ``steps_per_call`` 4 (4 in one call, 2 left over) against 6
               single steps, deterministic cuDNN: equal parameters, the
               log at the JAX trainer's windows.
     convert  - the StoSAVi ``train`` trained, as a reference-layout
               ``.pth``, through ``cli.convert_reference_ckpt``: its
               slots on 4 videos equal the original weights'.
 12. obj3d_tree - a mini OBJ3D tree in a temporary directory, the working
               directory of the OBJ3D phases: 12 + 24 + 2 train/val/test
               videos of 51 64x64 PNG frames ``test_{i}.png``.
 13. train_savi_obj3d - the deterministic SAVi of ``savi_obj3d_params`` (6
               slots x 128, an LSTM-wrapped 2-layer transformer predictor,
               ``kld_method='none'``, B=64): one B=2 step card against CPU
               and against K1's plain version; ``cli.train.run`` for one
               epoch of 8 steps: K1 launches, finite losses, a zero KLD, a
               checkpoint that reloads (linked as
               ``pretrained/savi_obj3d_params/model.pth``); steps/s and a
               profiled step.
 14. obj3d_slots - that SAVi through ``extract_video_slots`` over every
               train and val video, written as ``data/OBJ3D/obj3d_slots.pkl``;
               K1 launches.
 15. train_slotformer_obj3d - the full-width ``slotformer_obj3d_params``
               SlotFormer (d128, 4 layers, 6 + 10 frames, B=128) on those
               slots, the decoder grafted through the config's own
               ``dec_ckp_path``: one B=2 step card against CPU;
               ``cli.train.run`` for one epoch of 3 steps, the decoder
               bit-frozen, a checkpoint that reloads; steps/s.
 16. test_vp_obj3d - ``cli.test_vp`` on that SlotFormer: 6 + 44 frames of
               every val video, batch 12, no masks; every metric finite, the
               mask metrics unscored; frames/s.
 17. physion_tree - a mini Physion tree in a temporary directory: frame
               folders of 150 128x128 frames rendered by the synthetic
               renderer (6 + 2 training videos, 2 + 2 readout videos) and
               split files, ``datasets.physion._SPLIT_DIR`` pointed at them.
 18. train_dvae - the full-width ``dvae_physion_params`` dVAE (vocab 4096,
               B=64) trained by ``cli.train.run`` for one epoch (14 steps
               over 6 x 150 frames): one B=2 step card against CPU on the
               same gumbel uniforms (losses, every gradient); tau along its
               schedule in the log, the sample video, a checkpoint that
               reloads; steps/s. Its checkpoint is the dVAE of every later
               phase.
 19. tokenize - that dVAE through ``cli.tokenize_images``: every token file
               [150, 1024] int32 in range; the dVAE card against CPU on 4
               frames (logits, ids up to a tie); frames/s.
 20. train_steve - the full-width ``steve_physion_params`` STEVE (6 slots x
               192, B=48, 6-frame clips, ``dec_lr``, clip 0.05) trained by
               ``cli.train.run`` for one epoch (18 steps) under bf16
               autocast on the loader's tokens, the dVAE grafted from its
               trainer's checkpoint: one float32 B=2 step card against CPU
               and against K1's plain version (losses, every gradient); the
               K1 launch count, K1's ``autograd.Function`` in every frame
               step, the dVAE bit-frozen, the token decoder moved, two
               param groups, a checkpoint that reloads; steps/s, peak
               memory, a float32 step beside a bf16 one, a profiled step
               (encoder, K1 forward, token decoder, backward, K1's
               backward, optimizer); K1's gradient at the
               training shape (48, 4096, 192, 6, 384) against plain
               autograd.
 21. steve_extract - that STEVE through ``cli.extract_slots`` on the
               training and readout subsets: K1 launched once per frame
               step per batch, the files and their ``{subset}_slots.pkl``
               links; one 6-frame clip at B=2 card against CPU and against
               K1's plain version on the card (slots and masks, per frame);
               frames/s and K1's share of the device trace.
 22. train_steve_slotformer - the full-width ``slotformer_physion_params``
               STEVESlotFormer (d256, 8 layers, 15 + 10 frames at frame
               offset 3, B=128) trained by ``cli.train.run`` for one epoch
               on the training subset's slots, STEVE's token decoder and
               dVAE grafted from its checkpoint: one B=2 step card against
               CPU; the grafted subtrees bit-frozen, the rollouter moved,
               the config's (absent) loss-decay ramp, a checkpoint that
               reloads; steps/s.
 23. steve_rollout - that STEVESlotFormer through ``cli.rollout_slots
               --task physion --subset readout``, 45 -> 150 frames; one
               video card against CPU.
 24. steve_decode - ``STEVESlotFormer.rollout(decode=True)`` for 2 frames of
               2 videos: 1024 KV-cached token steps an image, then the dVAE;
               ms per image and per token step, launches per step; one
               image card against CPU (teacher-forced logits, generated ids
               up to a tie, hard and soft images).

 25. physion_readout - the Physion readout head: 2 test videos rendered into
               the mini tree (with ``bad_stimuli.txt`` and label files),
               encoded by ``cli.extract_slots --subset test`` and extended
               45 -> 150 frames by ``cli.rollout_slots --subset test``; the
               full-width ``readout_physion_params`` PhysionReadout (6 slots x
               192, all 15 slot pairs, 75 frames) trained by
               ``cli.train.run`` at the config's batch of 64 for 20 steps
               over 128 named copies of the 2 rolled-out readout train
               videos (``ReadoutMethod``; the head reads slots alone), then
               ``cli.test_physion_vqa`` over its checkpoints; the test
               videos' logits card against CPU; steps/s.
 26. phyre_tree - PHYRE on a stand-in ``phyre`` module this script puts into
               ``sys.modules`` (no simulator wheel is installed): 25
               templates with one train and one eval task each, a cache of
               1000 actions with deterministic statuses, 256x256
               colour-index frames of a falling ball (resized to 128 by
               ``BaseTransforms``, as real frames); ``datasets.phyre._SPLIT_DIR``
               at a temporary directory, where the splits are drawn (data
               ratio cut to 0.01: 500 train and 125 val actions).
 27. train_savi_phyre - the full-width ``savi_phyre_params-fold0`` SAVi (8
               slots x 128 at 128x128, B=32 clips of 6 frames, K1 at (32,
               4096, 128, 8, 256)): one B=2 step card against CPU and
               against the plain K1; ``cli.train.run`` for one epoch (15
               steps): K1 launches, a checkpoint that reloads; steps/s and
               a profiled step.
 28. phyre_slots - that SAVi through ``cli.extract_phyre_slots --bs 32
               --vid_len 11``: a file per action, K1 once a frame step a
               batch, the ``{split}_slots`` links the next config reads; 4
               actions card against CPU and against the plain K1;
               actions/s; the second of five shards, timed.
 29. train_slotformer_phyre - the full-width
               ``slotformer_phyre_params-fold0`` SingleStepSlotFormer (d256,
               8 layers, cond_len 6, 1 + 10 frames, B=64): one B=2 step card
               against CPU; ``cli.train.run`` for one epoch (7 steps), the
               SAVi decoder grafted and bit-frozen; steps/s.
 30. rollout_phyre - ``cli.rollout_phyre_slots``: 1 -> 11 frames for every
               action; 8 actions card against CPU.
 31. train_readout_phyre - the full-width ``readout_phyre_params-fold0``
               PHYREReadout (B=256) for two epochs on the rolled-out slots
               (``ReadoutMethod``'s ``acc_*`` sweep and sample video).
 32. plan_phyre - ``cli.test_phyre_planning --bs 128`` over 25 eval tasks x
               256 actions in two shards (the second under the profiler),
               ``--collect`` and AUCCESS; K1 at (128, 4096, 128, 8, 256)
               once a batch; actions/s end to end and on the device alone;
               one batch's confidences card against CPU.

K1 is also checked in the kernel phase at PHYRE's two shapes, (32, 4096, 128,
8, 256) and (128, 4096, 128, 8, 256), with the floor of k and v read once
per round beside its bound.

The OBJ3D, Physion and PHYRE phases run in the temporary directory of their tree,
where each training phase links its checkpoint as
``pretrained/<run>/model.pth``, the path the next stage's shipped config
names.

Every phase's seconds follow it on a line of their own.

Then a line of constants for comparison (each kernel's time at the same case
before it was redesigned for the H100, measured by an earlier version of this
script on an NVIDIA H100 80GB HBM3 at 700 W; K1's included the weight packing
in every call), the card's ``nvidia-smi`` line, the kernels line (K1 at the
training shape, with its launches in ``fit``; K2 at the extraction shape, with
its launches through its entry point; every number measured in this run but
``bound_ms``, which is computed), and as the last line
``{"ok": true, "device": {...}}``. K1's ``launches_by_path`` also counts the
encode of the slots file that SlotFormer trains on and ``test_vp`` evaluates
(SlotFormer itself launches no kernel of this repository: it reads K1's
slots), STEVE's training and extraction, OBJ3D SAVi's training and
extraction, the VQA phase's extraction and PHYRE's SAVi training,
extraction and planning, and the two ranks of ``ddp_savi`` (summed); its
``steve_case`` holds K1 at the STEVE
extraction shape, ``steve_train_case`` at STEVE's training shape, with its
gradient check, ``obj3d_case`` at OBJ3D's, and ``phyre_train_case`` and
``phyre_plan_case`` at PHYRE's. K3's ``launches_by_path`` counts its launches
on each main path the phases time (``wall_s``, the count reset before the
path runs), the ranks of ``ddp_savi`` summed; the run fails if StoSAVi's
training, the rollout, SlotFormer's training or ``ddp_savi`` launched none.
Without a CUDA device it exits 1 and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
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
# One SlotFormer train step at B=2 on the card against the CPU, float32 on
# both: 10 autoregressive transformer steps, then the decoder over 140 slot
# images, and back. The bf16 branch is held to the card's own float32 value
# at tests/test_models.py:495-530's tolerances (bfloat16 keeps 8 bits).
SF_LOSS_RTOL, SF_GRAD_RTOL = 1e-4, 1e-3
SF_BF16_IMG_RTOL, SF_BF16_SLOT_RTOL = 3e-2, 2e-5
# pred_eval_step on the card against the CPU: the pixel metrics are float32
# means over 64x64 frames (LPIPS through 13 convolutions); ARI and mIoU come
# from exact integer counts whose float32 sums may round in another order;
# the box matching is discrete.
VP_PIXEL_RTOL, VP_CLUSTER_ATOL = 1e-4, 1e-5
# STEVE on Physion, full width: K1 at the extraction
# shape (B, N, D, S, H) = (8, 64x64 features of 128x128 frames, 192, 6, 384)
STEVE_K1_SHAPE = (8, 4096, 192, 6, 384)
# STEVE training: K1 at the batch of steve_physion_params, (48, 4096, 192, 6,
# 384), forward through the kernel and backward through the autograd of its
# plain version. Its gradients through the kernel's autograd.Function and
# through plain autograd differentiate the same plain version on the same
# inputs: only the order of the card's reductions may differ.
STEVE_TRAIN_K1_SHAPE = (48, 4096, 192, 6, 384)
# OBJ3D SAVi training: K1 at savi_obj3d_params' batch, (64, 4096, 128, 6,
# 256): 6 slots beside D=128's resident slot-side weights
OBJ3D_K1_SHAPE = (64, 4096, 128, 6, 256)
K1_GRAD_RTOL = 1e-5
# STEVE extraction, card against CPU on one 6-frame clip: the slots pass 6
# recurrent frame steps (an LSTM-wrapped 2-layer predictor, then K1) at
# D=192 and O(1) magnitudes; the masks are softmaxes in [0, 1].
STEVE_SLOTS_ATOL, STEVE_MASKS_ATOL = 1e-3, 1e-4
# One dVAE train step (B=2, vocab 4096, tau 0.55), card and CPU in float32
# each against the same step in float64 on the CPU: losses as TRAIN_LOSS_RTOL;
# gradients relative to each one's largest entry. The weight gradient of the
# decoder's first block sums a softmax over 4096 tokens against the backward
# of a GroupNorm over 64 x 32 x 32 values. There float32 on the CPU of the
# card's host sat 2.1e-3 from float64, the card's float32 7.3e-6.
DVAE_GRAD_RTOL = 5e-3
# The dVAE's logits card against CPU, relative to the largest |logit|: 9
# convolutions in float32; an id may differ only where its top two logits
# lie closer than DVAE_TIE.
DVAE_LOGITS_RTOL, DVAE_TIE = 1e-4, 1e-4
# The STEVESlotFormer rollout card against CPU: 8 transformer layers over 35
# autoregressive steps, float32 on both.
STEVE_ROLLOUT_ATOL = 1e-4
# Token decoding, card against CPU: teacher-forced logits relative to the
# largest |logit|; generated ids equal up to a tie (top-2 gap under
# DECODE_TIE at the first mismatch); the images within 1e-4 given the same
# ids (hard) or the same gumbel uniforms (soft).
DECODE_LOGITS_RTOL, DECODE_TIE, DECODE_IMG_ATOL = 1e-4, 1e-4, 1e-4
# Several ranks against one process on the same global batch (the JAX
# package's dryrun limits, __graft_entry__.py:196-215): losses and grad_norm
# relative (float32 sums over other row splits and shard sums); parameters
# after one Adam step, which moves each weight by about lr.
RANKS_LOSS_RTOL, RANKS_PARAM_ATOL = 1e-5, 1e-4
# the global batch of the two-rank StoSAVi step (stosavi_clevrer's) and of
# the TP SlotFormer step
DDP_SAVI_BATCH, TP_SF_BATCH = 64, 8
PHYSION = dict(video_len=150, train=6, val=2, readout_train=2, readout_val=2,
               extract_batch=8, chunk_len=50)
CONFIGS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "slotformer_tpu_torch", "configs")
# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM bytes/s and
# float32 FLOP/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12


DEVICE = "cuda"  # every phase runs on the card


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


# K3's launches on each main path a phase runs through ``wall_s``
K3_LAUNCHES = {}


def wall_s(fn, k3_path=None):
    """``fn()`` and its seconds on the wall clock; with ``k3_path``, K3's
    launches inside it are recorded as ``K3_LAUNCHES[k3_path]``."""
    import torch

    from slotformer_tpu_torch.kernels import decoder_conv as k3

    torch.cuda.synchronize()
    if k3_path is not None:
        k3.LAUNCHES = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    if k3_path is not None:
        K3_LAUNCHES[k3_path] = k3.LAUNCHES
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
                                 ("train_batch", (64, 4096, 128, 7, 256)),
                                 ("steve", STEVE_K1_SHAPE),
                                 ("steve_train", STEVE_TRAIN_K1_SHAPE),
                                 ("obj3d", OBJ3D_K1_SHAPE),
                                 ("phyre_train", PHYRE_K1_TRAIN_SHAPE),
                                 ("phyre_plan", PHYRE_K1_PLAN_SHAPE)):
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
        # k and v read once per round: the floor when they do not stay in
        # the 50 MB L2 between the two rounds
        two_rounds_ms = 1e3 * 2 * (2 * B * N * D * 4) / HBM_BYTES_PER_S
        extra = {}
        if tag in ("clevrer", "train_batch", "obj3d", "phyre_train",
                   "phyre_plan"):
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
             two_rounds_floor_ms=two_rounds_ms, **extra, ok=ok)
        if not ok:
            raise AssertionError(f"K1 disagrees with its plain version or "
                                 f"with itself ({tag})")
        results[tag] = dict(max_abs_err=max(err_slots, err_attn), ms=ms,
                            plain_ms=plain_ms, bound_ms=bound_ms,
                            bound_by=bound_by, bit_stable=bit_stable, **extra)
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


# K3's bound: three TF32 products a float32 multiply-add at the H100's dense
# TF32 rate (NVIDIA data sheet, 700 W)
TF32_FLOP_PER_S = 495e12
# (N, H, W) of the stride-1 layer: the rollout call's 2352 images (8 x 42
# frames x 7 slots) of CLEVRER, and PHYRE's 128x128 layer at 256 images
K3_CASES = (("rollout", (2352, 64, 64)), ("phyre", (256, 128, 128)))


def k3_bound(N, H, W):
    """Least time for K3's work: its float32 multiply-adds as three TF32
    products each at the dense TF32 rate, against its input and output read
    and written once at 3.35 TB/s."""
    flops = 2 * N * H * W * 64 * 64 * 25
    t_ops = 3 * flops / TF32_FLOP_PER_S
    t_bytes = 2 * 4 * N * 64 * H * W / HBM_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes",
            flops)


def phase_decoder_conv():
    import torch

    from slotformer_tpu_torch.kernels import decoder_conv as k3
    from slotformer_tpu_torch.models.savi import SpatialBroadcastDecoder

    results = {}
    for tag, (N, H, W) in K3_CASES:
        g = torch.Generator(device=DEVICE).manual_seed(len(results))
        # activations in channels-last memory, as the decoder's layers hand
        # them on
        cl = torch.channels_last
        x = torch.relu(torch.randn(N, 64, H, W, device=DEVICE, generator=g)).contiguous(
            memory_format=cl)
        w = torch.randn(64, 64, 5, 5, device=DEVICE, generator=g) * 1600 ** -0.5
        b = 0.1 * torch.randn(64, device=DEVICE, generator=g)
        gy = torch.randn(N, 64, H, W, device=DEVICE, generator=g).contiguous(memory_format=cl)
        errs = {}
        y = k3.decoder_conv_s1(x, w, b)
        want = k3.decoder_conv_plain(x.double(), w.double(), b.double())
        errs["forward"] = (y.double() - want).abs().max().item()
        errs["forward_cudnn"] = (k3.decoder_conv_plain(x, w, b).double()
                                 - want).abs().max().item()
        del want
        dx = k3.input_grad(gy, y, w)
        want = k3.input_grad_plain(gy.double(), y.double(), w.double())
        errs["input_grad"] = (dx.double() - want).abs().max().item()
        errs["input_grad_cudnn"] = (k3.input_grad_plain(gy, y, w).double()
                                    - want).abs().max().item()
        del want, dx
        torch.cuda.empty_cache()
        ms = cuda_ms(lambda: k3.decoder_conv_s1(x, w, b), iters=10)
        grad_ms = cuda_ms(lambda: k3.input_grad(gy, y, w), iters=10)
        kernel_ms = kernel_split_ms(lambda: k3.decoder_conv_s1(x, w, b),
                                    ("decoder_conv_s1",), iters=5)["decoder_conv_s1"]
        library_ms = cuda_ms(lambda: torch.relu(torch.nn.functional.conv_transpose2d(
            x, w, b, padding=2)), iters=10)
        plain_ms = cuda_ms(lambda: k3.decoder_conv_plain(x, w, b), iters=10)
        library_grad_ms = cuda_ms(lambda: k3.input_grad_plain(gy, y, w), iters=10)
        bound_ms, bound_by, flops = k3_bound(N, H, W)
        ok = (errs["forward"] <= 2 * errs["forward_cudnn"]
              and errs["input_grad"] <= 2 * errs["input_grad_cudnn"])
        emit(phase="decoder_conv", name="decoder_conv_s1", case=tag,
             shape=dict(N=N, C=64, H=H, W=W), max_abs_err=errs, ms=ms,
             kernel_only_ms=kernel_ms, input_grad_ms=grad_ms,
             float32_tflop_per_s=flops / ms / 1e9, bound_ms=bound_ms,
             bound_by=bound_by, plain_ms=plain_ms, library_ms=library_ms,
             library_input_grad_ms=library_grad_ms, ok=ok)
        if not ok:
            raise AssertionError(f"K3 is less accurate than cuDNN float32 ({tag})")
        results[tag] = dict(max_abs_err=max(errs["forward"], errs["input_grad"]),
                            ms=ms, input_grad_ms=grad_ms, plain_ms=plain_ms,
                            library_ms=library_ms, bound_ms=bound_ms,
                            bound_by=bound_by)
        del x, y, gy
        torch.cuda.empty_cache()
    # launches on the decoder's paths: a rollout decode (no gradient) and a
    # frozen-decoder training chunk (forward and input gradient)
    torch.manual_seed(0)
    dec = SpatialBroadcastDecoder((64, 64), 128).to(DEVICE)
    slots = torch.randn(16, 7, 128, device=DEVICE)
    k3.LAUNCHES = 0
    with torch.no_grad():
        dec(slots)
    decode = k3.LAUNCHES
    dec.requires_grad_(False)
    slots.requires_grad_(True)
    k3.LAUNCHES = 0
    torch.autograd.grad(dec(slots)[0].sum(), slots)
    frozen_step = k3.LAUNCHES
    emit(phase="decoder_conv", check="launches", decode=decode,
         frozen_decoder_input_grad=frozen_step)
    if (decode, frozen_step) != (1, 2):
        raise AssertionError(f"K3 launches {decode} (decode), {frozen_step} "
                             f"(forward and input gradient): expected 1, 2")
    results["launches_check"] = dict(decode=decode,
                                     frozen_decoder_input_grad=frozen_step)
    return results


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
        slots, dt = wall_s(run, k3_path="extract")
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


def _tied_pair(card_step, cpu_step):
    """``(card_step(), cpu_step(), ties)`` with the CPU run taking the card's
    side at every ``F.relu`` (see RELU_TIE_RTOL). ``ties`` gives the ReLU
    calls, the units whose side the CPU would have taken otherwise, and the
    largest |input| among those over its call's largest |input|. Raises if
    the two runs do not make the same ReLU calls. On the card K3 takes the
    decoder's stride-1 layer with its ReLU inside the kernel, where the CPU
    calls ``F.relu``: its side is recorded from its output."""
    import torch.nn.functional as F

    from slotformer_tpu_torch.kernels import decoder_conv

    relu, k3, sides = F.relu, decoder_conv.decoder_conv_s1, []
    ties = dict(relu_calls=0, untied=0, untied_rel_x=0.0)

    def record(x, inplace=False):
        sides.append(x.detach() > 0)
        return relu(x, inplace=inplace)

    def record_k3(x, weight, bias):
        y = k3(x, weight, bias)
        sides.append(y.detach() > 0)
        return y

    def replay(x, inplace=False):
        if ties["relu_calls"] == len(sides) or sides[ties["relu_calls"]].shape != x.shape:
            raise AssertionError("the card and the CPU made different ReLU calls")
        side = sides[ties["relu_calls"]].to(x.device)
        ties["relu_calls"] += 1
        other = side != (x.detach() > 0)
        if other.any():
            ties["untied"] += int(other.sum())
            ties["untied_rel_x"] = max(ties["untied_rel_x"], float(
                x.detach()[other].abs().max() / x.detach().abs().max()))
        return x * side

    try:
        F.relu, decoder_conv.decoder_conv_s1 = record, record_k3
        card = card_step()
        F.relu, decoder_conv.decoder_conv_s1 = replay, k3
        cpu = cpu_step()
    finally:
        F.relu, decoder_conv.decoder_conv_s1 = relu, k3
    if ties["relu_calls"] != len(sides):
        raise AssertionError("the card and the CPU made different ReLU calls")
    return card, cpu, ties


def _read_log(ckp):
    """The JSONL log of a fit: (every record, the train records)."""
    with open(os.path.join(ckp, "log.jsonl")) as f:
        log = [json.loads(line) for line in f]
    return log, [r for r in log if r["phase"] == "train"]


def _finite(log):
    """Some train record, and every loss and gradient norm finite."""
    import numpy as np

    return any(r["phase"] == "train" for r in log) and all(
        np.isfinite(r[k]) for r in log for k in r
        if k.endswith("loss") or k == "grad_norm")


def _reloads(method, params, ckp):
    """A fresh method of ``params`` loads the newest checkpoint of ``ckp``
    and then holds ``method``'s step and weights, bit for bit."""
    import torch

    from slotformer_tpu_torch.datasets import build_dataset
    from slotformer_tpu_torch.methods import build_method
    from slotformer_tpu_torch.models import build_model
    from slotformer_tpu_torch.runtime import BaseDataModule, latest_checkpoint

    torch.manual_seed(123)
    fresh = build_method(model=build_model(params, device=DEVICE),
                         datamodule=BaseDataModule(params, *build_dataset(params)),
                         params=params, ckp_path=ckp)
    fresh.load_ckp(latest_checkpoint(ckp))
    return fresh.it == method.it and all(
        torch.equal(a, b) for a, b in zip(method.model.state_dict().values(),
                                          fresh.model.state_dict().values()))


def _steady_steps_per_s(method, n_steps=5):
    """Loader steps a second of ``method``'s train step on one batch, after
    a warm-up step (the weights go on training: the checkpoints are
    written before); returns (steps/s, the batch)."""
    batch = next(iter(method.train_loader))
    method._train_step(batch)
    _, dt = wall_s(lambda: [method._train_step(batch) for _ in range(n_steps)])
    return n_steps / dt, batch


def phase_train(ckp):
    """StoSAVi training at the full ``stosavi_clevrer`` width; the fit's
    checkpoints go to ``ckp``. Returns (K1 launches of the fit, its last
    checkpoint)."""
    import numpy as np
    import torch

    from slotformer_tpu_torch.cli import train as train_cli
    from slotformer_tpu_torch.datasets import build_dataset
    from slotformer_tpu_torch.kernels import slot_attention as k1
    from slotformer_tpu_torch.runtime import latest_checkpoint, load_params

    params = load_params(os.path.join(CONFIGS, "stosavi_clevrer_params.py"))
    # synthetic 64x64 clips (the CLEVRER videos are not in the repository):
    # 32 videos x 15 clip starts = 480 clips = 7 steps of 64
    params.dataset = "synthetic"
    params.num_videos_train = 32
    params.max_epochs = 1
    params.print_iter = 1  # a log line per step: the losses checked below
    T = params.n_sample_frames

    # (a)/(b) one train step at B=2: card vs CPU, and K1 vs its plain version
    train_set, _ = build_dataset(params)
    img = np.stack([train_set[i]["img"] for i in (0, 100)])
    S, D = params.slot_dict["num_slots"], params.slot_dict["slot_size"]
    eps = np.random.default_rng(0).standard_normal((2, T, S, D)).astype(np.float32)
    _k1_step_check("train", params, {"img": torch.from_numpy(img),
                                     "sample_eps": torch.from_numpy(eps)}, seed=2)

    # (c) fit at B=64 through the CLI's code
    params.seed = 0
    k1.LAUNCHES = 0
    method, fit_s = wall_s(lambda: train_cli.run(
        params, ckp, device=DEVICE, san_check_val_step=1), k3_path="train")
    launches, steps = k1.LAUNCHES, method.it
    val_batches = 1 + len(method.val_loader)  # sanity check + epoch end
    # the decomposition video of the epoch's end encodes n_samples whole
    # val videos, one K1 call a frame
    val_set = method.val_loader.dataset
    sampled = min(int(params.get("n_samples", 0)), val_set.num_videos)
    sampled_frames = sampled * len(range(0, val_set.video_len,
                                         val_set.frame_offset))
    expected = T * (steps + val_batches) + sampled_frames
    log, train_log = _read_log(ckp)
    finite = _finite(log)
    last = latest_checkpoint(ckp)
    reloaded = _reloads(method, params, ckp)

    # steady-state steps/s, then one profiled step
    steps_per_s, batch = _steady_steps_per_s(method)
    prof = _profiled_step(method, batch)
    ok = (steps == 7 and launches == expected and finite and reloaded
          and last is not None and last.endswith(f"model_{steps}.pth"))
    step_ms = prof["forward_ms"] + prof["backward_ms"] + prof["optimizer_ms"]

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
         val_batches=val_batches, sampled_video_frames=sampled_frames,
         finite=finite, checkpoint=os.path.basename(last),
         reloaded=reloaded, last_train=train_log[-1] if train_log else None,
         steps_per_s=steps_per_s, frames_per_s=steps_per_s * 64 * T,
         profiled_step=dict(prof, k1_backward_ms=T * k1_bwd_ms,
                            k1_backward_share=T * k1_bwd_ms / step_ms),
         ok=ok)
    if not ok:
        raise AssertionError("training check failed")
    return launches, last


# ------------------------------------------------------- several ranks
def _rank_cases(device, cases):
    """A spawned rank: float32 without TF32, as the parent runs, then
    ``entry.run_cases``."""
    import torch

    from slotformer_tpu_torch import entry

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return entry.run_cases(device, cases)


def _ranks_ok(rec):
    return (rec["loss_rel_err"] < RANKS_LOSS_RTOL
            and rec["max_param_diff"] < RANKS_PARAM_ATOL)


def phase_two_ranks(workdir):
    """Two ranks share the card over gloo (NCCL refuses two ranks on one
    device), one spawned process each, loading the kernels this script
    built: ``ddp_savi`` (a), StoSAVi at the full ``stosavi_clevrer`` width,
    one step of the global batch of 64 (32 a rank) with the same
    ``sample_eps`` as one process's step at B=64, K1 on every rank; and
    ``tp_slotformer``, the full-width ``slotformer_clevrer`` SlotFormer at
    tp_size 2, one step of 8 clips with dropout 0 and ``vid_len`` differing
    across rows, its checkpoint loaded in one process and one process's
    loaded on the grid. Returns K1's launches summed over the ranks."""
    import numpy as np

    from slotformer_tpu_torch.datasets import build_dataset
    from slotformer_tpu_torch.parallel.launch import spawn
    from slotformer_tpu_torch.runtime import load_params

    savi = load_params(os.path.join(CONFIGS, "stosavi_clevrer_params.py"))
    savi.dataset, savi.num_videos_train = "synthetic", 8
    train_set, _ = build_dataset(savi)
    T = savi.n_sample_frames
    S, D = savi.slot_dict["num_slots"], savi.slot_dict["slot_size"]
    B = DDP_SAVI_BATCH
    idx = np.linspace(0, len(train_set) - 1, B).astype(int)
    savi_batch = {
        "img": np.stack([train_set[int(i)]["img"] for i in idx]),
        "sample_eps": np.random.default_rng(0).standard_normal(
            (B, T, S, D)).astype(np.float32)}
    sf = load_params(os.path.join(CONFIGS, "slotformer_clevrer_params.py"))
    sf.tp_size, sf.seed = 2, 0
    sf.rollout_dict = dict(sf.rollout_dict, dropout=0.0)
    sf.dec_dict = dict(sf.dec_dict, dec_ckp_path="")
    Bs, Ts = TP_SF_BATCH, sf.n_sample_frames
    r = np.random.default_rng(1)
    sf_batch = {
        "slots": r.standard_normal(
            (Bs, Ts, sf.slot_dict["num_slots"], sf.slot_dict["slot_size"])
        ).astype(np.float32),
        "img": r.uniform(-1, 1, (Bs, Ts, *sf.resolution, 3)).astype(np.float32),
        "vid_len": np.array([16, 12, 9, 16, 7, 14, 16, 11], np.int32)}
    cases = [dict(params=savi.to_dict(), batches=[savi_batch],
                  count_launches=True),
             dict(params=sf.to_dict(), batches=[sf_batch],
                  ckp_dir=os.path.join(workdir, "tp_slotformer"))]
    device = "cuda:0" if DEVICE == "cuda" else DEVICE
    recs, dt = wall_s(lambda: spawn(_rank_cases, 2, (cases,), "gloo",
                                    [device, device]))
    ddp = [rec[0] for rec in recs]
    tp = [rec[1] for rec in recs]
    launches = [rec["k1_launches"] for rec in ddp]
    K3_LAUNCHES["ddp_train"] = sum(rec["k3_launches"] for rec in ddp)
    ok_ddp = (_ranks_ok(ddp[0]) and ddp[0]["grid"] == {"data": 2, "model": 1}
              and launches == [T, T])
    emit(phase="ddp_savi", check="two ranks on one card over gloo",
         config="stosavi_clevrer", global_batch=B, rows_per_rank=B // 2,
         loss_rel_err=ddp[0]["loss_rel_err"],
         max_param_diff=ddp[0]["max_param_diff"],
         tol=dict(loss_rel=RANKS_LOSS_RTOL, param_abs=RANKS_PARAM_ATOL),
         losses=ddp[0]["losses"], k1_launches_by_rank=launches,
         k3_launches_by_rank=[rec["k3_launches"] for rec in ddp],
         step_seconds_by_rank=[rec["seconds"] for rec in ddp],
         spawn_seconds=dt, ok=ok_ddp)
    whole = (sf.rollout_dict["ffn_dim"], sf.rollout_dict["d_model"])
    ok_tp = (_ranks_ok(tp[0]) and tp[0]["grid"] == {"data": 1, "model": 2}
             and tp[0]["linear1"] == ((whole[0] // 2, whole[1]), whole)
             and tp[0]["ckp_grid_to_one"] and tp[0]["ckp_one_to_grid"])
    emit(phase="tp_slotformer", check="tp_size 2 on one card over gloo",
         config="slotformer_clevrer", batch=Bs,
         vid_len=sf_batch["vid_len"].tolist(),
         loss_rel_err=tp[0]["loss_rel_err"],
         max_param_diff=tp[0]["max_param_diff"],
         linear1_local_and_whole=tp[0]["linear1"],
         checkpoint_tp2_to_one=tp[0]["ckp_grid_to_one"],
         checkpoint_one_to_tp2=tp[0]["ckp_one_to_grid"],
         losses=tp[0]["losses"],
         step_seconds_by_rank=[rec["seconds"] for rec in tp], ok=ok_tp)
    if not (ok_ddp and ok_tp):
        raise AssertionError("two-rank checks failed")
    return sum(launches)


def phase_ddp_cli(workdir):
    """``ddp_savi`` (b): ``python -m slotformer_tpu_torch.cli.train --ddp``
    at world size 1 on NCCL, torchrun's environment set for the child: a few
    StoSAVi steps at the full width on synthetic clips, and the checkpoint
    reloads."""
    import socket

    import torch

    from slotformer_tpu_torch.methods import build_method
    from slotformer_tpu_torch.models import build_model
    from slotformer_tpu_torch.runtime import (BaseDataModule, latest_checkpoint,
                                              load_checkpoint)

    cfg, params = derived_params(workdir, "stosavi_clevrer_params",
                                 dataset="synthetic", num_videos_train=10,
                                 num_videos_val=2, max_epochs=1,
                                 print_iter=1, n_samples=0)
    ckp = os.path.join(workdir, "ddp_cli")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
               LOCAL_WORLD_SIZE="1", MASTER_ADDR="localhost",
               MASTER_PORT=str(port))
    proc, dt = wall_s(lambda: subprocess.run(
        [sys.executable, "-m", "slotformer_tpu_torch.cli.train", "--params",
         cfg, "--ckp_path", ckp, "--ddp", "--san_check_val_step", "1",
         "--device", DEVICE],
        env=env, capture_output=True, text=True, timeout=600))
    if proc.returncode:
        print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
        raise AssertionError("cli.train --ddp failed")
    log, train_log = _read_log(ckp)
    last = latest_checkpoint(ckp)
    ck = load_checkpoint(last)
    torch.manual_seed(5)
    fresh = build_method(model=build_model(params, device=DEVICE),
                         datamodule=BaseDataModule(params, [0] * 64, None),
                         params=params, ckp_path="")
    fresh.load_ckp(last)
    reloaded = fresh.it == ck["it"] and all(
        torch.equal(v.cpu(), ck["state_dict"][k])
        for k, v in fresh.model.state_dict().items())
    steps = len(train_log)
    ok = (steps >= 2 and _finite(log) and reloaded
          and "grid={'data': 1, 'model': 1}" in proc.stdout)
    emit(phase="ddp_savi", check="cli.train --ddp, world size 1, NCCL",
         steps=steps, seconds=dt, checkpoint=os.path.basename(last),
         reloaded=reloaded, last_train=train_log[-1] if train_log else None,
         ok=ok)
    if not ok:
        raise AssertionError("cli.train --ddp check failed")


def phase_dryrun_multichip():
    """``entry.dryrun_multichip(4)``: four ranks on the one card over gloo,
    a 2 x 2 grid, one training step of the tiny SlotFormer against one
    process."""
    from slotformer_tpu_torch import entry

    recs, dt = wall_s(lambda: entry.dryrun_multichip(4))
    ok = (recs[0]["grid"] == {"data": 2, "model": 2}
          and all(r["linear1"] == ((16, 16), (32, 16)) for r in recs))
    emit(phase="dryrun_multichip", n=4, grid=recs[0]["grid"],
         max_param_diff=recs[0]["max_param_diff"],
         loss_rel_err=recs[0]["loss_rel_err"], seconds=dt, ok=ok)
    if not ok:
        raise AssertionError("dryrun_multichip check failed")


def phase_steps_per_call(slots_path, savi_ckp, workdir):
    """SlotFormer at the full ``slotformer_clevrer`` width for one epoch of
    6 steps at B=64 with ``steps_per_call`` 4 (4 in one call, 2 left over)
    against 6 single steps from the same init (deterministic cuDNN for
    both): the parameters equal, the log at the JAX trainer's windows."""
    import torch

    from slotformer_tpu_torch.cli import train as train_cli

    runs = {}
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        for k in (4, 1):
            params = slotformer_params(slots_path, savi_ckp, max_epochs=1,
                                       eval_interval=2, print_iter=1,
                                       save_interval=1.0, train_batch_size=64,
                                       steps_per_call=k, seed=0)
            ckp = os.path.join(workdir, f"steps_per_call_{k}")
            method, dt = wall_s(lambda: train_cli.run(
                params, ckp, device=DEVICE, san_check_val_step=0))
            runs[k] = (method, dt, [r["step"] for r in _read_log(ckp)[1]])
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
    (fused, fused_s, fused_log), (single, single_s, single_log) = runs[4], runs[1]
    a, b = fused.model.state_dict(), single.model.state_dict()
    diff = max(float((a[k].float() - b[k].float()).abs().max()) for k in a)
    equal = all(torch.equal(a[k], b[k]) for k in a)
    windows = [it for it, inc in ((4, 4), (5, 1), (6, 1))
               if it % fused.print_iter < inc]
    ok = (fused.it == single.it == 6 and equal and fused_log == windows
          and single_log == list(range(1, 7)))
    emit(phase="steps_per_call", config="slotformer_clevrer", batch=64,
         steps=fused.it, params_equal=equal, max_param_diff=diff,
         logged_steps=fused_log, jax_windows=windows,
         single_logged_steps=single_log, fused_fit_seconds=fused_s,
         single_fit_seconds=single_s, ok=ok)
    if not ok:
        raise AssertionError("steps_per_call check failed")


def phase_convert(workdir, savi_weight):
    """The StoSAVi ``phase_train`` trained, written as a reference-layout
    ``{'state_dict'}`` file, through ``cli.convert_reference_ckpt``; the
    result loaded on the card encodes 4 synthetic videos through K1 to the
    slots of the original weights."""
    import torch

    from slotformer_tpu_torch.cli import convert_reference_ckpt
    from slotformer_tpu_torch.cli.extract_slots import extract_video_slots
    from slotformer_tpu_torch.datasets import SyntheticVideoDataset
    from slotformer_tpu_torch.models import build_model
    from slotformer_tpu_torch.runtime import load_checkpoint, load_params

    cfg = os.path.join(CONFIGS, "stosavi_clevrer_params.py")
    params = load_params(cfg)
    ref = os.path.join(workdir, "reference_stosavi.pth")
    torch.save({"state_dict": load_checkpoint(savi_weight)["state_dict"]}, ref)
    out = os.path.join(workdir, "converted_stosavi.pth")
    _, dt = wall_s(lambda: convert_reference_ckpt.main(
        ["--params", cfg, "--ref_ckpt", ref, "--save_path", out]))
    ds = SyntheticVideoDataset("val", num_videos=4, video_len=12,
                               resolution=params.resolution)
    slots = {}
    for name, path in (("original", savi_weight), ("converted", out)):
        model = build_model(params, device=DEVICE)
        model.load_state_dict(load_checkpoint(path)["state_dict"])
        slots[name] = extract_video_slots(model, ds, 4, 12, seed=0)
    equal = all((slots["original"][k] == slots["converted"][k]).all()
                for k in slots["original"])
    emit(phase="convert", source="reference-layout .pth of the trained "
         "StoSAVi", seconds=dt, videos=len(slots["original"]),
         slots_equal=bool(equal), ok=bool(equal))
    if not equal:
        raise AssertionError("convert check failed")


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
        out, dt = wall_s(run, k3_path="rollout")
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


# ------------------------------------------------- SlotFormer training, test_vp

# the new path's data: synthetic 64x64 videos long enough for a 16-frame
# clip at frame offset 2 (training) and for a 48-frame clip (test_vp)
SF_DATA = dict(video_len=48, num_videos_train=24, num_videos_val=24,
               extract_batch=8, chunk_len=24)
SF_SMALL_CHUNK = 10  # the B=2 step: 20 rollout frames in 2 chunks
BRANCHES = {  # loss_dict settings of the image-loss branches
    "plain": dict(dec_chunk_frames=0, dec_recon_bf16=False, dec_custom_bwd=False),
    "chunked": dict(dec_chunk_frames=160, dec_recon_bf16=False, dec_custom_bwd=False),
    "bf16": dict(dec_chunk_frames=0, dec_recon_bf16=True, dec_custom_bwd=False),
    "custom": dict(dec_chunk_frames=0, dec_recon_bf16=False, dec_custom_bwd=True),
    "custom_chunked": dict(dec_chunk_frames=160, dec_recon_bf16=False,
                           dec_custom_bwd=True),
}


def _set_branch(model, branch, chunk=None):
    for k, v in BRANCHES[branch].items():
        setattr(model, k, v)
    if chunk is not None and model.dec_chunk_frames:
        model.dec_chunk_frames = chunk


def slotformer_params(slots_path, dec_ckp, **over):
    """The shipped ``slotformer_clevrer`` config on the synthetic slots file."""
    from slotformer_tpu_torch.runtime import load_params

    params = load_params(os.path.join(CONFIGS, "slotformer_clevrer_params.py"))
    params.dataset = "synthetic_slots"
    params.slots_root = slots_path
    params.dec_dict["dec_ckp_path"] = dec_ckp
    for k in ("video_len", "num_videos_train", "num_videos_val"):
        setattr(params, k, SF_DATA[k])
    for k, v in over.items():
        setattr(params, k, v)
    return params


def phase_slots_file(workdir):
    """Encode the train and val videos to the slots file through K1; returns
    (slots path, StoSAVi checkpoint path, K1 launches)."""
    import numpy as np
    import torch

    from slotformer_tpu_torch.cli.extract_slots import extract_video_slots
    from slotformer_tpu_torch.datasets import SyntheticVideoDataset
    from slotformer_tpu_torch.kernels import slot_attention as k1
    from slotformer_tpu_torch.models import build_model
    from slotformer_tpu_torch.runtime import dump_obj, load_params, save_checkpoint

    params = load_params(os.path.join(CONFIGS, "stosavi_clevrer_params.py"))
    torch.manual_seed(3)
    savi = build_model(params, device=DEVICE)
    savi_ckp = os.path.join(workdir, "stosavi", "model_0.pth")
    save_checkpoint(savi_ckp, {k: v.cpu() for k, v in savi.state_dict().items()})
    T, bs = SF_DATA["video_len"], SF_DATA["extract_batch"]
    sets = {split: SyntheticVideoDataset(
                split, num_videos=SF_DATA[f"num_videos_{split}"], video_len=T,
                resolution=params.resolution, frame_offset=params.frame_offset)
            for split in ("train", "val")}
    k1.LAUNCHES = 0
    slots, dt = wall_s(lambda: {
        split: extract_video_slots(savi, ds, bs, SF_DATA["chunk_len"], seed=0)
        for split, ds in sets.items()}, k3_path="slotformer_slots_file")
    launches = k1.LAUNCHES
    slots_path = os.path.join(workdir, "synthetic_slots.pkl")
    dump_obj(slots, slots_path)
    n_videos = sum(len(v) for v in slots.values())
    frame_steps = sum(-(-len(ds.files) // bs) for ds in sets.values()) * T
    shapes_ok = all(s.shape == (T, 7, 128) and s.dtype == np.float32
                    and np.isfinite(s).all()
                    for v in slots.values() for s in v.values())
    ok = (shapes_ok and launches == frame_steps
          and {k: len(v) for k, v in slots.items()}
          == {k: len(ds.files) for k, ds in sets.items()})
    emit(phase="slots_file", config="stosavi_clevrer", videos=n_videos,
         frames=T, seconds=dt, frames_per_s=n_videos * T / dt,
         k1_launches=launches, frame_steps=frame_steps, shapes_ok=shapes_ok,
         file_mb=os.path.getsize(slots_path) / 1e6, ok=ok)
    if not ok:
        raise AssertionError("slots file check failed")
    return slots_path, savi_ckp, launches


def _sf_step(model, batch, weights, factor=None):
    """Losses, rollouter gradients and d(loss)/d(pred_slots) of one
    dropout-free SlotFormer or STEVESlotFormer train step (no optimizer);
    ``factor`` is the loss-decay factor, for SlotFormer."""
    import torch

    model.eval()  # dropout-free: train_loss does not look at the mode
    model.zero_grad(set_to_none=True)
    seen = {}

    def keep_grad(mod, args, out):  # returns None: the output stays as it is
        out.register_hook(lambda g: seen.__setitem__("dpred", g.detach().cpu()))

    hook = model.rollouter.register_forward_hook(keep_grad)
    try:
        losses = model.train_loss(batch, **(
            {} if factor is None else {"loss_decay_factor": factor}))
        sum(weights.get(n, 1.0) * v for n, v in losses.items()).backward()
    finally:
        hook.remove()
    grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()
             if p.grad is not None}
    if any(not n.startswith("rollouter.") for n in grads):
        raise AssertionError("a frozen subtree got a weight gradient")
    return {n: v.item() for n, v in losses.items()}, grads, seen["dpred"]


def phase_train_slotformer(slots_path, savi_ckp, workdir):
    import numpy as np
    import torch
    from torch.autograd import DeviceType

    from slotformer_tpu_torch.cli import train as train_cli
    from slotformer_tpu_torch.datasets import build_dataset
    from slotformer_tpu_torch.models import build_model
    from slotformer_tpu_torch.runtime import graft, latest_checkpoint, load_checkpoint

    params = slotformer_params(slots_path, savi_ckp, max_epochs=2,
                               eval_interval=2, print_iter=1,
                               use_loss_decay=True, loss_decay_pct=0.5)
    weights = params.loss_weights()
    B = params.train_batch_size

    # (a) one step at B=2: card vs CPU per branch, the branches between them
    train_set, _ = build_dataset(params)
    items = [train_set[i] for i in (0, len(train_set) // 2)]
    batch = {k: torch.from_numpy(np.stack([it[k] for it in items]))
             for k in ("slots", "img")}
    torch.manual_seed(4)
    gpu = build_model(params, device=DEVICE)
    gpu.load_state_dict(graft(gpu.state_dict(), load_checkpoint(savi_ckp),
                              ("decoder", "decoder_pos_embedding")))
    cpu = build_model(params, device="cpu")
    cpu.load_state_dict(gpu.state_dict())
    for m in (gpu, cpu):
        for n, p in m.named_parameters():
            p.requires_grad_(not n.startswith("decoder"))
    gbatch = {k: v.to(DEVICE) for k, v in batch.items()}
    checks, dpreds, f32_losses = {}, {}, None
    for branch in ("plain", "chunked", "custom", "custom_chunked"):
        for m in (gpu, cpu):
            _set_branch(m, branch, chunk=SF_SMALL_CHUNK)
        (l_gpu, g_gpu, dpreds[branch]), (l_cpu, g_cpu, _), ties = _tied_pair(
            lambda: _sf_step(gpu, gbatch, weights, 0.5),
            lambda: _sf_step(cpu, batch, weights, 0.5))
        loss_err = max(abs(l_gpu[n] / l_cpu[n] - 1) for n in l_cpu)
        grad_err, worst = _grad_errors(g_gpu, g_cpu)
        checks[branch] = dict(losses_card=l_gpu, loss_rel_err_vs_cpu=loss_err,
                              grad_rel_err_vs_cpu=grad_err, worst_param=worst,
                              relu=ties, n_grads=len(g_cpu))
        f32_losses = f32_losses or l_gpu
    ref = dpreds["plain"]
    dpred_err = {b: ((d - ref).abs().max() / ref.abs().max()).item()
                 for b, d in dpreds.items() if b != "plain"}
    _set_branch(gpu, "bf16")
    l_bf16, g_bf16, _ = _sf_step(gpu, gbatch, weights, 0.5)
    bf16_err = {n: abs(l_bf16[n] / f32_losses[n] - 1) for n in l_bf16}
    step_ok = (
        all(c["loss_rel_err_vs_cpu"] <= SF_LOSS_RTOL
            and c["grad_rel_err_vs_cpu"] <= SF_GRAD_RTOL
            and c["relu"]["untied_rel_x"] <= RELU_TIE_RTOL for c in checks.values())
        and max(dpred_err.values()) <= SF_GRAD_RTOL
        and bf16_err["img_recon_loss"] <= SF_BF16_IMG_RTOL
        and bf16_err["slot_recon_loss"] <= SF_BF16_SLOT_RTOL
        and all(torch.isfinite(g).all() for g in g_bf16.values()))
    emit(phase="train_slotformer", check="one_step", batch=2,
         chunk_frames=SF_SMALL_CHUNK, branches=checks,
         dpred_rel_err_vs_plain=dpred_err, bf16_loss_rel_err_vs_f32=bf16_err,
         tol=dict(loss_rtol=SF_LOSS_RTOL, grad_rel=SF_GRAD_RTOL,
                  bf16_img_rtol=SF_BF16_IMG_RTOL,
                  bf16_slot_rtol=SF_BF16_SLOT_RTOL, relu_tie=RELU_TIE_RTOL),
         ok=step_ok)
    if not step_ok:
        raise AssertionError("SlotFormer train step: the card disagrees with "
                             "the CPU, or the branches with each other "
                             f"({checks}, {dpred_err}, {bf16_err})")
    del gpu, cpu

    # (b) fit at B=128 through the CLI's code, the shipped branch (chunked)
    ckp = os.path.join(workdir, "slotformer")
    params.seed = 0
    method, fit_s = wall_s(lambda: train_cli.run(
        params, ckp, device=DEVICE, san_check_val_step=1),
        k3_path="slotformer_train")
    model, steps = method.model, method.it
    nc = -(-B * model.rollout_len // model.dec_chunk_frames)
    log, train_log = _read_log(ckp)
    finite = _finite(log)
    decay_steps = params.loss_decay_pct * method.total_steps
    ramp = [min(0.01 + i / decay_steps * 0.99, 1.0) for i in range(steps)]
    factors = [r.get("loss_decay_factor") for r in train_log]
    ramp_ok = len(factors) == steps and bool(np.allclose(factors, ramp, rtol=1e-6))
    savi_sd = load_checkpoint(savi_ckp)["state_dict"]
    dec_keys = [k for k in model.state_dict() if k.startswith("decoder")]
    frozen = len(dec_keys) == 13 and all(
        torch.equal(model.state_dict()[k].cpu(), savi_sd[k]) for k in dec_keys)
    last = latest_checkpoint(ckp)
    reloaded = _reloads(method, params, ckp)
    videos = sorted(os.listdir(os.path.join(ckp, "vis")))

    # (c) steady-state steps/s, one profiled step, then each branch
    steps_per_s, loader_batch = _steady_steps_per_s(method)
    opt = method.optimizer
    db = method._to_device(loader_batch)
    model.train()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    with torch.profiler.profile(activities=acts) as prof:
        ev[0].record()
        slots = db["slots"]
        pred = model.rollouter(slots[:, :model.history_len], model.rollout_len)
        losses = model.calc_train_loss(
            db, {"gt_slots": slots[:, model.history_len:], "pred_slots": pred})
        ev[1].record()
        # the chunked branch: every chunk's decode and its backward to the
        # slots happen here, inside the loss's forward
        losses["img_recon_loss"] = model._chunked_img_recon_loss(db, pred, nc)
        ev[2].record()
        sum(weights.get(n, 1.0) * v for n, v in losses.items()).backward()
        ev[3].record()
        opt.step(method.it)
        opt.zero_grad()
        ev[4].record()
        torch.cuda.synchronize()
    ro_ms, img_ms, bwd_ms, opt_ms = (ev[i].elapsed_time(ev[i + 1])
                                     for i in range(4))
    step_ms = ro_ms + img_ms + bwd_ms + opt_ms
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    conv_ms = sum(e.self_device_time_total for e in kernels
                  if any(w in e.key.lower() for w in
                         ("conv", "cudnn", "dgrad", "wgrad", "winograd", "fft"))) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    top_kernels = [(e.key[:80], e.count, e.self_device_time_total / 1e3)
                   for e in top]
    del prof, losses, pred

    def branch_step(held=None):
        model.zero_grad(set_to_none=True)
        ls = model.train_loss(db)
        total = sum(weights.get(n, 1.0) * v for n, v in ls.items())
        if held is not None:  # what the graph keeps for the backward
            torch.cuda.synchronize()
            held.append(torch.cuda.memory_allocated())
        total.backward()

    by_branch = {}
    for branch in BRANCHES:
        _set_branch(model, branch)
        model.zero_grad(set_to_none=True)
        torch.cuda.empty_cache()
        branch_step()  # warm-up: cuDNN algorithm choice, allocator
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        _, bdt = wall_s(lambda: [branch_step() for _ in range(2)])
        peak, held = torch.cuda.max_memory_allocated(), []
        branch_step(held)
        # peak: the most allocated at any moment of a step, cuDNN's
        # workspaces included; held: what is allocated between the forward
        # and the backward (the saved state); both over what is resident
        by_branch[branch] = dict(
            fwd_bwd_ms=1e3 * bdt / 2, max_memory_allocated_gb=peak / 1e9,
            peak_over_resident_gb=(peak - base) / 1e9,
            held_for_backward_gb=(held[0] - base) / 1e9)
    model.zero_grad(set_to_none=True)
    _set_branch(model, "chunked")
    ok = (steps == method.total_steps and steps >= 4 and finite and ramp_ok
          and frozen and reloaded and last.endswith(f"model_{steps}.pth")
          and videos == [f"rollout_{steps}.mp4"])
    emit(phase="train_slotformer", check="fit", config="slotformer_clevrer",
         batch=B, frames_per_clip=params.n_sample_frames,
         rollout_frames_per_step=B * model.rollout_len, branch_of_config="chunked",
         chunks=nc, steps=steps, fit_seconds=fit_s, finite=finite,
         loss_decay_factors=factors, ramp_ok=ramp_ok, decoder_bit_frozen=frozen,
         checkpoint=os.path.basename(last), reloaded=reloaded, videos=videos,
         last_train=train_log[-1] if train_log else None,
         steps_per_s=steps_per_s,
         rollout_frames_per_s=steps_per_s * B * model.rollout_len,
         profiled_step=dict(rollouter_forward_ms=ro_ms,
                            img_loss_decoder_fwd_bwd_ms=img_ms,
                            backward_ms=bwd_ms, optimizer_ms=opt_ms,
                            decoder_share=img_ms / step_ms,
                            conv_kernels_ms=conv_ms,
                            top_kernels_name_count_ms=top_kernels),
         step_by_branch=by_branch, ok=ok)
    if not ok:
        raise AssertionError("SlotFormer training check failed")
    return last


def phase_test_vp(slots_path, weight, workdir):
    import numpy as np
    import torch

    from slotformer_tpu_torch.cli import test_vp
    from slotformer_tpu_torch.datasets import build_dataset
    from slotformer_tpu_torch.metrics import (load_lpips, masks_to_boxes,
                                              postproc_mask, pred_eval_step)
    from slotformer_tpu_torch.models import build_model
    from slotformer_tpu_torch.runtime import load_checkpoint, load_params

    # the evaluation clip is 6 + 42 frames of the 48-frame videos, frame by
    # frame (the synthetic dataset evaluates video_len frames)
    cfg = os.path.join(workdir, "slotformer_synth_params.py")
    with open(cfg, "w") as f:
        f.write(
            "from slotformer_tpu_torch.runtime import load_params\n\n"
            "Shipped = type(load_params("
            f"{os.path.join(CONFIGS, 'slotformer_clevrer_params.py')!r}))\n\n\n"
            "class SlotFormerParams(Shipped):\n"
            "    dataset = 'synthetic_slots'\n"
            f"    slots_root = {slots_path!r}\n"
            f"    video_len = {SF_DATA['video_len']}\n"
            f"    num_videos_val = {SF_DATA['num_videos_val']}\n"
            "    frame_offset = 1\n    num_workers = 4\n")
    vis = os.path.join(workdir, "vis")
    stats, dt = wall_s(lambda: test_vp.main(
        ["--params", cfg, "--weight", weight, "--batch_size", "8",
         "--vis_dir", vis, "--device", DEVICE]), k3_path="test_vp")
    T_ro = SF_DATA["video_len"] - 6
    results = stats["results"]
    finite = (sorted(results) == sorted(test_vp.METRICS) and all(
        v.shape == (T_ro,) and np.isfinite(v).all() for v in results.values()))
    files = sorted(os.listdir(stats["save_dir"]))
    files_ok = (sum(f.endswith(".npy") for f in files) == 8
                and sum(f.endswith(".mp4") for f in files) == 3)
    steady = stats["seconds_fwd"] + stats["seconds_metrics"]

    # one pred_eval_step on the card against the same call on the CPU
    params = test_vp.adjust_params(load_params(cfg), 8)
    val_set = build_dataset(params, val_only=True)
    items = [val_set[i] for i in range(2)]
    b = {k: np.stack([it[k] for it in items])[:, 6:]
         for k in ("slots", "img", "mask", "bbox", "pres_mask")}
    model = build_model(params, device=DEVICE)
    model.load_state_dict(load_checkpoint(weight)["state_dict"])
    with torch.no_grad():
        out = model({"slots": torch.from_numpy(
            np.stack([it["slots"] for it in items])).to(DEVICE)})
        pred_mask = postproc_mask(out["masks"])
        pred_bbox = masks_to_boxes(pred_mask, 7)
    pred = out["recon_combined"]
    kw = dict(gt=b["img"], gt_mask=b["mask"].astype(np.int32),
              gt_pres_mask=b["pres_mask"].astype(bool), gt_bbox=b["bbox"],
              eval_traj=True, num_classes=7)
    on_card = pred_eval_step(
        pred=pred, pred_mask=pred_mask, pred_bbox=pred_bbox,
        lpips_fn=load_lpips("", fallback="untrained", device=DEVICE), **kw)
    on_cpu = pred_eval_step(
        pred=pred.cpu(), pred_mask=pred_mask.cpu(), pred_bbox=pred_bbox.cpu(),
        lpips_fn=load_lpips("", fallback="untrained", device="cpu"), **kw)
    errs = {}
    for k in on_cpu:
        a, c = np.array(on_card[k]), np.array(on_cpu[k])
        if k in ("mse", "psnr", "ssim", "percept_dist"):
            errs[k] = float(np.abs(a / c - 1).max())
        else:
            errs[k] = float(np.abs(a - c).max())
    agree = (all(errs[k] <= VP_PIXEL_RTOL
                 for k in ("mse", "psnr", "ssim", "percept_dist"))
             and all(errs[k] <= VP_CLUSTER_ATOL for k in ("ari", "fari", "miou"))
             and errs["ap"] == 0.0 and errs["ar"] == 0.0)
    ok = (finite and files_ok and stats["traj"]["batches"] > 0
          and stats["percept_dist_source"] == "untrained" and agree
          and stats["steady_frames"] > 0)
    emit(phase="test_vp", config="slotformer_clevrer", batch=8, history=6,
         rollout=T_ro, batches=stats["traj"]["batches"], seconds=dt,
         first_batch_seconds=stats["seconds_first_batch"],
         steady_frames=stats["steady_frames"],
         frames_per_s_with_metrics=stats["steady_frames"] / steady,
         frames_per_s_forward_only=stats["steady_frames"] / stats["seconds_fwd"],
         metrics_share=stats["seconds_metrics"] / steady,
         means={k: float(v.mean()) for k, v in results.items()},
         traj=stats["traj"], percept_dist_source=stats["percept_dist_source"],
         finite=finite, files_ok=files_ok,
         card_vs_cpu=dict(errors=errs, pixel_rtol=VP_PIXEL_RTOL,
                          cluster_atol=VP_CLUSTER_ATOL, discrete="equal",
                          ok=agree),
         ok=ok)
    if not ok:
        raise AssertionError("test_vp check failed")


# ------------------------------------------------------- OBJ3D and Aloe VQA

# the OBJ3D tree: synthetic 64x64 videos of video_len + 1 = 51 PNG frames
# (get_video reads 51); 12 training videos give 8 SAVi steps of 64 clips
# (45 starts a video) and 3 SlotFormer steps of 128 (35 starts a video); 24
# val videos give test_vp 2 batches of 12
OBJ3D = dict(video_len=50, train=12, val=24, test=2, extract_batch=8,
             chunk_len=17)
# the Aloe phase: 8 + 2 + 2 CLEVRER-shaped 128-frame videos, each scene 40
# descriptive and 20 multiple-choice questions of 4 choices (120 rows)
VQA = dict(video_len=128, train=8, val=2, test=2, extract_batch=8,
           chunk_len=32, descriptive=40, multiple_choice=20, choices=4)
# One Aloe train step at B=2 card against CPU, float32 with dropout off: 12
# transformer layers over 208 tokens, and back (as TRAIN_*).
VQA_LOSS_RTOL, VQA_GRAD_RTOL = 1e-4, 1e-3
# A ReLU's input within rounding of 0 may fall on one side on the card and on
# the other on the CPU. The gradient then differs by that unit's whole share,
# which no rounding tolerance covers: on an NVIDIA H100 80GB HBM3 at 700 W,
# 20 of 48 Aloe steps had such units and 5 went past VQA_GRAD_RTOL (up to
# 2.9e-3), every unit at |input| under 2e-7 of its call's largest; with
# the sides tied all 48 sat at 2.5e-6 or less
# (experiments/torch_relu_tie_probe.py). So the steps held card against CPU
# through transformer stacks run the CPU at the card's sides
# (``_tied_pair``), and every unit whose side the CPU would have taken
# otherwise must lie within RELU_TIE_RTOL of its call's largest |input|.
RELU_TIE_RTOL = 1e-5


def derived_params(workdir, name, **over):
    """The shipped config ``name`` with ``over`` set, written as
    ``workdir/<name>.py`` (a config's file name names its runs)."""
    from slotformer_tpu_torch.runtime import load_params

    path = os.path.join(workdir, f"{name}.py")
    lines = "".join(f"    {k} = {v!r}\n" for k, v in over.items())
    with open(path, "w") as f:
        f.write("from slotformer_tpu_torch.runtime import load_params\n\n"
                "Shipped = type(load_params("
                f"{os.path.join(CONFIGS, name + '.py')!r}))\n\n\n"
                "class SlotFormerParams(Shipped):\n" + (lines or "    pass\n"))
    return path, load_params(path)


def _dropout_off(model):
    import torch

    for mod in model.modules():
        if isinstance(mod, torch.nn.Dropout):
            mod.p = 0.0
        elif isinstance(getattr(mod, "dropout", None), float):
            mod.dropout = 0.0  # attention dropout


def _k1_step_check(phase, params, batch, seed, prepare=None):
    """One float32 train step at B=2 of a model that runs K1: the card
    against the CPU and against the card with K1 swapped for its plain
    version (losses, every gradient), in training mode with every dropout
    at 0 (a cuDNN LSTM differentiates only in training mode). ``prepare``
    grafts and freezes what the trainer would, on each model."""
    from unittest import mock

    import torch

    from slotformer_tpu_torch.kernels import slot_attention as k1
    from slotformer_tpu_torch.models import build_model
    from slotformer_tpu_torch.models import slot_attention as sa_module

    weights = params.loss_weights()
    torch.manual_seed(seed)
    gpu = build_model(params, device=DEVICE)
    if prepare:
        prepare(gpu)
    cpu = build_model(params, device="cpu")
    cpu.load_state_dict(gpu.state_dict())
    for m in (gpu, cpu):
        if prepare:
            prepare(m)
        m.train()
        _dropout_off(m)

    def one_step(model, device):
        model.zero_grad(set_to_none=True)
        losses = model.train_loss({k: v.to(device) for k, v in batch.items()})
        sum(weights.get(n, 1.0) * v for n, v in losses.items()).backward()
        return ({n: v.item() for n, v in losses.items()},
                {n: p.grad.detach().cpu() for n, p in model.named_parameters()
                 if p.grad is not None})

    l_cpu, g_cpu = one_step(cpu, "cpu")
    l_gpu, g_gpu = one_step(gpu, DEVICE)
    with mock.patch.object(sa_module, "fused_slot_attention",
                           k1.fused_slot_attention_plain):
        l_plain, g_plain = one_step(gpu, DEVICE)
    rel = lambda a, b: abs(a / b - 1) if b else abs(a - b)  # noqa: E731
    loss_err_cpu = max(rel(l_gpu[n], l_cpu[n]) for n in l_cpu)
    loss_err_plain = max(rel(l_gpu[n], l_plain[n]) for n in l_plain)
    grad_err_cpu, worst_cpu = _grad_errors(g_gpu, g_cpu)
    grad_err_plain, worst_plain = _grad_errors(g_gpu, g_plain)
    ok = (max(loss_err_cpu, loss_err_plain) <= TRAIN_LOSS_RTOL
          and max(grad_err_cpu, grad_err_plain) <= TRAIN_GRAD_RTOL
          and len(g_cpu) == len(g_gpu) > 0)
    emit(phase=phase, check="one_step", batch=2, losses_card=l_gpu,
         losses_cpu=l_cpu, loss_rel_err_vs_cpu=loss_err_cpu,
         loss_rel_err_vs_plain_k1=loss_err_plain,
         grad_rel_err_vs_cpu=grad_err_cpu, worst_param_vs_cpu=worst_cpu,
         grad_rel_err_vs_plain_k1=grad_err_plain,
         worst_param_vs_plain_k1=worst_plain, n_params=len(g_cpu),
         tol_loss_rtol=TRAIN_LOSS_RTOL, tol_grad_rel=TRAIN_GRAD_RTOL, ok=ok)
    if not ok:
        raise AssertionError(
            f"{phase} train step: the card disagrees with the CPU (loss "
            f"{loss_err_cpu:.3g}, gradient {grad_err_cpu:.3g} at {worst_cpu}) "
            f"or with the plain K1 (loss {loss_err_plain:.3g}, gradient "
            f"{grad_err_plain:.3g} at {worst_plain})")


def _profiled_step(method, batch):
    """One train step of ``method`` on ``batch`` under ``torch.profiler``:
    forward, backward and optimizer ms (CUDA events), K1's kernels and the
    largest kernels."""
    import torch
    from torch.autograd import DeviceType

    weights = method.params.loss_weights()
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
    step_ms = fwd_ms + bwd_ms + opt_ms
    # device time of the kernels themselves (the CPU ops that launched them
    # carry the same time and are left out)
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    k1_ms = sum(e.self_device_time_total for e in kernels
                if "fused_slot_attention_" in e.key) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    return dict(forward_ms=fwd_ms, backward_ms=bwd_ms, optimizer_ms=opt_ms,
                backward_share=bwd_ms / step_ms,
                k1_forward_kernel_ms=k1_ms, k1_forward_share=k1_ms / step_ms,
                top_kernels_name_count_ms=[
                    (e.key[:80], e.count, e.self_device_time_total / 1e3)
                    for e in top])


def phase_obj3d_tree(workdir):
    """A mini OBJ3D tree under ``workdir/data/OBJ3D``: ``<split>/<video>/
    test_{1..51}.png``, 64x64 frames of the synthetic renderer."""
    import numpy as np
    from PIL import Image

    from slotformer_tpu_torch.datasets.synthetic import _render_video

    t0 = time.perf_counter()
    T, n_frames, seed = OBJ3D["video_len"] + 1, 0, 100
    for split in ("train", "val", "test"):
        for i in range(OBJ3D[split]):
            folder = os.path.join(workdir, "data", "OBJ3D", split, f"{split}_{i:03d}")
            os.makedirs(folder)
            video, _ = _render_video(seed, T, 64, 5)
            seed += 1
            for t, frame in enumerate(video):
                Image.fromarray(((frame + 1) * 127.5).round().astype(np.uint8)).save(
                    os.path.join(folder, f"test_{t + 1}.png"))
            n_frames += T
    emit(phase="obj3d_tree", videos={s: OBJ3D[s] for s in ("train", "val", "test")},
         frames=n_frames, resolution=[64, 64], seconds=time.perf_counter() - t0,
         ok=True)


def phase_train_savi_obj3d(workdir):
    """The deterministic SAVi of ``savi_obj3d_params`` (6 slots x 128, a
    2-layer transformer predictor in an LSTM, ``kld_method='none'``, B=64
    clips of 6 frames) on the tree: one B=2 step card against CPU and
    against the plain K1; then ``cli.train.run`` for one epoch. Its
    checkpoint becomes ``pretrained/savi_obj3d_params/model.pth``, the
    decoder the OBJ3D SlotFormer config grafts. Returns (checkpoint, K1
    launches of the fit)."""
    import numpy as np
    import torch

    from slotformer_tpu_torch.cli import train as train_cli
    from slotformer_tpu_torch.datasets import build_dataset
    from slotformer_tpu_torch.kernels import slot_attention as k1
    from slotformer_tpu_torch.runtime import latest_checkpoint

    _, params = derived_params(workdir, "savi_obj3d_params", max_epochs=1,
                               eval_interval=1, print_iter=1, num_workers=4)
    T, B = params.n_sample_frames, params.train_batch_size
    train_set, val_set = build_dataset(params)
    batch = {"img": torch.from_numpy(np.stack(
        [train_set[i]["img"] for i in (0, len(train_set) // 2)]))}
    _k1_step_check("train_savi_obj3d", params, batch, seed=11)

    ckp = os.path.join(workdir, "ckpts", "savi_obj3d_params")
    params.seed = 0
    k1.LAUNCHES = 0
    method, fit_s = wall_s(lambda: train_cli.run(
        params, ckp, device=DEVICE, san_check_val_step=1), k3_path="obj3d_train")
    launches, steps = k1.LAUNCHES, method.it
    val_batches = 1 + len(method.val_loader)  # sanity check + epoch end
    # the decomposition video encodes n_samples whole val videos of
    # video_len + 1 frames, one K1 call a frame
    sampled = min(int(params.n_samples), len(val_set.files))
    expected = T * (steps + val_batches) + sampled * (OBJ3D["video_len"] + 1)
    log, train_log = _read_log(ckp)
    last = latest_checkpoint(ckp)
    reloaded = _reloads(method, params, ckp)
    _link_pretrained("savi_obj3d_params", last)
    steps_per_s, batch = _steady_steps_per_s(method)
    prof = _profiled_step(method, batch)
    ok = (steps == OBJ3D["train"] * 45 // B and launches == expected
          and _finite(log) and reloaded and last.endswith(f"model_{steps}.pth")
          and all(r["kld_loss"] == 0.0 for r in train_log))
    emit(phase="train_savi_obj3d", check="fit", config="savi_obj3d_params",
         batch=B, frames_per_clip=T, steps=steps, fit_seconds=fit_s,
         k1_launches=launches, k1_launches_expected=expected,
         val_batches=val_batches, finite=_finite(log),
         checkpoint=os.path.basename(last), reloaded=reloaded,
         last_train=train_log[-1] if train_log else None,
         steps_per_s=steps_per_s, frames_per_s=steps_per_s * B * T,
         profiled_step=prof, ok=ok)
    if not ok:
        raise AssertionError("OBJ3D SAVi training check failed")
    return last, launches


def phase_obj3d_slots(workdir, savi_ckp):
    """The trained OBJ3D SAVi over every train and val video through
    ``extract_video_slots`` (K1 once a frame step a batch), written as
    ``data/OBJ3D/obj3d_slots.pkl``, the shipped config's ``slots_root``.
    Returns the K1 launches."""
    import numpy as np

    from slotformer_tpu_torch.cli.extract_slots import extract_video_slots
    from slotformer_tpu_torch.datasets import build_dataset
    from slotformer_tpu_torch.kernels import slot_attention as k1
    from slotformer_tpu_torch.models import build_model
    from slotformer_tpu_torch.runtime import dump_obj, load_checkpoint

    _, params = derived_params(workdir, "savi_obj3d_params")
    model = build_model(params, device=DEVICE)
    model.load_state_dict(load_checkpoint(savi_ckp)["state_dict"])
    sets = dict(zip(("train", "val"), build_dataset(params)))
    bs, T = OBJ3D["extract_batch"], OBJ3D["video_len"] + 1
    # the host's share: reading every video's PNG frames, as the
    # extraction reads them
    _, read_s = wall_s(lambda: [ds.get_video(i) for ds in sets.values()
                                for i in range(len(ds.files))])
    k1.LAUNCHES = 0
    slots, dt = wall_s(lambda: {
        split: extract_video_slots(model, ds, bs, OBJ3D["chunk_len"])
        for split, ds in sets.items()}, k3_path="obj3d_extract")
    launches = k1.LAUNCHES
    dump_obj(slots, os.path.join(workdir, "data", "OBJ3D", "obj3d_slots.pkl"))
    frame_steps = sum(-(-len(ds.files) // bs) for ds in sets.values()) * T
    S, D = params.slot_dict["num_slots"], params.slot_dict["slot_size"]
    shapes_ok = all(s.shape == (T, S, D) and s.dtype == np.float32
                    and np.isfinite(s).all()
                    for v in slots.values() for s in v.values())
    n_videos = sum(len(v) for v in slots.values())
    ok = (shapes_ok and launches == frame_steps
          and {k: len(v) for k, v in slots.items()}
          == {"train": OBJ3D["train"], "val": OBJ3D["val"]})
    emit(phase="obj3d_slots", config="savi_obj3d_params", videos=n_videos,
         frames=T, chunk_len=OBJ3D["chunk_len"], seconds=dt,
         frames_per_s=n_videos * T / dt, png_read_seconds=read_s,
         k1_launches=launches,
         frame_steps=frame_steps, shapes_ok=shapes_ok, ok=ok)
    if not ok:
        raise AssertionError("OBJ3D slot extraction check failed")
    return launches


def phase_train_slotformer_obj3d(workdir, savi_ckp):
    """SlotFormer at the full ``slotformer_obj3d_params`` width (6 slots x
    128, d_model 128, 4 layers, 8 heads, 6 + 10 frames at offset 1, B=128)
    on the extracted slots, the decoder grafted from the SAVi the phase
    before trained through the config's own ``dec_ckp_path``: one B=2 step
    card against CPU; ``cli.train.run`` for one epoch. Returns the
    checkpoint's path."""
    import numpy as np
    import torch

    from slotformer_tpu_torch.cli import train as train_cli
    from slotformer_tpu_torch.datasets import build_dataset
    from slotformer_tpu_torch.models import build_model
    from slotformer_tpu_torch.runtime import graft, latest_checkpoint, load_checkpoint

    _, params = derived_params(workdir, "slotformer_obj3d_params", max_epochs=1,
                               eval_interval=1, print_iter=1, num_workers=4)
    B, weights = params.train_batch_size, params.loss_weights()
    savi_sd = load_checkpoint(savi_ckp)["state_dict"]
    train_set, _ = build_dataset(params)
    items = [train_set[i] for i in (0, len(train_set) // 2)]
    batch = {k: torch.from_numpy(np.stack([it[k] for it in items]))
             for k in ("slots", "img")}
    torch.manual_seed(12)
    gpu = build_model(params, device=DEVICE)
    gpu.load_state_dict(graft(gpu.state_dict(), savi_sd,
                              ("decoder", "decoder_pos_embedding")))
    cpu = build_model(params, device="cpu")
    cpu.load_state_dict(gpu.state_dict())
    for m in (gpu, cpu):
        for n, p in m.named_parameters():
            p.requires_grad_(not n.startswith("decoder"))
    (l_gpu, g_gpu, _), (l_cpu, g_cpu, _), ties = _tied_pair(
        lambda: _sf_step(gpu, {k: v.to(DEVICE) for k, v in batch.items()},
                         weights),
        lambda: _sf_step(cpu, batch, weights))
    loss_err = max(abs(l_gpu[n] / l_cpu[n] - 1) for n in l_cpu)
    grad_err, worst = _grad_errors(g_gpu, g_cpu)
    step_ok = (loss_err <= SF_LOSS_RTOL and grad_err <= SF_GRAD_RTOL
               and ties["untied_rel_x"] <= RELU_TIE_RTOL
               and len(g_gpu) == len(g_cpu) > 0)
    emit(phase="train_slotformer_obj3d", check="one_step", batch=2,
         losses_card=l_gpu, loss_rel_err_vs_cpu=loss_err,
         grad_rel_err_vs_cpu=grad_err, worst_param=worst, relu=ties,
         n_grads=len(g_cpu), tol_loss_rtol=SF_LOSS_RTOL,
         tol_grad_rel=SF_GRAD_RTOL, tol_relu_tie=RELU_TIE_RTOL, ok=step_ok)
    if not step_ok:
        raise AssertionError(f"OBJ3D SlotFormer train step: the card disagrees "
                             f"with the CPU (loss {loss_err:.3g}, gradient "
                             f"{grad_err:.3g} at {worst}, ReLU {ties})")
    del gpu, cpu

    ckp = os.path.join(workdir, "ckpts", "slotformer_obj3d_params")
    params.seed = 0
    method, fit_s = wall_s(lambda: train_cli.run(
        params, ckp, device=DEVICE, san_check_val_step=1),
        k3_path="obj3d_slotformer_train")
    model, steps = method.model, method.it
    log, train_log = _read_log(ckp)
    sd = {k: v.cpu() for k, v in model.state_dict().items()}
    dec_keys = [k for k in sd if k.startswith("decoder")]
    frozen = len(dec_keys) > 0 and all(torch.equal(sd[k], savi_sd[k])
                                       for k in dec_keys)
    last = latest_checkpoint(ckp)
    reloaded = _reloads(method, params, ckp)
    steps_per_s, _ = _steady_steps_per_s(method)
    ok = (steps == method.total_steps == OBJ3D["train"] * 35 // B
          and _finite(log) and frozen and reloaded
          and last.endswith(f"model_{steps}.pth"))
    emit(phase="train_slotformer_obj3d", check="fit",
         config="slotformer_obj3d_params", batch=B,
         frames_per_clip=params.n_sample_frames, steps=steps,
         fit_seconds=fit_s, finite=_finite(log), decoder_bit_frozen=frozen,
         decoder_tensors=len(dec_keys), checkpoint=os.path.basename(last),
         reloaded=reloaded, last_train=train_log[-1] if train_log else None,
         steps_per_s=steps_per_s,
         rollout_frames_per_s=steps_per_s * B * model.rollout_len, ok=ok)
    if not ok:
        raise AssertionError("OBJ3D SlotFormer training check failed")
    return last


def phase_test_vp_obj3d(workdir, weight):
    """``cli.test_vp`` on the OBJ3D SlotFormer just trained: 6 burn-in + 44
    rollout frames of every val video, batch 12, no masks (only the pixel
    metrics are scored); every metric finite; frames/s."""
    import numpy as np

    from slotformer_tpu_torch.cli import test_vp

    cfg, _ = derived_params(workdir, "slotformer_obj3d_params")
    vis = os.path.join(workdir, "vis")
    stats, dt = wall_s(lambda: test_vp.main(
        ["--params", cfg, "--weight", weight, "--vis_dir", vis,
         "--device", DEVICE]), k3_path="obj3d_test_vp")
    T_ro = OBJ3D["video_len"] - 6
    results = stats["results"]
    finite = (sorted(results) == sorted(test_vp.METRICS) and all(
        v.shape == (T_ro,) and np.isfinite(v).all() for v in results.values()))
    unscored = all(not results[m].any() for m in ("ari", "fari", "miou", "ar"))
    files = sorted(os.listdir(stats["save_dir"]))
    files_ok = (sum(f.endswith(".npy") for f in files) == 8
                and [f for f in files if f.endswith(".mp4")]
                == ["slotformer_obj3d_params.mp4"])
    steady = stats["seconds_fwd"] + stats["seconds_metrics"]
    ok = (finite and unscored and files_ok and stats["traj"]["batches"] == 0
          and stats["steady_frames"] == (OBJ3D["val"] - 12) * T_ro)
    emit(phase="test_vp_obj3d", config="slotformer_obj3d_params", batch=12,
         history=6, rollout=T_ro, seconds=dt,
         first_batch_seconds=stats["seconds_first_batch"],
         steady_frames=stats["steady_frames"],
         frames_per_s_with_metrics=stats["steady_frames"] / steady,
         frames_per_s_forward_only=stats["steady_frames"] / stats["seconds_fwd"],
         metrics_share=stats["seconds_metrics"] / steady,
         means={k: float(v.mean()) for k, v in results.items()},
         percept_dist_source=stats["percept_dist_source"], finite=finite,
         mask_metrics_unscored=unscored, files_ok=files_ok, ok=ok)
    if not ok:
        raise AssertionError("OBJ3D test_vp check failed")


def _vqa_questions(names, first_scene, seed):
    """CLEVRER-format scenes over ``names``: descriptive questions with
    answers, and explanatory, predictive and counterfactual questions with
    choices, of vocab words."""
    import numpy as np

    from slotformer_tpu_torch.datasets.clevrer_vqa import _VOCAB_CACHE
    from slotformer_tpu_torch.runtime import load_obj

    vocab = load_obj(_VOCAB_CACHE)
    words = [w for w in vocab["q_vocab"] if w != "PAD"]
    answers = [a for a in vocab["a_vocab"] if a != "PAD"]
    r = np.random.default_rng(seed)
    text = lambda lo, hi: " ".join(r.choice(words, r.integers(lo, hi + 1)))  # noqa: E731
    scenes = []
    for i, name in enumerate(names):
        qs = [{"question_id": q, "question_type": "descriptive",
               "question": text(4, 20) + "?", "answer": str(r.choice(answers))}
              for q in range(VQA["descriptive"])]
        for q in range(VQA["multiple_choice"]):
            qs.append({"question_id": VQA["descriptive"] + q,
                       "question_type": ("explanatory", "predictive",
                                         "counterfactual")[q % 3],
                       "question": text(4, 20) + "?",
                       "choices": [{"choice_id": c, "choice": text(2, 12),
                                    "answer": ("correct" if r.random() < 0.5
                                               else "wrong")}
                                   for c in range(VQA["choices"])]})
        scenes.append({"scene_index": first_scene + i, "video_filename": name,
                       "questions": qs})
    return scenes


def phase_vqa(workdir, savi_ckp, sf_weight):
    """The Aloe VQA head on CLEVRER-shaped data: 128-frame synthetic videos
    encoded through K1 by the StoSAVi phase ``train`` trained, extended to
    160 frames by ``cli.rollout_slots --task clevrer`` on the SlotFormer
    ``train_slotformer`` trained, a question file per split; then for both
    shipped configs (ground-truth and rollout slots): a B=2 step card
    against CPU, ``cli.train.run`` at full width and B=256 rows,
    ``cli.test_clevrer_vqa`` on the test and the val split. Returns the K1
    launches of the extraction."""
    import numpy as np
    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from slotformer_tpu_torch.cli import rollout_slots, test_clevrer_vqa
    from slotformer_tpu_torch.cli import train as train_cli
    from slotformer_tpu_torch.cli.extract_slots import extract_video_slots
    from slotformer_tpu_torch.datasets import SyntheticVideoDataset, build_dataset
    from slotformer_tpu_torch.kernels import slot_attention as k1
    from slotformer_tpu_torch.models import build_model
    from slotformer_tpu_torch.runtime import (dump_obj, load_checkpoint, load_obj,
                                              load_params)

    root = os.path.join(workdir, "data", "CLEVRER")
    savi_params = load_params(os.path.join(CONFIGS, "stosavi_clevrer_params.py"))
    savi = build_model(savi_params, device=DEVICE)
    savi.load_state_dict(load_checkpoint(savi_ckp)["state_dict"])
    T, bs = VQA["video_len"], VQA["extract_batch"]
    sets = {split: SyntheticVideoDataset(
                split, num_videos=VQA[split], video_len=T, resolution=(64, 64),
                frame_offset=1) for split in ("train", "val", "test")}
    k1.LAUNCHES = 0
    gt, extract_s = wall_s(lambda: {
        split: extract_video_slots(savi, ds, bs, VQA["chunk_len"])
        for split, ds in sets.items()}, k3_path="vqa_extract")
    launches = k1.LAUNCHES
    gt_path = os.path.join(root, "clevrer_slots.pkl")
    dump_obj(gt, gt_path)
    frame_steps = sum(-(-len(ds.files) // bs) for ds in sets.values()) * T
    del savi

    sf_cfg, _ = derived_params(workdir, "slotformer_clevrer_params",
                               slots_root=gt_path)
    ro_path = os.path.join(root, "rollout_clevrer_slots.pkl")
    _, rollout_s = wall_s(lambda: rollout_slots.main(
        ["--task", "clevrer", "--params", sf_cfg, "--weight", sf_weight,
         "--save_path", ro_path, "--device", DEVICE]))
    ro = load_obj(ro_path)
    S, D = savi_params.slot_dict["num_slots"], savi_params.slot_dict["slot_size"]
    rollout_ok = all(
        s.shape == (160, S, D) and np.isfinite(s).all()
        and np.array_equal(s[:T], gt[split][n])
        for split in gt for n, s in ro[split].items())
    for split, first in (("train", 0), ("val", 10000), ("test", 15000)):
        dump_obj(_vqa_questions(sorted(gt[split]), first, seed=first),
                 os.path.join(root, "questions", f"{split}.json"))
    ok = (launches == frame_steps and rollout_ok
          and sum(len(v) for v in gt.values()) == 12)
    emit(phase="vqa", check="slots", videos={k: len(v) for k, v in gt.items()},
         frames=T, extract_seconds=extract_s, k1_launches=launches,
         frame_steps=frame_steps, rollout_frames=160,
         rollout_seconds=rollout_s, rollout_ok=rollout_ok, ok=ok)
    if not ok:
        raise AssertionError("VQA slots check failed")

    for name, slots_path in (("aloe_clevrer_params", gt_path),
                             ("aloe_clevrer_params-rollout", ro_path)):
        cfg, params = derived_params(
            workdir, name, data_root=root, slots_root=slots_path, max_epochs=1,
            eval_interval=1, print_iter=1, num_workers=4)
        weights = params.loss_weights()
        train_set, val_set = build_dataset(params)
        # (a) a B=2 step, one descriptive and one choice row, dropout off
        rows = [0, next(i for i, r in enumerate(train_set.rows) if not r["is_cls"])]
        items = [train_set[i] for i in rows]
        batch = {k: torch.from_numpy(np.stack([np.asarray(it[k]) for it in items]))
                 for k in ("video_emb", "q_tokens", "q_pad_mask", "is_cls", "label")}
        torch.manual_seed(13)
        gpu = build_model(params, device=DEVICE)
        cpu = build_model(params, device="cpu")
        cpu.load_state_dict(gpu.state_dict())
        def step(m, dev):
            m.eval()  # dropout off; train_loss does not look at the mode
            losses = m.train_loss({k: v.to(dev) for k, v in batch.items()})
            sum(weights.get(n, 1.0) * v for n, v in losses.items()).backward()
            return ({n: v.item() for n, v in losses.items()},
                    {n: p.grad.detach().cpu() for n, p in m.named_parameters()})

        (l_gpu, g_gpu), (l_cpu, g_cpu), ties = _tied_pair(
            lambda: step(gpu, DEVICE), lambda: step(cpu, "cpu"))
        loss_err = max(abs(l_gpu[n] / l_cpu[n] - 1) for n in l_cpu)
        grad_err, worst = _grad_errors(g_gpu, g_cpu)
        step_ok = (loss_err <= VQA_LOSS_RTOL and grad_err <= VQA_GRAD_RTOL
                   and ties["untied_rel_x"] <= RELU_TIE_RTOL
                   and len(g_gpu) == len(g_cpu) > 0)
        emit(phase="vqa", config=name, check="one_step", batch=2,
             losses_card=l_gpu, loss_rel_err_vs_cpu=loss_err,
             grad_rel_err_vs_cpu=grad_err, worst_param=worst, relu=ties,
             n_params=len(g_cpu), tol_loss_rtol=VQA_LOSS_RTOL,
             tol_grad_rel=VQA_GRAD_RTOL, tol_relu_tie=RELU_TIE_RTOL, ok=step_ok)
        if not step_ok:
            raise AssertionError(
                f"Aloe train step ({name}): the card disagrees with the CPU "
                f"(loss {loss_err:.3g}, gradient {grad_err:.3g} at {worst}, "
                f"ReLU {ties})")
        del gpu, cpu

        # (b) one epoch through the CLI's code, question-level validation
        ckp = os.path.join(workdir, "ckpts", name)
        params.seed = 0
        method, fit_s = wall_s(lambda: train_cli.run(
            params, ckp, device=DEVICE, san_check_val_step=1))
        steps = method.it
        log, train_log = _read_log(ckp)
        val_log = [r for r in log if r["phase"] == "val"]
        scored = bool(val_log) and all(
            f"{q}_acc" in val_log[-1] for q in
            ("descriptive", "choice", "multiple-choice", "explanatory",
             "predictive", "counterfactual"))
        steps_per_s, loader_batch = _steady_steps_per_s(method)
        prof = None
        if name == "aloe_clevrer_params":
            prof = _profiled_step(method, loader_batch)
            # which of PyTorch's attention back ends take this layer's call
            # (8 heads of 18 over 208 tokens, a key-padding mask, float32)
            B, L = params.train_batch_size, method.model.transformer_model.input_len
            q = torch.randn(B, 8, L, 18, device=DEVICE)
            mask = torch.ones(B, 1, 1, L, dtype=torch.bool, device=DEVICE)
            mask[..., -12:] = False
            backends = {}
            for be in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                       SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
                try:
                    with sdpa_kernel([be]):
                        torch.nn.functional.scaled_dot_product_attention(
                            q, q, q, attn_mask=mask)
                    torch.cuda.synchronize()
                    backends[be.name] = True
                except RuntimeError:
                    backends[be.name] = False
            prof["sdpa_backends_taking_the_call"] = backends
        # (c) the eval CLI on the test split (the submission) and on val
        weight = os.path.join(ckp, f"model_{steps}.pth")
        sub_path = os.path.join(workdir, f"{name}_CLEVRER.json")
        results, test_s = wall_s(lambda: test_clevrer_vqa.main(
            ["--params", cfg, "--weight", weight, "--split", "test",
             "--save_path", sub_path, "--device", DEVICE]))
        asked = load_obj(os.path.join(root, "questions", "test.json"))
        answered = {s["scene_index"]: s["questions"] for s in results
                    if s["questions"]}
        answers_ok = (sorted(answered) == [s["scene_index"] for s in asked]
                      and all(len(answered[s["scene_index"]]) == len(s["questions"])
                              for s in asked)
                      and all(("answer" in q) != ("choices" in q)
                              for qs in answered.values() for q in qs)
                      and len(load_obj(sub_path)) == 5000)
        metrics, val_s = wall_s(lambda: test_clevrer_vqa.main(
            ["--params", cfg, "--weight", weight, "--split", "val",
             "--device", DEVICE]))
        # the model's forward alone over every val row at once, warm
        model = method.model.eval()
        vb = method._to_device(next(iter(type(method.val_loader)(
            val_set, batch_size=len(val_set), num_workers=4))))
        with torch.no_grad():
            model(vb)
            _, fwd_s = wall_s(lambda: [model(vb) for _ in range(5)])
        n_q = VQA["val"] * VQA["multiple_choice"]
        metrics_ok = (metrics["descriptive_n"] == VQA["val"] * VQA["descriptive"]
                      and metrics["multiple-choice_n"] == n_q
                      and all(0.0 <= metrics[f"{q}_acc"] <= 1.0 for q in
                              ("descriptive", "multiple-choice", "explanatory",
                               "predictive", "counterfactual")))
        # the trainer's question-level validation of the same weights agrees
        agree = all(abs(val_log[-1][f"{q}_acc"] - metrics[f"{q}_acc"]) <= 1e-6
                    for q in ("multiple-choice", "explanatory", "predictive",
                              "counterfactual"))
        ok = (steps == method.total_steps >= 3 and _finite(log) and scored
              and answers_ok and metrics_ok and agree)
        emit(phase="vqa", config=name, check="fit_and_eval",
             batch_rows=params.train_batch_size, train_rows=len(train_set),
             val_rows=len(val_set), steps=steps, fit_seconds=fit_s,
             finite=_finite(log), question_level_val=val_log[-1],
             steps_per_s=steps_per_s,
             rows_per_s=steps_per_s * params.train_batch_size,
             profiled_step=prof, test_seconds=test_s, answers_ok=answers_ok,
             val_metrics=metrics, val_seconds=val_s,
             eval_rows_per_s=len(val_set) / val_s,
             forward_rows_per_s=5 * len(val_set) / fwd_s,
             val_log_agrees_with_cli=agree, ok=ok)
        if not ok:
            raise AssertionError(f"Aloe check failed ({name})")
    return launches


# ------------------------------------------------------- the STEVE family


def physion_params(workdir, name, **over):
    """The shipped Physion config ``name`` with its data under ``workdir``,
    written as ``workdir/<name>.py`` (the dVAE's file name names its token
    tree)."""
    return derived_params(workdir, name,
                          data_root=os.path.join(workdir, "data", "Physion"),
                          video_len=PHYSION["video_len"], num_workers=4, **over)


def phase_physion_tree(workdir):
    """A mini Physion tree of frame folders rendered by the synthetic
    renderer, with split files; ``physion._SPLIT_DIR`` points at them."""
    import numpy as np
    from PIL import Image

    import cv2  # noqa: F401  (the frame readers' other library)
    from slotformer_tpu_torch.datasets import physion
    from slotformer_tpu_torch.datasets.synthetic import _render_video

    t0 = time.perf_counter()
    T, tasks = PHYSION["video_len"], ("Collide", "Roll", "Drop", "Support")
    splits_dir = os.path.join(workdir, "splits")
    os.makedirs(splits_dir)
    n_frames, seed = 0, 0
    for subset, split in (("training", "train"), ("training", "val"),
                          ("readout", "train"), ("readout", "val")):
        n = PHYSION[split if subset == "training" else f"readout_{split}"]
        listing = {}
        for i in range(n):
            task = tasks[i % len(tasks)]
            rel = f"PhysionTrainMP4s/{task}_{subset}_MP4s/{subset}_{split}_{i:02d}"
            folder = os.path.join(workdir, "data", "Physion", rel)
            os.makedirs(folder)
            video, _ = _render_video(seed, T, 128, 4)
            seed += 1
            for t, frame in enumerate(video):
                Image.fromarray(((frame + 1) * 127.5).round().astype(np.uint8)).save(
                    os.path.join(folder, f"{t:06d}.jpg"), quality=95)
            listing.setdefault(task, []).append(rel + ".mp4")
            n_frames += T
        with open(os.path.join(splits_dir, f"{subset}_{split}.json"), "w") as f:
            json.dump(listing, f)
    physion._SPLIT_DIR = splits_dir
    emit(phase="physion_tree", videos=n_frames // T, frames=n_frames,
         resolution=[128, 128], seconds=time.perf_counter() - t0, ok=True)


def _top2_gap(logits):
    top = logits.topk(2, dim=-1).values
    return top[..., 0] - top[..., 1]


def _link_pretrained(name, ckp_file):
    """``pretrained/<name>/model.pth`` (the shipped configs' path, relative
    to the working directory) -> the checkpoint a phase trained."""
    os.makedirs(os.path.join("pretrained", name), exist_ok=True)
    os.symlink(os.path.abspath(ckp_file),
               os.path.join("pretrained", name, "model.pth"))


def phase_train_dvae(workdir):
    """The full-width dVAE (vocab 4096, B=64, 128x128 frames) trained for
    one epoch through ``cli.train.run``; its checkpoint is the dVAE of every
    later Physion phase. Returns the checkpoint's path."""
    import numpy as np
    import torch

    from slotformer_tpu_torch.cli import train as train_cli
    from slotformer_tpu_torch.datasets import build_dataset
    from slotformer_tpu_torch.models import build_model
    from slotformer_tpu_torch.runtime import latest_checkpoint

    _, params = physion_params(workdir, "dvae_physion_params", max_epochs=1,
                               print_iter=1)
    B = params.train_batch_size

    # (a) one step at B=2, card against CPU, on the same gumbel uniforms
    train_set, _ = build_dataset(params)
    img = torch.from_numpy(np.stack([train_set[i]["img"]
                                     for i in (0, len(train_set) // 2)]))
    hw = (params.resolution[0] // 4, params.resolution[1] // 4)
    u = torch.rand(2, 1, *hw, params.vocab_size,
                   generator=torch.Generator().manual_seed(1))
    torch.manual_seed(8)
    gpu = build_model(params, device=DEVICE)
    cpu = build_model(params, device="cpu")
    cpu.load_state_dict(gpu.state_dict())
    f64 = build_model(params, device="cpu").double()
    f64.load_state_dict(gpu.state_dict())

    def one_step(model, device, dtype=torch.float32):
        model.train()
        model.zero_grad(set_to_none=True)
        batch = {"img": img.to(device, dtype)}
        out = model(batch, tau=0.55, uniform=u.to(device, dtype))
        losses = model.calc_train_loss(batch, out)
        losses["recon_loss"].backward()
        return ({n: v.item() for n, v in losses.items()},
                {n: p.grad.detach().cpu().double()
                 for n, p in model.named_parameters()})

    l_64, g_64 = one_step(f64, "cpu", torch.float64)
    errs = {}
    for side, (model, device) in (("card", (gpu, DEVICE)), ("cpu", (cpu, "cpu"))):
        losses, grads = one_step(model, device)
        errs[side] = dict(losses=losses,
                          loss_rel_err=max(abs(losses[n] / l_64[n] - 1) for n in l_64),
                          grad_rel_err=_grad_errors(grads, g_64))
        if side == "card":
            g_card = grads
        else:
            errs["card_vs_cpu_grad_rel_err"] = _grad_errors(g_card, grads)
    step_ok = all(errs[s]["loss_rel_err"] <= TRAIN_LOSS_RTOL
                  and errs[s]["grad_rel_err"][0] <= DVAE_GRAD_RTOL
                  for s in ("card", "cpu"))
    emit(phase="train_dvae", check="one_step", batch=2, tau=0.55,
         vs_cpu_float64=errs, n_params=len(g_64),
         tol_loss_rtol=TRAIN_LOSS_RTOL, tol_grad_rel=DVAE_GRAD_RTOL, ok=step_ok)
    if not step_ok:
        raise AssertionError("dVAE train step: the card or the CPU is off "
                             "the float64 step")
    del gpu, cpu, f64

    # (b) one epoch through the CLI's code
    ckp = os.path.join(workdir, "ckpts", "dvae_physion_params")
    params.seed = 0
    method, fit_s = wall_s(lambda: train_cli.run(
        params, ckp, device=DEVICE, san_check_val_step=1))
    steps, (log, train_log) = method.it, _read_log(ckp)
    taus = [r["tau"] for r in train_log]
    want = [method.train_loss_kwargs(i)["tau"] for i in range(steps)]
    tau_ok = (len(taus) == steps and bool(np.allclose(taus, want, rtol=1e-6))
              and taus[0] == params.init_tau and taus[-1] < taus[0])
    last = latest_checkpoint(ckp)
    reloaded = _reloads(method, params, ckp)
    videos = sorted(os.listdir(os.path.join(ckp, "vis")))
    steps_per_s, _ = _steady_steps_per_s(method)
    ok = (steps == method.total_steps and steps >= 10 and _finite(log)
          and tau_ok and reloaded and last.endswith(f"model_{steps}.pth")
          and videos == [f"recon_{steps}.mp4"])
    emit(phase="train_dvae", check="fit", config="dvae_physion_params",
         batch=B, vocab=params.vocab_size, steps=steps, fit_seconds=fit_s,
         tau_by_step=taus, tau_ok=tau_ok, finite=_finite(log),
         checkpoint=os.path.basename(last), reloaded=reloaded, videos=videos,
         last_train=train_log[-1] if train_log else None,
         steps_per_s=steps_per_s,
         frames_per_s=steps_per_s * B * params.n_sample_frames, ok=ok)
    if not ok:
        raise AssertionError("dVAE training check failed")
    _link_pretrained("dvae_physion_params", last)
    return last


def phase_tokenize(workdir, dvae_ckp):
    """The dVAE just trained through ``cli.tokenize_images``."""
    import numpy as np
    import torch

    from slotformer_tpu_torch.cli import tokenize_images
    from slotformer_tpu_torch.datasets import build_dataset
    from slotformer_tpu_torch.datasets.physion import token_path
    from slotformer_tpu_torch.models import build_model
    from slotformer_tpu_torch.runtime import load_checkpoint

    cfg, params = physion_params(workdir, "dvae_physion_params")
    dvae = build_model(params, device=DEVICE)
    dvae.load_state_dict(load_checkpoint(dvae_ckp)["state_dict"])
    ckp = dvae_ckp
    with torch.inference_mode():  # warm-up: the convolutions' first calls
        dvae.tokenize(torch.zeros(64, *params.resolution, 3, device=DEVICE))
    stats, dt = wall_s(lambda: tokenize_images.main(
        ["--params", cfg, "--weight", ckp, "--batch_size", "64",
         "--device", DEVICE]))
    frames = sum(s["frames"] for s in stats.values())
    train_set, val_set = build_dataset(params)
    files = train_set.files + val_set.files
    V, T = params.vocab_size, PHYSION["video_len"]
    hw = (params.resolution[0] // 4) * (params.resolution[1] // 4)
    tok_ok = len(files) == PHYSION["train"] + PHYSION["val"]
    for folder in files:
        tok = np.load(token_path(folder, "dvae_physion_params"))
        tok_ok &= bool(tok.shape == (T, hw) and tok.dtype == np.int32
                       and 0 <= tok.min() and tok.max() < V)

    # the model alone on a batch of 64 frames, and card against CPU on 4
    val_set.load_video = True
    video = torch.from_numpy(val_set[0]["video"])
    val_set.load_video = False
    batch = video[:64].to(DEVICE)
    with torch.inference_mode():
        model_ms = cuda_ms(lambda: dvae.tokenize(batch, one_hot=False), iters=10)
        cpu = build_model(params, device="cpu")
        cpu.load_state_dict(dvae.state_dict())
        want = cpu.encode_logits(video[:4])
        got = dvae.encode_logits(video[:4].to(DEVICE)).cpu()
    rel = ((got - want).abs().max() / want.abs().max()).item()
    differ = got.argmax(-1) != want.argmax(-1)
    gap = _top2_gap(want)
    ids_ok = bool((gap[differ] <= DVAE_TIE).all())
    ok = tok_ok and rel <= DVAE_LOGITS_RTOL and ids_ok and stats["val"]["written"] > 0
    emit(phase="tokenize", config="dvae_physion_params", vocab=V,
         videos=len(files), frames=frames, seconds=dt, frames_per_s=frames / dt,
         model_only_frames_per_s=64 / (model_ms / 1e3), token_files_ok=tok_ok,
         card_vs_cpu=dict(frames=4, logits_rel_err=rel, tol=DVAE_LOGITS_RTOL,
                          ids_differ=int(differ.sum()),
                          min_top2_gap=gap.min().item(), tie=DVAE_TIE),
         ok=ok)
    if not ok:
        raise AssertionError("tokenize check failed")


def _k1_grad_check():
    """K1's gradients at STEVE's training shape through its
    ``autograd.Function`` against plain autograd of its plain version, and
    the time of that backward."""
    import torch

    from slotformer_tpu_torch.kernels import slot_attention as k1

    B, N, D, S, H = STEVE_TRAIN_K1_SHAPE
    k, v, slots, wp = k1_inputs(B, N, D, S, H, seed=6)
    xs = [k, v, slots] + [wp[n] for n in k1.WP_KEYS]
    for x in xs:
        x.requires_grad_(True)
    args = (2, S, D ** -0.5, 1e-6)
    w = dict(zip(k1.WP_KEYS, xs[3:]))
    out = k1.fused_slot_attention(k, v, slots, w, *args)
    plain = k1.fused_slot_attention_plain(k, v, slots, w, *args)
    g_out = [torch.randn_like(o) for o in out]
    got = torch.autograd.grad(out, xs, g_out, retain_graph=True)
    want = torch.autograd.grad(plain, xs, g_out, retain_graph=True)
    errs = {name: ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
            for name, a, b in zip(("k", "v", "slots") + k1.WP_KEYS, got, want)}
    bwd_ms = cuda_ms(lambda: torch.autograd.grad(out, xs, g_out,
                                                 retain_graph=True), iters=5)
    worst = max(errs, key=errs.get)
    return dict(grad_rel_err_vs_plain_autograd=errs[worst], worst_input=worst,
                tol_grad_rel=K1_GRAD_RTOL, backward_ms_plain_autograd=bwd_ms,
                ok=errs[worst] <= K1_GRAD_RTOL)


def phase_train_steve(workdir, dvae_ckp):
    """STEVE at the full ``steve_physion_params`` width (6 slots x 192, B=48
    clips of 6 frames, ``dec_lr``, clip 0.05) trained for one epoch under
    bf16 autocast (the reference's ``--fp16``) through ``cli.train.run``,
    the dVAE grafted from its trainer's checkpoint (the empty source
    prefix). Returns (checkpoint, K1 launches of the fit, K1's gradient
    check at the training shape)."""
    from unittest import mock

    import numpy as np
    import torch
    from torch.autograd import DeviceType

    from slotformer_tpu_torch.cli import train as train_cli
    from slotformer_tpu_torch.datasets import build_dataset
    from slotformer_tpu_torch.kernels import slot_attention as k1
    from slotformer_tpu_torch.models import build_model
    from slotformer_tpu_torch.runtime import graft, latest_checkpoint, load_checkpoint

    _, params = physion_params(workdir, "steve_physion_params", max_epochs=1,
                               print_iter=1)
    B, T = params.train_batch_size, params.n_sample_frames
    weights = params.loss_weights()
    dvae_sd = load_checkpoint(dvae_ckp)["state_dict"]

    # (a) one float32 step at B=2 on the loader's tokens, dropout off:
    # card against CPU, and against the card with K1's plain version
    train_set, _ = build_dataset(params)
    items = [train_set[i] for i in (0, len(train_set) // 2)]
    batch = {k: torch.from_numpy(np.stack([it[k] for it in items]))
             for k in ("img", "token_id")}

    def graft_frozen_dvae(m):
        m.load_state_dict(graft(m.state_dict(), dvae_sd, {"dvae": ""}))
        for n, p in m.named_parameters():
            p.requires_grad_(not n.startswith("dvae."))

    _k1_step_check("train_steve", params, batch, seed=9, prepare=graft_frozen_dvae)

    # (b) one epoch through the CLI's code under bf16 autocast
    ckp = os.path.join(workdir, "ckpts", "steve_physion_params")
    params.seed = 0
    torch.manual_seed(params.seed)  # the weights run() starts from
    init = build_model(params, device="cpu").state_dict()
    k1.LAUNCHES = 0
    method, fit_s = wall_s(lambda: train_cli.run(
        params, ckp, device=DEVICE, use_fp16=True, san_check_val_step=1),
        k3_path="steve_train")
    launches, steps = k1.LAUNCHES, method.it
    val_batches = 1 + len(method.val_loader)  # sanity check + epoch end
    # the decomposition video encodes n_samples whole val videos, one K1
    # call a frame
    val_set = method.val_loader.dataset
    sampled = min(int(params.n_samples), val_set.num_videos)
    sampled_frames = sampled * len(range(0, val_set.video_len, val_set.frame_offset))
    expected = T * (steps + val_batches) + sampled_frames
    log, train_log = _read_log(ckp)
    sd = {k: v.cpu() for k, v in method.model.state_dict().items()}
    dvae_frozen = len(dvae_sd) > 0 and all(
        torch.equal(sd["dvae." + k], v) for k, v in dvae_sd.items())
    moved = {p: max((sd[k] - init[k]).abs().max().item() for k in init
                    if k.startswith(p + ".") and init[k].is_floating_point())
             for p in ("trans_decoder", "slot_attention", "encoder")}
    groups = [len(g["params"]) for g in method.optimizer.optimizer.param_groups]
    last = latest_checkpoint(ckp)
    reloaded = _reloads(method, params, ckp)
    videos = sorted(os.listdir(os.path.join(ckp, "vis")))

    # (c) steady state: K1's Function in a train step, steps/s and memory
    # under bf16 and in float32
    model, opt = method.model, method.optimizer
    loader_batch = next(iter(method.train_loader))
    with mock.patch.object(k1._FusedSlotAttention, "apply",
                           wraps=k1._FusedSlotAttention.apply) as fn:
        method._train_step(loader_batch)
    function_calls = fn.call_count
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    bf16_steps_per_s, _ = _steady_steps_per_s(method)
    bf16_peak = torch.cuda.max_memory_allocated()
    method.use_fp16 = False
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    f32_steps_per_s, _ = _steady_steps_per_s(method, n_steps=2)
    f32_peak = torch.cuda.max_memory_allocated()
    method.use_fp16 = True

    # (d) one profiled bf16 step: the encoder (CNN, predictor, K1's
    # forward, 6 frame steps), the token decoder and its loss, the
    # decoder's backward (until the slots' gradient is ready), the rest of
    # the backward (K1's plain-autograd backward in it), the optimizer
    db = method._to_device(loader_batch)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)]

    def decoder_done(mod, args, out):
        ev[2].record()
        args[0].register_hook(lambda g: ev[4].record())

    hooks = [model.trans_decoder.register_forward_pre_hook(
                 lambda mod, args: ev[1].record()),
             model.trans_decoder.register_forward_hook(decoder_done)]
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    model.train()
    try:
        with torch.profiler.profile(activities=acts) as prof:
            with torch.autocast("cuda", dtype=torch.bfloat16):
                ev[0].record()
                losses = model.train_loss(db, generator=method.generator)
                total = sum(weights.get(n, 1.0) * v.float()
                            for n, v in losses.items())
                ev[3].record()
            total.backward()
            ev[5].record()
            opt.step(method.it)
            opt.zero_grad()
            ev[6].record()
            torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    enc_ms, dec_ms, _, dec_bwd_ms, enc_bwd_ms, opt_ms = (
        ev[i].elapsed_time(ev[i + 1]) for i in range(6))
    dec_ms += ev[2].elapsed_time(ev[3])  # the loss on the logits
    step_ms = ev[0].elapsed_time(ev[6])
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    k1_fwd_ms = sum(e.self_device_time_total for e in kernels
                    if "fused_slot_attention_" in e.key) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    del prof, losses, total, db

    # (e) K1's gradient at the training shape, against plain autograd
    k1_grad = _k1_grad_check()
    k1_bwd_ms = T * k1_grad["backward_ms_plain_autograd"]
    ok = (steps == method.total_steps and steps >= 10 and launches == expected
          and _finite(log) and dvae_frozen and moved["trans_decoder"] > 0
          and groups == [groups[0], len(dict(model.trans_decoder.named_parameters()))]
          and reloaded and last.endswith(f"model_{steps}.pth")
          and videos == [f"decomp_{steps}.mp4"] and function_calls == T
          and k1_grad["ok"])
    emit(phase="train_steve", check="fit", config="steve_physion_params",
         batch=B, frames_per_clip=T, amp="bf16", steps=steps,
         fit_seconds=fit_s, k1_launches=launches, k1_launches_expected=expected,
         k1_function_calls_per_step=function_calls, finite=_finite(log),
         dvae_bit_frozen=dvae_frozen, max_abs_change_from_init=moved,
         param_groups=groups, clip_grad=params.clip_grad, dec_lr=params.dec_lr,
         checkpoint=os.path.basename(last), reloaded=reloaded, videos=videos,
         last_train=train_log[-1] if train_log else None,
         steps_per_s=bf16_steps_per_s, clips_per_s=bf16_steps_per_s * B,
         max_memory_allocated_gb=bf16_peak / 1e9,
         float32=dict(steps_per_s=f32_steps_per_s, step_ms=1e3 / f32_steps_per_s,
                      max_memory_allocated_gb=f32_peak / 1e9),
         profiled_step=dict(step_ms=step_ms, encoder_forward_ms=enc_ms,
                            k1_forward_kernel_ms=k1_fwd_ms,
                            token_decoder_forward_ms=dec_ms,
                            token_decoder_backward_ms=dec_bwd_ms,
                            encoder_backward_ms=enc_bwd_ms,
                            k1_backward_ms=k1_bwd_ms,
                            k1_backward_share=k1_bwd_ms / step_ms,
                            k1_forward_share=k1_fwd_ms / step_ms,
                            optimizer_ms=opt_ms,
                            top_kernels_name_count_ms=[
                                (e.key[:80], e.count, e.self_device_time_total / 1e3)
                                for e in top]),
         k1_grad_at_training_shape=dict(
             shape=dict(zip("BNDSH", STEVE_TRAIN_K1_SHAPE)), **k1_grad),
         ok=ok)
    if not ok:
        raise AssertionError("STEVE training check failed")
    _link_pretrained("steve_physion_params", last)
    return last, launches, k1_grad


def phase_steve_extract(workdir, steve_ckp, k1_ms):
    """The STEVE just trained through ``cli.extract_slots`` on the training
    and readout subsets; returns the K1 launches."""
    from unittest import mock

    import numpy as np
    import torch
    from torch.autograd import DeviceType

    from slotformer_tpu_torch.cli import extract_slots
    from slotformer_tpu_torch.cli.extract_slots import extract_video_slots
    from slotformer_tpu_torch.datasets import build_dataset
    from slotformer_tpu_torch.kernels import slot_attention as k1
    from slotformer_tpu_torch.models import build_model
    from slotformer_tpu_torch.models import slot_attention as sa_module
    from slotformer_tpu_torch.runtime import load_checkpoint, load_obj

    cfg, params = physion_params(workdir, "steve_physion_params")
    steve = build_model(params, device=DEVICE)
    steve.load_state_dict(load_checkpoint(steve_ckp)["state_dict"])
    ckp, ckp_dir = steve_ckp, os.path.dirname(steve_ckp)
    bs, chunk, T = PHYSION["extract_batch"], PHYSION["chunk_len"], PHYSION["video_len"]
    S, D = steve.num_slots, steve.slot_size
    data = os.path.join(workdir, "data", "Physion")
    runs = {}
    for subset in ("training", "readout"):
        k1.LAUNCHES = 0
        path, dt = wall_s(lambda: extract_slots.main(
            ["--params", cfg, "--weight", ckp, "--subset", subset,
             "--save_path", os.path.join(data, f"{subset}_slots.pkl"),
             "--batch_size", str(bs), "--chunk_len", str(chunk),
             "--device", DEVICE]), k3_path=f"steve_extract_{subset}")
        slots = load_obj(path)
        link = os.path.join(ckp_dir, f"{subset}_slots.pkl")
        n_videos = {k: len(v) for k, v in slots.items()}
        prefix = "" if subset == "training" else "readout_"
        want_videos = {s: PHYSION[prefix + s] for s in ("train", "val")}
        batches = sum(-(-n // bs) for n in n_videos.values())
        runs[subset] = dict(
            seconds=dt, frames_per_s=sum(n_videos.values()) * T / dt,
            k1_launches=k1.LAUNCHES, frame_steps=batches * T,
            videos=n_videos, link=os.path.realpath(link) == os.path.realpath(path),
            shapes_ok=all(s.shape == (T, S, D) and s.dtype == np.float32
                          and np.isfinite(s).all()
                          for v in slots.values() for s in v.values()),
            ok=n_videos == want_videos)
    launches = sum(r["k1_launches"] for r in runs.values())

    # the model alone, warm, on the training split of the training subset;
    # K1's share of it from the device trace
    train_set, _ = build_dataset(params)
    run = lambda: extract_video_slots(steve, train_set, bs, chunk)  # noqa: E731
    _, dt = wall_s(run)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        run()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    k1_dev_ms = sum(e.self_device_time_total for e in kernels
                    if "fused_slot_attention_" in e.key) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]

    # card against CPU (and against K1's plain version on the card) on one
    # 6-frame clip at B=2
    train_set.load_video = True
    clip = torch.from_numpy(np.stack([train_set[i]["video"][:6] for i in (0, 1)]))
    train_set.load_video = False
    cpu = build_model(params, device="cpu")
    cpu.load_state_dict(steve.state_dict())
    with torch.inference_mode():
        gs, gm, _, _ = steve.encode(clip.to(DEVICE))
        cs, cm, _, _ = cpu.encode(clip)
        with mock.patch.object(sa_module, "fused_slot_attention",
                               k1.fused_slot_attention_plain):
            ps, pm, _, _ = steve.encode(clip.to(DEVICE))
    per_frame = lambda a, b: [(a[:, t].cpu() - b[:, t].cpu()).abs().max().item()  # noqa: E731
                              for t in range(a.shape[1])]
    errs = dict(slots_vs_cpu=per_frame(gs, cs), masks_vs_cpu=per_frame(gm, cm),
                slots_vs_plain_k1=per_frame(gs, ps),
                masks_vs_plain_k1=per_frame(gm, pm))
    agree = (max(errs["slots_vs_cpu"] + errs["slots_vs_plain_k1"]) <= STEVE_SLOTS_ATOL
             and max(errs["masks_vs_cpu"] + errs["masks_vs_plain_k1"]) <= STEVE_MASKS_ATOL)
    masks_ok = torch.allclose(gm.sum(2), torch.ones_like(gm.sum(2)), atol=1e-5)
    ok = (all(r["ok"] and r["link"] and r["shapes_ok"]
              and r["k1_launches"] == r["frame_steps"] for r in runs.values())
          and agree and masks_ok)
    emit(phase="steve_extract", config="steve_physion_params",
         batch_size=bs, chunk_len=chunk, frames=T, subsets=runs,
         k1_launches=launches, k1_ms_each_b8=k1_ms,
         training_run=dict(seconds=dt,
                           frames_per_s=len(train_set.files) * T / dt,
                           k1_device_ms=k1_dev_ms,
                           k1_share_of_run=k1_dev_ms / (1e3 * dt),
                           top_kernels_name_count_ms=[
                               (e.key[:80], e.count, e.self_device_time_total / 1e3)
                               for e in top]),
         card_vs_cpu=dict(clip=[2, 6], errors_per_frame=errs,
                          tol_slots=STEVE_SLOTS_ATOL, tol_masks=STEVE_MASKS_ATOL,
                          ok=agree),
         masks_sum_to_1_over_slots=masks_ok, ok=ok)
    if not ok:
        raise AssertionError("STEVE extraction check failed")
    return launches


def phase_train_steve_slotformer(workdir, steve_ckp):
    """STEVESlotFormer at the full ``slotformer_physion_params`` width (d256,
    8 layers, 15 burn-in + 10 rollout frames at frame offset 3, B=128)
    trained for one epoch through ``cli.train.run`` on the training
    subset's slots, STEVE's token decoder and dVAE grafted from its
    checkpoint. Returns the checkpoint's path."""
    import numpy as np
    import torch

    from slotformer_tpu_torch.cli import train as train_cli
    from slotformer_tpu_torch.datasets import build_dataset
    from slotformer_tpu_torch.models import build_model
    from slotformer_tpu_torch.runtime import graft, latest_checkpoint, load_checkpoint

    # n_samples 0: the inherited sample video decodes every frame of a val
    # video by generating its 1024 tokens, ~1.1 s an image on this card
    # (steve_decode), some 55 s a video
    _, params = physion_params(
        workdir, "slotformer_physion_params", max_epochs=1, print_iter=1,
        n_samples=0,
        slots_root=os.path.join(workdir, "data", "Physion", "training_slots.pkl"))
    B, weights = params.train_batch_size, params.loss_weights()
    steve_sd = load_checkpoint(steve_ckp)["state_dict"]
    grafts = {"decoder": "trans_decoder", "dvae": "dvae"}

    # (a) one step at B=2, card against CPU
    train_set, _ = build_dataset(params)
    batch = {"slots": torch.from_numpy(np.stack(
        [train_set[i]["slots"] for i in (0, len(train_set) // 2)]))}
    torch.manual_seed(10)
    gpu = build_model(params, device=DEVICE)
    gpu.load_state_dict(graft(gpu.state_dict(), steve_sd, grafts))
    cpu = build_model(params, device="cpu")
    cpu.load_state_dict(gpu.state_dict())
    for m in (gpu, cpu):
        for n, p in m.named_parameters():
            if n.startswith(("decoder.", "dvae.")):
                p.requires_grad_(False)
    (l_gpu, g_gpu, _), (l_cpu, g_cpu, _), ties = _tied_pair(
        lambda: _sf_step(gpu, {"slots": batch["slots"].to(DEVICE)}, weights),
        lambda: _sf_step(cpu, batch, weights))
    loss_err = max(abs(l_gpu[n] / l_cpu[n] - 1) for n in l_cpu)
    grad_err, worst = _grad_errors(g_gpu, g_cpu)
    step_ok = (loss_err <= SF_LOSS_RTOL and grad_err <= SF_GRAD_RTOL
               and ties["untied_rel_x"] <= RELU_TIE_RTOL
               and len(g_gpu) == len(g_cpu) > 0)
    emit(phase="train_steve_slotformer", check="one_step", batch=2,
         losses_card=l_gpu, loss_rel_err_vs_cpu=loss_err,
         grad_rel_err_vs_cpu=grad_err, worst_param=worst, relu=ties,
         n_grads=len(g_cpu), tol_loss_rtol=SF_LOSS_RTOL,
         tol_grad_rel=SF_GRAD_RTOL, tol_relu_tie=RELU_TIE_RTOL, ok=step_ok)
    if not step_ok:
        raise AssertionError(f"STEVESlotFormer train step: the card disagrees "
                             f"with the CPU (loss {loss_err:.3g}, gradient "
                             f"{grad_err:.3g} at {worst}, ReLU {ties})")
    del gpu, cpu

    # (b) one epoch through the CLI's code
    ckp = os.path.join(workdir, "ckpts", "slotformer_physion_params")
    params.seed = 0
    torch.manual_seed(params.seed)  # the weights run() starts from
    init = build_model(params, device="cpu").state_dict()
    method, fit_s = wall_s(lambda: train_cli.run(
        params, ckp, device=DEVICE, san_check_val_step=1),
        k3_path="steve_slotformer_train")
    model, steps = method.model, method.it
    log, train_log = _read_log(ckp)
    sd = {k: v.cpu() for k, v in model.state_dict().items()}
    frozen_keys = [k for k in sd if k.startswith(("decoder.", "dvae."))]
    frozen = len(frozen_keys) > 0 and all(
        torch.equal(sd[k], steve_sd["trans_" + k if k.startswith("decoder.")
                                    else k]) for k in frozen_keys)
    moved = max((sd[k] - init[k]).abs().max().item() for k in init
                if k.startswith("rollouter.") and init[k].is_floating_point())
    # the shipped config sets no loss-decay ramp (use_loss_decay), as the
    # reference's: train_loss_kwargs is empty and the log has no factor
    ramp = method.train_loss_kwargs(0)
    ramp_ok = ramp == {} and not any("loss_decay_factor" in r for r in train_log)
    last = latest_checkpoint(ckp)
    reloaded = _reloads(method, params, ckp)
    steps_per_s, _ = _steady_steps_per_s(method)
    ok = (steps == method.total_steps and steps >= 3 and _finite(log)
          and frozen and moved > 0 and ramp_ok and reloaded
          and last.endswith(f"model_{steps}.pth"))
    emit(phase="train_steve_slotformer", check="fit",
         config="slotformer_physion_params", batch=B,
         frames_per_clip=params.n_sample_frames,
         frame_offset=params.frame_offset, steps=steps, fit_seconds=fit_s,
         finite=_finite(log), grafted_bit_frozen=frozen,
         frozen_tensors=len(frozen_keys), rollouter_max_abs_change=moved,
         loss_decay=dict(use_loss_decay=bool(params.get("use_loss_decay", False)),
                         train_loss_kwargs=ramp, ok=ramp_ok),
         checkpoint=os.path.basename(last), reloaded=reloaded,
         last_train=train_log[-1] if train_log else None,
         steps_per_s=steps_per_s,
         rollout_frames_per_s=steps_per_s * B * model.rollout_len, ok=ok)
    if not ok:
        raise AssertionError("STEVESlotFormer training check failed")
    return last


def phase_steve_rollout(workdir, sf_ckp):
    """The STEVESlotFormer just trained through ``cli.rollout_slots --task
    physion --subset readout``; returns the model."""
    import numpy as np

    from slotformer_tpu_torch.cli import rollout_slots
    from slotformer_tpu_torch.cli.rollout_slots import interleaved_rollout
    from slotformer_tpu_torch.models import build_model
    from slotformer_tpu_torch.runtime import load_checkpoint, load_obj

    data = os.path.join(workdir, "data", "Physion")
    cfg, params = physion_params(
        workdir, "slotformer_physion_params",
        slots_root=os.path.join(data, "training_slots.pkl"))
    model = build_model(params, device=DEVICE)
    model.load_state_dict(load_checkpoint(sf_ckp)["state_dict"])
    ckp, ckp_dir = sf_ckp, os.path.dirname(sf_ckp)
    save = os.path.join(workdir, "out", "readout_rollout_slots.pkl")
    _, dt = wall_s(lambda: rollout_slots.main(
        ["--task", "physion", "--subset", "readout", "--params", cfg,
         "--weight", ckp, "--save_path", save, "--batch_size", "8",
         "--device", DEVICE]))
    rolled, given = load_obj(save), load_obj(os.path.join(data, "readout_slots.pkl"))
    obs, T = 45, PHYSION["video_len"]
    args = (obs, T, params.input_frames, params.frame_offset)
    # the model alone, warm, on the same videos
    _, warm_dt = wall_s(lambda: [interleaved_rollout(model, v, *args, batch_size=8)
                                 for v in given.values()])
    shapes_ok = set(rolled) == {"train", "val"} and all(
        r.shape == (T, model.num_slots, model.slot_size) and np.isfinite(r).all()
        and np.array_equal(r[:obs], given[split][n][:obs])
        for split, v in rolled.items() for n, r in v.items())
    n_videos = sum(len(v) for v in rolled.values())
    link_ok = os.path.islink(os.path.join(ckp_dir, "readout_slots.pkl"))

    name = sorted(given["val"])[0]
    one = {name: given["val"][name]}
    cpu = build_model(params, device="cpu")
    cpu.load_state_dict(model.state_dict())
    err = float(np.abs(interleaved_rollout(model, one, *args)[name]
                       - interleaved_rollout(cpu, one, *args)[name]).max())
    ok = shapes_ok and link_ok and err <= STEVE_ROLLOUT_ATOL
    emit(phase="steve_rollout", config="slotformer_physion_params",
         videos=n_videos, observed=obs, target=T,
         frame_offset=params.frame_offset, history=params.input_frames,
         seconds=dt, rolled_out_frames_per_s=n_videos * (T - obs) / dt,
         model_only=dict(seconds=warm_dt,
                         rolled_out_frames_per_s=n_videos * (T - obs) / warm_dt),
         shapes_ok=shapes_ok, link_ok=link_ok, max_abs_err_vs_cpu=err,
         tol=STEVE_ROLLOUT_ATOL, ok=ok)
    if not ok:
        raise AssertionError("STEVESlotFormer rollout check failed")
    return model, cpu, given


def phase_steve_decode(model, cpu, given):
    """``STEVESlotFormer.rollout(decode=True)``: 1024 generated tokens per
    image, then the dVAE; one image card against CPU."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType

    from slotformer_tpu_torch.models.dvae import make_one_hot

    names = sorted(given["train"])[:2]
    past = torch.from_numpy(np.stack([given["train"][n][:45]
                                      for n in names])).to(DEVICE)
    history, pred_len = model.history_len, 2
    run = lambda: model.rollout(past[:, -history:], pred_len, decode=True,  # noqa: E731
                                with_gt=False)
    # token steps traced: a whole decode is ~10^5 launches
    window = min(128, model.num_patches)
    with torch.inference_mode():
        run()  # warm-up
        out, dt = wall_s(run)
        flat = out["slots"].reshape(-1, *out["slots"].shape[2:])
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            _, prof_dt = wall_s(lambda: model.decoder.generate(flat, window))
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    images = len(names) * pred_len
    recon = out["recon_combined"]
    shapes_ok = (tuple(recon.shape) == (len(names), pred_len, *model.resolution, 3)
                 and bool(torch.isfinite(recon).all()))

    # one image, card against CPU
    slots = out["slots"][:1, 0]
    steps = model.num_patches
    with torch.inference_mode():
        g_ids, g_logits = model.decoder.generate(slots, steps)
        c_ids, c_logits = cpu.decoder.generate(slots.cpu(), steps)
        tf_card = model.decoder(slots, g_ids[:, :-1])
        tf_cpu = cpu.decoder(slots.cpu(), g_ids[:, :-1].cpu())
        tf_rel = ((tf_card.cpu() - tf_cpu).abs().max() / tf_cpu.abs().max()).item()
        differ = (g_ids.cpu() != c_ids)[0].nonzero()
        first = int(differ[0]) if len(differ) else None
        gap_at_first = (None if first is None
                        else _top2_gap(c_logits[0, first]).item())
        ids_ok = first is None or gap_at_first <= DECODE_TIE
        one_hot = make_one_hot(g_logits.reshape(1, model.h, model.w, -1))
        hard_err = (model.dvae.detokenize(one_hot).cpu()
                    - cpu.dvae.detokenize(one_hot.cpu())).abs().max().item()
        u = torch.rand(1, model.h, model.w, model.vocab_size,
                       generator=torch.Generator().manual_seed(0))
        soft_card, _ = model.decode(slots, uniform=u.to(DEVICE))
        soft_cpu, _ = cpu.decode(slots.cpu(), uniform=u)
        soft_err = (soft_card.cpu() - soft_cpu).abs().max().item()
    ok = (shapes_ok and tf_rel <= DECODE_LOGITS_RTOL and ids_ok
          and hard_err <= DECODE_IMG_ATOL and soft_err <= DECODE_IMG_ATOL)
    emit(phase="steve_decode", config="slotformer_physion_params",
         images=images, tokens_per_image=steps, seconds=dt,
         ms_per_image=1e3 * dt / images, ms_per_token_step=1e3 * dt / steps,
         profiled=dict(token_steps=window, images=images, seconds=prof_dt,
                       kernel_launches_per_step=sum(e.count for e in kernels)
                       / window),
         shapes_ok=shapes_ok,
         card_vs_cpu=dict(teacher_forced_logits_rel_err=tf_rel,
                          tol=DECODE_LOGITS_RTOL,
                          ids_equal=first is None, first_mismatch=first,
                          top2_gap_at_first_mismatch=gap_at_first,
                          tie=DECODE_TIE, hard_img_err_same_ids=hard_err,
                          soft_img_err_same_uniforms=soft_err,
                          tol_img=DECODE_IMG_ATOL),
         ok=ok)
    if not ok:
        raise AssertionError("STEVESlotFormer decode check failed")


# ------------------------------------------------------------------ PHYRE
# The `phyre` simulator is not installed: a stand-in module of the same API
# (get_fold, get_default_100k_cache, initialize_simulator,
# eval_setup_to_action_tier, simulate_action) renders 256x256 colour-index
# frames as PHYRE's does, so BaseTransforms resizes them to 128 as it would
# real ones. 25 templates, one train task and one eval task each; a cache
# of 1000 actions (x, y, radius) whose statuses are a deterministic rule of
# (task, action).
PHYRE = dict(tasks=25, cache_actions=1000, sim_frames=17, data_ratio=0.01,
             extract_vid_len=11, plan_acts=256, cpu_check_actions=4)
# K1 at PHYRE SAVi's calls: training and extraction (B=32), planning (B=128)
PHYRE_K1_TRAIN_SHAPE = (32, 4096, 128, 8, 256)
PHYRE_K1_PLAN_SHAPE = (128, 4096, 128, 8, 256)
# PHYRE extraction card against CPU: 11 recurrent frame steps (an
# LSTM-wrapped 2-layer transformer predictor, then K1) at D=128 (as
# EXTRACT_ATOL); the rollouts: 8 transformer layers over 10 steps (as
# ROLLOUT_ATOL); the planning confidences are sigmoids of the readout after
# SAVi's first frame and the rollout.
PHYRE_SLOTS_ATOL, PHYRE_ROLLOUT_ATOL, PLAN_CONF_ATOL = 1e-4, 1e-4, 1e-4
# The Physion readout's logits card against CPU: one float32 384 -> 192
# projection of each slot pair, a max, a 192 -> 1 projection.
READOUT_LOGITS_ATOL = 1e-4
# the Physion readout's train videos: two batches of the config's 64
READOUT_PHYSION_TRAIN_VIDEOS = 128


def _phyre_status(task, action):
    """1 solved, -1 failed, 0 invalid: the rule of the stand-in world."""
    a = [float(x) for x in action]
    if a[2] > 0.92:
        return 0  # the ball would overlap the scene
    goal = 0.15 + 0.7 * ((7 * task) % PHYRE["tasks"]) / (PHYRE["tasks"] - 1)
    return 1 if abs(a[0] - goal) < 0.12 else -1


def _disc(img, cy, cx, r, colour):
    """Paint a disc into ``img`` [H, W] (colour indices), clipped."""
    import numpy as np

    H, W = img.shape
    y0, y1 = max(int(cy - r), 0), min(int(cy + r) + 1, H)
    x0, x1 = max(int(cx - r), 0), min(int(cx + r) + 1, W)
    if y0 >= y1 or x0 >= x1:
        return
    yy, xx = np.ogrid[y0:y1, x0:x1]
    win = img[y0:y1, x0:x1]
    win[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = colour


class _PhyreFrames:
    """A simulation's frames [T, 256, 256], each rendered when it is read
    (the planner reads only the first)."""

    def __init__(self, background, states):
        self.background, self.states = background, states

    def __len__(self):
        return len(self.states)

    def _render(self, t):
        img = self.background.copy()
        (y, x, r), px = self.states[t]
        _disc(img, 220, px, 12, 4)  # the task's purple ball
        _disc(img, y, x, r, 1)  # the action's red ball
        return img

    def __getitem__(self, i):
        import numpy as np

        if isinstance(i, slice):
            return np.stack([self._render(t) for t in range(len(self))[i]])
        return self._render(range(len(self))[i])

    def __array__(self, dtype=None, copy=None):
        return self[:]


class _PhyreSim:
    def __init__(self, images, status):
        self.images, self.status = images, status


class _PhyreSimulator:
    """Frames of a red ball (the action: x, height, radius) falling onto a
    black floor beside a task's green goal bar and purple ball, then
    rolling and coming to rest (a static tail, as PHYRE's videos have)."""

    def __init__(self, tasks):
        import numpy as np

        self.tasks = tasks
        self.background = []
        for t in range(len(tasks)):
            bg = np.zeros((256, 256), np.uint8)  # white
            bg[236:, :] = 6  # black floor
            goal = int(256 * (0.15 + 0.7 * ((7 * t) % PHYRE["tasks"])
                              / (PHYRE["tasks"] - 1)))
            bg[226:236, max(goal - 15, 0):goal + 15] = 2  # green goal
            bg[100 + 3 * (t % 20):108 + 3 * (t % 20), 20:60] = 5  # gray bar
            self.background.append(bg)

    def simulate_action(self, task_id, action, stride=60, need_images=True,
                        need_featurized_objects=False):
        import numpy as np

        a = np.asarray(action, np.float64).ravel()
        r = 6 + 20 * a[2]
        x, y = 30 + 196 * a[0], 20 + 100 * a[1]
        px = 200 - 5 * (task_id % 30)
        states = []
        for t in range(PHYRE["sim_frames"]):
            states.append(((y, x, r), px))
            if y + r < 236:
                y = min(y + 22, 236 - r)  # falling
            elif t % 4:
                x = x + (4 if a[1] > 0.5 else -4)  # rolling, then at rest
                px = px if abs(px - x) > 30 else px + 3
        return _PhyreSim(_PhyreFrames(self.background[task_id], states),
                         _phyre_status(task_id, a))


class _PhyreCache:
    def __init__(self):
        import numpy as np

        self.action_array = np.random.default_rng(17).random(
            (PHYRE["cache_actions"], 3))

    def get_sample(self, tasks, _):
        import numpy as np

        st = np.array([[_phyre_status(t, a) for a in self.action_array]
                       for t in range(len(tasks))], np.int64)
        return {"actions": self.action_array.copy(), "simulation_statuses": st}


def _stand_in_phyre():
    import types

    m = types.ModuleType("phyre")
    n = PHYRE["tasks"]
    m.get_fold = lambda eval_setup, fold: (
        [f"{t:05d}:000" for t in range(n)], [],
        [f"{t:05d}:001" for t in range(n)])
    m.get_default_100k_cache = lambda tier: _PhyreCache()
    m.eval_setup_to_action_tier = lambda eval_setup: "ball"
    m.initialize_simulator = lambda tasks, tier: _PhyreSimulator(tasks)
    return m


def phyre_params(workdir, name, **over):
    """The shipped PHYRE config ``name``, cut in data (``data_ratio``),
    written as ``workdir/<name>.py``."""
    return derived_params(workdir, name, data_ratio=PHYRE["data_ratio"],
                          num_workers=4, **over)


def phase_phyre_tree(workdir):
    """The stand-in ``phyre`` into ``sys.modules`` and
    ``datasets.phyre._SPLIT_DIR`` at ``workdir/splits``: the val and train
    splits are drawn from its cache and written there. Returns the
    datasets."""
    import numpy as np

    from slotformer_tpu_torch.datasets import build_dataset
    from slotformer_tpu_torch.datasets import phyre as phyre_data

    sys.modules["phyre"] = _stand_in_phyre()
    phyre_data._SPLIT_DIR = os.path.join(workdir, "splits")
    _, params = phyre_params(workdir, "savi_phyre_params-fold0")
    (train_set, val_set), split_s = wall_s(lambda: build_dataset(params))
    sim = train_set.simulator
    _, sim_s = wall_s(lambda: [np.asarray(sim.simulate_action(i % 25, a).images)
                               for i, a in enumerate(train_set.video_info[:40, 1:])])
    clip, clip_s = wall_s(lambda: train_set[0])
    per_task = {s: len(ds) // PHYRE["tasks"] for s, ds in
                (("train", train_set), ("val", val_set))}
    pos_share = {s: float(np.mean(ds.act_labels)) for s, ds in
                 (("train", train_set), ("val", val_set))}
    ok = (per_task == {"train": 20, "val": 5}
          and clip["img"].shape == (6, *params.resolution, 3)
          and len(os.listdir(phyre_data._SPLIT_DIR)) == 4)
    emit(phase="phyre_tree", tasks=PHYRE["tasks"],
         actions=dict(train=len(train_set), val=len(val_set)),
         actions_per_task=per_task, positive_share=pos_share,
         data_ratio=PHYRE["data_ratio"], frame=[256, 256],
         resolution=list(params.resolution),
         split_seconds=split_s, simulate_all_frames_ms_each=1e3 * sim_s / 40,
         clip_ms=1e3 * clip_s, ok=ok)
    if not ok:
        raise AssertionError("PHYRE stand-in tree check failed")
    return train_set, val_set


def phase_train_savi_phyre(workdir):
    """SAVi at the full ``savi_phyre_params-fold0`` width (8 slots x 128 at
    128x128, N=4096, an LSTM-wrapped 2-layer transformer predictor, B=32
    clips of 6 frames) on the stand-in's clips: one B=2 step card against
    CPU and against the plain K1; ``cli.train.run`` for one epoch into
    ``checkpoints/savi_phyre_params-fold0`` (beside which the extraction
    links the slots the next config reads); K1 launches, a checkpoint that
    reloads, linked as ``pretrained/savi_phyre_params-fold0/model.pth``;
    steps/s and a profiled step. Returns (checkpoint, K1 launches)."""
    import numpy as np
    import torch

    from slotformer_tpu_torch.cli import train as train_cli
    from slotformer_tpu_torch.datasets import build_dataset
    from slotformer_tpu_torch.kernels import slot_attention as k1
    from slotformer_tpu_torch.runtime import latest_checkpoint

    _, params = phyre_params(workdir, "savi_phyre_params-fold0", max_epochs=1,
                             eval_interval=1, print_iter=1)
    T, B = params.n_sample_frames, params.train_batch_size
    train_set, val_set = build_dataset(params)
    batch = {"img": torch.from_numpy(np.stack(
        [train_set[i]["img"] for i in (0, len(train_set) // 2)]))}
    _k1_step_check("train_savi_phyre", params, batch, seed=21)

    ckp = os.path.join("checkpoints", "savi_phyre_params-fold0")
    params.seed = 0
    k1.LAUNCHES = 0
    method, fit_s = wall_s(lambda: train_cli.run(
        params, ckp, device=DEVICE, san_check_val_step=1), k3_path="phyre_train")
    launches, steps = k1.LAUNCHES, method.it
    val_batches = 1 + len(method.val_loader)  # sanity check + epoch end
    # the decomposition video encodes n_samples whole val videos of
    # video_len frames, one K1 call a frame
    sampled = min(int(params.n_samples), len(val_set.files))
    expected = T * (steps + val_batches) + sampled * params.video_len
    log, train_log = _read_log(ckp)
    last = latest_checkpoint(ckp)
    reloaded = _reloads(method, params, ckp)
    _link_pretrained("savi_phyre_params-fold0", last)
    steps_per_s, batch = _steady_steps_per_s(method)
    prof = _profiled_step(method, batch)
    ok = (steps == len(train_set) // B and launches == expected
          and _finite(log) and reloaded and last.endswith(f"model_{steps}.pth"))
    emit(phase="train_savi_phyre", check="fit",
         config="savi_phyre_params-fold0", batch=B, frames_per_clip=T,
         k1_shape=dict(zip("BNDSH", PHYRE_K1_TRAIN_SHAPE)), steps=steps,
         fit_seconds=fit_s, k1_launches=launches,
         k1_launches_expected=expected, val_batches=val_batches,
         finite=_finite(log), checkpoint=os.path.basename(last),
         reloaded=reloaded, last_train=train_log[-1] if train_log else None,
         steps_per_s=steps_per_s, clips_per_s=steps_per_s * B,
         frames_per_s=steps_per_s * B * T, profiled_step=prof, ok=ok)
    if not ok:
        raise AssertionError("PHYRE SAVi training check failed")
    return last, launches


def phase_phyre_slots(workdir, savi_ckp):
    """That SAVi through ``cli.extract_phyre_slots`` (``--bs 32 --vid_len
    11``) over the val and train actions: one file per action, K1 once a
    frame step a batch, the ``{split}_slots`` links; one batch of 4 actions
    card against CPU and against K1's plain version; actions/s; the second
    of five shards again, timed. Returns the K1 launches."""
    from unittest import mock

    import numpy as np
    import torch

    from slotformer_tpu_torch.cli import extract_phyre_slots
    from slotformer_tpu_torch.datasets import build_dataset
    from slotformer_tpu_torch.kernels import slot_attention as k1
    from slotformer_tpu_torch.models import build_model
    from slotformer_tpu_torch.models import slot_attention as sa_module
    from slotformer_tpu_torch.runtime import load_checkpoint

    cfg, params = phyre_params(workdir, "savi_phyre_params-fold0")
    bs, T = 32, PHYRE["extract_vid_len"]
    argv = ["--params", cfg, "--weight", savi_ckp, "--save_path",
            os.path.join("data", "PHYRE"), "--bs", str(bs), "--vid_len", str(T),
            "--device", DEVICE]
    k1.LAUNCHES = 0
    dirs, dt = wall_s(lambda: extract_phyre_slots.main(argv),
                      k3_path="phyre_extract")
    launches = k1.LAUNCHES
    train_set, val_set = build_dataset(params)
    n = {"train": len(train_set), "val": len(val_set)}
    frame_steps = sum(-(-v // bs) for v in n.values()) * T
    S, D = params.slot_dict["num_slots"], params.slot_dict["slot_size"]
    files_ok = all(sorted(os.listdir(dirs[s])) == [f"{i:06d}.npy"
                                                     for i in range(n[s])]
                   for s in n)
    shapes_ok = all(
        np.load(os.path.join(dirs[s], f"{i:06d}.npy")).shape == (T, S, D)
        for s in n for i in (0, n[s] - 1))
    links_ok = all(os.path.realpath(os.path.join(
        os.path.dirname(savi_ckp), f"{s}_slots")) == os.path.realpath(dirs[s])
        for s in n)

    # the sharded path: the second of five shards again, into another
    # directory (shard 0 would move the links)
    shard = argv[:argv.index("--save_path") + 1] + [
        os.path.join("data", "PHYRE_shard")] + argv[argv.index("--bs"):] + [
        "--split", "1", "--total_split", "5"]
    shard_dirs, shard_dt = wall_s(lambda: extract_phyre_slots.main(shard))
    shard_ok = all(sorted(os.listdir(shard_dirs[s])) == [
        f"{i:06d}.npy" for i in range(*extract_phyre_slots._action_range(
            n[s], 1, 5))] for s in n)

    # one batch of 4 actions, card against CPU and against the plain K1
    model = build_model(params, device=DEVICE)
    model.load_state_dict(load_checkpoint(savi_ckp)["state_dict"])
    cpu = build_model(params, device="cpu")
    cpu.load_state_dict(model.state_dict())
    val_set.vid_len = T
    vids = torch.from_numpy(np.stack([val_set.get_video(i)["video"] for i in
                                      range(PHYRE["cpu_check_actions"])]))
    with torch.inference_mode():
        got = model.encode(vids.to(DEVICE))[1].cpu()
        want = cpu.encode(vids)[1]
        with mock.patch.object(sa_module, "fused_slot_attention",
                               k1.fused_slot_attention_plain):
            plain = model.encode(vids.to(DEVICE))[1].cpu()
    saved = torch.from_numpy(np.stack([np.load(os.path.join(
        dirs["val"], f"{i:06d}.npy")) for i in range(vids.shape[0])]))
    err_cpu = (got - want).abs().max().item()
    err_plain = (got - plain).abs().max().item()
    err_file = (saved - got).abs().max().item()
    ok = (files_ok and shapes_ok and links_ok and shard_ok
          and launches == frame_steps
          and max(err_cpu, err_plain, err_file) <= PHYRE_SLOTS_ATOL)
    emit(phase="phyre_slots", config="savi_phyre_params-fold0", batch=bs,
         frames=T, actions=n, seconds=dt, actions_per_s=sum(n.values()) / dt,
         frames_per_s=sum(n.values()) * T / dt, k1_launches=launches,
         frame_steps=frame_steps,
         k1_shape=dict(zip("BNDSH", PHYRE_K1_TRAIN_SHAPE)),
         one_shard_of_5=dict(seconds=shard_dt, files_ok=shard_ok),
         card_vs_cpu=dict(actions=vids.shape[0], frames=T,
                          max_abs_err_vs_cpu=err_cpu,
                          max_abs_err_vs_plain_k1=err_plain,
                          max_abs_err_file_vs_card=err_file,
                          tol=PHYRE_SLOTS_ATOL),
         files_ok=files_ok, shapes_ok=shapes_ok, links_ok=links_ok, ok=ok)
    if not ok:
        raise AssertionError("PHYRE slot extraction check failed")
    return launches


def phase_train_slotformer_phyre(workdir):
    """SingleStepSlotFormer at the full ``slotformer_phyre_params-fold0``
    width (8 slots x 128, d256, 8 layers, cond_len 6, 1 + 10 frames, B=64)
    on the extracted slots (the config's own ``slots_root``), the decoder
    grafted through its own ``dec_ckp_path``: one B=2 step card against CPU
    with dropout off; ``cli.train.run`` for one epoch into
    ``checkpoints/slotformer_phyre_params-fold0``, the decoder bit-frozen, a
    checkpoint that reloads; steps/s. Returns the checkpoint's path."""
    import numpy as np
    import torch

    from slotformer_tpu_torch.cli import train as train_cli
    from slotformer_tpu_torch.datasets import build_dataset
    from slotformer_tpu_torch.models import build_model
    from slotformer_tpu_torch.runtime import graft, latest_checkpoint, load_checkpoint

    _, params = phyre_params(workdir, "slotformer_phyre_params-fold0",
                             max_epochs=1, eval_interval=1, print_iter=1)
    B, weights = params.train_batch_size, params.loss_weights()
    savi_sd = load_checkpoint(params.dec_dict["dec_ckp_path"])["state_dict"]
    train_set, _ = build_dataset(params)
    items = [train_set[i] for i in (0, len(train_set) // 2)]
    batch = {k: torch.from_numpy(np.stack([it[k] for it in items]))
             for k in ("slots", "vid_len")}
    torch.manual_seed(22)
    gpu = build_model(params, device=DEVICE)
    gpu.load_state_dict(graft(gpu.state_dict(), savi_sd,
                              ("decoder", "decoder_pos_embedding")))
    cpu = build_model(params, device="cpu")
    cpu.load_state_dict(gpu.state_dict())
    for m in (gpu, cpu):
        _dropout_off(m)
        for n, p in m.named_parameters():
            p.requires_grad_(not n.startswith("decoder"))
    (l_gpu, g_gpu, _), (l_cpu, g_cpu, _), ties = _tied_pair(
        lambda: _sf_step(gpu, {k: v.to(DEVICE) for k, v in batch.items()},
                         weights),
        lambda: _sf_step(cpu, batch, weights))
    loss_err = max(abs(l_gpu[n] / l_cpu[n] - 1) for n in l_cpu)
    grad_err, worst = _grad_errors(g_gpu, g_cpu)
    step_ok = (loss_err <= SF_LOSS_RTOL and grad_err <= SF_GRAD_RTOL
               and ties["untied_rel_x"] <= RELU_TIE_RTOL
               and len(g_gpu) == len(g_cpu) > 0)
    emit(phase="train_slotformer_phyre", check="one_step", batch=2,
         losses_card=l_gpu, loss_rel_err_vs_cpu=loss_err,
         grad_rel_err_vs_cpu=grad_err, worst_param=worst, relu=ties,
         n_grads=len(g_cpu), tol_loss_rtol=SF_LOSS_RTOL,
         tol_grad_rel=SF_GRAD_RTOL, tol_relu_tie=RELU_TIE_RTOL, ok=step_ok)
    if not step_ok:
        raise AssertionError(f"PHYRE SlotFormer train step: the card disagrees "
                             f"with the CPU (loss {loss_err:.3g}, gradient "
                             f"{grad_err:.3g} at {worst}, ReLU {ties})")
    del gpu, cpu

    ckp = os.path.join("checkpoints", "slotformer_phyre_params-fold0")
    params.seed = 0
    method, fit_s = wall_s(lambda: train_cli.run(
        params, ckp, device=DEVICE, san_check_val_step=1),
        k3_path="phyre_slotformer_train")
    model, steps = method.model, method.it
    log, train_log = _read_log(ckp)
    sd = {k: v.cpu() for k, v in model.state_dict().items()}
    dec_keys = [k for k in sd if k.startswith("decoder")]
    frozen = len(dec_keys) > 0 and all(torch.equal(sd[k], savi_sd[k])
                                       for k in dec_keys)
    last = latest_checkpoint(ckp)
    reloaded = _reloads(method, params, ckp)
    steps_per_s, _ = _steady_steps_per_s(method)
    ok = (steps == method.total_steps == len(train_set) // B
          and _finite(log) and frozen and reloaded
          and last.endswith(f"model_{steps}.pth"))
    emit(phase="train_slotformer_phyre", check="fit",
         config="slotformer_phyre_params-fold0", batch=B,
         frames_per_clip=params.n_sample_frames, steps=steps,
         fit_seconds=fit_s, finite=_finite(log), decoder_bit_frozen=frozen,
         decoder_tensors=len(dec_keys), checkpoint=os.path.basename(last),
         reloaded=reloaded, last_train=train_log[-1] if train_log else None,
         steps_per_s=steps_per_s,
         rollout_frames_per_s=steps_per_s * B * model.rollout_len, ok=ok)
    if not ok:
        raise AssertionError("PHYRE SlotFormer training check failed")
    return last


def phase_rollout_phyre(workdir, sf_ckp):
    """That SingleStepSlotFormer through ``cli.rollout_phyre_slots``: 1 ->
    11 frames for every action, the observed slots passed through, the
    ``{split}_slots`` links the readout config reads; 8 actions card against
    CPU."""
    import numpy as np
    import torch

    from slotformer_tpu_torch.cli import rollout_phyre_slots
    from slotformer_tpu_torch.models import build_model
    from slotformer_tpu_torch.runtime import load_checkpoint

    cfg, params = phyre_params(workdir, "slotformer_phyre_params-fold0")
    dirs, dt = wall_s(lambda: rollout_phyre_slots.main(
        ["--params", cfg, "--weight", sf_ckp, "--save_path",
         os.path.join("data", "PHYRE"), "--device", DEVICE]),
        k3_path="phyre_rollout")
    T, S, D = (params.video_len, params.slot_dict["num_slots"],
               params.slot_dict["slot_size"])
    src = params.slots_root
    n = {s: len(os.listdir(src.format(s))) for s in ("train", "val")}
    files_ok = all(len(os.listdir(dirs[s])) == n[s] for s in n)
    first = [np.load(os.path.join(dirs["val"], f"{i:06d}.npy")) for i in range(8)]
    given = [np.load(os.path.join(src.format("val"), f"{i:06d}.npy"))
             for i in range(8)]
    shapes_ok = all(f.shape == (T, S, D) and np.isfinite(f).all()
                    and np.array_equal(f[0], g[0]) for f, g in zip(first, given))
    links_ok = all(os.path.realpath(os.path.join(
        os.path.dirname(sf_ckp), f"{s}_slots")) == os.path.realpath(dirs[s])
        for s in n)
    params.loss_dict["rollout_len"] = T - 1
    model = build_model(params, device=DEVICE)
    model.load_state_dict(load_checkpoint(sf_ckp)["state_dict"])
    cpu = build_model(params, device="cpu")
    cpu.load_state_dict(model.state_dict())
    obs = torch.from_numpy(np.stack([g[:1] for g in given]))
    with torch.inference_mode():
        got = model.rollout(obs.to(DEVICE), T - 1).cpu()
        want = cpu.rollout(obs, T - 1)
    err = (got - want).abs().max().item()
    err_file = float(np.abs(np.stack(first)[:, 1:] - got.numpy()).max())
    ok = (files_ok and shapes_ok and links_ok
          and max(err, err_file) <= PHYRE_ROLLOUT_ATOL)
    emit(phase="rollout_phyre", config="slotformer_phyre_params-fold0",
         actions=n, rollout=T - 1, seconds=dt,
         actions_per_s=sum(n.values()) / dt,
         rolled_out_frames_per_s=sum(n.values()) * (T - 1) / dt,
         max_abs_err_vs_cpu=err, max_abs_err_file_vs_card=err_file,
         tol=PHYRE_ROLLOUT_ATOL, files_ok=files_ok, shapes_ok=shapes_ok,
         links_ok=links_ok, ok=ok)
    if not ok:
        raise AssertionError("PHYRE rollout check failed")


def phase_train_readout_phyre(workdir):
    """PHYREReadout at the full ``readout_phyre_params-fold0`` width (d128,
    4 layers, 8 heads, slots at steps 0 and 3, B=256) trained by
    ``cli.train.run`` for two epochs on the rolled-out slots (the config's
    own ``slot_root``): ``ReadoutMethod``'s validation with the ``acc_*``
    sweep and its sample video; steps/s. Returns the checkpoint's path."""
    from slotformer_tpu_torch.cli import train as train_cli
    from slotformer_tpu_torch.runtime import latest_checkpoint

    _, params = phyre_params(workdir, "readout_phyre_params-fold0",
                             max_epochs=2, eval_interval=1, print_iter=1)
    ckp = os.path.join("checkpoints", "readout_phyre_params-fold0")
    params.seed = 0
    method, fit_s = wall_s(lambda: train_cli.run(
        params, ckp, device=DEVICE, san_check_val_step=1))
    steps = method.it
    log, train_log = _read_log(ckp)
    val = [r for r in log if r["phase"] == "val"]
    sweep = sorted(k for k in val[-1] if k.startswith("acc_")) if val else []
    with open(os.path.join(ckp, "vis", f"readout_{steps}.json")) as f:
        samples = json.load(f)
    last = latest_checkpoint(ckp)
    steps_per_s, _ = _steady_steps_per_s(method)
    B = params.train_batch_size
    ok = (steps == method.total_steps > 0 and _finite(log)
          and sweep == ["acc_0.10", "acc_0.30", "acc_0.50", "acc_0.70",
                        "acc_0.90"]
          and len(samples) == int(params.n_samples)
          and last.endswith(f"model_{steps}.pth"))
    emit(phase="train_readout_phyre", config="readout_phyre_params-fold0",
         batch=B, steps=steps, fit_seconds=fit_s, finite=_finite(log),
         last_val=val[-1] if val else None,
         last_train=train_log[-1] if train_log else None,
         sample_pairs=len(samples), steps_per_s=steps_per_s,
         actions_per_s=steps_per_s * B, ok=ok)
    if not ok:
        raise AssertionError("PHYRE readout training check failed")
    return last


def phase_plan_phyre(workdir, savi_ckp, sf_ckp, readout_ckp):
    """``cli.test_phyre_planning --bs 128`` over the 25 eval tasks x 256
    actions of the stand-in in two shards (the second timed on its own),
    then ``--collect``: every action scored
    or marked invalid, K1 once a batch at (128, 4096, 128, 8, 256), AUCCESS;
    actions/s; one batch's confidences card against CPU. Returns K1's
    launches."""
    import numpy as np
    import torch

    from slotformer_tpu_torch.cli import test_phyre_planning as plan
    from slotformer_tpu_torch.datasets.phyre import observations_to_uint8_rgb
    from slotformer_tpu_torch.datasets.utils import BaseTransforms
    from slotformer_tpu_torch.kernels import slot_attention as k1
    from slotformer_tpu_torch.models import build_model
    from slotformer_tpu_torch.runtime import load_checkpoint

    cfgs = [phyre_params(workdir, name)[0] for name in (
        "savi_phyre_params-fold0", "slotformer_phyre_params-fold0",
        "readout_phyre_params-fold0")]
    bs, acts = 128, PHYRE["plan_acts"]
    argv = ["--params", cfgs[1], "--weight", sf_ckp,
            "--task_cls_params", cfgs[2], "--task_cls_weight", readout_ckp,
            "--savi_params", cfgs[0], "--savi_weight", savi_ckp,
            "--bs", str(bs), "--num_acts", str(acts), "--total_split", "2",
            "--device", DEVICE]
    k1.LAUNCHES = 0
    (_, stats0), dt0 = wall_s(lambda: plan.main(argv + ["--split", "0"]),
                              k3_path="phyre_plan")
    launches = k1.LAUNCHES
    out = {}
    _, dt1 = wall_s(lambda: out.update(s1=plan.main(argv + ["--split", "1"])[1]))
    launches_all = k1.LAUNCHES
    score, _ = plan.main(["--collect", stats0["save_path"], "--total_split", "2"])
    conf = np.load(os.path.join(stats0["save_path"], "all_conf.npy"))
    gt = np.load(os.path.join(stats0["save_path"], "all_gt.npy"))
    cache = _PhyreCache()
    want_gt = cache.get_sample(list(range(PHYRE["tasks"])), None)[
        "simulation_statuses"][:, :acts]
    valid = gt != 0
    batches0 = -(-stats0["scored"] // bs)
    tables_ok = bool(conf.shape == (PHYRE["tasks"], acts)
                     and np.array_equal(gt, want_gt)
                     and ((conf[valid] >= 0) & (conf[valid] <= 1)).all()
                     and (conf[~valid] == -1).all())

    # one batch of the first eval task's valid actions, card against CPU
    # (16 of them: SAVi's encoder over 128 frames takes long on the CPU)
    t_check = time.perf_counter()
    params = [phyre_params(workdir, name)[1] for name in (
        "savi_phyre_params-fold0", "slotformer_phyre_params-fold0",
        "readout_phyre_params-fold0")]
    sim = _PhyreSimulator([None] * PHYRE["tasks"])
    tf = BaseTransforms(params[1].resolution)
    ids = np.nonzero(want_gt[0])[0][:16]
    frames = torch.from_numpy(np.stack([tf(np.ascontiguousarray(
        observations_to_uint8_rgb(sim.simulate_action(
            0, cache.action_array[a]).images[0], True))) for a in ids])[:, None])
    models = {}
    for dev in (DEVICE, "cpu"):
        ms = []
        for p, w in zip(params, (savi_ckp, sf_ckp, readout_ckp)):
            m = build_model(p, device=dev)
            m.load_state_dict(load_checkpoint(w)["state_dict"])
            ms.append(m)
        models[dev] = ms
    rollout_len = params[1].n_sample_frames - 1
    got = plan.score_actions(*models[DEVICE], frames.to(DEVICE),
                             rollout_len).cpu()
    want = plan.score_actions(*models["cpu"], frames, rollout_len)
    err = (got - want).abs().max().item()
    err_table = float(np.abs(conf[0, ids] - got.numpy()).max())
    check_s = time.perf_counter() - t_check
    # the device alone on one full batch, frames already on the card
    full = frames.repeat(-(-bs // len(ids)), 1, 1, 1, 1)[:bs].to(DEVICE)
    batch_ms = cuda_ms(lambda: plan.score_actions(*models[DEVICE], full,
                                                  rollout_len), iters=5)
    scored = stats0["scored"] + out["s1"]["scored"]
    ok = (tables_ok and launches == batches0 and launches_all > launches
          and np.isfinite(score) and max(err, err_table) <= PLAN_CONF_ATOL)
    emit(phase="plan_phyre", tasks=PHYRE["tasks"], actions_per_task=acts,
         batch=bs, k1_shape=dict(zip("BNDSH", PHYRE_K1_PLAN_SHAPE)),
         shard0=dict(pairs=stats0["pairs"], scored=stats0["scored"],
                     seconds=dt0, actions_per_s=stats0["pairs"] / dt0,
                     scored_per_s=stats0["scored"] / dt0, k1_launches=launches,
                     batches=batches0),
         shard1=dict(pairs=out["s1"]["pairs"], seconds=dt1),
         score_batch_ms_device_only=batch_ms,
         device_only_actions_per_s=1e3 * bs / batch_ms,
         scored=scored, invalid=int((~valid).sum()), auccess=score,
         card_vs_cpu=dict(actions=len(ids), max_abs_err=err,
                          max_abs_err_table_vs_card=err_table,
                          tol=PLAN_CONF_ATOL, seconds=check_s),
         tables_ok=tables_ok, ok=ok)
    if not ok:
        raise AssertionError("PHYRE planning check failed")
    return launches_all


# ------------------------------------------------ the Physion readout head


def phase_physion_readout(workdir, steve_ckp, sf_ckp):
    """The Physion readout head on the STEVE family trained above: 2 test
    videos rendered into the mini tree (``PhysionTestMP4s``, with
    ``bad_stimuli.txt``), encoded by ``cli.extract_slots --subset test`` and
    extended 45 -> 150 frames by ``cli.rollout_slots --subset test``; label
    files for the readout and test videos; the full-width
    ``readout_physion_params`` PhysionReadout (6 slots x 192, all 15 pairs,
    the first 75 frames) trained by ``cli.train.run`` at the config's batch
    of 64 on the readout subset's rolled-out slots (128 named copies of the
    2 rolled-out train videos, 2 steps an epoch); then
    ``cli.test_physion_vqa`` over its checkpoints, and the logits of the
    test videos card against CPU."""
    import shutil

    import numpy as np
    import torch
    from PIL import Image

    from slotformer_tpu_torch.cli import extract_slots, rollout_slots
    from slotformer_tpu_torch.cli import test_physion_vqa
    from slotformer_tpu_torch.cli import train as train_cli
    from slotformer_tpu_torch.datasets import build_dataset, physion
    from slotformer_tpu_torch.datasets.synthetic import _render_video
    from slotformer_tpu_torch.models import build_model
    from slotformer_tpu_torch.runtime import dump_obj, load_obj

    t0 = time.perf_counter()
    data = os.path.join(workdir, "data", "Physion")
    T = PHYSION["video_len"]
    listing, labels = {}, []
    for i, task in enumerate(("Collide", "Drop")):
        rel = f"PhysionTestMP4s/{task}/pilot_{task.lower()}_{i:04d}"
        os.makedirs(os.path.join(data, rel))
        video, _ = _render_video(1000 + i, T, 128, 4)
        for t, frame in enumerate(video):
            Image.fromarray(((frame + 1) * 127.5).round().astype(np.uint8)).save(
                os.path.join(data, rel, f"{t:06d}.jpg"), quality=95)
        listing[task] = [rel + ".mp4"]
        labels.append((os.path.basename(rel), i % 2 == 0))
    with open(os.path.join(physion._SPLIT_DIR, "test_test.json"), "w") as f:
        json.dump(listing, f)
    shutil.copy(os.path.join(os.path.dirname(os.path.abspath(physion.__file__)),
                             "splits", "Physion", "bad_stimuli.txt"),
                physion._SPLIT_DIR)
    with open(os.path.join(data, "PhysionTestMP4s", "labels.csv"), "w") as f:
        f.write(",ground truth outcome\n"
                + "".join(f"{n},{v}\n" for n, v in labels))
    # the readout head reads slots alone, so the config's batch of 64 is
    # filled with copies of the 2 rolled-out train videos under new names
    # (each with its listing entry and label row): 2 steps an epoch
    rolled = load_obj(os.path.join(os.path.dirname(sf_ckp),
                                   "readout_slots.pkl"))
    given = sorted(rolled["train"])
    train = {}
    listing = {}
    for j in range(READOUT_PHYSION_TRAIN_VIDEOS):
        task = ("Collide", "Drop")[j % 2]
        name = f"readout_copy_{j:03d}"
        train[name] = rolled["train"][given[j % len(given)]]
        listing.setdefault(task, []).append(
            f"PhysionTrainMP4s/{task}_readout_MP4s/{name}.mp4")
    with open(os.path.join(physion._SPLIT_DIR, "readout_train.json"), "w") as f:
        json.dump(listing, f)
    slots_root = os.path.join(os.path.dirname(sf_ckp), "readout_slots_b64.pkl")
    dump_obj({"train": train, "val": rolled["val"]}, slots_root)
    names = sorted(train) + sorted(rolled["val"])
    with open(os.path.join(data, "PhysionTrainMP4s", "readout_labels.csv"),
              "w") as f:
        f.write(",ground truth outcome\n"
                + "".join(f"{n},{i % 2 == 0}\n" for i, n in enumerate(names)))
    tree_s = time.perf_counter() - t0

    # the test subset's slots: STEVE, then the STEVESlotFormer's rollout
    steve_cfg, _ = physion_params(workdir, "steve_physion_params")
    _, ext_s = wall_s(lambda: extract_slots.main(
        ["--params", steve_cfg, "--weight", steve_ckp, "--subset", "test",
         "--save_path", os.path.join(data, "test_slots.pkl"), "--batch_size",
         str(PHYSION["extract_batch"]), "--chunk_len",
         str(PHYSION["chunk_len"]), "--device", DEVICE]))
    sf_cfg, _ = physion_params(
        workdir, "slotformer_physion_params",
        slots_root=os.path.join(data, "training_slots.pkl"))
    _, ro_s = wall_s(lambda: rollout_slots.main(
        ["--task", "physion", "--subset", "test", "--params", sf_cfg,
         "--weight", sf_ckp, "--save_path",
         os.path.join(workdir, "out", "test_rollout_slots.pkl"),
         "--batch_size", "8", "--device", DEVICE]))

    # the readout, at the config's batch sizes: its slots_root lies next to
    # the SlotFormer weight, where test_physion_vqa reads test_slots.pkl
    cfg, params = derived_params(
        workdir, "readout_physion_params", data_root=data, num_workers=4,
        slots_root=slots_root, max_epochs=10, eval_interval=5, print_iter=1)
    ckp = os.path.join(workdir, "ckpts", "readout_physion_params")
    params.seed = 0
    method, fit_s = wall_s(lambda: train_cli.run(
        params, ckp, device=DEVICE, san_check_val_step=1))
    steps = method.it
    log, train_log = _read_log(ckp)
    val = [r for r in log if r["phase"] == "val"]
    samples = os.path.exists(os.path.join(ckp, "vis", f"readout_{steps}.json"))
    out, vqa_s = wall_s(lambda: test_physion_vqa.main(
        ["--params", cfg, "--weight", ckp, "--batch_size", "8",
         "--device", DEVICE]))
    n_ckpts = len([w for w in os.listdir(ckp) if w.endswith(".pth")
                   and not w.startswith("latest")])
    cells_ok = (len(out["sweep"]) == 6 * n_ckpts > 0 and all(
        0 <= c["acc"] <= 1 and set(c["task_acc"]) <= {"Collide", "Drop"}
        for c in out["sweep"]))

    # the test videos' logits, card against CPU
    params.dataset = "physion_slots_label_test"
    params.slots_root = os.path.join(os.path.dirname(sf_ckp), "test_slots.pkl")
    test_set = build_dataset(params)
    slots = torch.from_numpy(np.stack([test_set[i]["slots"]
                                       for i in range(len(test_set))]))
    gpu = build_model(params, device=DEVICE)
    gpu.load_state_dict(method.model.state_dict())
    cpu = build_model(params, device="cpu")
    cpu.load_state_dict(method.model.state_dict())
    with torch.no_grad():
        got = gpu({"slots": slots.to(DEVICE)})["logits"].cpu()
        want = cpu({"slots": slots})["logits"]
    err = (got - want).abs().max().item()
    steps_per_s, _ = _steady_steps_per_s(method)
    ok = (steps == method.total_steps == params.max_epochs
          * (READOUT_PHYSION_TRAIN_VIDEOS // params.train_batch_size)
          and _finite(log) and val and "acc_0.50" in val[-1] and samples
          and cells_ok and len(test_set) == 2 and err <= READOUT_LOGITS_ATOL)
    emit(phase="physion_readout", config="readout_physion_params",
         batch=params.train_batch_size, frames=params.video_len,
         steps=steps, fit_seconds=fit_s, finite=_finite(log),
         last_val=val[-1] if val else None, steps_per_s=steps_per_s,
         videos_per_s=steps_per_s * params.train_batch_size,
         test_extract_seconds=ext_s, test_rollout_seconds=ro_s,
         tree_seconds=tree_s, vqa_seconds=vqa_s, vqa_cells=len(out["sweep"]),
         vqa_best=out["best"], checkpoints=n_ckpts,
         logits_max_abs_err_vs_cpu=err, tol=READOUT_LOGITS_ATOL, ok=ok)
    if not ok:
        raise AssertionError("Physion readout check failed")


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
    sources = build.KERNEL_SOURCES
    build.build()
    ptxas = [line.strip() for name in sources
             for line in build.build_log(name).splitlines()
             if "Compiling entry function" in line or "registers" in line
             or "spill" in line]
    emit(phase="build", sources=list(sources),
         seconds=time.perf_counter() - t0, ptxas=ptxas)

    def timed(fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        emit(phase_seconds=fn.__name__[len("phase_"):],
             seconds=time.perf_counter() - t0)
        return out

    k1_results = timed(phase_kernel)
    k2_results, k2_launches = timed(phase_kernel_update)
    k3_results = timed(phase_decoder_conv)
    slots, extract_launches = timed(phase_extract, k1_results["clevrer"]["ms"])
    with tempfile.TemporaryDirectory() as workdir:
        train_launches, trained_savi = timed(
            phase_train, os.path.join(workdir, "stosavi_train"))
        timed(phase_rollout, slots)
        slots_path, savi_ckp, sf_extract_launches = timed(phase_slots_file, workdir)
        sf_weight = timed(phase_train_slotformer, slots_path, savi_ckp, workdir)
        timed(phase_test_vp, slots_path, sf_weight, workdir)
        # the VQA head reads slots of the StoSAVi and the SlotFormer trained
        # above
        vqa_launches = timed(phase_vqa, workdir, trained_savi, sf_weight)
        # several ranks on the one card, steps_per_call, the converter
        ddp_launches = timed(phase_two_ranks, workdir)
        timed(phase_ddp_cli, workdir)
        timed(phase_dryrun_multichip)
        timed(phase_steps_per_call, slots_path, savi_ckp, workdir)
        timed(phase_convert, workdir, trained_savi)
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as workdir:
        # the shipped OBJ3D configs name their data and the pretrained SAVi
        # relative to the working directory (./data/OBJ3D,
        # pretrained/savi_obj3d_params/model.pth)
        os.chdir(workdir)
        try:
            timed(phase_obj3d_tree, workdir)
            obj3d_savi, obj3d_train_launches = timed(phase_train_savi_obj3d,
                                                     workdir)
            obj3d_extract_launches = timed(phase_obj3d_slots, workdir, obj3d_savi)
            obj3d_sf = timed(phase_train_slotformer_obj3d, workdir, obj3d_savi)
            timed(phase_test_vp_obj3d, workdir, obj3d_sf)
        finally:
            os.chdir(cwd)
    with tempfile.TemporaryDirectory() as workdir:
        # the shipped Physion configs name their pretrained checkpoints
        # relative to the working directory (pretrained/<run>/model.pth);
        # each training phase links its checkpoint there
        os.chdir(workdir)
        try:
            timed(phase_physion_tree, workdir)
            dvae_ckp = timed(phase_train_dvae, workdir)
            timed(phase_tokenize, workdir, dvae_ckp)
            steve_ckp, steve_train_launches, k1_grad = timed(
                phase_train_steve, workdir, dvae_ckp)
            steve_launches = timed(phase_steve_extract, workdir, steve_ckp,
                                   k1_results["steve"]["ms"])
            sf_ckp = timed(phase_train_steve_slotformer, workdir, steve_ckp)
            sf_models = timed(phase_steve_rollout, workdir, sf_ckp)
            timed(phase_steve_decode, *sf_models)
            timed(phase_physion_readout, workdir, steve_ckp, sf_ckp)
        finally:
            os.chdir(cwd)
    with tempfile.TemporaryDirectory() as workdir:
        # the shipped PHYRE configs name their slots and checkpoints
        # relative to the working directory (checkpoints/<run>/{split}_slots,
        # pretrained/savi_phyre_params-fold0/model.pth)
        os.chdir(workdir)
        try:
            timed(phase_phyre_tree, workdir)
            phyre_savi, phyre_train_launches = timed(phase_train_savi_phyre,
                                                     workdir)
            phyre_extract_launches = timed(phase_phyre_slots, workdir,
                                           phyre_savi)
            phyre_sf = timed(phase_train_slotformer_phyre, workdir)
            timed(phase_rollout_phyre, workdir, phyre_sf)
            phyre_readout = timed(phase_train_readout_phyre, workdir)
            phyre_plan_launches = timed(phase_plan_phyre, workdir, phyre_savi,
                                        phyre_sf, phyre_readout)
        finally:
            os.chdir(cwd)
            sys.modules.pop("phyre", None)

    # not measured here: what the earlier kernels took at the cases of the
    # kernels line (K1 with its weights packed inside every call, as
    # ms_packing_each_call above still times it)
    emit(phase="record", what="ms before the H100 redesign, same cases, NVIDIA "
         "H100 80GB HBM3 at 700 W, from this script's earlier version",
         previous_ms=dict(fused_slot_attention=2.276,
                          slot_attention_update=0.0911))
    print(smi, flush=True)
    k1, k2 = k1_results["train_batch"], k2_results["clevrer"]
    k1_steve, k1_steve_train = k1_results["steve"], k1_results["steve_train"]
    k1_obj3d = k1_results["obj3d"]
    emit(kernels=[
        dict(name="fused_slot_attention", route="cuda",
             source="slotformer_tpu_torch/kernels/csrc/slot_attention.cu",
             replaces="slotformer_tpu/ops/slot_attention_kernel.py:284",
             case="train_batch", launches=train_launches,
             launches_by_path=dict(train=train_launches,
                                   extract=extract_launches,
                                   slotformer_slots_file=sf_extract_launches,
                                   steve_train=steve_train_launches,
                                   steve_extract=steve_launches,
                                   obj3d_train=obj3d_train_launches,
                                   obj3d_extract=obj3d_extract_launches,
                                   vqa_extract=vqa_launches,
                                   ddp_train=ddp_launches,
                                   phyre_train=phyre_train_launches,
                                   phyre_extract=phyre_extract_launches,
                                   phyre_plan=phyre_plan_launches),
             max_abs_err=k1["max_abs_err"], ms=k1["ms"],
             plain_ms=k1["plain_ms"], bound_ms=k1["bound_ms"],
             bound_by=k1["bound_by"], library_ms=None,
             steve_case=dict(shape=dict(zip("BNDSH", STEVE_K1_SHAPE)),
                             **k1_steve),
             steve_train_case=dict(
                 shape=dict(zip("BNDSH", STEVE_TRAIN_K1_SHAPE)), **k1_steve_train,
                 grad_rel_err_vs_plain_autograd=k1_grad[
                     "grad_rel_err_vs_plain_autograd"],
                 tol_grad_rel=K1_GRAD_RTOL,
                 backward_ms_plain_autograd=k1_grad["backward_ms_plain_autograd"]),
             obj3d_case=dict(shape=dict(zip("BNDSH", OBJ3D_K1_SHAPE)),
                             **k1_obj3d),
             phyre_train_case=dict(
                 shape=dict(zip("BNDSH", PHYRE_K1_TRAIN_SHAPE)),
                 launches_by_path=dict(train=phyre_train_launches,
                                       extract=phyre_extract_launches),
                 **k1_results["phyre_train"]),
             phyre_plan_case=dict(
                 shape=dict(zip("BNDSH", PHYRE_K1_PLAN_SHAPE)),
                 launches_by_path=dict(plan=phyre_plan_launches),
                 **k1_results["phyre_plan"])),
        dict(name="slot_attention_update", route="cuda",
             source="slotformer_tpu_torch/kernels/csrc/slot_attention_update.cu",
             replaces="slotformer_tpu/ops/slot_attention_kernel.py:87",
             case="clevrer", launches=k2_launches,
             launches_by_path=dict(entry_point=k2_launches),
             max_abs_err=k2["max_abs_err"], ms=k2["ms"],
             plain_ms=k2["plain_ms"], bound_ms=k2["bound_ms"],
             bound_by=k2["bound_by"], library_ms=None),
        dict(name="decoder_conv_s1", route="cuda",
             source="slotformer_tpu_torch/kernels/csrc/decoder_conv.cu",
             replaces=None, case="rollout",
             launches_by_path=K3_LAUNCHES,
             launches_check=k3_results["launches_check"],
             **k3_results["rollout"], phyre_case=k3_results["phyre"])])
    # every SAVi decoder forward on a CUDA float32 input outside autocast
    # takes K3: these paths decode
    silent = [p for p in ("train", "rollout", "slotformer_train", "ddp_train")
              if not K3_LAUNCHES.get(p)]
    if silent:
        raise AssertionError(f"K3 did not run on {silent}")
    emit(ok=True, device=dict(platform="gpu", kind=kind,
                              count=torch.cuda.device_count()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
