"""Kernels K1 and K2 on the card: each CUDA kernel against its plain version;
SlotFormer's image-loss branches and the video-prediction metrics on the card.

Marked ``cuda`` and skipped without a card. Imports no JAX, so it also runs
where JAX is not installed:

    python -m pytest tests/test_torch_kernels_cuda.py --noconftest -q

Tolerances. K1: 1e-4 abs on the slots and 1e-5 abs on the attention. Both
sides are float32 (TF32 off) but sum in different orders; the attention is a
softmax in [0, 1] and the slots are O(1) after two GRU/MLP rounds. K2: 1e-5
abs on the attention and 1e-4 on the updates (tests/test_pallas_ops.py's
tolerances; the updates are weighted means of O(1) values over N pixels).
Neither kernel uses atomics, so a second call on the same inputs must give the
same bits.
"""

import importlib
import shutil

import pytest
import torch

from slotformer_tpu_torch.kernels import build
from slotformer_tpu_torch.kernels import slot_attention as k1
from slotformer_tpu_torch.kernels import slot_attention_update

k2 = importlib.import_module("slotformer_tpu_torch.kernels.slot_attention_update")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(B, N, D, S, H, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    shapes = dict(wq=(D, D), w1=(D, H), b1=(H,), w2=(H, D))
    wp = {}
    for n in k1.WP_KEYS:
        shape = shapes.get(n, (D, D) if n.startswith("w_") else (D,))
        w = torch.randn(shape, generator=g)
        wp[n] = (w * shape[0] ** -0.5 if len(shape) == 2 else 0.1 * w).to(device)
    wp["q_ln_scale"] += 1.0
    wp["mlp_ln_scale"] += 1.0
    k, v, slots = (torch.randn(s, generator=g).to(device)
                   for s in ((B, N, D), (B, N, D), (B, S, D)))
    return k, v, slots, wp


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,D,S,H", [(8, 4096, 128, 7, 256),
                                       (3, 1000, 128, 5, 256),
                                       (2, 777, 64, 8, 96),
                                       (8, 4096, 192, 6, 384),
                                       (64, 4096, 128, 6, 256)])
def test_kernel_matches_plain(cuda, B, N, D, S, H):
    k, v, slots, wp = _inputs(B, N, D, S, H, cuda)
    before = k1.LAUNCHES
    got = k1.fused_slot_attention(k, v, slots, wp, 2, S, D ** -0.5, 1e-6)
    want = k1.fused_slot_attention_plain(k, v, slots, wp, 2, S, D ** -0.5, 1e-6)
    torch.cuda.synchronize()
    assert k1.LAUNCHES == before + 1
    assert (got[0] - want[0]).abs().max().item() < 1e-4
    assert (got[1] - want[1]).abs().max().item() < 1e-5


@pytest.mark.cuda
def test_kernel_gradients_are_plain_autograd(cuda):
    k, v, slots, wp = _inputs(2, 300, 32, 6, 64, cuda, seed=1)
    leaves = [k, v, slots] + [wp[n] for n in k1.WP_KEYS]

    def grads(fn):
        xs = [x.clone().requires_grad_(True) for x in leaves]
        s, a = fn(xs)
        return torch.autograd.grad(s.square().sum() + a.sum(), xs)

    args = (2, 6, 32 ** -0.5, 1e-6)
    got = grads(lambda xs: k1.fused_slot_attention(
        *xs[:3], dict(zip(k1.WP_KEYS, xs[3:])), *args))
    want = grads(lambda xs: k1.fused_slot_attention_plain(
        *xs[:3], dict(zip(k1.WP_KEYS, xs[3:])), *args))
    for a, b in zip(got, want):
        assert torch.allclose(a, b, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_kernel_raises_instead_of_falling_back(cuda):
    k, v, slots, wp = _inputs(2, 64, 32, 4, 64, cuda)
    with pytest.raises(TypeError):
        k1.fused_slot_attention(k.double(), v, slots, wp, 2, 4)
    with pytest.raises(ValueError):
        k1.fused_slot_attention(k.transpose(1, 2).contiguous().transpose(1, 2),
                                v, slots, wp, 2, 4)
    k9, v9, s9, wp9 = _inputs(1, 64, 32, 9, 64, cuda)
    with pytest.raises(ValueError):
        k1.fused_slot_attention(k9, v9, s9, wp9, 2, 9)
    with pytest.raises(ValueError):
        k1.fused_slot_attention(k, v, slots.cpu(), wp, 2, 4)


def _update_inputs(B, N, D, S, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    k, v = torch.randn(B, N, D, generator=g), torch.randn(B, N, D, generator=g)
    q = torch.randn(B, S, D, generator=g) * D ** -0.5
    return k.to(device), v.to(device), q.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,D,S", [(8, 4096, 128, 7), (8, 1000, 128, 5),
                                     (64, 4096, 128, 7)])
def test_update_kernel_matches_plain(cuda, B, N, D, S):
    k, v, q = _update_inputs(B, N, D, S, cuda)
    before = k2.LAUNCHES
    upd, attn = slot_attention_update(k, v, q)
    want_upd, want_attn = k2.slot_attention_update_plain(k, v, q)
    torch.cuda.synchronize()
    assert k2.LAUNCHES == before + 1
    assert upd.shape == (B, S, D) and attn.shape == (B, N, S)
    assert (attn - want_attn).abs().max().item() < 1e-5
    assert (upd - want_upd).abs().max().item() < 1e-4
    # no atomics: the same inputs give the same bits
    again = slot_attention_update(k, v, q)
    assert torch.equal(again[0], upd) and torch.equal(again[1], attn)


@pytest.mark.cuda
def test_update_gradients_are_plain_autograd(cuda):
    k, v, q = _update_inputs(2, 300, 64, 6, cuda, seed=1)

    def grads(fn):
        xs = [x.clone().requires_grad_(True) for x in (k, v, q)]
        upd, attn = fn(*xs)
        return torch.autograd.grad((upd ** 2).sum() + (attn ** 3).sum(), xs)

    for a, b in zip(grads(slot_attention_update),
                    grads(k2.slot_attention_update_plain)):
        assert torch.allclose(a, b, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_update_kernel_raises_instead_of_falling_back(cuda):
    k, v, q = _update_inputs(1, 64, 32, 9, cuda)
    with pytest.raises(ValueError):
        slot_attention_update(k, v, q)
    with pytest.raises(ValueError):
        slot_attention_update(k, v, q[:, :4].cpu())
    k, v, q = _update_inputs(1, 64, 2048, 4, cuda)
    with pytest.raises(ValueError):
        slot_attention_update(k, v, q)  # D above the kernel's shared memory


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,D,S,H", [(8, 4096, 128, 7, 256),
                                       (3, 1000, 128, 5, 256),
                                       (8, 4096, 192, 6, 384)])
def test_kernel_is_bit_stable(cuda, B, N, D, S, H):
    k, v, slots, wp = _inputs(B, N, D, S, H, cuda, seed=2)
    first = k1.fused_slot_attention(k, v, slots, wp, 2, S, D ** -0.5, 1e-6)
    # other work in between, then packed weights: still the same bits
    k1.fused_slot_attention(v, k, slots, wp, 2, S, D ** -0.5, 1e-6)
    again = k1.fused_slot_attention(k, v, slots, k1.pack_weights(wp), 2, S,
                                    D ** -0.5, 1e-6)
    torch.cuda.synchronize()
    assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])


@pytest.mark.cuda
@pytest.mark.parametrize("N", [1000, 4097])
@pytest.mark.parametrize("S", range(1, 9))
def test_kernels_at_chunk_ragged_n_and_every_slot_count(cuda, N, S):
    B, D, H = 2, 128, 256
    k, v, slots, wp = _inputs(B, N, D, S, H, cuda, seed=S)
    got = k1.fused_slot_attention(k, v, slots, wp, 2, S, D ** -0.5, 1e-6)
    want = k1.fused_slot_attention_plain(k, v, slots, wp, 2, S, D ** -0.5, 1e-6)
    assert (got[0] - want[0]).abs().max().item() < 1e-4
    assert (got[1] - want[1]).abs().max().item() < 1e-5
    q = slots * D ** -0.5
    upd, attn = slot_attention_update(k, v, q)
    want_upd, want_attn = k2.slot_attention_update_plain(k, v, q)
    torch.cuda.synchronize()
    assert (attn - want_attn).abs().max().item() < 1e-5
    assert (upd - want_upd).abs().max().item() < 1e-4


@pytest.mark.cuda
def test_kernel_at_the_phyre_training_shape(cuda):
    """PHYRE SAVi's training and extraction call, (32, 4096, 128, 8, 256):
    8 slots with k and v streamed from HBM over the whole card."""
    B, N, D, S, H = 32, 4096, 128, 8, 256
    k, v, slots, wp = _inputs(B, N, D, S, H, cuda, seed=8)
    got = k1.fused_slot_attention(k, v, slots, wp, 2, S, D ** -0.5, 1e-6)
    again = k1.fused_slot_attention(k, v, slots, wp, 2, S, D ** -0.5, 1e-6)
    want = k1.fused_slot_attention_plain(k, v, slots, wp, 2, S, D ** -0.5, 1e-6)
    torch.cuda.synchronize()
    assert (got[0] - want[0]).abs().max().item() < 1e-4
    assert (got[1] - want[1]).abs().max().item() < 1e-5
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])


@pytest.mark.cuda
@pytest.mark.parametrize("B,N", [(66, 4097), (33, 8200)])
def test_kernels_at_the_large_batch_chunk(cuda, B, N):
    """B * N large enough for chunks of 512 pixels, the last one ragged, and
    for clusters that take several batch elements, the last one short."""
    D, S, H = 128, 7, 256
    k, v, slots, wp = _inputs(B, N, D, S, H, cuda, seed=3)
    got = k1.fused_slot_attention(k, v, slots, wp, 2, S, D ** -0.5, 1e-6)
    want = k1.fused_slot_attention_plain(k, v, slots, wp, 2, S, D ** -0.5, 1e-6)
    assert (got[0] - want[0]).abs().max().item() < 1e-4
    assert (got[1] - want[1]).abs().max().item() < 1e-5
    q = slots * D ** -0.5
    upd, attn = slot_attention_update(k, v, q)
    want_upd, want_attn = k2.slot_attention_update_plain(k, v, q)
    torch.cuda.synchronize()
    assert (attn - want_attn).abs().max().item() < 1e-5
    assert (upd - want_upd).abs().max().item() < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["d_not_multiple_of_4", "d_above_256",
                                  "h_not_multiple_of_4",
                                  "h_above_1024_per_block", "misaligned"])
def test_kernels_raise_on_what_the_redesign_refuses(cuda, case):
    D = dict(d_not_multiple_of_4=18, d_above_256=260,
             h_above_1024_per_block=4).get(case, 32)
    H = dict(h_not_multiple_of_4=30, h_above_1024_per_block=2052).get(case, 64)
    k, v, slots, wp = _inputs(2, 64, D, 4, H, cuda)
    if case == "misaligned":
        k = torch.randn(2 * 64 * D + 1, device=cuda)[1:].reshape(2, 64, D)
    before = k1.LAUNCHES, k2.LAUNCHES
    with pytest.raises(ValueError):
        k1.fused_slot_attention(k, v, slots, wp, 2, 4)
    if not case.startswith("h_"):
        with pytest.raises(ValueError):
            slot_attention_update(k, v, slots)
    assert (k1.LAUNCHES, k2.LAUNCHES) == before


@pytest.mark.cuda
def test_build_picks_up_an_edited_header(cuda, tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "NVCC_FLAGS",
                        build.NVCC_FLAGS[:-1] + (str(csrc),))
    monkeypatch.setattr(build, "_LIBS", {})
    name = "slot_attention_update"
    build.load(name)
    first = build._lib_path(name)
    assert first.is_file() and "registers" in build.build_log(name)
    with open(csrc / "slot_attention_sweep.cuh", "a") as f:
        f.write("// edited\n")
    monkeypatch.setattr(build, "_LIBS", {})
    build.load(name)
    second = build._lib_path(name)
    assert second != first and second.is_file()


# ---- SlotFormer's image-loss branches and the metrics, on the card
# (no kernel of this repository runs in them: cuDNN and PyTorch on the card
# against the CPU). Tolerances: losses 1e-5 relative and d(loss)/d(slots)
# 1e-4 of its largest entry between the float32 branches (one decoder pass,
# summed in other orders); bf16 against float32 at rtol 3e-2, the tolerance
# of the CPU tests; pixel metrics 1e-4 relative, ARI/mIoU (float32 sums of
# exact integer counts) 1e-5 absolute, the box matching equal.

def _tiny_slotformer(device, **loss_dict):
    from slotformer_tpu_torch.models.slotformer import SlotFormer

    torch.manual_seed(0)
    return SlotFormer(
        resolution=(16, 16), slot_dict=dict(num_slots=4, slot_size=16),
        dec_dict=dict(dec_channels=(16, 8, 8), dec_resolution=(4, 4), dec_ks=3,
                      dec_norm=""),
        rollout_dict=dict(num_slots=4, slot_size=16, history_len=3, t_pe="sin",
                          d_model=16, num_layers=1, num_heads=2, ffn_dim=32,
                          dropout=0.0),
        loss_dict=dict(rollout_len=4, use_img_recon_loss=True, **loss_dict),
    ).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("vid_len", [False, True])
def test_loss_branches_agree_on_the_card(cuda, vid_len):
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator().manual_seed(1)
    batch = {"slots": torch.randn(4, 7, 4, 16, generator=g).to(cuda),
             "img": torch.randn(4, 7, 16, 16, 3, generator=g).to(cuda)}
    if vid_len:
        batch["vid_len"] = torch.tensor([5, 7, 6, 7], device=cuda)
    results = {}
    for name, ld in (("plain", dict(dec_chunk_frames=0)),
                     ("chunked", dict(dec_chunk_frames=4)),
                     ("custom", dict(dec_custom_bwd=True, dec_chunk_frames=0)),
                     ("custom_chunked", dict(dec_custom_bwd=True, dec_chunk_frames=4)),
                     ("bf16", dict(dec_recon_bf16=True, dec_chunk_frames=0))):
        model = _tiny_slotformer(cuda, **ld)
        losses = model.train_loss(batch, loss_decay_factor=0.5)
        sum(losses.values()).backward()
        results[name] = (losses, {n: p.grad for n, p in model.named_parameters()
                                  if n.startswith("rollouter.") and p.grad is not None})
    ref_l, ref_g = results["plain"]
    for name, (losses, grads) in results.items():
        rtol = 3e-2 if name == "bf16" else 2e-5
        for k in ref_l:
            torch.testing.assert_close(losses[k], ref_l[k], rtol=rtol, atol=0)
        if name == "bf16":
            continue
        assert sorted(grads) == sorted(ref_g)
        for n, want in ref_g.items():
            assert (grads[n] - want).abs().max() <= 1e-4 * want.abs().max() + 1e-12, n


@pytest.mark.cuda
def test_pred_eval_step_card_matches_cpu(cuda):
    import numpy as np

    from slotformer_tpu_torch.metrics import (load_lpips, masks_to_boxes,
                                              pred_eval_step)

    torch.backends.cudnn.allow_tf32 = False
    r = np.random.default_rng(0)
    B, T, H, W, N = 3, 4, 32, 32, 5
    gt = r.uniform(-1, 1, size=(B, T, H, W, 3)).astype(np.float32)
    pred = np.clip(gt + r.normal(0, 0.2, size=gt.shape), -1, 1).astype(np.float32)
    gt_mask = r.integers(0, N, size=(B, T, H, W)).astype(np.int32)
    pred_mask = np.where(r.uniform(size=gt_mask.shape) < 0.8, gt_mask,
                         r.integers(0, N, size=gt_mask.shape)).astype(np.int32)
    gt_bbox = masks_to_boxes(gt_mask, N).numpy()[:, :, 1:]
    kw = dict(gt=gt, gt_mask=gt_mask, gt_pres_mask=gt_bbox[..., 0] >= 0,
              gt_bbox=gt_bbox, eval_traj=True, num_classes=N)
    out = {}
    for dev in ("cpu", cuda):
        pm = torch.from_numpy(pred_mask).to(dev)
        out[str(dev)] = pred_eval_step(
            pred=torch.from_numpy(pred).to(dev), pred_mask=pm,
            pred_bbox=masks_to_boxes(pm, N),
            lpips_fn=load_lpips("", fallback="untrained", device=dev), **kw)
    on_cpu, on_card = out["cpu"], out[str(cuda)]
    for k in on_cpu:
        if k in ("mse", "psnr", "ssim", "percept_dist"):
            np.testing.assert_allclose(on_card[k], on_cpu[k], rtol=1e-4, err_msg=k)
        elif k in ("ari", "fari", "miou"):
            np.testing.assert_allclose(on_card[k], on_cpu[k], rtol=0, atol=1e-5,
                                       err_msg=k)
        else:
            assert on_card[k] == on_cpu[k], k
