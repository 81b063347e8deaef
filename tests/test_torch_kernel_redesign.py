"""The parts of the H100 redesign of kernels K1 and K2 that a CPU can check.

The CUDA kernels run only on a card (tests/test_torch_kernels_cuda.py). Here:

- ``pack_weights`` / ``unpack_weights``: the round trip, and packed against
  unpacked weights through ``fused_slot_attention`` in values and in the
  gradients of the unpacked weights (exact: the same arithmetic);
- the split-N algorithm of ``csrc/slot_attention_sweep.cuh`` in plain
  PyTorch (a record of num / den / sum_n v per chunk of N, the records added
  in chunk order, then the finishing division) against both plain versions,
  1e-6 abs in float32 (another order of the sums over N), at chunk sizes that
  do and do not divide N;
- ``StoSAVi.encode`` and a training forward/backward with the weights packed
  once per call against packing in every frame step: the values are exact
  (the same arithmetic); the parameter gradients agree to 1e-6 of each
  gradient's largest entry, because the six frame steps' gradients are then
  added in the packed layout before they reach the parameters and not after
  (another order of the same float32 sum). The encode also still matches the
  JAX package at tests/test_torch_savi.py's tolerance;
- what the redesigned kernels refuse (raised by the wrappers' checks before
  any launch), and the build's hash, which must cover the shared header.
"""

import importlib
import shutil

import pytest
import torch

from slotformer_tpu_torch.kernels import build
from slotformer_tpu_torch.kernels import slot_attention as k1
from slotformer_tpu_torch.models.savi import SAViCell
from slotformer_tpu_torch.models.slot_attention import SlotAttention
from test_torch_savi import SEQ_ATOL, _pair
from torch_port_helpers import close, randn, rng, t

k2 = importlib.import_module("slotformer_tpu_torch.kernels.slot_attention_update")


def _random_wp(r, D, H) -> dict:
    shapes = dict(wq=(D, D), w1=(D, H), b1=(H,), w2=(H, D))
    wp = {}
    for n in k1.WP_KEYS:
        shape = shapes.get(n, (D, D) if n.startswith("w_") else (D,))
        wp[n] = t(randn(r, *shape) * (shape[0] ** -0.5 if len(shape) == 2 else 0.1))
    wp["q_ln_scale"] += 1.0
    wp["mlp_ln_scale"] += 1.0
    return wp


# ------------------------------------------------------------- pack_weights
def test_pack_weights_round_trips():
    D, H = 16, 32
    wp = _random_wp(rng(0), D, H)
    packed = k1.pack_weights(wp)
    assert set(packed) == set(k1.PACKED_KEYS)
    assert packed["gru_i"].shape == (D, 3 * D) and packed["vecs"].shape == (9, D)
    assert all(p.is_contiguous() and p.dtype == torch.float32
               for p in packed.values())
    # the three gates of feature d sit side by side at columns 3d..3d+2
    assert torch.equal(packed["gru_h"][:, 3 * 5 + 1], wp["w_hz"][:, 5])
    back = k1.unpack_weights(packed)
    assert set(back) == set(k1.WP_KEYS)
    for n in k1.WP_KEYS:
        assert torch.equal(back[n], wp[n]), n
    assert k1.pack_weights(packed) is packed and k1.unpack_weights(wp) is wp


def test_pack_weights_raises_on_a_wrong_shape():
    wp = _random_wp(rng(1), 16, 32)
    wp["w_hz"] = wp["w_hz"][:, :8]
    with pytest.raises(ValueError, match="w_hz"):
        k1.pack_weights(wp)


@pytest.mark.parametrize("through_function", [False, True])
def test_packed_and_unpacked_weights_agree(monkeypatch, through_function):
    """Values and the gradients of the unpacked weights, on the CPU path and
    through the ``autograd.Function`` (its kernel stood in by the plain
    version)."""
    r = rng(2)
    B, N, D, S, H = 2, 24, 16, 5, 32
    k, v, slots = t(randn(r, B, N, D)), t(randn(r, B, N, D)), t(randn(r, B, S, D))
    wp = _random_wp(r, D, H)
    g_slots, g_attn = t(randn(r, B, S, D)), t(randn(r, B, N, S))
    if through_function:
        monkeypatch.setattr(k1, "_launch", k1.fused_slot_attention_plain)

    def call(weights):
        if not through_function:
            return k1.fused_slot_attention(k, v, slots, weights, 2, S, D ** -0.5)
        packed = k1.pack_weights(weights)
        return k1._FusedSlotAttention.apply(
            2, S, D ** -0.5, 1e-6, k, v, slots,
            *[packed[n] for n in k1.PACKED_KEYS])

    def run(pack):
        leaves = {n: w.clone().requires_grad_(True) for n, w in wp.items()}
        out = call(k1.pack_weights(leaves) if pack else leaves)
        loss = (out[0] * g_slots).sum() + (out[1] * g_attn).sum()
        return out, torch.autograd.grad(loss, list(leaves.values()))

    (s0, a0), g0 = run(pack=False)
    (s1, a1), g1 = run(pack=True)
    assert torch.equal(s0, s1) and torch.equal(a0, a1)
    for name, a, b in zip(wp, g0, g1):
        assert torch.equal(a, b), name


# --------------------------------------------------------- split-N algorithm
def _records(k, v, q, chunk_n):
    """The sweep's records: per chunk of N, (num [B,S,D], sum_n v [B,D],
    den [B,S]) and the attention of its pixels."""
    out = []
    for n0 in range(0, k.shape[1], chunk_n):
        kc, vc = k[:, n0:n0 + chunk_n], v[:, n0:n0 + chunk_n]
        attn = torch.softmax(torch.einsum("bnd,bsd->bns", kc, q), dim=-1)
        out.append((torch.einsum("bns,bnd->bsd", attn, vc), vc.sum(1),
                    attn.sum(1), attn))
    return out


def _finish(records, N, eps):
    """Adds the records in chunk order, then the finishing division."""
    num, sumv, den = (sum(r[i] for r in records) for i in range(3))
    upd = (num + eps * sumv[:, None]) / (den[..., None] + eps * N)
    return upd, torch.cat([r[3] for r in records], 1)


@pytest.mark.parametrize("S", [5, 7, 8])
@pytest.mark.parametrize("N,chunk_n", [(96, 32), (100, 32), (77, 128), (130, 64)])
def test_split_n_records_equal_update_plain(N, chunk_n, S):
    r = rng(10 + S)
    B, D = 2, 16
    k, v = t(randn(r, B, N, D)), t(randn(r, B, N, D))
    q = t(randn(r, B, S, D)) * D ** -0.5
    upd, attn = _finish(_records(k, v, q, chunk_n), N, 1e-6)
    want_upd, want_attn = k2.slot_attention_update_plain(k, v, q, 1e-6)
    assert (upd - want_upd).abs().max().item() <= 1e-6
    assert (attn - want_attn).abs().max().item() <= 1e-6


@pytest.mark.parametrize("S", [5, 7, 8])
@pytest.mark.parametrize("N,chunk_n", [(96, 32), (100, 32)])
def test_split_n_rounds_equal_fused_plain(N, chunk_n, S):
    """K1 as the kernels run it: per round a sweep into records, then the
    slot-side update from their sum."""
    r = rng(20 + S)
    B, D, H, eps = 2, 16, 32, 1e-6
    k, v, h = t(randn(r, B, N, D)), t(randn(r, B, N, D)), t(randn(r, B, S, D))
    wp = _random_wp(r, D, H)
    want = k1.fused_slot_attention_plain(k, v, h, wp, 2, S, D ** -0.5, eps)
    for _ in range(2):
        q = k1._layernorm(h, wp["q_ln_scale"], wp["q_ln_bias"]) @ wp["wq"] * D ** -0.5
        upd, attn = _finish(_records(k, v, q, chunk_n), N, eps)
        rr = torch.sigmoid(upd @ wp["w_ir"] + wp["b_ir"] + h @ wp["w_hr"])
        z = torch.sigmoid(upd @ wp["w_iz"] + wp["b_iz"] + h @ wp["w_hz"])
        n = torch.tanh(upd @ wp["w_in"] + wp["b_in"]
                       + rr * (h @ wp["w_hn"] + wp["b_hn"]))
        h = (1.0 - z) * n + z * h
        hm = k1._layernorm(h, wp["mlp_ln_scale"], wp["mlp_ln_bias"])
        h = h + torch.relu(hm @ wp["w1"] + wp["b1"]) @ wp["w2"] + wp["b2"]
    assert (h - want[0]).abs().max().item() <= 1e-6
    assert (attn - want[1]).abs().max().item() <= 1e-6


# ------------------------------------------------- packed once per encode
def _count_packs(monkeypatch) -> list:
    real = SlotAttention.packed_weights
    calls = []
    monkeypatch.setattr(SlotAttention, "packed_weights",
                        lambda self: calls.append(1) or real(self))
    return calls


def _pack_in_every_frame_step(monkeypatch) -> None:
    """The cell drops the weights ``StoSAVi.encode`` packed, so the
    slot-attention module packs them in every frame step."""
    real = SAViCell.forward

    def forward(self, carry, kv_t, is_first, eps_t=None, generator=None,
                sa_weights=None):
        return real(self, carry, kv_t, is_first, eps_t, generator, None)

    monkeypatch.setattr(SAViCell, "forward", forward)


def test_encode_packs_once_and_equals_per_frame_packing(monkeypatch):
    jmod, params, port, img, eps = _pair(T=3, seed=5)
    kd_jax, ps_jax, *_ = jmod.apply({"params": params}, img, method="encode",
                                    sample_eps=eps)
    calls = _count_packs(monkeypatch)
    with torch.no_grad():
        kd, ps, _, _ = port.encode(t(img), sample_eps=t(eps))
    assert len(calls) == 1  # three frame steps, one packing
    _pack_in_every_frame_step(monkeypatch)
    with torch.no_grad():
        kd_each, ps_each, _, _ = port.encode(t(img), sample_eps=t(eps))
    assert len(calls) == 1 + 1 + 3  # encode's own, dropped, and one per step
    assert torch.equal(kd, kd_each) and torch.equal(ps, ps_each)
    close(kd, kd_jax, atol=SEQ_ATOL)
    close(ps, ps_jax, atol=SEQ_ATOL)


def test_train_step_packed_once_equals_per_frame_packing(monkeypatch):
    _, _, port, img, eps = _pair(T=3, seed=6)
    port.train()
    batch = {"img": t(img), "sample_eps": t(eps)}

    def step():
        port.zero_grad(set_to_none=True)
        losses = port.train_loss(batch)
        sum(losses.values()).backward()
        return ({n: v.item() for n, v in losses.items()},
                {n: p.grad.clone() for n, p in port.named_parameters()})

    losses, grads = step()
    _pack_in_every_frame_step(monkeypatch)
    losses_each, grads_each = step()
    assert losses == losses_each
    assert set(grads) == set(grads_each)
    for n, g in grads.items():
        scale = max(g.abs().max().item(), 1e-30)
        assert (g - grads_each[n]).abs().max().item() <= 1e-6 * scale, n
    # every slot-attention parameter the pack reads gets a gradient
    for n in ("slot_attention.gru.weight_hh", "slot_attention.gru.bias_hh",
              "slot_attention.project_q.1.weight", "slot_attention.mlp.3.bias"):
        assert grads[n].abs().max().item() > 0, n


def test_packed_weights_follow_the_parameters():
    """Nothing is kept across calls: a changed parameter shows in the next
    pack (the trainer packs anew after every optimizer step)."""
    sa = SlotAttention(12, 2, 4, 16, 32)
    before = sa.packed_weights()["gru_i"].clone()
    with torch.no_grad():
        sa.gru.weight_ih.add_(1.0)
    assert torch.equal(sa.packed_weights()["gru_i"], before + 1.0)


# ------------------------------------------- what the new kernels refuse
@pytest.mark.parametrize("case", ["d_not_multiple_of_4", "d_above_256",
                                  "h_not_multiple_of_4",
                                  "h_above_1024_per_block", "misaligned_k",
                                  "packed_wrong_shape"])
def test_fused_check_raises_on_what_the_kernel_refuses(case):
    r = rng(30)
    D = dict(d_not_multiple_of_4=18, d_above_256=260,
             h_above_1024_per_block=4).get(case, 16)
    # D=4 leaves a cluster of one block, which would take all 2052 columns
    H = dict(h_not_multiple_of_4=30, h_above_1024_per_block=2052).get(case, 32)
    B, N, S = 1, 12, 4
    k, v, slots = t(randn(r, B, N, D)), t(randn(r, B, N, D)), t(randn(r, B, S, D))
    wp = k1.pack_weights(_random_wp(r, D, H))
    if case == "misaligned_k":
        k = t(randn(r, B * N * D + 1))[1:].reshape(B, N, D)
        assert k.is_contiguous() and k.data_ptr() % 16
    if case == "packed_wrong_shape":
        wp = dict(wp, vecs=wp["vecs"][:8].contiguous())
    with pytest.raises(ValueError, match=r"\(|D=|vecs"):
        k1._check(k, v, slots, wp, S)


@pytest.mark.parametrize("D,H,blocks", [(128, 256, 8), (16, 32, 4), (8, 24, 2),
                                        (4, 2052, 1), (128, 8192, 8),
                                        (192, 384, 8)])
def test_fused_check_takes_what_a_cluster_block_holds(D, H, blocks):
    """H up to 1024 columns per block of the cluster passes the check (a
    larger shared-memory need is the launch's to refuse)."""
    assert k1.cluster_blocks(D, H) == blocks
    r = rng(32)
    k, v, slots = t(randn(r, 1, 8, D)), t(randn(r, 1, 8, D)), t(randn(r, 1, 3, D))
    if H // blocks > k1.MAX_COLS_PER_BLOCK:
        with pytest.raises(ValueError, match=f"H={H}"):
            k1._check(k, v, slots, _random_wp(r, D, H), 3)
    else:
        assert k1._check(k, v, slots, _random_wp(r, D, H), 3)[:4] == (1, 8, D, H)


def test_fused_check_takes_the_obj3d_training_shape():
    """OBJ3D SAVi's training call, (B, N, D, S, H) = (64, 4096, 128, 6, 256):
    6 slots with D=128's resident slot-side weights, H split over a cluster
    of 8 blocks."""
    B, N, D, S, H = 64, 4096, 128, 6, 256
    assert k1.cluster_blocks(D, H) == 8 and H // 8 <= k1.MAX_COLS_PER_BLOCK
    k, v = torch.empty(B, N, D), torch.empty(B, N, D)  # shapes only
    slots = t(randn(rng(33), B, S, D))
    assert k1._check(k, v, slots, _random_wp(rng(34), D, H), S)[:4] == (B, N, D, H)


@pytest.mark.parametrize("B", [32, 128])
def test_fused_check_takes_the_phyre_shapes(B):
    """PHYRE SAVi's calls, (B, 4096, 128, 8, 256): 8 slots (the most the
    kernel's slot side holds) at the training and extraction batch (32) and
    the planning batch (128)."""
    N, D, S, H = 4096, 128, 8, 256
    assert S <= k1.S_PAD and k1.cluster_blocks(D, H) == 8
    k, v = torch.empty(B, N, D), torch.empty(B, N, D)  # shapes only
    slots = t(randn(rng(35), B, S, D))
    assert k1._check(k, v, slots, _random_wp(rng(36), D, H), S)[:4] == (B, N, D, H)


@pytest.mark.parametrize("case", ["d_not_multiple_of_4", "d_above_256",
                                  "misaligned_v"])
def test_update_check_raises_on_what_the_kernel_refuses(case):
    r = rng(31)
    D = dict(d_not_multiple_of_4=18, d_above_256=512).get(case, 16)
    k, v, q = t(randn(r, 1, 12, D)), t(randn(r, 1, 12, D)), t(randn(r, 1, 4, D))
    if case == "misaligned_v":
        v = t(randn(r, 12 * D + 1))[1:].reshape(1, 12, D)
    with pytest.raises(ValueError, match=r"shape|D="):
        k2._check_layout(k, v, q)
    # the CPU path, which launches nothing, takes any D
    k2.slot_attention_update(k, v, q)


# ------------------------------------------------------------- the build
def test_build_hash_covers_the_shared_header(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    assert (csrc / "slot_attention_sweep.cuh").is_file()
    before = build.source_digest()
    paths = {n: build._lib_path(n) for n in build.KERNEL_SOURCES}
    assert before == build.source_digest()
    with open(csrc / "slot_attention_sweep.cuh", "a") as f:
        f.write("// edited\n")
    assert build.source_digest() != before
    for n, p in paths.items():
        assert build._lib_path(n) != p, n


def test_kernel_sources_include_the_shared_sweep():
    for name in build.KERNEL_SOURCES:
        text = (build.CSRC / f"{name}.cu").read_text()
        assert '#include "slot_attention_sweep.cuh"' in text, name
        assert "sweep_chunk(" in text, name
    assert "-I" in build.NVCC_FLAGS and str(build.CSRC) in build.NVCC_FLAGS
