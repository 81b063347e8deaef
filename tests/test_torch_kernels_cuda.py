"""Kernels K1 and K2 on the card: each CUDA kernel against its plain version.

Marked ``cuda`` and skipped without a card. Imports no JAX, so it also runs
where JAX is not installed:

    python -m pytest tests/test_torch_kernels_cuda.py --noconftest -q

Tolerances. K1: 1e-4 abs on the slots and 1e-5 abs on the attention. Both
sides are float32 (TF32 off) but sum in different orders; the attention is a
softmax in [0, 1] and the slots are O(1) after two GRU/MLP rounds. K2: 1e-5
abs on the attention and 1e-4 on the updates (tests/test_pallas_ops.py's
tolerances; the updates are weighted means of O(1) values over N pixels).
"""

import importlib

import pytest
import torch

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
                                       (2, 777, 64, 8, 96)])
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
