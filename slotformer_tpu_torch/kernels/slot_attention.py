"""Kernel K1: the whole slot-attention loop in one CUDA kernel.

Replaces ``slotformer_tpu/ops/slot_attention_kernel.py::fused_slot_attention``
(Pallas launcher ``_fused_forward``). For ``num_iterations`` rounds:

    q       = LN(h) @ wq * scale
    attn    = softmax over SLOTS of k @ q^T                 [B, N, S]
    upd     = (attn^T @ v + eps * sum_n v) / (sum_n attn + eps * N)
    h       = GRUCell(upd, h)    (flax gate layout, r/z biases folded)
    h       = h + MLP(LN(h))

and returns the slots [B, S, D] and the last round's attention [B, N, S].

``fused_slot_attention`` launches the kernel (``csrc/slot_attention.cu``)
for CUDA tensors and runs ``fused_slot_attention_plain`` for CPU tensors;
there is no other switch. Its gradient differentiates the plain version, as
the JAX ``custom_vjp`` differentiates ``fused_reference``.

``wp`` holds the weights in the JAX package's layout (``[in, out]``
matrices, the GRU as separate gates with ``b_ir``/``b_iz`` already holding
the hidden-side r/z biases): the keys of ``WP_KEYS``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

S_PAD = 8  # the kernel's slot capacity
LN_EPS = 1e-6
WP_KEYS = (
    "q_ln_scale", "q_ln_bias", "wq",
    "w_ir", "w_iz", "w_in", "w_hr", "w_hz", "w_hn",
    "b_ir", "b_iz", "b_in", "b_hn",
    "mlp_ln_scale", "mlp_ln_bias", "w1", "b1", "w2", "b2",
)
# [9, D] rows of the kernel's vector block, in the order csrc/slot_attention.cu
# reads them
_VEC_KEYS = ("q_ln_scale", "q_ln_bias", "b_ir", "b_iz", "b_in", "b_hn",
             "mlp_ln_scale", "mlp_ln_bias", "b2")

# Kernel launches since the last reset; incremented once per launch.
LAUNCHES = 0


def _layernorm(x, scale, bias):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + LN_EPS) * scale + bias


def fused_slot_attention_plain(k, v, slots, wp, num_iterations: int,
                               n_slots: int, scale: float, eps: float):
    """Plain PyTorch version of the kernel (same arguments and results);
    the twin of JAX ``fused_reference``."""
    del n_slots
    sumv = v.sum(1, keepdim=True)
    N = k.shape[1]
    attn = None
    h = slots
    for _ in range(num_iterations):
        q = _layernorm(h, wp["q_ln_scale"], wp["q_ln_bias"]) @ wp["wq"] * scale
        attn = torch.softmax(torch.einsum("bnd,bsd->bns", k, q), dim=-1)
        den = attn.sum(1)[..., None]
        num = torch.einsum("bns,bnd->bsd", attn, v)
        upd = (num + eps * sumv) / (den + eps * N)
        r = torch.sigmoid(upd @ wp["w_ir"] + wp["b_ir"] + h @ wp["w_hr"])
        z = torch.sigmoid(upd @ wp["w_iz"] + wp["b_iz"] + h @ wp["w_hz"])
        n = torch.tanh(upd @ wp["w_in"] + wp["b_in"]
                       + r * (h @ wp["w_hn"] + wp["b_hn"]))
        h = (1.0 - z) * n + z * h
        hm = _layernorm(h, wp["mlp_ln_scale"], wp["mlp_ln_bias"])
        h = h + torch.relu(hm @ wp["w1"] + wp["b1"]) @ wp["w2"] + wp["b2"]
    return h, attn


_P = ctypes.c_void_p
_ARGTYPES = [_P] * 12 + [ctypes.c_int] * 6 + [ctypes.c_float] * 2 + [_P]


def _library():
    from . import build

    lib = build.load("slot_attention")
    if lib.fused_slot_attention_f32.argtypes is None:
        lib.fused_slot_attention_f32.argtypes = _ARGTYPES
        lib.fused_slot_attention_f32.restype = ctypes.c_int
        lib.slot_attention_error_string.argtypes = [ctypes.c_int]
        lib.slot_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check(k, v, slots, wp: Dict[str, torch.Tensor], n_slots: int):
    if k.dim() != 3 or v.shape != k.shape:
        raise ValueError(f"k/v must both be [B, N, D]: {tuple(k.shape)} "
                         f"{tuple(v.shape)}")
    B, N, D = k.shape
    if slots.shape != (B, n_slots, D):
        raise ValueError(f"slots {tuple(slots.shape)} != {(B, n_slots, D)}")
    if not 1 <= n_slots <= S_PAD:
        raise ValueError(f"the kernel takes 1..{S_PAD} slots, got {n_slots}")
    if N < 1:
        raise ValueError("N must be positive")
    H = wp["w1"].shape[1]
    shapes = dict(wq=(D, D), w1=(D, H), b1=(H,), w2=(H, D))
    for name in WP_KEYS:
        want = shapes.get(name, (D, D) if name.startswith("w_") else (D,))
        if tuple(wp[name].shape) != want:
            raise ValueError(f"wp[{name!r}] is {tuple(wp[name].shape)}, "
                             f"expected {want}")
    for name, t in [("k", k), ("v", v), ("slots", slots)] + [
            (f"wp[{n!r}]", wp[n]) for n in WP_KEYS]:
        if t.dtype != torch.float32:
            raise TypeError(f"the kernel takes float32 only; {name} is "
                            f"{t.dtype}")
    for name, t in (("k", k), ("v", v), ("slots", slots)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return B, N, D, H


def _launch(k, v, slots, wp, num_iterations: int, n_slots: int, scale: float,
            eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    global LAUNCHES
    B, N, D, H = _check(k, v, slots, wp, n_slots)
    lib = _library()
    gru_i = torch.cat([wp["w_ir"], wp["w_iz"], wp["w_in"]], 1).contiguous()
    gru_h = torch.cat([wp["w_hr"], wp["w_hz"], wp["w_hn"]], 1).contiguous()
    vecs = torch.stack([wp[n] for n in _VEC_KEYS]).contiguous()
    wq, w1, b1, w2 = (wp[n].contiguous() for n in ("wq", "w1", "b1", "w2"))
    slots_out = torch.empty_like(slots)
    attn = torch.empty((B, N, n_slots), device=k.device, dtype=torch.float32)
    with torch.cuda.device(k.device):
        stream = torch.cuda.current_stream(k.device).cuda_stream
        err = lib.fused_slot_attention_f32(
            k.data_ptr(), v.data_ptr(), slots.data_ptr(), wq.data_ptr(),
            gru_i.data_ptr(), gru_h.data_ptr(), w1.data_ptr(), w2.data_ptr(),
            vecs.data_ptr(), b1.data_ptr(), slots_out.data_ptr(),
            attn.data_ptr(), B, N, D, n_slots, H, num_iterations,
            scale, eps, stream)
    if err != 0:
        msg = lib.slot_attention_error_string(err).decode()
        raise RuntimeError(f"fused_slot_attention launch failed: {msg} "
                           f"(B={B} N={N} D={D} S={n_slots} H={H})")
    LAUNCHES += 1
    return slots_out, attn


class _FusedSlotAttention(torch.autograd.Function):
    """Forward: the CUDA kernel. Backward: autograd of the plain version."""

    @staticmethod
    def forward(ctx, num_iterations, n_slots, scale, eps, k, v, slots, *w):
        ctx.save_for_backward(k, v, slots, *w)
        ctx.args = (num_iterations, n_slots, scale, eps)
        return _launch(k, v, slots, dict(zip(WP_KEYS, w)), num_iterations,
                       n_slots, scale, eps)

    @staticmethod
    def backward(ctx, g_slots, g_attn):
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
            k, v, slots, *w = inputs
            out = fused_slot_attention_plain(
                k, v, slots, dict(zip(WP_KEYS, w)), *ctx.args)
            grads = torch.autograd.grad(out, inputs, (g_slots, g_attn),
                                        allow_unused=True)
        return (None, None, None, None) + tuple(grads)


def fused_slot_attention(k, v, slots, wp, num_iterations: int = 2,
                         n_slots: int = 7, scale: float = 1.0,
                         eps: float = 1e-6):
    """All slot-attention rounds + GRU + MLP.

    k/v: [B, N, D] (input-LN'd and projected); slots: [B, S, D] init;
    wp: weights by ``WP_KEYS``. Returns (slots [B, S, D], last-round attn
    [B, N, S]). CPU tensors run the plain version; CUDA tensors launch the
    kernel, which takes float32, contiguous k/v/slots and S <= 8, and raises
    on anything else.
    """
    devices = {t.device for t in [k, v, slots] + [wp[n] for n in WP_KEYS]}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on several devices: {sorted(map(str, devices))}")
    if k.device.type == "cpu":
        return fused_slot_attention_plain(k, v, slots, wp, num_iterations,
                                          n_slots, scale, eps)
    if k.device.type != "cuda":
        raise ValueError(f"no kernel for device {k.device}")
    return _FusedSlotAttention.apply(num_iterations, n_slots, float(scale),
                                     float(eps), k, v, slots,
                                     *[wp[n] for n in WP_KEYS])
