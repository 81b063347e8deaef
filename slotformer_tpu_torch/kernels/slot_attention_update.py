"""Kernel K2: one slot-attention round in a CUDA kernel.

Replaces ``slotformer_tpu/ops/slot_attention_kernel.py::slot_attention_update``
(Pallas launcher ``_pallas_forward``). For k, v [B, N, D] and a pre-scaled
q [B, S, D]:

    attn = softmax over SLOTS of k @ q^T                           [B, N, S]
    upd  = ((attn + eps) / sum_n (attn + eps))^T @ v               [B, S, D]

computed in float32 and cast back to the input dtype, as the JAX function
does. ``slot_attention_update`` launches the kernel
(``csrc/slot_attention_update.cu``: a sweep over N split over the card,
shared with kernel K1 through ``csrc/slot_attention_sweep.cuh``, and a
finishing pass; two launches a call, counted as one in ``LAUNCHES``) for
CUDA tensors and runs
``slot_attention_update_plain`` for CPU tensors; its gradient differentiates
the plain version, as the JAX ``custom_vjp`` differentiates
``_jnp_reference``. No model calls it: like the JAX function, it is an entry
point of its own.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

S_PAD = 8  # the kernel's slot capacity
MAX_D = 256  # two stages of k and v tiles live in the kernel's shared memory

# Kernel launches since the last reset; incremented once per launch.
LAUNCHES = 0


def slot_attention_update_plain(k, v, q, eps: float = 1e-6):
    """Plain PyTorch version of the kernel (same arguments and results);
    the twin of JAX ``_jnp_reference``."""
    attn = torch.softmax(torch.einsum("bnd,bsd->bns", k, q), dim=-1)
    attn_w = attn + eps
    attn_w = attn_w / attn_w.sum(1, keepdim=True)
    return torch.einsum("bns,bnd->bsd", attn_w, v), attn


_P = ctypes.c_void_p


def _library():
    from . import build

    lib = build.load("slot_attention_update")
    if lib.slot_attention_update_f32.argtypes is None:
        lib.slot_attention_update_f32.argtypes = (
            [_P] * 6 + [ctypes.c_int] * 4 + [ctypes.c_float, _P])
        lib.slot_attention_update_f32.restype = ctypes.c_int
        lib.slot_attention_update_workspace_floats.argtypes = [ctypes.c_int] * 3
        lib.slot_attention_update_workspace_floats.restype = ctypes.c_longlong
        lib.slot_attention_update_error_string.argtypes = [ctypes.c_int]
        lib.slot_attention_update_error_string.restype = ctypes.c_char_p
    return lib


def _check_layout(k, v, q) -> None:
    """Raises on a D or an alignment the kernel's 16-byte copies do not take."""
    D = k.shape[2]
    if D % 4 or D > MAX_D:
        raise ValueError(f"the kernel takes D that is a multiple of 4 and "
                         f"<= {MAX_D}, got D={D} (k {tuple(k.shape)})")
    for name, t in (("k", k), ("v", v), ("q", q)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary "
                             f"(shape {tuple(t.shape)}, offset "
                             f"{t.storage_offset()})")


def _launch(k, v, q, eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """k, v, q: contiguous float32 CUDA tensors, checked by the caller."""
    global LAUNCHES
    B, N, D = k.shape
    S = q.shape[1]
    _check_layout(k, v, q)
    lib = _library()
    upd = k.new_empty((B, S, D))
    attn = k.new_empty((B, N, S))
    work = k.new_empty(lib.slot_attention_update_workspace_floats(B, N, D))
    with torch.cuda.device(k.device):
        stream = torch.cuda.current_stream(k.device).cuda_stream
        err = lib.slot_attention_update_f32(
            k.data_ptr(), v.data_ptr(), q.data_ptr(), upd.data_ptr(),
            attn.data_ptr(), work.data_ptr(), B, N, D, S, eps, stream)
    if err != 0:
        msg = lib.slot_attention_update_error_string(err).decode()
        raise RuntimeError(f"slot_attention_update launch failed: {msg} "
                           f"(B={B} N={N} D={D} S={S})")
    LAUNCHES += 1
    return upd, attn


class _SlotAttentionUpdate(torch.autograd.Function):
    """Forward: the CUDA kernel. Backward: autograd of the plain version."""

    @staticmethod
    def forward(ctx, eps, k, v, q):
        ctx.save_for_backward(k, v, q)
        ctx.eps = eps
        return _launch(k, v, q, eps)

    @staticmethod
    def backward(ctx, g_upd, g_attn):
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
            out = slot_attention_update_plain(*inputs, ctx.eps)
            grads = torch.autograd.grad(out, inputs, (g_upd, g_attn))
        return (None,) + tuple(grads)


def slot_attention_update(k, v, q, eps: float = 1e-6):
    """(updates [B, S, D], attn [B, N, S]) of one slot-attention round.

    k/v: [B, N, D] projected inputs; q: [B, S, D] already scaled by
    D**-0.5; S <= 8. Computed in float32, returned in k's dtype. CPU tensors
    run the plain version; CUDA tensors launch the kernel, which takes D that
    is a multiple of 4 and <= 256, and anything else raises.
    """
    if k.dim() != 3 or v.shape != k.shape:
        raise ValueError(f"k/v must both be [B, N, D]: {tuple(k.shape)} "
                         f"{tuple(v.shape)}")
    B, N, D = k.shape
    if q.dim() != 3 or q.shape[0] != B or q.shape[2] != D:
        raise ValueError(f"q {tuple(q.shape)} must be [{B}, S, {D}]")
    if not 1 <= q.shape[1] <= S_PAD:
        raise ValueError(f"the kernel takes 1..{S_PAD} slots, got {q.shape[1]}")
    if N < 1:
        raise ValueError("N must be positive")
    devices = {t.device for t in (k, v, q)}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on several devices: {sorted(map(str, devices))}")
    dtype = k.dtype
    k, v, q = (t.float().contiguous() for t in (k, v, q))
    if k.device.type == "cpu":
        upd, attn = slot_attention_update_plain(k, v, q, eps)
    elif k.device.type == "cuda":
        if torch.is_grad_enabled() and (k.requires_grad or v.requires_grad
                                        or q.requires_grad):
            upd, attn = _SlotAttentionUpdate.apply(float(eps), k, v, q)
        else:  # nothing to differentiate: no autograd bookkeeping
            upd, attn = _launch(k, v, q, float(eps))
    else:
        raise ValueError(f"no kernel for device {k.device}")
    return upd.to(dtype), attn.to(dtype)
