"""Kernel K1: the whole slot-attention loop as one call of CUDA kernels.

Replaces ``slotformer_tpu/ops/slot_attention_kernel.py::fused_slot_attention``
(Pallas launcher ``_fused_forward``). For ``num_iterations`` rounds:

    q       = LN(h) @ wq * scale
    attn    = softmax over SLOTS of k @ q^T                 [B, N, S]
    upd     = (attn^T @ v + eps * sum_n v) / (sum_n attn + eps * N)
    h       = GRUCell(upd, h)    (flax gate layout, r/z biases folded)
    h       = h + MLP(LN(h))

and returns the slots [B, S, D] and the last round's attention [B, N, S].

``fused_slot_attention`` launches the kernels (``csrc/slot_attention.cu``:
per round one sweep over N split over the card, shared with kernel K2 through
``csrc/slot_attention_sweep.cuh``, and one slot-side kernel; five launches a
call at two iterations, counted as one in ``LAUNCHES``) for CUDA tensors and
runs ``fused_slot_attention_plain`` for CPU tensors; there is no other
switch. Its gradient differentiates the plain version, as the JAX
``custom_vjp`` differentiates ``fused_reference``.

``wp`` holds the weights either in the JAX package's layout (``[in, out]``
matrices, the GRU as separate gates with ``b_ir``/``b_iz`` already holding
the hidden-side r/z biases: the keys of ``WP_KEYS``) or packed into the
kernel's buffers by ``pack_weights`` (the keys of ``PACKED_KEYS``). A caller
that runs many calls on the same weights, as ``StoSAVi.encode`` does over
the frames of a clip, packs once.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from ..trace import span

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
# The kernel's buffers: gru_i/gru_h [D, 3D] with the r, z, n gates of one
# feature side by side (column 3 * d + gate), vecs [9, D] (_VEC_KEYS), wq
# [D, D], w1 [D, H], b1 [H], w2 [H, D]; contiguous float32.
PACKED_KEYS = ("gru_i", "gru_h", "vecs", "wq", "w1", "b1", "w2")
MAX_D = 256  # two stages of k and v tiles live in the kernel's shared memory
# columns of a slot-side product one block takes: a float4 of them per thread
MAX_COLS_PER_BLOCK = 1024

# Kernel launches since the last reset; incremented once per launch.
LAUNCHES = 0


def _layernorm(x, scale, bias):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + LN_EPS) * scale + bias


class PackedWeights(dict):
    """The kernel's buffers by ``PACKED_KEYS``, as ``pack_weights`` returns
    them: shapes, dtype, contiguity and alignment already checked, so a call
    that gets one does not check them again."""


def _check_packed(packed: Dict[str, torch.Tensor]) -> None:
    D = packed["wq"].shape[0]
    H = packed["w1"].shape[-1]
    shapes = dict(gru_i=(D, 3 * D), gru_h=(D, 3 * D), vecs=(len(_VEC_KEYS), D),
                  wq=(D, D), w1=(D, H), b1=(H,), w2=(H, D))
    for name in PACKED_KEYS:
        t = packed[name]
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"packed[{name!r}] is {tuple(t.shape)}, "
                             f"expected {shapes[name]}")
        if t.dtype != torch.float32:
            raise TypeError(f"the kernel takes float32 only; packed[{name!r}] "
                            f"is {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"packed[{name!r}] must be contiguous and start "
                             f"on a 16-byte boundary (shape {tuple(t.shape)}, "
                             f"offset {t.storage_offset()})")


def pack_weights(wp: Dict[str, torch.Tensor]) -> PackedWeights:
    """The ``WP_KEYS`` weights as the kernel's buffers (``PACKED_KEYS``),
    checked. Differentiable: gradients of the packed buffers reach the
    entries of ``wp``. A ``PackedWeights`` is returned as it is; a plain
    dictionary of ``PACKED_KEYS`` is checked and wrapped."""
    if isinstance(wp, PackedWeights):
        return wp
    if not is_packed(wp):
        D = wp["wq"].shape[0]
        H = wp["w1"].shape[-1]
        shapes = dict(wq=(D, D), w1=(D, H), b1=(H,), w2=(H, D))
        for name in WP_KEYS:
            want = shapes.get(name, (D, D) if name.startswith("w_") else (D,))
            if tuple(wp[name].shape) != want:
                raise ValueError(f"wp[{name!r}] is {tuple(wp[name].shape)}, "
                                 f"expected {want}")
        wp = dict(
            gru_i=torch.stack([wp["w_ir"], wp["w_iz"], wp["w_in"]], 2).reshape(D, 3 * D),
            gru_h=torch.stack([wp["w_hr"], wp["w_hz"], wp["w_hn"]], 2).reshape(D, 3 * D),
            vecs=torch.stack([wp[n] for n in _VEC_KEYS]),
            **{n: wp[n].contiguous() for n in ("wq", "w1", "b1", "w2")})
    _check_packed(wp)
    return PackedWeights(wp)


def unpack_weights(packed: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The inverse of ``pack_weights``: ``WP_KEYS`` views of the packed
    buffers. An unpacked dictionary is returned as it is."""
    if not is_packed(packed):
        return packed
    D = packed["wq"].shape[0]
    wp = {n: packed[n] for n in ("wq", "w1", "b1", "w2")}
    for side, buf in (("i", packed["gru_i"]), ("h", packed["gru_h"])):
        gates = buf.reshape(D, D, 3)
        for g, gate in enumerate("rzn"):
            wp[f"w_{side}{gate}"] = gates[:, :, g]
    wp.update(zip(_VEC_KEYS, packed["vecs"]))
    return wp


def is_packed(wp: Dict[str, torch.Tensor]) -> bool:
    return "gru_i" in wp


def fused_slot_attention_plain(k, v, slots, wp, num_iterations: int,
                               n_slots: int, scale: float, eps: float):
    """Plain PyTorch version of the kernel (same arguments and results);
    the twin of JAX ``fused_reference``."""
    del n_slots
    wp = unpack_weights(wp)
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
_ARGTYPES = [_P] * 13 + [ctypes.c_int] * 6 + [ctypes.c_float] * 2 + [_P]


def _library():
    from . import build

    lib = build.load("slot_attention")
    if lib.fused_slot_attention_f32.argtypes is None:
        lib.fused_slot_attention_f32.argtypes = _ARGTYPES
        lib.fused_slot_attention_f32.restype = ctypes.c_int
        lib.fused_slot_attention_workspace_floats.argtypes = [ctypes.c_int] * 4
        lib.fused_slot_attention_workspace_floats.restype = ctypes.c_longlong
        lib.slot_attention_error_string.argtypes = [ctypes.c_int]
        lib.slot_attention_error_string.restype = ctypes.c_char_p
    return lib


def cluster_blocks(D: int, H: int) -> int:
    """Blocks of the slot-side kernel's cluster, each taking 1 / this of every
    product's columns: the largest power of two up to 8 that cuts D and H
    into whole float4s (``cluster_size`` in csrc/slot_attention.cu)."""
    for blocks in (8, 4, 2):
        if D % (4 * blocks) == 0 and H % (4 * blocks) == 0:
            return blocks
    return 1


def _check(k, v, slots, wp: Dict[str, torch.Tensor], n_slots: int):
    """Raises on what the kernel does not take; returns (B, N, D, H, packed
    weights)."""
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
    packed = pack_weights(wp)
    H = packed["w1"].shape[1]
    if packed["wq"].shape[0] != D:
        raise ValueError(f"the weights are for D={packed['wq'].shape[0]}, "
                         f"k is {tuple(k.shape)}")
    if D % 4 or D > MAX_D or H % 4 or D < 4 or H < 4:
        raise ValueError(f"the kernel takes D and H that are multiples of 4 "
                         f"and D <= {MAX_D}, got D={D} H={H}")
    blocks = cluster_blocks(D, H)
    if H // blocks > MAX_COLS_PER_BLOCK:
        raise ValueError(f"the kernel takes at most {MAX_COLS_PER_BLOCK} "
                         f"columns of H per block of its cluster, got "
                         f"{H // blocks} (D={D} H={H}, {blocks} blocks)")
    for name, t in (("k", k), ("v", v), ("slots", slots)):
        if t.dtype != torch.float32:
            raise TypeError(f"the kernel takes float32 only; {name} is "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary "
                             f"(shape {tuple(t.shape)}, offset "
                             f"{t.storage_offset()})")
    return B, N, D, H, packed


def _launch(k, v, slots, wp, num_iterations: int, n_slots: int, scale: float,
            eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    global LAUNCHES
    B, N, D, H, w = _check(k, v, slots, wp, n_slots)
    lib = _library()
    slots_out = k.new_empty((B, n_slots, D))
    attn = k.new_empty((B, N, n_slots))
    work = k.new_empty(
        lib.fused_slot_attention_workspace_floats(B, N, D, n_slots))
    with torch.cuda.device(k.device):
        stream = torch.cuda.current_stream(k.device).cuda_stream
        err = lib.fused_slot_attention_f32(
            k.data_ptr(), v.data_ptr(), slots.data_ptr(), w["wq"].data_ptr(),
            w["gru_i"].data_ptr(), w["gru_h"].data_ptr(), w["w1"].data_ptr(),
            w["w2"].data_ptr(), w["vecs"].data_ptr(), w["b1"].data_ptr(),
            slots_out.data_ptr(), attn.data_ptr(), work.data_ptr(), B, N, D,
            n_slots, H, num_iterations, scale, eps, stream)
    if err != 0:
        msg = lib.slot_attention_error_string(err).decode()
        raise RuntimeError(f"fused_slot_attention launch failed: {msg} "
                           f"(B={B} N={N} D={D} S={n_slots} H={H})")
    LAUNCHES += 1
    return slots_out, attn


class _FusedSlotAttention(torch.autograd.Function):
    """Forward: the CUDA kernels, on packed weights (``PACKED_KEYS`` order).
    Backward: autograd of the plain version; the gradients of the packed
    buffers flow on through ``pack_weights`` to the caller's weights."""

    @staticmethod
    def forward(ctx, num_iterations, n_slots, scale, eps, k, v, slots, *w):
        ctx.save_for_backward(k, v, slots, *w)
        ctx.args = (num_iterations, n_slots, scale, eps)
        return _launch(k, v, slots, dict(zip(PACKED_KEYS, w)), num_iterations,
                       n_slots, scale, eps)

    @staticmethod
    def backward(ctx, g_slots, g_attn):
        with span("k1.backward"), torch.enable_grad():
            inputs = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
            k, v, slots, *w = inputs
            out = fused_slot_attention_plain(
                k, v, slots, dict(zip(PACKED_KEYS, w)), *ctx.args)
            grads = torch.autograd.grad(out, inputs, (g_slots, g_attn),
                                        allow_unused=True)
        return (None, None, None, None) + tuple(grads)


def fused_slot_attention(k, v, slots, wp, num_iterations: int = 2,
                         n_slots: int = 7, scale: float = 1.0,
                         eps: float = 1e-6):
    """All slot-attention rounds + GRU + MLP.

    k/v: [B, N, D] (input-LN'd and projected); slots: [B, S, D] init;
    wp: weights by ``WP_KEYS`` (packed on the spot) or already packed by
    ``pack_weights``. Returns (slots [B, S, D], last-round attn [B, N, S]).
    CPU tensors run the plain version; CUDA tensors launch the kernel, which
    takes float32, contiguous, 16-byte-aligned k/v/slots, S <= 8, D and H
    multiples of 4, D <= 256 and H <= 1024 per block of its cluster, and
    raises on anything else.
    """
    devices = {t.device for t in [k, v, slots, *wp.values()]}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on several devices: {sorted(map(str, devices))}")
    if k.device.type == "cpu":
        return fused_slot_attention_plain(k, v, slots, wp, num_iterations,
                                          n_slots, scale, eps)
    if k.device.type != "cuda":
        raise ValueError(f"no kernel for device {k.device}")
    packed = pack_weights(wp)
    weights = [packed[n] for n in PACKED_KEYS]
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (k, v, slots, *weights)):
        return _FusedSlotAttention.apply(num_iterations, n_slots, float(scale),
                                         float(eps), k, v, slots, *weights)
    # nothing to differentiate: the kernel without the autograd bookkeeping
    return _launch(k, v, slots, packed, num_iterations, n_slots, float(scale),
                   float(eps))
