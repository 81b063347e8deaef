"""Kernel K3: the SAVi decoder's 5x5 stride-1 transposed convolution with its
bias and ReLU, 64 -> 64 channels, float32 on the tensor cores.

    y = relu(conv_transpose2d(x, weight, bias, stride 1, padding 2))

It replaces no TPU kernel (the JAX package leaves the layer to XLA). It
exists because this layer holds ~74% of the spatial-broadcast decoder's
multiply-adds and the decoder sets the pace of SlotFormer training, StoSAVi
training and the test_vp rollout; cuDNN runs it in float32 on the SIMT units.

``csrc/decoder_conv.cu`` computes it as an implicit GEMM on warpgroup
TF32 products (wgmma): each float32 operand is split into a TF32 high part
and a TF32 low part (``split_tf32``), and each product is the sum of three
TF32 products (lo*hi + hi*lo + hi*hi) in float32, which keeps float32's
accuracy. One template serves the forward and the input gradient (a
convolution with the weight unflipped, the ReLU's mask applied as the
gradient is loaded).

What bounds it on an H100: operations. The rollout call's 2352 images of
64x64 are 1.973 TFLOP of float32 work in this layer: three TF32 products
each at the 495 TFLOP/s dense TF32 rate give a floor of 12.0 ms, against
1.4 ms for its 4.7 GB of input and output at 3.35 TB/s. The kernel loads each
tile's input halo into shared memory once for all 25 taps and streams the
pre-split weights through shared memory a tap at a time, so device memory
stays out of the way (see the source).

``decoder_conv_s1`` launches the kernel for CUDA tensors (float32, [N, 64,
H, W] in channels-last memory, as the decoder's layers hand each other their
activations from the position embedding on) and raises on anything else; CPU
tensors run ``decoder_conv_plain``. Its gradient is
``DecoderConvS1``: the input gradient from the kernel, the weight and bias
gradients from ``aten.convolution_backward`` (cuDNN's), where wanted.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

CHANNELS = 64  # the kernel's input and output channels
KERNEL_SIZE = 5
PADDING = KERNEL_SIZE // 2

# Kernel launches since the last reset (forward and input gradient alike).
LAUNCHES = 0


def split_tf32(v: torch.Tensor):
    """(hi, lo) of float32 ``v``: hi is ``v`` rounded to TF32 (10 mantissa
    bits, to nearest, ties away from zero) and lo is ``v - hi`` rounded the
    same way, so the low 13 bits of each are zero and
    ``|v - (hi + lo)| <= 2**-22 * |v|``. The kernel splits its activations
    with the same bit operations."""

    def rnd(x):
        return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(
            torch.float32)

    hi = rnd(v)
    return hi, rnd(v - hi)


def conv_weight(weight: torch.Tensor, input_grad: bool) -> torch.Tensor:
    """The conv2d weight [out, in, 5, 5] the kernel applies: the transposed
    convolution's weight [in, out, 5, 5] flipped with its axes swapped for the
    forward, and as it is for the input gradient."""
    return weight if input_grad else weight.transpose(0, 1).flip(2, 3)


def pack_weight(wk: torch.Tensor) -> torch.Tensor:
    """The conv2d weight ``wk`` [64, 64, 5, 5] split and laid out as the
    kernel's warpgroup products read it from shared memory: [25 taps, 8
    chunks of 8 input channels, hi or lo, 8 groups of 8 output channels, 2
    halves of the chunk, 8 output channels, 4 input channels], so that each
    (tap, chunk, hi or lo) slab is a K-major 64 x 8 operand of 8 x 4 core
    matrices of 128 bytes: output channel 8 * group + o, input channel
    8 * chunk + 4 * half + i."""
    C = CHANNELS
    w = wk.detach().float().permute(2, 3, 0, 1)  # [ky, kx, co, ci]
    w = w.reshape(KERNEL_SIZE ** 2, C // 8, 8, C // 8, 2, 4)  # [tap, grp, o, chunk, half, i]
    w = w.permute(0, 3, 1, 4, 2, 5)  # [tap, chunk, grp, half, o, i]
    hi, lo = split_tf32(w)
    return torch.stack([hi, lo], 2).contiguous()


def decoder_conv_plain(x: torch.Tensor, weight: torch.Tensor,
                       bias: Optional[torch.Tensor]) -> torch.Tensor:
    """Plain PyTorch version of the kernel's forward."""
    return torch.relu(F.conv_transpose2d(x, weight, bias, padding=PADDING))


def input_grad_plain(g: torch.Tensor, y: torch.Tensor,
                     weight: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel's input gradient: d loss / d x of
    ``decoder_conv_plain`` given its output ``y`` and d loss / d y ``g``."""
    return F.conv2d(g * (y > 0), weight, padding=PADDING)


def _check(name: str, t: torch.Tensor, shape=None,
           memory_format=torch.contiguous_format) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} lies on {t.device}; the kernel takes CUDA tensors")
    if t.dtype != torch.float32:
        raise TypeError(f"the kernel takes float32 only; {name} is {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} is {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous(memory_format=memory_format) or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous ({memory_format}) and start "
                         f"on a 16-byte boundary (shape {tuple(t.shape)}, strides "
                         f"{t.stride()}, offset {t.storage_offset()})")


def _check_input(x: torch.Tensor, weight: torch.Tensor,
                 bias: Optional[torch.Tensor]) -> None:
    """Raises on what the kernel does not take."""
    C = CHANNELS
    if x.dim() != 4 or x.shape[1] != C or 0 in x.shape:
        raise ValueError(f"x must be [N, {C}, H, W] and not empty, got "
                         f"{tuple(x.shape)}")
    _check("x", x, memory_format=torch.channels_last)
    _check("weight", weight, (C, C, KERNEL_SIZE, KERNEL_SIZE))
    if bias is not None:
        _check("bias", bias, (C,))
    devices = {t.device for t in (x, weight, bias) if t is not None}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on several devices: {sorted(map(str, devices))}")


def _library():
    from . import build

    lib = build.load("decoder_conv")
    if lib.decoder_conv_s1_forward_f32.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.decoder_conv_s1_forward_f32.argtypes = [P] * 4 + [I] * 3 + [P]
        lib.decoder_conv_s1_forward_f32.restype = I
        lib.decoder_conv_s1_input_grad_f32.argtypes = [P] * 4 + [I] * 3 + [P]
        lib.decoder_conv_s1_input_grad_f32.restype = I
        lib.decoder_conv_s1_error_string.argtypes = [I]
        lib.decoder_conv_s1_error_string.restype = ctypes.c_char_p
    return lib


def _launch(inp, relu_out, wpack, bias) -> torch.Tensor:
    """One launch on ``inp``, into a new channels-last tensor: the forward
    where ``relu_out`` is None, else the input gradient masked by
    ``relu_out``."""
    global LAUNCHES
    lib = _library()
    out = torch.empty_like(inp, memory_format=torch.channels_last)
    N, _, H, W = inp.shape
    with torch.cuda.device(inp.device):
        stream = torch.cuda.current_stream(inp.device).cuda_stream
        if relu_out is None:
            what = "forward"
            err = lib.decoder_conv_s1_forward_f32(
                inp.data_ptr(), wpack.data_ptr(), bias.data_ptr(),
                out.data_ptr(), N, H, W, stream)
        else:
            what = "input gradient"
            err = lib.decoder_conv_s1_input_grad_f32(
                inp.data_ptr(), relu_out.data_ptr(), wpack.data_ptr(),
                out.data_ptr(), N, H, W, stream)
    if err != 0:
        raise RuntimeError(f"decoder_conv_s1 {what} launch failed: "
                           f"{lib.decoder_conv_s1_error_string(err).decode()} "
                           f"(shape {tuple(inp.shape)})")
    LAUNCHES += 1
    return out


def _forward(x, weight, bias):
    if x.device.type == "cpu":
        return decoder_conv_plain(x, weight, bias)
    _check_input(x, weight, bias)
    return _launch(x, None, pack_weight(conv_weight(weight, input_grad=False)),
                   x.new_zeros(CHANNELS) if bias is None else bias)


def input_grad(g, y, weight):
    """d loss / d x of ``decoder_conv_s1`` from its output ``y`` and
    d loss / d y ``g``: the kernel for CUDA tensors, ``input_grad_plain``
    for CPU ones."""
    if g.device.type == "cpu":
        return input_grad_plain(g, y, weight)
    g = g.contiguous(memory_format=torch.channels_last)
    _check_input(g, weight, None)
    _check("y", y, g.shape, torch.channels_last)
    return _launch(g, y, pack_weight(conv_weight(weight, input_grad=True)), None)


# The largest ReLU gradient, in bytes, that the weight gradient takes at once
# (``DecoderConvS1.backward``).
WGRAD_SLICE_BYTES = 1 << 28


class DecoderConvS1(torch.autograd.Function):
    """``decoder_conv_s1`` with its gradient. The forward keeps its output
    (the ReLU's mask) and, only where the weight or the bias wants a
    gradient, its input. The backward takes the weight and bias gradients
    from ``aten.convolution_backward`` (cuDNN's, as autograd of
    ``ConvTranspose2d`` takes them) and the input gradient from the kernel
    (on the CPU ``input_grad_plain``), which masks by the ReLU as it loads.

    Autograd of the two modules frees the layer's output and its incoming
    gradient once the ReLU's gradient is taken, before cuDNN's weight
    gradient with its workspace; here both stay live to the end. So the
    weight gradient takes the ReLU's gradient a slice of the batch at a time
    (``WGRAD_SLICE_BYTES``), summing the slices' weight and bias gradients,
    and the peak stays that of the two modules."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        y = _forward(x, weight, bias)
        params = ctx.needs_input_grad[1] or ctx.needs_input_grad[2]
        ctx.save_for_backward(y, weight, x if params else None)
        ctx.has_bias = bias is not None
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gy):
        y, weight, x = ctx.saved_tensors
        dx = dw = db = None
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            N = y.shape[0]
            parts = min(N, -(-y.numel() * y.element_size() // WGRAD_SLICE_BYTES))
            for i in range(parts):
                a, b = N * i // parts, N * (i + 1) // parts
                gz = torch.ops.aten.threshold_backward(gy[a:b], y[a:b], 0)
                _, dw_i, db_i = torch.ops.aten.convolution_backward(
                    gz, x[a:b], weight, [weight.shape[1]] if ctx.has_bias else None,
                    [1, 1], [PADDING, PADDING], [1, 1], True, [0, 0], 1,
                    [False, ctx.needs_input_grad[1], ctx.needs_input_grad[2]])
                del gz
                if dw_i is not None:
                    dw = dw_i if dw is None else dw + dw_i
                if db_i is not None:
                    db = db_i if db is None else db + db_i
        if ctx.needs_input_grad[0]:
            dx = input_grad(gy, y, weight)
        return dx, dw, db


def decoder_conv_s1(x: torch.Tensor, weight: torch.Tensor,
                    bias: Optional[torch.Tensor]) -> torch.Tensor:
    """relu(conv_transpose2d(x, weight, bias, stride 1, padding 2)).

    x: [N, 64, H, W]; weight: the transposed convolution's [64, 64, 5, 5];
    bias: [64] or None. CPU tensors run ``decoder_conv_plain``; CUDA tensors
    launch the kernel, which takes float32, 16-byte-aligned tensors, x in
    channels-last memory and the weight and bias contiguous, raises on
    anything else, and returns y in channels-last memory."""
    return DecoderConvS1.apply(x, weight, bias)
