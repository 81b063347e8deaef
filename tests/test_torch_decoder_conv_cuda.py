"""Kernel K3 (``kernels/decoder_conv.py``) on the card: its forward and its
input gradient against float64, at the rollout call's shape (2352 images of
64 channels at 64x64), at PHYRE's 128x128 and at a ragged shape; its launch
count in a decoder's forward; its parameter gradients against autograd of
the layer's two modules.

Marked ``cuda`` and skipped without a card. Imports no JAX:

    python -m pytest tests/test_torch_decoder_conv_cuda.py --noconftest -q

Tolerance: K3's largest absolute error against float64 may be at most twice
cuDNN's float32 convolution's (TF32 off) on the same inputs: float32
accuracy, where one TF32 product would be ~1000x worse.
"""

import pytest
import torch

from slotformer_tpu_torch.kernels import decoder_conv as k3
from slotformer_tpu_torch.models.savi import SpatialBroadcastDecoder


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(N, H, W, device, seed):
    """Activations in channels-last memory, as the decoder's layers hand them
    on."""
    g = torch.Generator(device=device).manual_seed(seed)
    cl = torch.channels_last
    x = torch.relu(torch.randn(N, 64, H, W, device=device, generator=g)).contiguous(
        memory_format=cl)
    w = torch.randn(64, 64, 5, 5, device=device, generator=g) * 1600 ** -0.5
    b = 0.1 * torch.randn(64, device=device, generator=g)
    gy = torch.randn(N, 64, H, W, device=device, generator=g).contiguous(memory_format=cl)
    return x, w, b, gy


def _max_err(got, want):
    return (got.double() - want).abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("N,H,W", [(2352, 64, 64), (256, 128, 128), (3, 7, 21)],
                         ids=["rollout", "phyre", "ragged"])
def test_forward_and_input_grad_hold_float32_accuracy(cuda, N, H, W):
    x, w, b, gy = _inputs(N, H, W, cuda, seed=N)
    y = k3.decoder_conv_s1(x, w, b)
    want = k3.decoder_conv_plain(x.double(), w.double(), b.double())
    err = _max_err(y, want)
    err_cudnn = _max_err(k3.decoder_conv_plain(x, w, b), want)
    del want
    dx = k3.input_grad(gy, y, w)
    want = k3.input_grad_plain(gy.double(), y.double(), w.double())
    gerr = _max_err(dx, want)
    gerr_cudnn = _max_err(k3.input_grad_plain(gy, y, w), want)
    assert err <= 2 * err_cudnn, (err, err_cudnn)
    assert gerr <= 2 * gerr_cudnn, (gerr, gerr_cudnn)


@pytest.mark.cuda
def test_one_launch_per_stride1_layer_in_a_decoder_forward(cuda):
    torch.manual_seed(0)
    dec = SpatialBroadcastDecoder((64, 64), 128).to(cuda)
    slots = torch.randn(4, 7, 128, device=cuda)
    before = k3.LAUNCHES
    with torch.no_grad():
        got = dec(slots)[0]
    assert k3.LAUNCHES == before + 1
    want = dec.double()(slots.double())[0]
    dec.float()
    assert _max_err(got, want) < 1e-5
    # with gradients: one forward and one input-gradient launch
    slots.requires_grad_(True)
    before = k3.LAUNCHES
    dec(slots)[0].square().sum().backward()
    assert k3.LAUNCHES == before + 2


@pytest.mark.cuda
def test_parameter_gradients_match_autograd_of_the_layer(cuda):
    x, w, b, gy = _inputs(16, 64, 64, cuda, seed=5)
    leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
    got = torch.autograd.grad(k3.decoder_conv_s1(*leaves), leaves, gy)
    ref = [t.double().requires_grad_(True) for t in (x, w, b)]
    want = torch.autograd.grad(k3.decoder_conv_plain(*ref), ref, gy.double())
    cudnn = torch.autograd.grad(k3.decoder_conv_plain(*leaves), leaves, gy)
    for name, a, c, e in zip(("x", "weight", "bias"), got, cudnn, want):
        assert _max_err(a, e) <= 2 * _max_err(c, e) + 1e-12, name


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["float64", "channels", "kernel3",
                                  "channels_first"])
def test_wrapper_raises_on_what_the_kernel_refuses(cuda, case):
    x, w, b, _ = _inputs(2, 8, 8, cuda, seed=6)
    if case == "float64":
        x, w, b = x.double(), w.double(), b.double()
    elif case == "channels":
        x = x[:, :32].contiguous(memory_format=torch.channels_last)
    elif case == "kernel3":
        w = w[..., 1:4, 1:4].contiguous()
    else:
        x = x.contiguous()
    with pytest.raises((TypeError, ValueError)):
        k3.decoder_conv_s1(x, w, b)


def _decoder_peak_bytes(dec, slots, gt, route_k3):
    """Peak allocated bytes of one forward, squared-error loss and backward
    of ``dec``, with its stride-1 layer on K3 or on its two modules."""
    from slotformer_tpu_torch.models import nn as port_nn

    takes = port_nn.DeconvNormAct.takes_decoder_conv
    if not route_k3:
        port_nn.DeconvNormAct.takes_decoder_conv = lambda self, x: False
    try:
        slots = slots.detach().requires_grad_(True)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        before = k3.LAUNCHES
        ((dec(slots)[0] - gt) ** 2).mean().backward()
        torch.cuda.synchronize()
        assert (k3.LAUNCHES - before) == (2 if route_k3 else 0)
        return torch.cuda.max_memory_allocated() - base
    finally:
        port_nn.DeconvNormAct.takes_decoder_conv = takes


@pytest.mark.cuda
@pytest.mark.parametrize("trainable", [False, True], ids=["frozen", "trainable"])
def test_decoder_backward_peak_is_no_higher_than_the_modules(cuda, trainable):
    # the StoSAVi training step's decode: 64 clips x 6 frames x 7 slots
    torch.manual_seed(0)
    dec = SpatialBroadcastDecoder((64, 64), 128).to(cuda).requires_grad_(trainable)
    slots = torch.randn(64 * 6, 7, 128, device=cuda)
    gt = torch.rand(64 * 6, 64, 64, 3, device=cuda)
    modules = _decoder_peak_bytes(dec, slots, gt, route_k3=False)
    kernel = _decoder_peak_bytes(dec, slots, gt, route_k3=True)
    assert kernel <= modules, (kernel / 2 ** 30, modules / 2 ** 30)
