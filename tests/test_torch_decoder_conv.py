"""Kernel K3 (``kernels/decoder_conv.py``) on the CPU: the route that
``DeconvNormAct`` takes to it, its ``autograd.Function`` on the plain path,
the TF32 split and its packed weight, and the arithmetic of three TF32
products. The kernel itself runs only on a card
(``tests/test_torch_decoder_conv_cuda.py``).

Tolerances: float64 comparisons of the same convolution computed two ways
hold to 1e-10; the arithmetic test compares root-mean-square errors against
float64 (see there).
"""

from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import slotformer_tpu_torch
from slotformer_tpu_torch.kernels import decoder_conv as k3
from slotformer_tpu_torch.models.nn import DeconvNormAct
from slotformer_tpu_torch.models.savi import SpatialBroadcastDecoder
from slotformer_tpu_torch.runtime.params import load_params

CONFIGS = Path(slotformer_tpu_torch.__file__).parent / "configs"
# the shipped configs whose SAVi decoders have a stride-1 layer: CLEVRER and
# OBJ3D at 64x64, PHYRE at 128x128
DECODER_CONFIGS = ("stosavi_clevrer_params", "savi_obj3d_params",
                   "savi_phyre_params-fold0")


def _decoder(name: str) -> SpatialBroadcastDecoder:
    p = load_params(str(CONFIGS / f"{name}.py"))
    return SpatialBroadcastDecoder(tuple(p.resolution), p.slot_dict["slot_size"],
                                   p.dec_dict)


def _card_input(dtype=torch.float32):
    """What the route reads of an input, as a CUDA tensor would give it."""
    return SimpleNamespace(device=torch.device("cuda"), dtype=dtype)


def _deconvs(dec: SpatialBroadcastDecoder):
    return [m for m in dec.decoder if isinstance(m, DeconvNormAct)]


@pytest.mark.parametrize("name", DECODER_CONFIGS)
def test_route_takes_only_the_stride1_layer(name):
    layers = _deconvs(_decoder(name))
    taken = [layer.takes_decoder_conv(_card_input()) for layer in layers]
    strides = [layer[0].stride for layer in layers]
    assert taken == [s == (1, 1) for s in strides]
    assert taken.count(True) == 1 and taken[-1]


@pytest.mark.parametrize("case", ["float64", "bfloat16", "autocast", "cpu"])
def test_route_refuses_other_inputs(case, monkeypatch):
    layer = _deconvs(_decoder("stosavi_clevrer_params"))[-1]
    assert layer.takes_decoder_conv(_card_input())
    if case == "cpu":
        x = torch.zeros(1, 64, 8, 8)
    elif case == "autocast":
        # CUDA autocast cannot be entered without a card; the route asks
        # torch whether it is on
        monkeypatch.setattr(torch, "is_autocast_enabled",
                            lambda device_type=None: device_type == "cuda")
        x = _card_input()
    else:
        x = _card_input(getattr(torch, case))
    assert not layer.takes_decoder_conv(x)


@pytest.mark.parametrize("layer", [
    DeconvNormAct(64, 64, 5, 2), DeconvNormAct(64, 64, 5, 1, act=""),
    DeconvNormAct(32, 32, 5, 1), DeconvNormAct(64, 32, 5, 1),
    DeconvNormAct(64, 64, 3, 1)], ids=["stride2", "no_relu", "32_channels",
                                       "64_to_32", "kernel3"])
def test_route_refuses_other_layers(layer):
    assert not layer.takes_decoder_conv(_card_input())


def test_cpu_layer_and_wrapper_are_the_plain_version():
    g = torch.Generator().manual_seed(0)
    layer = DeconvNormAct(64, 64, 5, 1)
    x = torch.randn(2, 64, 6, 8, generator=g)
    before = k3.LAUNCHES
    want = k3.decoder_conv_plain(x, layer[0].weight, layer[0].bias)
    assert torch.equal(layer(x), want)
    assert torch.equal(k3.decoder_conv_s1(x, layer[0].weight, layer[0].bias), want)
    assert k3.LAUNCHES == before


@pytest.mark.parametrize("sliced", [False, True], ids=["whole", "sliced"])
@pytest.mark.parametrize("trainable", [False, True], ids=["frozen", "trainable"])
def test_function_gradients_on_the_plain_path(trainable, sliced, monkeypatch):
    if sliced:
        # the weight gradient over slices of 1 and 2 images of the batch
        monkeypatch.setattr(k3, "WGRAD_SLICE_BYTES", 3 * 4 * 5 * 8 * 2)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(3, 3, 4, 5, generator=g, dtype=torch.float64, requires_grad=True)
    w = torch.randn(3, 4, 5, 5, generator=g, dtype=torch.float64,
                    requires_grad=trainable)
    b = torch.randn(4, generator=g, dtype=torch.float64, requires_grad=trainable)
    assert torch.autograd.gradcheck(k3.DecoderConvS1.apply, (x, w, b))
    # against autograd of ConvTranspose2d + ReLU
    gy = torch.randn(3, 4, 4, 5, generator=g, dtype=torch.float64)
    leaves = [x, w, b] if trainable else [x]
    got = torch.autograd.grad(k3.DecoderConvS1.apply(x, w, b), leaves, gy)
    want = torch.autograd.grad(
        torch.relu(F.conv_transpose2d(x, w, b, padding=2)), leaves, gy)
    for a, e in zip(got, want):
        torch.testing.assert_close(a, e, rtol=1e-10, atol=1e-10)


def test_function_keeps_its_input_only_for_parameter_gradients():
    g = torch.Generator().manual_seed(2)
    x = torch.randn(1, 3, 4, 4, generator=g, requires_grad=True)
    w = torch.randn(3, 3, 5, 5, generator=g)
    for trainable in (False, True):
        w.requires_grad_(trainable)
        y = k3.DecoderConvS1.apply(x, w, None)
        saved = [t for t in y.grad_fn.saved_tensors if t is not None]
        assert len(saved) == (3 if trainable else 2)
        assert any(t is x or torch.equal(t, x) for t in saved) == trainable


def test_split_tf32_keeps_13_zero_bits_and_float32_accuracy():
    # normal float32 values whose low parts are normal too (a subnormal's
    # rounding error is absolute, not relative)
    r = np.random.default_rng(3)
    v = np.concatenate([r.standard_normal(100_000) * 10.0 ** r.integers(-30, 30, 100_000),
                        [0.0, 1.0, -1.0, 1.5, 3.0e38]]).astype(np.float32)
    hi, lo = k3.split_tf32(torch.from_numpy(v))
    for part in (hi, lo):
        assert (part.view(torch.int32) & 0x1FFF).eq(0).all()
    v64 = v.astype(np.float64)
    hi64, lo64 = hi.double().numpy(), lo.double().numpy()
    assert (np.abs(v64 - hi64) <= 2.0 ** -11 * np.abs(v64)).all()
    assert (np.abs(v64 - (hi64 + lo64)) <= 2.0 ** -22 * np.abs(v64)).all()


def _tf32(a: np.ndarray) -> np.ndarray:
    return k3.split_tf32(torch.from_numpy(np.ascontiguousarray(a, np.float32)))[0].numpy()


def _chunked_dot(products, steps: int = 8) -> np.ndarray:
    """float32 accumulation, as the tensor core adds each k-step of 8 into
    its accumulator: each step's products summed exactly, then rounded once
    into the float32 sum. ``products``: a list of [P, K, N] float64 product
    arrays, added in that order at every step."""
    P, K, N = products[0].shape
    acc = np.zeros((P, N), np.float32)
    for k in range(0, K, steps):
        for prod in products:
            acc = (acc + prod[:, k:k + steps].sum(1)).astype(np.float32)
    return acc


def test_three_tf32_products_keep_float32_accuracy():
    """At the layer's depth (K = 64 x 25), ReLU'd activations: three TF32
    products per float32 product sit within 2x float32's own RMS error
    against float64; a single TF32 product is far worse."""
    r = np.random.default_rng(4)
    K = k3.CHANNELS * k3.KERNEL_SIZE ** 2
    a = np.maximum(r.standard_normal((24, K)), 0).astype(np.float32)
    b = (r.standard_normal((K, 16)) / np.sqrt(K)).astype(np.float32)
    exact = a.astype(np.float64) @ b.astype(np.float64)

    def rms(got):
        return np.sqrt(np.mean(((got - exact) / np.abs(exact).mean()) ** 2))

    def outer(x, y):
        return x.astype(np.float64)[:, :, None] * y.astype(np.float64)[None]

    a_hi = _tf32(a)
    a_lo = _tf32(a - a_hi)
    b_hi = _tf32(b)
    b_lo = _tf32(b - b_hi)
    three = _chunked_dot([outer(a_lo, b_hi), outer(a_hi, b_lo), outer(a_hi, b_hi)])
    float32 = _chunked_dot([outer(a, b)])
    one = _chunked_dot([outer(a_hi, b_hi)])
    assert rms(three) <= 2 * rms(float32)
    assert rms(one) > 100 * rms(float32)


def test_packed_weight_is_in_the_kernels_slab_order():
    g = torch.Generator().manual_seed(5)
    wk = torch.randn(64, 64, 5, 5, generator=g)
    p = k3.pack_weight(wk).double()
    assert p.shape == (25, 8, 2, 8, 2, 8, 4)
    tap, chunk, grp, half, o, i = torch.meshgrid(
        *(torch.arange(n) for n in (25, 8, 8, 2, 8, 4)), indexing="ij")
    want = wk.double()[8 * grp + o, 8 * chunk + 4 * half + i, tap // 5, tap % 5]
    hi, lo = p[:, :, 0], p[:, :, 1]
    assert (hi + lo - want).abs().max() <= 2.0 ** -22 * want.abs().max()
    assert torch.equal(hi.float(), k3.split_tf32(want.float())[0])
    # each (tap, chunk, hi or lo) slab: 512 floats, a core matrix of 8 output
    # channels x 4 input channels every 32 floats (128 bytes)
    flat = k3.pack_weight(wk).reshape(25, 8, 2, 512)
    assert torch.equal(flat[3, 5, 0, 32 * 3:32 * 4].reshape(8, 4),
                       hi[3, 5, 1, 1].float())


def test_conv_weights_give_the_forward_and_its_input_gradient():
    g = torch.Generator().manual_seed(6)
    x = torch.randn(2, 64, 5, 6, generator=g, dtype=torch.float64, requires_grad=True)
    w = torch.randn(64, 64, 5, 5, generator=g, dtype=torch.float64)
    gz = torch.randn(2, 64, 5, 6, generator=g, dtype=torch.float64)
    z = F.conv_transpose2d(x, w, padding=2)
    torch.testing.assert_close(
        F.conv2d(x, k3.conv_weight(w, input_grad=False), padding=2), z,
        rtol=1e-10, atol=1e-10)
    (dx,) = torch.autograd.grad(z, x, gz)
    torch.testing.assert_close(
        F.conv2d(gz, k3.conv_weight(w, input_grad=True), padding=2), dx,
        rtol=1e-10, atol=1e-10)
    y = torch.relu(z).detach()
    (dx_relu,) = torch.autograd.grad(torch.relu(F.conv_transpose2d(x, w, padding=2)),
                                     x, gz)
    torch.testing.assert_close(k3.input_grad_plain(gz, y, w), dx_relu,
                               rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("name", DECODER_CONFIGS)
def test_decoder_state_dicts_load_unchanged(name):
    dec = _decoder(name)
    keys = list(dec.state_dict())
    n = len(_deconvs(dec))
    assert keys == ([f"decoder.{i}.0.{p}" for i in range(n) for p in ("weight", "bias")]
                    + [f"decoder.{n}.weight", f"decoder.{n}.bias",
                       "decoder_pos_embedding.grid",
                       "decoder_pos_embedding.dense.weight",
                       "decoder_pos_embedding.dense.bias"])
    other = _decoder(name)
    other.load_state_dict(dec.state_dict(), strict=True)
    slots = torch.randn(2, 3, dec.decoder_pos_embedding.dense.out_features)
    for a, b in zip(dec(slots), other(slots)):
        assert torch.equal(a, b)
