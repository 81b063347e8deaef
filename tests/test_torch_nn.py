"""Port vs JAX: the NN blocks of ``slotformer_tpu_torch/models/nn.py``.

Tolerance: rtol 1e-4 / atol 1e-5, float32 reassociation between XLA and
torch on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slotformer_tpu.models import nn as jnn
from slotformer_tpu_torch.models import nn as tnn
from slotformer_tpu_torch.runtime import weights as bridge
from torch_port_helpers import close, jax_init, randn, rng, t


def _convert(fn, tree) -> dict:
    sd = {}
    fn(sd, "m", tree)
    return {k[2:]: v for k, v in sd.items()}


def _nchw(x: np.ndarray) -> torch.Tensor:
    return t(x).permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> np.ndarray:
    return x.permute(0, 2, 3, 1).detach().numpy()


def test_layernorm_eps_is_flax_default():
    # tiny variance, where eps 1e-5 and 1e-6 give different outputs
    x = 1e-3 * randn(rng(0), 4, 32)
    mod = jnn.LayerNorm()
    params = jax_init(mod, x)
    want = np.asarray(mod.apply({"params": params}, x))
    ln = tnn.LayerNorm(32)
    assert ln.eps == 1e-6
    close(ln(t(x)), want, atol=1e-4)
    assert np.abs(torch.nn.LayerNorm(32)(t(x)).detach().numpy() - want).max() > 1e-2


@pytest.mark.parametrize("k,stride,size,act", [
    (5, 1, 16, "relu"), (5, 2, 16, "relu"), (3, 2, 15, ""), (4, 1, 12, "")])
def test_conv_norm_act(k, stride, size, act):
    x = randn(rng(1), 2, size, size, 3)
    mod = jnn.ConvNormAct(8, kernel_size=k, stride=stride, act=act)
    params = jax_init(mod, x)
    want = np.asarray(mod.apply({"params": params}, x))
    port = tnn.ConvNormAct(3, 8, k, stride, act=act)
    port.load_state_dict(_convert(bridge._conv_block, params))
    close(_nhwc(port(_nchw(x))), want)


@pytest.mark.parametrize("k,stride", [(5, 2), (5, 1), (3, 2)])
def test_deconv_norm_act(k, stride):
    x = randn(rng(2), 2, 6, 6, 8)
    mod = jnn.DeconvNormAct(4, kernel_size=k, stride=stride, phase=0)
    params = jax_init(mod, x)
    want = np.asarray(mod.apply({"params": params}, x))
    port = tnn.DeconvNormAct(8, 4, k, stride)
    port.load_state_dict(_convert(bridge._conv_block, params))
    got = _nhwc(port(_nchw(x)))
    assert got.shape == (2, 6 * stride, 6 * stride, 4)
    close(got, want)


def test_soft_position_embed_and_grid():
    x = randn(rng(3), 2, 5, 7, 6)
    mod = jnn.SoftPositionEmbed(6, (5, 7))
    params = jax_init(mod, x)
    want = np.asarray(mod.apply({"params": params}, x))
    port = tnn.SoftPositionEmbed(6, (5, 7))
    np.testing.assert_array_equal(port.grid.numpy(), jnn.build_grid((5, 7)))
    sd = _convert(bridge._linear, params["dense"])
    port.load_state_dict({"dense." + k: v for k, v in sd.items()} | {"grid": port.grid})
    close(_nhwc(port(_nchw(x))), want)


def test_mlp():
    x = randn(rng(4), 3, 10)
    mod = jnn.MLP((16, 5))
    params = jax_init(mod, x)
    want = np.asarray(mod.apply({"params": params}, x))
    port = tnn.MLP(10, (16, 5))
    sd = {}
    for i in range(2):
        bridge._linear(sd, str(2 * i), params[f"Dense_{i}"])
    port.load_state_dict(sd)
    close(port(t(x)), want)


def test_sin_pos_enc_reversed_positions():
    want = jnn.get_sin_pos_enc(6, 16)
    got = tnn.get_sin_pos_enc(6, 16)
    np.testing.assert_array_equal(got.numpy(), want)
    pe = tnn.PosEnc("sin", 6, 16)
    assert not pe.requires_grad and torch.equal(pe.data, got)
    assert tnn.PosEnc("", 6, 16) is None


@pytest.mark.parametrize("norm_first,masked", [(True, False), (False, True)])
def test_transformer_encoder(norm_first, masked):
    r = rng(5)
    x = randn(r, 2, 6, 16)
    mask = np.zeros((2, 6), bool)
    if masked:
        mask[0, :2] = True  # True = padded
    mod = jnn.TransformerEncoder(d_model=16, num_layers=2, num_heads=4,
                                 ffn_dim=32, norm_first=norm_first)
    params = jax_init(mod, x)
    want = np.asarray(mod.apply({"params": params}, x,
                                key_padding_mask=jnp.asarray(mask)))
    port = tnn.TransformerEncoder(16, 2, 4, 32, norm_first).eval()
    port.load_state_dict(_convert(bridge._transformer_encoder, params))
    got = port(t(x), key_padding_mask=torch.from_numpy(mask) if masked else None)
    close(got, want)
