"""Port vs JAX: kernel K1's plain version and the SlotAttention module.

The CUDA kernel itself runs only on a card (tests/test_torch_kernels_cuda.py);
here CPU tensors take its plain version, which must equal the JAX twin
``fused_reference`` and the JAX module's jnp loop. Tolerance: rtol 1e-4 /
atol 1e-5 (float32 reassociation); the goldens keep the looser tolerance of
tests/test_golden_parity.py, since the reference ran its LayerNorms with
torch's eps of 1e-5.
"""

import numpy as np
import pytest
import torch

from slotformer_tpu.models.slot_attention import SlotAttention as JaxSlotAttention
from slotformer_tpu.ops.slot_attention_kernel import fused_reference
from slotformer_tpu_torch.kernels import slot_attention as k1
from slotformer_tpu_torch.models.slot_attention import SlotAttention
from slotformer_tpu_torch.runtime import weights as bridge
from torch_port_helpers import close, golden_group, jax_init, randn, rng, state_dict, t


def _random_wp(r, D, H) -> dict:
    shapes = dict(wq=(D, D), w1=(D, H), b1=(H,), w2=(H, D))
    wp = {}
    for n in k1.WP_KEYS:
        shape = shapes.get(n, (D, D) if n.startswith("w_") else (D,))
        wp[n] = randn(r, *shape) * (shape[0] ** -0.5 if len(shape) == 2 else 0.1)
    wp["q_ln_scale"] += 1.0
    wp["mlp_ln_scale"] += 1.0
    return wp


def _port_sa(params, in_features, iters, S, D, H) -> SlotAttention:
    sd = {}
    bridge._slot_attention(sd, "m", params)
    mod = SlotAttention(in_features, iters, S, D, H)
    mod.load_state_dict({k[2:]: v for k, v in sd.items()})
    return mod


@pytest.mark.parametrize("B,N,D,S,H,iters", [(2, 48, 16, 7, 32, 2),
                                              (3, 37, 32, 3, 24, 3),
                                              (2, 64, 192, 6, 384, 2)])
def test_plain_matches_jax_fused_reference(B, N, D, S, H, iters):
    r = rng(0)
    k, v, slots = randn(r, B, N, D), randn(r, B, N, D), randn(r, B, S, D)
    wp = _random_wp(r, D, H)
    want = fused_reference(k, v, slots, wp, iters, S, D ** -0.5, 1e-6)
    got = k1.fused_slot_attention_plain(
        t(k), t(v), t(slots), {n: t(w) for n, w in wp.items()}, iters, S,
        D ** -0.5, 1e-6)
    close(got[0], want[0])
    close(got[1], want[1])


def test_module_matches_jax_jnp_loop():
    r = rng(1)
    x, slots = randn(r, 2, 64, 12), randn(r, 2, 5, 16)
    jmod = JaxSlotAttention(in_features=12, num_iterations=2, num_slots=5,
                            slot_size=16, mlp_hidden_size=32)
    params = jax_init(jmod, x, slots)
    want = np.asarray(jmod.apply({"params": params}, x, slots))
    port = _port_sa(params, 12, 2, 5, 16, 32)
    close(port(t(x), t(slots)), want)


def test_golden_g_sa_loads_reference_state_dict():
    sd, ins, outs = golden_group("g_sa")
    port = SlotAttention(in_features=12, num_iterations=2, num_slots=4,
                         slot_size=16, mlp_hidden_size=32)
    port.load_state_dict(state_dict(sd))
    close(port(t(ins["inputs"]), t(ins["slots"])), outs["slots"],
          rtol=2e-3, atol=2e-4)


def test_cpu_tensors_never_launch_the_kernel(monkeypatch):
    monkeypatch.setattr(k1, "LAUNCHES", 0)
    r = rng(2)
    port = SlotAttention(12, 2, 4, 16, 32)
    port(t(randn(r, 2, 20, 12)), t(randn(r, 2, 4, 16)))
    assert k1.LAUNCHES == 0


def test_autograd_function_grads_equal_plain_autograd(monkeypatch):
    """The Function's backward (autograd of the plain version), with its
    forward stood in by the plain version, as no kernel runs on the CPU.
    The Function takes the packed weights; the gradients reach the unpacked
    ones through ``pack_weights``."""
    monkeypatch.setattr(k1, "_launch", k1.fused_slot_attention_plain)
    r = rng(3)
    B, N, D, S, H = 2, 24, 16, 5, 32
    leaves = [t(randn(r, B, N, D)), t(randn(r, B, N, D)), t(randn(r, B, S, D))]
    leaves += [t(w) for w in _random_wp(r, D, H).values()]
    g_slots, g_attn = t(randn(r, B, S, D)), t(randn(r, B, N, S))

    def grads(fn):
        xs = [x.clone().requires_grad_(True) for x in leaves]
        slots, attn = fn(xs)
        loss = (slots * g_slots).sum() + (attn * g_attn).sum()
        return torch.autograd.grad(loss, xs)

    args = (2, S, D ** -0.5, 1e-6)
    want = grads(lambda xs: k1.fused_slot_attention_plain(
        *xs[:3], dict(zip(k1.WP_KEYS, xs[3:])), *args))

    def through_function(xs):
        packed = k1.pack_weights(dict(zip(k1.WP_KEYS, xs[3:])))
        return k1._FusedSlotAttention.apply(
            *args, *xs[:3], *[packed[n] for n in k1.PACKED_KEYS])

    got = grads(through_function)
    for a, b in zip(got, want):
        close(a, b.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("case", ["nine_slots", "float64", "noncontiguous",
                                  "device_mix"])
def test_wrapper_raises_on_unsupported_input(case):
    r = rng(4)
    B, N, D, S, H = 2, 10, 16, 9 if case == "nine_slots" else 4, 32
    k, v, slots = t(randn(r, B, N, D)), t(randn(r, B, N, D)), t(randn(r, B, S, D))
    wp = {n: t(w) for n, w in _random_wp(r, D, H).items()}
    if case == "float64":
        k = k.double()
    if case == "noncontiguous":
        k = t(randn(r, B, D, N)).transpose(1, 2)
    if case == "device_mix":
        wp["wq"] = wp["wq"].to("meta")
        with pytest.raises(ValueError, match="several devices"):
            k1.fused_slot_attention(k, v, slots, wp, 2, S, D ** -0.5)
        return
    with pytest.raises((ValueError, TypeError)):
        k1._check(k, v, slots, wp, S)
