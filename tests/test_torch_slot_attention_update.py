"""Port vs JAX: kernel K2's entry point, ``slot_attention_update``.

The port's plain version (what CPU tensors run, and what the kernel's
backward differentiates) is held against the JAX Pallas kernel in interpret
mode and against its jnp twin ``_jnp_reference``, in values and in the
gradients of k, v and q, on the same numpy inputs. Tolerances are those of
tests/test_pallas_ops.py: attn 1e-5, upd 1e-4, grads 2e-4 (float32 on both
sides, summed in different orders).
"""

import importlib

import jax
import numpy as np
import pytest
import torch

from slotformer_tpu.ops.slot_attention_kernel import (
    _jnp_reference,
    slot_attention_update as jax_update,
)
from slotformer_tpu_torch.kernels import slot_attention_update
from slotformer_tpu_torch.kernels.slot_attention_update import (
    slot_attention_update_plain,
)
from torch_port_helpers import close, randn, rng, t

k2 = importlib.import_module("slotformer_tpu_torch.kernels.slot_attention_update")

CASES = [dict(B=2, N=64, S=7), dict(B=2, N=32, S=5), dict(B=2, N=37, S=7)]


def _inputs(B, N, S, D=128, seed=0):
    r = rng(seed)
    return randn(r, B, N, D), randn(r, B, N, D), randn(r, B, S, D) * D ** -0.5


def _loss(upd, attn):
    return (upd ** 2).sum() + (attn ** 3).sum()


@pytest.mark.parametrize("case", CASES, ids=lambda c: "B{B}-N{N}-S{S}".format(**c))
def test_plain_matches_jax_kernel_and_reference(case):
    k, v, q = _inputs(**case)
    pal_upd, pal_attn = jax_update(k, v, q, 1e-6, True)
    ref_upd, ref_attn = _jnp_reference(k, v, q, 1e-6)
    upd, attn = slot_attention_update_plain(t(k), t(v), t(q), 1e-6)
    assert upd.shape == (case["B"], case["S"], 128)
    assert attn.shape == (case["B"], case["N"], case["S"])
    for want_upd, want_attn in ((pal_upd, pal_attn), (ref_upd, ref_attn)):
        close(attn, want_attn, rtol=1e-5, atol=1e-5)
        close(upd, want_upd, rtol=1e-4, atol=1e-4)
    close(attn.sum(-1), np.ones((case["B"], case["N"])), rtol=1e-5)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "B{B}-N{N}-S{S}".format(**c))
def test_plain_gradients_match_jax(case):
    k, v, q = _inputs(**case, seed=1)
    want = jax.grad(lambda *a: _loss(*jax_update(*a, 1e-6, True)),
                    argnums=(0, 1, 2))(k, v, q)
    xs = [t(x).requires_grad_(True) for x in (k, v, q)]
    got = torch.autograd.grad(_loss(*slot_attention_update(*xs)), xs)
    for g, w in zip(got, want):
        close(g, w, rtol=2e-4, atol=2e-4)


def test_cpu_tensors_never_launch_and_cast_back():
    k, v, q = (t(x) for x in _inputs(2, 40, 6))
    before = k2.LAUNCHES
    upd, attn = slot_attention_update(k, v, q)
    want_upd, want_attn = slot_attention_update_plain(k, v, q)
    assert k2.LAUNCHES == before
    assert torch.equal(upd, want_upd) and torch.equal(attn, want_attn)
    # computed in float32, returned in the input dtype (as the JAX function)
    b_upd, b_attn = slot_attention_update(k.bfloat16(), v.bfloat16(), q.bfloat16())
    assert b_upd.dtype == b_attn.dtype == torch.bfloat16
    f32 = slot_attention_update_plain(k.bfloat16().float(), v.bfloat16().float(),
                                      q.bfloat16().float())
    assert torch.equal(b_upd, f32[0].bfloat16())
    assert torch.equal(b_attn, f32[1].bfloat16())


def test_bad_input_raises():
    k, v, q = (t(x) for x in _inputs(1, 16, 9))
    with pytest.raises(ValueError, match="slots"):
        slot_attention_update(k, v, q)  # S = 9 > 8
    with pytest.raises(ValueError, match="B, N, D"):
        slot_attention_update(k, v[:, :8], q[:, :4])
    with pytest.raises(ValueError, match="q"):
        slot_attention_update(k, v, q[:, :4, :64])
    with pytest.raises(ValueError, match="several devices"):
        slot_attention_update(k, v, q[:, :4].to("meta"))
    meta = [x.to("meta") for x in (k, v, q[:, :4])]
    with pytest.raises(ValueError, match="no kernel for device"):
        slot_attention_update(*meta)
