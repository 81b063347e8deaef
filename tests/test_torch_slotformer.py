"""Port vs JAX: SlotRollouter, SlotFormer rollout + decode, the weight
bridge and golden group ``g_roll``.

Tolerance: rtol 1e-4 / atol 1e-5 per call; 1e-4 abs for rollouts of several
autoregressive steps, where each step feeds the last one's float32 noise
back in; the golden keeps tests/test_golden_parity.py's tolerance.
"""

import types

import jax
import numpy as np
import pytest
import torch

from slotformer_tpu.models.slotformer import SlotFormer as JaxSlotFormer
from slotformer_tpu.models.slotformer import SlotRollouter as JaxSlotRollouter
from slotformer_tpu.runtime import torch_compat as tc
from slotformer_tpu_torch.models.slotformer import SlotFormer, SlotRollouter
from slotformer_tpu_torch.runtime.weights import from_jax_params
from torch_port_helpers import close, golden_group, jax_init, randn, rng, state_dict, t

SEQ_ATOL = 1e-4

ROLL = dict(num_slots=3, slot_size=8, history_len=4, t_pe="sin", slots_pe="",
            d_model=16, num_layers=2, num_heads=2, ffn_dim=32, norm_first=True)
CFG = dict(
    resolution=(16, 16),
    slot_dict=dict(num_slots=3, slot_size=8),
    dec_dict=dict(dec_channels=(8, 8, 8), dec_resolution=(4, 4), dec_ks=3,
                  dec_norm=""),
    rollout_dict=ROLL,
    loss_dict=dict(rollout_len=3, use_img_recon_loss=True),
)


def _pair(cfg=CFG, seed=0):
    jmod = JaxSlotFormer(**cfg)
    n_frames = cfg["rollout_dict"]["history_len"] + cfg["loss_dict"]["rollout_len"]
    params = jax_init(jmod, {"slots": np.zeros((1, n_frames, 3, 8), np.float32)},
                      seed=seed)
    port = SlotFormer(**cfg).eval()
    port.load_state_dict(from_jax_params(
        params, "SlotFormer", types.SimpleNamespace(**cfg)))
    return jmod, params, port


def test_rollouter_matches_jax():
    x = randn(rng(0), 2, 4, 3, 8)
    jmod = JaxSlotRollouter(**ROLL)
    params = jax_init(jmod, x, 5)
    want = np.asarray(jmod.apply({"params": params}, x, 5))
    port = SlotFormer(**CFG).rollouter.eval()
    sd = from_jax_params({"rollouter": params, "decoder": _pair()[1]["decoder"]},
                         "SlotFormer", types.SimpleNamespace(**CFG))
    port.load_state_dict({k[len("rollouter."):]: v for k, v in sd.items()
                          if k.startswith("rollouter.")})
    with torch.no_grad():
        got = port(t(x), 5)
    assert got.shape == (2, 5, 3, 8)
    close(got, want, atol=SEQ_ATOL)


def test_golden_g_roll_loads_reference_state_dict():
    sd, ins, outs = golden_group("g_roll")
    port = SlotRollouter(**ROLL).eval()
    port.load_state_dict(state_dict(sd))
    with torch.no_grad():
        got = port(t(ins["x"]), 3)
    close(got, outs["pred"], rtol=2e-3, atol=2e-4)


@pytest.mark.parametrize("with_gt", [True, False])
def test_rollout_decode_matches_jax(with_gt):
    jmod, params, port = _pair(seed=1)
    past = randn(rng(2), 2, 5, 3, 8)
    want = jmod.apply({"params": params}, past, 6, True, with_gt,
                      method="rollout")
    with torch.no_grad():
        got = port.rollout(t(past), 6, decode=True, with_gt=with_gt)
    T = 11 if with_gt else 6
    assert got["recon_combined"].shape == (2, T, 16, 16, 3)
    for key in ("slots", "recon_combined", "recons", "masks"):
        close(got[key], want[key], atol=SEQ_ATOL)


def test_forward_matches_jax():
    jmod, params, port = _pair(seed=3)
    slots = randn(rng(4), 2, 7, 3, 8)
    want = jmod.apply({"params": params}, {"slots": slots})
    with torch.no_grad():
        got = port({"slots": t(slots)})
    assert sorted(got) == sorted(want)
    for key in want:
        close(got[key], want[key], atol=SEQ_ATOL)


def test_weight_bridge_inverts_torch_compat():
    _, params, _ = _pair(seed=5)
    sd = from_jax_params(params, "SlotFormer", types.SimpleNamespace(**CFG))
    sd_np = {k: v.numpy() for k, v in sd.items()}
    back = {"rollouter": tc.slotformer(sd_np, 2, 2)["rollouter"],
            "decoder": tc.savi_decoder(sd_np, n_deconvs=2)}
    assert jax.tree.structure(back) == jax.tree.structure(params)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, rtol=0, atol=1e-7),
                 back, params)


def _loop(m, x, pred_len):
    """The rollouter's sliding-window loop written out: what every call
    computes, on the graph path or off it."""
    B, N = x.shape[0], m.num_slots
    buf = x.reshape(B, m.history_len * N, x.shape[-1])
    pe = m._pos_enc()
    preds = []
    for _ in range(pred_len):
        pred = m.out_proj(m.transformer_encoder(m.in_proj(buf) + pe)[:, -N:])
        preds.append(pred)
        buf = torch.cat([buf[:, N:], pred], dim=1)
    return torch.stack(preds, 1)


@pytest.mark.parametrize("case", ["grad", "train", "cpu"])
def test_rollouter_runs_eagerly_where_no_graph_can(case, monkeypatch):
    """With gradients, in training mode (dropout draws) or on the CPU the
    rollouter runs its loop eagerly: no graph is captured, the output is
    the loop's, bit for bit, and with gradients it carries them."""
    m = SlotRollouter(**ROLL).train(case == "train")
    monkeypatch.setattr(SlotRollouter, "_capture", lambda *a: pytest.fail(
        "captured a graph"))
    x = t(randn(rng(6), 2, 4, 3, 8))
    with torch.set_grad_enabled(case == "grad"):
        assert not m._graphable(x)
        torch.manual_seed(0)
        got = m(x, 5)
        torch.manual_seed(0)
        want = _loop(m, x, 5)
    assert len(m._graphs.by_key) == 0
    assert torch.equal(got, want)
    assert got.requires_grad == (case == "grad")
    if case == "grad":
        got.sum().backward()
        assert m.in_proj.weight.grad.abs().sum() > 0
    if case == "train":  # dropout drew: eval mode gives another answer
        with torch.no_grad():
            assert not torch.equal(got, m.eval()(x, 5))
