"""Port vs JAX and the reference goldens: the STEVE family (dVAE,
the token decoder with its KV-cached ``generate``, STEVE, STEVESlotFormer),
``RNNPredictorWrapper``, ``SlotAttentionWMask`` and the weight bridge.

Inputs, weights and gumbel noise are the same numpy arrays on both sides
(the noise JAX draws is recorded and passed to the port's ``uniform=``).
Tolerances: rtol 1e-4 / atol 1e-5 for single modules; 1e-4 abs where slots
pass through recurrent frame steps of slot attention; the goldens keep
tests/test_golden_parity.py's tolerances (the reference ran torch's
LayerNorm and GroupNorm eps of 1e-5, the port and JAX 1e-6).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import slotformer_tpu.models.dvae as jax_dvae
import slotformer_tpu.models.steve as jax_steve
from slotformer_tpu.models.dvae import dVAE as JaxDVAE
from slotformer_tpu.models.predictor import build_predictor as jax_build_predictor
from slotformer_tpu.models.savi import StoSAVi as JaxStoSAVi
from slotformer_tpu.models.slot_attention import SlotAttentionWMask as JaxSAWMask
from slotformer_tpu.models.steve import STEVE as JaxSTEVE
from slotformer_tpu.models.steve_slotformer import STEVESlotFormer as JaxSTEVESF
from slotformer_tpu.runtime import torch_compat as tc
from slotformer_tpu_torch.models import (STEVE, STEVESlotFormer, SlotAttentionWMask,
                                         StoSAVi, dVAE)
from slotformer_tpu_torch.models.predictor import build_predictor
from slotformer_tpu_torch.models.steve_transformer import STEVETransformerDecoder
from slotformer_tpu_torch.runtime import weights as W
from slotformer_tpu_torch.runtime.weights import from_jax_params
from torch_port_helpers import close, golden_group, randn, rng, state_dict, t

SEQ_ATOL = 1e-4
# the goldens (tests/test_golden_parity.py): GroupNorm / LayerNorm eps differ
DVAE_GOLDEN_ATOL = 2e-3
GOLDEN_RTOL, GOLDEN_ATOL = 2e-3, 2e-4
SLOTS_RTOL, SLOTS_ATOL = 5e-3, 5e-4

PRED_RNN = dict(pred_type="transformer", pred_rnn=True, pred_norm_first=True,
                pred_num_layers=1, pred_num_heads=2, pred_ffn_dim=32,
                pred_sg_every=None)
TINY_DVAE = dict(down_factor=4, vocab_size=16)
TINY_DEC = dict(dec_num_layers=1, dec_num_heads=2, dec_d_model=16)


def steve_cfg(resolution=(64, 64), use_img_recon_loss=False):
    return dict(
        resolution=resolution, clip_len=2,
        slot_dict=dict(num_slots=3, slot_size=16, slot_mlp_size=32,
                       num_iterations=2),
        dvae_dict=TINY_DVAE,
        enc_dict=dict(enc_channels=(3, 8, 8), enc_ks=5, enc_norm="",
                      enc_out_channels=16),
        dec_dict=TINY_DEC, pred_dict=PRED_RNN,
        loss_dict=dict(use_img_recon_loss=use_img_recon_loss))


def sf_cfg(resolution=(64, 64)):
    return dict(
        resolution=resolution, clip_len=2,
        slot_dict=dict(num_slots=3, slot_size=16), dvae_dict=TINY_DVAE,
        dec_dict=TINY_DEC,
        rollout_dict=dict(num_slots=3, slot_size=16, history_len=2,
                          t_pe="sin", slots_pe="", d_model=16, num_layers=1,
                          num_heads=2, ffn_dim=32, norm_first=True),
        loss_dict=dict(rollout_len=3, use_img_recon_loss=False))


def japply(jmod, params, *args, **static):
    """``jmod.apply`` under ``jax.jit`` (one compile instead of one per
    operation), keyword arguments static; ``rngs`` passes through."""
    rngs = static.pop("rngs", None)
    fn = jax.jit(lambda p, r, *a: jmod.apply({"params": p}, *a, rngs=r, **static))
    return jax.tree.map(np.asarray, fn(params, rngs, *args))


def init_both(jmod, port_cls, kind, cfg, *args, seed=0):
    """(JAX params from ``jmod.init``, the port model holding them)."""
    key = jax.random.PRNGKey(seed)
    params = jax.tree.map(np.asarray, dict(
        jax.jit(jmod.init)({"params": key, "sample": key}, *args)["params"]))
    port = port_cls(**cfg).eval()
    port.load_state_dict(from_jax_params(params, kind,
                                         types.SimpleNamespace(**cfg)))
    return params, port


@pytest.fixture
def jax_uniforms(monkeypatch):
    """Records the U[tiny, 1) draws of the JAX gumbel_softmax calls."""
    drawn = []
    orig = jax_dvae.gumbel_softmax

    def spy(logits, key, tau=1.0, hard=False, axis=-1):
        u = jax.random.uniform(key, logits.shape, logits.dtype,
                               minval=jnp.finfo(logits.dtype).tiny, maxval=1.0)
        jax.debug.callback(lambda u: drawn.append(np.asarray(u)), u)
        return orig(logits, key, tau, hard, axis)

    monkeypatch.setattr(jax_dvae, "gumbel_softmax", spy)
    monkeypatch.setattr(jax_steve, "gumbel_softmax", spy)
    return drawn


# ------------------------------------------------------------------ goldens

def test_golden_g_dvae():
    sd, ins, outs = golden_group("g_dvae")
    port = dVAE(vocab_size=16).eval()
    port.load_state_dict(state_dict(sd))
    jmod, jparams = JaxDVAE(vocab_size=16), tc.dvae(sd)
    img = np.transpose(ins["img"], (0, 2, 3, 1))  # NCHW -> NHWC
    z = np.transpose(ins["z"], (0, 2, 3, 1))
    with torch.no_grad():
        logits = port.encode_logits(t(img))
        ids = port.tokenize(t(img), one_hot=False)
        recon = port.detokenize(t(z))
    close(logits, np.transpose(outs["logits"], (0, 2, 3, 1)), atol=DVAE_GOLDEN_ATOL)
    np.testing.assert_array_equal(ids.numpy(), outs["token_ids"])
    close(recon, np.transpose(outs["recon"], (0, 2, 3, 1)), atol=DVAE_GOLDEN_ATOL)
    close(logits, japply(jmod, jparams, img, method="encode_logits"))
    np.testing.assert_array_equal(
        ids.numpy(), japply(jmod, jparams, img, one_hot=False, method="tokenize"))
    close(recon, japply(jmod, jparams, z, method="detokenize"))


def test_golden_g_steve_generate_token_for_token():
    sd, ins, outs = golden_group("g_steve")
    port = STEVETransformerDecoder(vocab_size=12, d_model=16, n_head=2,
                                   max_len=15, num_slots=3, num_layers=2).eval()
    port.load_state_dict(state_dict(sd))
    slots = t(ins["slots"])
    with torch.no_grad():
        logits = port(slots, torch.from_numpy(ins["idx"]))
        ids, gen_logits = port.generate(slots, 6)
        again = port(slots, ids[:, :-1])  # the full re-forward of its ids
    close(logits, outs["logits"])
    np.testing.assert_array_equal(ids.numpy(), outs["gen_ids"])
    close(gen_logits, outs["gen_logits"])
    close(again, gen_logits.numpy())
    g1, g2 = (torch.Generator().manual_seed(3) for _ in range(2))
    with torch.no_grad():
        s1 = port.generate(slots, 16, sample=True, generator=g1)[0]
        s2 = port.generate(slots, 16, sample=True, generator=g2)[0]
    assert torch.equal(s1, s2) and s1.shape == (2, 16)


def test_golden_g_stevefull():
    sd, ins, outs = golden_group("g_stevefull")
    port = STEVE(**steve_cfg()).eval()
    port.load_state_dict(state_dict(sd))
    img = np.transpose(ins["img"], (0, 1, 3, 4, 2))  # NCHW video -> NHWC
    with torch.no_grad():
        slots, masks, feats, _ = port.encode(t(img))
    close(feats, outs["encoder_out"], rtol=GOLDEN_RTOL, atol=GOLDEN_ATOL)
    close(slots, outs["slots"], rtol=SLOTS_RTOL, atol=SLOTS_ATOL)
    close(masks, outs["masks"], rtol=SLOTS_RTOL, atol=SLOTS_ATOL)


def test_golden_g_stevesf():
    sd, ins, outs = golden_group("g_stevesf")
    port = STEVESlotFormer(**sf_cfg()).eval()
    port.load_state_dict(state_dict(sd))
    with torch.no_grad():
        pred = port.rollout(t(ins["past"]), 3)
    close(pred, outs["pred"])


# ----------------------------------------------------------------- modules

@pytest.mark.parametrize("sg_every", [None, 2])
def test_rnn_predictor_matches_jax_with_gradients(sg_every):
    """Four frame steps of the LSTM-wrapped MLP predictor: outputs, and the
    gradients of a weighted sum of them to every step's input and to the
    weights (``sg_every=2`` cuts the graph before step 2)."""
    import flax.linen as fnn

    pred_dict = dict(pred_type="mlp", pred_rnn=True, pred_sg_every=sg_every)
    B, N, D, H, T = 2, 3, 8, 12, 4

    class Rollout(fnn.Module):
        @fnn.compact
        def __call__(self, xs):
            pred = jax_build_predictor(D, H, pred_dict)
            state, outs = pred.init_state(B, N), []
            for x in xs:
                out, state = pred(x, state)
                outs.append(out)
            return jnp.stack(outs)

    r = rng(7)
    xs, ws = randn(r, T, B, N, D), randn(r, T, B, N, D)
    jmod = Rollout()
    params = jax.tree.map(np.asarray, dict(
        jax.jit(jmod.init)(jax.random.PRNGKey(0), xs)["params"]))
    loss = lambda p, x: (jmod.apply({"params": p}, x) * ws).sum()  # noqa: E731
    want = japply(jmod, params, xs)
    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, xs)

    def as_torch(tree):
        sd = {}
        W._lstm(sd, "rnn", tree["predictor"]["rnn"])
        W._linear(sd, "out_projector", tree["predictor"]["out_projector"])
        base = tree["predictor_base"]
        W._norm(sd, "base_predictor.ln", base["ln"])
        for i in range(2):
            W._linear(sd, f"base_predictor.mlp.{2 * i}", base["mlp"][f"Dense_{i}"])
        return sd

    port = build_predictor(D, H, pred_dict)
    port.load_state_dict(as_torch(params))
    x = t(xs).requires_grad_(True)
    state, outs = port.init_state(B, N), []
    for i in range(T):
        out, state = port(x[i], state)
        outs.append(out)
    got = torch.stack(outs)
    (got * t(ws)).sum().backward()
    close(got, want)
    close(x.grad, gx)
    if sg_every:
        assert not x.grad[sg_every].any()
    grads = {n: p.grad for n, p in port.named_parameters()}
    for name, g in as_torch(jax.tree.map(np.asarray, gp)).items():
        if name != "rnn.bias_hh_l0":
            close(grads[name], g.numpy(), atol=1e-5)
    # the JAX tree has one LSTM bias a gate, torch two that add: both get
    # the gradient of the JAX one
    close(grads["rnn.bias_hh_l0"], grads["rnn.bias_ih_l0"].numpy(), atol=0)


def test_slot_attention_w_mask_matches_jax():
    r = rng(3)
    inputs, slots = randn(r, 2, 20, 12), randn(r, 2, 5, 16)
    jmod = JaxSAWMask(in_features=12, num_iterations=2, num_slots=5,
                      slot_size=16, mlp_hidden_size=24)
    params = jax.tree.map(np.asarray, dict(
        jax.jit(jmod.init)(jax.random.PRNGKey(1), inputs, slots)["params"]))
    want_slots, want_masks = japply(jmod, params, inputs, slots)
    port = SlotAttentionWMask(12, 2, 5, 16, 24)
    sd = {}
    W._slot_attention(sd, "sa", params)
    port.load_state_dict({k[3:]: v for k, v in sd.items()})
    with torch.no_grad():
        got_slots, got_masks = port(t(inputs), t(slots))
    assert got_masks.shape == (2, 5, 20)
    close(got_slots, want_slots)
    close(got_masks, want_masks)


def test_dvae_forward_and_loss_match_jax(jax_uniforms):
    img = np.tanh(randn(rng(4), 2, 3, 16, 16, 3))
    jmod = JaxDVAE(vocab_size=16)
    params, port = init_both(jmod, dVAE, "dVAE", dict(vocab_size=16),
                             {"img": img[:, 0]})
    key = jax.random.PRNGKey(5)
    want = japply(jmod, params, {"img": img}, tau=0.5, rngs={"sample": key})
    want_loss = japply(jmod, params, {"img": img}, want,
                       method="calc_train_loss")
    u = jax_uniforms[-1].reshape(2, 3, 4, 4, 16)  # JAX draws over B*T frames
    with torch.no_grad():
        got = port({"img": t(img)}, tau=0.5, uniform=t(u))
        loss = port.calc_train_loss({"img": t(img)}, got)
        ids = port({"img": t(img)}, testing=True)
    close(got["z_logits"], want["z_logits"])
    close(got["recon"], want["recon"])
    close(loss["recon_loss"], want_loss["recon_loss"])
    np.testing.assert_array_equal(
        ids.numpy(), japply(jmod, params, {"img": img}, testing=True))


@pytest.mark.parametrize("use_img_recon_loss", [False, True])
def test_steve_forward_and_loss_match_jax(use_img_recon_loss, jax_uniforms):
    """STEVE at 128x128 (stride-2 encoder, masks upsampled 64 -> 128 in
    eval) with the token path, teacher forcing, the loss and, optionally,
    the gumbel image branch."""
    cfg = steve_cfg((128, 128), use_img_recon_loss)
    img = np.tanh(randn(rng(5), 2, 2, 128, 128, 3))
    jmod = JaxSTEVE(**cfg)
    params, port = init_both(jmod, STEVE, "STEVE", cfg, {"img": img})
    want = japply(jmod, params, {"img": img}, deterministic=True,
                  rngs={"sample": jax.random.PRNGKey(9)})
    want_loss = japply(jmod, params, {"img": img}, want,
                       method="calc_train_loss")
    uniform = t(jax_uniforms[-1]) if use_img_recon_loss else None
    with torch.no_grad():
        got = port({"img": t(img)}, uniform=uniform)
        loss = port.calc_train_loss({"img": t(img)}, got)
    assert got["masks"].shape == (2, 2, 3, 128, 128)
    close(got["slots"], want["slots"], atol=SEQ_ATOL)
    close(got["masks"], want["masks"], atol=SEQ_ATOL)
    np.testing.assert_array_equal(got["target_token_id"].numpy(),
                                  want["target_token_id"])
    close(got["pred_token_id"], want["pred_token_id"], atol=SEQ_ATOL)
    assert sorted(loss) == sorted(want_loss)
    for name in loss:
        close(loss[name], want_loss[name])
    if use_img_recon_loss:
        close(got["recon_img"], want["recon_img"], atol=SEQ_ATOL)


def test_steve_chunked_encode_with_carry_matches_whole():
    cfg = steve_cfg((32, 32))
    img = np.tanh(randn(rng(6), 2, 4, 32, 32, 3))
    jmod = JaxSTEVE(**cfg)
    params, port = init_both(jmod, STEVE, "STEVE", cfg, {"img": img})
    want_slots, want_masks, _, _ = japply(jmod, params, img, method="encode")
    with torch.no_grad():
        s1, m1, _, carry = port.encode(t(img[:, :2]))
        s2, m2, _, _ = port.encode(t(img[:, 2:]), *carry)
    close(torch.cat([s1, s2], 1), want_slots, atol=SEQ_ATOL)
    close(torch.cat([m1, m2], 1), want_masks, atol=SEQ_ATOL)


def test_steve_slotformer_decode_and_forward_match_jax():
    """KV-cached generation over all h*w = 16 patches, then both
    detokenizations; the gumbel noise JAX draws from PRNGKey(0) without a
    ``sample`` stream is passed to the port as ``uniform``."""
    cfg = dict(sf_cfg((16, 16)), loss_dict=dict(rollout_len=3,
                                                use_img_recon_loss=True))
    r = rng(8)
    slots, batch_slots = randn(r, 3, 3, 16), randn(r, 2, 5, 3, 16)
    img = np.tanh(randn(r, 2, 5, 16, 16, 3))
    jmod = JaxSTEVESF(**cfg)
    params, port = init_both(jmod, STEVESlotFormer, "STEVESlotFormer", cfg,
                             {"slots": batch_slots, "img": img})
    soft, hard = japply(jmod, params, slots, method="decode")
    u = np.asarray(jax.random.uniform(
        jax.random.PRNGKey(0), (3, 4, 4, 16), jnp.float32,
        minval=jnp.finfo(jnp.float32).tiny, maxval=1.0))
    want = japply(jmod, params, {"slots": batch_slots, "img": img})
    want_loss = japply(jmod, params, {"slots": batch_slots}, want,
                       method="calc_train_loss")
    with torch.no_grad():
        got_soft, got_hard = port.decode(t(slots), uniform=t(u))
        default_soft, _ = port.decode(t(slots))  # its own seeded generator
        got = port({"slots": t(batch_slots), "img": t(img)})
        loss = port.calc_train_loss({}, got)
        ro = port.rollout(t(batch_slots[:, :2]), 2, decode=True)
    close(got_soft, soft)
    close(got_hard, hard)
    assert default_soft.shape == (3, 16, 16, 3)
    close(got["pred_slots"], want["pred_slots"])
    close(got["pred_token_id"], want["pred_token_id"])
    assert sorted(loss) == sorted(want_loss)
    for name in loss:
        close(loss[name], want_loss[name])
    assert ro["recon_combined"].shape == (2, 4, 16, 16, 3)


# --------------------------------------------------------------- weights

def _savi_rnn_cfg():
    return dict(
        resolution=(16, 16),
        slot_dict=dict(num_slots=3, slot_size=16, slot_mlp_size=32,
                       num_iterations=2, kernel_mlp=True),
        enc_dict=dict(enc_channels=(3, 8, 8), enc_ks=5, enc_out_channels=16,
                      enc_norm=""),
        dec_dict=dict(dec_channels=(16, 8, 8), dec_resolution=(4, 4),
                      dec_ks=5, dec_norm=""),
        pred_dict=PRED_RNN,
        loss_dict=dict(use_post_recon_loss=True, kld_method="none"))


ROUND_TRIPS = {
    "dVAE": (lambda: (JaxDVAE(vocab_size=16), dVAE, dict(vocab_size=16),
                      ({"img": np.zeros((1, 16, 16, 3), np.float32)},)),
             lambda sd: tc.dvae(sd)),
    "STEVE": (lambda: (JaxSTEVE(**steve_cfg((32, 32))), STEVE,
                       steve_cfg((32, 32)),
                       ({"img": np.zeros((1, 2, 32, 32, 3), np.float32)},)),
              lambda sd: tc.steve(sd, n_convs=2, pred_dict=PRED_RNN,
                                  dec_num_layers=1)),
    "STEVESlotFormer": (
        lambda: (JaxSTEVESF(**sf_cfg((16, 16))), STEVESlotFormer,
                 sf_cfg((16, 16)),
                 ({"slots": np.zeros((1, 5, 3, 16), np.float32)},)),
        lambda sd: tc.steve_slotformer(sd, num_layers=1, num_heads=2,
                                       dec_num_layers=1)),
    "StoSAVi": (lambda: (JaxStoSAVi(**_savi_rnn_cfg()), StoSAVi, _savi_rnn_cfg(),
                         ({"img": np.zeros((1, 2, 16, 16, 3), np.float32)},)),
                lambda sd: tc.stosavi(sd, n_convs=2, pred_dict=PRED_RNN,
                                      kernel_mlp=True, n_deconvs=2)),
}


@pytest.mark.parametrize("kind", sorted(ROUND_TRIPS))
def test_weight_bridge_round_trip(kind):
    """JAX tree -> the port's state_dict (loads strictly) -> the JAX tree
    again through torch_compat, the mapping the reference's checkpoints
    take."""
    make, back = ROUND_TRIPS[kind]
    jmod, port_cls, cfg, args = make()
    key = jax.random.PRNGKey(11)
    params = jax.tree.map(np.asarray, dict(
        jax.jit(jmod.init)({"params": key, "sample": key}, *args)["params"]))
    sd = from_jax_params(params, kind, types.SimpleNamespace(**cfg))
    port = port_cls(**cfg)
    assert set(sd) == set(port.state_dict())
    port.load_state_dict(sd)
    again = back({k: v.numpy() for k, v in sd.items()})
    assert jax.tree.structure(again) == jax.tree.structure(params)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, rtol=0, atol=1e-7),
                 again, params)
