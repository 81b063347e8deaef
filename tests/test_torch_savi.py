"""Port vs JAX: StoSAVi encode (one clip and chunked with carry), decode,
the testing forward, the weight bridge and golden group ``g_savi`` (with
its LSTM predictor).

Inputs, weights and the kernel-sampling noise (``sample_eps``) are the same
numpy arrays on both sides. Tolerance: rtol 1e-4 / atol 1e-5 for single
calls; 1e-4 abs for the encodes, whose slots pass through 3-4 recurrent
frame steps of two slot-attention rounds each; the golden keeps
tests/test_golden_parity.py's tolerances (the reference ran torch's
LayerNorm eps of 1e-5).
"""

import types

import jax
import numpy as np
import pytest
import torch

from slotformer_tpu.models.savi import StoSAVi as JaxStoSAVi
from slotformer_tpu.runtime import torch_compat as tc
from slotformer_tpu_torch.models.savi import StoSAVi
from slotformer_tpu_torch.runtime.weights import from_jax_params
from torch_port_helpers import close, golden_group, jax_init, randn, rng, state_dict, t

SEQ_ATOL = 1e-4

CFG = dict(
    resolution=(16, 16),
    slot_dict=dict(num_slots=4, slot_size=16, slot_mlp_size=32,
                   num_iterations=2, kernel_mlp=False),
    enc_dict=dict(enc_channels=(3, 8, 8), enc_ks=5, enc_out_channels=16,
                  enc_norm=""),
    dec_dict=dict(dec_channels=(16, 8, 8), dec_resolution=(4, 4), dec_ks=5,
                  dec_norm=""),
    pred_dict=dict(pred_type="mlp", pred_rnn=False, pred_norm_first=True),
    loss_dict=dict(use_post_recon_loss=True, kld_method="var-0.01"),
)


def _pair(cfg=CFG, B=2, T=3, seed=0):
    """(jax model, its random params, port model with the same weights,
    img, sample_eps)."""
    r = rng(seed)
    img = np.tanh(randn(r, B, T, *cfg["resolution"], 3))
    eps = randn(r, B, T, cfg["slot_dict"]["num_slots"],
                cfg["slot_dict"]["slot_size"])
    jmod = JaxStoSAVi(**cfg)
    params = jax_init(jmod, {"img": img, "sample_eps": eps})
    port = StoSAVi(**cfg).eval()
    port.load_state_dict(from_jax_params(
        params, "StoSAVi", types.SimpleNamespace(**cfg)))
    return jmod, params, port, img, eps


def test_encode_matches_jax():
    jmod, params, port, img, eps = _pair()
    kd, ps, _, feats, _ = jmod.apply({"params": params}, img,
                                     method="encode", sample_eps=eps)
    with torch.no_grad():
        got_kd, got_ps, got_feats, carry = port.encode(t(img), sample_eps=t(eps))
    close(got_feats, feats)
    close(got_kd, kd, atol=SEQ_ATOL)
    close(got_ps, ps, atol=SEQ_ATOL)
    assert carry[1] == () and torch.equal(carry[0], got_ps[:, -1])


def test_chunked_encode_with_carry_matches_jax():
    jmod, params, port, img, eps = _pair(T=4, seed=1)
    enc = lambda *a, **k: jmod.apply({"params": params}, *a, method="encode", **k)  # noqa: E731
    _, ps1, _, _, carry = enc(img[:, :2], sample_eps=eps[:, :2])
    _, ps2, _, _, _ = enc(img[:, 2:], carry[0], carry[1], sample_eps=eps[:, 2:])
    with torch.no_grad():
        _, got1, _, c = port.encode(t(img[:, :2]), sample_eps=t(eps[:, :2]))
        _, got2, _, _ = port.encode(t(img[:, 2:]), c[0], c[1],
                                    sample_eps=t(eps[:, 2:]))
        _, whole, _, _ = port.encode(t(img), sample_eps=t(eps))
    close(got1, ps1, atol=SEQ_ATOL)
    close(got2, ps2, atol=SEQ_ATOL)
    close(torch.cat([got1, got2], 1), whole.numpy(), atol=1e-5)


def test_transformer_predictor_deterministic_encode_matches_jax():
    cfg = dict(CFG, slot_dict=dict(CFG["slot_dict"], kernel_mlp=True),
               pred_dict=dict(pred_type="transformer", pred_rnn=False,
                              pred_num_layers=1, pred_num_heads=4,
                              pred_ffn_dim=32),
               loss_dict=dict(use_post_recon_loss=True, kld_method="none"))
    jmod, params, port, img, _ = _pair(cfg, seed=2)
    kd, ps, _, _, _ = jmod.apply({"params": params}, img, method="encode")
    with torch.no_grad():
        got_kd, got_ps, _, _ = port.encode(t(img))
    close(got_kd, kd, atol=SEQ_ATOL)
    close(got_ps, ps, atol=SEQ_ATOL)


def test_decode_and_testing_forward_match_jax():
    jmod, params, port, img, eps = _pair(seed=3)
    slots = randn(rng(4), 3, 4, 16)
    want = jmod.apply({"params": params}, slots, method="decode")
    out = jmod.apply({"params": params}, {"img": img, "sample_eps": eps},
                     testing=True)
    with torch.no_grad():
        got = port.decode(t(slots))
        got_out = port({"img": t(img), "sample_eps": t(eps)}, testing=True)
    for g, w in zip(got[:3], want[:3]):
        close(g, w)
    assert got[0].shape == (3, 16, 16, 3) and got[2].shape == (3, 4, 16, 16, 1)
    close(got_out["post_slots"], out["post_slots"], atol=SEQ_ATOL)
    close(got_out["kernel_dist"], out["kernel_dist"], atol=SEQ_ATOL)


def test_stochastic_encode_needs_noise_or_generator():
    _, _, port, img, _ = _pair(seed=5)
    with pytest.raises(ValueError, match="Generator"):
        port.encode(t(img))
    g1, g2 = torch.Generator().manual_seed(7), torch.Generator().manual_seed(7)
    with torch.no_grad():
        a = port.encode(t(img), generator=g1)[1]
        b = port.encode(t(img), generator=g2)[1]
    assert torch.equal(a, b)


def test_weight_bridge_inverts_torch_compat():
    _, params, _, _, _ = _pair(seed=6)
    sd = from_jax_params(params, "StoSAVi", types.SimpleNamespace(**CFG))
    back = tc.stosavi({k: v.numpy() for k, v in sd.items()}, n_convs=2,
                      pred_dict=CFG["pred_dict"], kernel_mlp=False, n_deconvs=2)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, rtol=0, atol=1e-7),
                 back, params)


def test_golden_g_savi():
    """The reference's StoSAVi with an LSTM-wrapped transformer predictor:
    the frame encoder, the whole 4-frame encode and the decoder."""
    sd, ins, outs = golden_group("g_savi")
    port = StoSAVi(
        resolution=(64, 64),
        slot_dict=dict(num_slots=4, slot_size=16, slot_mlp_size=32,
                       num_iterations=2, kernel_mlp=True),
        enc_dict=dict(enc_channels=(3, 8, 8), enc_ks=5, enc_norm="",
                      enc_out_channels=16),
        dec_dict=dict(dec_channels=(16, 8, 8), dec_resolution=(16, 16),
                      dec_ks=5, dec_norm=""),
        pred_dict=dict(pred_type="transformer", pred_rnn=True,
                       pred_num_layers=1, pred_num_heads=4, pred_ffn_dim=32),
        loss_dict=dict(use_post_recon_loss=True, kld_method="none"),
    ).eval()
    port.load_state_dict(state_dict(sd))

    img = np.transpose(ins["img"], (0, 1, 3, 4, 2))  # NCHW video -> NHWC
    with torch.no_grad():
        kd, ps, feats, _ = port.encode(t(img))
        rc, recons, masks, _ = port.decode(t(ins["dec_slots"]))
    close(feats, outs["encoder_out"], rtol=2e-3, atol=2e-4)
    close(kd, outs["kernel_dist"], rtol=2e-3, atol=2e-4)
    close(ps, outs["post_slots"], rtol=5e-3, atol=5e-4)
    close(rc, np.transpose(outs["recon_combined"], (0, 2, 3, 1)),
          rtol=2e-3, atol=2e-4)
    close(recons, np.transpose(outs["recons"], (0, 1, 3, 4, 2)),
          rtol=2e-3, atol=2e-4)
    close(masks, np.transpose(outs["masks"], (0, 1, 3, 4, 2)),
          rtol=2e-3, atol=2e-4)
