"""The weight bridge between the JAX package and the port.

``from_jax_params`` turns a JAX param tree (nested dict of arrays, as
``model.init`` or a JAX checkpoint gives it) into the port's state_dict,
whose keys are the reference torch layout. It is the inverse of
``slotformer_tpu.runtime.torch_compat.stosavi`` / ``.slotformer`` (+
``savi_decoder``) / ``.dvae`` / ``.steve`` / ``.steve_slotformer`` (+
``savi_cell`` with an LSTM predictor) / ``.aloe`` / ``.phyre_readout`` /
``.physion_readout``; the re-encodings are:

  * Dense ``kernel`` [in, out] -> Linear ``weight`` [out, in];
  * LayerNorm ``scale`` -> ``weight``;
  * Conv ``kernel`` HWIO -> OIHW, and ConvTranspose ``kernel`` [kH, kW, out,
    in] (the ``transpose_kernel=True`` storage) -> torch [in, out, kH, kW]:
    both are the axis permutation (3, 2, 0, 1);
  * flax GRUCell -> torch GRUCell: the gates stack as (r, z, n); flax keeps
    the r/z hidden biases folded into the input biases, so ``bias_hh`` gets
    zeros there (the same function);
  * flax OptimizedLSTMCell -> one-layer ``nn.LSTM``: the gates stack as
    (i, f, g, o); flax keeps one bias per gate on the hidden side, so it
    becomes ``bias_ih_l0`` and ``bias_hh_l0`` gets zeros (the same
    function);
  * flax MultiHeadDotProductAttention [D, heads, head_dim] -> the packed
    ``in_proj_weight`` / ``out_proj`` of ``nn.MultiheadAttention``;
  * GroupNorm ``scale`` -> the dVAE block's own ``weight``; Embed
    ``embedding`` -> ``weight``;
  * the JAX STEVESlotFormer's ``trans_decoder`` -> the reference's
    ``decoder``;
  * buffers that carry no learned value (the coordinate grids, the frozen
    sinusoidal PE, the token decoder's causal masks, Aloe's fixed tag
    tokens, PhysionReadout's slot pairs, constants in JAX) are rebuilt from
    the config or the tree's shapes.

``runtime.checkpoint.load_checkpoint`` reads a reference-format
``{'state_dict': ...}`` file.
"""

from __future__ import annotations

from itertools import combinations
from typing import Dict

import numpy as np
import torch

from ..models.aloe import TAG_TOKENS
from ..models.nn import build_grid, get_sin_pos_enc

StateDict = Dict[str, torch.Tensor]


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32))  # a writable copy


def _linear(sd: StateDict, prefix: str, tree: dict) -> None:
    sd[f"{prefix}.weight"] = _t(np.asarray(tree["kernel"]).T)
    if "bias" in tree:
        sd[f"{prefix}.bias"] = _t(tree["bias"])


def _norm(sd: StateDict, prefix: str, tree: dict) -> None:
    sd[f"{prefix}.weight"] = _t(tree["scale"])
    sd[f"{prefix}.bias"] = _t(tree["bias"])


def _conv(sd: StateDict, prefix: str, tree: dict) -> None:
    sd[f"{prefix}.weight"] = _t(np.transpose(np.asarray(tree["kernel"]),
                                             (3, 2, 0, 1)))
    sd[f"{prefix}.bias"] = _t(tree["bias"])


def _gru(sd: StateDict, prefix: str, tree: dict) -> None:
    kern = {g: np.asarray(tree[g]["kernel"]).T for g in tree}
    D = kern["hn"].shape[0]
    sd[f"{prefix}.weight_ih"] = _t(np.concatenate([kern[g] for g in ("ir", "iz", "in")]))
    sd[f"{prefix}.weight_hh"] = _t(np.concatenate([kern[g] for g in ("hr", "hz", "hn")]))
    sd[f"{prefix}.bias_ih"] = _t(np.concatenate(
        [np.asarray(tree[g]["bias"]) for g in ("ir", "iz", "in")]))
    sd[f"{prefix}.bias_hh"] = _t(np.concatenate(
        [np.zeros(2 * D, np.float32), np.asarray(tree["hn"]["bias"])]))


def _mha(sd: StateDict, prefix: str, tree: dict) -> None:
    D = np.asarray(tree["query"]["kernel"]).shape[0]
    qkv = ("query", "key", "value")
    sd[f"{prefix}.in_proj_weight"] = _t(np.concatenate(
        [np.asarray(tree[n]["kernel"]).reshape(D, -1).T for n in qkv]))
    sd[f"{prefix}.in_proj_bias"] = _t(np.concatenate(
        [np.asarray(tree[n]["bias"]).reshape(-1) for n in qkv]))
    sd[f"{prefix}.out_proj.weight"] = _t(
        np.asarray(tree["out"]["kernel"]).reshape(-1, D).T)
    sd[f"{prefix}.out_proj.bias"] = _t(tree["out"]["bias"])


def _transformer_encoder(sd: StateDict, prefix: str, tree: dict) -> None:
    for i in range(len(tree)):
        layer, p = tree[f"layer_{i}"], f"{prefix}.layers.{i}"
        _mha(sd, f"{p}.self_attn", layer["self_attn"])
        _linear(sd, f"{p}.linear1", layer["linear1"])
        _linear(sd, f"{p}.linear2", layer["linear2"])
        _norm(sd, f"{p}.norm1", layer["norm1"])
        _norm(sd, f"{p}.norm2", layer["norm2"])


def _slot_attention(sd: StateDict, prefix: str, tree: dict) -> None:
    _norm(sd, f"{prefix}.norm_inputs", tree["norm_inputs"])
    _norm(sd, f"{prefix}.project_q.0", tree["project_q_norm"])
    _linear(sd, f"{prefix}.project_q.1", tree["project_q"])
    _linear(sd, f"{prefix}.project_k", tree["project_k"])
    _linear(sd, f"{prefix}.project_v", tree["project_v"])
    _gru(sd, f"{prefix}.gru", tree["gru"])
    _norm(sd, f"{prefix}.mlp.0", tree["mlp_norm"])
    _linear(sd, f"{prefix}.mlp.1", tree["mlp_hidden"])
    _linear(sd, f"{prefix}.mlp.3", tree["mlp_out"])


def _conv_block(sd: StateDict, prefix: str, tree: dict) -> None:
    """A ConvNormAct/DeconvNormAct: the conv at ``.0``."""
    _conv(sd, f"{prefix}.0", tree.get("Conv_0", tree.get("ConvTranspose_0")))


def _decoder(sd: StateDict, tree: dict, cfg) -> None:
    n = sum(k.startswith("deconv_") for k in tree)
    for i in range(n):
        _conv_block(sd, f"decoder.{i}", tree[f"deconv_{i}"])
    _conv(sd, f"decoder.{n}", tree["out_conv"])
    _linear(sd, "decoder_pos_embedding.dense", tree["pos_embedding"]["dense"])
    dec_res = tuple((cfg.dec_dict or {}).get("dec_resolution", (8, 8)))
    sd["decoder_pos_embedding.grid"] = _t(build_grid(dec_res))


def _lstm(sd: StateDict, prefix: str, tree: dict) -> None:
    gates = "ifgo"
    sd[f"{prefix}.weight_ih_l0"] = _t(np.concatenate(
        [np.asarray(tree[f"i{g}"]["kernel"]).T for g in gates]))
    sd[f"{prefix}.weight_hh_l0"] = _t(np.concatenate(
        [np.asarray(tree[f"h{g}"]["kernel"]).T for g in gates]))
    bias = np.concatenate([np.asarray(tree[f"h{g}"]["bias"]) for g in gates])
    sd[f"{prefix}.bias_ih_l0"] = _t(bias)
    sd[f"{prefix}.bias_hh_l0"] = _t(np.zeros_like(bias))


def _frame_encoder(sd: StateDict, enc: dict, cfg) -> None:
    for i in range(sum(k.startswith("conv_") for k in enc)):
        _conv_block(sd, f"encoder.{i}", enc[f"conv_{i}"])
    _linear(sd, "encoder_pos_embedding.dense", enc["pos_embedding"]["dense"])
    stride0 = 2 if cfg.resolution[0] == 128 else 1
    sd["encoder_pos_embedding.grid"] = _t(build_grid(
        (cfg.resolution[0] // stride0, cfg.resolution[1] // stride0)))
    _norm(sd, "encoder_out_layer.0", enc["out_ln"])
    _linear(sd, "encoder_out_layer.1", enc["out_0"])
    _linear(sd, "encoder_out_layer.3", enc["out_1"])


def _cell(sd: StateDict, cell: dict) -> None:
    """SAViCell: slot attention, the kernel head (StoSAVi) and the predictor,
    LSTM-wrapped (``predictor.base_predictor.*``) or not (``predictor.*``)."""
    _slot_attention(sd, "slot_attention", cell["slot_attention"])
    kd = cell.get("kernel_dist_layer")
    if kd is not None:
        _linear(sd, "kernel_dist_layer.0", kd["Dense_0"])
        if "LayerNorm_0" in kd:
            _norm(sd, "kernel_dist_layer.1", kd["LayerNorm_0"])
            _linear(sd, "kernel_dist_layer.3", kd["Dense_1"])
    base = "predictor"
    if "predictor" in cell:
        _lstm(sd, "predictor.rnn", cell["predictor"]["rnn"])
        _linear(sd, "predictor.out_projector",
                cell["predictor"]["out_projector"])
        base = "predictor.base_predictor"
    pred = cell["predictor_base"]
    if "ln" in pred:
        _norm(sd, f"{base}.ln", pred["ln"])
        for i in range(len(pred["mlp"])):
            _linear(sd, f"{base}.mlp.{2 * i}", pred["mlp"][f"Dense_{i}"])
    else:
        _transformer_encoder(sd, f"{base}.transformer_encoder",
                             pred["transformer_encoder"])


def _dvae_block(sd: StateDict, prefix: str, tree: dict) -> None:
    sd[f"{prefix}.m.weight"] = _t(np.transpose(
        np.asarray(tree["Conv_0"]["kernel"]), (3, 2, 0, 1)))
    _norm(sd, prefix, tree["GroupNorm_0"])


def _dvae(sd: StateDict, prefix: str, tree: dict) -> None:
    """The dVAE; the decoder's Sequential indices skip the PixelShuffles."""
    for i in range(7):
        _dvae_block(sd, f"{prefix}encoder.{i}", tree[f"enc_{i}"])
    _conv(sd, f"{prefix}encoder.7", tree["enc_out"])
    for j, i in enumerate((0, 1, 2, 3, 4, 6, 7, 8, 9)):
        _dvae_block(sd, f"{prefix}decoder.{i}", tree[f"dec_{j}"])
    _conv(sd, f"{prefix}decoder.11", tree["dec_out"])


def _token_decoder(sd: StateDict, prefix: str, tree: dict) -> None:
    """STEVETransformerDecoder; its causal-mask buffers from ``pe``'s length."""
    _linear(sd, f"{prefix}.in_proj", tree["in_proj"])
    sd[f"{prefix}.tok_emb.weight"] = _t(tree["tok_emb"]["embedding"])
    sd[f"{prefix}.pos_emb.pe"] = _t(tree["pos_emb"]["pe"])
    L = np.asarray(tree["pos_emb"]["pe"]).shape[1]
    for i in range(sum(k.startswith("block_") for k in tree)):
        blk, p = tree[f"block_{i}"], f"{prefix}.tf_dec.blocks.{i}"
        for ours, theirs in (("self_attn", "self_attn"),
                             ("encoder_decoder_attn", "cross_attn")):
            for n in "qkvo":
                _linear(sd, f"{p}.{ours}.proj_{n}", blk[theirs][f"proj_{n}"])
        _norm(sd, f"{p}.self_attn_layer_norm", blk["self_attn_ln"])
        _norm(sd, f"{p}.encoder_decoder_attn_layer_norm", blk["cross_ln"])
        _norm(sd, f"{p}.ffn_layer_norm", blk["ffn_ln"])
        _linear(sd, f"{p}.ffn.0", blk["ffn"]["fc1"])
        _linear(sd, f"{p}.ffn.2", blk["ffn"]["fc2"])
        sd[f"{p}.self_attn_mask"] = torch.ones(L, L, dtype=torch.bool).triu(1)
    _norm(sd, f"{prefix}.tf_dec.layer_norm", tree["final_ln"])
    _linear(sd, f"{prefix}.head", tree["head"])


def _pos_enc(sd: StateDict, key: str, tree: dict, name: str, kind: str,
             length: int, d_model: int) -> None:
    """A PosEnc table: learned (from the tree) or the frozen sinusoid."""
    if kind == "learnable":
        sd[key] = _t(tree[name]["pos_embedding"])
    elif kind:
        sd[key] = get_sin_pos_enc(length, d_model)


def _rollouter(sd: StateDict, tree: dict, rd: dict) -> None:
    """SlotRollouter, or SingleStepSlotRollouter (``cond_len`` in ``rd``:
    its temporal PE spans the context)."""
    _linear(sd, "rollouter.in_proj", tree["in_proj"])
    _linear(sd, "rollouter.out_proj", tree["out_proj"])
    _transformer_encoder(sd, "rollouter.transformer_encoder",
                         tree["transformer_encoder"])
    d_model = rd.get("d_model", 128)
    for name, kind, length in (
            ("enc_t_pe", rd.get("t_pe", "sin"),
             rd.get("cond_len", rd["history_len"])),
            ("enc_slots_pe", rd.get("slots_pe", ""), rd["num_slots"])):
        _pos_enc(sd, f"rollouter.{name}", tree, name, kind, length, d_model)


def _stosavi(tree: dict, cfg) -> StateDict:
    sd: StateDict = {"init_latents": _t(tree["init_latents"])}
    _frame_encoder(sd, tree["encoder"], cfg)
    _cell(sd, tree["cell"])
    _decoder(sd, tree["decoder"], cfg)
    return sd


def _slotformer(tree: dict, cfg) -> StateDict:
    sd: StateDict = {}
    _rollouter(sd, tree["rollouter"], cfg.rollout_dict)
    _decoder(sd, tree["decoder"], cfg)
    return sd


def _steve(tree: dict, cfg) -> StateDict:
    sd: StateDict = {"init_latents": _t(tree["init_latents"])}
    _frame_encoder(sd, tree["encoder"], cfg)
    _cell(sd, tree["cell"])
    _dvae(sd, "dvae.", tree["dvae"])
    _token_decoder(sd, "trans_decoder", tree["trans_decoder"])
    return sd


def _steve_slotformer(tree: dict, cfg) -> StateDict:
    sd: StateDict = {}
    _rollouter(sd, tree["rollouter"], cfg.rollout_dict)
    _dvae(sd, "dvae.", tree["dvae"])
    _token_decoder(sd, "decoder", tree["trans_decoder"])
    return sd


def _dvae_model(tree: dict, cfg) -> StateDict:
    sd: StateDict = {}
    _dvae(sd, "", tree)
    return sd


def _aloe(tree: dict, cfg) -> StateDict:
    tm, p = tree["transformer_model"], "transformer_model"
    sd: StateDict = {
        f"{p}.q_embedding.weight": _t(tm["q_embedding"]["embedding"]),
        f"{p}.CLS": _t(tm["CLS"]),
        f"{p}.transformer_encoder.pos_enc": _t(tm["pos_enc"]["pos_embedding"]),
    }
    _linear(sd, f"{p}.q_in_proj", tm["q_in_proj"])
    _linear(sd, f"{p}.vision_in_proj", tm["vision_in_proj"])
    _transformer_encoder(sd, f"{p}.transformer_encoder.transformer_encoder",
                         tm["transformer_encoder"])
    for head in ("cls_answer", "mc_answer"):
        _linear(sd, f"{p}.{head}_mlp.0", tm[f"{head}_0"])
        _linear(sd, f"{p}.{head}_mlp.2", tm[f"{head}_1"])
    for name, tag in TAG_TOKENS.items():
        sd[f"{p}.{name}"] = torch.tensor(tag)
    return sd


def _phyre_readout(tree: dict, cfg) -> StateDict:
    rd = cfg.readout_dict
    sd: StateDict = {"CLS": _t(tree["CLS"])}
    _linear(sd, "in_proj", tree["in_proj"])
    _transformer_encoder(sd, "transformer_encoder", tree["transformer_encoder"])
    _linear(sd, "cls_mlp.0", tree["cls_mlp_0"])
    _linear(sd, "cls_mlp.2", tree["cls_mlp_1"])
    _pos_enc(sd, "enc_t_pe", tree, "enc_t_pe", rd.get("t_pe", "sin"),
             len(rd.get("sel_slots", (0, 3))), rd.get("d_model", 128))
    return sd


def _physion_readout(tree: dict, cfg) -> StateDict:
    n = cfg.readout_dict.get("num_slots", 6)
    sd: StateDict = {"comb_idx": torch.tensor(
        list(combinations(range(n), 2)), dtype=torch.int64).reshape(-1)}
    _linear(sd, "linear1", tree["linear1"])
    _linear(sd, "linear2", tree["linear2"])
    return sd


_KINDS = {"StoSAVi": _stosavi, "SlotFormer": _slotformer,
          "SingleStepSlotFormer": _slotformer, "dVAE": _dvae_model,
          "STEVE": _steve, "STEVESlotFormer": _steve_slotformer,
          "CLEVRERAloe": _aloe, "PHYREReadout": _phyre_readout,
          "PhysionReadout": _physion_readout}


def from_jax_params(tree: dict, model_kind: str, cfg) -> StateDict:
    """A JAX param tree of ``model_kind`` (a key of ``_KINDS``: 'StoSAVi',
    'SlotFormer', 'SingleStepSlotFormer', 'dVAE', 'STEVE',
    'STEVESlotFormer', 'CLEVRERAloe', 'PHYREReadout' or 'PhysionReadout',
    built from the config ``cfg``) as the port's reference-layout
    state_dict."""
    if model_kind not in _KINDS:
        raise NotImplementedError(f"model {model_kind} is not ported yet")
    return _KINDS[model_kind](tree, cfg)
