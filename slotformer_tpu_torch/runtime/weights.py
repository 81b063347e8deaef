"""The weight bridge between the JAX package and the port.

``from_jax_params`` turns a JAX param tree (nested dict of arrays, as
``model.init`` or a JAX checkpoint gives it) into the port's state_dict,
whose keys are the reference torch layout. It is the inverse of
``slotformer_tpu.runtime.torch_compat.stosavi`` / ``.slotformer`` (+
``savi_decoder``); the re-encodings are:

  * Dense ``kernel`` [in, out] -> Linear ``weight`` [out, in];
  * LayerNorm ``scale`` -> ``weight``;
  * Conv ``kernel`` HWIO -> OIHW, and ConvTranspose ``kernel`` [kH, kW, out,
    in] (the ``transpose_kernel=True`` storage) -> torch [in, out, kH, kW]:
    both are the axis permutation (3, 2, 0, 1);
  * flax GRUCell -> torch GRUCell: the gates stack as (r, z, n); flax keeps
    the r/z hidden biases folded into the input biases, so ``bias_hh`` gets
    zeros there (the same function);
  * flax MultiHeadDotProductAttention [D, heads, head_dim] -> the packed
    ``in_proj_weight`` / ``out_proj`` of ``nn.MultiheadAttention``;
  * buffers that carry no learned value (the coordinate grids, the frozen
    sinusoidal PE) are rebuilt from the config.

``runtime.checkpoint.load_checkpoint`` reads a reference-format
``{'state_dict': ...}`` file.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

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


def _stosavi(tree: dict, cfg) -> StateDict:
    sd: StateDict = {"init_latents": _t(tree["init_latents"])}
    enc = tree["encoder"]
    for i in range(sum(k.startswith("conv_") for k in enc)):
        _conv_block(sd, f"encoder.{i}", enc[f"conv_{i}"])
    _linear(sd, "encoder_pos_embedding.dense", enc["pos_embedding"]["dense"])
    stride0 = 2 if cfg.resolution[0] == 128 else 1
    sd["encoder_pos_embedding.grid"] = _t(build_grid(
        (cfg.resolution[0] // stride0, cfg.resolution[1] // stride0)))
    _norm(sd, "encoder_out_layer.0", enc["out_ln"])
    _linear(sd, "encoder_out_layer.1", enc["out_0"])
    _linear(sd, "encoder_out_layer.3", enc["out_1"])

    cell = tree["cell"]
    _slot_attention(sd, "slot_attention", cell["slot_attention"])
    kd = cell["kernel_dist_layer"]
    _linear(sd, "kernel_dist_layer.0", kd["Dense_0"])
    if "LayerNorm_0" in kd:
        _norm(sd, "kernel_dist_layer.1", kd["LayerNorm_0"])
        _linear(sd, "kernel_dist_layer.3", kd["Dense_1"])
    if "predictor" in cell:
        raise NotImplementedError("pred_rnn=True is not ported yet")
    pred = cell["predictor_base"]
    if "ln" in pred:
        _norm(sd, "predictor.ln", pred["ln"])
        for i in range(len(pred["mlp"])):
            _linear(sd, f"predictor.mlp.{2 * i}", pred["mlp"][f"Dense_{i}"])
    else:
        _transformer_encoder(sd, "predictor.transformer_encoder",
                             pred["transformer_encoder"])
    _decoder(sd, tree["decoder"], cfg)
    return sd


def _slotformer(tree: dict, cfg) -> StateDict:
    sd: StateDict = {}
    ro, rd = tree["rollouter"], cfg.rollout_dict
    _linear(sd, "rollouter.in_proj", ro["in_proj"])
    _linear(sd, "rollouter.out_proj", ro["out_proj"])
    _transformer_encoder(sd, "rollouter.transformer_encoder",
                         ro["transformer_encoder"])
    for name, kind, length in (
            ("enc_t_pe", rd.get("t_pe", "sin"), rd["history_len"]),
            ("enc_slots_pe", rd.get("slots_pe", ""), rd["num_slots"])):
        if kind:
            sd[f"rollouter.{name}"] = get_sin_pos_enc(
                length, rd.get("d_model", 128))
    _decoder(sd, tree["decoder"], cfg)
    return sd


def from_jax_params(tree: dict, model_kind: str, cfg) -> StateDict:
    """A JAX param tree of ``model_kind`` ('StoSAVi' or 'SlotFormer', built
    from the config ``cfg``) as the port's reference-layout state_dict."""
    if model_kind == "StoSAVi":
        return _stosavi(tree, cfg)
    if model_kind == "SlotFormer":
        return _slotformer(tree, cfg)
    raise NotImplementedError(f"model {model_kind} is not ported yet")
