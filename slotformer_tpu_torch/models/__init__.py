"""Models of the port and ``build_model`` keyed on ``params.model``."""

import torch

from .nn import (
    MLP,
    ConvNormAct,
    DeconvNormAct,
    LayerNorm,
    PosEnc,
    SoftPositionEmbed,
    TransformerEncoder,
    TransformerEncoderLayer,
    build_grid,
    get_sin_pos_enc,
)
from .dvae import dVAE, gumbel_softmax, make_one_hot
from .predictor import (
    ResidualMLPPredictor,
    RNNPredictorWrapper,
    TransformerPredictor,
    build_predictor,
)
from .savi import (
    FrameEncoder,
    KernelDistLayer,
    SAViCell,
    SpatialBroadcastDecoder,
    StoSAVi,
)
from .slot_attention import SlotAttention, SlotAttentionWMask
from .slotformer import SlotFormer, SlotRollouter
from .steve import STEVE
from .steve_slotformer import STEVESlotFormer
from .steve_transformer import STEVETransformerDecoder


def build_model(params, device="cuda") -> torch.nn.Module:
    """The model named by ``params.model``, on ``device``, in eval mode.

    Weights are torch's default initialization, drawn from the global RNG
    (``torch.manual_seed`` makes them reproducible); load trained weights
    with ``load_state_dict``.
    """
    name = params.model
    if name == "StoSAVi":
        model = StoSAVi(
            resolution=tuple(params.resolution),
            clip_len=params.input_frames,
            slot_dict=params.slot_dict,
            enc_dict=params.enc_dict,
            dec_dict=params.dec_dict,
            pred_dict=params.pred_dict,
            loss_dict=params.loss_dict,
        )
    elif name == "SlotFormer":
        model = SlotFormer(
            resolution=tuple(params.resolution),
            clip_len=params.get("n_sample_frames", 16),
            slot_dict=params.slot_dict,
            dec_dict=params.dec_dict,
            rollout_dict=params.rollout_dict,
            loss_dict=params.loss_dict,
        )
    elif name == "dVAE":
        model = dVAE(vocab_size=params.vocab_size, img_channels=3)
    elif name == "STEVE":
        model = STEVE(
            resolution=tuple(params.resolution),
            clip_len=params.input_frames,
            slot_dict=params.slot_dict,
            dvae_dict=params.dvae_dict,
            enc_dict=params.enc_dict,
            dec_dict=params.dec_dict,
            pred_dict=params.pred_dict,
            loss_dict=params.loss_dict,
        )
    elif name == "STEVESlotFormer":
        model = STEVESlotFormer(
            resolution=tuple(params.resolution),
            clip_len=params.get("n_sample_frames", 16),
            slot_dict=params.slot_dict,
            dvae_dict=params.dvae_dict,
            dec_dict=params.dec_dict,
            rollout_dict=params.rollout_dict,
            loss_dict=params.loss_dict,
        )
    else:
        raise NotImplementedError(f"model {name} is not ported yet")
    return model.to(device).eval()
