"""Frozen-decoder image-reconstruction loss with a hand-written backward:
the port of ``slotformer_tpu/ops/frozen_decoder_loss.py``.

SlotFormer's image loss decodes every predicted frame through the frozen
spatial-broadcast decoder. The decoder's weight gradients are dead, so the
backward needs d(loss)/d(slots) only, yet autograd of the plain decode keeps
every deconv layer's float activation for the ReLU backwards. This
``torch.autograd.Function`` computes the same loss and keeps instead:

  * one BOOL mask per deconv layer (the ReLU's sign);
  * the 1x1 head's outputs (softmax masks and rgb, 5 channels a slot image);
  * the float32 residual ``diff`` [F, 3, H, W] and the per-frame SSE;

never a layer's input. Its backward is the exact chain: d(mse) -> softmax and
compositing -> the transposed 1x1 head -> per layer (mask * the transpose of
the transposed convolution). A transposed convolution is linear in its input,
and its transpose is ``F.conv2d`` with the same weight, stride and padding,
which needs the weight only. The convolutions stay cuDNN's.

The decoder's weights are constants here: they get no gradient. ``slots``
get the exact gradient, and so do ``gt``, the frame weights ``w`` and the
normaliser ``denom`` when they ask for one. The loss side (diff, SSE, softmax
backward) runs in float32 even when the decode runs in bfloat16 (bfloat16
slots, or under autocast); the transposed-convolution chain of the backward
runs in the decode's dtype, as autograd of a bfloat16 decode would.

Supports the decoders the port builds: norm-free ``DeconvNormAct`` stacks, a
1x1 out conv, softmax-over-slots compositing.
"""

from __future__ import annotations

from typing import Union

import torch
import torch.nn.functional as F
from torch import nn


def _layers(decoder: nn.Module):
    """(the ConvTranspose2d of every deconv layer, the 1x1 out conv) of a
    ``SpatialBroadcastDecoder``."""
    *deconvs, out_conv = decoder.decoder
    convs = []
    for layer in deconvs:
        if (len(layer) != 2 or not isinstance(layer[0], nn.ConvTranspose2d)
                or not isinstance(layer[1], nn.ReLU)):
            raise NotImplementedError(
                "frozen_decoder_recon_loss supports norm-free ConvTranspose2d "
                "+ ReLU decoder layers only")
        convs.append(layer[0])
    return convs, out_conv


class _FrozenDecoderReconLoss(torch.autograd.Function):

    @staticmethod
    def forward(ctx, slots, gt, w, denom, decoder, num_slots):
        convs, out_conv = _layers(decoder)
        S, D = num_slots, slots.shape[-1]
        FS = slots.numel() // D
        n_frames = FS // S
        H0, W0 = decoder.dec_resolution
        x = slots.reshape(FS, D, 1, 1).expand(FS, D, H0, W0)
        x = decoder.decoder_pos_embedding(x)
        relu_masks = []
        for conv in convs:
            x = conv(x)
            relu_masks.append(x > 0)
            x = torch.relu_(x)
        out = out_conv(x)  # [F*S, 4, H, W]
        del x
        H, W = out.shape[-2:]
        out = out.reshape(n_frames, S, 4, H, W)
        r = out[:, :, :3]
        m = torch.softmax(out[:, :, 3], dim=1)  # over slots, [F, S, H, W]
        recon = (m.unsqueeze(2) * r).sum(dim=1)  # [F, 3, H, W]
        diff = recon.float() - gt.permute(0, 3, 1, 2).float()
        sse_f = diff.square().sum(dim=(1, 2, 3))  # [F], float32
        loss = (sse_f * w.float()).sum() / denom.float()
        ctx.save_for_backward(m, r, diff, sse_f, w, denom, *relu_masks)
        ctx.decoder = decoder
        ctx.slots_shape, ctx.slots_dtype = slots.shape, slots.dtype
        ctx.gt_dtype, ctx.compute_dtype = gt.dtype, out.dtype
        return loss

    @staticmethod
    def backward(ctx, g):
        m, r, diff, sse_f, w, denom, *relu_masks = ctx.saved_tensors
        convs, out_conv = _layers(ctx.decoder)
        n_frames, S, H, W = m.shape
        cdt = ctx.compute_dtype
        w32, den32, g32 = w.float(), denom.float(), g.float()

        # d loss / d recon = 2 * diff * w / denom, times the upstream g
        drecon = diff * (2.0 * g32 * w32 / den32)[:, None, None, None]
        # compositing: recon = sum_s m_s * r_s
        dout = torch.empty(n_frames, S, 4, H, W, dtype=torch.float32,
                           device=diff.device)
        torch.mul(m.unsqueeze(2), drecon.unsqueeze(1), out=dout[:, :, :3])
        dm = (drecon.unsqueeze(1) * r).sum(dim=2)  # [F, S, H, W]
        # softmax over slots
        dout[:, :, 3] = m * (dm - (m * dm).sum(dim=1, keepdim=True))
        del dm

        # the decode's own dtype from here on; autocast would re-cast
        with torch.autocast(diff.device.type, enabled=False):
            # transpose of the 1x1 head
            dy = F.conv_transpose2d(dout.reshape(n_frames * S, 4, H, W).to(cdt),
                                    out_conv.weight.detach().to(cdt))
            del dout
            for conv, mask in zip(reversed(convs), reversed(relu_masks)):
                dy = dy.mul_(mask)
                # transpose of the transposed convolution: the weight alone
                dy = F.conv2d(dy, conv.weight.detach().to(cdt),
                              stride=conv.stride, padding=conv.padding)
        # the position embedding is additive; the broadcast's backward sums
        # over space
        dslots = dy.sum(dim=(2, 3)).reshape(ctx.slots_shape).to(ctx.slots_dtype)

        dgt = dw = ddenom = None
        if ctx.needs_input_grad[1]:
            dgt = (-drecon).permute(0, 2, 3, 1).to(ctx.gt_dtype)
        if ctx.needs_input_grad[2]:
            dw = (g32 * sse_f / den32).to(w.dtype)
        if ctx.needs_input_grad[3]:
            ddenom = (-g32 * (sse_f * w32).sum() / den32 ** 2).to(denom.dtype)
        return dslots, dgt, dw, ddenom, None, None


def frozen_decoder_recon_loss(decoder: nn.Module, slots: torch.Tensor,
                              gt: torch.Tensor, w: torch.Tensor,
                              denom: Union[torch.Tensor, float],
                              num_slots: int) -> torch.Tensor:
    """sum_f w_f * SSE(composite(decode(slots))_f, gt_f) / denom, with the
    decoder frozen.

    ``decoder``: a ``SpatialBroadcastDecoder`` (its weights are constants:
    no gradient); ``slots`` [F, S, D]; ``gt`` [F, H, W, 3]; ``w`` [F] frame
    weights (``vid_len`` masking); ``denom``: the scalar normaliser.
    ``sum(w) * H * W * C`` gives the plain (weighted) mean; a chunked caller
    passes the global ``denom`` and sums the per-chunk losses.
    """
    denom = torch.as_tensor(denom, dtype=torch.float32, device=slots.device)
    return _FrozenDecoderReconLoss.apply(slots, gt, w, denom, decoder,
                                         num_slots)
