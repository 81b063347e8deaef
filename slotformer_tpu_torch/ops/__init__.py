"""Custom-gradient ops in plain PyTorch: the port of ``slotformer_tpu/ops``
without its Pallas kernels, whose CUDA counterparts live in ``kernels/``."""

from .frozen_decoder_loss import frozen_decoder_recon_loss

__all__ = ["frozen_decoder_recon_loss"]
