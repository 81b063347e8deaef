"""Hand-written CUDA kernels for Hopper, the counterparts of ``slotformer_tpu/ops``.

Each kernel module holds the wrapper, its plain PyTorch version and a launch
counter; ``build`` compiles ``csrc/`` on first use.

``slot_attention_update`` here is the function (the entry point, as
``slotformer_tpu.ops.slot_attention_update`` is in the JAX package); its
module, with ``LAUNCHES``, is
``importlib.import_module("slotformer_tpu_torch.kernels.slot_attention_update")``.
"""

from .slot_attention_update import slot_attention_update

__all__ = ["slot_attention_update"]
