"""Named spans at the port's layer boundaries.

``span(name)`` marks a region in the trace of whatever ``torch.profiler``
is recording (the trainer's ``profile_steps`` window, or any profiler an
operator puts around a call): a ``record_function``, which the profiler
keeps beside the kernels on one clock and mirrors on the device's
timeline. With no profiler recording it is one shared no-op context, so a
span costs one check of the profiler's state. The spans:

  * ``step.forward``, ``step.backward``, ``step.optimizer``: the parts of
    a training step (``BaseMethod._train_step``);
  * ``slotformer.rollouter``: a rollout of ``pred_len`` steps;
  * ``slotformer.rollouter.graph``: inside it, the replay of the rollout's
    CUDA graph, where it runs as one;
  * ``slotformer.image_loss``: SlotFormer's image loss on the chunked,
    bfloat16 and custom branches;
  * ``savi.frame_step``: one frame of the temporal encode;
  * ``k1.backward``: the backward of kernel K1;
  * ``extract.load``: reading and stacking a batch of videos for
    extraction.
"""

from __future__ import annotations

from contextlib import nullcontext

import torch

_OFF = nullcontext()


def span(name: str):
    """A context that records ``name`` while a profiler is recording."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF
