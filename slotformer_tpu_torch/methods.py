"""Per-model training methods and ``build_method``: the port of
``slotformer_tpu/methods.py`` for the models the port trains (StoSAVi, SAVi).
"""

from __future__ import annotations

from .runtime.method import BaseMethod


class SAViMethod(BaseMethod):
    """StoSAVi / SAVi training (reference base_slots/method.py:99-162). The
    reference's per-slot video grids (``_sample_video``) wait for
    ``metrics/vis.py``."""


_METHODS = {"StoSAVi": SAViMethod, "SAVi": SAViMethod}


def build_method(model=None, datamodule=None, params=None, ckp_path="",
                 local_rank=0, use_ddp=False, use_fp16=False, **kw):
    """The trainer of ``params.model`` (reference signature,
    scripts/train.py:65-73)."""
    cls = _METHODS.get(params.model)
    if cls is None:
        raise NotImplementedError(
            f"training {params.model} is not ported yet (ported: "
            f"{sorted(_METHODS)})")
    return cls(model=model, datamodule=datamodule, params=params,
               ckp_path=ckp_path, local_rank=local_rank, use_ddp=use_ddp,
               use_fp16=use_fp16, **kw)
