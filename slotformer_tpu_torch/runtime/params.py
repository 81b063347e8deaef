"""Config/params system: a copy of ``slotformer_tpu/runtime/params.py``.

Configs are plain Python classes: declarative, diff-able, and importable by
file path. ``load_params`` imports a config ``.py`` file and instantiates the
``SlotFormerParams`` class found inside, the workflow of the reference CLI.
"""

from __future__ import annotations

import copy
import importlib.util
import os
import sys
from typing import Any


class BaseParams:
    """Base class for experiment params.

    Subclasses declare settings as class attributes. Instances get deep
    copies so that CLI-time mutation never leaks across instances.
    """

    project = "SlotFormer-TPU"

    def __init__(self, **overrides: Any):
        for k in dir(type(self)):
            if k.startswith("__"):
                continue
            v = getattr(type(self), k)
            if callable(v):
                continue
            object.__setattr__(self, k, copy.deepcopy(v))
        for k, v in overrides.items():
            setattr(self, k, v)

    def get(self, key: str, default: Any = None) -> Any:
        return getattr(self, key, default)

    def has(self, key: str) -> bool:
        return hasattr(self, key)

    def to_dict(self) -> dict:
        return {
            k: v
            for k, v in vars(self).items()
            if not k.startswith("__") and not callable(v)
        }

    def loss_weights(self) -> dict:
        """All ``*_loss_w`` entries, keyed by loss name."""
        out = {}
        for k, v in self.to_dict().items():
            if k.endswith("_loss_w"):
                out[k[: -len("_w")]] = float(v)
        return out

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        body = ",\n  ".join(f"{k}={v!r}" for k, v in sorted(self.to_dict().items()))
        return f"{type(self).__name__}(\n  {body}\n)"


def load_params(config_path: str, cls_name: str = "SlotFormerParams") -> BaseParams:
    """Import a config ``.py`` by path and instantiate its params class."""
    config_path = os.path.abspath(config_path)
    if not os.path.isfile(config_path):
        raise FileNotFoundError(config_path)
    mod_name = ("slotformer_tpu_torch._cfg_"
                + os.path.splitext(os.path.basename(config_path))[0])
    spec = importlib.util.spec_from_file_location(mod_name, config_path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = module
    spec.loader.exec_module(module)
    params_cls = getattr(module, cls_name)
    return params_cls()
