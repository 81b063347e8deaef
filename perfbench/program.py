"""What the benchmark takes from the program under test: its shipped
configuration with the benchmark's values laid over it, and its models
built by its own ``build_model``."""

from __future__ import annotations

import copy

from .core import ROOT, Cell


def port_params(cell: Cell):
    """The port's shipped params of the configuration, with every value of
    the configuration file's ``params`` set over it."""
    from slotformer_tpu_torch.runtime.params import load_params

    params = load_params(str(ROOT / cell.config["port_params"]))
    for key, value in cell.config["params"].items():
        setattr(params, key, copy.deepcopy(value))
    return params


def port_model(params, device):
    from slotformer_tpu_torch.models import build_model

    return build_model(params, device=device)
