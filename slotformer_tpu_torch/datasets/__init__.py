"""Datasets of the port; ``build_dataset`` dispatches on ``params.dataset``
and returns (train, val), or val alone with ``val_only``."""

from .clevrer import (
    CLEVRERDataset,
    CLEVRERSlotsDataset,
    build_clevrer_dataset,
    build_clevrer_slots_dataset,
)
from .synthetic import (
    SyntheticSlotsDataset,
    SyntheticVideoDataset,
    build_synthetic_dataset,
    build_synthetic_slots_dataset,
)

_BUILDERS = {"clevrer": build_clevrer_dataset,
             "clevrer_slots": build_clevrer_slots_dataset,
             "synthetic": build_synthetic_dataset,
             "synthetic_slots": build_synthetic_slots_dataset}


def build_dataset(params, val_only=False):
    if params.dataset not in _BUILDERS:
        raise NotImplementedError(
            f"dataset {params.dataset!r} is not ported yet "
            f"(ported: {sorted(_BUILDERS)})")
    return _BUILDERS[params.dataset](params, val_only=val_only)
