"""Datasets of the port; ``build_dataset`` dispatches on ``params.dataset``
and returns (train, val), or val alone with ``val_only``."""

from .clevrer import CLEVRERDataset, build_clevrer_dataset
from .synthetic import SyntheticVideoDataset, build_synthetic_dataset

_BUILDERS = {"clevrer": build_clevrer_dataset,
             "synthetic": build_synthetic_dataset}


def build_dataset(params, val_only=False):
    if params.dataset not in _BUILDERS:
        raise NotImplementedError(
            f"dataset {params.dataset!r} is not ported yet "
            f"(ported: {sorted(_BUILDERS)})")
    return _BUILDERS[params.dataset](params, val_only=val_only)
