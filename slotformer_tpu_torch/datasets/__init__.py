"""Datasets of the port; ``build_dataset`` dispatches on ``params.dataset``
and returns (train, val), or val alone with ``val_only``. Physion names
carry their subset as a suffix (``physion_training``,
``physion_slots_readout``)."""

from .clevrer import (
    CLEVRERDataset,
    CLEVRERSlotsDataset,
    build_clevrer_dataset,
    build_clevrer_slots_dataset,
)
from .physion import (
    PhysionDataset,
    PhysionSlotsDataset,
    build_physion_dataset,
    build_physion_slots_dataset,
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
             "synthetic_slots": build_synthetic_slots_dataset,
             "physion": build_physion_dataset,
             "physion_slots": build_physion_slots_dataset}


def build_dataset(params, val_only=False):
    name = params.dataset
    if name.startswith("physion"):
        name = name[:name.rindex("_")]  # 'physion_xxx_<subset>'
    if name not in _BUILDERS:
        raise NotImplementedError(
            f"dataset {params.dataset!r} is not ported yet "
            f"(ported: {sorted(_BUILDERS)})")
    return _BUILDERS[name](params, val_only=val_only)
