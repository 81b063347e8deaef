"""Multi-device training and inference: the port of
``slotformer_tpu/parallel`` (a process grid in place of the JAX mesh)."""

from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Grid,
    RowShard,
    get_mesh,
    init_process_group,
    local_devices,
    pad_batch_to,
    pad_rows,
    replicas,
    replicate,
    shard_batch,
    shard_or_replicate,
    spread_rows,
)
from .tp import (
    DEFAULT_TP_RULES,
    Split,
    full_state_dict,
    load_full_state_dict,
    param_specs,
    shard_params,
)

__all__ = [
    "DATA_AXIS", "DEFAULT_TP_RULES", "Grid", "MODEL_AXIS", "RowShard",
    "Split", "full_state_dict", "get_mesh", "init_process_group",
    "load_full_state_dict", "local_devices", "pad_batch_to", "pad_rows",
    "param_specs", "replicas", "replicate", "shard_batch",
    "shard_or_replicate", "shard_params", "spread_rows",
]
