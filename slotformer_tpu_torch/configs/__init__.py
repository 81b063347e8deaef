"""Per-task configs copied from ``slotformer_tpu/configs``; they import the
port's ``BaseParams``."""
