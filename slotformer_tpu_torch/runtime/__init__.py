"""Host-side runtime: params, IO and the weight bridge."""

from .io import dump_obj, load_obj, symlink_force
from .params import BaseParams, load_params

__all__ = ["BaseParams", "dump_obj", "load_obj", "load_params", "symlink_force"]
