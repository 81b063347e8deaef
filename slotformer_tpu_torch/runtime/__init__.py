"""Host-side runtime: params, IO, checkpoints, the data pipeline, the
optimizer stack and the trainer."""

from .checkpoint import graft, latest_checkpoint, load_checkpoint, save_checkpoint
from .datamodule import BaseDataModule, DataLoader, Dataset, default_collate
from .io import (
    dump_obj,
    glob_all,
    load_obj,
    mkdir_or_exist,
    read_all_lines,
    read_img,
    save_img,
    save_video,
    VideoReader,
    strip_suffix,
    symlink_force,
)
from .meters import AverageMeter, MeanMetric, MeterBank
from .method import BaseMethod
from .params import BaseParams, load_params
from .schedules import (
    ScheduledOptimizer,
    build_optimizer,
    cosine_anneal,
    cosine_annealing_warmup,
)

__all__ = [
    "AverageMeter", "BaseDataModule", "BaseMethod", "BaseParams", "DataLoader",
    "Dataset", "MeanMetric", "MeterBank", "ScheduledOptimizer",
    "build_optimizer", "cosine_anneal", "cosine_annealing_warmup",
    "default_collate", "dump_obj", "glob_all", "graft", "latest_checkpoint",
    "load_checkpoint", "load_obj", "load_params", "mkdir_or_exist",
    "read_all_lines", "read_img", "save_checkpoint", "save_img",
    "save_video", "strip_suffix", "symlink_force", "VideoReader",
]
