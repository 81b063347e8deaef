"""The process grid and batch placement: the port of
``slotformer_tpu/parallel/mesh.py``.

The JAX package lays its devices out as a ``('data', 'model')`` mesh inside
one program. Here each device is a process of a ``torch.distributed`` group:
``n_data x n_model`` ranks, rank ``r`` at data index ``r // n_model`` and
model index ``r % n_model`` (the JAX mesh's row-major layout). Each rank
belongs to one data group (the ranks of its model index, over which
gradients are averaged) and one model group (the ranks of its data index,
over which tensor-parallel layers reduce).

One process with no process group is the 1 x 1 grid, and no collective runs.
The backend is NCCL on CUDA devices and gloo on the CPU; gloo may be asked
for on CUDA too, for ranks that share one card (NCCL refuses two ranks on
one device). Offline inference spreads a batch over the visible cards from
one process instead (``local_devices``, ``spread_rows``).
"""

from __future__ import annotations

import copy
import datetime
import os
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclass(frozen=True)
class Grid:
    """This rank's place in an ``n_data x n_model`` process grid."""

    n_data: int = 1
    n_model: int = 1
    rank: int = 0
    device: torch.device = torch.device("cpu")
    data_group: Any = None  # None: a group of one
    model_group: Any = None

    @property
    def world_size(self) -> int:
        return self.n_data * self.n_model

    @property
    def data_rank(self) -> int:
        return self.rank // self.n_model

    @property
    def model_rank(self) -> int:
        return self.rank % self.n_model

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.n_data, MODEL_AXIS: self.n_model}

    def barrier(self) -> None:
        if self.world_size > 1:
            dist.barrier()


def default_backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_process_group(device: str = "cuda", backend: Optional[str] = None,
                       init_method: Optional[str] = None,
                       rank: Optional[int] = None,
                       world_size: Optional[int] = None,
                       timeout_s: Optional[float] = None) -> torch.device:
    """Join the process group and return this rank's device.

    Without ``init_method`` the group comes from torchrun's environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``), and a process started without it raises: it never
    carries on as one process. On CUDA the device is ``cuda:<LOCAL_RANK>``
    (``cuda:<rank>`` with an explicit ``init_method``)."""
    if init_method is None:
        missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                               "MASTER_PORT") if k not in os.environ]
        if missing:
            raise RuntimeError(
                f"no process group environment ({', '.join(missing)} unset): "
                "start data-parallel runs with torchrun --nproc_per_node=<n>")
        init_method = "env://"
        rank = int(os.environ["RANK"])
        world_size = int(os.environ["WORLD_SIZE"])
        local = int(os.environ.get("LOCAL_RANK", rank))
    else:
        local = rank
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local % max(torch.cuda.device_count(), 1))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend or default_backend(dev)
    kw = {"device_id": dev} if backend == "nccl" else {}
    if timeout_s is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, **kw)
    return dev


def get_mesh(n_model: int = 1, device=None) -> Grid:
    """The grid over the current process group (1 x 1 without one) with
    ``n_model`` ranks on the model axis. Every rank must call it, in the
    same order: it creates the groups."""
    device = torch.device(device) if device is not None else torch.device("cpu")
    if not (dist.is_available() and dist.is_initialized()):
        if n_model != 1:
            raise ValueError(f"tp_size {n_model} needs {n_model} ranks: start "
                             "the run with torchrun")
        return Grid(device=device)
    world, rank = dist.get_world_size(), dist.get_rank()
    if world % n_model:
        raise ValueError(f"world size {world} is not a multiple of tp_size "
                         f"{n_model}")
    n_data = world // n_model
    data_group = model_group = None
    for m in range(n_model):
        ranks = list(range(m, world, n_model))
        g = dist.new_group(ranks)
        if rank in ranks:
            data_group = g
    for d in range(n_data):
        ranks = list(range(d * n_model, (d + 1) * n_model))
        g = dist.new_group(ranks)
        if rank in ranks:
            model_group = g
    return Grid(n_data, n_model, rank, device, data_group, model_group)


# ------------------------------------------------------------- collectives
def data_sum(grid: Grid, x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the data group (a copy; ``x`` itself when the group
    is one rank)."""
    if grid.n_data == 1:
        return x
    x = x.detach().clone()
    dist.all_reduce(x, group=grid.data_group)
    return x


def data_mean(grid: Grid, x: torch.Tensor) -> torch.Tensor:
    """``x`` averaged over the data group, forward only (no gradient)."""
    if grid.n_data == 1:
        return x
    return data_sum(grid, x) / grid.n_data


def _flat_collective(tensors: Sequence[torch.Tensor], op: Callable) -> None:
    """``op`` on one flat buffer a dtype of ``tensors``, written back in
    place: one collective a dtype, not one a tensor."""
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        op(flat)
        torch._foreach_copy_(group, [f.view_as(t) for f, t in zip(
            flat.split([t.numel() for t in group]), group)])


def average_gradients(grid: Grid, params: Sequence[torch.Tensor]) -> None:
    """Average the ``.grad`` of ``params`` over the data group in place.
    Every rank holds a gradient for the same parameters (the same model runs
    on each)."""
    if grid.n_data == 1:
        return

    def mean(flat):
        dist.all_reduce(flat, group=grid.data_group)
        flat /= grid.n_data

    _flat_collective([p.grad for p in params if p.grad is not None], mean)


def broadcast_module(grid: Grid, module: torch.nn.Module) -> None:
    """Give every rank global rank 0's parameters (the buffers of the port's
    models are constants of the config)."""
    if grid.world_size == 1:
        return
    with torch.no_grad():
        _flat_collective([p.data for p in module.parameters()],
                         lambda flat: dist.broadcast(flat, src=0))


def gather_objects(grid: Grid, obj) -> list:
    """``obj`` of every rank of the data group, in data-rank order."""
    if grid.n_data == 1:
        return [obj]
    out = [None] * grid.n_data
    dist.all_gather_object(out, obj, group=grid.data_group)
    return out


# --------------------------------------------------------------- placement
def _rows(x) -> bool:
    return isinstance(x, (np.ndarray, torch.Tensor)) and x.ndim >= 1


def shard_batch(grid: Grid, batch: dict) -> dict:
    """This data rank's contiguous block of rows of the global ``batch``;
    entries that are not arrays (file names, scalars) are left as they are.
    The rows must divide the data axis, as the JAX batch sharding needs."""
    n, i = grid.n_data, grid.data_rank

    def take(x):
        if not _rows(x):
            return x
        if x.shape[0] % n:
            raise ValueError(f"{x.shape[0]} rows do not divide the data "
                             f"axis of {n}")
        b = x.shape[0] // n
        return x[i * b:(i + 1) * b]

    return {k: take(v) for k, v in batch.items()}


def replicate(grid: Grid, tree):
    """Every rank holds all of ``tree``: its tensors on the grid's device."""
    if isinstance(tree, dict):
        return {k: replicate(grid, v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(grid.device)
    return tree


def shard_or_replicate(grid: Grid, batch: dict) -> dict:
    """``shard_batch`` when every row count divides the data axis, else the
    whole batch on every rank (exact, without the data-parallel speed-up)."""
    if all(v.shape[0] % grid.n_data == 0 for v in batch.values() if _rows(v)):
        return shard_batch(grid, batch)
    return replicate(grid, batch)


def pad_rows(x: np.ndarray, target: int) -> np.ndarray:
    """Pad the leading dim to ``target`` by repeating the last row."""
    n = x.shape[0]
    if n >= target:
        return x
    return np.concatenate([x, np.repeat(x[-1:], target - n, axis=0)])


def pad_batch_to(batch: dict, target_bs: int):
    """Pad the batch dim up to ``target_bs`` (repeating the last sample);
    returns (batch, bool mask of the real rows)."""
    first = next(v for v in batch.values() if hasattr(v, "shape"))
    bs = first.shape[0]
    mask = np.zeros((target_bs,), dtype=bool)
    mask[:bs] = True
    if bs == target_bs:
        return batch, mask

    def pad(x):
        if hasattr(x, "shape") and getattr(x, "ndim", 0) >= 1 and x.shape[0] == bs:
            return pad_rows(x, target_bs)
        return x

    return {k: pad(v) for k, v in batch.items()}, mask


# ------------------------------------------------------ one process, N cards
def local_devices(device) -> List[torch.device]:
    """The devices one process spreads a batch over: every visible card
    when ``device`` is CUDA without an index, else ``device`` alone."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return [torch.device("cuda", i)
                for i in range(max(torch.cuda.device_count(), 1))]
    return [device]


def replicas(model: torch.nn.Module,
             devices: Sequence[torch.device]) -> List[torch.nn.Module]:
    """``model`` on ``devices[0]`` and a copy of it on each other device."""
    first = model.to(devices[0])
    return [first] + [copy.deepcopy(first).to(d) for d in devices[1:]]


class RowShard:
    """A generator that stands for a draw over the global batch: a draw of
    ``[b, ...]`` from it draws ``[b * n, ...]`` from ``generator`` and keeps
    block ``index`` of the rows. Every holder of an equal generator then
    sees the noise of the whole batch, cut into its rows."""

    def __init__(self, generator: torch.Generator, n: int, index: int):
        self.generator, self.n, self.index = generator, n, index


def randn(shape, generator, device, dtype) -> torch.Tensor:
    """``torch.randn`` from a ``torch.Generator`` or a ``RowShard``."""
    return _draw(torch.randn, shape, generator, device, dtype)


def rand(shape, generator, device, dtype) -> torch.Tensor:
    """``torch.rand`` from a ``torch.Generator`` or a ``RowShard``."""
    return _draw(torch.rand, shape, generator, device, dtype)


def _draw(fn, shape, generator, device, dtype) -> torch.Tensor:
    shape = tuple(shape)
    if not isinstance(generator, RowShard):
        return fn(shape, generator=generator, device=device, dtype=dtype)
    b = shape[0]
    full = fn((b * generator.n,) + shape[1:], generator=generator.generator,
              device=device, dtype=dtype)
    return full[generator.index * b:(generator.index + 1) * b]


def spread_rows(fn: Callable, models: Sequence[torch.nn.Module],
                rows: int) -> Any:
    """Run ``fn(i, model_i, lo, hi)`` on each replica for its block
    ``[lo, hi)`` of ``rows`` rows and concatenate the results (tensors, or
    tuples of them) in order, as numpy arrays. When the rows do not divide
    the devices, every replica runs all of them (the JAX package replicates
    such a batch) and the first one's result is kept. One replica is the
    one-card path."""
    n = len(models)
    if rows % n:
        blocks = [(0, rows)] * n
    else:
        blocks = [(i * rows // n, (i + 1) * rows // n) for i in range(n)]
    # every replica's work is enqueued before any result is read back
    outs = [fn(i, m, lo, hi) for i, (m, (lo, hi)) in enumerate(zip(models, blocks))]
    if rows % n:
        outs = outs[:1]

    def host(parts):
        return np.concatenate([p.detach().cpu().numpy() for p in parts])

    if isinstance(outs[0], tuple):
        return tuple(host(parts) for parts in zip(*outs))
    return host(outs)
