"""Start n ranks of one process group on this machine: each a fresh
process (``spawn``), meeting at a file in a temporary directory, so no port
is taken and parallel runs do not collide."""

from __future__ import annotations

import os
import tempfile
from typing import Callable, List, Optional, Sequence

import torch

from .mesh import init_process_group


def _rank_main(rank: int, fn: Callable, n: int, backend: str,
               devices: Sequence[str], workdir: str, timeout_s: float) -> None:
    import torch.distributed as dist

    args = torch.load(os.path.join(workdir, "args.pt"), weights_only=False)
    if torch.device(devices[rank]).type == "cpu":
        # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    device = init_process_group(
        devices[rank], backend, f"file://{os.path.join(workdir, 'rendezvous')}",
        rank, n, timeout_s)
    try:
        out = fn(device, *args)
        torch.save(out, os.path.join(workdir, f"result_{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, n: int, args: tuple = (), backend: str = "gloo",
          devices: Optional[Sequence[str]] = None,
          timeout_s: float = 600.0) -> List:
    """Run ``fn(device, *args)`` on ranks 0..n-1 of a new process group and
    return what each rank returned (picklable by ``torch.save``), in rank
    order. ``fn`` must be importable by name (module level). ``devices``:
    each rank's device (all ``cpu`` by default; ranks may share one card
    with ``backend='gloo'``). A rank's failure raises here; a collective
    left waiting fails after ``timeout_s``."""
    import torch.multiprocessing as mp

    devices = list(devices or ["cpu"] * n)
    with tempfile.TemporaryDirectory() as workdir:
        # the arguments go through a file: through the spawn pipe, a large
        # one holds the parent until each rank has started, one at a time
        torch.save(args, os.path.join(workdir, "args.pt"))
        mp.start_processes(_rank_main, nprocs=n, start_method="spawn",
                           args=(fn, n, backend, devices, workdir, timeout_s))
        return [torch.load(os.path.join(workdir, f"result_{r}.pt"),
                           weights_only=False) for r in range(n)]
