"""Entry points: the port of ``__graft_entry__.py``.

``entry()``              - the flagship forward (SlotFormer rollout + decode
                           at the CLEVRER width), on the card.
``dryrun_multichip(n)``  - n ranks of one process group run ONE full training
                           step of a tiny SlotFormer through the trainer (the
                           optimizer update included): the global batch
                           sharded over the data axis, the transformer
                           layers tensor-parallel over a 2-wide model axis
                           when n >= 4 is even. Each rank asserts that the
                           model axis is physical (a local ``linear1``
                           weight holds 1/n_model of the rows) and that the
                           parameters after the step are within 1e-4 of one
                           process's on the same global batch.

``step_against_one_process`` is that check for any config and batches; the
tests and ``chip_smoke.py`` run it through ``run_cases`` on spawned ranks.
"""

from __future__ import annotations

import copy
import os
import time
import types
from typing import List, Optional, Sequence

import numpy as np
import torch

from .parallel.launch import spawn
from .parallel.mesh import Grid, get_mesh, shard_or_replicate
from .parallel.tp import full_optimizer_state
from .runtime.params import BaseParams

PARAM_ATOL = 1e-4  # the parameters after a step, against one process


def flagship_params(tiny: bool = False, **over) -> BaseParams:
    """The CLEVRER SlotFormer (reference slotformer_clevrer_params.py), or
    the tiny one of the dryrun; ``over`` sets any entry."""
    if tiny:
        cfg = dict(
            resolution=(16, 16), n_sample_frames=6, input_frames=3,
            slot_dict=dict(num_slots=4, slot_size=16),
            dec_dict=dict(dec_channels=(16, 8), dec_resolution=(16, 16),
                          dec_ks=3),
            rollout_dict=dict(num_slots=4, slot_size=16, history_len=3,
                              t_pe="sin", d_model=16, num_layers=1,
                              num_heads=2, ffn_dim=32, dropout=0.0),
            loss_dict=dict(rollout_len=3, use_img_recon_loss=True))
    else:
        cfg = dict(
            resolution=(64, 64), n_sample_frames=16, input_frames=6,
            slot_dict=dict(num_slots=7, slot_size=128),
            dec_dict=dict(dec_channels=(128, 64, 64, 64, 64),
                          dec_resolution=(8, 8), dec_ks=5),
            rollout_dict=dict(num_slots=7, slot_size=128, history_len=6,
                              t_pe="sin", slots_pe="", d_model=256,
                              num_layers=4, num_heads=8, ffn_dim=1024,
                              norm_first=True),
            loss_dict=dict(rollout_len=10, use_img_recon_loss=True))
    cfg.update(model="SlotFormer", optimizer="Adam", lr=1e-3,
               warmup_steps_pct=0.1, clip_grad=0.05, max_epochs=1,
               slot_recon_loss_w=1.0, img_recon_loss_w=1.0, seed=0)
    cfg.update(over)
    return BaseParams(**cfg)


def entry(device: str = "cuda"):
    """(fn, args): the flagship forward, ``fn(*args)`` = rollout of 10
    frames from 6 and the decode of all 16, at B=2."""
    from .models import build_model

    params = flagship_params()
    torch.manual_seed(0)
    model = build_model(params, device=device)
    batch = {
        "slots": torch.from_numpy(np.random.RandomState(0).randn(
            2, 16, 7, 128).astype(np.float32)).to(device),
        "img": torch.zeros(2, 16, 64, 64, 3, device=device),
    }

    @torch.no_grad()
    def fn(batch):
        return model(batch)

    return fn, (batch,)


class _Batches(list):
    """Stands for a train loader of ``n`` global batches of ``batch_size``."""

    def __init__(self, n: int, batch_size: int):
        super().__init__([None] * n)
        self.batch_size = batch_size


class _Rows:
    """The rows of a numpy batch as a dataset."""

    def __init__(self, batch: dict):
        self.batch = batch

    def __len__(self):
        return len(next(iter(self.batch.values())))

    def __getitem__(self, i):
        return {k: v[i] for k, v in self.batch.items()}


def _method(params, model, grid, steps, rows, ckp_path="", val=None):
    from .methods import build_method
    from .runtime.datamodule import DataLoader

    loader = None if val is None else DataLoader(
        _Rows(val), int(params.get("val_batch_size", rows)), num_workers=0,
        shard=(grid.n_data, grid.data_rank))
    dm = types.SimpleNamespace(train_loader=_Batches(steps, rows),
                               val_loader=loader)
    return build_method(model=model, datamodule=dm, params=params,
                        ckp_path=ckp_path, grid=grid)


def _max_diff(a: dict, b: dict) -> float:
    return max(float((a[k].float() - b[k].float().to(a[k].device)).abs().max())
               if a[k].numel() else 0.0 for k in b)


def _state_equal(a, b) -> bool:
    """Tensors (and the numbers beside them) of two nested states equal."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_state_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_state_equal(x, y) for x, y in zip(a, b))
    if torch.is_tensor(a):
        return torch.equal(a.cpu(), b.cpu())
    return a == b


def step_against_one_process(device, params: BaseParams,
                             batches: Sequence[dict],
                             ckp_dir: Optional[str] = None,
                             count_launches: bool = False,
                             val: Optional[dict] = None) -> dict:
    """One rank's part: the trainer's steps on ``batches`` (global numpy
    batches, one a loader step) over the grid of the current process group
    with ``params.tp_size`` model ranks, and on rank 0 the same steps in one
    process from the same init. Returns rank 0's comparison (every loss,
    ``grad_norm``, every parameter), the TP layout of a ``linear1`` weight,
    the step's seconds; with ``val`` (a global numpy batch, its rows the val
    set, in loader batches of ``val_batch_size``) the validation averages
    after the steps; with ``ckp_dir``, whether a checkpoint written on the
    grid loads in one process with equal tensors (parameters and Adam
    moments) and one written by one process loads on the grid."""
    from .kernels import decoder_conv as k3
    from .kernels import slot_attention as k1
    from .models import build_model
    from .runtime.checkpoint import latest_checkpoint

    device = torch.device(device)
    grid = get_mesh(int(params.get("tp_size", 1)), device)
    one = BaseParams(**{**params.to_dict(), "tp_size": 1})
    rows = next(v.shape[0] for v in batches[0].values() if hasattr(v, "shape"))
    torch.manual_seed(params.get("seed", 0))
    model = build_model(params, device=device)
    ref_model = copy.deepcopy(model) if grid.rank == 0 else None
    method = _method(params, model, grid, len(batches), rows,
                     ckp_path=ckp_dir or "", val=val)

    launches0, k3_launches0 = k1.LAUNCHES, k3.LAUNCHES
    t0 = time.perf_counter()
    outs = [method._train_step(shard_or_replicate(grid, b)) for b in batches]
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    launches = k1.LAUNCHES - launches0
    k3_launches = k3.LAUNCHES - k3_launches0
    full = method._full_state_dict()
    tp_layout = {k: (tuple(p.shape), tuple(full[k].shape))
                 for k, p in method.model.named_parameters()
                 if k.endswith("linear1.weight")}
    res = dict(rank=grid.rank, grid=grid.shape, seconds=seconds,
               linear1=next(iter(tp_layout.values()), None))
    if count_launches:
        res["k1_launches"] = launches
        res["k3_launches"] = k3_launches
    if val is not None:
        val_avgs = method.validation_epoch()

    if ckp_dir:
        method.save_ckp()
        method._join_ckp_writer()
        grid.barrier()
        written = latest_checkpoint(ckp_dir)
        opt_grid = full_optimizer_state(method.optimizer.optimizer, grid)
    if grid.rank == 0:
        ref = _method(one, ref_model, Grid(device=device), len(batches), rows,
                      ckp_path=os.path.join(ckp_dir, "one") if ckp_dir else "",
                      val=val)
        want = [ref._train_step(b) for b in batches]
        if val is not None:
            ref_avgs = ref.validation_epoch()
            res["val_rel_err"] = max(
                abs(val_avgs[k] - w) / max(abs(w), 1e-12)
                for k, w in ref_avgs.items())
        res["loss_rel_err"] = max(
            abs(float(o[k]) - float(w[k])) / max(abs(float(w[k])), 1e-12)
            for o, w in zip(outs, want) for k in w)
        res["losses"] = {k: float(v) for k, v in outs[-1].items()}
        res["max_param_diff"] = _max_diff(full, ref.model.state_dict())
        if ckp_dir:  # the grid's checkpoint in one process
            torch.manual_seed(params.get("seed", 0) + 1)
            probe = _method(one, build_model(params, device=device),
                            Grid(device=device), len(batches), rows)
            probe.load_ckp(written)
            res["ckp_grid_to_one"] = _state_equal(
                probe.model.state_dict(), full) and _state_equal(
                probe.optimizer.state_dict()["state"], opt_grid["state"])
            ref.save_ckp()
            ref._join_ckp_writer()
    if ckp_dir:  # one process's checkpoint on the grid
        grid.barrier()
        method.load_ckp(latest_checkpoint(os.path.join(ckp_dir, "one")))
        back = method._full_state_dict()
        back_opt = full_optimizer_state(method.optimizer.optimizer, grid)
        if grid.rank == 0:
            res["ckp_one_to_grid"] = _state_equal(
                back, ref.model.state_dict()) and _state_equal(
                back_opt["state"], ref.optimizer.state_dict()["state"])
    return res


def run_cases(device, cases: List[dict]) -> List[dict]:
    """``step_against_one_process`` for each case (``params`` as a dict,
    ``batches``, ``ckp_dir``, ``count_launches``), on a rank
    started by ``parallel.launch.spawn``."""
    out = []
    for case in cases:
        case = dict(case)
        params = BaseParams(**case.pop("params"))
        out.append(step_against_one_process(device, params, **case))
    return out


def tiny_batch(rows: int, seed: int = 0) -> dict:
    """A global batch of the tiny flagship: 6 frames of slots and images."""
    r = np.random.RandomState(seed)
    return {"slots": r.randn(rows, 6, 4, 16).astype(np.float32),
            "img": r.uniform(-1, 1, (rows, 6, 16, 16, 3)).astype(np.float32)}


def dryrun_multichip(n_devices: int) -> List[dict]:
    """One training step of the tiny SlotFormer on ``n_devices`` ranks: on
    distinct cards over NCCL where there are that many, else over gloo on
    one shared card, or on the CPU without one. A 2-wide model axis when
    ``n_devices`` >= 4 is even. Raises unless TP is physical and the step
    equals one process's; returns each rank's record."""
    n_cuda = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n_cuda >= n_devices:
        backend, devices = "nccl", [f"cuda:{r}" for r in range(n_devices)]
    else:
        backend = "gloo"
        devices = ["cuda:0" if n_cuda else "cpu"] * n_devices
    n_model = 2 if n_devices >= 4 and n_devices % 2 == 0 else 1
    case = dict(params=flagship_params(tiny=True, tp_size=n_model).to_dict(),
                batches=[tiny_batch(2 * n_devices)])
    recs = [r[0] for r in spawn(run_cases, n_devices, ([case],), backend,
                                devices)]
    lead = recs[0]
    if n_model > 1:
        local, whole = lead["linear1"]
        if local[0] * n_model != whole[0]:
            raise AssertionError(f"TP inert: linear1 {local} of {whole}")
    if not lead["max_param_diff"] < PARAM_ATOL:
        raise AssertionError(f"sharded vs one process: max|dparam| = "
                             f"{lead['max_param_diff']}")
    print(f"dryrun_multichip({n_devices}): grid={lead['grid']} "
          f"backend={backend} loss={lead['losses']['total_loss']:.4f} "
          f"max|dparam| vs one process={lead['max_param_diff']:.2e}",
          flush=True)
    return recs


if __name__ == "__main__":
    fn, args = entry("cuda" if torch.cuda.is_available() else "cpu")
    out = fn(*args)
    print("entry() ok:", {k: tuple(v.shape) for k, v in out.items()})
    dryrun_multichip(max(torch.cuda.device_count(), 1))
