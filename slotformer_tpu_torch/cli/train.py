"""Training CLI: the port of ``slotformer_tpu/cli/train.py``.

    python -m slotformer_tpu_torch.cli.train --params <config.py>
        [--weight ckpt] [--auto_resume] [--ckp_path dir] [--seeds K]
        [--seed S] [--fp16] [--device cuda]
    torchrun --nproc_per_node=<cards> -m slotformer_tpu_torch.cli.train \
        --ddp --params <config.py> ...

``--seeds K`` runs K seeds one after another, each in its own checkpoint
dir; ``--auto_resume`` continues from the newest ``model_<it>.pth`` of the
run dir; ``--fp16`` trains under bf16 autocast, as the JAX package does.
``--ddp`` joins the process group torchrun describes (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``; it raises
without them) on NCCL, or on gloo with ``--device cpu``; each rank drives
``cuda:<LOCAL_RANK>`` (``--local_rank`` is the older launchers' spelling of
it). The ranks form a grid of ``WORLD_SIZE / tp_size`` data ranks by the
config's ``tp_size`` model ranks; ``train_batch_size`` is the global batch.
``--cudnn`` is accepted and ignored.
"""

from __future__ import annotations

import argparse
import os


def run(params, ckp_path: str, device: str = "cuda", use_fp16: bool = False,
        resume: str = "", san_check_val_step: int = 2, grid=None):
    """Build the datasets, the model (initialized from ``params.seed``) and
    its method, then ``fit``; returns the method. ``grid``: this rank's
    ``parallel.Grid`` in a multi-process run (one process without it)."""
    import torch

    from ..datasets import build_dataset
    from ..methods import build_method
    from ..models import build_model
    from ..runtime import BaseDataModule

    train_set, val_set = build_dataset(params)
    datamodule = BaseDataModule(params, train_set, val_set, grid=grid)
    torch.manual_seed(params.seed)
    model = build_model(params, device=device)
    method = build_method(model=model, datamodule=datamodule, params=params,
                          ckp_path=ckp_path, use_fp16=use_fp16, grid=grid)
    if method.grid.rank == 0:
        print(f"[train] seed={params.seed} steps/epoch={method.steps_per_epoch} "
              f"total={method.total_steps} grid={method.grid.shape} "
              f"resume={resume or 'none'}", flush=True)
    method.fit(resume_from=resume, san_check_val_step=san_check_val_step)
    return method


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="train a slotformer_tpu_torch model")
    parser.add_argument("--params", required=True, help="path to the config .py")
    parser.add_argument("--weight", default="", help="checkpoint to resume from")
    parser.add_argument("--auto_resume", action="store_true")
    parser.add_argument("--ckp_path", default="", help="checkpoint dir override")
    parser.add_argument("--seeds", type=int, default=1)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--san_check_val_step", type=int, default=2)
    parser.add_argument("--fp16", action="store_true",
                        help="bf16 autocast (the reference's AMP flag)")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--ddp", action="store_true",
                        help="data (and tensor) parallel over the process "
                             "group torchrun starts")
    parser.add_argument("--local_rank", "--local-rank", type=int, default=None,
                        help="this rank's card (default: LOCAL_RANK)")
    parser.add_argument("--cudnn", action="store_true")  # reference parity
    args = parser.parse_args(argv)

    from ..parallel import get_mesh, init_process_group
    from ..runtime import latest_checkpoint, load_params

    device, grid = args.device, None
    if args.ddp:
        if args.local_rank is not None:
            os.environ.setdefault("LOCAL_RANK", str(args.local_rank))
        device = init_process_group(args.device)

    for k in range(args.seeds):
        params = load_params(args.params)
        params.seed = args.seed + k
        exp_name = os.path.splitext(os.path.basename(args.params))[0]
        if args.seeds > 1:
            exp_name = f"{exp_name}-seed{params.seed}"
        ckp_path = args.ckp_path or os.path.join("checkpoints", exp_name, "models")
        if args.ckp_path and args.seeds > 1:
            # one dir per seed, or a later seed would resume an earlier one
            ckp_path = os.path.join(args.ckp_path, f"seed{params.seed}")
        resume = args.weight
        if args.auto_resume and not resume:
            resume = latest_checkpoint(ckp_path) or ""
        if args.ddp:
            grid = get_mesh(int(params.get("tp_size", 1)), device)
        run(params, ckp_path, device=device, use_fp16=args.fp16,
            resume=resume, san_check_val_step=args.san_check_val_step,
            grid=grid)
    if args.ddp:
        import torch.distributed as dist

        dist.destroy_process_group()


if __name__ == "__main__":
    main()
