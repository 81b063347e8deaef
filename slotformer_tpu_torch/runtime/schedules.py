"""Optimizer LR schedules, scalar annealing and the optimizer stack: the port
of ``slotformer_tpu/runtime/schedules.py``.

Every schedule is a pure function of the optimizer step (the number of
updates applied so far), as the optax schedules the JAX package evaluates
inside its train step; ``ScheduledOptimizer`` writes each group's LR from it
before every update, so a resumed run needs no scheduler state.
"""

from __future__ import annotations

import math
from typing import Callable, List, Sequence

import torch

Schedule = Callable[[int], float]


def cosine_annealing_warmup(total_steps: int, max_lr: float,
                            min_lr: float = 0.0,
                            warmup_steps: int = 0) -> Schedule:
    """Linear warmup (min -> max over ``warmup_steps``) then cosine decay
    (max -> min) until ``total_steps``; the single cycle of the reference's
    CosineAnnealingWarmupRestarts."""
    total_steps = max(int(total_steps), 1)
    warmup_steps = int(warmup_steps)

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return min_lr + (max_lr - min_lr) * step / max(warmup_steps, 1)
        decay_steps = max(total_steps - warmup_steps, 1)
        t = min(max((step - warmup_steps) / decay_steps, 0.0), 1.0)
        return min_lr + 0.5 * (max_lr - min_lr) * (1.0 + math.cos(math.pi * t))

    return schedule


def cosine_anneal(step: int, start_value: float, final_value: float,
                  start_step: int, final_step: int) -> float:
    """Scalar cosine annealing from ``start_value`` to ``final_value``."""
    if final_step <= start_step:
        return final_value
    t = min(max((step - start_step) / (final_step - start_step), 0.0), 1.0)
    a = 0.5 * (start_value - final_value)
    b = 0.5 * (start_value + final_value)
    return b + a * math.cos(math.pi * t)


class ScheduledOptimizer:
    """Global-norm clip of each param group, then each group's LR from its
    schedule, then the torch optimizer's update: the order of the JAX
    package's optax chains, one a group under ``multi_transform``."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 schedules: Sequence[Schedule], clip_grad: float):
        if len(schedules) != len(optimizer.param_groups):
            raise ValueError("one schedule per param group")
        self.optimizer = optimizer
        self.schedules = list(schedules)
        self.clip_grad = clip_grad

    @property
    def params(self) -> List[torch.Tensor]:
        return [p for g in self.optimizer.param_groups for p in g["params"]]

    def step(self, step: int) -> torch.Tensor:
        """Apply optimizer step ``step`` (0-based) to the accumulated
        ``.grad``s; returns the global norm of all the gradients before
        clipping (``optax.global_norm(grads)``). Each group is clipped by the
        global norm of its own gradients, as each chain of the JAX package's
        ``multi_transform`` holds its own ``clip_by_global_norm``; parameters
        without a gradient count for nothing."""
        group_norms = []
        for group, schedule in zip(self.optimizer.param_groups, self.schedules):
            grads = [p.grad for p in group["params"] if p.grad is not None]
            if grads:
                norm = torch.linalg.vector_norm(
                    torch.stack([torch.linalg.vector_norm(g) for g in grads]))
                group_norms.append(norm)
                if self.clip_grad > 0:
                    # optax.clip_by_global_norm: g * max_norm / norm when
                    # norm >= max_norm
                    scale = torch.where(norm < self.clip_grad, 1.0,
                                        self.clip_grad / norm)
                    torch._foreach_mul_(grads, scale)
            group["lr"] = schedule(step)
        self.optimizer.step()
        if not group_norms:
            return torch.zeros(())
        return torch.linalg.vector_norm(torch.stack(group_norms))

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    def state_dict(self) -> dict:
        return self.optimizer.state_dict()

    def load_state_dict(self, state: dict) -> None:
        self.optimizer.load_state_dict(state)


def build_optimizer(params_cfg, model: torch.nn.Module, total_steps: int,
                    frozen_prefixes: Sequence[str] = ()) -> ScheduledOptimizer:
    """The reference training optimizer stack over ``model``'s parameters.

      * Adam, or AdamW (decoupled decay) for ``optimizer='adamw'`` or Adam
        with ``weight_decay > 0``; SGD with coupled decay (``g + wd * p``),
        which never becomes AdamW;
      * global-norm gradient clipping by ``clip_grad`` (<= 0 disables), each
        param group by its own norm;
      * cosine warmup schedule from ``lr`` / ``warmup_steps_pct`` down to
        ``lr / 100``;
      * parameters whose top-level name starts with one of
        ``dec_lr_prefixes`` (default ``('trans_decoder',)``) train at
        ``dec_lr`` with ``min_lr=0`` when ``dec_lr`` is set;
      * parameters under ``frozen_prefixes`` get ``requires_grad=False`` and
        stay out of the optimizer.

    ``total_steps`` counts optimizer steps (loader steps // accum_grad).
    """
    lr = float(params_cfg.lr)
    warmup_steps = int(float(params_cfg.get("warmup_steps_pct", 0.0)) * total_steps)
    opt_name = str(params_cfg.get("optimizer", "Adam")).lower()
    weight_decay = float(params_cfg.get("weight_decay", 0.0) or 0.0)
    clip_grad = float(params_cfg.get("clip_grad", -1.0) or -1.0)
    dec_lr = params_cfg.get("dec_lr", None)
    dec_prefixes = tuple(params_cfg.get("dec_lr_prefixes", ("trans_decoder",)))

    main, dec = [], []
    for name, p in model.named_parameters():
        top = name.split(".")[0]
        if any(top.startswith(f) for f in frozen_prefixes):
            p.requires_grad_(False)
        elif dec_lr is not None and any(top.startswith(f) for f in dec_prefixes):
            dec.append(p)
        else:
            main.append(p)
    groups = [{"params": main, "lr": lr}]
    schedules = [cosine_annealing_warmup(total_steps, lr, lr / 100.0,
                                         warmup_steps)]
    if dec:
        groups.append({"params": dec, "lr": float(dec_lr)})
        schedules.append(cosine_annealing_warmup(total_steps, float(dec_lr),
                                                 0.0, warmup_steps))

    if opt_name == "adamw" or (opt_name == "adam" and weight_decay > 0):
        opt = torch.optim.AdamW(groups, weight_decay=weight_decay)
    elif opt_name == "adam":
        opt = torch.optim.Adam(groups)
    elif opt_name == "sgd":
        opt = torch.optim.SGD(groups, weight_decay=weight_decay)
    else:
        raise NotImplementedError(f"optimizer {opt_name}")
    return ScheduledOptimizer(opt, schedules, clip_grad)
