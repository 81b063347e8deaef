"""The training step of the published recipe, plain float32: the weighted
sum of the losses, its gradient, a clip of the gradients' global norm, and
Adam under a linear-warmup cosine schedule (from lr / 100 up to lr, then
down to lr / 100).

With ``dec_lr`` in the params, the parameters whose top-level name starts
with one of ``dec_lr_prefixes`` (required with it) form a second
group: its rate peaks at ``dec_lr`` and falls to 0, with the same warm-up,
and each group's gradients are clipped by their own global norm. That is
the published STEVE method (``base_slots/method.py:234-276`` of
pairlab/SlotFormer: two Adam parameter groups) as the JAX package runs it,
one ``clip_by_global_norm`` in each chain of its ``multi_transform``."""

from __future__ import annotations

import math
from typing import Dict, List

import torch

BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def lr_at(step: int, p: dict, total_steps: int, lr: float = None,
          lo: float = None) -> float:
    """The learning rate of optimizer step ``step`` (0-based), from ``lo``
    up to the peak ``lr`` and down again (by default ``p["lr"]`` and a
    hundredth of it)."""
    if lr is None:
        lr, lo = float(p["lr"]), float(p["lr"]) / 100.0
    warmup = int(float(p["warmup_steps_pct"]) * total_steps)
    if step < warmup:
        return lo + (lr - lo) * step / max(warmup, 1)
    t = min(max((step - warmup) / max(total_steps - warmup, 1), 0.0), 1.0)
    return lo + 0.5 * (lr - lo) * (1.0 + math.cos(math.pi * t))


class Trainer:
    """Adam over the parameters of ``model`` outside ``frozen`` (top-level
    name prefixes) that require a gradient, in one group, or in two with
    ``dec_lr`` in the params."""

    def __init__(self, model: torch.nn.Module, p: dict, total_steps: int,
                 frozen=()):
        self.model, self.p, self.total_steps = model, p, total_steps
        self.weights = {k[:-2]: float(v) for k, v in p.items()
                        if k.endswith("_loss_w")}
        dec = tuple(p["dec_lr_prefixes"]) if p.get("dec_lr") is not None else ()
        self.names: List[str] = []
        self.params: List[torch.Tensor] = []
        self.group: List[int] = []  # each parameter's group: 0, or 1 (dec_lr)
        for name, q in model.named_parameters():
            top = name.split(".")[0]
            if any(top.startswith(f) for f in frozen):
                q.requires_grad_(False)
            elif q.requires_grad:
                self.names.append(name)
                self.params.append(q)
                self.group.append(int(any(top.startswith(f) for f in dec)))
        self.m = [torch.zeros_like(q) for q in self.params]
        self.v = [torch.zeros_like(q) for q in self.params]
        self.t = 0

    def step(self, batch: dict, generator) -> Dict[str, object]:
        """One step; returns the losses, the total, and the gradients as
        the optimizer takes them (after the clip), by name."""
        self.model.train()
        losses = self.model.train_loss(batch, generator)
        total = sum(self.weights.get(k, 1.0) * v for k, v in losses.items())
        grads = torch.autograd.grad(total, self.params, allow_unused=True)
        grads = [torch.zeros_like(q) if g is None else g
                 for q, g in zip(self.params, grads)]
        clip = float(self.p.get("clip_grad", -1.0) or -1.0)
        lrs, squares = [], 0.0
        for k in sorted(set(self.group)):
            idx = [i for i, gk in enumerate(self.group) if gk == k]
            norm = torch.sqrt(sum((grads[i].double() ** 2).sum()
                                  for i in idx)).float()
            squares = squares + norm.double() ** 2
            if clip > 0 and norm >= clip:
                for i in idx:
                    grads[i] = grads[i] * (clip / norm)
            lrs.append(lr_at(self.t, self.p, self.total_steps) if k == 0 else
                       lr_at(self.t, self.p, self.total_steps,
                             float(self.p["dec_lr"]), 0.0))
        self.t += 1
        b1, b2 = BETAS
        # Adam as Kingma and Ba write it, in the order of operations of
        # torch.optim.Adam, so that the two round alike
        with torch.no_grad():
            for q, g, m, v, k in zip(self.params, grads, self.m, self.v,
                                     self.group):
                m.lerp_(g, 1 - b1)
                v.mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = v.sqrt() / math.sqrt(1 - b2 ** self.t) + ADAM_EPS
                q.addcdiv_(m, denom, value=-lrs[k] / (1 - b1 ** self.t))
        return {"losses": {k: float(v.detach()) for k, v in losses.items()},
                "total": float(total.detach()),
                "grad_norm": float(torch.sqrt(squares)),
                "grads": dict(zip(self.names, (g.detach() for g in grads)))}
