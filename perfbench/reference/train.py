"""The training step of the published recipe, plain float32: the weighted
sum of the losses, its gradient, a clip of the gradients' global norm, and
Adam under a linear-warmup cosine schedule (from lr / 100 up to lr, then
down to lr / 100)."""

from __future__ import annotations

import math
from typing import Dict, List

import torch

BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def lr_at(step: int, p: dict, total_steps: int) -> float:
    """The learning rate of optimizer step ``step`` (0-based)."""
    lr, lo = float(p["lr"]), float(p["lr"]) / 100.0
    warmup = int(float(p["warmup_steps_pct"]) * total_steps)
    if step < warmup:
        return lo + (lr - lo) * step / max(warmup, 1)
    t = min(max((step - warmup) / max(total_steps - warmup, 1), 0.0), 1.0)
    return lo + 0.5 * (lr - lo) * (1.0 + math.cos(math.pi * t))


class Trainer:
    """Adam over the parameters of ``model`` outside ``frozen`` (top-level
    name prefixes) that require a gradient."""

    def __init__(self, model: torch.nn.Module, p: dict, total_steps: int,
                 frozen=()):
        self.model, self.p, self.total_steps = model, p, total_steps
        self.weights = {k[:-2]: float(v) for k, v in p.items()
                        if k.endswith("_loss_w")}
        self.names: List[str] = []
        self.params: List[torch.Tensor] = []
        for name, q in model.named_parameters():
            if any(name.split(".")[0].startswith(f) for f in frozen):
                q.requires_grad_(False)
            elif q.requires_grad:
                self.names.append(name)
                self.params.append(q)
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
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads)).float()
        clip = float(self.p.get("clip_grad", -1.0) or -1.0)
        if clip > 0 and norm >= clip:
            grads = [g * (clip / norm) for g in grads]
        lr = lr_at(self.t, self.p, self.total_steps)
        self.t += 1
        b1, b2 = BETAS
        # Adam as Kingma and Ba write it, in the order of operations of
        # torch.optim.Adam, so that the two round alike
        with torch.no_grad():
            for q, g, m, v in zip(self.params, grads, self.m, self.v):
                m.lerp_(g, 1 - b1)
                v.mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = v.sqrt() / math.sqrt(1 - b2 ** self.t) + ADAM_EPS
                q.addcdiv_(m, denom, value=-lr / (1 - b1 ** self.t))
        return {"losses": {k: float(v.detach()) for k, v in losses.items()},
                "total": float(total.detach()), "grad_norm": float(norm),
                "grads": dict(zip(self.names, (g.detach() for g in grads)))}
