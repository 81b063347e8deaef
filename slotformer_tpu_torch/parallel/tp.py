"""Tensor parallelism (Megatron column/row rules) over the grid's model
axis: the port of ``slotformer_tpu/parallel/tp.py``.

The JAX package places parameters with shardings and lets XLA derive the
collectives. Here ``shard_params`` swaps each matched module for a parallel
module that holds only this rank's shard and runs the collectives itself:

=====================================  ==========  ==========================
module path (first match wins)         kind        this rank holds
=====================================  ==========  ==========================
``linear1`` / ``ffn.0`` (JAX ``fc1``)  column      rows of ``weight``, ``bias``
``linear2`` / ``ffn.2`` (JAX ``fc2``)  row         columns of ``weight``; the
                                                   bias whole, added once
``self_attn`` (nn.MultiheadAttention)  heads       its heads' rows of each of
                                                   q, k, v in ``in_proj_*``;
                                                   ``out_proj`` row-parallel
``proj_q|proj_k|proj_v``               column      rows of ``weight``
``proj_o``                             row         columns of ``weight``
=====================================  ==========  ==========================

A column-parallel layer's input passes ``copy_to_model`` (identity forward,
all-reduce of the gradient backward); a row-parallel layer's output passes
``reduce_from_model`` (all-reduce forward, identity backward): one
all-reduce a sublayer each way. A dimension that does not divide the model
axis stays replicated, as in JAX; so does an attention whose head count
does not (where JAX could still cut its projections' columns).

The state_dict keys stay the reference's: a sharded parameter keeps its
name and carries ``tp_split`` (the dimension and the number of stacked
blocks it is cut along), so ``full_state_dict`` / ``load_full_state_dict``
and their optimizer counterparts move between the layout of one process and
this rank's shard.
"""

from __future__ import annotations

import re
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from .mesh import Grid


class Split(NamedTuple):
    """A parameter cut along ``dim`` into ``blocks`` stacked blocks (q, k, v
    of a fused projection: 3), each cut into one piece a model rank."""

    dim: int
    blocks: int = 1


DEFAULT_TP_RULES: Tuple[Tuple[str, str], ...] = (
    (r"(^|\.)(linear1|ffn\.0)$", "column"),
    (r"(^|\.)(linear2|ffn\.2)$", "row"),
    (r"(^|\.)self_attn$", "heads"),
    (r"(^|\.)proj_[qkv]$", "column"),
    (r"(^|\.)proj_o$", "row"),
)


# ------------------------------------------------------------- collectives
class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, grid: Grid) -> torch.Tensor:
    """Identity forward; the gradient all-reduced over the model group."""
    return _CopyToModel.apply(x, grid.model_group)


def reduce_from_model(x: torch.Tensor, grid: Grid) -> torch.Tensor:
    """``x`` summed over the model group; the gradient passed as it is."""
    return _ReduceFromModel.apply(x, grid.model_group)


# ------------------------------------------------------------------ shards
def shard(t: torch.Tensor, split: Split, n: int, index: int) -> torch.Tensor:
    """Piece ``index`` of ``n`` of each of ``t``'s blocks, stacked."""
    return torch.cat([b.chunk(n, split.dim)[index]
                      for b in t.chunk(split.blocks, split.dim)],
                     split.dim).clone()


def unshard(t: torch.Tensor, split: Split, grid: Grid) -> torch.Tensor:
    """The whole tensor from every model rank's shard ``t``. Each rank
    writes its pieces into zeros and the model group sums them (gloo takes
    CUDA tensors in an all-reduce, not in every gather)."""
    n, r = grid.n_model, grid.model_rank
    pieces = t.chunk(split.blocks, split.dim)
    full = []
    for p in pieces:
        shape = list(p.shape)
        shape[split.dim] *= n
        z = p.new_zeros(shape)
        z.narrow(split.dim, r * p.shape[split.dim], p.shape[split.dim]).copy_(p)
        full.append(z)
    out = torch.cat(full, split.dim).contiguous()
    dist.all_reduce(out, group=grid.model_group)
    return out


def _mark(p: nn.Parameter, split: Split) -> nn.Parameter:
    p.tp_split = split
    return p


# ----------------------------------------------------------------- modules
class ColumnParallelLinear(nn.Module):
    """This rank's rows of a Linear; its input through ``copy_to_model``."""

    def __init__(self, full: nn.Linear, grid: Grid):
        super().__init__()
        self.grid = grid
        n, r = grid.n_model, grid.model_rank
        self.in_features = full.in_features
        self.out_features = full.out_features // n
        self.weight = _mark(nn.Parameter(shard(full.weight.data, Split(0), n, r),
                                         full.weight.requires_grad), Split(0))
        self.bias = None if full.bias is None else _mark(nn.Parameter(
            shard(full.bias.data, Split(0), n, r), full.bias.requires_grad),
            Split(0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(copy_to_model(x, self.grid), self.weight, self.bias)


class RowParallelLinear(nn.Module):
    """This rank's columns of a Linear; the partial products summed over the
    model group, then the (whole) bias added once."""

    def __init__(self, full: nn.Linear, grid: Grid):
        super().__init__()
        self.grid = grid
        n, r = grid.n_model, grid.model_rank
        self.in_features = full.in_features // n
        self.out_features = full.out_features
        self.weight = _mark(nn.Parameter(shard(full.weight.data, Split(1), n, r),
                                         full.weight.requires_grad), Split(1))
        self.bias = full.bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = reduce_from_model(F.linear(x, self.weight), self.grid)
        return y if self.bias is None else y + self.bias


class ParallelMultiheadAttention(nn.Module):
    """This rank's heads of a batch-first ``nn.MultiheadAttention`` used for
    self-attention: the same math (projection, queries scaled by
    ``head_dim ** -0.5``, softmax over the keys, ``key_padding_mask`` True =
    ignored, attention dropout), then a row-parallel ``out_proj``.
    ``nn.MultiheadAttention`` itself cannot hold the shard: its fused
    ``in_proj_weight`` stacks q, k and v, so a head split takes rows from
    each of the three blocks."""

    def __init__(self, full: nn.MultiheadAttention, grid: Grid):
        super().__init__()
        if not full.batch_first or not full._qkv_same_embed_dim:
            raise NotImplementedError("tensor parallelism takes batch-first "
                                      "self-attention with one embed dim")
        self.grid = grid
        n, r = grid.n_model, grid.model_rank
        self.num_heads = full.num_heads // n
        self.head_dim = full.head_dim
        self.dropout = full.dropout
        qkv = Split(0, 3)
        self.in_proj_weight = _mark(nn.Parameter(
            shard(full.in_proj_weight.data, qkv, n, r),
            full.in_proj_weight.requires_grad), qkv)
        self.in_proj_bias = None if full.in_proj_bias is None else _mark(
            nn.Parameter(shard(full.in_proj_bias.data, qkv, n, r),
                         full.in_proj_bias.requires_grad), qkv)
        self.out_proj = RowParallelLinear(full.out_proj, grid)

    def forward(self, query, key=None, value=None, key_padding_mask=None,
                need_weights: bool = False, **_):
        if need_weights:
            raise NotImplementedError("need_weights under tensor parallelism")
        x = copy_to_model(query, self.grid)
        B, L, _ = x.shape
        qkv = F.linear(x, self.in_proj_weight, self.in_proj_bias)
        q, k, v = qkv.reshape(B, L, 3, self.num_heads, self.head_dim).permute(
            2, 0, 3, 1, 4)
        mask = None if key_padding_mask is None else \
            ~key_padding_mask[:, None, None, :]  # True = attend
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask,
            dropout_p=self.dropout if self.training else 0.0)
        out = out.transpose(1, 2).reshape(B, L, self.num_heads * self.head_dim)
        return self.out_proj(out), None


# ------------------------------------------------------------------- rules
def _parent(model: nn.Module, name: str) -> Tuple[nn.Module, str]:
    parent, _, leaf = name.rpartition(".")
    return (model.get_submodule(parent) if parent else model), leaf


def _plan(model: nn.Module, n_model: int, rules) -> Dict[str, str]:
    """{module name: kind} of the modules to shard."""
    compiled = [(re.compile(rx), kind) for rx, kind in rules]
    plan = {}
    if n_model <= 1:
        return plan
    for name, mod in model.named_modules():
        kind = next((k for rx, k in compiled if rx.search(name)), None)
        if kind is None:
            continue
        if kind == "heads":
            if isinstance(mod, nn.MultiheadAttention) and \
                    mod.num_heads % n_model == 0:
                plan[name] = kind
            continue
        if not isinstance(mod, nn.Linear):
            continue
        dim = mod.out_features if kind == "column" else mod.in_features
        heads = getattr(_parent(model, name)[0], "num_heads", n_model)
        if dim % n_model == 0 and heads % n_model == 0:
            plan[name] = kind
    return plan


_SPLITS = {
    "column": {"weight": Split(0), "bias": Split(0)},
    "row": {"weight": Split(1)},
    "heads": {"in_proj_weight": Split(0, 3), "in_proj_bias": Split(0, 3),
              "out_proj.weight": Split(1)},
}


def param_specs(model: nn.Module, n_model: int,
                rules: Sequence[Tuple[str, str]] = DEFAULT_TP_RULES
                ) -> Dict[str, Optional[Split]]:
    """{parameter name: its Split, or None when replicated} of ``model``
    under ``n_model``-way tensor parallelism (all None for ``n_model`` 1)."""
    specs = {name: None for name, _ in model.named_parameters()}
    for mod_name, kind in _plan(model, n_model, rules).items():
        for p_name, split in _SPLITS[kind].items():
            key = f"{mod_name}.{p_name}"
            if key in specs:
                specs[key] = split
    return specs


def shard_params(grid: Grid, model: nn.Module,
                 rules: Sequence[Tuple[str, str]] = DEFAULT_TP_RULES
                 ) -> Dict[str, Optional[Split]]:
    """Swap the modules the rules match for their parallel modules, holding
    this rank's shard of ``model``'s weights (every rank must hold the same
    whole weights first). Attentions whose projections are cut keep their
    own head count. Returns ``param_specs``. A 1-wide model axis changes
    nothing."""
    specs = param_specs(model, grid.n_model, rules)
    swap = {"column": ColumnParallelLinear, "row": RowParallelLinear,
            "heads": ParallelMultiheadAttention}
    for name, kind in _plan(model, grid.n_model, rules).items():
        parent, leaf = _parent(model, name)
        setattr(parent, leaf, swap[kind](getattr(parent, leaf), grid))
        if kind != "heads" and hasattr(parent, "num_heads") and \
                not getattr(parent, "_tp_heads_cut", False):
            parent.num_heads //= grid.n_model
            parent._tp_heads_cut = True
    return specs


# ---------------------------------------------------- the layout of one run
def full_state_dict(model: nn.Module, grid: Grid) -> Dict[str, torch.Tensor]:
    """``model.state_dict()`` with every shard made whole again: the
    reference key layout of one process. A collective of the model group."""
    out = {}
    for k, v in model.state_dict(keep_vars=True).items():
        split = getattr(v, "tp_split", None)
        out[k] = v.detach() if split is None else unshard(v.detach(), split, grid)
    return out


def load_full_state_dict(model: nn.Module, sd: Dict[str, torch.Tensor],
                         grid: Grid) -> None:
    """Load a state_dict of one process's layout, each sharded parameter
    cut to this rank's piece."""
    local = dict(sd)
    for k, v in model.state_dict(keep_vars=True).items():
        split = getattr(v, "tp_split", None)
        if split is not None and k in sd:
            local[k] = shard(sd[k], split, grid.n_model, grid.model_rank)
    model.load_state_dict(local)


def _optimizer_params(optimizer) -> list:
    return [p for g in optimizer.param_groups for p in g["params"]]


def full_optimizer_state(optimizer, grid: Grid) -> dict:
    """The optimizer's state_dict with the moments of sharded parameters
    made whole (a collective of the model group)."""
    state = optimizer.state_dict()
    for i, p in enumerate(_optimizer_params(optimizer)):
        split = getattr(p, "tp_split", None)
        if split is None or i not in state["state"]:
            continue
        state["state"][i] = {
            k: unshard(v, split, grid) if torch.is_tensor(v) and
            v.shape == p.shape else v for k, v in state["state"][i].items()}
    return state


def load_full_optimizer_state(optimizer, state: dict, grid: Grid) -> None:
    """Load an optimizer state_dict of one process's layout."""
    params = _optimizer_params(optimizer)
    local = {**state, "state": dict(state["state"])}
    for i, s in state["state"].items():
        split = getattr(params[int(i)], "tp_split", None)
        if split is None:
            continue
        shape = params[int(i)].shape
        local["state"][i] = {
            k: shard(v, split, grid.n_model, grid.model_rank)
            if torch.is_tensor(v) and v.dim() == len(shape) and
            v.shape != shape else v for k, v in s.items()}
    optimizer.load_state_dict(local)
