"""The collectives that XLA's sharding inserts for the JAX package, written
out for eager PyTorch over ``torch.distributed`` process groups.

Tensor parallelism (Megatron's column/row split, ``parallel/mesh.py``'s
rules) needs two autograd functions over the model axis:

  * :func:`copy_to_tp`: the replicated input of a column-parallel layer;
    forward identity, backward the sum of every rank's input gradient;
  * :func:`reduce_from_tp`: the partial output of a row-parallel layer;
    forward the sum over the ranks, backward identity;

and :func:`all_reduce_max` for the int8 scales of a row-parallel product
(``models/quant.py``), taken over a dimension the ranks split.

Every function takes ``group=None`` for "no such axis" and is then the
identity, issuing no collective: a one-process run goes through the same
code. The data axis uses :func:`all_mean` and :func:`all_cat`.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Tuple

import torch
import torch.distributed as dist


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    """``x``, replicated over ``group``: its gradient is summed over the
    group's ranks (each rank's share of the split layer that reads it)."""
    return x if group is None else _CopyToTP.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``'s ranks; the gradient passes through."""
    return x if group is None else _ReduceFromTP.apply(x, group)


@torch.no_grad()
def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise maximum of ``x`` over ``group`` (no gradient)."""
    if group is None:
        return x
    x = x.contiguous().clone()
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    return x


@torch.no_grad()
def all_mean(x: torch.Tensor, group) -> torch.Tensor:
    """The mean of ``x`` over ``group``'s ranks (no gradient)."""
    if group is None:
        return x
    x = x.contiguous().clone()
    dist.all_reduce(x, group=group)
    return x / dist.get_world_size(group)


@torch.no_grad()
def all_cat(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` of ``group``, concatenated along ``dim`` in group
    rank order (no gradient); each rank's ``x`` has the same shape."""
    if group is None:
        return x
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def all_reduce_sum_(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group`` in place (no gradient); returns ``x``."""
    if group is not None:
        dist.all_reduce(x, group=group)
    return x


@torch.no_grad()
def coalesced_(tensors: Iterable[torch.Tensor],
               collective: Callable[[torch.Tensor], None]) -> None:
    """``collective`` applied in place to one flat buffer per dtype and
    device holding ``tensors``, and the result copied back into them: one
    call for many small tensors (a gradient all-reduce, a broadcast)."""
    by_kind: Dict[Tuple, List[torch.Tensor]] = {}
    for t in tensors:
        by_kind.setdefault((t.dtype, t.device), []).append(t)
    for group in by_kind.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        collective(flat)
        for t, v in zip(group, flat.split([t.numel() for t in group])):
            t.copy_(v.view_as(t))
