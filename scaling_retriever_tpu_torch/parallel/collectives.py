"""Collectives with autograd for training over several ranks.

The reference's training step is one program over the global batch, and
XLA inserts its collectives. Under ``torchrun`` every rank computes the
same global loss from its own rows, joined by the functions below:

  * ``gather_rows``: the data group's reps, concatenated in rank order, so
    that the in-batch negatives and the FLOPS regularizers see every row.
    Its backward sums the W ranks' (identical) gradients and keeps this
    rank's rows, so the trainable's gradient on a rank is W times its rows'
    share: the Trainer all-reduces it and divides by W, as FSDP's
    reduce-scatter averages;
  * ``sum_over``: a sum over a group whose backward sums too (a loss that
    is a sum of the ranks' parts, MNTP's token mean), the same convention;
  * ``to_model`` and ``from_model``: Megatron's f and g around a
    column-parallel and a row-parallel projection over the ``model``
    group (identity one way, all-reduce the other).

``Part`` tells a forward which rows of the global batch this rank holds,
so that the LoRA dropout draws the global mask and keeps this rank's
slice of it.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Part:
    """This rank's part of one encode call: ``count`` rows from ``row0``
    of a global batch of ``rows``."""

    row0: int
    count: int
    rows: int

    @property
    def local(self) -> slice:
        return slice(self.row0, self.row0 + self.count)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous().clone()
    dist.all_reduce(x, group=group)
    return x


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.rank = dist.get_rank(group)
        ctx.n = x.shape[0]
        x = x.contiguous()
        out = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(out, x, group=group)
        return torch.cat(out)

    @staticmethod
    def backward(ctx, grad):
        grad = _all_reduce(grad, ctx.group)
        return grad[ctx.rank * ctx.n:(ctx.rank + 1) * ctx.n], None


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _ToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _FromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """[n, ...] on each rank → [W * n, ...], rank order."""
    return _GatherRows.apply(x, group)


def sum_over(x: torch.Tensor, group) -> torch.Tensor:
    return _SumOver.apply(x, group)


def to_model(x: torch.Tensor, group) -> torch.Tensor:
    """The input of a column-parallel projection: the same forward, its
    gradient summed over the model group (each rank's columns give a
    part)."""
    return _ToModel.apply(x, group)


def from_model(x: torch.Tensor, group) -> torch.Tensor:
    """The output of a row-parallel projection: the ranks' partial sums
    added; the gradient passes as it is."""
    return _FromModel.apply(x, group)
