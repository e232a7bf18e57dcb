"""Where a process's tensors sit in a parallel gang, and the collectives
that carry a gradient.

`Shard` names this process's coordinates on the ('data', 'model') mesh
and the two process groups. The model reads it to put each rank's slice
in global coordinates (its dropout offsets, its SpecAugment rows, its
first attention head), so a gang draws what one process at the global
batch draws. `SINGLE` is the one-process shard every module starts with.

The three differentiable collectives of the Megatron layout and of the
global-batch loss, each a `torch.autograd.Function`:

  * `copy_to_model`: identity forward, gradient all-reduced over
    'model' (the input of a column-parallel linear);
  * `reduce_from_model`: all-reduce over 'model' forward, identity
    backward (the output of a row-parallel linear);
  * `gather_rows`: the rows of every 'data' rank concatenated in rank
    order forward; backward, the gradient summed over 'data' and this
    rank's rows taken (a reduce-scatter). Every rank computes the same
    loss on the gathered rows, so the sum is n_data times this rank's
    share of the gradient, and the average over 'data' that follows
    (`average_gradients`, FSDP2's reduce-scatter) gives the gradient of
    the global batch.

The all-reduces run in fp32 whatever the activation dtype, so a bf16
row-parallel sum rounds once. They use `all_reduce` and `all_gather`
only, which NCCL takes and Gloo takes for CPU and CUDA tensors alike.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional

import torch
import torch.distributed as dist

__all__ = ["Shard", "SINGLE", "copy_to_model", "reduce_from_model",
           "gather_rows", "average_gradients", "set_shard"]


@dataclasses.dataclass(frozen=True)
class Shard:
    """This process's place on the ('data', 'model') mesh: its rank and
    size on each axis and the process group along each (None in one
    process)."""

    data_rank: int = 0
    n_data: int = 1
    model_rank: int = 0
    n_model: int = 1
    data_group: Optional[dist.ProcessGroup] = None
    model_group: Optional[dist.ProcessGroup] = None

    def batch_offset(self, local_batch: int) -> int:
        """The global row of this rank's first row."""
        return self.data_rank * local_batch


SINGLE = Shard()


def set_shard(module: torch.nn.Module, shard: Shard) -> None:
    """Give every submodule that reads a shard (one with a `shard` class
    attribute) this one."""
    for m in module.modules():
        if hasattr(type(m), "shard"):
            m.shard = shard


def _all_reduce_fp32(x: torch.Tensor, group) -> torch.Tensor:
    y = x.to(torch.float32, copy=True).contiguous()
    dist.all_reduce(y, group=group)
    return y.to(x.dtype)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_fp32(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce_fp32(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _gather(x: torch.Tensor, group, n: int) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, rank, n):
        ctx.group, ctx.rank, ctx.rows = group, rank, x.shape[0]
        return _gather(x, group, n)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        rows = slice(ctx.rank * ctx.rows, (ctx.rank + 1) * ctx.rows)
        return g[rows], None, None, None


def copy_to_model(x: torch.Tensor, shard: Shard) -> torch.Tensor:
    """The input of a column-parallel linear (identity without a
    'model' axis)."""
    if shard.n_model == 1:
        return x
    return _CopyToModel.apply(x, shard.model_group)


def reduce_from_model(x: torch.Tensor, shard: Shard) -> torch.Tensor:
    """The sum over 'model' of row-parallel partial outputs (identity
    without a 'model' axis)."""
    if shard.n_model == 1:
        return x
    return _ReduceFromModel.apply(x, shard.model_group)


def gather_rows(x: torch.Tensor, shard: Shard) -> torch.Tensor:
    """(B_local, ...) -> (n_data * B_local, ...), the rows of every
    'data' rank in rank order; differentiable (module docstring). In one
    process (no data group) x itself."""
    if shard.data_group is None:
        return x
    return _GatherRows.apply(x, shard.data_group, shard.data_rank,
                             shard.n_data)


def average_gradients(params: Iterable[torch.nn.Parameter], shard: Shard,
                      bucket_bytes: int = 256 << 20) -> None:
    """All-reduce the gradients of `params` over 'data' and divide by
    n_data, in flat fp32 buckets: the data-parallel step of every
    trainable parameter that FSDP2 does not reduce itself; nothing over
    a 'data' axis of one. A parameter without a gradient takes zeros, so
    every rank reduces the same buckets."""
    if shard.n_data == 1:
        return
    params = [p for p in params if p.requires_grad]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    bucket: List[torch.nn.Parameter] = []
    size = 0
    for p in params + [None]:
        if p is not None and (not bucket or size + p.grad.nbytes
                              <= bucket_bytes):
            bucket.append(p)
            size += p.grad.nbytes
            continue
        if bucket:
            flat = torch.cat([q.grad.reshape(-1).float() for q in bucket])
            dist.all_reduce(flat, group=shard.data_group)
            flat.div_(shard.n_data)
            for q, g in zip(bucket, flat.split([q.numel() for q in bucket])):
                q.grad.copy_(g.view_as(q.grad))
        bucket, size = ([p], p.grad.nbytes) if p is not None else ([], 0)
