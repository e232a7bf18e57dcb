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

The collectives of the GPipe pipeline (parallel/pipeline.py), where the
'model' axis carries the stages:

  * `shift_stages`: the stage hand-off, the counterpart of the JAX
    `ppermute` shift (pipeline.py:160): stage s sends its output to
    stage s + 1 and receives stage s - 1's (stage 0 receives zeros);
    backward, the inverse shift of the gradient. Every stage calls it
    at every tick, so the gang's backward meets the same hand-offs in
    the same order on every rank. The transfers are point-to-point
    (`batch_isend_irecv`); under Gloo a CUDA tensor is staged through
    host memory, as parallel/gloo_probe.py found necessary on the H100
    (PERF.md), and NCCL moves it directly.

and of Megatron's sequence parallelism over 'model', on the frame axis
(dim 1) of a (B, T, D) residual stream whose frames are split over the
'model' ranks:

  * `split_frames`: this rank's frames forward, the all-gather of the
    gradient backward (the stream enters the frame-sharded region);
  * `gather_frames`: the frames of every rank concatenated forward; its
    gradient backward is reduce-scattered (`reduce_grad`, before a
    column-parallel linear, whose ranks each contribute a part) or only
    sliced (a replicated consumer, whose ranks each hold all of it);
  * `scatter_frames`: the sum over 'model' of row-parallel partial
    outputs, each rank keeping its frames (a reduce-scatter); the
    all-gather of the gradient backward.

The all-reduces and reduce-scatters run in fp32 whatever the activation
dtype, so a bf16 row-parallel sum rounds once. NCCL takes every one of
these collectives, and Gloo takes the collectives for CPU and CUDA
tensors alike (parallel/gloo_probe.py).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional

import torch
import torch.distributed as dist

__all__ = ["Shard", "SINGLE", "copy_to_model", "reduce_from_model",
           "gather_rows", "average_gradients", "reduce_in_buckets",
           "set_shard", "shift_stages",
           "split_frames", "gather_frames", "scatter_frames"]


@dataclasses.dataclass(frozen=True)
class Shard:
    """This process's place on the ('data', 'model') mesh: its rank and
    size on each axis and the process group along each (None in one
    process), and what the 'model' axis carries: tensor-parallel slices
    by default, with `sequence_parallel` also the residual stream's
    frames, and GPipe stages when `pipeline_microbatches` > 0 (the
    count of microbatches a step)."""

    data_rank: int = 0
    n_data: int = 1
    model_rank: int = 0
    n_model: int = 1
    data_group: Optional[dist.ProcessGroup] = None
    model_group: Optional[dist.ProcessGroup] = None
    sequence_parallel: bool = False
    pipeline_microbatches: int = 0

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


def _exchange(send: Optional[torch.Tensor], dst: Optional[int],
              like: torch.Tensor, src: Optional[int], group) -> torch.Tensor:
    """Send `send` to rank `dst` of `group` and receive a tensor shaped
    like `like` from rank `src` (zeros when `src` is None), at once. A
    CUDA tensor under Gloo rides host memory (module docstring)."""
    staged = like.is_cuda and dist.get_backend(group) == "gloo"
    if src is None:
        out = torch.zeros_like(like)
    else:
        out = torch.empty_like(like, device="cpu" if staged else None)
    ops = []
    if dst is not None:
        buf = send.contiguous()
        ops.append(dist.P2POp(dist.isend, buf.cpu() if staged else buf,
                              dist.get_global_rank(group, dst), group))
    if src is not None:
        ops.append(dist.P2POp(dist.irecv, out,
                              dist.get_global_rank(group, src), group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return out.to(like.device) if staged and src is not None else out


class _ShiftStages(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, stage, n):
        ctx.group, ctx.stage, ctx.n = group, stage, n
        return _exchange(x, stage + 1 if stage + 1 < n else None, x,
                         stage - 1 if stage > 0 else None, group)

    @staticmethod
    def backward(ctx, g):
        s, n = ctx.stage, ctx.n
        return (_exchange(g, s - 1 if s > 0 else None, g,
                          s + 1 if s + 1 < n else None, ctx.group),
                None, None, None)


def _chunk(x: torch.Tensor, shard: Shard) -> torch.Tensor:
    return x.chunk(shard.n_model, 1)[shard.model_rank].contiguous()


def _gather_frames(x: torch.Tensor, shard: Shard) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(shard.n_model)]
    dist.all_gather(parts, x.contiguous(), group=shard.model_group)
    return torch.cat(parts, 1)


def _scatter_frames(x: torch.Tensor, shard: Shard) -> torch.Tensor:
    """The fp32 sum over 'model' of x (B, T, ...), this rank's frames."""
    full = x.to(torch.float32).transpose(0, 1).contiguous()
    out = full.new_empty((full.shape[0] // shard.n_model,) + full.shape[1:])
    dist.reduce_scatter_tensor(out, full, group=shard.model_group)
    return out.transpose(0, 1).to(x.dtype).contiguous()


class _SplitFrames(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return _chunk(x, shard)

    @staticmethod
    def backward(ctx, g):
        return _gather_frames(g, ctx.shard), None


class _GatherFrames(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard, reduce_grad):
        ctx.shard, ctx.reduce_grad = shard, reduce_grad
        return _gather_frames(x, shard)

    @staticmethod
    def backward(ctx, g):
        if ctx.reduce_grad:
            return _scatter_frames(g, ctx.shard), None, None
        return _chunk(g, ctx.shard), None, None


class _ScatterFrames(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return _scatter_frames(x, shard)

    @staticmethod
    def backward(ctx, g):
        return _gather_frames(g, ctx.shard), None


def shift_stages(x: torch.Tensor, shard: Shard) -> torch.Tensor:
    """The pipeline's hand-off over 'model' (module docstring): stage
    s - 1's x on stage s, zeros on stage 0; differentiable."""
    return _ShiftStages.apply(x, shard.model_group, shard.model_rank,
                              shard.n_model)


def split_frames(x: torch.Tensor, shard: Shard) -> torch.Tensor:
    """(B, T, ...) -> this 'model' rank's T / n_model frames; backward,
    the gradient's frames gathered (module docstring)."""
    return _SplitFrames.apply(x, shard)


def gather_frames(x: torch.Tensor, shard: Shard,
                  reduce_grad: bool) -> torch.Tensor:
    """(B, T / n_model, ...) -> (B, T, ...), every rank's frames in rank
    order; backward, the gradient reduce-scattered over 'model' when
    `reduce_grad`, else this rank's frames of it (module docstring)."""
    return _GatherFrames.apply(x, shard, reduce_grad)


def scatter_frames(x: torch.Tensor, shard: Shard) -> torch.Tensor:
    """(B, T, ...) partial sums -> this rank's frames of their sum over
    'model', in fp32 and cast back; backward, the gradient's frames
    gathered (module docstring)."""
    return _ScatterFrames.apply(x, shard)


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


def reduce_in_buckets(grads: List[torch.Tensor], group, divisor: int = 1,
                      bucket_bytes: int = 256 << 20) -> None:
    """All-reduce (sum) each tensor of `grads` over `group` in place, in
    flat fp32 buckets, then divide by `divisor`; every rank of the group
    passes tensors of the same shapes in the same order."""
    bucket: List[torch.Tensor] = []
    size = 0
    for g in grads + [None]:
        if g is not None and (not bucket or size + g.nbytes <= bucket_bytes):
            bucket.append(g)
            size += g.nbytes
            continue
        if bucket:
            flat = torch.cat([q.reshape(-1).float() for q in bucket])
            dist.all_reduce(flat, group=group)
            if divisor != 1:
                flat.div_(divisor)
            for q, part in zip(bucket, flat.split([q.numel()
                                                   for q in bucket])):
                q.copy_(part.view_as(q))
        bucket, size = ([g], g.nbytes) if g is not None else ([], 0)


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
    reduce_in_buckets([p.grad for p in params], shard.data_group,
                      shard.n_data, bucket_bytes)
