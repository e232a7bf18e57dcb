"""GPipe pipeline parallelism over the encoder's layer stack.

The port of wav2vec_contr_loss_tpu/parallel/pipeline.py (`gpipe_stack`).
Under `param_sharding='pp'` the mesh's 'model' axis carries S stages:
stage s holds layers [s*L/S, (s+1)*L/S) (parallel/mesh.py frees the
others), the batch is cut into M microbatches, and M + S - 1 ticks run
on every stage. At tick t stage s runs microbatch t - s through its
layers, or passes its input on unchanged in a bubble tick (t < s or
t - s >= M: the GPipe bubble, (S-1)/(M+S-1) of the ticks); then one
`shift_stages` hands every stage's output to the next stage, and stage
0 takes its next microbatch from the input instead.

Each stage keeps fp32 partial sums of its own layers' outputs for the
encoder's K-state mean; one fp32 all-reduce over 'model' closes the
pipe (`reduce_from_model`, JAX pipeline.py:163-173): every stage but
the last contributes zeros to the outputs, and the partial sums add up.

Autograd's order. The gang's backward meets the hand-offs of the
forward in reverse, and every rank must reach them in the same order or
the gang deadlocks. The schedule is the same program on every stage:
stage 0 picks its input with `torch.where` between the microbatch and
what the hand-off brought (zeros), the other stages between the
microbatch and the hand-off, and every stage writes each tick's output
into the collected outputs with `torch.where` (kept by the last stage
only). So on every rank the hand-off of tick t feeds tick t + 1, whose
output feeds the hand-off of tick t + 1 or the collected outputs: each
hand-off's backward is reached, and only after the next tick's. The
zero-weight uses cost one select a tick.

The pipe's input reaches the layers of stage 0 alone, so the caller
passes it through `copy_to_model` (identity forward, all-reduce over
'model' backward): every stage then holds one process's gradient for
what lies before the stack. The layers' random draws are the caller's
(`layer_fn` gets the global layer index and the microbatch), so a pipe
draws what one process draws.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch

from .collectives import Shard, reduce_from_model, shift_stages

__all__ = ["gpipe_stack"]


def gpipe_stack(layer_fn: Callable[[int, torch.Tensor, Tuple, int],
                                   torch.Tensor],
                n_layers: int, x: torch.Tensor, consts: Sequence[torch.Tensor],
                shard: Shard, n_micro: int,
                sum_dtype: torch.dtype = torch.float32
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run `n_layers` layers as an S-stage pipeline over 'model' (S =
    shard.n_model; one stage without a 'model' group).

    layer_fn(i, h, consts_mb, m) -> h': global layer i (of this stage)
        on microbatch m's rows h, with consts_mb its rows of `consts`.
    x:       (B, ...) the stack's input, this data rank's rows.
    consts:  (B, ...) tensors every layer reads (the attention key bias),
             cut into microbatches with x.
    n_micro: M microbatches; B % M == 0.

    -> (h_last, layer_sum): the last layer's output and the sum of all
    L layers' outputs in `sum_dtype`, both (B, ...) and the same on every
    stage."""
    n_stages = shard.n_model if shard.model_group is not None else 1
    if n_layers % n_stages:
        raise ValueError(f"gpipe_stack: {n_layers} layers not divisible by "
                         f"{n_stages} pipeline stages")
    batch = x.shape[0]
    if batch % n_micro:
        raise ValueError(f"gpipe_stack: batch {batch} not divisible by "
                         f"n_micro={n_micro}")
    M, S = n_micro, n_stages
    s = shard.model_rank if S > 1 else 0
    per = n_layers // S
    mb = batch // M
    xq = x.split(mb)
    cq = [tuple(c[m * mb:(m + 1) * mb] for c in consts) for m in range(M)]
    # device flags made by fills: no host-to-device copy, no sync
    flag = {v: torch.full((), v, dtype=torch.bool, device=x.device)
            for v in (False, True)}
    first = flag[s == 0]
    zeros = x.new_zeros((mb,) + x.shape[1:])
    h_prev = zeros
    out_h = [zeros] * M
    out_sum = [None] * M
    for t in range(M + S - 1):
        m = t - s
        h = torch.where(first, xq[min(t, M - 1)], h_prev)
        if 0 <= m < M:
            acc = None
            for i in range(s * per, (s + 1) * per):
                h = layer_fn(i, h, cq[m], m)
                acc = h.to(sum_dtype) if acc is None else acc + h.to(
                    sum_dtype)
            out_sum[m] = acc
        keep = flag[s == S - 1 and 0 <= m < M]
        slot = min(max(m, 0), M - 1)
        out_h[slot] = torch.where(keep, h, out_h[slot])
        if S > 1 and t < M + S - 2:
            h_prev = shift_stages(h, shard)
    h_last, layer_sum = torch.cat(out_h), torch.cat(out_sum)
    if S > 1:
        h_last = reduce_from_model(h_last, shard)
        layer_sum = reduce_from_model(layer_sum, shard)
    return h_last, layer_sum
