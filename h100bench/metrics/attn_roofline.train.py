"""Attention's share of its roofline in training: the least time of the
attention forwards and backwards of the profiled steps (from their
shapes, at the configuration's compute dtype: the bf16 tensor cores, or
3xTF32 at fp32) over the device time of the operations launched inside
the attention Function's forward and its backward node."""

from h100bench.metrics_common import roofline_share
from h100bench import roofline


def read(ctx):
    if ctx["kind"] != "train":
        return None
    shape = (ctx["batch"], ctx["heads"], ctx["frames"], ctx["head_dim"],
             ctx["dtype"])
    return roofline_share(
        ctx, [("FusedAttention", roofline.attention_fwd(*shape)),
              ("FusedAttentionBackward", roofline.attention_bwd(*shape))])
