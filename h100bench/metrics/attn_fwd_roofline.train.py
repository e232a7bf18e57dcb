"""The attention forward's share of its roofline in training, apart from
the backward: the least time of the traced steps' attention forwards
(forward and remat recompute; from their shapes at the true head dim,
120 at XLS-R 2B and not the 128 the kernel pads its contraction to) over
the device time of the operations launched inside the attention
Function's forward."""

from h100bench.metrics_common import roofline_share
from h100bench import roofline


def read(ctx):
    if ctx["kind"] != "train":
        return None
    shape = (ctx["batch"], ctx["heads"], ctx["frames"], ctx["head_dim"],
             ctx["dtype"])
    return roofline_share(
        ctx, [("FusedAttention", roofline.attention_fwd(*shape))])
