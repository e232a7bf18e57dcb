"""The attention backward's share of its roofline in training, apart from
the forward: the least time of the traced steps' attention backwards
(from their shapes at the true head dim, never the padded 128) over the
device time of the operations launched inside the attention Function's
backward node (its dq and dk/dv kernels)."""

from h100bench.metrics_common import roofline_share
from h100bench import roofline


def read(ctx):
    if ctx["kind"] != "train":
        return None
    shape = (ctx["batch"], ctx["heads"], ctx["frames"], ctx["head_dim"],
             ctx["dtype"])
    return roofline_share(
        ctx, [("FusedAttentionBackward", roofline.attention_bwd(*shape))])
