"""The conv extractor's LayerNorm+GELU share of its roofline in training:
the least time of the 7 forwards and 7 backwards a step (rows of each
conv's output, from the shapes, with I/O at the configuration's compute
dtype) times the profiled steps, over the device time of the operations
launched inside the LN+GELU Function's forward and its backward node.
Nothing to read where the extractor has no LayerNorm+GELU (a 'group'
extractor)."""

from h100bench.metrics_common import roofline_share
from h100bench import roofline


def read(ctx):
    if ctx["kind"] != "train":
        return None
    c, dtype = ctx["channels"], ctx["dtype"]
    n = len(ctx["ln_rows"])
    fwd = sum(roofline.ln_gelu_fwd(r, c, dtype) for r in ctx["ln_rows"]) / n
    bwd = sum(roofline.ln_gelu_bwd(r, c, dtype) for r in ctx["ln_rows"]) / n
    return roofline_share(
        ctx, [("FusedLnGelu", fwd), ("FusedLnGeluBackward", bwd)])
