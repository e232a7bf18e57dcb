"""The positional conv's share of its roofline in training: the least
time of the traced steps' positional convs, one conv in each forward and
two in each backward (the input and the weight gradient), from the
shapes at the true group width (120 at XLS-R 2B, never the 128 that a
kernel pads its contraction to), over the device time of the operations
launched inside the grouped conv Function's forward (`_GroupConv`) and
its backward node. The conv's groups and kernel are those of the
benchmark's one configuration of the traced run's width, heads and
compute dtype. Nothing to read where no such Function ran (groups a
multiple of 64 channels wide take cuDNN's conv)."""

import json
import os

from h100bench import roofline, spec
from h100bench.metrics_common import roofline_share


def pos_conv(b: int, t: int, d: int, groups: int, k: int,
             dtype: str = "bfloat16") -> float:
    """Least seconds of one conv of (b, t, d) frames: x read and y
    written, the weight read once, at the compute dtype; 2 b t d (d /
    groups) k operations, on the bf16 tensor cores at bfloat16."""
    e = roofline.ELEMENT_BYTES[dtype]
    nbytes = 2 * b * t * d * e + d * (d // groups) * k * e
    rate = (roofline.BF16_FLOP_PER_S if dtype == "bfloat16"
            else roofline.FP32_FLOP_PER_S)
    return roofline.least_seconds(nbytes, 2.0 * b * t * d * (d // groups) * k,
                                  rate)


def geometry(hidden: int, heads: int, dtype: str):
    """(groups, kernel) of the positional conv of the benchmark's
    configurations of this width, heads and compute dtype; None where
    there is none. Configurations that disagree raise: the traced run's
    conv is then not known."""
    found = set()
    for c in spec.benchmark()["configs"]:
        with open(os.path.join(spec.ROOT, c["file"])) as f:
            cfg = json.load(f)
        if (cfg["hidden_size"], cfg["num_attention_heads"],
                cfg["compute_dtype"]) == (hidden, heads, dtype):
            found.add((cfg["num_conv_pos_embedding_groups"],
                       cfg["num_conv_pos_embeddings"]))
    if len(found) > 1:
        raise ValueError(
            f"configurations of width {hidden}, {heads} heads, {dtype} "
            f"disagree on the positional conv's (groups, kernel): "
            f"{sorted(found)}; the train driver's ctx has to name it")
    return found.pop() if found else None


def read(ctx):
    if ctx["kind"] != "train":
        return None
    d = ctx["heads"] * ctx["head_dim"]
    geo = geometry(d, ctx["heads"], ctx["dtype"])
    if geo is None:
        return None
    one = pos_conv(ctx["batch"], ctx["frames"], d, *geo, ctx["dtype"])
    return roofline_share(
        ctx, [("_GroupConv", one), ("_GroupConvBackward", 2 * one)])
