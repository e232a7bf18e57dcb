"""Device milliseconds a stage-1 step of the operations launched inside
the program's `w2v.attention` spans: every attention forward, in the
forward and in the remat recompute, over the stretch traced with the
host's operators (h100bench/spans.py); the backward's kernels land in
`w2v.backward`. Nothing to read from a program without the span."""

from h100bench import spans


def read(ctx):
    if ctx["kind"] != "train":
        return None
    return spans.read(ctx, "w2v.attention", "device_ms")
