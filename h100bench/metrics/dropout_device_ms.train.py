"""Device milliseconds a stage-1 step of the operations launched inside
the program's `w2v.dropout` spans: every murmur-dropout site, in the
forward and in the remat recompute, over the stretch traced with the
host's operators (h100bench/spans.py)."""

from h100bench import spans


def read(ctx):
    if ctx["kind"] != "train":
        return None
    return spans.read(ctx, "w2v.dropout", "device_ms")
