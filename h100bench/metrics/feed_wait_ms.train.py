"""Milliseconds a stage-1 step that the main thread waited inside the
program's `w2v.feed_wait` spans for the prefetch's next batch, over the
stretch traced with the host's operators (h100bench/spans.py)."""

from h100bench import spans


def read(ctx):
    if ctx["kind"] != "train":
        return None
    return spans.read(ctx, "w2v.feed_wait", "host_ms")
