"""Host milliseconds a stage-1 step inside the program's `w2v.step`
spans: the host's time to enqueue one step, over the stretch traced with
the host's operators, which costs the host more a step than an untraced
run (h100bench/spans.py)."""

from h100bench import spans


def read(ctx):
    if ctx["kind"] != "train":
        return None
    return spans.read(ctx, "w2v.step", "host_ms")
