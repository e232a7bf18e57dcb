"""Host milliseconds a stage-1 step inside the program's `w2v.optimizer`
spans (clearing the gradients, AdamW with its clip, a gang's gradient
averaging) on the main thread, over the stretch traced with the host's
operators, which costs the host more a step than an untraced run
(h100bench/spans.py)."""

from h100bench import spans


def read(ctx):
    if ctx["kind"] != "train":
        return None
    return spans.read(ctx, "w2v.optimizer", "host_ms")
