"""Device idle milliseconds a stage-1 step in the gaps that a launch
inside the program's `w2v.optimizer` spans ended, over the stretch
traced with the host's operators (h100bench/spans.py)."""

from h100bench import spans


def read(ctx):
    if ctx["kind"] != "train":
        return None
    return spans.read(ctx, "w2v.optimizer", "idle_ms")
