"""Clips a second of the stage-1 step over the untraced stretch of a
traced run: train_clips_per_s, in the cells where it is read per layer
because the host that paces them spreads it beyond any bound."""


def read(ctx):
    if ctx["kind"] != "train" or not ctx["steps"]:
        return None
    return ctx["steps"] * ctx["batch"] / ctx["stretch_s"]
