"""Model FLOP utilization of the stage-1 step: the step's model
operations (three forwards of the batch at the config's shapes,
recomputation not counted) times the steps of the untraced stretch, over
its seconds, as a share of the H100's bf16 peak."""

from h100bench import roofline


def read(ctx):
    if ctx["kind"] != "train" or not ctx["steps"]:
        return None
    rate = ctx["steps"] * ctx["step_flops"] / ctx["stretch_s"]
    return 100.0 * rate / roofline.BF16_FLOP_PER_S
