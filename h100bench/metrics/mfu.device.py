"""Model FLOP utilization of the stage-1 step's device time: the step's
model operations (as mfu.train counts them) over the step's device time
(the union of its device operations' intervals, over the steps traced
with the device's activity alone after the window), as a share of the
H100's bf16 peak. It bounds what the kernels' rooflines can give to
step_device_ms, as mfu.train does for the rate."""

from h100bench import roofline


def read(ctx):
    if ctx["kind"] != "train" or not ctx.get("step_device_ms"):
        return None
    rate = ctx["step_flops"] / (ctx["step_device_ms"] / 1e3)
    return 100.0 * rate / roofline.BF16_FLOP_PER_S
