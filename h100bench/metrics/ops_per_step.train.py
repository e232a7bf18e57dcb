"""Device operations (kernels, copies, sets) a stage-1 step, over the
profiled steps: the host dispatches each of them."""


def read(ctx):
    trace = ctx.get("trace")
    if trace is None or ctx["kind"] != "train" or not trace.device_ops:
        return None
    return len(trace.device_ops) / ctx["traced"].units
