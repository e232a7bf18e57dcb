"""Share of the device's time idle in training: the share of a
stretch traced with the device's activity alone in which no device
operation ran (one minus the union of the operations' intervals over
the stretch's seconds)."""

from h100bench.metrics_common import idle_share


def read(ctx):
    return idle_share(ctx) if ctx["kind"] == "train" else None
