"""mfu.train in the cells that report train_clips_per_s.fp32 (the fp32
cell, whose steadier rate has a bound of its own)."""

from h100bench.metrics_common import same_as

read = same_as(__file__, "mfu.train")
