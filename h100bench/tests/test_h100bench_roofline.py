"""The FLOP and byte functions against the project's kernel table: the
attention forward and backward at (32, 16, 249, 64), the LN+GELU
backward at 511,968 rows, and the forward of one 5 s clip."""

import json
import os

import pytest

from h100bench import roofline, spec


def _cfg():
    with open(os.path.join(spec.HERE, "configs", "xlsr300m.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("fn, args, ms", [
    (roofline.attention_fwd, (32, 16, 249, 64), 0.0195),
    (roofline.attention_bwd, (32, 16, 249, 64), 0.0341),
    (roofline.ln_gelu_bwd, (511968, 512), 0.4695),
    (roofline.attention_fwd, (8, 16, 249, 64), 0.0049),
    (roofline.ln_gelu_fwd, (127992, 512), 0.0782),
])
def test_kernel_bounds_match_the_kernel_table(fn, args, ms):
    assert round(fn(*args) * 1e3, 4) == ms


def test_clip_forward_is_186_gflop():
    parts = roofline.forward_flops(_cfg(), 80000)
    assert round(parts["conv"] / 1e9, 1) == 24.5
    assert round(parts["pos_conv"] / 1e9, 1) == 4.2
    assert round(parts["layers"] / 1e9, 1) == 156.5
    assert round(parts["projections"] / 1e9, 1) == 0.4
    assert round(roofline.clip_forward_flops(_cfg(), 80000) / 1e9) == 186
    step = roofline.train_step_flops(_cfg(), 80000, 32)
    assert 17.7e12 < step < 17.9e12


def test_frames_and_rows():
    assert roofline.conv_lengths(_cfg(), 80000)[-1] == 249
    assert roofline.ln_gelu_rows(_cfg(), 80000, 32)[0] == 511968
