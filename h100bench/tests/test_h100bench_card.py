"""On the card, at each cell's own size: the control (the reference at
the precision below the configuration's in the program's place: float8
operands under bf16 compute; TF32 under fp32) fails one of the cell's
numbers, and the program on a fresh seed passes
them. Run on the chip:

    python3 -m pytest h100bench/tests/test_h100bench_card.py -q
"""

import time

import pytest

from h100bench import calibrate, run as harness, spec

SEED = 2 ** 31 + 4242


@pytest.mark.card
@pytest.mark.parametrize("name", ["xlsr300m.train_b32",
                                  "xlsr300m_fp32.train_b32"])
def test_control_fails_and_program_passes(card, name):
    cell = spec.cell(name)
    out = calibrate._train_control(cell, SEED, "cuda")
    control = out[calibrate.CONTROLS[cell.config["compute_dtype"]]]
    assert any(v > cell.limits[k] for k, v in control.items()), out
    _, _, checks, correct = harness.measure(cell, SEED, 3.0, False, "cuda",
                                            time.perf_counter())
    assert correct, checks
