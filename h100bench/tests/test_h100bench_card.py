"""On the card, at each cell's own size: the fp8 control (the reference
at float8 operands in the program's place) fails one of the cell's
numbers, and the program on a fresh seed passes them. Run on the chip:

    python3 -m pytest h100bench/tests/test_h100bench_card.py -q
"""

import time

import pytest

from h100bench import calibrate, run as harness, spec

SEED = 2 ** 31 + 4242


@pytest.mark.card
@pytest.mark.parametrize("name", ["xlsr300m.train_b32"])
def test_control_fails_and_program_passes(card, name):
    cell = spec.cell(name)
    control = calibrate._train_control(cell, SEED, "cuda")["fp8"]
    assert any(v > cell.limits[k] for k, v in control.items()), control
    _, _, checks, correct = harness.measure(cell, SEED, 3.0, False, "cuda",
                                            time.perf_counter())
    assert correct, checks
