"""XLS-R 2B's configuration in the harness, on the CPU: the operations of
one of its 5 s clips by hand; and a tiny cell of its layout at head dim
120 (2 layers of 240, 2 heads of 120, the tiny traffic), where the
port's train step agrees with the plain reference on seeded random
weights and the lower-precision control and each planted fault come out
not correct, as in the tiny cells of test_h100bench_harness.py. On the
card (`card`-marked): the two cells this configuration and the B = 64
traffic brought, their fp8 control failing and the program passing."""

import json
import os
import time

import pytest
import torch

from h100bench import roofline, run as harness, spec
from h100bench.tests import test_h100bench_harness as th, tiny

CELL = "tiny.train_hd120"
HD120 = dict(tiny.TINY, hidden_size=240, num_attention_heads=2,
             intermediate_size=480)


def _cfg(name):
    with open(os.path.join(spec.HERE, "configs", f"{name}.json")) as f:
        return json.load(f)


def test_clip_forward_is_1120_gflop():
    """By hand, T = 249 frames: a layer 2 T (4 d^2 + 2 d f) + 4 T^2 d =
    22.506 GFLOP at d = 1920, f = 7680, 48 of them 1,080.3; the
    positional conv 2 T d (d / 16) 128 = 14.7; the projections 0.7; the
    extractor's 24.5 as XLS-R 300M's."""
    cfg = _cfg("xlsr2b")
    parts = roofline.forward_flops(cfg, 80000)
    assert round(parts["layers"] / 1e9, 1) == 1080.3
    assert round(parts["pos_conv"] / 1e9, 1) == 14.7
    assert round(parts["projections"] / 1e9, 1) == 0.7
    assert parts["conv"] == roofline.forward_flops(_cfg("xlsr300m"),
                                                   80000)["conv"]
    assert round(roofline.clip_forward_flops(cfg, 80000) / 1e8) == 11202
    assert 107.5e12 < roofline.train_step_flops(cfg, 80000, 32) < 107.6e12
    assert cfg["hidden_size"] // cfg["num_attention_heads"] == 120


def test_attention_bounds_at_head_dim_120():
    """The roofline counts the true head dim, not the kernels' padded
    contraction of 128: bytes bound both at (32, 16, 249, 120)."""
    assert round(roofline.attention_fwd(32, 16, 249, 120) * 1e3, 4) == 0.0365
    assert round(roofline.attention_bwd(32, 16, 249, 120) * 1e3, 4) == 0.0639
    assert roofline.attention_fwd(32, 16, 249, 120) < \
        roofline.attention_fwd(32, 16, 249, 128)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(2)
    root = tiny.make_root(str(tmp_path_factory.mktemp("checkout")),
                          {CELL: th.LIMITS})
    bench_dir = os.path.join(root, "h100bench")
    cfg = dict(_cfg("xlsr2b"), **HD120)
    with open(os.path.join(bench_dir, "configs", "tiny_xlsr2b.json"),
              "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "tiny_xlsr2b", "source": "tests",
                             "file": "h100bench/configs/tiny_xlsr2b.json",
                             "reduced": [], "why": "tests"})
    bench["workloads"].append({"name": CELL, "config": "tiny_xlsr2b",
                               "traffic": "tiny_train", "chips": 1,
                               "why": "tests"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "xlsr2b.train_b32" in m.get("workloads", ()):
            m["workloads"].append(CELL)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root


def _measure(root, fault=None):
    cell = spec.cell(CELL, root=root)
    assert cell.config["hidden_size"] // \
        cell.config["num_attention_heads"] == 120
    return harness.measure(cell, th.SEED, 1.0, False, "cpu",
                           time.perf_counter(), fault=fault)


def test_port_agrees_with_the_reference_at_head_dim_120(root):
    res, metrics, checks, correct = _measure(root)
    assert correct, checks
    assert res["failed"] == 0 and res["attempted"] > 0
    assert res["ctx"]["head_dim"] == 120
    assert "setup_s" in metrics


@pytest.mark.parametrize("fault", [th._unchanged_state,
                                   th._half_batch_train, th._altered_loss])
def test_a_planted_fault_is_not_correct_at_head_dim_120(root, fault):
    _, _, checks, correct = _measure(root, fault)
    assert not correct, checks


def test_the_fp8_control_is_not_correct_at_head_dim_120(root):
    from h100bench import calibrate

    cell = spec.cell(CELL, root=root)
    control = calibrate._train_control(cell, th.SEED, "cpu",
                                       control="fp8")["fp8"]
    assert any(v > cell.limits[k] for k, v in control.items()), control


@pytest.mark.card
@pytest.mark.parametrize("name", ["xlsr2b.train_b32", "xlsr300m.train_b64"])
def test_control_fails_and_program_passes_on_the_card(card, name):
    """As test_h100bench_card.py, for the two cells this configuration
    and the B = 64 traffic brought: the fp8 control fails one of the
    cell's numbers, and the program on a fresh seed passes them."""
    from h100bench import calibrate

    seed = 2 ** 31 + 4343
    cell = spec.cell(name)
    out = calibrate._train_control(cell, seed, "cuda")
    assert any(v > cell.limits[k] for k, v in out["fp8"].items()), out
    _, _, checks, correct = harness.measure(cell, seed, 3.0, False, "cuda",
                                            time.perf_counter())
    assert correct, checks
