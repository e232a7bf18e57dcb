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


_KERNELS = {"attention_fwd": (32, 16, 249, 64),
            "attention_bwd": (32, 16, 249, 64),
            "ln_gelu_fwd": (511968, 512), "ln_gelu_bwd": (511968, 512)}


@pytest.mark.parametrize("kernel, bf16_ms, fp32_ms", [
    ("attention_fwd", "0.019494", "0.0493"),
    ("attention_bwd", "0.034108", "0.1232"),
    ("ln_gelu_fwd", "0.31299", "0.6260"),
    ("ln_gelu_bwd", "0.46948", "0.9390"),
])
def test_kernel_bounds_by_compute_dtype(kernel, bf16_ms, fp32_ms):
    """bf16 by default, as before the dtype was an argument; at fp32 the
    kernel table's fp32 bounds (rows 1a-4a: attention at 3xTF32, the
    LN+GELU kernels by their 4-byte I/O)."""
    fn, args = getattr(roofline, kernel), _KERNELS[kernel]
    assert fn(*args) == fn(*args, "bfloat16")
    for dtype, ms in (("bfloat16", bf16_ms), ("float32", fp32_ms)):
        digits = len(ms.split(".")[1])
        assert f"{fn(*args, dtype) * 1e3:.{digits}f}" == ms, dtype


def _one_call_trace(names, device_us):
    """A trace in which each host range of `names` launched one device
    operation of `device_us` microseconds."""
    from h100bench import trace as tr

    cpu, launches, dev = [], {}, []
    for i, name in enumerate(names):
        ts = 1000.0 * i
        cpu.append((name, 1, ts, 100.0))
        launches[i] = (1, ts + 10.0)
        dev.append(("kernel", ts + 20.0, device_us, i))
    return tr.Trace(dev, launches, cpu)


class _Traced:
    counters = {}


@pytest.mark.parametrize("metric, names, bounds", [
    ("attn_roofline.train", ("FusedAttention", "FusedAttentionBackward"),
     lambda dt: roofline.attention_fwd(32, 16, 249, 64, dt)
     + roofline.attention_bwd(32, 16, 249, 64, dt)),
    ("ln_gelu_roofline.train", ("FusedLnGelu", "FusedLnGeluBackward"),
     lambda dt: (roofline.ln_gelu_fwd(511968, 512, dt)
                 + roofline.ln_gelu_bwd(511968, 512, dt))),
    ("attn_roofline.train_fp32", ("FusedAttention", "FusedAttentionBackward"),
     lambda dt: roofline.attention_fwd(32, 16, 249, 64, dt)
     + roofline.attention_bwd(32, 16, 249, 64, dt)),
])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_roofline_readers_take_the_compute_dtype(metric, names, bounds,
                                                 dtype):
    """A reader divides the bounds at the cell's compute dtype by the
    device time of what the ranges launched."""
    ctx = {"kind": "train", "batch": 32, "heads": 16, "frames": 249,
           "head_dim": 64, "channels": 512, "ln_rows": [511968],
           "dtype": dtype, "trace": _one_call_trace(names, 2000.0),
           "traced": _Traced()}
    share = spec.metric_reader(spec.HERE, metric)(ctx)
    assert share == pytest.approx(100.0 * bounds(dtype) / 4e-3)


@pytest.mark.parametrize("metric", [m["name"] for m in
                                    spec.benchmark()["per_layer"]])
def test_each_per_layer_metric_has_its_reader(metric):
    """metrics/<name>.py reads each per-layer metric; one of the fp32
    cell's ('.train_fp32', beside train_clips_per_s.fp32) is its '.train'
    twin's reader."""
    read = spec.metric_reader(spec.HERE, metric)
    twin = metric.replace(".train_fp32", ".train")
    assert read.__code__.co_filename == os.path.join(
        spec.HERE, "metrics", f"{twin}.py")


def test_device_mfu_and_per_layer_rate_read_their_context():
    """mfu.device: the step's model operations over the step's device
    time, a share of the bf16 peak; clips_per_s.train: the untraced
    stretch's clips over its seconds. Neither reads a run without them."""
    ctx = {"kind": "train", "batch": 32, "steps": 10, "stretch_s": 2.5,
           "step_flops": 98.9e12 * 0.125, "step_device_ms": 125.0}
    mfu = spec.metric_reader(spec.HERE, "mfu.device")
    rate = spec.metric_reader(spec.HERE, "clips_per_s.train")
    assert mfu(ctx) == pytest.approx(10.0)
    assert rate(ctx) == pytest.approx(128.0)
    assert mfu(dict(ctx, step_device_ms=None)) is None
    assert rate(dict(ctx, steps=0)) is None


def test_each_per_layer_metric_moves_what_its_cells_report():
    """A per-layer metric's `moves` is an end-to-end metric that every
    cell it lists reports: the host-paced cell that reads its rate per
    layer moves the step's device time."""
    bench = spec.benchmark()
    e2e = {m["name"]: set(m.get("workloads", [w["name"] for w in
                                              bench["workloads"]]))
           for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert set(m["workloads"]) <= e2e[m["moves"]], m["name"]
    for w in bench["workloads"]:
        reported = [k for k, cells in e2e.items() if w["name"] in cells]
        assert "setup_s" in reported and len(reported) >= 2, w["name"]
