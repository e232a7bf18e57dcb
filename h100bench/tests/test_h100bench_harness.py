"""The harness on the CPU at a tiny size: the port's train step against
the plain reference on seeded random weights; the reference run one
layer at a time giving what it gives run whole; the lower-precision
control and each planted fault coming out not correct; no run loading
JAX or the JAX package; and a cell, a traffic mix, a metric and a
configuration added as files being picked up with no edit to a file
that is there."""

import hashlib
import json
import os
import subprocess
import sys
import time

import pytest
import torch

from h100bench import run as harness, spec
from h100bench.tests import tiny

SEED = 2 ** 31 + 977
# tight on the CPU, where the port computes in fp32 like the reference
LIMITS = {"loss_gap": 1e-5, "grad_gap": 1e-2, "grad_cos_gap": 1e-4,
          "update_gap": 1e-2}
CELLS = ("tiny.train", "tiny.train_group")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(2)
    return tiny.make_root(str(tmp_path_factory.mktemp("checkout")),
                          {c: LIMITS for c in CELLS})


def _measure(root, name, fault=None, trace=False, seconds=1.0):
    cell = spec.cell(name, root=root)
    return harness.measure(cell, SEED, seconds, trace, "cpu",
                           time.perf_counter(), fault=fault)


@pytest.mark.parametrize("name", CELLS)
def test_port_agrees_with_the_reference(root, name):
    res, metrics, checks, correct = _measure(root, name)
    assert correct, checks
    assert res["failed"] == 0 and res["attempted"] > 0
    assert all(m["value"] > 0 for m in metrics.values()), metrics
    assert "setup_s" in metrics
    # the CPU runs no device operation: the step's device time reads
    # None and is left out of the line, never reading 0
    assert res["e2e"]["step_device_ms"] is None
    assert "step_device_ms" not in metrics


def _unchanged_state(trainer):
    trainer.optimizer.step = lambda: None


def _half_batch_train(trainer):
    loss = trainer._loss

    def half(z, b, alpha):
        n = z.shape[0] // 2
        return loss(z[:n], {k: v[:n] for k, v in b.items()}, alpha)
    trainer._loss = half


def _altered_loss(trainer):
    step = trainer.train_step
    trainer.train_step = lambda batch, alpha: {
        "loss": step(batch, alpha)["loss"] + 0.05}


@pytest.mark.parametrize("name, fault", [
    ("tiny.train", _unchanged_state), ("tiny.train", _half_batch_train),
    ("tiny.train", _altered_loss)])
def test_a_planted_fault_is_not_correct(root, name, fault):
    _, _, checks, correct = _measure(root, name, fault)
    assert not correct, checks


@pytest.mark.parametrize("name", CELLS)
def test_the_fp8_control_is_not_correct(root, name):
    """The reference at float8 operands in the program's place fails one
    of the cell's numbers."""
    from h100bench import calibrate

    cell = spec.cell(name, root=root)
    control = calibrate._train_control(cell, SEED, "cpu",
                                       control="fp8")["fp8"]
    assert any(v > cell.limits[k] for k, v in control.items()), control


@pytest.mark.parametrize("name", CELLS)
def test_the_reference_one_layer_at_a_time_changes_nothing(root, name,
                                                           monkeypatch):
    """Under checkpoint each layer is recomputed in the backward; with
    dropout on, its hash masks come out the same, so losses, first
    gradients and changes are bit for bit those of the layers run
    whole (checkpoint replaced by a direct call)."""
    from h100bench import traffic as gen, weights
    from h100bench.drivers import train as drv
    from h100bench.reference import model, train as ref_train

    cell = spec.cell(name, root=root)
    cfg, t = cell.config, cell.traffic
    assert cfg["hidden_dropout"] > 0 and cfg["attention_dropout"] > 0
    _, recipe = drv._stage1_config(cell, SEED)
    pool, labels = gen.train_pool(t, SEED,
                                  t["clip_seconds"] * gen.SAMPLE_RATE)
    batches = [(torch.from_numpy(pool[i]), torch.from_numpy(labels[i]))
               for i in drv.first_batches(labels, t["batch_size"], SEED,
                                          t["check_steps"])]
    calls = []

    def counted(fn, *args, **kw):
        calls.append(args[1])
        return checkpointed(fn, *args, **kw)

    def run():
        p = {k: v for k, v in weights.make(cfg, SEED, "cpu").items()
             if not k.startswith("head.")}
        return ref_train.run_steps(p, cfg, recipe, SEED, batches,
                                   t["check_steps"])

    checkpointed = model.checkpoint
    monkeypatch.setattr(model, "checkpoint", counted)
    blocked = run()
    assert calls == list(range(cfg["num_hidden_layers"])) * t["check_steps"]
    monkeypatch.setattr(model, "checkpoint",
                        lambda fn, *args, use_reentrant: fn(*args))
    whole = run()
    assert blocked["loss"] == whole["loss"]
    assert blocked["update"] == whole["update"]
    assert blocked["first"].keys() == whole["first"].keys()
    for n, g in whole["first"].items():
        assert torch.equal(blocked["first"][n], g), n


def test_traced_run_reads_its_metrics(root):
    _, metrics, _, _ = _measure(root, "tiny.train", trace=True, seconds=1.5)
    # the CPU runs no device operation: the readers of the device's trace
    # find nothing and leave their metrics out, never reading 0
    assert set(metrics) == {"mfu.train"}, metrics


_GUARD = """
import sys, time
sys.path.insert(0, {repo!r})
import torch
torch.set_num_threads(2)
from h100bench import run as harness, spec
cell = spec.cell({name!r}, root={root!r})
harness.measure(cell, 5, 0.5, {trace}, "cpu", time.perf_counter())
print("FORBIDDEN", harness.forbidden_modules())
"""


@pytest.mark.parametrize("name", CELLS)
def test_no_run_loads_jax(root, name):
    code = _GUARD.format(repo=spec.ROOT, name=name, root=root,
                         trace=name == "tiny.train_group")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=spec.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "FORBIDDEN []" in out.stdout, out.stdout[-1000:]


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxlike_pkg", sys)
    monkeypatch.setitem(sys.modules, "wav2vec_contr_loss_tpu_extra", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "flax.linen", sys)
    assert harness.forbidden_modules() == ["flax"]


def _digests(path):
    out = {}
    for d, _, files in os.walk(path):
        for f in files:
            p = os.path.join(d, f)
            if "__pycache__" not in p:
                with open(p, "rb") as fh:
                    out[os.path.relpath(p, path)] = hashlib.sha1(
                        fh.read()).hexdigest()
    return out


def test_a_cell_mix_and_metric_added_as_files(tmp_path):
    root = tiny.make_root(str(tmp_path))
    bench_dir = os.path.join(root, "h100bench")
    before = _digests(bench_dir)
    traffic = json.load(open(os.path.join(bench_dir, "traffic",
                                          "tiny_train.json")))
    traffic["batch_size"] = 4
    with open(os.path.join(bench_dir, "traffic", "tiny_b4.json"), "w") as f:
        json.dump(traffic, f)
    with open(os.path.join(bench_dir, "metrics", "rows_seen.py"), "w") as f:
        f.write("def read(ctx):\n    return ctx['batch'] * ctx['steps']\n")
    with open(os.path.join(bench_dir, "limits", "tiny.b4.json"), "w") as f:
        json.dump({k: LIMITS[k] for k in ("loss_gap", "grad_gap",
                                          "grad_cos_gap", "update_gap")}, f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["workloads"].append({"name": "tiny.b4", "config": "tiny_xlsr300m",
                               "traffic": "tiny_b4", "chips": 1,
                               "why": "added by a test"})
    bench["per_layer"].append({"name": "rows_seen", "unit": "rows",
                               "better": "higher", "source": "program_counter",
                               "layer": "stage-1 step",
                               "moves": "train_clips_per_s",
                               "workloads": ["tiny.b4"]})
    next(m for m in bench["end_to_end"]
         if m["name"] == "train_clips_per_s")["workloads"].append("tiny.b4")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    after = _digests(bench_dir)
    assert all(after[k] == v for k, v in before.items())
    cell = spec.cell("tiny.b4", root=root)
    assert [m["name"] for m in cell.per_layer] == ["rows_seen"]
    res, metrics, checks, correct = harness.measure(
        cell, SEED, 1.0, True, "cpu", time.perf_counter())
    assert correct, checks
    assert metrics["rows_seen"]["value"] == 4 * res["ctx"]["steps"]


def test_a_configuration_at_another_precision_added_as_files(tmp_path):
    """A configuration whose compute dtype differs is a configuration file:
    configs/xlsr300m_fp32.json cut to the tiny widths, a cell under the
    tiny traffic and its limits are picked up with no edit to a file that
    is there, run at the file's dtype, read against its control, and
    reported under the metrics that name the fp32 cell."""
    from h100bench import calibrate

    root = tiny.make_root(str(tmp_path))
    bench_dir = os.path.join(root, "h100bench")
    before = _digests(bench_dir)
    with open(os.path.join(bench_dir, "configs", "xlsr300m_fp32.json")) as f:
        cfg = json.load(f)
    cfg.update({k: v for k, v in tiny.TINY.items() if k != "compute_dtype"})
    with open(os.path.join(bench_dir, "configs", "tiny_fp32.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(bench_dir, "limits", "tiny_fp32.train.json"),
              "w") as f:
        json.dump(LIMITS, f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "tiny_fp32", "source": "tests",
                             "file": "h100bench/configs/tiny_fp32.json",
                             "reduced": [], "why": "added by a test"})
    bench["workloads"].append({"name": "tiny_fp32.train",
                               "config": "tiny_fp32", "traffic": "tiny_train",
                               "chips": 1, "why": "added by a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "xlsr300m_fp32.train_b32" in m.get("workloads", ()):
            m["workloads"].append("tiny_fp32.train")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    after = _digests(bench_dir)
    assert all(after[k] == v for k, v in before.items())
    cell = spec.cell("tiny_fp32.train", root=root)
    assert cell.config["compute_dtype"] == "float32"
    assert calibrate.CONTROLS["float32"] == "tf32"
    res, metrics, checks, correct = harness.measure(
        cell, SEED, 1.0, True, "cpu", time.perf_counter())
    assert correct, checks
    assert res["ctx"]["dtype"] == "float32"
    assert set(metrics) == {"mfu.train_fp32"}, metrics
    res, metrics, _, _ = harness.measure(cell, SEED, 1.0, False, "cpu",
                                         time.perf_counter())
    assert set(metrics) == {"train_clips_per_s.fp32", "setup_s"}, metrics
    assert metrics["train_clips_per_s.fp32"]["value"] == \
        res["e2e"]["train_clips_per_s"]
