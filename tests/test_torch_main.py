"""The port's front door: `python -m wav2vec_contr_loss_torch` lists
exactly the commands the port has (22, all of the JAX package's, the
last of them bench_components), refuses an unknown one, passes `--help`
to every command (the five of the baseline and features slice, the
three of the serving slice and bench_components among them), and
`doctor --device cpu` reports the card's checks as absent, passes the
waveform-cache check and fails. ~16 s alone."""

import importlib
import os
import pkgutil
import subprocess
import sys

import pytest

from tests.test_torch_bridge import cap_torch_threads
from wav2vec_contr_loss_tpu import __main__ as jax_front
from wav2vec_contr_loss_torch import __main__ as front, cli
from wav2vec_contr_loss_torch.cli import doctor

cap_torch_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(*args):
    return subprocess.run([sys.executable, "-m", "wav2vec_contr_loss_torch",
                           *args], cwd=REPO, capture_output=True, text=True,
                          timeout=120)


def test_lists_exactly_the_port_commands():
    modules = {m.name for m in pkgutil.iter_modules(cli.__path__)
               if hasattr(importlib.import_module(f"{cli.__name__}.{m.name}"),
                          "main")}
    assert set(front.COMMANDS) == modules
    out = _run()
    assert out.returncode == 0
    listed = [ln.split()[0] for ln in out.stdout.splitlines()
              if ln.startswith("  ")]
    assert listed == list(front.COMMANDS)
    # every command of the JAX package
    assert len(listed) == 22
    assert set(listed) == set(jax_front.COMMANDS)
    for present in ("train_baseline", "score_baseline",
                    "score_famous_figures", "extract_encoder_features",
                    "cache_waveforms", "export_serving", "run_sweep",
                    "verify_parity", "bench_components"):
        assert present in listed


def test_unknown_command_exits_2():
    out = _run("no_such_command")
    assert out.returncode == 2
    assert "unknown command" in out.stderr


@pytest.mark.parametrize("command", list(front.COMMANDS))
def test_every_command_takes_help(command, capsys):
    with pytest.raises(SystemExit) as e:
        front.main([command, "--help"])
    assert e.value.code == 0
    assert "usage:" in capsys.readouterr().out


def test_doctor_on_the_cpu_names_the_absent_card(capsys):
    with pytest.raises(SystemExit) as e:
        doctor.main(["--device", "cpu"])
    assert e.value.code == 1
    out = capsys.readouterr().out
    for name in ("card", "nvcc", "triton", "CUDA kernel builds"):
        assert f"[FAIL] {name}: absent (--device cpu)" in out
    for name in ("native audio decoder", "eval forward (tiny encoder)",
                 "torch.distributed", "checkpoint write/restore",
                 "waveform cache"):
        assert f"[ ok ] {name}:" in out
    assert "launches attention 0, LN+GELU 0" in out
    assert "Gloo available; not launched under torchrun (one process)" in out
    assert "cache built, reused and read back bit for bit" in out
    assert "==> doctor: 5/9 checks passed" in out


def test_doctor_reports_the_torchrun_gang(monkeypatch, capsys):
    """Under torchrun's variables the distributed check names the gang."""
    for key, value in (("RANK", "1"), ("WORLD_SIZE", "2"), ("LOCAL_RANK", "1"),
                       ("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", "29500")):
        monkeypatch.setenv(key, value)
    with pytest.raises(SystemExit):
        doctor.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert ("[ ok ] torch.distributed: NCCL" in out
            and "launched under torchrun: world size 2, rank 1, local rank 1"
            in out)
