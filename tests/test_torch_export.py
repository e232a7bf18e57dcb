"""The port's serving artifact on the CPU: `SpoofScorer.export` ->
file -> `eval.artifact.load_exported` against the live scorer (float32
and int16 wire, fp32 and int8), the two kernels as custom-op nodes of the
program, the header's `ExportSpec`, a JAX `.jaxexport` refused and
agreeing with the port's artifact on the same weights, a fresh
interpreter that loads an artifact without model code or JAX, the
`export_serving` CLI, and `serve --artifact` against checkpoint mode with
every conflicting flag refused. Budget: ~30 s alone."""

import io
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from wav2vec_contr_loss_tpu.config import Stage1Config as JaxStage1Config
from wav2vec_contr_loss_tpu.config import Stage2Config as JaxStage2Config
from wav2vec_contr_loss_tpu.eval.serving import SpoofScorer as JaxScorer
from wav2vec_contr_loss_tpu.eval.serving import \
    load_exported as jax_load_exported
from wav2vec_contr_loss_tpu.models.heads import build_head as jax_build_head
from wav2vec_contr_loss_tpu.train import Stage1Trainer as JaxTrainer

from tests.test_export_serving import TINY_ENC
from tests.test_torch_bridge import cap_torch_threads, perturbed, port_config
from wav2vec_contr_loss_torch import (Stage1Config, Stage1Trainer,
                                      SpoofScorer, Stage2Config,
                                      jax_params_to_torch)
from wav2vec_contr_loss_torch.bridge import head_state_dict, random_jax_trees
from wav2vec_contr_loss_torch.cli import export_serving, serve
from wav2vec_contr_loss_torch.data.audio import write_wav
from wav2vec_contr_loss_torch.eval.artifact import (ExportSpec,
                                                    load_exported,
                                                    unwrap_export)
from wav2vec_contr_loss_torch.ops.wire import quantize_wire
from wav2vec_contr_loss_torch.train import checkpoint as ckpt
from wav2vec_contr_loss_torch.train.stage2 import STAGE2_BEST

cap_torch_threads()

SR = 16000
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# fp32 on both sides, the same graph: tests/test_export_serving.py's bound
ATOL = 1e-5


@pytest.fixture(scope="module")
def weights():
    """(JAX encoder, compression and head trees, port weights) of the
    tiny encoder of tests/test_export_serving.py, seeded."""
    enc, comp, _ = random_jax_trees(port_config(TINY_ENC), comp_dim=16,
                                    seed=4)
    head = perturbed(jax_build_head("linear", 8).init(
        jax.random.PRNGKey(1), jnp.zeros((1, 16)))["params"], 2)
    return (enc, comp, head), jax_params_to_torch(port_config(TINY_ENC), enc,
                                                  comp, head)


def _scorer(weights, quantize="none"):
    return SpoofScorer(port_config(TINY_ENC), weights[1],
                       Stage2Config(in_dim=16), max_duration_seconds=1,
                       device="cpu", quantize=quantize)


def _waves(batch=4):
    rng = np.random.default_rng(0)
    w = rng.normal(0, 0.2, (batch, SR)).astype(np.float32)
    w[:, 12000:] = 0.0
    w[1, 5000:] = 0.0
    return w


@pytest.mark.parametrize("quantize,wire", [
    ("none", "float32"), ("none", "int16"), ("w8", "int16"),
    ("w8a8", "float32")])
def test_export_round_trip(weights, tmp_path, quantize, wire):
    scorer = _scorer(weights, quantize)
    waves = _waves()
    want = scorer.score_waveforms(waves, wire=wire)
    path = tmp_path / "scorer.w2vexport"
    path.write_bytes(scorer.export(4, wire=wire))
    loaded, spec = load_exported(str(path), with_spec=True)
    assert spec == ExportSpec(4, SR, wire, SR, quantize, "cpu")
    assert loaded.device == torch.device("cpu")
    assert loaded.num_samples == SR
    # the two kernels are ops of the program; w8a8's products are int8 x
    # int8 -> int32, 6 a layer
    targets = _targets(path.read_bytes())
    assert targets.count("w2v_torch.attention_fwd.default") == 2
    assert targets.count("w2v_torch.ln_gelu_fwd.default") == 2
    assert sum("_int_mm" in t for t in targets) == (
        12 if quantize == "w8a8" else 0)
    x = quantize_wire(waves) if wire == "int16" else waves
    got = loaded(x)
    assert got.shape == (4,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    # run() has SpoofScorer.run's shape, so the server takes either
    z, logits = loaded.run(torch.from_numpy(x))
    assert z is None
    np.testing.assert_array_equal(logits.numpy(), got.numpy())
    # the program's input is static: another shape or dtype is refused
    with pytest.raises(ValueError, match="takes"):
        loaded(x[:2])


def _targets(blob: bytes) -> list:
    program = torch.export.load(io.BytesIO(unwrap_export(blob)[0]))
    return [str(n.target) for n in program.graph.nodes
            if n.op == "call_function"]


def test_program_holds_the_two_kernels_as_ops():
    """At XLS-R-300M's depth and conv tower (24 layers, 7 convs), tiny
    widths: 24 attention and 7 LN+GELU custom-op nodes."""
    from wav2vec_contr_loss_torch import XLSR_300M

    cfg = XLSR_300M.with_(hidden_size=32, num_heads=4, intermediate_size=64,
                          conv_dim=(16,) * 7, num_conv_pos_embeddings=16,
                          num_conv_pos_embedding_groups=4, dtype="float32")
    w = jax_params_to_torch(cfg, *random_jax_trees(cfg, comp_dim=16, seed=5))
    targets = _targets(SpoofScorer(cfg, w, Stage2Config(in_dim=16),
                                   max_duration_seconds=1,
                                   device="cpu").export(2))
    assert targets.count("w2v_torch.attention_fwd.default") == 24
    assert targets.count("w2v_torch.ln_gelu_fwd.default") == 7


def test_jax_artifact_is_refused_and_agrees(weights, tmp_path):
    (enc, comp, head), w = weights
    cfg = JaxStage1Config(batch_size=4, input_dim=32, hidden_dim=16,
                          max_duration_seconds=1, use_rawboost=False,
                          finetune_encoder=False, compute_dtype="float32")
    trainer = JaxTrainer(cfg, enc_config=TINY_ENC, enc_params=enc)
    state = trainer.init_state()
    state = state.replace(params=dict(state.params, compression=comp))
    jax_scorer = JaxScorer(trainer, state, JaxStage2Config(), head)
    jax_path = tmp_path / "scorer.jaxexport"
    jax_path.write_bytes(jax_scorer.export(4, platforms=("cpu",)))
    with pytest.raises(ValueError, match="wav2vec_contr_loss_tpu"):
        load_exported(str(jax_path))
    port_path = tmp_path / "scorer.w2vexport"
    port_path.write_bytes(_scorer(weights).export(4))
    waves = _waves()
    want = np.asarray(jax_load_exported(str(jax_path))(jnp.asarray(waves)))
    got = load_exported(str(port_path))(waves).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
    # and the JAX loader does not take the port's file as its own
    assert not port_path.read_bytes().startswith(b"W2VEXPT1")


def test_device_is_fixed_at_export(weights, tmp_path):
    path = tmp_path / "scorer.w2vexport"
    path.write_bytes(_scorer(weights).export(4))
    with pytest.raises(ValueError, match="traced for 'cpu'"):
        load_exported(str(path), device="cuda")
    bare = tmp_path / "bare.bin"
    bare.write_bytes(unwrap_export(path.read_bytes())[0])
    with pytest.raises(ValueError, match="not a serving artifact"):
        load_exported(str(bare))


def test_fresh_interpreter_loads_without_model_code(weights, tmp_path):
    path = tmp_path / "scorer.w2vexport"
    path.write_bytes(_scorer(weights).export(4))
    np.save(tmp_path / "waves.npy", _waves())
    code = (
        "import sys\n"
        "import numpy as np\n"
        "from wav2vec_contr_loss_torch.eval.artifact import load_exported\n"
        f"scorer = load_exported({str(path)!r})\n"
        f"logits = scorer(np.load({str(tmp_path / 'waves.npy')!r}))\n"
        "print(' '.join(repr(float(x)) for x in logits))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'wav2vec_contr_loss_tpu')\n"
        "             or m.startswith(('wav2vec_contr_loss_torch.models',\n"
        "                              'wav2vec_contr_loss_torch.train',\n"
        "                              'wav2vec_contr_loss_torch.eval.serving')))\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    logits, bad = out.stdout.splitlines()[-2:]
    assert bad == "[]"
    np.testing.assert_allclose([float(x) for x in logits.split()],
                               _scorer(weights).score_waveforms(_waves()),
                               atol=ATOL)


@pytest.fixture(scope="module")
def checkpoints(weights, tmp_path_factory):
    """A port stage-1 and stage-2 checkpoint pair of the tiny weights, as
    `fit` and `train_stage2` write them, 5 clips of 0.75 s and their
    listing, and an int16-wire artifact of batch 4 that `export_serving`
    wrote from the pair."""
    root = tmp_path_factory.mktemp("torch_export")
    (enc, comp, head), w = weights
    trainer = Stage1Trainer(
        Stage1Config(batch_size=4, input_dim=32, hidden_dim=16,
                     max_duration_seconds=1, use_rawboost=False,
                     finetune_encoder=False, compute_dtype="float32"),
        port_config(TINY_ENC), w, device="cpu")
    s1, s2 = str(root / "s1"), str(root / "s2")
    ckpt.save_checkpoint(s1, "best", trainer.state_dict(),
                         trainer.cfg.ckpt_config(), {},
                         trainer._sidecar_extra())
    ckpt.save_checkpoint(s2, STAGE2_BEST, head_state_dict(head),
                         Stage2Config(in_dim=16).ckpt_config())
    rng = np.random.default_rng(7)
    paths = []
    for i in range(5):        # 5 clips at batch 4: a padded last batch
        p = str(root / f"a{i}.wav")
        write_wav(p, (0.3 * rng.standard_normal(12000)).astype(np.float32))
        paths.append(p)
    listing = root / "list.txt"
    listing.write_text("\n".join(paths) + "\n")
    art = str(root / "scorer.w2vexport")
    export_serving.main(["--stage1_dir", s1, "--stage2_dir", s2, "--out",
                         art, "--batch", "4", "--wire", "int16",
                         "--device", "cpu"])
    return s1, s2, str(listing), paths, art


def _serve(argv, capsys) -> list:
    capsys.readouterr()
    serve.main(argv)
    return [ln.split("\t") for ln in capsys.readouterr().out.splitlines()]


def test_export_cli_and_serve_artifact(checkpoints, capsys):
    s1, s2, listing, paths, art = checkpoints
    _, spec = load_exported(art, with_spec=True)
    assert spec == ExportSpec(4, SR, "int16", SR, "none", "cpu")

    ckpt_args = ["--stage1_dir", s1, "--stage2_dir", s2, "--list", listing,
                 "--device", "cpu", "--max_duration_seconds", "1"]
    want = _serve(ckpt_args + ["--batch", "4", "--wire", "int16"], capsys)
    got = _serve(["--artifact", art, "--list", listing], capsys)
    assert [ln[0] for ln in got] == paths == [ln[0] for ln in want]
    np.testing.assert_allclose([float(ln[1]) for ln in got],
                               [float(ln[1]) for ln in want], atol=2e-6)

    # int8 serving from checkpoints runs and stays close to fp32
    q = _serve(ckpt_args + ["--quantize", "w8"], capsys)
    assert [ln[0] for ln in q] == paths
    assert np.isfinite([float(ln[1]) for ln in q]).all()


@pytest.mark.parametrize("bad,msg", [
    (["--batch", "8"], "--batch=8 conflicts"),
    (["--wire", "float32"], "--wire=float32 conflicts"),
    (["--target_sample_rate", "8000"], "--target_sample_rate=8000"),
    (["--max_duration_seconds", "5"], "--max_duration_seconds=5"),
    (["--quantize", "w8a8"], "--quantize is baked"),
    (["--device", "cuda"], "traced for 'cpu'"),
])
def test_serve_artifact_refuses_conflicting_flags(checkpoints, capsys,
                                                  bad, msg):
    _, _, listing, _, art = checkpoints
    with pytest.raises(SystemExit) as e:
        serve.main(["--artifact", art, "--list", listing] + bad)
    assert e.value.code == 2
    assert msg in capsys.readouterr().err
