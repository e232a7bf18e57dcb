"""The port's `fit`, checkpoints and CLI on a tiny encoder with 1 s clips:
`fit` against the JAX `Stage1Trainer.fit` on the same weights and data
(host RawBoost, so both see the same augmented batches), a mid-epoch
preempt-and-resume with device RawBoost and dropout on to the same bits
as an uninterrupted run, exact checkpoint round trips, crash recovery,
and the CLI's exit code 75 and --resume."""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from wav2vec_contr_loss_tpu.config import Stage1Config as JaxStage1Config
from wav2vec_contr_loss_tpu.data import AudioConfig as JaxAudioConfig
from wav2vec_contr_loss_tpu.data import BatchPipeline as JaxPipeline
from wav2vec_contr_loss_tpu.data import parse_asvspoof2019 as jax_parse
from wav2vec_contr_loss_tpu.data.rawboost import (
    RawBoostParams as JaxRawBoostParams)
from wav2vec_contr_loss_tpu.models.hf_convert import convert_hf_state_dict
from wav2vec_contr_loss_tpu.models.wav2vec2 import Wav2Vec2Config as JaxConfig
from wav2vec_contr_loss_tpu.parallel.mesh import make_mesh
from wav2vec_contr_loss_tpu.train import Stage1Trainer as JaxTrainer

from chip_smoke import write_corpus
from tests.test_torch_bridge import port_config
from wav2vec_contr_loss_torch import (Stage1Config, Stage1Trainer,
                                      jax_params_to_torch)
from wav2vec_contr_loss_torch.bridge import random_jax_trees
from wav2vec_contr_loss_torch.cli import train_stage1 as cli
from wav2vec_contr_loss_torch.data import (AudioConfig, BatchPipeline,
                                           parse_asvspoof2019)
from wav2vec_contr_loss_torch.data.rawboost import RawBoostParams
from wav2vec_contr_loss_torch.train import checkpoint as ckpt

from tests.test_torch_bridge import cap_torch_threads

cap_torch_threads()

SR = 16000
TINY = JaxConfig(
    hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
    conv_dim=(16, 16, 16, 16), conv_kernel=(10, 3, 3, 3),
    conv_stride=(5, 2, 2, 2), num_conv_pos_embeddings=16,
    num_conv_pos_embedding_groups=4, dtype=jnp.float32,
    apply_spec_augment=False, hidden_dropout=0.0, attention_dropout=0.0,
    activation_dropout=0.0, feat_proj_dropout=0.0)
KW = dict(epochs=2, batch_size=8, seed=7, input_dim=32, hidden_dim=16,
          max_duration_seconds=1, finetune_encoder=True,
          compute_dtype="float32", grad_dtype="float32", dropout=0.0,
          adam_mu_dtype="float32", adam_nu_dtype="float32", warmup_epochs=1,
          alpha_ramp_epochs=2, alpha_end=0.5, use_rawboost=True,
          rawboost_mode="host")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """16 clips: two balanced batches of 8 an epoch."""
    root = str(tmp_path_factory.mktemp("torch_fit_corpus"))
    return root, write_corpus(root, 16, seed=3, seconds=1.0)


def _pipes(corpus, rawboost=True):
    root, proto = corpus
    ds = parse_asvspoof2019(proto, root, audio=AudioConfig(SR, 1))
    return (BatchPipeline(ds, 8, seed=7, num_workers=2,
                          rawboost=RawBoostParams() if rawboost else None),
            BatchPipeline(ds, 8, seed=8, num_workers=2))


class CountGuard:
    """Requests a stop at the k-th poll (fit polls once a step)."""

    def __init__(self, k: int):
        self.k, self.calls = k, 0

    def requested(self, step=None):
        self.calls += 1
        return self.calls >= self.k


def _state_equal(a, b):
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_state_equal(a[k], b[k])
                                            for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(_state_equal, a, b))
    return a == b


def test_fit_matches_jax(corpus):
    """2 epochs (alpha 0, then 0.25) with a dev pipe, dropout off, host
    RawBoost: per-epoch losses rtol 1e-4 and final parameters within 2e-5
    (the tolerances of tests/test_torch_train.py)."""
    root, proto = corpus
    # one device: the step compiles and runs without an 8-way sharding
    jt = JaxTrainer(JaxStage1Config(**KW), enc_config=TINY,
                    mesh=make_mesh(devices=jax.devices()[:1]))
    state = jt.init_state(jax.random.PRNGKey(0))
    p0 = jax.device_get(state.params)
    port = Stage1Trainer(Stage1Config(**KW), port_config(TINY),
                         jax_params_to_torch(port_config(TINY), p0["encoder"],
                                             p0["compression"], {}),
                         device="cpu")
    jds = jax_parse(proto, root, audio=JaxAudioConfig(SR, 1))
    state, want = jt.fit(
        state, JaxPipeline(jds, 8, seed=7, num_workers=2,
                           rawboost=JaxRawBoostParams()),
        JaxPipeline(jds, 8, seed=8, num_workers=2), log_fn=lambda m: None)
    got = port.fit(*_pipes(corpus), log_fn=lambda m: None)

    assert got["alpha"] == want["alpha"] == [0.0, 0.25]
    np.testing.assert_allclose(got["train_loss"], want["train_loss"],
                               rtol=1e-4)
    np.testing.assert_allclose(got["dev_loss"], want["dev_loss"], rtol=1e-4)
    final = jax.device_get(state.params)
    back = convert_hf_state_dict(
        {k: v.numpy() for k, v in port.encoder.state_dict().items()}, TINY)
    want_leaves, want_def = jax.tree_util.tree_flatten(final["encoder"])
    got_leaves, got_def = jax.tree_util.tree_flatten(back)
    assert got_def == want_def
    for g, w in zip(got_leaves, want_leaves):
        np.testing.assert_allclose(g, np.asarray(w), atol=2e-5, rtol=0)
    proj = final["compression"]["proj"]
    np.testing.assert_allclose(port.compression.proj.weight.detach().numpy(),
                               np.asarray(proj["kernel"]).T, atol=2e-5)
    assert port.step == int(state.step) == 4


def _noisy_trainer(seed: int = 0, **kw):
    """Dropout, SpecAugment and device RawBoost on."""
    cfg = port_config(TINY).with_(
        hidden_dropout=0.1, attention_dropout=0.1, feat_proj_dropout=0.1,
        apply_spec_augment=True, mask_time_prob=0.3, mask_time_length=2)
    scfg = Stage1Config(**{**KW, "dropout": 0.1, "rawboost_mode": "device",
                           "rawboost_prob": 1.0, **kw})
    weights = jax_params_to_torch(cfg, *random_jax_trees(cfg, comp_dim=16,
                                                         seed=seed))
    return Stage1Trainer(scfg, cfg, weights, device="cpu")


def test_preempt_and_resume_is_bit_identical(corpus, tmp_path):
    quiet = dict(log_fn=lambda m: None)
    a = _noisy_trainer()
    hist_a = a.fit(*_pipes(corpus, rawboost=False),
                   save_dir=str(tmp_path / "a"), **quiet)

    save = str(tmp_path / "b")
    b = _noisy_trainer()
    hist_b = b.fit(*_pipes(corpus, rawboost=False), save_dir=save,
                   preemption=CountGuard(3), **quiet)
    assert hist_b["preempted"] is True
    m = ckpt.load_sidecar(save, "latest")["metrics"]
    assert m["preempted"] and (m["epoch"], m["batches_done"]) == (2, 1)
    # best_dev rides the sidecar: epoch 1's dev loss
    assert m["best_dev"] == hist_a["dev_loss"][0]

    c = Stage1Trainer.from_checkpoint(save, "latest", device="cpu")
    start, skip = ckpt.resume_cursor(m)
    hist_c = c.fit(*_pipes(corpus, rawboost=False), save_dir=save,
                   start_epoch=start, skip_steps=skip,
                   best_dev=m["best_dev"], **quiet)
    assert c.step == a.step == 4
    assert hist_c["dev_loss"] == hist_a["dev_loss"][1:]
    assert _state_equal(c.state_dict(), a.state_dict())
    end = ckpt.load_sidecar(save, "latest")["metrics"]
    assert end["best_dev"] == min(hist_a["dev_loss"])


def test_checkpoint_round_trip_is_exact(tmp_path):
    rng = np.random.default_rng(0)
    batch = {"waveforms": rng.normal(0, 0.2, (8, SR)).astype(np.float32),
             "labels": np.array([1, 0] * 4)}
    bf16 = dict(adam_mu_dtype="bfloat16", adam_nu_dtype="bfloat16")
    src = _noisy_trainer(**bf16)
    for _ in range(2):
        src.train_step(batch, 0.5)
    ckpt.save_checkpoint(str(tmp_path), "latest", src.state_dict(),
                         {"A": 1}, {"epoch": 1}, {"x": "y"}, block=False)
    with pytest.raises(ValueError, match="dtype"):
        _noisy_trainer().restore(str(tmp_path), "latest")
    dst = _noisy_trainer(seed=5, **bf16)
    assert not _state_equal(dst.state_dict(), src.state_dict())
    sidecar = dst.restore(str(tmp_path), "latest")
    assert sidecar == {"config": {"A": 1}, "metrics": {"epoch": 1},
                       "extra": {"x": "y"}}
    assert _state_equal(dst.state_dict(), src.state_dict())
    assert dst.optimizer.groups["encoder"].mu[0].dtype == torch.bfloat16
    # the restored generator draws what the source's draws next
    assert float(src.train_step(batch, 0.5)["loss"]) == float(
        dst.train_step(batch, 0.5)["loss"])


def test_async_snapshot_is_taken_before_the_next_step(tmp_path):
    tr = _noisy_trainer()
    before = {k: v.clone() for k, v in tr.compression.state_dict().items()}
    ckpt.save_checkpoint(str(tmp_path), "latest", tr.state_dict(),
                         block=False)
    with torch.no_grad():
        tr.compression.proj.weight.add_(1.0)    # an in-place update
    state, _ = ckpt.restore_checkpoint(str(tmp_path), "latest")
    assert _state_equal(state["compression"], before)


def test_stranded_saving_copy_is_recovered(tmp_path):
    d = str(tmp_path)
    base = os.path.join(d, "latest")
    ckpt.save_checkpoint(d, "latest", {"v": torch.tensor(1)},
                         metrics={"epoch": 1})
    # a crash after the staged pair was written, before it moved in
    os.replace(base + ".pt", base + ".saving.pt")
    os.replace(base + ".config.json", base + ".saving.config.json")
    assert ckpt.checkpoint_exists(d, "latest")
    assert int(ckpt.restore_checkpoint(d, "latest")[0]["v"]) == 1
    ckpt.save_checkpoint(d, "other", {"v": torch.tensor(0)})
    ckpt.save_checkpoint(d, "latest", {"v": torch.tensor(2)},
                         metrics={"epoch": 2})
    assert int(ckpt.restore_checkpoint(d, "latest")[0]["v"]) == 2
    # a crash between the two replaces: new state, old sidecar, the new
    # sidecar still staged
    ckpt.save_checkpoint(d, "latest", {"v": torch.tensor(3)},
                         metrics={"epoch": 3})
    os.replace(base + ".config.json", base + ".saving.config.json")
    with open(base + ".config.json", "w") as f:
        f.write('{"metrics": {"epoch": 2}}')
    assert ckpt.load_sidecar(d, "latest")["metrics"]["epoch"] == 3
    # an in-flight state with no staged sidecar is not a checkpoint
    torch.save({"v": torch.tensor(9)}, base + ".saving.pt")
    ckpt.save_checkpoint(d, "latest", {"v": torch.tensor(4)},
                         metrics={"epoch": 4})
    assert int(ckpt.restore_checkpoint(d, "latest")[0]["v"]) == 4
    assert ckpt.load_sidecar(d, "latest")["metrics"]["epoch"] == 4
    assert sorted(os.listdir(d)) == ["latest.config.json", "latest.pt",
                                     "other.config.json", "other.pt"]


def test_alias_and_best_without_dev(corpus, tmp_path):
    """No dev pipe: 'best' aliases 'latest'; the metrics logger gets each
    epoch's scalars and the profiler its trace."""
    logged = []

    class Logger:
        def log(self, epoch, scalars):
            logged.append((epoch, scalars))

    tr = _noisy_trainer(epochs=1)
    tr.fit(_pipes(corpus, rawboost=False)[0], save_dir=str(tmp_path),
           log_fn=lambda m: None, metrics_logger=Logger(),
           profile_dir=str(tmp_path / "prof"))
    assert [e for e, _ in logged] == [1]
    assert set(logged[0][1]) == {"train_loss", "dev_loss", "alpha",
                                 "clips_per_sec"}
    assert os.listdir(tmp_path / "prof") == ["train_steps_2-5.json"]
    assert os.path.islink(tmp_path / "best.pt")
    assert ckpt.load_sidecar(str(tmp_path), "best") == ckpt.load_sidecar(
        str(tmp_path), "latest")
    with pytest.raises(ValueError, match="RawBoost"):
        tr.fit(_pipes(corpus)[0], dev_pipe=_pipes(corpus)[0])


def test_from_checkpoint_rebuilds_from_the_sidecar(tmp_path):
    src = _noisy_trainer(rawboost_fir_impl="direct", topk_neg=3)
    ckpt.save_checkpoint(str(tmp_path), "best", src.state_dict(),
                         src.cfg.ckpt_config(), {}, src._sidecar_extra())
    got = Stage1Trainer.from_checkpoint(str(tmp_path), device="cpu")
    assert got.cfg == src.cfg and got.enc_config == src.enc_config
    assert _state_equal(got.state_dict(), src.state_dict())


def test_cli_exits_75_on_a_marked_guard_and_resumes(corpus, tmp_path,
                                                    monkeypatch, capsys):
    root, proto = corpus
    args = ["--model_name", "test/tiny-wav2vec2", "--encoder_init", "random",
            "--device", "cpu", "--compute_dtype", "float32",
            "--save_dir", str(tmp_path), "--train_root", root,
            "--train_protocol", proto, "--dev_root", root,
            "--dev_protocol", proto, "--epochs", "2", "--batch_size", "8",
            "--max_duration_seconds", "1", "--input_dim", "32",
            "--hidden_dim", "16", "--num_workers", "2"]
    save = os.path.join(str(tmp_path), "test__tiny-wav2vec2")

    class Marked(cli.PreemptionGuard):
        def install(self):
            self.mark()
            return super().install()

    monkeypatch.setattr(cli, "PreemptionGuard", Marked)
    with pytest.raises(SystemExit) as stop:
        cli.main(args)
    assert stop.value.code == 75
    m = ckpt.load_sidecar(save, "latest")["metrics"]
    assert m["preempted"] and (m["epoch"], m["batches_done"]) == (1, 1)

    monkeypatch.undo()
    cli.main(args + ["--resume"])
    out = capsys.readouterr().out
    assert "[RESUME] continuing from epoch 1 batch 1" in out
    assert "[epoch 002]" in out and "training complete" in out
    assert ckpt.load_sidecar(save, "latest")["metrics"]["epoch"] == 2
    with pytest.raises(ValueError, match="downloads nothing|neither"):
        cli.main(args[:2] + ["--encoder_init", "pretrained"] + args[4:])


def test_cli_debug_nans_raises_on_a_nan(corpus, tmp_path, monkeypatch):
    """A NaN in the compression's bias: the run trains on through NaN
    losses, and with --debug_nans (autograd's anomaly mode with its NaN
    check) the first step's backward raises; the mode ends with the run."""
    root, proto = corpus

    def poisoned(*a, **k):
        enc, comp, head = random_jax_trees(*a, **k)
        comp["proj"]["bias"][0] = np.nan
        return enc, comp, head

    monkeypatch.setattr(cli, "random_jax_trees", poisoned)
    args = ["--model_name", "test/tiny-wav2vec2", "--encoder_init", "random",
            "--device", "cpu", "--compute_dtype", "float32",
            "--train_root", root, "--train_protocol", proto, "--epochs", "1",
            "--batch_size", "8", "--max_duration_seconds", "1",
            "--input_dim", "32", "--hidden_dim", "16", "--num_workers", "2"]
    cli.main(args + ["--save_dir", str(tmp_path / "plain")])
    with pytest.raises(RuntimeError, match="returned nan values"):
        cli.main(args + ["--save_dir", str(tmp_path / "debug"),
                         "--debug_nans"])
    assert not torch.is_anomaly_enabled()


def test_default_config_steps_on_cpu():
    """Stage1Config's defaults (device RawBoost 'fft'/'exact', bf16,
    frozen encoder) build and take a step at the tiny width, 5 s clips."""
    cfg = Stage1Config(input_dim=32)
    assert cfg.use_rawboost and cfg.rawboost_mode == "device"
    enc = port_config(TINY)
    tr = Stage1Trainer(cfg, enc, jax_params_to_torch(
        enc, *random_jax_trees(enc, comp_dim=cfg.hidden_dim)), device="cpu")
    rng = np.random.default_rng(1)
    wave = rng.normal(0, 0.2, (4, 80000)).astype(np.float32)
    wave[1, 50000:] = 0.0
    loss = tr.train_step({"waveforms": wave, "labels": np.array([1, 0] * 2)},
                         0.0)["loss"]
    assert torch.isfinite(loss) and tr.step == 1
