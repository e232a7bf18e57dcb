"""The port's end-to-end BCE baseline (train/baseline.py, the all-group
clip of train/optim.py, cli/train_baseline.py, cli/score_baseline.py)
against the JAX `BaselineTrainer` and CLIs, on the same weights and data,
fp32 on the CPU (plain kernel versions), at a small width (2 layers,
hidden 64, 2 heads) with every dropout and RawBoost off where the two
sides are compared: steps, gradients, `fit` with its dev EER and early
stop, `score_dataset` and the score file; then the port alone: resume
with the best EER and the patience count, a preempted run that resumes to
the same bits with dropout and device RawBoost on, and the CLI's exit
codes. ~40 s alone."""

import os

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp
import torch

from wav2vec_contr_loss_tpu.cli import score_baseline as jax_score_cli
from wav2vec_contr_loss_tpu.config import BaselineConfig as JaxBaselineConfig
from wav2vec_contr_loss_tpu.data import AudioConfig as JaxAudioConfig
from wav2vec_contr_loss_tpu.data import BatchPipeline as JaxPipeline
from wav2vec_contr_loss_tpu.data import parse_asvspoof2019 as jax_parse
from wav2vec_contr_loss_tpu.losses import bce_logits_loss as jax_bce
from wav2vec_contr_loss_tpu.models.hf_convert import convert_hf_state_dict
from wav2vec_contr_loss_tpu.models.wav2vec2 import Wav2Vec2Config as JaxConfig
from wav2vec_contr_loss_tpu.parallel.mesh import make_mesh
from wav2vec_contr_loss_tpu.train import BaselineTrainer as JaxTrainer
from wav2vec_contr_loss_tpu.train import checkpoint as jax_ckpt

from chip_smoke import write_corpus
from tests.test_torch_bridge import cap_torch_threads, port_config
from wav2vec_contr_loss_torch import (BaselineConfig, BaselineTrainer,
                                      jax_params_to_torch)
from wav2vec_contr_loss_torch.bridge import (dense_state_dict, random_dense,
                                             random_jax_trees)
from wav2vec_contr_loss_torch.cli import score_baseline, train_baseline
from wav2vec_contr_loss_torch.data import (AudioConfig, BatchPipeline,
                                           parse_asvspoof2019)
from wav2vec_contr_loss_torch.eval.score import read_score_file
from wav2vec_contr_loss_torch.ops import attention, conv_ln, supcon
from wav2vec_contr_loss_torch.train import checkpoint as ckpt
from wav2vec_contr_loss_torch.train.optim import (AdamWGroup, GroupedAdamW,
                                                  clip_scale)

cap_torch_threads()

SR = 8000
TINY = JaxConfig(
    hidden_size=64, num_layers=2, num_heads=2, intermediate_size=128,
    conv_dim=(16, 16, 16, 16), conv_kernel=(10, 3, 3, 3),
    conv_stride=(5, 2, 2, 2), num_conv_pos_embeddings=16,
    num_conv_pos_embedding_groups=4, dtype=jnp.float32,
    apply_spec_augment=False, hidden_dropout=0.0, attention_dropout=0.0,
    activation_dropout=0.0, feat_proj_dropout=0.0)
# fp32 on both sides; the JAX-only knobs set to the XLA path the port's
# plain versions compute (fp32 softmax, no unrolled scan)
KW = dict(epochs=3, batch_size=8, seed=7, input_dim=64, hidden_dim=16,
          max_duration_seconds=1, target_sample_rate=SR,
          compute_dtype="float32",
          grad_dtype="float32", dropout=0.0, adam_mu_dtype="float32",
          adam_nu_dtype="float32", use_rawboost=False, patience=1,
          remat_encoder=False, grad_clip=1e6)
JAX_KW = dict(softmax_dtype="float32", scan_unroll=1, remat_policy="full")
POS_WEIGHT = 1.5


def _mesh():
    return make_mesh(devices=jax.devices()[:1])


def _weights(params):
    """The port's weights of a JAX baseline state's params."""
    p = jax.device_get(params)
    w = jax_params_to_torch(port_config(TINY), p["encoder"],
                            p["compression"], {})
    w["classifier"] = dense_state_dict(p["classifier"])
    return w


_JAX_TRAINERS = {}


def _pair(**kw):
    """(JAX trainer, its state, port trainer) on the same initial params;
    one JAX trainer a config, so its steps compile once a module."""
    key = tuple(sorted(kw.items()))
    if key not in _JAX_TRAINERS:
        _JAX_TRAINERS[key] = JaxTrainer(
            JaxBaselineConfig(**{**KW, **JAX_KW, **kw}), enc_config=TINY,
            mesh=_mesh(), pos_weight=POS_WEIGHT)
    jt = _JAX_TRAINERS[key]
    state = jt.init_state(jax.random.PRNGKey(0))
    port = BaselineTrainer(BaselineConfig(**{**KW, **kw}), port_config(TINY),
                           _weights(state.params), device="cpu",
                           pos_weight=POS_WEIGHT)
    return jt, state, port


def _batch():
    rng = np.random.default_rng(0)
    wave = rng.normal(0, 0.2, (8, SR)).astype(np.float32)
    wave[1, 6000:] = 0.0                  # zero padding
    wave[6, 2500:] = 0.0
    return {"waveforms": wave, "labels": np.array([1, 0, 0, 1, 0, 0, 1, 0],
                                                  np.int32)}


def _jax_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _counts():
    return (attention.launches, attention.bwd_launches, conv_ln.launches,
            conv_ln.bwd_launches, supcon.launches)


def _assert_params_match(state, port):
    """Every parameter within 2e-5 (the bound of tests/test_torch_train.py:
    two AdamW steps of 1e-5 on the encoder, over fp32 rounding)."""
    final = jax.device_get(state.params)
    back = convert_hf_state_dict(
        {k: v.numpy() for k, v in port.encoder.state_dict().items()}, TINY)
    want_leaves, want_def = jax.tree_util.tree_flatten(final["encoder"])
    got_leaves, got_def = jax.tree_util.tree_flatten(back)
    assert got_def == want_def
    for g, w in zip(got_leaves, want_leaves):
        np.testing.assert_allclose(g, np.asarray(w), atol=2e-5, rtol=0)
    for name, mod in (("compression", port.compression.proj),
                      ("classifier", port.classifier)):
        tree = final[name]["proj"] if name == "compression" else final[name]
        np.testing.assert_allclose(mod.weight.detach().numpy(),
                                   np.asarray(tree["kernel"]).T, atol=2e-5)
        np.testing.assert_allclose(mod.bias.detach().numpy(),
                                   np.asarray(tree["bias"]), atol=2e-5)


# grad_clip 1e-6 sits far below the gradients' global norm, so the clip
# binds and scales the gradients down to where Adam's eps (1e-8) decides
# the step size: a clip that scaled each group on its own norm, or not at
# all, would take other steps. KW's 1e6 leaves it unbound.
@pytest.mark.parametrize("kw", [dict(grad_clip=1e-6), {}],
                         ids=["bound", "unbound"])
def test_train_steps_match_jax(kw):
    """3 steps: losses rtol 1e-4, every parameter within 2e-5."""
    jt, state, port = _pair(**kw)
    batch = _batch()
    before = _counts()
    want, got = [], []
    for _ in range(3):
        state, m = jt.train_step(state, _jax_batch(batch))
        want.append(float(m["loss"]))
        got.append(float(port.train_step(batch)["loss"]))
    assert _counts() == before      # the CPU runs the plain versions
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert port.step == int(state.step) == 3
    _assert_params_match(state, port)


def test_first_step_encoder_grads_match_jax():
    """One port step's gradients, every encoder leaf and the classifier,
    against jax.grad of the JAX trainer's loss on the same params:
    within 2e-5 of each leaf's largest entry (fp32 both sides; the bound
    of tests/test_torch_train.py), plus 1e-8 for the key bias, whose
    gradient is zero up to rounding under the softmax."""
    jt, state, port = _pair()
    batch = _batch()
    jb = _jax_batch(batch)

    def loss_fn(params):
        # every dropout is off, so the key changes nothing
        logits = jt._logits(params, state.frozen, jb["waveforms"], True,
                            jax.random.PRNGKey(0))
        return jax_bce(logits, jb["labels"], POS_WEIGHT)

    want = jax.device_get(jax.jit(jax.grad(loss_fn))(state.params))
    port.train_step(batch)
    got = convert_hf_state_dict(
        {k: p.grad.numpy() for k, p in port.encoder.named_parameters()}, TINY)
    want_leaves, want_def = jax.tree_util.tree_flatten(want["encoder"])
    got_leaves, got_def = jax.tree_util.tree_flatten(got)
    assert got_def == want_def
    for g, w in zip(got_leaves, want_leaves):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=2e-5 * np.abs(w).max() + 1e-8)
    cls = np.asarray(want["classifier"]["kernel"]).T
    np.testing.assert_allclose(port.classifier.weight.grad.numpy(), cls,
                               rtol=0, atol=2e-5 * np.abs(cls).max())


def test_all_group_clip_matches_optax():
    """GroupedAdamW's clip over every group against optax's chain of
    clip_by_global_norm and multi_transform (fp32; the norm is summed in
    another order, so 1e-6 relative), bound and unbound; the head-only
    clip of stage 1 (AdamWGroup.clip) against a clip of its group alone."""
    rng = np.random.default_rng(0)
    shapes = {"head": [(4, 3), (3,)], "encoder": [(5, 6), (6,), (2, 2)]}
    grads = {k: [rng.normal(0, 1, s).astype(np.float32) for s in v]
             for k, v in shapes.items()}
    for clip in (0.5, 1e4):
        tx = optax.chain(optax.clip_by_global_norm(clip),
                         optax.multi_transform(
                             {"head": optax.adamw(5e-3, weight_decay=3e-3),
                              "encoder": optax.adamw(1e-5,
                                                     weight_decay=3e-3)},
                             {k: k for k in shapes}))
        params = {k: [np.ones(s, np.float32) for s in v]
                  for k, v in shapes.items()}
        upd, _ = tx.update(grads, tx.init(params), params)
        want = jax.tree_util.tree_map(lambda p, u: np.asarray(p + u),
                                      params, upd)
        groups = {}
        for name, lr in (("head", 5e-3), ("encoder", 1e-5)):
            ps = [torch.nn.Parameter(torch.ones(s)) for s in shapes[name]]
            for p, g in zip(ps, grads[name]):
                p.grad = torch.from_numpy(g)
            groups[name] = AdamWGroup(ps, lr, 3e-3, torch.float32,
                                      torch.float32)
        GroupedAdamW(groups, clip=clip).step()
        for name in shapes:
            for p, w in zip(groups[name].params, want[name]):
                np.testing.assert_allclose(p.detach().numpy(), w,
                                           rtol=1e-6, atol=1e-7)
    flat = [torch.from_numpy(g) for gs in grads.values() for g in gs]
    norm = float(np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                             for gs in grads.values() for g in gs)))
    assert float(clip_scale(flat, 0.5)) == pytest.approx(0.5 / norm,
                                                         rel=1e-6)
    assert float(clip_scale(flat, 1e4)) == 1.0


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """16 clips of 1 s: two balanced batches of 8 an epoch; the dev set
    is the same corpus in its natural order."""
    root = str(tmp_path_factory.mktemp("torch_baseline_corpus"))
    return root, write_corpus(root, 16, seed=5, seconds=1.0, sr=SR)


def _pipes(corpus):
    root, proto = corpus
    ds = parse_asvspoof2019(proto, root, audio=AudioConfig(SR, 1))
    return (BatchPipeline(ds, 8, seed=7, num_workers=2),
            BatchPipeline(ds, 8, num_workers=2))


def test_fit_matches_jax(corpus, tmp_path):
    """3 epochs at patience 1: the same train losses (rtol 1e-4), the same
    dev EERs and accuracies each epoch (exact: fp32 logits a few ulps
    apart rank the clips alike), the same early-stop epoch; then the
    same logits from `score_dataset` (1e-5) and both checkpoint names."""
    root, proto = corpus
    jt, state, port = _pair()
    jds = jax_parse(proto, root, audio=JaxAudioConfig(SR, 1))
    state, want = jt.fit(state, JaxPipeline(jds, 8, seed=7, num_workers=2),
                         JaxPipeline(jds, 8, num_workers=2),
                         log_fn=lambda m: None)
    save = str(tmp_path / "ours")
    got = port.fit(*_pipes(corpus), save_dir=save, log_fn=lambda m: None)
    assert len(got["dev_eer"]) == len(want["dev_eer"]) < 3   # stopped early
    assert got["dev_eer"] == want["dev_eer"]
    assert got["dev_acc"] == want["dev_acc"]
    np.testing.assert_allclose(got["train_loss"], want["train_loss"],
                               rtol=1e-4)
    _assert_params_match(state, port)
    for name in ("baseline_best", "baseline_latest"):
        assert ckpt.checkpoint_exists(save, name)
    m = ckpt.load_sidecar(save, "baseline_latest")["metrics"]
    assert m["epochs_no_improve"] == 1 and m["best_eer"] == min(
        want["dev_eer"])

    logits, labels = port.score_dataset(_pipes(corpus)[1])
    w_logits, w_labels = jt.score_dataset(state, JaxPipeline(jds, 8,
                                                             num_workers=2))
    np.testing.assert_array_equal(labels, w_labels)
    np.testing.assert_allclose(logits, w_logits, atol=1e-5)


def _noisy_trainer(**kw):
    """Dropout, SpecAugment, compression dropout and device RawBoost on."""
    cfg = port_config(TINY).with_(
        hidden_dropout=0.1, attention_dropout=0.1, feat_proj_dropout=0.1,
        apply_spec_augment=True, mask_time_prob=0.3, mask_time_length=2)
    bcfg = BaselineConfig(**{**KW, "epochs": 2, "patience": 5,
                             "dropout": 0.1, "use_rawboost": True,
                             "rawboost_prob": 1.0, **kw})
    weights = jax_params_to_torch(cfg, *random_jax_trees(cfg, comp_dim=16,
                                                         seed=2))
    weights["classifier"] = dense_state_dict(random_dense(16, 1, seed=2))
    return BaselineTrainer(bcfg, cfg, weights, device="cpu",
                           pos_weight=POS_WEIGHT)


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


def test_preempt_and_resume_is_bit_identical(corpus, tmp_path):
    """Preempted at epoch 2, batch 1 and resumed from 'baseline_latest'
    (its cursor, best EER and patience count): the same bits as the run
    that went through, with dropout and device RawBoost on."""
    quiet = dict(log_fn=lambda m: None)
    a = _noisy_trainer()
    hist_a = a.fit(*_pipes(corpus), **quiet)

    save = str(tmp_path / "b")
    b = _noisy_trainer()
    assert b.fit(*_pipes(corpus), save_dir=save, preemption=CountGuard(3),
                 **quiet)["preempted"] is True
    m = ckpt.load_sidecar(save, "baseline_latest")["metrics"]
    assert m["preempted"] and (m["epoch"], m["batches_done"]) == (2, 1)
    assert m["best_eer"] == hist_a["dev_eer"][0]
    assert m["epochs_no_improve"] == 0

    c = _noisy_trainer()                 # as the CLI resumes
    c.restore(save, "baseline_latest")
    start, skip = ckpt.resume_cursor(m)
    hist_c = c.fit(*_pipes(corpus), save_dir=save, start_epoch=start,
                   skip_steps=skip, best_eer=m["best_eer"],
                   epochs_no_improve=m["epochs_no_improve"], **quiet)
    assert c.step == a.step == 4
    assert hist_c["dev_eer"] == hist_a["dev_eer"][1:]
    assert _state_equal(c.state_dict(), a.state_dict())
    rebuilt = BaselineTrainer.from_checkpoint(save, "baseline_latest",
                                              device="cpu")
    assert rebuilt.cfg == c.cfg and _state_equal(rebuilt.state_dict(),
                                                 c.state_dict())


def test_resume_carries_patience_and_stops(corpus):
    """A resume that has reached the patience is a no-op; one a step
    short stops after one epoch without a better EER."""
    tr = _noisy_trainer(use_rawboost=False, patience=2, epochs=3)
    before = tr.step
    hist = tr.fit(*_pipes(corpus), best_eer=0.0, epochs_no_improve=2,
                  log_fn=lambda m: None)
    assert hist == {"train_loss": [], "dev_eer": [], "dev_acc": []}
    assert tr.step == before
    logs = []
    hist = tr.fit(*_pipes(corpus), best_eer=-1.0, epochs_no_improve=1,
                  start_epoch=2, log_fn=logs.append)
    assert len(hist["dev_eer"]) == 1 and tr.step == 2
    assert any("[EARLY STOP] patience 2 reached" in m for m in logs)


def test_refuses_what_it_does_not_run():
    w = _noisy_trainer().state_dict()
    weights = {k: w[k] for k in ("encoder", "compression", "classifier")}
    cfg = port_config(TINY)
    # fp32 weight gradients under bf16 compute: what the JAX trainer
    # computes there (tests/test_torch_train.py holds it), accepted
    BaselineTrainer(BaselineConfig(**{**KW, "compute_dtype": "bfloat16"}),
                    cfg.with_(apply_spec_augment=True), weights,
                    device="cpu")
    with pytest.raises(ValueError, match="grad_dtype='bfloat16'"):
        BaselineTrainer(BaselineConfig(**{**KW, "grad_dtype": "bfloat16"}),
                        cfg, weights, device="cpu")
    with pytest.raises(ValueError, match="rawboost_mode"):
        BaselineTrainer(BaselineConfig(**{**KW, "rawboost_mode": "gpu"}),
                        cfg, weights, device="cpu")


def _cli_args(corpus, save):
    root, proto = corpus
    return ["--model_name", "test/tiny-wav2vec2", "--encoder_init", "random",
            "--device", "cpu", "--compute_dtype", "float32",
            "--save_dir", save, "--train_root", root,
            "--train_protocol", proto, "--dev_root", root,
            "--dev_protocol", proto, "--epochs", "2", "--batch_size", "8",
            "--max_duration_seconds", "1", "--hidden_dim", "16",
            "--num_workers", "2", "--use_rawboost", "0"]


def test_cli_exits_0_then_75_on_a_marked_guard(corpus, tmp_path,
                                               monkeypatch, capsys):
    save = str(tmp_path / "bl")
    train_baseline.main(_cli_args(corpus, save))
    run = os.path.join(save, "test__tiny-wav2vec2")
    for name in ("baseline_best", "baseline_latest"):
        assert ckpt.checkpoint_exists(run, name)
    assert "Baseline training complete" in capsys.readouterr().out

    class Marked(train_baseline.PreemptionGuard):
        def install(self):
            self.mark()
            return super().install()

    save2 = str(tmp_path / "bl2")
    monkeypatch.setattr(train_baseline, "PreemptionGuard", Marked)
    with pytest.raises(SystemExit) as stop:
        train_baseline.main(_cli_args(corpus, save2))
    assert stop.value.code == 75
    m = ckpt.load_sidecar(os.path.join(save2, "test__tiny-wav2vec2"),
                          "baseline_latest")["metrics"]
    assert m["preempted"] and (m["epoch"], m["batches_done"]) == (1, 1)
    monkeypatch.undo()
    train_baseline.main(_cli_args(corpus, save2) + ["--resume"])
    assert "[RESUME] continuing from epoch 1 batch 1" in \
        capsys.readouterr().out


def test_score_baseline_matches_the_jax_cli(corpus, tmp_path):
    """The same weights in a JAX and a port checkpoint; score_cm_eval.txt
    of each CLI: the same utt ids (the audio names) and keys, scores to
    1e-5 (fp32 logits; the file keeps 6 decimals); a second run skips."""
    root, proto = corpus
    # the JAX CLI reads clips at 16 kHz whatever the config says: the
    # 8 kHz corpus is resampled alike on both sides
    jt, state, port = _pair(target_sample_rate=16000)
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_ckpt.save_checkpoint(jdir, "baseline_best", state,
                             jt.cfg.ckpt_config(), {"epoch": 1},
                             jt._sidecar_extra())
    jax_ckpt.wait_for_saves()
    ckpt.save_checkpoint(pdir, "baseline_best", port.state_dict(),
                         port.cfg.ckpt_config(), {"epoch": 1},
                         port._sidecar_extra())
    common = ["--eval_root", root, "--eval_protocol", proto,
              "--batch_size", "8", "--num_workers", "2"]
    jax_score_cli.main(["--ckpt_dir", jdir, "--scores_dir",
                        str(tmp_path / "js")] + common)
    score_baseline.main(["--ckpt_dir", pdir, "--scores_dir",
                         str(tmp_path / "ps"), "--device", "cpu"] + common)
    want = read_score_file(str(tmp_path / "js" / "score_cm_eval.txt"))
    got = read_score_file(str(tmp_path / "ps" / "score_cm_eval.txt"))
    assert list(got.utt_ids) == list(want.utt_ids)
    assert got.utt_ids[0] == "clip_0000.wav"
    assert list(got.keys) == list(want.keys)
    np.testing.assert_allclose(got.scores, want.scores, atol=1e-5)
    path = str(tmp_path / "ps" / "score_cm_eval.txt")
    mtime = os.path.getmtime(path)
    score_baseline.main(["--ckpt_dir", pdir, "--scores_dir",
                         str(tmp_path / "ps"), "--device", "cpu"] + common)
    assert os.path.getmtime(path) == mtime
