"""The port's scorers and the reference baseline `.pt` against the JAX
package: `score_famous_figures` against the JAX CLI on the same weights
(the same score file, scores to 1e-5, the speaker filter); a baseline
`.pt` written by the JAX `export_baseline_checkpoint` converts in the
port and scores as the JAX-converted one does (1e-5); the port's baseline
export equals the JAX export of the same weights, and converts back in
JAX to the same parameters. fp32 on the CPU, 1 s clips at 8 kHz. ~45 s
alone."""

import json
import os

import numpy as np
import pytest

import jax
import torch

from wav2vec_contr_loss_tpu.cli import \
    score_famous_figures as jax_ff_cli
from wav2vec_contr_loss_tpu.config import BaselineConfig as JaxBaselineConfig
from wav2vec_contr_loss_tpu.config import Stage1Config as JaxStage1Config
from wav2vec_contr_loss_tpu.config import Stage2Config as JaxStage2Config
from wav2vec_contr_loss_tpu.data import AudioConfig as JaxAudioConfig
from wav2vec_contr_loss_tpu.data import BatchPipeline as JaxPipeline
from wav2vec_contr_loss_tpu.data import parse_asvspoof2019 as jax_parse
from wav2vec_contr_loss_tpu.models.ref_convert import (
    convert_baseline_checkpoint as jax_convert_baseline,
    export_baseline_checkpoint as jax_export_baseline)
from wav2vec_contr_loss_tpu.parallel.mesh import make_mesh
from wav2vec_contr_loss_tpu.train import BaselineTrainer as JaxBaseline
from wav2vec_contr_loss_tpu.train import Stage1Trainer as JaxStage1
from wav2vec_contr_loss_tpu.train import checkpoint as jax_ckpt

from chip_smoke import write_corpus
from tests.test_torch_bridge import (cap_torch_threads, jax_config, jax_trees,
                                     port_config)
from tests.test_torch_ref_convert import _same
from wav2vec_contr_loss_torch import (BaselineConfig, BaselineTrainer,
                                      Stage1Config, Stage1Trainer,
                                      Stage2Config, jax_params_to_torch)
from wav2vec_contr_loss_torch.bridge import dense_state_dict, head_state_dict
from wav2vec_contr_loss_torch.cli import (convert_reference_checkpoint,
                                          export_reference_checkpoint,
                                          score_famous_figures)
from wav2vec_contr_loss_torch.data import (AudioConfig, BatchPipeline,
                                           parse_asvspoof2019)
from wav2vec_contr_loss_torch.eval.score import read_score_file
from wav2vec_contr_loss_torch.models.export_hf import hf_config_from
from wav2vec_contr_loss_torch.models.ref_convert import (
    convert_baseline_checkpoint, detect_kind)
from wav2vec_contr_loss_torch.train import checkpoint as ckpt
from wav2vec_contr_loss_torch.train.stage2 import STAGE2_BEST

cap_torch_threads()

SR = 8000
CFG = jax_config("xlsr")


def _mesh():
    return make_mesh(devices=jax.devices()[:1])


@pytest.fixture(scope="module")
def ff_corpus(tmp_path_factory):
    """12 clips of 1 s and their FamousFigures TSV: two speakers, one
    row whose path carries junk after '.wav'."""
    root = str(tmp_path_factory.mktemp("ff_corpus"))
    write_corpus(root, 12, seed=9, seconds=1.0, sr=SR)
    rows = ["AudioName\tSpeaker\tSource\tLabel\tAudioPath"]
    for i in range(12):
        name = f"clip_{i:04d}.wav"
        label = "bonafide" if i % 2 == 0 else "spoof"
        junk = ", 0.91" if i == 4 else ""
        rows.append(f"{name}\tceleb{i % 3}\tyoutube\t{label}\t{name}{junk}")
    with open(os.path.join(root, "ff.tsv"), "w") as f:
        f.write("\n".join(rows) + "\n")
    return root


@pytest.fixture(scope="module")
def stage_checkpoints(tmp_path_factory):
    """A finetuned stage 1 and a linear stage-2 head, the same weights
    saved by each package."""
    tmp = tmp_path_factory.mktemp("scorer_ckpts")
    enc, comp, head = jax_trees(CFG)
    kw = dict(input_dim=32, hidden_dim=16, max_duration_seconds=1,
              target_sample_rate=SR, use_rawboost=False,
              finetune_encoder=True, compute_dtype="float32", seed=3)
    jt = JaxStage1(JaxStage1Config(**kw), enc_config=CFG, enc_params=enc,
                   mesh=_mesh())
    state = jt.init_state(jax.random.PRNGKey(3))
    state = state.replace(params={**state.params, "compression": comp})
    out = {k: str(tmp / k) for k in ("jax_s1", "jax_s2", "s1", "s2")}
    jax_ckpt.save_checkpoint(out["jax_s1"], "best", state,
                             jt.cfg.ckpt_config(), {"epoch": 1},
                             jt._sidecar_extra())
    c2 = JaxStage2Config(head_type="linear", in_dim=16)
    jax_ckpt.save_checkpoint(out["jax_s2"], STAGE2_BEST, head,
                             c2.ckpt_config(), {"epoch": 1})
    jax_ckpt.wait_for_saves()
    tr = Stage1Trainer(Stage1Config(**kw), port_config(CFG),
                       jax_params_to_torch(port_config(CFG), enc, comp, {}),
                       device="cpu")
    ckpt.save_checkpoint(out["s1"], "best", tr.state_dict(),
                         tr.cfg.ckpt_config(), {"epoch": 1},
                         tr._sidecar_extra())
    ckpt.save_checkpoint(out["s2"], STAGE2_BEST, head_state_dict(head),
                         Stage2Config(in_dim=16).ckpt_config(), {"epoch": 1})
    return out


@pytest.mark.parametrize("speakers", [None, ["celeb0", "celeb2"]])
def test_score_famous_figures_matches_the_jax_cli(ff_corpus,
                                                  stage_checkpoints,
                                                  tmp_path, capsys, speakers):
    """The same ids (audio names), keys and order; scores within 1e-5
    (fp32 logits both sides; the file keeps 6 decimals); the EER line."""
    c = stage_checkpoints
    common = ["--protocol", os.path.join(ff_corpus, "ff.tsv"),
              "--root_dir", ff_corpus, "--batch_size", "5",
              "--num_workers", "2", "--print_eer"]
    if speakers:
        common += ["--include_speakers", *speakers]
    jax_ff_cli.main(["--stage1_dir", c["jax_s1"], "--stage2_dir",
                     c["jax_s2"], "--scores_dir", str(tmp_path / "j")]
                    + common)
    want_out = capsys.readouterr().out
    score_famous_figures.main(["--stage1_dir", c["s1"], "--stage2_dir",
                               c["s2"], "--scores_dir", str(tmp_path / "p"),
                               "--device", "cpu"] + common)
    got_out = capsys.readouterr().out
    name = "score_cm_famous_figures.txt"
    want = read_score_file(str(tmp_path / "j" / name))
    got = read_score_file(str(tmp_path / "p" / name))
    assert list(got.utt_ids) == list(want.utt_ids)
    assert list(got.keys) == list(want.keys)
    assert len(got) == (8 if speakers else 12)
    assert got.utt_ids[4 if not speakers else 3] == (
        "clip_0004.wav" if not speakers else "clip_0005.wav")
    np.testing.assert_allclose(got.scores, want.scores, atol=1e-5)
    eer = [ln for ln in got_out.splitlines() if ln.startswith("EER:")]
    assert eer == [ln for ln in want_out.splitlines()
                   if ln.startswith("EER:")]


# ---------------------------------------------------------- the baseline
@pytest.fixture(scope="module")
def baseline(tmp_path_factory):
    """A JAX baseline checkpoint, its reference .pt from the JAX exporter,
    the port's checkpoint of the same weights, a config.json of the
    architecture and an 8 kHz eval corpus."""
    tmp = tmp_path_factory.mktemp("baseline_pt")
    enc, comp, _ = jax_trees(CFG)
    kw = dict(input_dim=32, hidden_dim=16, max_duration_seconds=1,
              target_sample_rate=SR, use_rawboost=False,
              compute_dtype="float32", seed=4)
    jt = JaxBaseline(JaxBaselineConfig(**kw, softmax_dtype="float32"),
                     enc_config=CFG, enc_params=enc, mesh=_mesh())
    state = jt.init_state(jax.random.PRNGKey(4))
    cls = {"kernel": np.random.default_rng(4).normal(
        0, 0.3, (16, 1)).astype(np.float32), "bias": np.full(1, 0.1,
                                                              np.float32)}
    state = state.replace(params={**state.params, "compression": comp,
                                  "classifier": cls})
    out = {"jax": str(tmp / "jax"), "ours": str(tmp / "ours"),
           "pt": str(tmp / "baseline.pt"), "tmp": tmp}
    metrics = {"epoch": 6, "dev_eer": 0.125, "dev_acc": 0.75}
    jax_ckpt.save_checkpoint(out["jax"], "baseline_best", state,
                             jt.cfg.ckpt_config(), metrics,
                             jt._sidecar_extra())
    jax_ckpt.wait_for_saves()
    jax_export_baseline(out["jax"], out["pt"])
    weights = jax_params_to_torch(port_config(CFG), enc, comp, {})
    weights["classifier"] = dense_state_dict(cls)
    tr = BaselineTrainer(BaselineConfig(**kw), port_config(CFG), weights,
                         device="cpu")
    ckpt.save_checkpoint(out["ours"], "baseline_best", tr.state_dict(),
                         tr.cfg.ckpt_config(), metrics, tr._sidecar_extra())
    out["hf_config"] = str(tmp / "config.json")
    with open(out["hf_config"], "w") as f:
        json.dump(hf_config_from(port_config(CFG)), f)
    root = str(tmp / "eval")
    out["eval"] = (root, write_corpus(root, 10, seed=4, seconds=1.0, sr=SR))
    return out


def _fp32(cfg_over):
    """Conversion overrides: score in fp32 at 8 kHz (the .pt's config
    keeps the reference's defaults: bf16, 16 kHz)."""
    return {"compute_dtype": "float32", "target_sample_rate": SR,
            **cfg_over}


def test_reference_baseline_pt_scores_as_in_jax(baseline, tmp_path):
    """The JAX-exported .pt converted by each package (the port through
    its CLI's path, with the architecture from config.json): the same
    dev-set logits within 1e-5 (fp32), the same metrics carried."""
    b = baseline
    assert detect_kind(torch.load(b["pt"], weights_only=False)) == "baseline"
    ours = str(tmp_path / "ours")
    convert_baseline_checkpoint(b["pt"], ours, hf_config=b["hf_config"],
                                config_overrides=_fp32({}))
    theirs = str(tmp_path / "theirs")
    jax_convert_baseline(b["pt"], theirs, hf_config=b["hf_config"],
                         config_overrides=_fp32({"softmax_dtype":
                                                 "float32"}))
    got_tr = BaselineTrainer.from_checkpoint(ours, device="cpu")
    assert got_tr.step == 0 and got_tr.cfg.finetune_encoder
    want_tr, want_state = JaxBaseline.from_checkpoint(theirs, mesh=_mesh())
    root, proto = b["eval"]
    got, labels = got_tr.score_dataset(BatchPipeline(
        parse_asvspoof2019(proto, root, audio=AudioConfig(SR, 1)), 4,
        num_workers=2))
    want, want_labels = want_tr.score_dataset(want_state, JaxPipeline(
        jax_parse(proto, root, audio=JaxAudioConfig(SR, 1)), 4,
        num_workers=2))
    assert got.shape == (10,) and np.isfinite(got).all()
    np.testing.assert_array_equal(labels, want_labels)
    np.testing.assert_allclose(got, want, atol=1e-5)
    m = ckpt.load_sidecar(ours, "baseline_best")["metrics"]
    assert m["epoch"] == 6 and m["converted_from"] == os.path.abspath(b["pt"])
    # the CLI path: auto-detected kind, default name
    convert_reference_checkpoint.main(["--src", b["pt"], "--out",
                                       str(tmp_path / "cli"), "--hf_config",
                                       b["hf_config"]])
    assert ckpt.checkpoint_exists(str(tmp_path / "cli"), "baseline_best")


def test_port_export_matches_jax_and_converts_back(baseline, tmp_path):
    """The port's export of its checkpoint of the JAX weights against the
    JAX export (keys, values; weight_g to 1e-6 as in
    tests/test_torch_ref_convert.py); JAX converts the port's .pt back to
    the parameters it converts its own .pt to, bit for bit."""
    b = baseline
    out = str(tmp_path / "ours.pt")
    export_reference_checkpoint.main(["--src", b["ours"], "--out", out])
    got = torch.load(out, weights_only=False)
    want = torch.load(b["pt"], weights_only=False)
    assert set(got) == set(want)
    for k, v in want.items():
        if k == "model_state_dict":
            _same(got[k], v, k)
        else:
            assert got[k] == v, k
    assert detect_kind(got) == "baseline"

    params = {}
    for tag, pt in (("ours", out), ("theirs", b["pt"])):
        d = str(tmp_path / f"back_{tag}")
        jax_convert_baseline(pt, d, hf_config=b["hf_config"])
        _, state = JaxBaseline.from_checkpoint(d, mesh=_mesh())
        params[tag] = jax.device_get(state.params)
    got_leaves, got_def = jax.tree_util.tree_flatten(params["ours"])
    want_leaves, want_def = jax.tree_util.tree_flatten(params["theirs"])
    assert got_def == want_def
    pos = jax.tree_util.tree_leaves(
        params["theirs"]["encoder"]["pos_conv_embed"]["conv"]["kernel"])[0]
    for g, w in zip(got_leaves, want_leaves):
        if w is pos:
            # weight norm folds g * v / ||v||, and each exporter sums g in
            # its own order: a few ulps on the positional conv
            np.testing.assert_array_max_ulp(np.asarray(g), np.asarray(w),
                                            maxulp=4)
        else:
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
