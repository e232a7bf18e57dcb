"""The port's reference `.pt` conversion (models/ref_convert.py) against the
JAX package: stage-1 (frozen and finetuned, with and without
DataParallel's `module.`) and stage-2 (linear and MLP) `.pt` files written
by the JAX `export_reference_checkpoint` from JAX checkpoints convert into
port checkpoints whose scorer gives the JAX scorer's logits (fp32, CPU);
the port's export gives the JAX export's keys and values; a malformed
baseline .pt is refused; a sidecar with the JAX trainer's extra fields
restores. ~25 s alone."""

import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from wav2vec_contr_loss_tpu.config import Stage1Config as JaxStage1Config
from wav2vec_contr_loss_tpu.config import Stage2Config as JaxStage2Config
from wav2vec_contr_loss_tpu.eval.serving import SpoofScorer as JaxScorer
from wav2vec_contr_loss_tpu.models.heads import build_head as jax_build_head
from wav2vec_contr_loss_tpu.models.ref_convert import \
    export_reference_checkpoint as jax_export
from wav2vec_contr_loss_tpu.train import Stage1Trainer as JaxTrainer
from wav2vec_contr_loss_tpu.train import checkpoint as jax_ckpt

from tests.test_torch_bridge import (cap_torch_threads, jax_config, jax_trees,
                                     perturbed, port_config)
from wav2vec_contr_loss_torch import (SpoofScorer, Stage1Config,
                                      Stage1Trainer, Stage2Config,
                                      jax_params_to_torch)
from wav2vec_contr_loss_torch.bridge import head_state_dict
from wav2vec_contr_loss_torch.cli import (convert_reference_checkpoint,
                                          export_reference_checkpoint)
from wav2vec_contr_loss_torch.models.export_hf import hf_config_from
from wav2vec_contr_loss_torch.models.hf_convert import save_encoder_init
from wav2vec_contr_loss_torch.models.ref_convert import (
    convert_reference_checkpoint as port_convert, detect_kind,
    export_reference_checkpoint as port_export)
from wav2vec_contr_loss_torch.train import checkpoint as ckpt
from wav2vec_contr_loss_torch.train.stage2 import STAGE2_BEST

cap_torch_threads()

SR = 16000


def _waves():
    rng = np.random.default_rng(3)
    w = rng.normal(0, 0.2, (4, SR)).astype(np.float32)
    w[1, SR // 2:] = 0.0
    w[3] = 0.0
    return w


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """JAX checkpoints at a small width (1 s clips): a finetuned stage 1
    and stage-2 heads, linear and MLP, their reference .pt files from the
    JAX exporter, and the frozen run's .pt: the same file without the
    encoder and with FINETUNE_ENCODER off, as the JAX exporter writes a
    frozen run. Also the port's checkpoints of the same weights (through
    the bridge), a config.json of the architecture, and a port encoder
    init of the pretrained encoder."""
    tmp = tmp_path_factory.mktemp("jax_side")
    cfg = jax_config("xlsr")
    pcfg = port_config(cfg)
    enc, comp, _ = jax_trees(cfg)
    jcfg = JaxStage1Config(input_dim=32, hidden_dim=16,
                           max_duration_seconds=1, use_rawboost=False,
                           finetune_encoder=True, compute_dtype="float32",
                           seed=3)
    trainer = JaxTrainer(jcfg, enc_config=cfg, enc_params=enc)
    state = trainer.init_state(jax.random.PRNGKey(jcfg.seed))
    state = state.replace(params={**state.params, "compression": comp})
    metrics = {"epoch": 4, "train_loss": 0.5, "dev_loss": 0.75}
    d = str(tmp / "jax_s1")
    jax_ckpt.save_checkpoint(d, "best", state, jcfg.ckpt_config(), metrics,
                             trainer._sidecar_extra())
    jax_ckpt.wait_for_saves()
    out = {"dirs": {"finetuned": d, "frozen": d}, "pts": {}, "ours": {}}
    out["pts"]["finetuned"] = jax_export(d, str(tmp / "finetuned.pt"))[1]
    frozen = torch.load(out["pts"]["finetuned"], weights_only=False)
    del frozen["encoder_state_dict"]
    frozen["config"]["FINETUNE_ENCODER"] = False
    out["pts"]["frozen"] = str(tmp / "frozen.pt")
    torch.save(frozen, out["pts"]["frozen"])

    weights = jax_params_to_torch(pcfg, enc, comp, {})
    for ft in (True, False):
        scfg = Stage1Config(input_dim=32, hidden_dim=16,
                            max_duration_seconds=1, use_rawboost=False,
                            finetune_encoder=ft, compute_dtype="float32",
                            seed=3)
        tr = Stage1Trainer(scfg, pcfg, weights, device="cpu")
        name = "finetuned" if ft else "frozen"
        out["ours"][name] = str(tmp / f"ours_{name}")
        ckpt.save_checkpoint(out["ours"][name], "best", tr.state_dict(),
                             scfg.ckpt_config(), metrics, tr._sidecar_extra())

    for head_type in ("linear", "mlp"):
        head = perturbed(jax_build_head(head_type, 8).init(
            jax.random.PRNGKey(2), jnp.zeros((1, 16)))["params"], 3)
        c2 = JaxStage2Config(head_type=head_type, in_dim=16, hidden_dim=8)
        m2 = {"epoch": 9, "dev_eer": 0.125}
        d = str(tmp / f"s2_{head_type}")
        jax_ckpt.save_checkpoint(d, "stage2_binary_head_best", head,
                                 c2.ckpt_config(), m2)
        jax_ckpt.wait_for_saves()
        out["dirs"][head_type] = d
        out["pts"][head_type] = jax_export(d, str(tmp / f"{head_type}.pt")
                                           )[1]
        out["ours"][head_type] = str(tmp / f"ours_{head_type}")
        ckpt.save_checkpoint(out["ours"][head_type], STAGE2_BEST,
                             head_state_dict(head),
                             Stage2Config(head_type=head_type, in_dim=16,
                                          hidden_dim=8).ckpt_config(), m2)
    out["hf_config"] = str(tmp / "config.json")
    with open(out["hf_config"], "w") as f:
        json.dump(hf_config_from(pcfg), f)
    out["encoder_init"] = str(tmp / "encoder_init")
    save_encoder_init(out["encoder_init"], pcfg, weights["encoder"])
    return out


def _with_module_prefix(src: str, dst: str) -> str:
    """The same .pt with every state dict under DataParallel's 'module.'."""
    d = torch.load(src, weights_only=False)
    for k in ("compression_state_dict", "encoder_state_dict",
              "model_state_dict"):
        if k in d:
            d[k] = {f"module.{n}": v for n, v in d[k].items()}
    torch.save(d, dst)
    return dst


@pytest.mark.parametrize("module", [False, True])
@pytest.mark.parametrize("stage1,head_type", [("finetuned", "linear"),
                                              ("frozen", "mlp")])
def test_converted_checkpoints_score_as_the_jax_scorer(jax_side, tmp_path,
                                                       stage1, head_type,
                                                       module):
    s1_pt, s2_pt = jax_side["pts"][stage1], jax_side["pts"][head_type]
    if module:
        s1_pt = _with_module_prefix(s1_pt, str(tmp_path / "s1.pt"))
        s2_pt = _with_module_prefix(s2_pt, str(tmp_path / "s2.pt"))
    arch = (["--hf_config", jax_side["hf_config"]] if stage1 == "finetuned"
            else ["--encoder_init", jax_side["encoder_init"]])
    convert_reference_checkpoint.main(["--src", s1_pt, "--out",
                                       str(tmp_path / "s1"), *arch])
    convert_reference_checkpoint.main(["--src", s2_pt, "--out",
                                       str(tmp_path / "s2")])
    got = SpoofScorer.from_checkpoints(str(tmp_path / "s1"),
                                       str(tmp_path / "s2"), device="cpu",
                                       compute_dtype="float32")
    want = JaxScorer.from_checkpoints(jax_side["dirs"][stage1],
                                      jax_side["dirs"][head_type])
    a = got.score_waveforms(_waves())
    b = np.asarray(want.score_waveforms(_waves()))
    assert a.shape == (4,) and np.isfinite(a).all()
    # fp32 on both sides; the tolerance of tests/test_torch_serving.py
    np.testing.assert_allclose(a, b, atol=1e-5)
    # and the trainer restores the converted state whole
    tr = Stage1Trainer.from_checkpoint(str(tmp_path / "s1"), device="cpu")
    assert tr.step == 0 and tr.cfg.finetune_encoder == (stage1 == "finetuned")


def _same(got: dict, want: dict, where: str):
    """The port's and the JAX .pt state dicts: the same keys (JAX writes
    the installed torch's weight-norm layout), the same values; weight_g,
    ||w|| over dims 0 and 1, to 1e-6 relative: both sum the same fp32
    squares, the port over the C-ordered kernel, JAX over a transposed
    view, so in another order."""
    names = {"parametrizations.weight.original0": "weight_g",
             "parametrizations.weight.original1": "weight_v"}
    want = {next((k.replace(a, b) for a, b in names.items() if a in k), k): v
            for k, v in want.items()}
    assert set(got) == set(want), where
    for k, v in want.items():
        g, w = got[k].numpy(), v.numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if k.endswith("weight_g"):
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=0)
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{where}: {k}")


@pytest.mark.parametrize("name", ["finetuned", "frozen", "linear", "mlp"])
def test_export_matches_the_jax_export(jax_side, tmp_path, name):
    """The port's export of a checkpoint of the JAX weights against the
    JAX export of the same weights."""
    out = str(tmp_path / "ours.pt")
    export_reference_checkpoint.main(["--src", jax_side["ours"][name],
                                      "--out", out])
    got = torch.load(out, weights_only=False)
    want = torch.load(jax_side["pts"][name], weights_only=False)
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, dict) and k.endswith("state_dict"):
            _same(got[k], v, k)
        else:
            assert got[k] == v, k
    assert detect_kind(got) == detect_kind(want)


def test_baseline_is_refused_naming_a7(tmp_path):
    """A .pt that detect_kind takes for a baseline but that lacks the
    compression is refused, naming the parts a baseline .pt holds; so is
    an export from a directory that holds no baseline checkpoint (the
    baseline's conversion itself: tests/test_torch_scorers.py)."""
    pt = str(tmp_path / "baseline.pt")
    torch.save({"model_state_dict": {"encoder.model.x": torch.zeros(1),
                                     "classifier.weight": torch.zeros(1)},
                "config": {}}, pt)
    assert detect_kind(torch.load(pt)) == "baseline"
    with pytest.raises(ValueError, match="compression"):
        port_convert(pt, str(tmp_path / "out"))
    with pytest.raises(FileNotFoundError):
        port_export(str(tmp_path), str(tmp_path / "b.pt"), kind="baseline")


def test_a_sidecar_with_the_jax_fields_restores(jax_side, tmp_path):
    """A stage-1 sidecar's stage1_config may carry the fields the port
    leaves out (the JAX trainer's XLA-path and TPU knobs)."""
    port_convert(jax_side["pts"]["finetuned"], str(tmp_path),
                 hf_config=jax_side["hf_config"])
    path = os.path.join(str(tmp_path), "best.config.json")
    with open(path) as f:
        side = json.load(f)
    extra = {"attention_impl": "pallas", "scan_unroll": 2,
             "param_sharding": "fsdp", "sequence_parallel": False}
    side["extra"]["stage1_config"].update(extra)
    with open(path, "w") as f:
        json.dump(side, f)
    tr = Stage1Trainer.from_checkpoint(str(tmp_path), device="cpu")
    assert tr.cfg.finetune_encoder and tr.cfg.hidden_dim == 16
    assert not hasattr(tr.cfg, "scan_unroll")
    assert ckpt.load_sidecar(str(tmp_path), "best")["metrics"]["epoch"] == 4
