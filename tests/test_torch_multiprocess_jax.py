"""A 2-rank Gloo gang of the port against the JAX `Stage1Trainer` on a
JAX CPU mesh of the same shape, from the same bridged parameters, with
every dropout, SpecAugment and RawBoost off so both compute the same
deterministic step: (2, 1) data parallel, (1, 2) tensor parallel, the
(1, 2) GPipe pipeline (param_sharding='pp', 2 microbatches; JAX's pipe
draws a schedule of its own, so only a step without draws compares) and
(1, 2) tensor parallel with sequence parallelism (on the 99 frames of
1 kHz clips), one step (parallel/mp_smoke.py legs 'dp_nodrop',
'tp_nodrop', 'pp_nodrop' and 'tp_sp_nodrop'), within
tests/test_sharding.py::test_dp_tp_train_step's tolerances (loss rel
1e-4, parameters rtol 2e-4 / atol 2e-5). The encoder's first AdamW step
moves each element by about enc_lr (1e-5), below that atol, so each
leaf's update (after - initial) is also held to JAX's: cosine >= 0.999
and norms within 1e-2."""

import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wav2vec_contr_loss_tpu.config import Stage1Config as JaxStage1Config
from wav2vec_contr_loss_tpu.models.hf_convert import convert_hf_state_dict
from wav2vec_contr_loss_tpu.models.wav2vec2 import Wav2Vec2Config as JaxConfig
from wav2vec_contr_loss_tpu.parallel import batch_sharding, make_mesh
from wav2vec_contr_loss_tpu.train import Stage1Trainer as JaxTrainer

from tests.test_torch_bridge import cap_torch_threads, port_config
from wav2vec_contr_loss_torch import jax_params_to_torch
from wav2vec_contr_loss_torch.parallel import mp_smoke

cap_torch_threads()

# mp_smoke.encoder_config(False) as a JAX config
TINY = JaxConfig(
    hidden_size=64, num_layers=4, num_heads=4, intermediate_size=128,
    conv_dim=(32, 32), conv_kernel=(10, 3), conv_stride=(5, 2),
    num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
    dtype=jnp.float32, apply_spec_augment=False, hidden_dropout=0.0,
    attention_dropout=0.0, activation_dropout=0.0, feat_proj_dropout=0.0)
JAX_KW = dict(batch_size=8, max_duration_seconds=1, target_sample_rate=4000,
              input_dim=64, hidden_dim=16, use_rawboost=False,
              finetune_encoder=True, compute_dtype="float32",
              grad_dtype="float32", adam_mu_dtype="float32",
              adam_nu_dtype="float32", dropout=0.0, seed=0)
# leg -> (the JAX mesh's 'model' axis, the JAX config's layout fields)
MESHES = {"dp_nodrop": (1, {}), "tp_nodrop": (2, {}),
          "pp_nodrop": (2, dict(param_sharding="pp",
                                pipeline_microbatches=2)),
          "tp_sp_nodrop": (2, dict(sequence_parallel=True))}


def test_port_config_is_the_smoke_config():
    assert port_config(TINY) == mp_smoke.encoder_config(False)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(initial JAX params, {leg: (JAX step loss, JAX params after)},
    the gang's results, its output directory). The gang runs while the
    JAX steps compile and run."""
    out = str(tmp_path_factory.mktemp("gang_jax"))

    def trainer_for(leg):
        n_model, layout = MESHES[leg]
        job = mp_smoke.Job().for_leg(leg)
        mesh = make_mesh(devices=np.array(jax.devices()[:2]), n_model=n_model)
        return job, mesh, JaxTrainer(JaxStage1Config(
            **dict(JAX_KW, target_sample_rate=job.sr), **layout),
            enc_config=TINY, mesh=mesh)

    init = jax.device_get(trainer_for("dp_nodrop")[2].init_state(
        jax.random.PRNGKey(0)).params)
    weights = os.path.join(out, "weights.pt")
    torch.save(jax_params_to_torch(port_config(TINY), init["encoder"],
                                   init["compression"], {}), weights)
    with ThreadPoolExecutor(1) as pool:
        gang = pool.submit(mp_smoke.launch_gang, out, list(MESHES), n=2,
                           device="cpu", weights=weights, timeout=300)
        want = {}
        for leg in MESHES:
            job, mesh, trainer = trainer_for(leg)
            batch = mp_smoke.fixed_batches(job, 1)[0]
            jax_batch = dict(batch, labels=batch["labels"].astype(np.int32),
                             multi_labels=batch["labels"].astype(np.int32))
            state = trainer.init_state(jax.random.PRNGKey(0))
            dev_batch = {k: jax.device_put(v, batch_sharding(mesh))
                         for k, v in jax_batch.items()}
            state, m = trainer.train_step(state, dev_batch, jnp.float32(1.0))
            want[leg] = (float(m["loss"]), jax.device_get(state.params))
        gang = gang.result()
    return init, want, gang, out


def _update_agrees(got, want, init, name):
    """The port's update of one leaf against JAX's, from the same
    initial value: cosine >= 0.999 and norms within 1e-2, or both
    zero where the step leaves the leaf alone."""
    g = np.asarray(got, np.float64) - np.asarray(init, np.float64)
    w = np.asarray(want, np.float64) - np.asarray(init, np.float64)
    gn, wn = np.linalg.norm(g), np.linalg.norm(w)
    if wn == 0.0:
        assert gn == 0.0, name
        return
    assert gn > 0.0, f"{name}: the gang left it unchanged"
    cos = float((g * w).sum() / (gn * wn))
    assert cos >= 0.999, f"{name}: update cosine {cos}"
    assert gn / wn == pytest.approx(1.0, abs=1e-2), name


@pytest.mark.parametrize("leg", list(MESHES))
def test_gang_step_equals_the_jax_mesh_step(runs, leg):
    init, want, gang, out = runs
    loss, params = want[leg]
    for r in gang[leg]:
        assert r["losses"][0] == pytest.approx(loss, rel=1e-4)
    got = torch.load(os.path.join(out, f"{leg}.pt"))
    enc = convert_hf_state_dict(
        {k[len("encoder."):]: v.numpy() for k, v in got.items()
         if k.startswith("encoder.")}, TINY)
    got_leaves, got_def = jax.tree_util.tree_flatten_with_path(enc)
    want_leaves, want_def = jax.tree_util.tree_flatten(params["encoder"])
    init_leaves, _ = jax.tree_util.tree_flatten(init["encoder"])
    assert got_def == want_def
    for (path, g), w, i in zip(got_leaves, want_leaves, init_leaves):
        np.testing.assert_allclose(g, np.asarray(w), rtol=2e-4, atol=2e-5)
        name = jax.tree_util.keystr(path)
        # k_proj's bias adds q.b_k to every key's score of a query, which
        # the softmax cancels: its gradient is zero but for rounding, and
        # Adam's first step turns that rounding into a full enc_lr either
        # way, in both frameworks
        if "'k_proj']['bias'" not in name:
            _update_agrees(g, w, i, name)
    proj = params["compression"]["proj"]
    np.testing.assert_allclose(got["compression.proj.weight"].numpy(),
                               np.asarray(proj["kernel"]).T, rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(got["compression.proj.bias"].numpy(),
                               np.asarray(proj["bias"]), rtol=2e-4,
                               atol=2e-5)
