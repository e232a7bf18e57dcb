"""Real multi-process runs of the port (Gloo on the CPU): one 2-rank gang
and one 4-rank gang of parallel/mp_smoke.py, launched once for the
module, held against the single-process port at the global batch with
every random draw on (dropout, SpecAugment, compression dropout, device
RawBoost): losses rtol 1e-5, parameters rtol 2e-4 / atol 2e-5 (the
tolerances of tests/test_sharding.py::test_dp_tp_train_step; measured
~1 % of them: a gang sums its rows in another order). The encoder's
AdamW steps (enc_lr 1e-5) sit near that atol and Adam is blind to a
gradient's scale, so the first step's gradients are also held, each
parameter's by cosine >= 0.999 and norm within 1e-3, and each optimizer
group's norm as the clip computes it over the shards within 1e-3. The
legs: data parallel, fsdp, tensor parallel, GPipe pipeline ('pp' on
(1, 2), 'dp_pp' on (2, 2)) and sequence parallel ('tp_sp' on (1, 2),
'tp4_sp' on (1, 4), 'fsdp_tp_sp' on (2, 2); the frame padding runs, on
1 kHz clips' 99 frames over 2 'model' ranks and 399 over 4,
mp_smoke.Job.for_leg). Also the
global-batch SupCon, collective checkpoints across layouts both ways
(a pipeline's too), preemption agreement, `fit` in lockstep, the
baseline under fsdp, extraction and `fit_from_features` across a gang,
and `train_stage1` launched with torchrun's variables, under 'pp', with
sequence parallelism and from features."""

import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from chip_smoke import write_corpus
from tests.test_torch_bridge import cap_torch_threads
from wav2vec_contr_loss_torch.config import SupConConfig
from wav2vec_contr_loss_torch.ops.supcon import supcon_binary_loss_fused
from wav2vec_contr_loss_torch.parallel import mp_smoke
from wav2vec_contr_loss_torch.train import Stage1Trainer
from wav2vec_contr_loss_torch.train import checkpoint as ckpt

cap_torch_threads()

LEGS2 = ["dp", "fsdp", "tp", "pp", "tp_sp", "baseline_smoke", "supcon",
         "smoke", "restore_tp", "restore_fsdp", "restore_pp",
         "restore_fsdp_pp", "restore_pp_tp", "extract", "features"]
LEGS4 = ["fsdp_tp", "dp_pp", "fsdp_tp_sp", "tp4_sp"]
STEP_LEGS = ["dp", "fsdp", "tp", "fsdp_tp", "pp", "dp_pp", "tp_sp",
             "fsdp_tp_sp", "tp4_sp"]
LOSS_RTOL = 1e-5
PARAM_TOL = dict(rtol=2e-4, atol=2e-5)
GRAD_COS = 0.999
NORM_RTOL = 1e-3


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    """The 2-rank and 4-rank runs and the single-process references,
    computed here while the gangs run: {'out', 'two', 'out4', 'four',
    'single' (the single-process checkpoint's state), 'ref' (the stage-1
    legs' one reference: dp, fsdp, tp and fsdp+tp compute the same
    global step), 'baseline', 'smoke' (the references of those legs)}."""
    root = tmp_path_factory.mktemp("gang")
    out2, out4 = str(root / "two"), str(root / "four")
    single = mp_smoke.write_single_checkpoint(os.path.join(out2, "single"))
    with ThreadPoolExecutor(2) as pool:
        two = pool.submit(mp_smoke.launch_gang, out2, LEGS2, 2,
                          device="cpu", timeout=300, grads=True,
                          save=["pp"])
        four = pool.submit(mp_smoke.launch_gang, out4, LEGS4, 4,
                           device="cpu", timeout=300, grads=True)
        refs = {"ref": mp_smoke.run_leg("dp", None, "cpu", grads=True),
                "ref_sp": mp_smoke.run_leg("tp_sp", None, "cpu",
                                           grads=True),
                "baseline": mp_smoke.baseline_smoke(
                    None, "cpu", str(root / "baseline_ref")),
                "smoke": mp_smoke.run_smoke(None, "cpu",
                                            str(root / "smoke_ref")),
                "extract": mp_smoke.extract_leg(None, "cpu"),
                "features": mp_smoke.features_leg(None, "cpu")}
        two, four = two.result(), four.result()
    return dict(refs, out=out2, two=two, out4=out4, four=four, single=single)


def _close(got, want):
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], **PARAM_TOL, msg=k)


def _run(gang, leg):
    """(ranks, output directory, each rank's result, the single-process
    reference) of a stage-1 leg (the sequence-parallel legs' on their
    1 kHz clips)."""
    ref = gang["ref" if mp_smoke.Job().for_leg(leg) == mp_smoke.Job()
               else "ref_sp"]
    if leg in LEGS4:
        return 4, gang["out4"], gang["four"][leg], ref
    return 2, gang["out"], gang["two"][leg], ref


@pytest.mark.parametrize("leg", STEP_LEGS)
def test_gang_steps_equal_the_single_process_port(gang, leg):
    n, out, results, ref = _run(gang, leg)
    assert len(results) == n
    for r in results:   # every rank reports the global batch's loss
        assert r["losses"] == results[0]["losses"]
        np.testing.assert_allclose(r["losses"], ref["losses"],
                                   rtol=LOSS_RTOL)
        # the plain versions run on the CPU: no kernel launches
        assert set(r["launches"].values()) == {0}
    _close(torch.load(os.path.join(out, f"{leg}.pt")), ref["state"])


@pytest.mark.parametrize("leg", STEP_LEGS)
def test_gang_first_step_gradients_equal_the_single_process_port(gang, leg):
    """The first step's gradients, averaged over 'data' and gathered to
    full, against one process's at the global batch, by direction and by
    size: a missing or doubled average, or a shard's square counted
    twice in the clip's norm, moves a norm by a factor of 2 or more.
    Under 'pp' that holds for what lies outside the stack too (its
    gradient crosses the pipe's input once), under sequence parallelism
    for the layers' LayerNorms and row biases (summed over 'model')."""
    n, out, results, ref = _run(gang, leg)
    got = torch.load(os.path.join(out, f"{leg}.grad.pt"))
    want = ref["grads"]
    assert set(got) == set(want)
    for k in want:
        # k_proj's bias adds q.b_k to all of a query's scores, which the
        # softmax cancels: its gradient is rounding alone
        if k.endswith("k_proj.bias"):
            continue
        a, b = got[k].double().flatten(), want[k].double().flatten()
        assert b.norm() > 0, k
        cos = float(a @ b / (a.norm() * b.norm()))
        assert cos >= GRAD_COS, f"{k}: gradient cosine {cos}"
        assert float(a.norm() / b.norm()) == pytest.approx(
            1.0, rel=NORM_RTOL), k
    for r in results:
        assert set(r["grad_norms"]) == set(ref["grad_norms"])
        for name, norm in ref["grad_norms"].items():
            assert r["grad_norms"][name] == pytest.approx(
                norm, rel=NORM_RTOL), name


def test_baseline_gang_clip_norm_equals_the_single_process_port(gang):
    """The norm the baseline's clip over every gradient took in the last
    step of `fit`, on each rank of the fsdp gang (the squares of its
    shards summed over 'data'), against one process's."""
    want = gang["baseline"]["grad_norms"]
    for r in gang["two"]["baseline_smoke"]:
        assert set(r["grad_norms"]) == set(want)
        for name, norm in want.items():
            assert norm > 0, name
            assert r["grad_norms"][name] == pytest.approx(
                norm, rel=NORM_RTOL), name


def test_baseline_fsdp_layout(gang):
    """`BaselineTrainer` under fsdp on 2 ranks: 2 epochs of `fit` end on
    the single-process run's parameters and losses."""
    want = gang["baseline"]
    for r in gang["two"]["baseline_smoke"]:
        np.testing.assert_allclose(r["train_loss"], want["train_loss"],
                                   rtol=LOSS_RTOL)
    _close(torch.load(os.path.join(gang["out"], "baseline_smoke.pt")),
           want["state"])


def test_baseline_fit_scores_dev_over_gathered_logits(gang):
    """The baseline's `fit` in a gang: each rank scores its rows of the
    dev batches, the logits are gathered over 'data', and every rank
    finds the single-process run's dev EER each epoch."""
    want = gang["baseline"]
    r0, r1 = gang["two"]["baseline_smoke"]
    assert r0["dev_eer"] == r1["dev_eer"] == want["dev_eer"]
    assert r0["logits"] == r1["logits"]
    assert len(r0["logits"]) == mp_smoke.N_CLIPS
    np.testing.assert_allclose(r0["logits"], want["logits"], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(r0["train_loss"], want["train_loss"],
                               rtol=LOSS_RTOL)


def test_global_loss_equals_replica_average(gang):
    """The SupCon loss of rows gathered over 'data' is the global batch's
    on every rank, and each rank's rows get n_data times their rows of
    the global dL/dz (the average over 'data' then gives dL/dtheta)."""
    rng = np.random.default_rng(1)
    z = rng.normal(size=(32, 8)).astype(np.float32)
    z /= np.linalg.norm(z, axis=1, keepdims=True)
    zt = torch.tensor(z, requires_grad=True)
    loss = supcon_binary_loss_fused(zt, torch.tensor([1, 0] * 16), 0.5,
                                    SupConConfig())
    loss.backward()
    for rank, r in enumerate(gang["two"]["supcon"]):
        assert r["loss"] == pytest.approx(loss.item(), rel=1e-6)
        np.testing.assert_allclose(
            np.asarray(r["grad"]) / 2, zt.grad[16 * rank:16 * (rank + 1)],
            rtol=1e-5, atol=1e-7)


def test_fit_keeps_every_rank_in_lockstep(gang):
    """`fit` (2 epochs, dev set, collective checkpoints, fsdp) gives every
    rank the single-process run's losses."""
    want = gang["smoke"]
    r0, r1 = gang["two"]["smoke"]
    for r in (r0, r1):
        assert r["train_loss"] == r0["train_loss"]
        assert r["dev_loss"] == r0["dev_loss"]
        np.testing.assert_allclose(r["train_loss"], want["train_loss"],
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(r["dev_loss"], want["dev_loss"],
                                   rtol=LOSS_RTOL)
    assert r0["param_sum"] == pytest.approx(want["param_sum"], rel=1e-5)


def test_gang_checkpoint_restores_single_process(gang):
    """The fsdp gang's collective checkpoint (shards gathered, rank 0
    writes) restores in one process; its parameters are the gang's."""
    directory = os.path.join(gang["out"], "ckpt", "fit")
    trainer = Stage1Trainer.from_checkpoint(directory, "latest",
                                            device="cpu")
    assert trainer.cfg.param_sharding == "fsdp"
    state, _ = ckpt.restore_checkpoint(directory, "latest")
    for k, v in trainer.encoder.state_dict().items():
        assert torch.equal(v, state["encoder"][k]), k
    total = sum(v.double().sum() for part in ("encoder", "compression")
                for v in state[part].values())
    assert float(total) == pytest.approx(
        gang["two"]["smoke"][0]["param_sum"], rel=1e-9)
    # the moments too, in their full shapes
    opt = trainer.optimizer.groups["encoder"]
    assert [m.shape for m in opt.mu] == [p.shape for p in opt.params]


@pytest.mark.parametrize("leg", ["restore_tp", "restore_fsdp",
                                 "restore_pp", "restore_fsdp_pp",
                                 "restore_pp_tp"])
def test_checkpoint_restores_across_mesh_shapes(gang, leg):
    """restore_tp: the fsdp gang's checkpoint on a (1, 2) tensor-parallel
    mesh; restore_fsdp: a single-process checkpoint on a (2, 1) fsdp
    mesh; restore_pp and restore_fsdp_pp: a single-process and the fsdp
    gang's checkpoint on a (1, 2) pipeline; restore_pp_tp: the pipeline
    gang's checkpoint on a (1, 2) tensor-parallel mesh. The restored
    state gathered back is the file's, bit for bit, and one step there
    gives the single-process restore's loss."""
    directory, _, _ = mp_smoke.RESTORES[leg]
    path = os.path.join(gang["out"], directory)
    state, _ = ckpt.restore_checkpoint(path, "latest")
    got = torch.load(os.path.join(gang["out"], f"{leg}.pt"))
    for part in ("encoder", "compression"):
        for k, v in state[part].items():
            assert torch.equal(got[f"{part}.{k}"], v), k
    if leg in ("restore_fsdp", "restore_pp"):
        for k, v in gang["single"].items():
            assert torch.equal(got[k], v), k
    want = mp_smoke.restore(leg, gang["out"], None, "cpu")
    for r in gang["two"][leg]:
        assert r["loss"] == pytest.approx(want["loss"], rel=2e-5)


def test_pipeline_checkpoint_restores_single_process(gang):
    """The pp gang's collective checkpoint (each layer broadcast from its
    stage, rank 0 writes) restores in one process, parameters and
    moments in their full shapes, and equals the gang's gathered
    state."""
    directory = os.path.join(gang["out"], "ckpt", "pp")
    trainer = Stage1Trainer.from_checkpoint(directory, "latest",
                                            device="cpu")
    assert trainer.cfg.param_sharding == "pp"
    got = mp_smoke.model_state(trainer)
    want = torch.load(os.path.join(gang["out"], "pp.pt"))
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    opt = trainer.optimizer.groups["encoder"]
    assert [m.shape for m in opt.mu] == [p.shape for p in opt.params]
    assert all(m.numel() for m in opt.mu)


@pytest.mark.parametrize("n_model", [2, 4])
def test_sequence_parallel_pads_the_frames(gang, n_model):
    """'tp_sp' on (1, 2) takes T' = 99 frames and 'tp4_sp' on (1, 4)
    T' = 399 (mp_smoke.Job.for_leg): neither divides, so both pad with
    masked frames, and still compute one process's step."""
    from wav2vec_contr_loss_torch.config import feature_frame_length

    leg = {2: "tp_sp", 4: "tp4_sp"}[n_model]
    job = mp_smoke.Job().for_leg(leg)
    frames = int(feature_frame_length(torch.tensor(job.sr * job.seconds),
                                      mp_smoke.encoder_config(True)))
    assert frames == {2: 99, 4: 399}[n_model] and frames % n_model
    n, out, results, ref = _run(gang, leg)
    assert n == n_model
    for r in results:
        np.testing.assert_allclose(r["losses"], ref["losses"],
                                   rtol=LOSS_RTOL)
    _close(torch.load(os.path.join(out, f"{leg}.pt")), ref["state"])


def test_gang_extraction_equals_one_process(gang):
    """`embed_dataset` across 2 ranks (each decodes and embeds its rows of
    every batch of 6, the last padded with 2 invalid clips) gives every
    rank one process's embeddings and labels in corpus order."""
    want = gang["extract"]
    for r in gang["two"]["extract"]:
        assert len(r["embeddings"]) == mp_smoke.N_CLIPS
        assert r["labels"] == want["labels"]
        np.testing.assert_allclose(r["embeddings"], want["embeddings"],
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["binary", "multiclass"])
def test_gang_fit_from_features_equals_one_process(gang, mode):
    """`fit_from_features` across 2 ranks (each its rows of the global
    balanced batches, the loss on the gathered embeddings): every rank's
    train and dev losses, and the head, are one process's."""
    want = gang["features"]
    for r in gang["two"]["features"]:
        for key in ("train_loss", "dev_loss"):
            np.testing.assert_allclose(r[mode][key], want[mode][key],
                                       rtol=LOSS_RTOL)
    got = torch.load(os.path.join(gang["out"], "features.pt"))
    _close({k: v for k, v in got.items() if k.startswith(mode)},
           {k: v for k, v in want["state"].items() if k.startswith(mode)})


def test_preemption_flag_agreement_across_processes(gang):
    """The flag is raised on rank 0 only; the guard's all-reduce every 2
    steps stops both ranks at step 2, and the mid-epoch save from there
    is a working collective, restorable in one process."""
    for r in gang["two"]["smoke"]:
        assert r["preempted"] is True and r["preempt_step"] == 2
    directory = os.path.join(gang["out"], "ckpt", "preempt")
    m = ckpt.load_sidecar(directory, "latest")["metrics"]
    assert m["preempted"] is True and m["batches_done"] == 2
    trainer = Stage1Trainer.from_checkpoint(directory, "latest",
                                            device="cpu")
    assert trainer.step == 2
    assert ckpt.resume_cursor(m) == (1, 2)


def test_train_stage1_cli_under_torchrun_variables(tmp_path):
    """Two processes with torchrun's variables run `train_stage1` for an
    epoch as one fsdp gang; rank 0 writes the checkpoints."""
    root, save = str(tmp_path / "corpus"), str(tmp_path / "save")
    write_corpus(root, 16, seed=0, seconds=1.0)
    cmd = [sys.executable, "-m", "wav2vec_contr_loss_torch.cli.train_stage1",
           "--device", "cpu", "--model_name", "test/tiny-wav2vec2",
           "--encoder_init", "random", "--compute_dtype", "float32",
           "--train_root", root, "--train_protocol",
           os.path.join(root, "protocol.txt"), "--epochs", "1",
           "--batch_size", "8", "--max_duration_seconds", "1",
           "--input_dim", "32", "--hidden_dim", "16", "--num_workers", "1",
           "--param_sharding", "fsdp", "--save_dir", save]
    logs = mp_smoke.spawn(cmd, 2, timeout=300, threads=1)
    assert "Stage-1 training complete" in logs[0]
    assert "=== CONFIG ===" not in logs[1]     # rank 0 alone logs
    directory = os.path.join(save, "test__tiny-wav2vec2")
    m = ckpt.load_sidecar(directory, "latest")
    assert m["metrics"]["epoch"] == 1
    assert m["extra"]["stage1_config"]["param_sharding"] == "fsdp"
    assert ckpt.checkpoint_exists(directory, "best")


def test_single_process_cli_ignores_a_gang_of_one(tmp_path):
    """Without torchrun's variables (or with --multihost 0) the CLI trains
    as one process: no process group is joined."""
    out = subprocess.run(
        [sys.executable, "-c",
         "import torch.distributed as d\n"
         "from wav2vec_contr_loss_torch.utils import distributed as u\n"
         "import argparse\n"
         "a = argparse.Namespace(multihost=0)\n"
         "assert u.init_from_args(a, device='cpu') is False\n"
         "assert u.maybe_initialize(device='cpu') is False\n"
         "assert not d.is_initialized() and u.world_size() == 1\n"],
        env={k: v for k, v in os.environ.items()
             if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR")},
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
