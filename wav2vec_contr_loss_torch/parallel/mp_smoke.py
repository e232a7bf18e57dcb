"""A real multi-process run of the port's stage-1 and baseline trainers.

The port of wav2vec_contr_loss_tpu/parallel/mp_smoke.py (`run_smoke`,
`launch_gang`, `main`): the same tiny stage-1 job (4 layers, 64 wide, 4
heads, B = 8 from 16 clips, 2 epochs) run either in one process or as N
real processes of a torch.distributed gang (Gloo on the CPU; NCCL, or
Gloo with CUDA tensors, on the card). Every path of a gang runs: the
global balanced sampler, each rank's slice of the global batch, the
sharded train steps, `fit` with a dev set and its collective
checkpoints, and a preemption flag raised on rank 0 only.

A run is a list of legs (`LEGS`, 'smoke', 'baseline_smoke', `RESTORES`,
'supcon', 'extract', 'features'), each
on the mesh its layout needs over the same process group. Each leg
prints its losses, parameter sums and the kernels' launch counts as
JSON; rank 0 also writes the leg's full (gathered) model state, so a
caller compares it with a single-process run of the same leg
(`run_leg(..., mesh=None)`) at the global batch.

    python -m wav2vec_contr_loss_torch.parallel.mp_smoke --out DIR \\
        --legs dp,fsdp,tp   (under torchrun, or through `launch_gang`)

on the card by default; `--device cpu` (launch_gang(device='cpu')) runs
the ranks on the CPU over Gloo.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

N_CLIPS = 16
BATCH = 8
SR, SECONDS = 4000, 1      # 4000 samples -> 399 frames
EPOCHS = 2                 # 16 clips / batch 8 -> 2 steps an epoch

# stage-1 legs: name -> (param_sharding, n_model, every random draw on,
# other Stage1Config fields); the mesh's 'data' axis takes the other
# ranks, so 'dp_pp' and 'fsdp_tp_sp' are (2, 2) on four ranks
PP = {"pipeline_microbatches": 4}
SP = {"sequence_parallel": True}
LEGS = {
    "dp": ("replicated", 1, True, {}),
    "fsdp": ("fsdp", 1, True, {}),
    "tp": ("replicated", 2, True, {}),
    "fsdp_tp": ("fsdp", 2, True, {}),
    "pp": ("pp", 2, True, PP),
    "dp_pp": ("pp", 2, True, PP),
    "tp_sp": ("replicated", 2, True, SP),
    "fsdp_tp_sp": ("fsdp", 2, True, SP),
    "tp4_sp": ("replicated", 4, True, SP),
    "dp_nodrop": ("replicated", 1, False, {}),
    "tp_nodrop": ("replicated", 2, False, {}),
    "pp_nodrop": ("pp", 2, False, {}),
    "tp_sp_nodrop": ("replicated", 2, False, SP),
}


def encoder_config(dropout: bool = True, width: str = "tiny"):
    """'tiny': the JAX smoke job's encoder (fp32); 'wide': XLS-R-300M's
    widths (1024, 16 heads, 4096 FFN) at 4 layers, bf16; 'full':
    XLS-R-300M whole (24 layers), bf16. `dropout`: every dropout at 0.1
    and SpecAugment on, else all off. The card's widths keep bf16, the
    step's default compute, though the kernels take fp32 too: the legs
    hold a gang's layouts against one process, which the dtype does not
    change, and 2-4 ranks share one card, where fp32 doubles each rank's
    activations. fp32 gangs run in the tiny job; the fp32 kernels and
    the fp32 step are held by chip_smoke.py's fp32 phase."""
    from ..config import XLSR_300M, Wav2Vec2Config

    rate = 0.1 if dropout else 0.0
    drops = dict(hidden_dropout=rate, attention_dropout=rate,
                 activation_dropout=rate, feat_proj_dropout=rate,
                 apply_spec_augment=dropout)
    if width == "wide":
        return XLSR_300M.with_(num_layers=4, dtype="bfloat16", **drops)
    if width == "full":
        return XLSR_300M.with_(dtype="bfloat16", **drops)
    return Wav2Vec2Config(
        hidden_size=64, num_layers=4, num_heads=4, intermediate_size=128,
        conv_dim=(32, 32), conv_kernel=(10, 3), conv_stride=(5, 2),
        num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
        dtype="float32", **drops)


@dataclasses.dataclass(frozen=True)
class Job:
    """The sizes of a run: 'tiny' (the CPU tests, fp32), 'wide' (the
    card: XLS-R-300M widths at 4 layers, B = 16 x 2 s, bf16) or 'full'
    (the card: XLS-R-300M at 24 layers, B = 32 x 5 s, bf16), and
    the steps of a `LEGS` leg with its draws on."""

    width: str = "tiny"
    batch: int = BATCH
    sr: int = SR
    seconds: int = SECONDS
    steps: int = 2

    def for_leg(self, leg: str) -> "Job":
        """The job a `LEGS` leg runs. A sequence-parallel leg of the tiny
        job on two 'model' ranks takes 1 s clips at 1 kHz, 99 frames (as
        2 s at 16 kHz give the wide job), which 2 does not divide, so the
        frame padding runs; on four ranks it keeps the 4 kHz clips' 399
        frames, which 4 does not divide either. (At 1 kHz, every draw on,
        one element of the layer mean is 0.0 in one process and 1.5e-7
        on four tensor-parallel ranks, with or without sequence
        parallelism: the compression's LeakyReLU kink, whose gradient
        slopes 0.01 and 1 then differ.)"""
        _, n_model, _, kw = LEGS[leg]
        if (self.width == "tiny" and kw.get("sequence_parallel")
                and n_model == 2):
            return dataclasses.replace(self, sr=1000)
        return self

    @classmethod
    def named(cls, width: str) -> "Job":
        return {"wide": cls("wide", 16, 16000, 2, 3),
                "full": cls("full", 32, 16000, 5, 3)}.get(width, cls())


def stage1_config(job: Job, dropout: bool, param_sharding: str, **kw):
    from ..config import Stage1Config

    wide = job.width != "tiny"
    return Stage1Config(
        batch_size=job.batch, max_duration_seconds=job.seconds,
        target_sample_rate=job.sr, input_dim=1024 if wide else 64,
        hidden_dim=256 if wide else 16, finetune_encoder=True,
        use_rawboost=dropout, rawboost_mode="device", rawboost_prob=1.0,
        compute_dtype="bfloat16" if wide else "float32",
        grad_dtype="auto" if wide else "float32",
        adam_mu_dtype="bfloat16" if wide else "float32",
        adam_nu_dtype="bfloat16" if wide else "float32",
        dropout=0.1 if dropout else 0.0, seed=0, epochs=EPOCHS,
        warmup_epochs=1, alpha_ramp_epochs=1,
        param_sharding=param_sharding, **kw)


def baseline_config(job: Job, param_sharding: str):
    from ..config import BaselineConfig

    return BaselineConfig(
        batch_size=job.batch, max_duration_seconds=job.seconds,
        target_sample_rate=job.sr, input_dim=64, hidden_dim=16,
        finetune_encoder=True, use_rawboost=True, rawboost_mode="device",
        rawboost_prob=1.0, compute_dtype="float32", grad_dtype="float32",
        adam_mu_dtype="float32", adam_nu_dtype="float32", seed=0,
        epochs=EPOCHS, param_sharding=param_sharding)


def initial_weights(enc_cfg, hidden_dim: int, classifier: bool = False):
    """Seeded random weights in the port's state dicts (seed 0)."""
    from ..bridge import (dense_state_dict, jax_params_to_torch,
                          random_dense, random_jax_trees)

    w = jax_params_to_torch(enc_cfg, *random_jax_trees(
        enc_cfg, comp_dim=hidden_dim, seed=0))
    if classifier:
        w["classifier"] = dense_state_dict(random_dense(hidden_dim, 1, seed=1))
    return w


def corpus(job: Job, n: int = N_CLIPS):
    """n deterministic synthetic clips, the same in every process; two
    with zero-padded tails."""
    rng = np.random.default_rng(0)
    wave = rng.normal(0, 0.2, (n, job.sr * job.seconds)).astype(np.float32)
    wave[1, wave.shape[1] * 3 // 4:] = 0.0
    wave[6, wave.shape[1] // 3:] = 0.0
    labels = np.array([1, 0] * (n // 2), np.int32)
    return wave, labels


class ArrayPipe:
    """A BatchPipeline over in-memory clips: balanced global batches
    (the sampler's 'global' mode, as every rank draws them), no host
    RawBoost."""

    rawboost = None

    def __init__(self, wave, labels, batch: int, seed: int):
        from ..data.sampler import BalancedBatchSampler

        self.wave, self.labels = wave, labels
        self.sampler = BalancedBatchSampler(labels, batch, seed=seed)

    def train_epoch(self, epoch: int, skip: int = 0) -> Iterator:
        from ..data.pipeline import Batch

        for i, idx in enumerate(self.sampler.epoch_batches(epoch)):
            if i >= skip:
                yield Batch(self.wave[idx], self.labels[idx],
                            self.labels[idx], np.ones(len(idx), bool))

    def sequential(self, part=None) -> Iterator:
        """Every clip in order, the last batch padded with invalid zero
        clips; `part` (i, n): rows [i*B/n, (i+1)*B/n) of each batch
        (BatchPipeline.sequential)."""
        from ..data.pipeline import Batch

        b = self.sampler.batch_size
        i, n = part or (0, 1)
        rows = slice(i * b // n, (i + 1) * b // n)
        for start in range(0, len(self.labels), b):
            idx = np.arange(start, min(start + b, len(self.labels)))
            pad = b - len(idx)
            wave = np.concatenate([self.wave[idx], np.zeros(
                (pad, self.wave.shape[1]), np.float32)])
            labels = np.concatenate([self.labels[idx],
                                     np.zeros(pad, self.labels.dtype)])
            valid = np.arange(b) < len(idx)
            yield Batch(wave[rows], labels[rows], labels[rows], valid[rows])


def fixed_batches(job: Job, n: int) -> List[Dict[str, np.ndarray]]:
    """The first `n` global batches of the sampler, as host arrays (from
    at least a batch's clips)."""
    wave, labels = corpus(job, max(N_CLIPS, job.batch))
    out = []
    for epoch in range(1, n + 1):
        for b in ArrayPipe(wave, labels, job.batch, seed=0).train_epoch(epoch):
            out.append({"waveforms": b.waveforms, "labels": b.labels,
                        "multi_labels": b.multi_labels})
    return out[:n]


def launch_counts() -> Dict[str, int]:
    """The kernel wrappers' launch counters, by kernel."""
    from ..ops import attention, conv_ln, supcon

    return {"attention_fwd": attention.launches,
            "attention_bwd": attention.bwd_launches,
            "ln_gelu_fwd": conv_ln.launches,
            "ln_gelu_bwd": conv_ln.bwd_launches,
            "supcon": supcon.launches}


def _since(before: Dict[str, int]) -> Dict[str, int]:
    return {k: v - before[k] for k, v in launch_counts().items()}


def model_state(trainer) -> Dict[str, torch.Tensor]:
    """A host copy of the trainer's full parameters, HF-named under their
    module ('encoder.', 'compression.', 'classifier.'); collective in a
    gang."""
    from ..train.stage1 import _module_states

    state = _module_states(trainer.layout, trainer._parts)
    return {f"{part}.{k}": v.detach().to("cpu", copy=True)
            for part, sd in state.items() for k, v in sd.items()}


def gradients(trainer) -> Dict[str, torch.Tensor]:
    """A host copy of the gradients the trainer's last step left (in a
    gang averaged over 'data' and gathered to full; a pipeline's layers
    from their stage), named as `model_state` names the parameters;
    collective in a gang."""
    layout = trainer.layout
    out = {}
    for part, module in trainer._parts.items():
        if module is None:
            continue
        for name, p in module.named_parameters():
            held = layout is not None and layout.owner(name) is not None
            if p.grad is None and not held:
                continue
            g = (p.grad if layout is None else
                 layout.full(name, p if p.grad is None else p.grad, like=p))
            out[f"{part}.{name}"] = g.detach().to("cpu", copy=True)
    return out


def grad_norms(trainer) -> Dict[str, float]:
    """Each optimizer group's gradient norm as a clip computes it from
    this rank's shards (the squares summed over the ranks that hold the
    other shards), from the gradients the last step left; collective in
    a gang."""
    from ..train.optim import global_norm

    return {name: float(global_norm(grp.norm_inputs(), grp.norm_groups))
            for name, grp in trainer.optimizer.groups.items()}


def make_mesh_for(n_model: int, device: torch.device):
    from .mesh import make_mesh

    return make_mesh(n_model=n_model, device_type=device.type)


def run_leg(name: str, mesh, device, job: Job = Job(),
            weights: Optional[Dict] = None, steps: Optional[int] = None,
            save_dir: Optional[str] = None, grads: bool = False) -> Dict:
    """One leg of `LEGS` (on `job.for_leg(name)`): `steps` (job.steps;
    1 without dropout) steps
    on the sampler's first global batches, on `mesh` (a gang) or alone
    (mesh None, the reference at the global batch); with `save_dir`, then
    a (collective) checkpoint there, 'latest'. -> {'losses', 'ms' (host
    clock a step, to the loss on the host), 'peak_gib' (on the card),
    'param_sum', 'launches', 'state', 'grad_norms' (`grad_norms` after
    the first step), and with `grads` the first step's 'grads'}."""
    from ..train import Stage1Trainer
    from ..train import checkpoint as ckpt
    from .mesh import local_batch, shard_of

    sharding, _, dropout, kw = LEGS[name]
    job = job.for_leg(name)
    device = torch.device(device)
    steps = steps or (job.steps if dropout else 1)
    enc_cfg = encoder_config(dropout, job.width)
    cfg = stage1_config(job, dropout, sharding, **kw)
    weights = weights or initial_weights(enc_cfg, cfg.hidden_dim)
    if device.type == "cuda":   # what earlier work left counts no more
        gc.collect()
        torch.cuda.empty_cache()
    trainer = Stage1Trainer(cfg, enc_cfg, weights, device=device, mesh=mesh)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    losses, ms, first, norms = [], [], None, None
    before = launch_counts()
    for batch in fixed_batches(job, steps):
        if mesh is not None:
            batch = local_batch(batch, shard_of(mesh))
        t0 = time.perf_counter()
        out = trainer.train_step(batch, 1.0)
        losses.append(float(out["loss"]))     # waits for the step
        ms.append(1e3 * (time.perf_counter() - t0))
        print(f"[mp_smoke] {name} step {len(ms)}: {ms[-1]:.1f} ms",
              flush=True)
        if norms is None:
            norms = grad_norms(trainer)
            first = gradients(trainer) if grads else None
    launches = _since(before)
    peak = (torch.cuda.max_memory_allocated(device) / 2 ** 30
            if device.type == "cuda" else None)
    if save_dir is not None:
        ckpt.save_checkpoint(save_dir, "latest", trainer.state_dict(),
                             trainer.cfg.ckpt_config(), {"steps": steps},
                             trainer._sidecar_extra())
    state = model_state(trainer)
    return {"losses": losses, "ms": ms, "peak_gib": peak,
            "launches": launches, "state": state, "grads": first,
            "grad_norms": norms,
            "param_sum": float(sum(v.double().sum() for v in state.values()))}


def run_smoke(mesh, device, ckpt_dir: str, job: Job = Job()) -> Dict:
    """The JAX smoke job's counterpart: `fit` under fsdp for 2 epochs with
    a dev set and collective checkpoints, then, in a gang, a preemption
    flag raised on rank 0 only that must stop every rank at one step
    (sync_every 2) with a collective mid-epoch save. (The composed
    fsdp+tp layout is the 'fsdp_tp' leg.)"""
    from ..train import Stage1Trainer
    from ..utils import distributed
    from ..utils.preemption import PreemptionGuard

    enc_cfg = encoder_config(True, job.width)
    cfg = stage1_config(job, True, "fsdp")
    wave, labels = corpus(job)
    trainer = Stage1Trainer(cfg, enc_cfg, initial_weights(
        enc_cfg, cfg.hidden_dim), device=device, mesh=mesh)
    history = trainer.fit(ArrayPipe(wave, labels, job.batch, cfg.seed),
                          ArrayPipe(wave, labels, job.batch, cfg.seed + 1),
                          save_dir=os.path.join(ckpt_dir, "fit"),
                          log_fn=lambda *a: None)
    state = model_state(trainer)
    out = {"train_loss": history["train_loss"],
           "dev_loss": history["dev_loss"],
           "param_sum": float(sum(v.double().sum() for v in state.values()))}
    if distributed.world_size() > 1:
        guard = PreemptionGuard(sync_every=2)
        if distributed.is_primary():
            guard.mark()
        trainer = Stage1Trainer(cfg, enc_cfg, initial_weights(
            enc_cfg, cfg.hidden_dim), device=device, mesh=mesh)
        stop = trainer.fit(ArrayPipe(wave, labels, job.batch, cfg.seed),
                           save_dir=os.path.join(ckpt_dir, "preempt"),
                           preemption=guard, log_fn=lambda *a: None)
        out["preempted"] = bool(stop.get("preempted"))
        out["preempt_step"] = trainer.step
    return out


# restore legs: (checkpoint directory under --out, param_sharding,
# n_model); 'restore_tp' and 'restore_fsdp_pp' read the 'smoke' leg's
# fsdp checkpoint, so they run after it, 'restore_pp_tp' the 'pp' leg's
# (saved with --save pp), and 'restore_fsdp' and 'restore_pp' a
# single-process one (`write_single_checkpoint`)
RESTORES = {"restore_tp": ("ckpt/fit", "replicated", 2),
            "restore_fsdp": ("single", "fsdp", 1),
            "restore_pp": ("single", "pp", 2),
            "restore_fsdp_pp": ("ckpt/fit", "pp", 2),
            "restore_pp_tp": ("ckpt/pp", "replicated", 2)}


def write_single_checkpoint(directory: str, job: Job = Job()) -> Dict:
    """One single-process step of the 'dp' leg's trainer, saved to
    <directory>/latest. -> its model state."""
    from ..train import Stage1Trainer
    from ..train import checkpoint as ckpt

    enc_cfg = encoder_config(True, job.width)
    cfg = stage1_config(job, True, "replicated")
    trainer = Stage1Trainer(cfg, enc_cfg, initial_weights(
        enc_cfg, cfg.hidden_dim), device="cpu")
    trainer.train_step(fixed_batches(job, 1)[0], 1.0)
    ckpt.save_checkpoint(directory, "latest", trainer.state_dict(),
                         cfg.ckpt_config(), {"epoch": 1},
                         trainer._sidecar_extra())
    return model_state(trainer)


def baseline_smoke(mesh, device, ckpt_dir: str, job: Job = Job()) -> Dict:
    """`BaselineTrainer.fit` for 2 epochs (fsdp on a mesh): the dev EER of
    each epoch from logits gathered over 'data', the collective
    checkpoints, and the norm the clip over every gradient took in the
    last step (`grad_norms`)."""
    from ..train import BaselineTrainer

    enc_cfg = encoder_config(True, job.width)
    cfg = baseline_config(job, "fsdp")
    wave, labels = corpus(job)
    trainer = BaselineTrainer(cfg, enc_cfg, initial_weights(
        enc_cfg, cfg.hidden_dim, True), device=device, mesh=mesh)
    history = trainer.fit(ArrayPipe(wave, labels, job.batch, cfg.seed),
                          ArrayPipe(wave[:12], labels[:12], job.batch, 0),
                          save_dir=os.path.join(ckpt_dir, "baseline"),
                          log_fn=lambda *a: None)
    norms = grad_norms(trainer)
    logits, _ = trainer.score_dataset(ArrayPipe(wave, labels, job.batch, 0))
    return {"train_loss": history["train_loss"], "grad_norms": norms,
            "dev_eer": history["dev_eer"], "logits": logits.tolist(),
            "state": model_state(trainer)}


def restore(name: str, out: str, mesh, device, job: Job = Job()) -> Dict:
    """A leg of `RESTORES`: the checkpoint restored on `mesh` (or alone)
    in the leg's layout, then one step on the first global batch.
    -> {'state': the restored full state (gathered), 'loss'}."""
    from ..train import Stage1Trainer
    from .mesh import local_batch, shard_of

    directory, sharding, _ = RESTORES[name]
    trainer = Stage1Trainer.from_checkpoint(
        os.path.join(out, directory), "latest", device=device, mesh=mesh,
        param_sharding=sharding)
    state = model_state(trainer)
    batch = fixed_batches(job, 1)[0]
    if mesh is not None:
        batch = local_batch(batch, shard_of(mesh))
    return {"state": state,
            "loss": float(trainer.train_step(batch, 1.0)["loss"])}


def supcon_leg(shard) -> Dict:
    """The binary SupCon loss of a (32, 8) global batch, each rank holding
    its rows: the loss and the gradient that reaches this rank's rows
    (n_data times its rows of dL/dz, collectives.gather_rows)."""
    from ..config import SupConConfig
    from ..ops.supcon import supcon_binary_loss_fused
    from .collectives import gather_rows

    rng = np.random.default_rng(1)
    z = rng.normal(size=(32, 8)).astype(np.float32)
    z /= np.linalg.norm(z, axis=1, keepdims=True)
    labels = torch.tensor([1, 0] * 16)
    per = 32 // shard.n_data
    rows = slice(shard.batch_offset(per), shard.batch_offset(per) + per)
    zl = torch.tensor(z[rows], requires_grad=True)
    loss = supcon_binary_loss_fused(gather_rows(zl, shard),
                                    gather_rows(labels[rows], shard), 0.5,
                                    SupConConfig())
    loss.backward()
    return {"loss": loss.item(), "grad": zl.grad.tolist()}


# the extraction leg's (clips, batch): the tiny job's 16 clips in 3
# batches, the last with 2 padded rows; the card's 48 clips in 2
# batches of 32, the last with 16
EXTRACT = {"tiny": (N_CLIPS, 6), "full": (48, 32)}


def extract_leg(mesh, device, job: Job = Job(),
                weights: Optional[Dict] = None) -> Dict:
    """`embed_dataset` of the seeded 'dp' trainer over a corpus in order
    (`EXTRACT`, its last batch padded), each rank embedding its rows (a
    data mesh) or alone. -> {'embeddings', 'labels'}, every rank's the
    gathered corpus, and 'launches', 'ms' (the pass, host clock)."""
    from ..train import Stage1Trainer

    enc_cfg = encoder_config(True, job.width)
    cfg = stage1_config(job, True, "replicated")
    trainer = Stage1Trainer(cfg, enc_cfg, weights or initial_weights(
        enc_cfg, cfg.hidden_dim), device=device, mesh=mesh)
    n, batch = EXTRACT[job.width]
    wave, labels = corpus(job, n)
    before = launch_counts()
    t0 = time.perf_counter()
    z, y = trainer.embed_dataset(ArrayPipe(wave, labels, batch, 0))
    return {"embeddings": z.tolist(), "labels": y.tolist(),
            "launches": _since(before),
            "ms": 1e3 * (time.perf_counter() - t0)}


def feature_corpus(job: Job = Job()):
    """Seeded (N, F, T) layer-mean features, binary labels and 4 attack
    classes of the corpus's clips; the dev set its first 12."""
    rng = np.random.default_rng(3)
    _, labels = corpus(job)
    feats = rng.normal(size=(N_CLIPS, stage1_config(
        job, True, "replicated").input_dim, 25)).astype(np.float32)
    multi = np.where(labels == 1, 0, 1 + np.arange(N_CLIPS) % 3)
    return feats, labels, multi


def features_leg(mesh, device, job: Job = Job()) -> Dict:
    """`fit_from_features` 2 epochs with a dev set, binary and
    multiclass, on a data mesh or alone. -> {mode: {'train_loss',
    'dev_loss'}} and 'state', both modes' heads (prefixed by mode)."""
    from ..train import Stage1Trainer

    enc_cfg = encoder_config(True, job.width)
    cfg = stage1_config(job, True, "replicated")
    feats, labels, multi = feature_corpus(job)
    comp = initial_weights(enc_cfg, cfg.hidden_dim)["compression"]
    out, state = {}, {}
    for mode in ("binary", "multiclass"):
        trainer = Stage1Trainer(cfg, enc_cfg, {"compression": comp},
                                device=device, loss_mode=mode,
                                from_features=True, mesh=mesh)
        hist = trainer.fit_from_features(
            feats, labels, feats[:12], labels[:12],
            multi_labels=multi if mode == "multiclass" else None,
            log_fn=lambda *a: None)
        out[mode] = {k: hist[k] for k in ("train_loss", "dev_loss")}
        state.update({f"{mode}.{k}": v
                      for k, v in model_state(trainer).items()})
    out["state"] = state
    return out


def build_parser() -> argparse.ArgumentParser:
    """The flags of one rank (`main`)."""
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True)
    p.add_argument("--legs", required=True,
                   help="comma-separated: " + ", ".join(
                       [*LEGS, "smoke", "baseline_smoke", *RESTORES,
                        "supcon", "extract", "features"]))
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    p.add_argument("--backend", default=None,
                   help="'gloo' for CUDA tensors of two ranks on one card")
    p.add_argument("--width", default="tiny",
                   choices=["tiny", "wide", "full"])
    p.add_argument("--weights", default=None,
                   help="a torch.save of the port's state dicts to start "
                        "the legs without dropout from")
    p.add_argument("--save", default="",
                   help="comma-separated legs of LEGS that end with a "
                        "collective checkpoint in <out>/ckpt/<leg>")
    p.add_argument("--grads", action="store_true",
                   help="rank 0 writes each LEGS leg's first-step "
                        "gradients to <out>/<leg>.grad.pt")
    p.add_argument("--go", default=None,
                   help="wait, after joining the group, until this file "
                        "exists (a caller's GPU work ends first)")
    return p


def main(argv=None) -> None:
    """One rank of a gang (torchrun's variables in the environment):
    join the group, run the legs in order, write `<out>/<leg>.p<rank>.json`
    and, from rank 0, `<out>/<leg>.pt` (the full model state)."""
    args = build_parser().parse_args(argv)

    from ..device import resolve_device
    from ..utils import distributed

    resolve_device(args.device)   # the card unless the caller asks the CPU
    distributed.maybe_initialize(force=True, device=args.device,
                                 backend=args.backend)
    device = distributed.gang_device(args.device)
    rank = distributed.rank()
    job = Job.named(args.width)
    weights = (torch.load(args.weights, weights_only=True)
               if args.weights else None)
    os.makedirs(args.out, exist_ok=True)
    ckpt_dir = os.path.join(args.out, "ckpt")
    # the draws-on legs' weights, made before waiting for the go
    enc_cfg = encoder_config(True, job.width)
    seeded = initial_weights(enc_cfg, stage1_config(job, True,
                                                    "replicated").hidden_dim)
    while args.go and not os.path.exists(args.go):
        time.sleep(0.05)
    for leg in args.legs.split(","):
        print(f"[mp_smoke] rank {rank} {leg}: start", flush=True)
        t0 = time.perf_counter()
        if leg == "smoke":
            res = run_smoke(make_mesh_for(1, device), device, ckpt_dir, job)
        elif leg in RESTORES:
            res = restore(leg, args.out, make_mesh_for(RESTORES[leg][2],
                                                       device), device, job)
        elif leg == "baseline_smoke":
            res = baseline_smoke(make_mesh_for(1, device), device, ckpt_dir,
                                 job)
        elif leg == "supcon":
            from .mesh import shard_of

            res = supcon_leg(shard_of(make_mesh_for(1, device)))
        elif leg == "extract":
            res = extract_leg(make_mesh_for(1, device), device, job, seeded)
        elif leg == "features":
            res = features_leg(make_mesh_for(1, device), device, job)
        else:
            res = run_leg(leg, make_mesh_for(LEGS[leg][1], device), device,
                          job, seeded if LEGS[leg][2] else weights,
                          save_dir=os.path.join(ckpt_dir, leg)
                          if leg in args.save.split(",") else None,
                          grads=args.grads)
        res["seconds"] = time.perf_counter() - t0
        state, grads = res.pop("state", None), res.pop("grads", None)
        if state is not None and rank == 0:
            torch.save(state, os.path.join(args.out, f"{leg}.pt"))
        if grads is not None and rank == 0:
            torch.save(grads, os.path.join(args.out, f"{leg}.grad.pt"))
        with open(os.path.join(args.out, f"{leg}.p{rank}.json"), "w") as f:
            json.dump(res, f)
        brief = {k: v for k, v in res.items() if k != "embeddings"}
        print(f"[mp_smoke] rank {rank}/{distributed.world_size()} {leg}: "
              f"{json.dumps(brief)}", flush=True)
    distributed.barrier()
    torch.distributed.destroy_process_group()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(cmd: List[str], n: int, timeout: float = 600, env=None,
          one_card: bool = False, threads: Optional[int] = None
          ) -> List[str]:
    """Run `cmd` as the N ranks of a gang with torchrun's variables (a
    free port on 127.0.0.1; `one_card`: every rank's LOCAL_RANK 0, for
    two ranks on one card), each capped at `threads` torch threads.
    -> each rank's output; raises with the log tails if a rank fails or
    the gang outlives `timeout`, after killing every rank (a rank still
    running at the timeout gets SIGABRT first, so its log ends with the
    faulthandler's traceback of every thread)."""
    port = free_port()
    base = dict(os.environ if env is None else env, MASTER_ADDR="127.0.0.1",
                MASTER_PORT=str(port), WORLD_SIZE=str(n),
                PYTHONFAULTHANDLER="1")
    if threads:
        base["OMP_NUM_THREADS"] = str(threads)
    # each rank writes to a file of its own: a pipe that no one reads
    # while another rank is waited for blocks its writer when it fills
    with tempfile.TemporaryDirectory(prefix="gang_logs_") as logdir:
        files = [open(os.path.join(logdir, f"rank{i}.log"), "w+")
                 for i in range(n)]
        procs = [subprocess.Popen(
            cmd, env=dict(base, RANK=str(i),
                          LOCAL_RANK="0" if one_card else str(i)),
            stdout=files[i], stderr=subprocess.STDOUT, text=True)
            for i in range(n)]
        deadline = time.monotonic() + timeout
        timed_out = False
        try:
            for proc in procs:
                proc.wait(timeout=max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            timed_out = True
            for proc in procs:
                if proc.poll() is None:
                    proc.send_signal(signal.SIGABRT)
            for proc in procs:
                try:
                    proc.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    pass
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        logs = []
        for f in files:
            f.seek(0)
            logs.append(f.read())
            f.close()
    if timed_out:
        raise RuntimeError(f"{n}-rank gang timed out after {timeout} s:\n"
                           + "\n".join(f"--- rank {i} ---\n{log[-6000:]}"
                                        for i, log in enumerate(logs)))
    bad = [i for i, proc in enumerate(procs) if proc.returncode != 0]
    if bad:
        raise RuntimeError("gang rank(s) %s failed:\n%s" % (bad, "\n".join(
            f"--- rank {i}: exit {procs[i].returncode} ---\n"
            f"{logs[i][-4000:]}" for i in bad)))
    return logs


def launch_gang(out: str, legs: List[str], n: int = 2, device: str = "cuda",
                backend: Optional[str] = None, width: str = "tiny",
                weights: Optional[str] = None, timeout: float = 600,
                save: List[str] = (), grads: bool = False,
                go: Optional[str] = None) -> Dict[str, List[Dict]]:
    """Run `legs` on an N-rank gang of `main` and return {leg: [each
    rank's result]}; rank 0's full model state of a leg is at
    <out>/<leg>.pt (with `grads`, its first-step gradients at
    <out>/<leg>.grad.pt). `go`: the ranks wait, once in the group, until
    that file exists. One launcher for the tests and chip_smoke.py. On
    the CPU each rank takes an equal share of the cores (of this pytest
    worker's share under pytest-xdist). The ranks run on the card unless
    `device` is 'cpu'."""
    from ..device import resolve_device

    device = resolve_device(device).type
    cmd = [sys.executable, "-m", "wav2vec_contr_loss_torch.parallel.mp_smoke",
           "--out", out, "--legs", ",".join(legs), "--device", device,
           "--width", width]
    if backend:
        cmd += ["--backend", backend]
    if weights:
        cmd += ["--weights", weights]
    if save:
        cmd += ["--save", ",".join(save)]
    if grads:
        cmd += ["--grads"]
    if go:
        cmd += ["--go", go]
    threads = None
    if device == "cpu":
        workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
        threads = max(1, (os.cpu_count() or 1) // workers // n)
    one_card = device != "cpu" and torch.cuda.device_count() < n
    spawn(cmd, n, timeout, one_card=one_card, threads=threads)
    results = {}
    for leg in legs:
        results[leg] = []
        for i in range(n):
            with open(os.path.join(out, f"{leg}.p{i}.json")) as f:
                results[leg].append(json.load(f))
    return results


if __name__ == "__main__":
    main()
