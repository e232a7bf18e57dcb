"""What stage 1 (`Stage1Trainer`) and the baseline (`BaselineTrainer`)
share: the host feed (`wire_batch`, `pinned`, `to_device`), the in-step
`device_rawboost`, building and moving state (`check_config`,
`load_fp32`, and `module_states`, `optimizer_state`, `load_states`,
`norm_group_fn`, which gather a gang's shards to full tensors and back),
and `fit_epochs`, the one epoch loop, which owns the checkpoint and
preemption policy. A trainer gives the loop its batches, its step and an
`end_epoch` that evaluates the dev set, logs and returns an `EpochEnd`.
"""

from __future__ import annotations

import dataclasses
import time
from typing import (Callable, Dict, Iterable, Mapping, NamedTuple, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

from ..config import Wav2Vec2Config
from ..data.pipeline import Batch
from ..ops.rawboost import RawBoostDraws, rawboost_batch, rawboost_draws
from ..ops.wire import dequantize_wire, quantize_wire
from ..parallel.collectives import SINGLE, Shard
from ..parallel.mesh import PARAM_SHARDINGS, check_layout, local_batch
from . import checkpoint as ckpt
from .optim import resolve_grad_bf16

__all__ = ["EpochEnd", "check_config", "device_rawboost", "fit_epochs",
           "load_fp32", "load_states", "module_states", "norm_group_fn",
           "optimizer_state", "pinned", "to_device", "wire_batch"]


def check_config(cfg, enc_config: Wav2Vec2Config) -> None:
    """Refuse the settings the port does not compute (a Stage1Config or
    a BaselineConfig, and the encoder's config)."""
    if enc_config.quant != "none":
        raise ValueError(f"quant={enc_config.quant!r} is serving only "
                         f"(int8 rounding has no gradient); the trainers "
                         f"take quant='none'")
    if resolve_grad_bf16(cfg) and cfg.compute_dtype != "bfloat16":
        raise ValueError(
            "grad_dtype='bfloat16' requires compute_dtype='bfloat16' "
            "(with fp32 compute, bf16 weight gradients would change "
            "what the step computes)")
    if cfg.rawboost_mode not in ("device", "host", "off"):
        raise ValueError(f"rawboost_mode must be 'device', 'host' or "
                         f"'off'; got {cfg.rawboost_mode!r}")
    if cfg.wire_dtype not in ("float32", "int16"):
        raise ValueError(f"wire_dtype must be 'float32' or 'int16'; got "
                         f"{cfg.wire_dtype!r}")
    if cfg.param_sharding not in PARAM_SHARDINGS:
        raise ValueError(f"param_sharding must be one of {PARAM_SHARDINGS}; "
                         f"got {cfg.param_sharding!r}")
    check_layout(pipeline=cfg.param_sharding == "pp",
                 sequence_parallel=getattr(cfg, "sequence_parallel", False),
                 microbatches=getattr(cfg, "pipeline_microbatches", 1),
                 batch=cfg.batch_size)


# ------------------------------------------------------------------ feed
def to_device(batch: Mapping, device: torch.device,
              keys=("waveforms", "labels", "multi_labels", "features")
              ) -> Dict[str, torch.Tensor]:
    """Host or device arrays -> tensors on `device` (a non-blocking copy
    from pinned host memory); int16 wire waveforms are dequantized there
    (dewire)."""
    out = {}
    for key in keys:
        if key in batch:
            x = batch[key]
            x = torch.from_numpy(np.asarray(x)) if not isinstance(
                x, torch.Tensor) else x
            out[key] = x.to(device, non_blocking=True)
    if "waveforms" in out:
        out["waveforms"] = dequantize_wire(out["waveforms"])
    return out


def pinned(arrays: Mapping[str, np.ndarray], device: torch.device
           ) -> Dict[str, torch.Tensor]:
    """Host arrays as tensors, pinned when `device` is the card (so the
    step's copy is non-blocking)."""
    out = {k: torch.from_numpy(np.ascontiguousarray(v))
           for k, v in arrays.items()}
    if device.type == "cuda":
        return {k: v.pin_memory() for k, v in out.items()}
    return out


def wire_batch(b: Batch, cfg, device: torch.device,
               shard: Optional[Shard] = None,
               keys: Sequence[str] = ()) -> Dict[str, torch.Tensor]:
    """A host batch as pinned tensors (run in the prefetch thread): the
    waveforms in cfg.wire_dtype (quantized to int16 when it says so), the
    labels as int64, and of `keys` 'multi_labels' as int64 and 'valid'
    as uint8. With `shard`, this data rank's rows of the global batch."""
    arrays = {"waveforms": quantize_wire(b.waveforms)
              if cfg.wire_dtype == "int16" else b.waveforms,
              "labels": b.labels.astype(np.int64)}
    for key in keys:
        arrays[key] = getattr(b, key).astype(
            np.uint8 if key == "valid" else np.int64)
    if shard is not None:
        arrays = local_batch(arrays, shard)
    return pinned(arrays, device)


def device_rawboost(waves: torch.Tensor, gen: torch.Generator,
                    device_gen: torch.Generator, prob: float,
                    params, shard: Shard = SINGLE) -> torch.Tensor:
    """In-step device RawBoost: a seed from the trainer's CPU generator
    seeds the device generator, which draws the numbers of the global
    batch; a gang's rank keeps its rows of every draw."""
    seed = int(torch.randint(0, 2 ** 62, (), generator=gen))
    device_gen.manual_seed(seed)
    b, t = waves.shape
    draws = rawboost_draws(device_gen, b * shard.n_data, t, params)
    if shard.n_data > 1:
        rows = slice(shard.batch_offset(b), shard.batch_offset(b) + b)
        draws = RawBoostDraws(**{f.name: getattr(draws, f.name)[rows]
                                 for f in dataclasses.fields(draws)})
    return rawboost_batch(waves, draws, prob, params)


# ----------------------------------------------------------------- state
def load_fp32(mod: torch.nn.Module, sd: Mapping[str, torch.Tensor],
              device: torch.device) -> torch.nn.Module:
    """Copies of `sd` in fp32 on `device` as the parameters of `mod`,
    which was built on the meta device."""
    mod.load_state_dict({k: v.to(device, torch.float32, copy=True)
                         for k, v in sd.items()}, strict=True, assign=True)
    return mod


def _named(modules: Mapping[str, Optional[torch.nn.Module]]):
    """{id(parameter): (module key, parameter name)} over `modules`."""
    return {id(p): (key, n) for key, m in modules.items() if m is not None
            for n, p in m.named_parameters()}


def norm_group_fn(layout, modules):
    """The optimizer's `norm_group` of a gang's layout (None in one
    process)."""
    if layout is None:
        return None
    names = _named(modules)
    return lambda p: layout.norm_group(names[id(p)][1], p)


def module_states(layout, modules) -> Dict:
    """{key: state dict} of the modules; a gang's gathered to full."""
    return {key: (m.state_dict() if layout is None
                  else layout.full_state_dict(m))
            for key, m in modules.items() if m is not None}


def optimizer_state(layout, optimizer, modules) -> Dict:
    """The optimizer's state; a gang's moments gathered to full."""
    state = optimizer.state_dict()
    if layout is None:
        return state
    names = _named(modules)
    for gname, grp in optimizer.groups.items():
        for key in ("mu", "nu"):
            state[gname][key] = [
                layout.full(names[id(p)][1], m, p)
                for p, m in zip(grp.params, state[gname][key])]
    return state


def load_states(layout, optimizer, modules, state: Mapping) -> None:
    """Load a full state into the modules and the optimizer (in a gang,
    each rank its shards); the optimizer checks first."""
    opt = state["optimizer"]
    if layout is not None:
        names = _named(modules)
        opt = {g: dict(s) for g, s in opt.items()}
        for gname, grp in optimizer.groups.items():
            if gname not in opt:
                continue
            for key in ("mu", "nu"):
                if len(opt[gname][key]) != len(grp.params):
                    continue   # load_state_dict names the mismatch
                opt[gname][key] = [
                    layout.local(names[id(p)][1], m.to(p.device), p)
                    for p, m in zip(grp.params, opt[gname][key])]
    optimizer.load_state_dict(opt)
    for key, m in modules.items():
        if m is None:
            continue
        if layout is None:
            m.load_state_dict(state[key], strict=True)
        else:
            layout.load_full_state_dict(m, state[key])


# ------------------------------------------------------------ epoch loop
class EpochEnd(NamedTuple):
    """A trainer's account of one finished epoch, for `fit_epochs`."""

    score: float                 # the dev score to minimise; NaN if none
    row: Dict[str, float]        # the epoch's history entries
    metrics: Dict[str, float]    # its sidecar metrics after 'epoch'
    best_line: Optional[str] = None   # logged after a new best is saved


def fit_epochs(trainer, fields: Sequence[str],
               batches: Callable[[int, int], Iterable],
               step: Callable[[object, int], torch.Tensor],
               end_epoch: Callable[[int, float, int, float], EpochEnd], *,
               save_dir: Optional[str], log_fn,
               names: Tuple[str, str] = ("latest", "best"),
               has_dev: bool = True,
               cursor: Callable[[str, float, int], Dict] = (
                   lambda name, best, stale: {}),
               start_epoch: int = 1, skip_steps: int = 0,
               best: float = float("inf"), stale: int = 0,
               patience: Optional[int] = None,
               show_best: Callable[[float], str] = str,
               preemption=None) -> Dict:
    """Epochs `start_epoch`..cfg.epochs of `trainer` (anything with
    `cfg.epochs`, `cfg.ckpt_config()`, `state_dict()` and
    `_sidecar_extra()`). -> history {field: one entry an epoch}, plus
    'preempted': True after a stop.

    `batches(epoch, skip)` yields the epoch's batches past `skip`
    (`skip_steps` in the first epoch); `step(batch, epoch)` runs one and
    returns its loss on the device, read once an epoch;
    `end_epoch(epoch, train_loss, steps run, seconds of the steps)`
    returns the epoch's `EpochEnd`. `preemption.requested(cursor)` is
    polled after every step; on a request `names[0]` is saved, blocking,
    with the batch cursor and `cursor(name, best, stale)`, and the loop
    returns. An epoch's end saves `names[0]`, then `names[1]` on a new
    best (`score < best`: NaN never is) from one host snapshot, so 'best'
    is never newer than the 'latest' a resume reads; without a dev set
    `names[1]` aliases `names[0]`. `best` and `stale` (epochs since it)
    carry across resumes; with `patience` the run stops once `stale`
    reaches it, at once if it already has. In a gang every rank runs the
    loop in lockstep: the scores are the same bits on every rank, the
    preemption flag is agreed, and every save is collective."""
    cfg = trainer.cfg
    latest, best_name = names
    history = {k: [] for k in fields}
    if patience is not None and stale >= patience:
        log_fn(f"[EARLY STOP] patience {patience} already reached at "
               f"resume ({show_best(best)})")
        return history
    for epoch in range(start_epoch, cfg.epochs + 1):
        t_epoch = time.perf_counter()
        losses = []
        skip = skip_steps if epoch == start_epoch else 0
        n_steps = skip   # absolute batch cursor within the epoch
        preempted = False
        for batch in batches(epoch, skip):
            losses.append(step(batch, epoch))
            n_steps += 1
            if preemption is not None and preemption.requested(n_steps):
                preempted = True
                break
        if preempted:
            if save_dir is not None:
                ckpt.save_checkpoint(
                    save_dir, latest, trainer.state_dict(),
                    cfg.ckpt_config(),
                    {"epoch": epoch, "batches_done": n_steps,
                     "preempted": True, **cursor(latest, best, stale)},
                    trainer._sidecar_extra())
            log_fn(f"[PREEMPTED] "
                   f"{'saved mid-epoch state at' if save_dir else 'stopping (no save_dir) at'} "
                   f"epoch {epoch} batch {n_steps}"
                   + ("; resume with --resume" if save_dir else ""))
            history["preempted"] = True
            return history
        train_loss = (float(np.mean(torch.stack(losses).tolist()))
                      if losses else 0.0)
        end = end_epoch(epoch, train_loss, n_steps - skip,
                        time.perf_counter() - t_epoch)
        for k in fields:
            history[k].append(end.row[k])
        is_new_best = end.score < best   # NaN is never best
        if is_new_best:
            best, stale = end.score, 0
        else:
            stale += 1
        if save_dir is not None:
            extra = trainer._sidecar_extra()
            # one host copy serves both names; the writer thread hides the
            # file writes behind the next epoch
            host = ckpt.snapshot_for_save(trainer.state_dict())

            def save(name):
                ckpt.save_checkpoint(
                    save_dir, name, None, cfg.ckpt_config(),
                    {"epoch": epoch, **end.metrics,
                     **cursor(name, best, stale)},
                    extra, block=False, host_state=host)
            save(latest)
            if not has_dev:
                ckpt.alias_checkpoint(save_dir, best_name, latest)
            elif is_new_best:
                save(best_name)
                if end.best_line is not None:
                    log_fn(end.best_line)
        if patience is not None and stale >= patience:
            log_fn(f"[EARLY STOP] patience {patience} reached "
                   f"({show_best(best)})")
            break
    if save_dir is not None:
        ckpt.wait_for_saves()
    return history
