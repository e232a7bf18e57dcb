"""Stage-1 SupCon finetuning, closed loop: `Stage1Trainer.train_step`
back to back on balanced batches from a seeded host pool, fed through
the trainer's own prefetch to the device, with no host read a step.

Set-up builds one trainer from the seed's weights and runs its first
`check_steps` steps on batches whose rows all differ; the same trainer
then runs the window. After the window the plain reference follows those
first steps from the same weights, batches and seed, and the run is
correct when each step's loss, each leaf's first gradient (read from the
optimizer's first moment after step 1, the reference's rounded to that
moment's dtype alike: its norm and its direction) and
each leaf's change after the first steps agree with it within the cell's
limits.

After the window, in every run, a few steps traced with the device's
activity alone give the step's device time (`step_device_ms`), which the
host's pace does not move.
"""

from __future__ import annotations

import gc
import itertools
import time
from typing import Dict

import numpy as np
import torch

from .. import roofline, trace as tr, traffic as gen, weights
from ..reference import train as ref_train
from . import common

# the recipe fields the reference takes, checked against the program's
# preset before a run
_RECIPE = ("head_lr", "enc_lr", "weight_decay", "grad_clip", "temperature",
           "topk_neg", "dropout", "use_rawboost", "rawboost_prob",
           "rawboost_mode", "rawboost_fir_impl", "rawboost_isd_mode",
           "finetune_encoder", "freeze_feature_extractor", "uniformity_weight",
           "supcon_similarity", "adam_mu_dtype", "adam_nu_dtype")


def _stage1_config(cell, seed: int):
    from wav2vec_contr_loss_torch.config import preset
    from wav2vec_contr_loss_torch.train.schedule import alpha_for_epoch

    t = cell.traffic
    s1 = preset(t["preset"]).replace(
        seed=seed, batch_size=t["batch_size"],
        max_duration_seconds=t["clip_seconds"],
        compute_dtype=cell.config["compute_dtype"],
        input_dim=cell.config["hidden_size"])
    recipe = dict(t["recipe"])
    bad = {k: (getattr(s1, k), recipe[k]) for k in _RECIPE
           if getattr(s1, k) != recipe[k]}
    if bad:
        raise ValueError(f"preset {t['preset']!r} differs from the traffic "
                         f"file's recipe (program, file): {bad}")
    recipe["alpha"] = alpha_for_epoch(1, s1.warmup_epochs,
                                      s1.alpha_ramp_epochs, s1.alpha_end)
    return s1, recipe


def gaps(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The compared numbers: the largest loss gap over the steps; the
    worst leaf's gap between the program's and the reference's norms of
    the first gradient and of the change, each over the larger of the
    reference leaf's norm and the median leaf's; and the worst leaf's
    1 - cosine between the two first gradients, which sees the direction
    that a gap of norms misses.
    Leaves whose reference gradient is under a thousandth of the median
    leaf's (nought to rounding, as a key bias under softmax) are left out
    of the change and of the cosine."""
    loss = max(abs(a - b) for a, b in zip(prog["loss"], ref["loss"]))
    names = list(ref["grad"])
    g_ref = np.array([ref["grad"][n] for n in names])
    u_ref = np.array([ref["update"][n] for n in names])
    g_med, u_med = np.median(g_ref), np.median(u_ref)
    g = np.array([prog["grad"][n] for n in names])
    u = np.array([prog["update"][n] for n in names])
    g_gap = np.abs(g - g_ref) / np.maximum(g_ref, g_med)
    moved = g_ref >= 1e-3 * g_med
    u_gap = np.where(moved, np.abs(u - u_ref) / np.maximum(u_ref, u_med), 0.0)
    cos = np.zeros(len(names))
    for i, n in enumerate(names):
        if moved[i]:
            r = ref["first"][n].double().flatten()
            p = prog["first"][n].to(r.device).double().flatten()
            cos[i] = 1.0 - float(p @ r / (p.norm() * r.norm()).clamp_min(
                1e-300))
    gi, ui, ci = (int(np.argmax(a)) for a in (g_gap, u_gap, cos))
    return {"loss_gap": float(loss), "grad_gap": float(g_gap[gi]),
            "grad_cos_gap": float(cos[ci]), "update_gap": float(u_gap[ui]),
            "_worst": {"grad": names[gi], "update": names[ui],
                       "cos": names[ci],
                       "left_out": [n for n, m in zip(names, moved) if not m]}}


def _short(worst: Dict) -> Dict:
    out = dict(worst)
    left = out.pop("left_out")
    out["left_out"] = f"{len(left)} leaves, {left[:2]}..."
    return out


def first_batches(labels, batch: int, seed: int, k: int):
    """Row indices of the first k balanced batches of a run (the
    program's sampler, epoch 1)."""
    from wav2vec_contr_loss_torch.data.sampler import BalancedBatchSampler

    return list(itertools.islice(
        BalancedBatchSampler(labels, batch, seed=seed).epoch_batches(1), k))


def run(cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, fault=None) -> Dict:
    from wav2vec_contr_loss_torch.data.pipeline import Batch
    from wav2vec_contr_loss_torch.data.sampler import BalancedBatchSampler
    from wav2vec_contr_loss_torch.train.stage1 import Stage1Trainer

    mark = common.Marks(t_start)
    mark("imports")
    cfg, t = cell.config, cell.traffic
    b, samples = t["batch_size"], t["clip_seconds"] * gen.SAMPLE_RATE
    s1, recipe = _stage1_config(cell, seed)
    flat = weights.make(cfg, seed, device)
    common.sync(device)
    mark("weights")
    trainer = Stage1Trainer(s1, common.port_config(cfg), weights.split(flat),
                            device=device)
    if fault is not None:
        fault(trainer)
    common.sync(device)
    mark("trainer")
    pool, labels = gen.train_pool(t, seed, samples)
    mark("pool")
    sampler = BalancedBatchSampler(labels, b, seed=seed)

    def host_batches():
        for epoch in itertools.count(1):
            for idx in sampler.epoch_batches(epoch):
                yield Batch(waveforms=pool[idx], labels=labels[idx],
                            multi_labels=labels[idx],
                            valid=np.ones(b, bool))

    feed = trainer._device_batches(host_batches())
    alpha = recipe["alpha"]

    # the first steps: warm-up, and what the reference follows
    opt = trainer.optimizer
    named = {id(p): "compression." + n
             for n, p in trainer.compression.named_parameters()}
    named.update({id(p): n for n, p in trainer.encoder.named_parameters()})
    params = [(named[id(p)], p, grp) for grp in opt.groups.values()
              for p in grp.params]
    losses, first = [], {}
    pin = torch.device(device).type == "cuda"
    for i in range(t["check_steps"]):
        losses.append(trainer.train_step(next(feed), alpha)["loss"])
        if i == 0:
            # the first moment after step 1 is (1 - b1) times the first
            # gradient as the optimizer took it; a host copy, queued
            # before step 2 overwrites it
            for (n, _, grp), m in zip(
                    params, [m for g in opt.groups.values() for m in g.mu]):
                host = torch.empty(m.shape, dtype=m.dtype, pin_memory=pin)
                first[n] = (host.copy_(m, non_blocking=pin), 1 - grp.b1)
        common.sync(device)
        mark(f"step {i + 1}")
    update = {n: torch.linalg.vector_norm(p.detach() - flat[n])
              for n, p, _ in params}
    del flat
    common.sync(device)
    setup_s = time.perf_counter() - t_start
    mark("set-up")
    mark.print()
    c0 = common.counters()

    window_losses = []
    untraced = seconds - (t["trace_reserve_s"] if trace else 0.0)
    n = 0
    stamps = []
    host0 = common.HostPace()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < untraced:
        window_losses.append(trainer.train_step(next(feed), alpha)["loss"])
        n += 1
        stamps.append(time.perf_counter() - t0)
    common.sync(device)
    stretch_s = time.perf_counter() - t0
    host0.print(stretch_s, n, stamps)
    c1 = common.counters()
    traced = None
    # after the window, in every run: the device's activity alone (the
    # step's device time; in a traced run also the idle share and busy
    # seconds), then, traced, the host's operators with it (attribution,
    # breakdown)
    with common.Traced(device, cpu=False) as dev_traced:
        for _ in range(t["trace_device_steps"]):
            window_losses.append(
                trainer.train_step(next(feed), alpha)["loss"])
    # None where no device operation ran (the CPU tests)
    step_device_ms = (1e3 * tr.busy_seconds(dev_traced.trace)
                      / t["trace_device_steps"]) or None
    print(f"[train] the step's device time {step_device_ms} ms over "
          f"{t['trace_device_steps']} steps traced after the window",
          flush=True)
    if trace:
        c2 = common.counters()
        with common.Traced(device) as traced:
            for _ in range(t["trace_steps"]):
                window_losses.append(
                    trainer.train_step(next(feed), alpha)["loss"])
        traced.counters = common.delta(common.counters(), c2)
        traced.units = t["trace_steps"]
        step_s = stretch_s / max(n, 1)
        print(f"[trace] the profiler's overhead: a step took {step_s:.4f} s "
              f"untraced, {dev_traced.window_s / t['trace_device_steps']:.4f} "
              f"s with the device's activity traced, "
              f"{traced.window_s / traced.units:.4f} s with the host's "
              f"operators too", flush=True)
    peak = (torch.cuda.max_memory_allocated()
            if torch.device(device).type == "cuda" else 0)
    failed = int((~torch.isfinite(torch.stack(window_losses))).sum())
    first = {n: m.float() / scale for n, (m, scale) in first.items()}
    prog = {"loss": [float(x) for x in losses], "first": first,
            "grad": {n: float(torch.linalg.vector_norm(g))
                     for n, g in first.items()},
            "update": {k: float(v) for k, v in update.items()}}
    per_step = {k: v / max(n, 1) for k, v in common.delta(c1, c0).items()}
    print(f"[train] {n} steps of {b} clips in {stretch_s:.4f} s untraced; "
          f"launches a step {per_step}", flush=True)
    feed.close()
    del trainer, feed, params, opt, named
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    # the reference, from the same seed, weights and first batches
    t_ref = time.perf_counter()
    ref_params = {k: v for k, v in weights.make(cfg, seed, device).items()
                  if not k.startswith("head.")}
    first = first_batches(labels, b, seed, t["check_steps"])
    batches = [(torch.from_numpy(pool[idx]).to(device),
                torch.from_numpy(labels[idx]).to(device)) for idx in first]
    ref = ref_train.run_steps(ref_params, cfg, recipe, seed, batches,
                              t["check_steps"])
    checks = gaps(prog, ref)
    print(f"[train] reference {time.perf_counter() - t_ref:.2f} s; losses "
          f"program {prog['loss']} reference {ref['loss']}; worst leaves "
          f"{_short(checks.pop('_worst'))}", flush=True)

    flops = roofline.train_step_flops(cfg, samples, b)
    return {
        "setup_s": setup_s, "attempted": len(window_losses), "failed": failed,
        "e2e": {"train_clips_per_s": n * b / stretch_s,
                "step_device_ms": step_device_ms},
        "checks": checks, "memory_peak_bytes": peak, "traced": traced,
        "dev_traced": dev_traced,
        "ctx": {"kind": "train", "batch": b, "samples": samples,
                "dtype": cfg["compute_dtype"],
                "stretch_s": stretch_s, "steps": n,
                "step_flops": flops, "step_device_ms": step_device_ms,
                "heads": cfg["num_attention_heads"],
                "head_dim": cfg["hidden_size"] // cfg["num_attention_heads"],
                "frames": roofline.conv_lengths(cfg, samples)[-1],
                "ln_rows": roofline.ln_gelu_rows(cfg, samples, b),
                "channels": cfg["conv_dim"][0]}}
