"""What both drivers share: the program's view of a configuration file,
its launch counters, set-up marks, and a traced stretch."""

from __future__ import annotations

import os
import tempfile
import time
from typing import Dict

import torch

from .. import trace as tr

# configuration-file keys -> the program's Wav2Vec2Config fields
_RENAMED = {"num_hidden_layers": "num_layers",
            "num_attention_heads": "num_heads"}
_FIELDS = ("hidden_size", "num_hidden_layers", "num_attention_heads",
           "intermediate_size", "conv_dim", "conv_kernel", "conv_stride",
           "conv_bias", "feat_extract_norm", "do_stable_layer_norm",
           "num_conv_pos_embeddings", "num_conv_pos_embedding_groups",
           "layer_norm_eps", "hidden_dropout", "attention_dropout",
           "activation_dropout", "feat_proj_dropout", "apply_spec_augment",
           "mask_time_prob", "mask_time_length", "mask_time_min_masks")


def port_config(cfg: Dict):
    """The program's encoder config of a configuration file."""
    from wav2vec_contr_loss_torch.config import Wav2Vec2Config

    kw = {_RENAMED.get(k, k): (tuple(cfg[k]) if isinstance(cfg[k], list)
                               else cfg[k]) for k in _FIELDS}
    return Wav2Vec2Config(dtype=cfg["compute_dtype"], **kw)


def counters() -> Dict[str, int]:
    """The program's kernel launch counters."""
    from wav2vec_contr_loss_torch.ops import attention, conv_ln, supcon

    return {"attention_fwd": attention.launches,
            "attention_bwd": attention.bwd_launches,
            "ln_gelu_fwd": conv_ln.launches,
            "ln_gelu_bwd": conv_ln.bwd_launches,
            "supcon": supcon.launches}


def delta(after: Dict[str, int], before: Dict[str, int]) -> Dict[str, int]:
    return {k: after[k] - before[k] for k in after}


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Marks:
    """Seconds since the process started at each step of set-up, printed
    on one line: where set-up's time goes, run by run."""

    def __init__(self, t_start: float):
        self.t_start, self.marks = t_start, []

    def __call__(self, what: str) -> None:
        self.marks.append((what, time.perf_counter() - self.t_start))

    def print(self) -> None:
        print("[setup] " + ", ".join(f"{w} {s:.2f}" for w, s in self.marks)
              + " s", flush=True)


class HostPace:
    """What the host gave the dispatching thread over a window: its CPU
    seconds and its involuntary context switches (the scheduler took the
    core away), printed with the window's steps a second in sixths."""

    def __init__(self):
        self.cpu0, self.ru0 = time.thread_time(), self._rusage()

    @staticmethod
    def _rusage():
        import resource

        return resource.getrusage(getattr(resource, "RUSAGE_THREAD",
                                          resource.RUSAGE_SELF))

    def print(self, seconds: float, steps: int, stamps) -> None:
        ru = self._rusage()
        cpu = time.thread_time() - self.cpu0
        sixths = [sum(1 for s in stamps if k * seconds / 6 <= s
                      < (k + 1) * seconds / 6) / (seconds / 6)
                  for k in range(6)]
        print(f"[host] dispatching thread: {cpu:.3f} CPU s of {seconds:.3f} "
              f"s ({1e3 * cpu / max(steps, 1):.2f} CPU ms a step), "
              f"{ru.ru_nivcsw - self.ru0.ru_nivcsw} involuntary and "
              f"{ru.ru_nvcsw - self.ru0.ru_nvcsw} voluntary switches; "
              f"steps a second by sixths "
              f"{[round(x, 3) for x in sixths]}", flush=True)


class Traced:
    """A profiled stretch, read back as a `trace.Trace`. With `cpu`, the
    host's operators on every thread where the profiler can, so that
    kernels can be attributed to the ranges that launched them; without,
    the device's activity alone, which costs the host little, so that
    the stretch's own idle share stands for the untraced run's."""

    def __init__(self, device, cpu: bool = True):
        from torch.profiler import ProfilerActivity, profile

        self.device = device
        acts = [ProfilerActivity.CPU] if cpu else []
        if torch.device(device).type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        elif not cpu:
            acts.append(ProfilerActivity.CPU)   # the CPU tests' stand-in
        kw = {}
        if cpu:
            try:
                from torch._C._profiler import _ExperimentalConfig

                kw["experimental_config"] = _ExperimentalConfig(
                    profile_all_threads=True)
            except (ImportError, TypeError):
                print("[trace] this torch profiles the starting thread and "
                      "the autograd threads only", flush=True)
        self.prof = profile(activities=acts, **kw)

    def __enter__(self):
        sync(self.device)
        self.prof.start()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        sync(self.device)
        self.window_s = time.perf_counter() - self.t0
        self.prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json", prefix="h100bench-trace-")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            self.trace = tr.load(path)
        finally:
            os.remove(path)
        return False
