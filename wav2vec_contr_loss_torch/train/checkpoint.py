"""Checkpoints of the full train state, config embedded as JSON.

The port's own format, with the layout and contract of
wav2vec_contr_loss_tpu/train/checkpoint.py:

  <dir>/<name>.pt           torch.save of the state (nested dicts of CPU
                            tensors and numbers; read with weights_only)
  <dir>/<name>.config.json  {"config", "metrics", "extra"}, the JAX schema

The trainer's state holds the encoder and compression state dicts, the
optimizer state (the stored AdamW moments and step counts), the step and
the trainer's CPU generator state, so a resumed run continues exactly.

Crash safety: a save writes `<name>.saving.pt`, then its sidecar
`<name>.saving.config.json`, then moves both over the old pair with
`os.replace` (atomic per file). A crash before the sidecar is written
leaves the old checkpoint whole and the temporary state is dropped by the
next save; a crash after it leaves a complete new pair (or a new state
and its staged sidecar), which the next save adopts (`_recover`) and a
reader pairs correctly without renaming anything (`_resolve`).

`block=False` copies the state to host memory in the caller's thread (the
optimizer updates parameters in place, so the copy must be taken before
the next step) and hands the file writes to one ordered writer thread:
saves and aliases commit in call order, readers in this process drain
the queue first, and a failed background write re-raises on the next
checkpoint call or `wait_for_saves()`.

In a gang of several processes (utils/distributed.py) a save is
collective, as in the JAX module (`_host_tree`, `_is_primary`,
`_barrier`): every rank calls it with the same full, layout-free state
(the trainers gather their shards into HF-named tensors first), rank 0
alone writes the files, and every rank waits for the write before going
on, so a save under several processes always blocks. Every rank
restores, each re-sharding into its own layout; a gang's checkpoint
loads in one process and the reverse.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..utils import distributed

__all__ = ["save_checkpoint", "restore_checkpoint", "restore_parts",
           "load_sidecar",
           "checkpoint_exists", "alias_checkpoint", "wait_for_saves",
           "resume_cursor", "snapshot_for_save", "checkpoint_bytes"]

_STATE, _SIDECAR, _TMP = ".pt", ".config.json", ".saving"


def resume_cursor(metrics: Dict) -> Tuple[int, int]:
    """-> (start_epoch, skip_steps) from a 'latest' sidecar's metrics. An
    epoch-end save resumes at the next epoch; a preemption save carries a
    `batches_done` cursor and resumes the same epoch past it."""
    if metrics.get("preempted"):
        return int(metrics["epoch"]), int(metrics["batches_done"])
    return int(metrics["epoch"]) + 1, 0


# One ordered writer thread for `block=False` saves, made at the first
# one; its futures stay in _PENDING until read.
_WRITER: Optional[ThreadPoolExecutor] = None
_PENDING: List[Future] = []


def _writer() -> ThreadPoolExecutor:
    global _WRITER
    if _WRITER is None:
        _WRITER = ThreadPoolExecutor(max_workers=1,
                                     thread_name_prefix="ckpt-writer")
    return _WRITER


def _raise_failed_saves() -> None:
    """Re-raise the first failure of a finished async save (later ones go
    to stderr) and drop finished futures."""
    global _PENDING
    done = [f for f in _PENDING if f.done()]
    _PENDING = [f for f in _PENDING if f not in done]
    errs = [e for e in (f.exception() for f in done) if e is not None]
    for extra in errs[1:]:
        print(f"[checkpoint] additional async save failure: {extra!r}",
              file=sys.stderr)
    if errs:
        raise errs[0]


def wait_for_saves() -> None:
    """Block until every async save and alias has committed; re-raise the
    first failure after joining them all."""
    global _PENDING
    pending, _PENDING = _PENDING, []
    errs = [e for e in (f.exception() for f in pending) if e is not None]
    if errs:
        raise errs[0]


def _base(directory: str, name: str) -> str:
    return os.path.abspath(os.path.join(directory, name))


def _remove(path: str) -> None:
    if os.path.islink(path) or os.path.isfile(path):
        os.remove(path)
    elif os.path.isdir(path):
        shutil.rmtree(path)


def _recover(base: str) -> None:
    """Writer side: adopt what a crashed commit left. A staged sidecar
    marks its state complete: with the staged state still there, both
    move in; with the state already moved, the sidecar follows it."""
    tmp_state, tmp_side = base + _TMP + _STATE, base + _TMP + _SIDECAR
    if not os.path.exists(tmp_side):
        return
    if os.path.exists(tmp_state):
        os.replace(tmp_state, base + _STATE)
        os.replace(tmp_side, base + _SIDECAR)
    elif os.path.exists(base + _STATE):
        os.replace(tmp_side, base + _SIDECAR)


def _resolve(base: str) -> Optional[Tuple[str, str]]:
    """Reader side, never renames: (state file, its sidecar) of the newest
    complete copy, or None."""
    state, side = base + _STATE, base + _SIDECAR
    tmp_state, tmp_side = base + _TMP + _STATE, base + _TMP + _SIDECAR
    if os.path.exists(state):
        if os.path.exists(tmp_side) and not os.path.exists(tmp_state):
            return state, tmp_side   # between the two replaces of a commit
        return state, side
    if os.path.exists(tmp_state) and os.path.exists(tmp_side):
        return tmp_state, tmp_side
    return None


def _commit_save(base: str, host_state: Any, sidecar: Dict) -> None:
    os.makedirs(os.path.dirname(base), exist_ok=True)
    _recover(base)
    tmp_state, tmp_side = base + _TMP + _STATE, base + _TMP + _SIDECAR
    for stale in (tmp_state, tmp_side):
        _remove(stale)
    torch.save(host_state, tmp_state)
    with open(tmp_side, "w") as f:
        json.dump(sidecar, f, indent=2, default=str)
    # os.replace swaps the directory entry: an alias (symlink) at the
    # destination is replaced, its target left as it was
    os.replace(tmp_state, base + _STATE)
    os.replace(tmp_side, base + _SIDECAR)


def _gang() -> bool:
    return distributed.world_size() > 1


def _host(tree: Any, copy: bool) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=copy)
    if isinstance(tree, dict):
        return {k: _host(v, copy) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host(v, copy) for v in tree)
    return tree


def snapshot_for_save(state: Any) -> Any:
    """A host copy of `state` that later in-place updates cannot touch,
    shareable by several saves of the same state ('latest' and 'best').
    In a gang only rank 0 writes, so the others keep no copy (None)."""
    if _gang() and not distributed.is_primary():
        return None
    return _host(state, copy=True)


def save_checkpoint(directory: str, name: str, state: Any,
                    config: Optional[Dict] = None,
                    metrics: Optional[Dict] = None,
                    extra: Optional[Dict] = None, *,
                    block: bool = True,
                    host_state: Optional[Any] = None) -> str:
    """Write <directory>/<name>.pt and its sidecar, crash-safe (module
    docstring). `block=False` returns once the state is copied to host
    memory; `host_state` (from snapshot_for_save) skips that copy. In a
    gang the save is collective and blocks (module docstring).
    -> the checkpoint's base path (without suffix)."""
    _raise_failed_saves()
    base = _base(directory, name)
    sidecar = {"config": config or {}, "metrics": metrics or {},
               "extra": extra or {}}
    if _gang():
        if distributed.is_primary():
            wait_for_saves()
            _commit_save(base, host_state if host_state is not None
                         else _host(state, copy=False), sidecar)
        distributed.barrier()
    elif block:
        wait_for_saves()   # total order with in-flight async writes
        _commit_save(base, host_state if host_state is not None
                     else _host(state, copy=False), sidecar)
    else:
        snap = host_state if host_state is not None else snapshot_for_save(
            state)
        _PENDING.append(_writer().submit(_commit_save, base, snap, sidecar))
    return base


def _commit_alias(base: str, target: str) -> None:
    directory = os.path.dirname(base)
    for suffix in (_STATE, _SIDECAR):
        dst = base + suffix
        _remove(dst)
        try:
            os.symlink(target + suffix, dst)   # relative, inside directory
        except OSError:
            shutil.copyfile(os.path.join(directory, target + suffix), dst)


def alias_checkpoint(directory: str, name: str, target: str) -> str:
    """Make <directory>/<name> an alias (symlinks, else copies) of
    <directory>/<target>: a run with no dev set keeps 'best' = 'latest'
    without writing the state twice. Queued behind async saves in
    flight, so it only ever points at a committed target; collective in
    a gang (rank 0 writes)."""
    _raise_failed_saves()
    base = _base(directory, name)
    if _gang():
        if distributed.is_primary():
            _commit_alias(base, target)
        distributed.barrier()
    elif _PENDING:
        _PENDING.append(_writer().submit(_commit_alias, base, target))
    else:
        _commit_alias(base, target)
    return base


def restore_checkpoint(directory: str, name: str
                       ) -> Tuple[Dict[str, Any], Dict]:
    """-> (state with CPU tensors, sidecar dict). Read-only: a copy that
    a crashed save stranded is read in place."""
    wait_for_saves()
    found = _resolve(_base(directory, name))
    if found is None:
        raise FileNotFoundError(f"no checkpoint at "
                                f"{_base(directory, name)}{_STATE}")
    state_path, side_path = found
    with open(side_path) as f:
        sidecar = json.load(f)
    state = torch.load(state_path, map_location="cpu", weights_only=True)
    return state, sidecar


def restore_parts(directory: str, name: str, parts) -> Dict[str, Any]:
    """-> {part: state[part]} for the named top-level parts of a state,
    as CPU tensors mapped from the file: the bytes of the other parts
    (an optimizer's moments, say) are never read."""
    wait_for_saves()
    found = _resolve(_base(directory, name))
    if found is None:
        raise FileNotFoundError(f"no checkpoint at "
                                f"{_base(directory, name)}{_STATE}")
    state = torch.load(found[0], map_location="cpu", weights_only=True,
                       mmap=True)
    return {p: state[p] for p in parts}


def load_sidecar(directory: str, name: str) -> Dict:
    wait_for_saves()
    found = _resolve(_base(directory, name))
    if found is None or not os.path.exists(found[1]):
        raise FileNotFoundError(_base(directory, name) + _SIDECAR)
    with open(found[1]) as f:
        return json.load(f)


def checkpoint_exists(directory: str, name: str) -> bool:
    wait_for_saves()
    return _resolve(_base(directory, name)) is not None


def checkpoint_bytes(directory: str, name: str) -> int:
    """Size of the committed state file in bytes."""
    wait_for_saves()
    return os.path.getsize(_base(directory, name) + _STATE)
