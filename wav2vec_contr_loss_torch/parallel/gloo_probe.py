"""Which torch.distributed collectives and point-to-point transfers Gloo
takes for CUDA tensors here.

Two ranks that share one card cannot use NCCL, so a gang of two on one
card runs Gloo with CUDA tensors. Gloo implements some collectives for
CUDA tensors and not others; this probe runs each collective the port's
parallel layouts use, in fp32 and bf16, on two ranks on `cuda:0`, and
one FSDP2 step (its parameter all-gather and gradient reduce-scatter).
Then it tries the point-to-point transfers the pipeline's hand-off
could use (`send`/`recv`, `isend`/`irecv`, `batch_isend_irecv`) on a
CUDA tensor, each in a gang of its own (a transfer that crashes a rank
ends only its gang), and checks the values that arrive. It prints one
JSON line {name: "ok" | what went wrong} from rank 0. What it prints
fixes which layouts chip_smoke.py's two-rank legs run, and how
collectives.shift_stages hands activations on under Gloo.

    python -m wav2vec_contr_loss_torch.parallel.gloo_probe
"""

from __future__ import annotations

import json
import sys
from concurrent.futures import ThreadPoolExecutor

P2P = ("send/recv", "isend/irecv", "batch_isend_irecv")


def _probe() -> dict:
    import torch
    import torch.distributed as dist

    dev = torch.device("cuda", 0)
    out = {}

    def attempt(name, fn):
        try:
            fn()
            torch.cuda.synchronize()
            out[name] = "ok"
        except Exception as e:   # the probe's answer, not a fallback
            out[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
        dist.barrier()

    for dt in (torch.float32, torch.bfloat16):
        tag = str(dt).split(".")[-1]
        x = torch.ones(1024, dtype=dt, device=dev)
        attempt(f"all_reduce {tag}", lambda: dist.all_reduce(x.clone()))
        attempt(f"all_gather {tag}", lambda: dist.all_gather(
            [torch.empty_like(x) for _ in range(2)], x))
        attempt(f"all_gather_into_tensor {tag}",
                lambda: dist.all_gather_into_tensor(
                    torch.empty(2048, dtype=dt, device=dev), x))
        attempt(f"reduce_scatter_tensor {tag}",
                lambda: dist.reduce_scatter_tensor(
                    torch.empty(512, dtype=dt, device=dev), x))
        attempt(f"broadcast {tag}", lambda: dist.broadcast(x.clone(), 0))

    def fsdp_step():
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.fsdp import fully_shard

        mesh = init_device_mesh("cuda", (2,), mesh_dim_names=("data",))
        torch.manual_seed(0)
        m = torch.nn.Sequential(torch.nn.Linear(64, 64),
                                torch.nn.Linear(64, 8)).to(dev)
        fully_shard(m[0], mesh=mesh)
        fully_shard(m, mesh=mesh)
        m(torch.ones(4, 64, device=dev)).sum().backward()

    attempt("FSDP2 fully_shard step", fsdp_step)
    return out


def _probe_p2p(kind: str) -> str:
    """Rank 0 sends a bf16 CUDA tensor to rank 1 by `kind`; rank 1 checks
    what arrived. -> "ok" or what went wrong (on rank 1)."""
    import torch
    import torch.distributed as dist

    dev = torch.device("cuda", 0)
    want = torch.arange(4096, device=dev).to(torch.bfloat16)
    rank = dist.get_rank()
    buf = want.clone() if rank == 0 else torch.zeros_like(want)
    if kind == "send/recv":
        (dist.send if rank == 0 else dist.recv)(buf, 1 - rank)
    elif kind == "isend/irecv":
        (dist.isend if rank == 0 else dist.irecv)(buf, 1 - rank).wait()
    else:
        op = dist.isend if rank == 0 else dist.irecv
        for work in dist.batch_isend_irecv([dist.P2POp(op, buf, 1 - rank)]):
            work.wait()
    torch.cuda.synchronize()
    if rank == 1 and not torch.equal(buf, want):
        return "wrong values arrived"
    return "ok"


def main() -> int:
    from ..utils import distributed

    if len(sys.argv) > 1 and sys.argv[1] == "--rank":
        distributed.maybe_initialize(force=True, device="cuda",
                                     backend="gloo")
        kind = sys.argv[2] if len(sys.argv) > 2 else None
        res = _probe() if kind is None else {kind: _probe_p2p(kind)}
        if distributed.rank() == (0 if kind is None else 1):
            print(json.dumps({"gloo_cuda": res}), flush=True)
        import torch.distributed as dist

        dist.destroy_process_group()
        return 0
    from .mp_smoke import spawn

    cmd = [sys.executable, "-m", "wav2vec_contr_loss_torch.parallel.gloo_probe",
           "--rank"]

    def run(kind):
        try:
            logs = spawn(cmd + ([kind] if kind else []), 2, timeout=120,
                         one_card=True)
        except RuntimeError as e:   # a crashed or hung gang is the answer
            why = [ln for ln in str(e).splitlines()
                   if "Error" in ln or "rank" in ln]
            return {kind: " | ".join(why[-2:])[:300]}
        line = [ln for log in logs for ln in log.splitlines()
                if ln.startswith("{")][-1]
        return json.loads(line)["gloo_cuda"]

    with ThreadPoolExecutor(len(P2P) + 1) as pool:
        parts = list(pool.map(run, (None,) + P2P))
    res = {k: v for part in parts for k, v in part.items()}
    print(json.dumps({"gloo_cuda": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
