"""Which torch.distributed collectives Gloo takes for CUDA tensors here.

Two ranks that share one card cannot use NCCL, so a gang of two on one
card runs Gloo with CUDA tensors. Gloo implements some collectives for
CUDA tensors and not others; this probe runs each collective the port's
parallel layouts use, in fp32 and bf16, on two ranks on `cuda:0`, and
one FSDP2 step (its parameter all-gather and gradient reduce-scatter),
and prints one JSON line {collective: "ok" | the error} from rank 0.
What it prints fixes which layouts chip_smoke.py's two-rank leg runs.

    python -m wav2vec_contr_loss_torch.parallel.gloo_probe
"""

from __future__ import annotations

import json
import sys


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


def main() -> int:
    from ..utils import distributed

    if len(sys.argv) > 1 and sys.argv[1] == "--rank":
        distributed.maybe_initialize(force=True, device="cuda",
                                     backend="gloo")
        res = _probe()
        if distributed.is_primary():
            print(json.dumps({"gloo_cuda": res}), flush=True)
        import torch.distributed as dist

        dist.destroy_process_group()
        return 0
    from .mp_smoke import spawn

    logs = spawn([sys.executable, "-m",
                  "wav2vec_contr_loss_torch.parallel.gloo_probe", "--rank"],
                 2, timeout=300, one_card=True)
    print([ln for ln in logs[0].splitlines() if ln.startswith("{")][-1])
    return 0


if __name__ == "__main__":
    sys.exit(main())
