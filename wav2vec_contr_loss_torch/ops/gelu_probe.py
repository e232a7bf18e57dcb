"""Time the CUDA LN+GELU backward (csrc/ln_gelu_bwd.cu) with GELU' built
three ways, at the train step's first conv (511,968 rows x 512, bf16):

* the kernel as it is: the Pallas kernel's erf (Abramowitz & Stegun
  7.1.26) sharing one `__expf` with GELU';
* `erff` for the erf, `__expf` for GELU';
* `erff` and `expf`.

Each variant is the kernel's source with those lines replaced, built
with the port's nvcc flags into `_build/`, launched through the port's
wrapper, timed as device time (CUDA events around 20 calls queued behind
a sleeping kernel) and held against the plain version. Needs one card:

    python -m wav2vec_contr_loss_torch.ops.gelu_probe
"""

from __future__ import annotations

import ctypes
import subprocess
import time
from unittest import mock

import torch

from . import _build, conv_ln

_ERF = "erf_as(h * 0.7071067811865476f, e2)"
_EXP = "__expf(-0.5f * h * h)"
VARIANTS = {
    "as_erf": {},
    "erff___expf": {_ERF: "erff(h * 0.7071067811865476f)"},
    "erff_expf": {_ERF: "erff(h * 0.7071067811865476f)",
                  _EXP: "expf(-0.5f * h * h)"},
}
ROWS, C = 32 * 15999, 512


def build_variant(tag: str, subs: dict) -> ctypes.CDLL:
    """ln_gelu_bwd.cu with each `old` replaced by `new`, built and bound
    as `conv_ln._bwd_lib` binds the kernel."""
    src = (_build.SRC_DIR / "ln_gelu_bwd.cu").read_text()
    for old, new in subs.items():
        if src.count(old) != 1:
            raise RuntimeError(f"{old!r} is not in ln_gelu_bwd.cu once")
        src = src.replace(old, new)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = _build.BUILD_DIR / f"ln_gelu_bwd_{tag}.cu"
    so = cu.with_suffix(".so")
    cu.write_text(src)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                    str(_build.SRC_DIR), "-o", str(so), str(cu)], check=True)
    lib = ctypes.CDLL(str(so))
    lib.w2v_cuda_error_string.argtypes = [ctypes.c_int]
    lib.w2v_cuda_error_string.restype = ctypes.c_char_p
    return conv_ln._bind_bwd(lib)


def device_ms(fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    if time.perf_counter() - t0 < 1e-3:
        raise RuntimeError("the host outlasted the sleeping kernel")
    return start.elapsed_time(end) / iters


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    print(card)
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = (2.0 * torch.randn(ROWS, C, generator=gen, device="cuda")
         ).to(torch.bfloat16)
    dy = torch.randn(ROWS, C, generator=gen, device="cuda"
                     ).to(torch.bfloat16)
    scale = 1.0 + 0.1 * torch.randn(C, generator=gen, device="cuda")
    shift = 0.1 * torch.randn(C, generator=gen, device="cuda")
    ins = [a.detach().requires_grad_() for a in (x, scale, shift)]
    want = torch.autograd.grad(
        conv_ln.fused_ln_gelu_plain(*ins, 1e-5, True), ins, dy)
    libs = {tag: build_variant(tag, subs) for tag, subs in VARIANTS.items()}
    for rep in range(2):
        for tag, lib in libs.items():
            with mock.patch.object(conv_ln, "_bwd_lib", lambda: lib):
                def run():
                    return conv_ln._launch_bwd(x, dy, scale, shift, 1e-5,
                                               True)
                errs = [(a.float() - w.float()).abs().max().item()
                        for a, w in zip(run(), want)]
                ms = device_ms(run)
            print(f"{tag} rep {rep}: {ms:.4f} ms at ({ROWS}, {C}) bf16; max "
                  f"abs err against the plain version dx {errs[0]:.3e}, "
                  f"dscale {errs[1]:.3e}, dbias {errs[2]:.3e} [{card}]")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
