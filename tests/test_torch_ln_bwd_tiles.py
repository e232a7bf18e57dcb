"""The algorithm of the port's LN+GELU backward kernel
(wav2vec_contr_loss_torch/csrc/ln_gelu_bwd.cu), emulated in plain PyTorch
on the CPU, against `jax.vjp` of the Pallas `fused_ln_gelu` (interpret
mode, as tests/test_conv_ln_pallas.py runs it).

The emulation keeps the kernel's structure: the static partition of the
row stages (8 warps x 4, 2 or 1 rows a stage at C = 256, 512, 768 and
1024) into contiguous ranges, one range a block; one warp a row, lane l
holding columns 256c + 8l ... 256c + 8l + 7, each row sum taken as the
lane's own columns in order then the xor butterfly across the 32 lanes;
GELU' through the Pallas kernel's erf (Abramowitz & Stegun 7.1.26) with
its exp shared; each warp's column sums over its rows, a block's partial
row pair as the warps' sums added in warp order, dscale and dbias as the
partial rows added in block order. Within one warp the rows are added by
`torch.sum`, whose order is not the kernel's.

Tolerances, those of tests/test_torch_train_ops.py (and of
tests/test_conv_ln_pallas.py): fp32 rtol = atol = 1e-4, bf16 2e-2.
"""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from wav2vec_contr_loss_tpu.ops.conv_ln_pallas import \
    fused_ln_gelu as jax_fused_ln_gelu

from wav2vec_contr_loss_torch.ops import conv_ln

from tests.test_torch_bridge import cap_torch_threads

cap_torch_threads()

WARPS = 8
ROWS_PER_WARP = {256: 4, 512: 2, 768: 1, 1024: 1}
TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def stage_rows(c: int) -> int:
    return WARPS * ROWS_PER_WARP[c]


def block_stages(n_stages: int, grid: int):
    """[(first, end)] row stages of each block, as the kernel cuts them."""
    return [(b * n_stages // grid, (b + 1) * n_stages // grid)
            for b in range(grid)]


def warp_sum(v: torch.Tensor) -> torch.Tensor:
    """(rows, C) -> (rows,): each lane adds its columns in order, then the
    xor butterfly over the 32 lanes (every lane ends with the same sum)."""
    rows, c = v.shape
    lanes = v.reshape(rows, c // 256, 32, 8).permute(0, 2, 1, 3)
    lanes = lanes.reshape(rows, 32, -1)
    t = torch.zeros(rows, 32)
    for k in range(lanes.shape[-1]):
        t = t + lanes[:, :, k]
    for o in (16, 8, 4, 2, 1):
        t = t + t[:, torch.arange(32) ^ o]
    return t[:, 0]


def erf_as(x: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """Abramowitz & Stegun 7.1.26 given e = exp(-x^2), as `erf_as`."""
    t = 1.0 / (1.0 + 0.3275911 * x.abs())
    poly = ((((1.061405429 * t - 1.453152027) * t + 1.421413741) * t
             - 0.284496736) * t + 0.254829592) * t
    return torch.copysign(1.0 - poly * e, x)


def emulate(x, dy, scale, bias, eps, gelu, grid):
    """-> (dx in x's dtype, dscale, dbias) as ln_gelu_bwd.cu's two
    kernels on a grid of `grid` blocks."""
    n, c = x.shape
    rs = stage_rows(c)
    xf, gf = x.float(), dy.float()
    mean = warp_sum(xf) / c
    xc = xf - mean[:, None]
    rstd = torch.rsqrt(warp_sum(xc * xc) / c + eps)
    xhat = xc * rstd[:, None]
    if gelu:
        h = xhat * scale + bias
        e = torch.exp(-0.5 * h * h)
        phi = 0.5 * (1.0 + erf_as(h * 0.7071067811865476, e))
        dh = gf * (phi + h * 0.3989422804014327 * e)
    else:
        dh = gf
    dxh = dh * scale
    m1, m2 = warp_sum(dxh) / c, warp_sum(dxh * xhat) / c
    dx = rstd[:, None] * (dxh - m1[:, None] - xhat * m2[:, None])

    # the warp that takes each row: its place in its stage
    warp_of = (torch.arange(n) % rs) // ROWS_PER_WARP[c]
    parts = []
    for first, end in block_stages(-(-n // rs), grid):
        rows = torch.arange(first * rs, min(end * rs, n))
        part = torch.zeros(2, c)
        for w in range(WARPS):                      # warps in order
            mine = rows[warp_of[rows] == w]
            part = part + torch.stack([(dh[mine] * xhat[mine]).sum(0),
                                       dh[mine].sum(0)])
        parts.append(part)
    total = torch.zeros(2, c)
    for part in parts:                              # blocks in order
        total = total + part
    return dx.to(x.dtype), total[0], total[1]


def _inputs(rows, c, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 2, (rows, c)).astype(np.float32)
    dy = rng.normal(0, 1, (rows, c)).astype(np.float32)
    scale = rng.normal(1, 0.2, c).astype(np.float32)
    bias = rng.normal(0, 0.3, c).astype(np.float32)
    return x, dy, scale, bias


@pytest.mark.parametrize("gelu", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [256, 512])
@pytest.mark.parametrize("rows", [300, 1000])
def test_row_partition_matches_pallas(rows, c, dtype, gelu):
    x, dy, scale, bias = _inputs(rows, c, rows + c)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    _, vjp = jax.vjp(lambda x_, s_, b_: jax_fused_ln_gelu(x_, s_, b_, 1e-5,
                                                         gelu),
                     jnp.asarray(x, jdt), jnp.asarray(scale),
                     jnp.asarray(bias))
    want = vjp(jnp.asarray(dy, jdt))

    tdt = getattr(torch, dtype)
    # a grid that leaves blocks one stage apart in size
    grid = min(7, -(-rows // stage_rows(c)))
    got = emulate(torch.from_numpy(x).to(tdt), torch.from_numpy(dy).to(tdt),
                  torch.from_numpy(scale), torch.from_numpy(bias), 1e-5,
                  gelu, grid)
    for name, a, w in zip(("dx", "dscale", "dbias"), got, want):
        np.testing.assert_allclose(a.float().numpy(), np.asarray(w, np.float32),
                                   **TOL[dtype], err_msg=name)


@pytest.mark.parametrize("grid", [1, 3, 132])
def test_column_sums_do_not_depend_on_the_grid_beyond_rounding(grid):
    """The grid changes only the order of the fp32 column sums: dx is the
    same bits on any grid, dscale and dbias agree to rounding."""
    x, dy, scale, bias = (torch.from_numpy(a) for a in _inputs(2000, 512, 5))
    n_stages = -(-2000 // stage_rows(512))
    one = emulate(x, dy, scale, bias, 1e-5, True, 1)
    got = emulate(x, dy, scale, bias, 1e-5, True, min(grid, n_stages))
    assert torch.equal(got[0], one[0])
    for a, w in zip(got[1:], one[1:]):
        torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("c", [256, 512, 768, 1024])
@pytest.mark.parametrize("n", [1, 15, 16, 511968])
def test_partition_covers_every_stage_once(n, c):
    n_stages = -(-n // stage_rows(c))
    grid = min(264, n_stages)
    ranges = block_stages(n_stages, grid)
    assert ranges[0][0] == 0 and ranges[-1][1] == n_stages
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    sizes = [end - first for first, end in ranges]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
    # a stage's bulk copy of x (or dy) fits the ring slot and is whole rows
    assert stage_rows(c) * c * 2 <= 16384
    assert math.ceil(n / stage_rows(c)) == n_stages


def test_lane_columns_and_parameter_slots():
    """Lane l's columns of chunk c are 256c + 8l ... + 7, and the shared
    memory slots of scale and bias (`param_slot`) are a permutation of
    the columns in which lane l's eight values of a chunk are two
    consecutive float4s, at ((2c + h) * 32 + l) * 4."""
    c_max = 1024
    col = np.arange(c_max)
    chunk, lane, e = col >> 8, (col >> 3) & 31, col & 7
    slot = ((2 * chunk + (e >> 2)) * 32 + lane) * 4 + (e & 3)
    assert sorted(slot) == list(range(c_max))
    for ch in range(4):
        for ln in (0, 17, 31):
            cols = 256 * ch + 8 * ln + np.arange(8)
            want = np.concatenate([((2 * ch + h) * 32 + ln) * 4 + np.arange(4)
                                   for h in (0, 1)])
            np.testing.assert_array_equal(slot[cols], want)


@pytest.mark.parametrize("c", [128, 300, 1280])
def test_cuda_backward_refuses_other_widths(c):
    x = torch.zeros(4, c, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="C in"):
        conv_ln._check_bwd(x, x)


def test_cuda_backward_checks_dy():
    x = torch.zeros(4, 512, dtype=torch.bfloat16)
    conv_ln._check_bwd(x, torch.zeros_like(x))
    for dy in (torch.zeros(4, 512), torch.zeros(512, 4,
                                                dtype=torch.bfloat16).T):
        with pytest.raises(ValueError, match="dy"):
            conv_ln._check_bwd(x, dy)
