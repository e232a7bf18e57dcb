"""fp32 compute in the port, on the CPU.

* The plain fp32 attention (rates 0 and 0.1) and LN+GELU, forward and
  gradients: the CPU twins of the card's fp32 kernels, which
  chip_smoke.py holds the kernels to, against JAX's default fp32 program
  (the XLA attention of wav2vec_contr_loss_tpu/models/wav2vec2.py with
  fp32 softmax, flax's LayerNorm and exact GELU), and against the Pallas
  kernels in interpret mode at fp32 I/O, where the attention kernel's
  bf16 rounding of q, k, v and p is a measured distance (ROADMAP queue C).
* The wrappers' dtype dispatch without a card: CPU tensors of either
  dtype take the plain versions; the CUDA checks refuse float16,
  float64 and mixed dtypes, and take the (B, T, H, 64) view in fp32.
* The fp32 conv's autograd Function (cuDNN without TF32 on the card) on
  the CPU, `--encoder_init pretrained` from a local HF cache, the
  mp_smoke entry point's device, and chip_smoke.py's fp32-phase helpers.
"""

import os

import numpy as np
import pytest

import flax.linen as fnn
import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from wav2vec_contr_loss_tpu.ops.attention_pallas import \
    _dropout_mask as jax_dropout_mask
from wav2vec_contr_loss_tpu.ops.attention_pallas import \
    fused_attention as jax_fused_attention
from wav2vec_contr_loss_tpu.ops.conv_ln_pallas import \
    fused_ln_gelu as jax_fused_ln_gelu

from chip_smoke import (FP32_CLI_CLIPS, UPDATE_GROUPS, conv_extractor_vs_cpu,
                        expected_train_launches, fp32_cli_args,
                        fp32_step_config, random_jax_trees, train_batch,
                        update_cosines, write_corpus)
from wav2vec_contr_loss_torch import (XLSR_300M, Stage1Trainer,
                                      jax_params_to_torch)
from wav2vec_contr_loss_torch.cli import common, train_stage1
from wav2vec_contr_loss_torch.device import fp32_convs, resolve_device
from wav2vec_contr_loss_torch.models import wav2vec2
from wav2vec_contr_loss_torch.models.export_hf import save_hf_checkpoint
from wav2vec_contr_loss_torch.models.hf_convert import \
    load_local_hf_checkpoint
from wav2vec_contr_loss_torch.ops import attention, conv_ln
from wav2vec_contr_loss_torch.parallel import mp_smoke
from wav2vec_contr_loss_torch.parallel.mp_smoke import gradients

from tests.test_torch_bridge import cap_torch_threads

cap_torch_threads()

SEED = 12345
# the forwards, fp32 on both sides: products and sums in other orders
FWD_TOL = dict(atol=1e-5, rtol=1e-5)
# attention gradients (dq, dk, dv: O(1) entries, each a sum over 40 keys
# of products of fp32 values): the same order of rounding
ATT_GRAD_TOL = dict(atol=1e-5, rtol=1e-5)
# LN+GELU dx, and dscale/dbias, which are sums over 600 rows of terms up
# to ~5 taken in other orders
LN_DX_TOL = dict(atol=1e-5, rtol=1e-5)
LN_DPARAM_TOL = dict(atol=1e-4, rtol=1e-5)
# the Pallas attention kernel at fp32 I/O rounds q, k, v, p (and g, ds in
# its backward) to bf16 before each product; the port's fp32 path rounds
# nothing. Measured max |d| on these inputs (2^-9 relative rounding of
# O(1) operands): forward 5.5e-3 at rate 0, 7.8e-3 at rate 0.1; the
# gradients 6.8e-2 and 7.0e-2, on dq entries up to 18-20 (3.5e-3 of the
# largest). The upper bounds leave ~2x; the lower ones show the
# rounding is there.
PALLAS_FWD_DIST = (1e-4, 1.6e-2)
PALLAS_GRAD_DIST = (1e-3, 0.15)


def _attention_inputs(b=3, h=2, t=40, d=64):
    """q (pre-scaled), k, v, g and an fp32 key bias with a padded tail
    (clip 1) and a clip of no valid frame (clip 2)."""
    rng = np.random.default_rng(3)
    q, k, v, g = (rng.normal(0, 1, (b, h, t, d)).astype(np.float32)
                  for _ in range(4))
    q *= d ** -0.5
    bias = np.zeros((b, t), np.float32)
    bias[1, -9:] = -1e30
    bias[2, :] = -1e30
    return q, k, v, g, bias


def _jax_xla_attention(q, k, v, bias, seed, rate):
    """JAX's default attention program under fp32 compute
    (wav2vec2.py:439-454, 'bhqk' layout: fp32 logits plus the key bias,
    fp32 softmax, the dropped probabilities times v), the dropout mask
    that of the Pallas kernel, which the port draws (seed + b*H + h)."""
    b, h, t, _ = q.shape
    logits = jnp.einsum("bhqd,bhkd->bhqk", q, k) + bias[:, None, None, :]
    p = jax.nn.softmax(logits, axis=-1)
    if rate > 0.0:
        p = p * jnp.stack([jnp.stack([
            jax_dropout_mask((t, t), rate, jnp.uint32(seed + i * h + j))
            for j in range(h)]) for i in range(b)])
    return jnp.einsum("bhqk,bhkd->bhqd", p, v)


def _jax_fwd_and_grads(fn, q, k, v, g):
    out, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out), [np.asarray(x) for x in vjp(jnp.asarray(g))]


def _port_fwd_and_grads(q, k, v, g, bias, rate):
    """The port's fused_attention on fp32 CPU tensors: the plain version,
    without a gradient (the custom op) and under autograd."""
    before = (attention.launches, attention.bwd_launches)
    ts = [torch.from_numpy(a) for a in (q, k, v)]
    nograd = attention.fused_attention(*ts, torch.from_numpy(bias), SEED,
                                       rate, q.shape[1])
    ins = [x.clone().requires_grad_() for x in ts]
    out = attention.fused_attention(*ins, torch.from_numpy(bias), SEED,
                                    rate, q.shape[1])
    grads = torch.autograd.grad(out, ins, torch.from_numpy(g))
    assert (attention.launches, attention.bwd_launches) == before
    assert nograd.dtype == out.dtype == torch.float32
    np.testing.assert_array_equal(nograd.numpy(), out.detach().numpy())
    return out.detach().numpy(), [x.numpy() for x in grads]


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_fp32_attention_plain_matches_jax_xla(rate):
    q, k, v, g, bias = _attention_inputs()
    want, want_g = _jax_fwd_and_grads(
        lambda *a: _jax_xla_attention(*a, jnp.asarray(bias), SEED, rate),
        q, k, v, g)
    got, got_g = _port_fwd_and_grads(q, k, v, g, bias, rate)
    np.testing.assert_allclose(got, want, **FWD_TOL)
    for a, w in zip(got_g, want_g):
        np.testing.assert_allclose(a, w, **ATT_GRAD_TOL)
    if rate > 0.0:    # the mask drops ~10 % of the probabilities
        dropped = (jax_dropout_mask((40, 40), rate, jnp.uint32(SEED)) == 0)
        assert 0.05 < float(np.mean(dropped)) < 0.15
    if rate == 0.0:   # the fully masked clip attends uniformly
        np.testing.assert_allclose(got[2], np.broadcast_to(
            v[2].mean(axis=1, keepdims=True), got[2].shape), **FWD_TOL)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_fp32_attention_plain_vs_pallas_interpret(rate):
    """The Pallas kernel (interpret mode on the CPU) at fp32 I/O against
    the port's fp32 path: they differ by the kernel's bf16 rounding of
    its product operands, within PALLAS_*_DIST."""
    q, k, v, g, bias = _attention_inputs()
    want, want_g = _jax_fwd_and_grads(
        lambda *a: jax_fused_attention(*a, jnp.asarray(bias), SEED, rate,
                                       q.shape[1]), q, k, v, g)
    assert want.dtype == np.float32
    got, got_g = _port_fwd_and_grads(q, k, v, g, bias, rate)
    fwd = float(np.abs(got - want).max())
    grad = max(float(np.abs(a - w).max()) for a, w in zip(got_g, want_g))
    lo, hi = PALLAS_FWD_DIST
    assert lo < fwd < hi, fwd
    lo, hi = PALLAS_GRAD_DIST
    assert lo < grad < hi, grad


def _ln_inputs(shape=(2, 300, 512)):
    rng = np.random.default_rng(0)
    x = rng.normal(0, 2, shape).astype(np.float32)
    dy = rng.normal(0, 1, shape).astype(np.float32)
    scale = rng.normal(1, 0.2, shape[-1]).astype(np.float32)
    bias = rng.normal(0, 0.3, shape[-1]).astype(np.float32)
    return x, dy, scale, bias


def _jax_xla_ln_gelu(x, scale, bias, gelu):
    """JAX's default program for a conv's LayerNorm (+ GELU) under fp32
    compute: flax LayerNorm (wav2vec2.py `_ConvLayerNorm`, impl 'xla'),
    then exact GELU."""
    y = fnn.LayerNorm(epsilon=1e-5, dtype=jnp.float32,
                      param_dtype=jnp.float32).apply(
        {"params": {"scale": scale, "bias": bias}}, x)
    return jax.nn.gelu(y, approximate=False) if gelu else y


def _port_ln(x, dy, scale, bias, gelu):
    before = (conv_ln.launches, conv_ln.bwd_launches)
    ins = [torch.from_numpy(a).requires_grad_() for a in (x, scale, bias)]
    out = conv_ln.fused_ln_gelu(*ins, 1e-5, gelu)
    grads = torch.autograd.grad(out, ins, torch.from_numpy(dy))
    assert (conv_ln.launches, conv_ln.bwd_launches) == before
    assert out.dtype == torch.float32
    return out.detach().numpy(), [a.numpy() for a in grads]


@pytest.mark.parametrize("gelu", [True, False])
def test_fp32_ln_gelu_plain_matches_jax_xla(gelu):
    x, dy, scale, bias = _ln_inputs()
    out, vjp = jax.vjp(lambda *a: _jax_xla_ln_gelu(*a, gelu),
                       jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    want_g = vjp(jnp.asarray(dy))
    got, got_g = _port_ln(x, dy, scale, bias, gelu)
    np.testing.assert_allclose(got, np.asarray(out), **FWD_TOL)
    for a, w, tol in zip(got_g, want_g,
                         (LN_DX_TOL, LN_DPARAM_TOL, LN_DPARAM_TOL)):
        np.testing.assert_allclose(a, np.asarray(w), **tol)


@pytest.mark.parametrize("gelu", [True, False])
def test_fp32_ln_gelu_plain_matches_pallas_grads(gelu):
    """The Pallas LN+GELU computes in fp32 at fp32 I/O (its erf is A&S
    7.1.26, 1.5e-7 from erf): its forward and VJP in interpret mode
    against the port's fp32 path within the fp32 tolerances."""
    x, dy, scale, bias = _ln_inputs((2, 96, 256))
    out, vjp = jax.vjp(lambda *a: jax_fused_ln_gelu(*a, 1e-5, gelu),
                       jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    want_g = vjp(jnp.asarray(dy))
    got, got_g = _port_ln(x, dy, scale, bias, gelu)
    np.testing.assert_allclose(got, np.asarray(out), **FWD_TOL)
    for a, w, tol in zip(got_g, want_g,
                         (LN_DX_TOL, LN_DPARAM_TOL, LN_DPARAM_TOL)):
        np.testing.assert_allclose(a, np.asarray(w), **tol)


# ---- dispatch by dtype -------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_tensors_of_either_dtype_take_the_plain_versions(dtype):
    q, k, v, g, bias = (torch.from_numpy(a) for a in _attention_inputs(
        t=16))
    q, k, v, g = (x.to(dtype) for x in (q, k, v, g))
    x = torch.randn(40, 256).to(dtype)
    before = (attention.launches, attention.bwd_launches, conv_ln.launches,
              conv_ln.bwd_launches)
    out = attention.fused_attention(q, k, v, bias, 1, 0.1, 2)
    ins = [a.clone().requires_grad_() for a in (q, k, v)]
    dq, _, _ = torch.autograd.grad(
        attention.fused_attention(*ins, bias, 1, 0.1, 2), ins, g)
    sc, sh = torch.ones(256), torch.zeros(256)
    y = conv_ln.fused_ln_gelu(x, sc, sh)
    xr = x.clone().requires_grad_()
    dx, = torch.autograd.grad(conv_ln.fused_ln_gelu(xr, sc, sh), xr,
                              torch.ones_like(x))
    assert (attention.launches, attention.bwd_launches, conv_ln.launches,
            conv_ln.bwd_launches) == before
    assert out.dtype == dq.dtype == y.dtype == dx.dtype == dtype


@pytest.mark.parametrize("dtypes", [
    (torch.float16,) * 4, (torch.float64,) * 4,
    (torch.float32, torch.bfloat16, torch.float32, torch.float32),
    (torch.bfloat16,) * 3 + (torch.float32,)])
def test_cuda_attention_check_refuses_other_and_mixed_dtypes(dtypes):
    ts = [torch.zeros(1, 2, 8, 64, dtype=dt) for dt in dtypes]
    with pytest.raises(ValueError, match="all bfloat16 or all float32"):
        attention._check_cuda(ts, 64)


def test_cuda_attention_check_picks_the_kernels_by_dtype():
    for dtype in (torch.float32, torch.bfloat16):
        proj = torch.zeros(2, 9, 4, 64, dtype=dtype)   # (B, T, H, 64)
        view = proj.transpose(1, 2)                     # no copy
        assert attention._check_cuda([view] * 3, 64) == dtype
    # fp32 rows 66 floats apart are not 16-byte aligned
    odd = torch.zeros(1, 2, 8, 66)[..., :64]
    with pytest.raises(ValueError, match="multiples of 4"):
        attention._check_cuda([odd] * 3, 64)
    assert attention._check_cuda([torch.zeros(1, 2, 8, 68)[..., :64]] * 3,
                                 64) == torch.float32
    # bf16 keeps the TMA rule: strides multiples of 8 elements
    odd16 = torch.zeros(1, 2, 8, 68, dtype=torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match="multiples of 8"):
        attention._check_cuda([odd16] * 3, 64)


def test_cuda_ln_gelu_checks_refuse_other_and_mixed_dtypes():
    sc, sh = torch.ones(512), torch.zeros(512)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.zeros(4, 512, dtype=dtype)
        conv_ln._check_cuda(x, sc, sh)
        conv_ln._check_bwd(x, torch.zeros_like(x))
        assert conv_ln._BWD_ENTRIES[dtype][1].startswith("ln_gelu_bwd")
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(ValueError, match="bfloat16 or float32"):
            conv_ln._check_cuda(torch.zeros(4, 512, dtype=dtype), sc, sh)
    with pytest.raises(ValueError, match="dtype"):
        conv_ln._check_bwd(torch.zeros(4, 512),
                           torch.zeros(4, 512, dtype=torch.bfloat16))


# ---- the fp32 conv ------------------------------------------------------

@pytest.mark.parametrize("stride,groups,bias", [(5, 1, False), (1, 4, True)])
def test_fp32_conv_function_matches_autograd(stride, groups, bias):
    """`_Fp32Conv` (the card's fp32 conv: cuDNN with TF32 off in the
    forward and in the backward) computes F.conv1d and its gradients;
    the process's TF32 setting is left as it was."""
    torch.manual_seed(0)
    conv = torch.nn.Conv1d(8, 8, 6, stride, padding=3 if groups > 1 else 0,
                           groups=groups, bias=bias)
    x = torch.randn(2, 8, 50, requires_grad=True)
    g = torch.randn_like(conv(x))
    before = torch.backends.cudnn.allow_tf32
    got = wav2vec2._Fp32Conv.apply(x, conv.weight, conv.bias, conv.stride,
                                   conv.padding, conv.groups)
    gg = torch.autograd.grad(got, [x, conv.weight]
                             + ([conv.bias] if bias else []), g)
    want = F.conv1d(x, conv.weight, conv.bias, conv.stride, conv.padding,
                    groups=conv.groups)
    wg = torch.autograd.grad(want, [x, conv.weight]
                             + ([conv.bias] if bias else []), g)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    for a, w in zip(gg, wg):
        torch.testing.assert_close(a, w, rtol=1e-6, atol=1e-6)
    assert torch.backends.cudnn.allow_tf32 == before
    with fp32_convs():
        assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 == before


# ---- --encoder_init pretrained -----------------------------------------

def _fake_hub(root, name="test/tiny-wav2vec2", rev="0123abcd"):
    """A local HF hub cache holding one snapshot of `name`, written by
    the port's exporter from a seeded tiny encoder. -> snapshot dir."""
    cfg = common.TINY_TEST
    sd = jax_params_to_torch(cfg, *random_jax_trees(cfg, seed=7))["encoder"]
    repo = os.path.join(root, "models--" + name.replace("/", "--"))
    snap = save_hf_checkpoint(os.path.join(repo, "snapshots", rev), cfg, sd)
    os.makedirs(os.path.join(repo, "refs"))
    with open(os.path.join(repo, "refs", "main"), "w") as f:
        f.write(rev + "\n")
    return snap


def test_encoder_init_pretrained_reads_the_local_hf_cache(tmp_path,
                                                          monkeypatch):
    snap = _fake_hub(str(tmp_path / "hub"))
    monkeypatch.delenv("HF_HOME", raising=False)
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "hub"))
    cfg, sd = common.load_encoder_init("pretrained", "test/tiny-wav2vec2")
    cfg2, sd2 = common.load_encoder_init(snap, "test/tiny-wav2vec2")
    cfg3, sd3 = load_local_hf_checkpoint(snap)
    assert cfg == cfg2 == cfg3
    assert sd.keys() == sd2.keys() == sd3.keys() and sd
    for key in sd:
        assert torch.equal(sd[key], sd2[key]) and torch.equal(sd[key],
                                                              sd3[key])
    # $HF_HOME/hub when HF_HUB_CACHE is unset
    monkeypatch.delenv("HF_HUB_CACHE")
    monkeypatch.setenv("HF_HOME", str(tmp_path / "home"))
    _fake_hub(str(tmp_path / "home" / "hub"))
    cfg4, sd4 = common.load_encoder_init("pretrained", "test/tiny-wav2vec2")
    assert cfg4 == cfg and all(torch.equal(sd4[k], sd[k]) for k in sd)
    # no snapshot of that name: refused, naming the cache
    with pytest.raises(ValueError, match="downloads nothing") as e:
        common.load_encoder_init("pretrained", "facebook/wav2vec2-xls-r-300m")
    assert str(tmp_path / "home" / "hub") in str(e.value)


# ---- mp_smoke on the card unless asked --------------------------------

def test_mp_smoke_runs_on_the_card_unless_asked(tmp_path):
    args = mp_smoke.build_parser().parse_args(["--out", "o", "--legs", "dp"])
    assert args.device == "cuda"
    if torch.cuda.is_available():
        assert resolve_device(args.device).type == "cuda"
        return
    msg = "no CUDA device is available; the port runs on the GPU"
    with pytest.raises(RuntimeError, match=msg):
        resolve_device(args.device)
    with pytest.raises(RuntimeError, match=msg):
        mp_smoke.main(["--out", str(tmp_path), "--legs", "dp"])
    with pytest.raises(RuntimeError, match=msg):   # before any rank starts
        mp_smoke.launch_gang(str(tmp_path), ["dp"])
    assert not os.listdir(tmp_path)


# ---- chip_smoke.py's fp32 phase ----------------------------------------

def test_fp32_phase_helpers_on_cpu(tmp_path):
    """The fp32 step's config and launch counts at XLS-R-300M width; one
    fp32 step of its trainer at a tiny width (remat_conv, dropout and
    SpecAugment on) gives gradients in every group the card check reads;
    the conv-extractor comparison and the CLI leg's flags."""
    scfg = fp32_step_config()
    assert (scfg.compute_dtype, scfg.grad_dtype) == ("float32", "auto")
    assert expected_train_launches(scfg, XLSR_300M) == {
        "attention_fwd": 48, "attention_bwd": 24, "ln_gelu_fwd": 7,
        "ln_gelu_bwd": 7, "supcon": 1}

    cfg = XLSR_300M.with_(hidden_size=128, num_heads=2, intermediate_size=64,
                          conv_dim=(32,) * 7, num_layers=1,
                          num_conv_pos_embeddings=8,
                          num_conv_pos_embedding_groups=2,
                          mask_time_prob=0.2, mask_time_length=5)
    tr = Stage1Trainer(fp32_step_config(batch_size=4, remat_conv=True,
                                        input_dim=128, hidden_dim=16), cfg,
                       jax_params_to_torch(cfg, *random_jax_trees(
                           cfg, comp_dim=16, seed=3)), device="cpu")
    batch = train_batch(np.random.default_rng(4), 4, samples=8000)
    assert np.isfinite(tr.train_step(batch, 0.5)["loss"].item())
    grads = gradients(tr)
    cos = update_cosines(None, grads, grads)
    assert set(cos) == set(UPDATE_GROUPS)
    assert all(abs(c - 1.0) < 1e-12 for c in cos.values())

    err, top = conv_extractor_vs_cpu(tr.encoder, batch["waveforms"][:2],
                                     "cpu")
    assert err == 0.0 and top > 0.0

    root = str(tmp_path)
    proto = write_corpus(root, 4, seed=13, seconds=0.5)
    args = train_stage1.build_parser().parse_args(
        fp32_cli_args(root, proto, str(tmp_path / "save")))
    assert (args.device, args.compute_dtype, args.encoder_init) == (
        "cuda", "float32", "random")
    assert FP32_CLI_CLIPS // args.batch_size == 2
