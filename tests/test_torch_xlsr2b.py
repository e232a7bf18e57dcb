"""XLS-R 2B in the port, on the CPU: the `XLSR_2B` preset and its name in
the CLI's and the reference converter's tables (an unknown name under
`--encoder_init random` refused, no longer XLS-R 300M in silence); the
encoder at head dim 120 (the 2B's, 2 heads at 240 wide) against the JAX
encoder on the same bridged weights; the attention forward as a
`w2v.attention` range, in the forward and in the remat recompute; the
launch counters by head dim; an optimizer group a caller keeps holds
nothing once its optimizer is gone, and an optimizer it keeps holds
everything; the positional conv with its groups padded to the width
cuDNN's tensor-core kernels take is the plain grouped conv."""

import collections

import pytest
import torch
import torch.nn.functional as F

from tests.test_torch_bridge import cap_torch_threads, jax_config, jax_trees
from tests.test_torch_encoder import _port_outputs, _wave
from tests.test_torch_spans import _inside, _profiled_steps, _ranges, \
    _trainer, TINY
from wav2vec_contr_loss_tpu.models.wav2vec2 import \
    Wav2Vec2Encoder as JaxEncoder
import wav2vec_contr_loss_torch as w2v
from wav2vec_contr_loss_torch.cli import common
from wav2vec_contr_loss_torch.config import XLSR_2B, XLSR_300M
from wav2vec_contr_loss_torch.models import ref_convert
from wav2vec_contr_loss_torch.ops import attention
from wav2vec_contr_loss_torch.ops.pos_conv import pos_conv

cap_torch_threads()

NAME = "facebook/wav2vec2-xls-r-2b"


def test_xlsr2b_preset_is_the_300m_at_the_2b_widths():
    assert (XLSR_2B.hidden_size, XLSR_2B.num_layers, XLSR_2B.num_heads,
            XLSR_2B.intermediate_size) == (1920, 48, 16, 7680)
    assert XLSR_2B.hidden_size // XLSR_2B.num_heads == 120
    assert XLSR_2B == XLSR_300M.with_(hidden_size=1920, num_layers=48,
                                      intermediate_size=7680)
    assert w2v.XLSR_2B is XLSR_2B


def test_random_init_resolves_xlsr2b_and_refuses_an_unknown_name():
    cfg, sd = common.load_encoder_init("random", NAME)
    assert cfg is XLSR_2B and sd == {}
    assert common.KNOWN_ARCHS[NAME] is XLSR_2B
    with pytest.raises(ValueError, match="facebook/wav2vec2-xls-r-2b") as e:
        common.load_encoder_init("random", "facebook/wav2vec2-xls-r-1b")
    assert "facebook/wav2vec2-xls-r-300m" in str(e.value)


def test_reference_checkpoints_resolve_xlsr2b_by_model_name():
    cfg, sd = ref_convert._resolve_encoder(None, None, NAME, False)
    assert cfg is XLSR_2B and sd is None


@pytest.mark.parametrize("variant", ["xlsr", "large960h"])
def test_encoder_at_head_dim_120_matches_jax_xla(variant):
    """tests/test_torch_encoder.py's check with 2 heads of 120."""
    import numpy as np

    cfg = jax_config(variant, hidden_size=240, num_heads=2,
                     intermediate_size=480)
    enc = jax_trees(cfg)[0]
    want = JaxEncoder(cfg).apply({"params": enc}, _wave(),
                                 return_all_hidden_states=True)
    got = _port_outputs(cfg, enc)
    for key in ("layer_mean", "last_hidden", "all_hidden"):
        assert got[key].shape == want[key].shape, key
        np.testing.assert_allclose(got[key], np.asarray(want[key]),
                                   atol=2e-4, rtol=1e-3, err_msg=key)


@pytest.mark.parametrize("remat", [False, True])
def test_attention_is_a_span_in_the_forward_and_the_recompute(remat):
    """One `w2v.attention` a layer inside `w2v.forward`; under remat one
    more a layer inside `w2v.backward`, from its recompute."""
    prof, _ = _profiled_steps(_trainer(remat_encoder=remat), 1)
    spans = _ranges(prof, "w2v.attention")
    forward, = _ranges(prof, "w2v.forward")
    backward, = _ranges(prof, "w2v.backward")
    assert sum(_inside(s, forward) for s in spans) == TINY.num_layers
    assert sum(_inside(s, backward) for s in spans) == \
        (TINY.num_layers if remat else 0)
    assert len(spans) == TINY.num_layers * (2 if remat else 1)


def test_head_dim_counters_count_kernel_launches_alone():
    """Counters by head dim beside `launches` and `bwd_launches`: the
    plain versions on the CPU move none of them."""
    assert isinstance(attention.head_dim_launches, collections.Counter)
    assert isinstance(attention.head_dim_bwd_launches, collections.Counter)
    before = (dict(attention.head_dim_launches),
              dict(attention.head_dim_bwd_launches))
    q, k, v = (torch.randn(1, 2, 9, 120, requires_grad=True)
               for _ in range(3))
    out = attention.fused_attention(q, k, v, torch.zeros(1, 9), 3, 0.1, 2)
    out.sum().backward()
    assert (dict(attention.head_dim_launches),
            dict(attention.head_dim_bwd_launches)) == before
    assert attention.HEAD_DIMS[torch.bfloat16] == (64, 80, 120)
    assert attention.HEAD_DIMS[torch.float32] == (64,)


def test_a_group_kept_past_its_trainer_holds_no_tensor():
    """A caller that keeps a reference to an optimizer group after the
    trainer and its optimizer are gone (a loop variable) keeps none of its
    parameters, gradients or moments alive: at XLS-R 2B they are ~22 GB."""
    import gc
    import weakref

    import numpy as np
    from chip_smoke import train_batch

    trainer = _trainer()
    trainer.train_step(train_batch(np.random.default_rng(0), 4, 16000), 0.5)
    grp = list(trainer.optimizer.groups.values())[-1]
    assert grp.params and grp.mu
    param = weakref.ref(grp.params[0])
    moment = weakref.ref(grp.mu[0])
    del trainer
    gc.collect()
    assert param() is None and moment() is None
    assert grp.params == grp.mu == grp.nu == []


def test_an_optimizer_kept_past_its_trainer_keeps_its_state():
    """An optimizer a caller still holds once its trainer is gone (to save
    it, or to hand it on) keeps every parameter, gradient and moment."""
    import gc

    import numpy as np
    from chip_smoke import train_batch

    trainer = _trainer()
    trainer.train_step(train_batch(np.random.default_rng(0), 4, 16000), 0.5)
    opt = trainer.optimizer
    before = {name: ([p.detach().clone() for p in grp.params],
                     [m.clone() for m in grp.mu], [v.clone() for v in grp.nu])
              for name, grp in opt.groups.items()}
    del trainer
    gc.collect()
    for name, grp in opt.groups.items():
        params, mu, nu = before[name]
        assert len(grp.params) == len(params) > 0
        assert all(torch.equal(a.detach(), b) for a, b in zip(grp.params,
                                                               params))
        assert all(torch.equal(a, b) for a, b in zip(grp.mu, mu))
        assert all(torch.equal(a, b) for a, b in zip(grp.nu, nu))
        assert all(p.grad is not None for p in grp.params)


@pytest.mark.parametrize("d, groups, k", [(240, 2, 16), (1920 // 8, 16, 16),
                                         (128, 2, 16), (240, 2, 7)])
def test_aligned_group_conv_is_the_plain_grouped_conv(d, groups, k):
    """The model's grouped conv at 2B's widths (ops/pos_conv.py
    `pos_conv`; 120 and 15 here, 64 too), the input gradient a forward
    conv with the flipped weight: the same outputs and gradients as the
    plain conv, in fp32 on the CPU, at an even and an odd kernel."""
    torch.manual_seed(0)
    conv = torch.nn.Conv1d(d, d, k, padding=k // 2, groups=groups)
    x = torch.randn(3, 37, d, requires_grad=True)
    got = pos_conv(x, conv.weight, conv.bias, conv.padding[0],
                   groups).transpose(1, 2)
    want = F.conv1d(x.transpose(1, 2), conv.weight, conv.bias, conv.stride,
                    conv.padding, groups=groups)
    assert got.shape == want.shape == (3, d, 37 + 2 * (k // 2) - k + 1)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    g = torch.randn_like(want)
    leaves = [x, conv.weight, conv.bias]
    for a, b in zip(torch.autograd.grad((got * g).sum(), leaves),
                    torch.autograd.grad((want * g).sum(), leaves)):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-5)
