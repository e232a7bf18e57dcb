"""The training slice's loss and optimizer on the CPU against the JAX
package: the port's SupCon loss (its fused kernel's plain version) and
its gradients in z and alpha against both the Pallas kernel in interpret
mode and the XLA loss, over the case grid of tests/test_supcon_pallas.py;
the AdamW with bf16 moments against optax; the alpha schedule. The CUDA
SupCon kernel runs only on the card (chip_smoke.py holds it against the
plain version)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from wav2vec_contr_loss_tpu.losses import SupConConfig as JaxSupConConfig
from wav2vec_contr_loss_tpu.losses import supcon_binary_loss as jax_supcon
from wav2vec_contr_loss_tpu.ops.adam_bf16nu import adamw_storage_dtypes
from wav2vec_contr_loss_tpu.ops.supcon_pallas import supcon_binary_loss_pallas
from wav2vec_contr_loss_tpu.train.schedule import \
    alpha_for_epoch as jax_alpha_for_epoch

from tests.test_supcon_pallas import CASES, make_labels, normed
from wav2vec_contr_loss_torch.config import SupConConfig
from wav2vec_contr_loss_torch.ops import supcon
from wav2vec_contr_loss_torch.train import alpha_for_epoch
from wav2vec_contr_loss_torch.train.optim import AdamWGroup

from tests.test_torch_bridge import cap_torch_threads

cap_torch_threads()


@pytest.mark.parametrize("b,d,lk,tau,sim,topk,alpha,lam", CASES)
def test_supcon_matches_pallas_and_xla(b, d, lk, tau, sim, topk, alpha, lam):
    rng = np.random.default_rng(b * 100 + topk)
    z = normed(rng, b, d)
    labels = make_labels(lk, b, rng)
    kw = dict(temperature=tau, similarity=sim, topk_neg=topk,
              uniformity_weight=lam, uniformity_t=2.0)
    jcfg = JaxSupConConfig(**kw)

    def grads(fn):
        return jax.value_and_grad(lambda z_, a_: fn(z_, labels, a_, jcfg),
                                  argnums=(0, 1))(z, jnp.float32(alpha))

    wants = [grads(supcon_binary_loss_pallas), grads(jax_supcon)]
    zt = torch.from_numpy(z).requires_grad_()
    at = torch.tensor(alpha, requires_grad=True)
    before = supcon.launches
    loss = supcon.supcon_binary_loss_fused(zt, torch.from_numpy(labels), at,
                                           SupConConfig(**kw))
    gz, ga = torch.autograd.grad(loss, (zt, at))
    assert supcon.launches == before
    for want_loss, (want_gz, want_ga) in wants:
        # fp32 both sides; the tolerances of tests/test_supcon_pallas.py
        assert loss.item() == pytest.approx(float(want_loss), rel=2e-5,
                                            abs=2e-5)
        np.testing.assert_allclose(gz.numpy(), np.asarray(want_gz),
                                   rtol=5e-4, atol=5e-6)
        assert ga.item() == pytest.approx(float(want_ga), rel=5e-4, abs=5e-6)


def test_supcon_wrapper_checks_shapes():
    with pytest.raises(ValueError, match="labels"):
        supcon.supcon_binary_loss_fused(torch.zeros(4, 3),
                                        torch.zeros(5, dtype=torch.long), 0.0)


def _problem(seed=0):
    rng = np.random.default_rng(seed)
    params = {"w": rng.normal(0, 1, (7, 5)).astype(np.float32),
              "b": rng.normal(0, 1, (5,)).astype(np.float32)}
    grads = [{k: rng.normal(0, s, v.shape).astype(np.float32)
              for k, v in params.items()} for s in (1.0, 0.3, 2.0, 0.01)]
    return params, grads


@pytest.mark.parametrize("storage,clip", [("bfloat16", None),
                                          ("float32", None),
                                          ("bfloat16", 0.5)])
def test_adamw_matches_optax(storage, clip):
    params, grads = _problem()
    dt = jnp.bfloat16 if storage == "bfloat16" else None
    tx = adamw_storage_dtypes(1e-2, weight_decay=3e-3, mu_dtype=dt,
                              nu_dtype=dt, force_core=True)
    if clip is not None:
        tx = optax.chain(optax.clip_by_global_norm(clip), tx)
    state = tx.init(params)
    jp = params
    for g in grads:
        upd, state = tx.update(g, state, jp)
        jp = optax.apply_updates(jp, upd)

    tp = [torch.nn.Parameter(torch.from_numpy(params[k].copy()))
          for k in ("w", "b")]
    tdt = getattr(torch, storage)
    grp = AdamWGroup(tp, 1e-2, 3e-3, tdt, tdt, clip=clip)
    for g in grads:
        for p, k in zip(tp, ("w", "b")):
            p.grad = torch.from_numpy(g[k])
        grp.step()
    assert grp.mu[0].dtype == tdt and grp.nu[0].dtype == tdt
    # the same fp32 math and bf16 storage; rounding of a few fp32 ops
    for p, k in zip(tp, ("w", "b")):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("epoch", [1, 100, 101, 140, 180, 500])
def test_alpha_schedule_matches_jax(epoch):
    assert alpha_for_epoch(epoch, 100, 80, 1.0) == \
        jax_alpha_for_epoch(epoch, 100, 80, 1.0)
