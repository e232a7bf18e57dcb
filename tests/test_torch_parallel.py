"""The port's parallel layer in one process: the dropout hashes in global
coordinates, the shard-aware encoder draws, the Megatron rules over the
port's HF names, the mesh checks, the per-rank batch slice, the GPipe
executor with one stage against the plain layer loop, the layout
refusals the JAX package makes, the layout config fields and the CLI
flags (the multi-process runs are tests/test_torch_multiprocess.py)."""

import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

from jax.sharding import PartitionSpec as P

from wav2vec_contr_loss_tpu.parallel import (
    param_sharding_rules as jax_rules)

from tests.test_torch_bridge import cap_torch_threads
from wav2vec_contr_loss_torch import Stage1Config, Stage1Trainer
from wav2vec_contr_loss_torch.bridge import (jax_params_to_torch,
                                             random_jax_trees)
from wav2vec_contr_loss_torch.cli import train_baseline, train_stage1
from wav2vec_contr_loss_torch.models.compression import CompressionModule
from wav2vec_contr_loss_torch.ops import attention
from wav2vec_contr_loss_torch.ops.dropout import (attention_dropout_mask,
                                                  murmur_bits,
                                                  murmur_dropout)
from wav2vec_contr_loss_torch.parallel import mp_smoke
from wav2vec_contr_loss_torch.parallel.collectives import Shard, set_shard
from wav2vec_contr_loss_torch.parallel.mesh import (check_layout, local_batch,
                                                    make_mesh,
                                                    param_sharding_rules)
from wav2vec_contr_loss_torch.parallel.pipeline import gpipe_stack
from wav2vec_contr_loss_torch.train.core import device_rawboost

cap_torch_threads()


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_murmur_bits_with_offsets_are_the_global_slice(axis):
    shape = (6, 5, 8)
    full = murmur_bits(shape, 1234)
    for start, stop in ((0, 2), (2, 5), (1, 2)):
        if stop > shape[axis]:
            continue
        sub = list(shape)
        sub[axis] = stop - start
        offsets = [0, 0, 0]
        offsets[axis] = start
        want = full.narrow(axis, start, stop - start)
        assert torch.equal(murmur_bits(sub, 1234, offsets=offsets), want)
    # a unit slice away from the origin keeps its index term
    one = [0, 0, 0]
    one[axis] = 3
    sub = list(shape)
    sub[axis] = 1
    assert torch.equal(murmur_bits(sub, 1234, offsets=one),
                       full.narrow(axis, 3, 1))


def test_murmur_dropout_offsets_slice_both_axes():
    x = torch.randn(4, 3, 16)
    full = murmur_dropout(x, 77, 0.3)
    part = murmur_dropout(x[2:4, :, 8:16], 77, 0.3, (2, 0, 8))
    assert torch.equal(part, full[2:4, :, 8:16])


def test_attention_mask_with_seed_stride_is_the_global_slice():
    """A (b, h) shard at batch b0 and head h0 of a (B, H) grid passes
    seed + b0*H + h0 and stride H: its mask is the global mask's slice."""
    b, h, t = 5, 8, 13
    full = attention_dropout_mask(b, h, t, 99, 0.2)
    assert torch.equal(attention_dropout_mask(b, h, t, 99, 0.2,
                                              seed_stride=h), full)
    for b0, nb, h0, nh in ((2, 3, 4, 4), (0, 1, 0, 2), (4, 1, 6, 2)):
        got = attention_dropout_mask(nb, nh, t, 99 + b0 * h + h0, 0.2,
                                     seed_stride=h)
        assert torch.equal(got, full[b0:b0 + nb, h0:h0 + nh])


def test_plain_attention_with_seed_stride_is_the_global_slice():
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(4, 6, 9, 8, generator=g) for _ in range(3))
    bias = torch.zeros(4, 9)
    full = attention.fused_attention(q, k, v, bias, 5, 0.25, 6)
    got = attention.fused_attention(q[1:3, 2:5], k[1:3, 2:5], v[1:3, 2:5],
                                    bias[1:3], 5 + 1 * 6 + 2, 0.25, 3,
                                    seed_stride=6)
    assert torch.equal(got, full[1:3, 2:5])


def _tiny():
    return mp_smoke.encoder_config(True), mp_smoke.Job()


def test_encoder_draws_in_global_coordinates():
    """Train mode with every dropout and SpecAugment on: the forward of
    rows 4-7 as data rank 1 of 2 equals rows 4-7 of the global forward,
    from generators in the same state."""
    from wav2vec_contr_loss_torch.models.wav2vec2 import Wav2Vec2Encoder

    cfg, job = _tiny()
    sd = jax_params_to_torch(cfg, *random_jax_trees(cfg, comp_dim=16))
    enc = Wav2Vec2Encoder(cfg)
    enc.load_state_dict(sd["encoder"])
    enc.train()
    wave = torch.from_numpy(mp_smoke.fixed_batches(job, 1)[0]["waveforms"])
    with torch.no_grad():
        full = enc(wave, gen=torch.Generator().manual_seed(3))["layer_mean"]
        set_shard(enc, Shard(data_rank=1, n_data=2))
        part = enc(wave[4:8], gen=torch.Generator().manual_seed(3)
                   )["layer_mean"]
    torch.testing.assert_close(part, full[4:8], rtol=1e-5, atol=1e-6)


def test_compression_and_rawboost_draws_in_global_coordinates():
    comp = CompressionModule(8, 4, 0.3).train()
    x = torch.randn(6, 5, 8)
    full = comp(x, gen=torch.Generator().manual_seed(1))
    comp.shard = Shard(data_rank=2, n_data=3)
    part = comp(x[4:6], gen=torch.Generator().manual_seed(1))
    assert torch.equal(part, full[4:6])

    cfg = Stage1Config()
    waves = torch.randn(4, 4000) * 0.1

    def run(w, shard):
        return device_rawboost(w, torch.Generator().manual_seed(5),
                               torch.Generator(), 1.0,
                               cfg.rawboost_params(), shard)
    full = run(waves, Shard())
    assert torch.equal(run(waves[2:4], Shard(data_rank=1, n_data=2)),
                       full[2:4])


def test_param_sharding_rules_mirror_the_jax_layout():
    """The port's rules over HF names put 'model' on the axis the JAX
    rules put it on (the torch weight is the JAX kernel transposed)."""
    cases = {  # HF name -> the JAX path of the same parameter
        "encoder.layers.0.attention.q_proj.weight":
            "layers/layer/attention/q_proj/kernel",
        "encoder.layers.3.attention.v_proj.bias":
            "layers/layer/attention/v_proj/bias",
        "encoder.layers.0.attention.out_proj.weight":
            "layers/layer/attention/out_proj/kernel",
        "encoder.layers.1.feed_forward.intermediate_dense.weight":
            "layers/layer/feed_forward/intermediate_dense/kernel",
        "encoder.layers.1.feed_forward.intermediate_dense.bias":
            "layers/layer/feed_forward/intermediate_dense/bias",
        "encoder.layers.0.feed_forward.output_dense.weight":
            "layers/layer/feed_forward/output_dense/kernel",
        "encoder.layers.0.attention.out_proj.bias":
            "layers/layer/attention/out_proj/bias",
        "encoder.layers.0.layer_norm.weight": "layers/layer/layer_norm/scale",
        "proj.weight": "compression/proj/kernel",
    }
    for name, path in cases.items():
        spec = tuple(jax_rules(path, 3, True))
        # JAX: (L, in, out) stacked kernels, (L, out) biases
        want = None
        if "model" in spec:
            axis = spec.index("model") - 1          # drop the layer axis
            ndim = 2 if path.endswith("kernel") else 1
            want = (ndim - 1 - axis) if ndim == 2 else 0
        assert param_sharding_rules(name, True) == want, name
        assert param_sharding_rules(name, False) is None
    assert jax_rules("compression/proj/kernel", 2, True) == P()


@pytest.fixture
def one_process_group():
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                            f"{mp_smoke.free_port()}", world_size=1, rank=0)
    yield
    dist.destroy_process_group()


def test_make_mesh_shapes(one_process_group):
    mesh = make_mesh()
    assert mesh.mesh_dim_names == ("data", "model")
    assert tuple(mesh.shape) == (1, 1)
    assert mesh.device_type == "cpu"
    with pytest.raises(ValueError, match="not divisible"):
        make_mesh(n_model=2)
    with pytest.raises(ValueError, match=r"mesh 3x2 != 1"):
        make_mesh(n_data=3, n_model=2)


def test_make_mesh_needs_the_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh()


def test_local_batch_slices_rows_and_refuses_a_ragged_batch():
    batch = {"waveforms": np.arange(24).reshape(8, 3),
             "labels": torch.arange(8)}
    got = local_batch(batch, Shard(data_rank=1, n_data=4))
    assert np.array_equal(got["waveforms"], batch["waveforms"][2:4])
    assert torch.equal(got["labels"], torch.tensor([2, 3]))
    with pytest.raises(ValueError, match="not divisible"):
        local_batch(batch, Shard(data_rank=0, n_data=3))


def test_layout_config_fields_round_trip_through_the_sidecar(tmp_path):
    cfg, job = _tiny()
    s1 = mp_smoke.stage1_config(job, True, "fsdp", pipeline_microbatches=4)
    trainer = Stage1Trainer(s1, cfg, mp_smoke.initial_weights(cfg, 16),
                            device="cpu")
    from wav2vec_contr_loss_torch.train import checkpoint as ckpt

    ckpt.save_checkpoint(str(tmp_path), "latest", trainer.state_dict(),
                         s1.ckpt_config(), {}, trainer._sidecar_extra())
    back = Stage1Trainer.from_checkpoint(str(tmp_path), "latest",
                                         device="cpu")
    assert back.cfg == s1
    assert (back.cfg.param_sharding, back.cfg.pipeline_microbatches,
            back.cfg.sequence_parallel) == ("fsdp", 4, False)
    # a sidecar naming a layout the port does not run restores replicated
    extra = trainer._sidecar_extra()
    extra["stage1_config"] = dataclasses.asdict(
        s1.replace(param_sharding="replicated")) | {"param_sharding": "pp"}
    ckpt.save_checkpoint(str(tmp_path), "jax", trainer.state_dict(),
                         s1.ckpt_config(), {}, extra)
    back = Stage1Trainer.from_checkpoint(str(tmp_path), "jax", device="cpu")
    # the port runs 'pp' now: the sidecar's layout comes back as it was
    # (the JAX package would refuse pp with sequence parallelism)
    assert (back.cfg.param_sharding, back.cfg.sequence_parallel) == (
        "pp", False)
    # the JAX package's refusals: pp with sequence parallelism, and a
    # batch that the microbatches do not divide
    with pytest.raises(ValueError, match="pick one"):
        Stage1Trainer(s1.replace(param_sharding="pp", sequence_parallel=True),
                      cfg, mp_smoke.initial_weights(cfg, 16), device="cpu")
    with pytest.raises(ValueError, match="not divisible by "
                                         "pipeline_microbatches=3"):
        Stage1Trainer(s1.replace(param_sharding="pp",
                                 pipeline_microbatches=3), cfg,
                      mp_smoke.initial_weights(cfg, 16), device="cpu")


def test_cli_layout_flags_parse():
    args = train_stage1.build_parser().parse_args(
        ["--param_sharding", "fsdp", "--mesh_model", "2", "--multihost", "1",
         "--pipeline_microbatches", "4", "--sequence_parallel", "0"])
    cfg = train_stage1.config_from_args(args)
    assert (cfg.param_sharding, cfg.pipeline_microbatches,
            cfg.sequence_parallel) == ("fsdp", 4, False)
    assert (args.mesh_model, args.multihost) == (2, 1)
    args = train_baseline.build_parser().parse_args(
        ["--param_sharding", "fsdp", "--multihost", "0"])
    assert (args.param_sharding, args.multihost) == ("fsdp", 0)


@pytest.mark.parametrize("cli,argv,why", [
    # the JAX package's own refusals (pp with sequence parallelism, a
    # batch of 32 that 3 microbatches do not divide, and pp with fsdp,
    # which one --param_sharding cannot name: the fsdp-only baseline)
    (train_stage1, ["--param_sharding", "pp", "--sequence_parallel", "1"],
     "pick one"),
    (train_stage1, ["--param_sharding", "pp", "--pipeline_microbatches",
                    "3"], "not divisible by pipeline_microbatches=3"),
    (train_stage1, ["--param_sharding", "pp", "--pipeline_microbatches",
                    "0"], "must be >= 1"),
    (train_baseline, ["--param_sharding", "pp"], "no pipeline layout"),
    (train_stage1, ["--mesh_model", "2"], "needs a gang"),
])
def test_cli_refuses_unported_layouts_with_exit_2(cli, argv, why, capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(argv + ["--device", "cpu"])
    assert e.value.code == 2
    assert why in capsys.readouterr().err


def test_check_layout_refuses_what_jax_refuses():
    """The JAX package's refusals of a layout (mesh.py:151-153,
    wav2vec2.py:619-622, pipeline.py:98-101)."""
    with pytest.raises(ValueError, match="pipeline and fsdp"):
        check_layout(fsdp=True, pipeline=True)
    with pytest.raises(ValueError, match="sequence_parallel"):
        check_layout(pipeline=True, sequence_parallel=True)
    with pytest.raises(ValueError, match="batch 8 not divisible"):
        check_layout(pipeline=True, microbatches=3, batch=8)
    check_layout(fsdp=True, sequence_parallel=True)   # they compose
    check_layout(pipeline=True, microbatches=4, batch=8)


@pytest.mark.parametrize("n_micro", [1, 2, 4])
def test_gpipe_stack_toy_linear(n_micro):
    """The executor with one stage (no 'model' group), as JAX's
    test_gpipe_stack_toy_linear: elementwise 'layers' h -> h*w give
    prod(w) through the pipe, the layer sum matches the running sum,
    and the gradient agrees with the dense formula."""
    L, D, B = 4, 3, 8
    W = (torch.arange(1, L * D + 1, dtype=torch.float64).reshape(L, D)
         / (L * D)).requires_grad_()
    x = torch.from_numpy(np.random.default_rng(0).normal(1, 0.1, (B, D)))
    seen = []

    def layer_fn(i, h, consts, m):
        seen.append((i, m))
        assert consts[0].shape == (B // n_micro, 1)
        return h * W[i]

    h, total = gpipe_stack(layer_fn, L, x, (torch.zeros(B, 1),), Shard(),
                           n_micro, sum_dtype=torch.float64)
    ref_h = x * W.prod(0)
    ref_s = sum(x * W[:i + 1].prod(0) for i in range(L))
    torch.testing.assert_close(h, ref_h, rtol=1e-12, atol=0)
    torch.testing.assert_close(total, ref_s, rtol=1e-12, atol=0)
    assert seen == [(i, m) for m in range(n_micro) for i in range(L)]
    g, = torch.autograd.grad(h.sum(), W)
    g_ref, = torch.autograd.grad(ref_h.sum(), W)
    torch.testing.assert_close(g, g_ref, rtol=1e-12, atol=0)


def test_gpipe_stack_refusals():
    """JAX's refusals: layers that the stages do not divide, and a batch
    that the microbatches do not divide."""
    fn = lambda i, h, c, m: h   # noqa: E731
    with pytest.raises(ValueError, match="batch 4 not divisible by "
                                         "n_micro=3"):
        gpipe_stack(fn, 4, torch.ones(4, 3), (), Shard(), 3)
    with pytest.raises(ValueError, match="3 layers not divisible by 2 "
                                         "pipeline stages"):
        gpipe_stack(fn, 3, torch.ones(4, 3), (),
                    Shard(n_model=2, model_group=object()), 2)
