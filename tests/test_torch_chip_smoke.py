"""chip_smoke.py's CPU-reachable parts: its seeded random weights have
exactly the JAX package's tree layout, and its serving path and its train
phase's model run at the XLS-R-300M widths (depth cut to one or two
layers, 1 s clips) on the CPU, and the front-door phase's helpers run at
a small width on the CPU, and the artifact and int8 phase's at XLS-R-300M
width, one layer, and the parallel phase's leg B (the launcher, the leg
configs, the update cosines, the checkpoint restore) at tiny width on
the CPU over Gloo."""

import threading

import numpy as np
import pytest
import torch

import jax

from chip_smoke import (BENCH_LEGS, LEG_B, LEG_PP, PARALLEL_GRAD_COS,
                        PARALLEL_NORM_RTOL, bench_expected, check_bench,
                        run_bench_legs,
                        PARALLEL_UPDATE_COS, norm_ratios,
                        QUANT_REL_TOL, _rel,
                        baseline_weights, parallel_leg_b,
                        pp_launches, update_cosines,
                        client_requests, compare_converted,
                        convert_front_door, expected_extract_launches,
                        expected_train_launches, int8_bytes,
                        quant_cpu_reference, random_jax_trees,
                        reference_logits, run_clients, serving_waves,
                        train_batch, ulps, write_corpus,
                        write_front_door_corpus, write_reference_files)
from tests.test_torch_bridge import jax_config, jax_trees, port_config
from wav2vec_contr_loss_torch import (XLSR_300M, BaselineConfig,
                                      BaselineTrainer, SpoofScorer,
                                      Stage1Config, Stage1Trainer,
                                      Stage2Config, jax_params_to_torch)
from wav2vec_contr_loss_torch.data import (AudioConfig, BatchPipeline,
                                           parse_asvspoof2019)
from wav2vec_contr_loss_torch.ops import attention, conv_ln, supcon

from tests.test_torch_bridge import cap_torch_threads

cap_torch_threads()


def _shapes(tree):
    return jax.tree_util.tree_map(np.shape, tree)


@pytest.mark.parametrize("variant,head_type", [("xlsr", "linear"),
                                               ("large960h", "mlp")])
def test_random_trees_have_the_jax_layout(variant, head_type):
    cfg = jax_config(variant)
    want = jax_trees(cfg, head_type)
    got = random_jax_trees(port_config(cfg), comp_dim=16, head_type=head_type,
                           head_hidden=8)
    for w, g in zip(want, got):
        assert _shapes(g) == _shapes(w)
        assert all(a.dtype == np.float32
                   for a in jax.tree_util.tree_leaves(g))


def test_serving_path_at_xlsr_width_on_cpu():
    cfg = XLSR_300M.with_(num_layers=1, dtype="float32")
    scorer = SpoofScorer(cfg, jax_params_to_torch(cfg, *random_jax_trees(cfg)),
                         Stage2Config(), max_duration_seconds=1, device="cpu")
    waves = serving_waves(np.random.default_rng(0), 1)[0, [0, 1, 7], :16000]
    waves[1, 9000:] = 0.0         # padded; row 2 is the all-zero clip
    before = attention.launches, conv_ln.launches
    logits = scorer.score_waveforms(waves)
    assert (attention.launches, conv_ln.launches) == before
    assert logits.shape == (3,) and np.isfinite(logits).all()


def test_train_phase_model_steps_on_cpu():
    """The train phase's trainer (Stage1Config defaults with
    finetune_encoder=True, use_rawboost=False: dropout, SpecAugment and
    remat on) at XLS-R-300M width, 2 layers, fp32, 4 clips of 1 s."""
    cfg = XLSR_300M.with_(num_layers=2)
    scfg = Stage1Config(finetune_encoder=True, use_rawboost=False,
                        compute_dtype="float32", grad_dtype="float32")
    trainer = Stage1Trainer(scfg, cfg, jax_params_to_torch(
        cfg, *random_jax_trees(cfg)), device="cpu")
    batch = train_batch(np.random.default_rng(0), 4, 16000)
    before = (attention.launches, attention.bwd_launches, conv_ln.launches,
              conv_ln.bwd_launches, supcon.launches)
    losses = [trainer.train_step(batch, 1.0)["loss"].item()
              for _ in range(2)]
    assert before == (attention.launches, attention.bwd_launches,
                      conv_ln.launches, conv_ln.bwd_launches, supcon.launches)
    assert np.isfinite(losses).all()
    assert trainer.compression.proj.weight.grad is not None
    assert expected_train_launches(scfg, cfg) == {
        "attention_fwd": 4, "attention_bwd": 2, "ln_gelu_fwd": 7,
        "ln_gelu_bwd": 7, "supcon": 1}


def test_baseline_phase_model_steps_on_cpu():
    """The baseline phase's trainer (BaselineConfig's defaults: dropout,
    SpecAugment, remat, device RawBoost and the clip over every gradient)
    at XLS-R-300M width, 2 layers, fp32, 4 clips of 1 s, from
    `baseline_weights`; and the per-step launch counts the phase expects
    on the card at full depth: no SupCon."""
    cfg = XLSR_300M.with_(num_layers=2)
    bcfg = BaselineConfig(compute_dtype="float32", max_duration_seconds=1)
    weights = baseline_weights(cfg)
    assert weights["classifier"]["weight"].shape == (1, 256)
    trainer = BaselineTrainer(bcfg, cfg, weights, device="cpu")
    batch = train_batch(np.random.default_rng(0), 4, 16000)
    before = (attention.launches, attention.bwd_launches, conv_ln.launches,
              conv_ln.bwd_launches, supcon.launches)
    losses = [trainer.train_step(batch)["loss"].item() for _ in range(2)]
    assert before == (attention.launches, attention.bwd_launches,
                      conv_ln.launches, conv_ln.bwd_launches, supcon.launches)
    assert np.isfinite(losses).all()
    assert trainer.classifier.weight.grad is not None
    assert expected_train_launches(BaselineConfig(), XLSR_300M,
                                   supcon=0) == {
        "attention_fwd": 48, "attention_bwd": 24, "ln_gelu_fwd": 7,
        "ln_gelu_bwd": 7, "supcon": 0}


def test_pipeline_phase_extraction_on_cpu(tmp_path):
    """The pipeline phase's extraction: `embed_dataset` of a full-width
    trainer (1 layer, fp32, 1 s clips) over 5 clips at batch 4 (a padded
    last batch), and the per-batch launch counts it expects on the card."""
    cfg = XLSR_300M.with_(num_layers=1)
    scfg = Stage1Config(compute_dtype="float32", max_duration_seconds=1)
    trainer = Stage1Trainer(scfg, cfg, jax_params_to_torch(
        cfg, *random_jax_trees(cfg)), device="cpu")
    proto = write_corpus(str(tmp_path), 5, seed=1, seconds=1.0)
    pipe = BatchPipeline(parse_asvspoof2019(proto, str(tmp_path),
                                            audio=AudioConfig(16000, 1)),
                         4, num_workers=2)
    z, y = trainer.embed_dataset(pipe)
    assert z.shape == (5, 256) and np.isfinite(z).all()
    np.testing.assert_array_equal(y, [1, 0, 1, 0, 1])
    assert expected_extract_launches(XLSR_300M, 4) == {
        "attention_fwd": 96, "attention_bwd": 0, "ln_gelu_fwd": 28,
        "ln_gelu_bwd": 0, "supcon": 0}


def test_front_door_helpers_on_cpu(tmp_path):
    """The front-door phase at a small width on the CPU: the reference
    files written by the port's writers convert back through the CLIs to
    the original tensors (the positional conv within one ulp), and
    ScoringServer answers 3 clients' bare and tagged lines over a FLAC and
    WAV corpus and a missing path, each once, with the scorer's logits."""
    from wav2vec_contr_loss_torch.data import AudioLoader
    from wav2vec_contr_loss_torch.eval.server import ScoringServer

    cfg = port_config(jax_config("xlsr"))
    weights = jax_params_to_torch(cfg, *random_jax_trees(cfg, comp_dim=16))
    files = write_reference_files(str(tmp_path), cfg, weights, "test/small")
    dirs = convert_front_door(str(tmp_path), files, hf_config=str(
        tmp_path / "hf_snapshot" / "config.json"))
    cmp = compare_converted(weights, dirs)
    # encoder_init, stage1 and stage1_frozen each hold one pos-conv kernel
    assert cmp["bit_equal"] >= cmp["tensors"] - 3
    assert cmp["pos_conv_off"] < cmp["pos_conv_elems"]
    a = torch.tensor([1.0, -2.0, 0.5])
    b = torch.nextafter(a, torch.tensor(10.0))
    assert ulps(a, b).tolist() == [1, 1, 1] and ulps(a, a).sum() == 0

    corpus = tmp_path / "corpus"
    corpus.mkdir()
    paths = write_front_door_corpus(str(corpus), 6, seed=3,
                                    seconds=(0.5, 1.5))
    assert sum(p.endswith(".flac") for p in paths) == 3
    served = paths + [str(corpus / "missing.flac")]
    scorer = SpoofScorer.from_checkpoints(dirs["stage1"], dirs["stage2"],
                                          device="cpu",
                                          compute_dtype="float32")
    server = ScoringServer(scorer, "127.0.0.1", 0, batch=4, max_wait_ms=5,
                           log_fn=lambda m: None)
    thread = threading.Thread(target=server.serve_forever)
    failed0 = AudioLoader.failed_count
    thread.start()
    try:
        requests = client_requests(served, 3)
        assert any("\t" in r for r in requests[0])
        replies, lat, _ = run_clients(server.address, requests)
    finally:
        stats = server.shutdown()
        thread.join(timeout=60)
    assert not thread.is_alive()
    assert AudioLoader.failed_count - failed0 == 1
    assert stats["clips"] == len(served) == len(lat)
    got = np.array([replies[r] for c in requests for r in c])
    order = [r.partition("\t")[2] or r for c in requests for r in c]
    ref = reference_logits(scorer, order, 4)
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_artifact_phase_helpers_at_xlsr_width_on_cpu(tmp_path):
    """The artifact and int8 phase at XLS-R-300M width, depth cut to one
    layer, 1 s clips: the fp32 CPU references of the three modes (the
    quantization error within JAX's bounds), the int8 bytes of a
    quantized scorer, and a w8a8 artifact written, loaded and run."""
    from wav2vec_contr_loss_torch.eval.artifact import load_exported

    cfg = XLSR_300M.with_(num_layers=1)
    weights = jax_params_to_torch(cfg, *random_jax_trees(cfg))
    waves = serving_waves(np.random.default_rng(1), 1)[0, :2, :16000]
    ref = quant_cpu_reference(cfg, weights, waves)
    assert set(ref) == {"none", "w8", "w8a8"}
    for mode, (lm, z, logits) in ref.items():
        assert lm.shape == (2, 49, 1024) and z.shape == (2, 256)
        assert logits.shape == (2,) and torch.isfinite(logits).all()
        if mode != "none":
            assert 0.0 < _rel(lm, ref["none"][0]) <= QUANT_REL_TOL[mode]
    scorer = SpoofScorer(cfg.with_(dtype="float32"), weights, Stage2Config(),
                         max_duration_seconds=1, device="cpu",
                         quantize="w8a8")
    # 4 square attention linears and the two FFN linears of one layer
    assert int8_bytes(scorer) == 4 * 1024 ** 2 + 2 * 1024 * 4096
    path = tmp_path / "w8a8.w2vexport"
    path.write_bytes(scorer.export(2))
    assert path.stat().st_size < sum(
        t.numel() * 4 for t in weights["encoder"].values())
    loaded = load_exported(str(path))
    np.testing.assert_allclose(loaded(waves).numpy(), ref["w8a8"][2].numpy(),
                               atol=1e-5)


def test_parallel_leg_configs():
    from wav2vec_contr_loss_torch.parallel import mp_smoke

    assert set(LEG_B) <= set(mp_smoke.LEGS)
    job = mp_smoke.Job.named("wide")
    assert (job.batch, job.sr * job.seconds) == (16, 32000)
    cfg = mp_smoke.encoder_config(True, "wide")
    assert (cfg.hidden_size, cfg.num_heads, cfg.intermediate_size,
            cfg.num_layers, cfg.dtype) == (1024, 16, 4096, 4, "bfloat16")
    assert cfg.apply_spec_augment and cfg.attention_dropout == 0.1
    scfg = mp_smoke.stage1_config(job, True, "fsdp")
    assert (scfg.compute_dtype, scfg.use_rawboost, scfg.param_sharding,
            scfg.input_dim) == ("bfloat16", True, "fsdp", 1024)
    # per rank a step: 4 layers with remat, 7 convs, one SupCon on the
    # gathered batch
    assert expected_train_launches(scfg, cfg) == {
        "attention_fwd": 8, "attention_bwd": 4, "ln_gelu_fwd": 7,
        "ln_gelu_bwd": 7, "supcon": 1}
    # the pipeline leg: XLS-R-300M whole at B = 32 x 5 s, 3 steps, two
    # stages; per rank a step 12 layers x 4 microbatches, twice with remat
    assert set(LEG_PP) <= {"extract", *mp_smoke.LEGS}
    job = mp_smoke.Job.named("full")
    assert (job.batch, job.sr * job.seconds, job.steps) == (32, 80000, 3)
    cfg = mp_smoke.encoder_config(True, "full")
    assert (cfg.num_layers, cfg.hidden_size, cfg.num_heads) == (24, 1024, 16)
    scfg = mp_smoke.stage1_config(job, True, "pp", **mp_smoke.PP)
    assert pp_launches(scfg, cfg, 2) == {
        "attention_fwd": 96, "attention_bwd": 48, "ln_gelu_fwd": 7,
        "ln_gelu_bwd": 7, "supcon": 1}


def test_update_cosines_group_by_name():
    start = {"encoder.feature_projection.layer_norm.weight": torch.zeros(3),
             "encoder.encoder.layers.0.attention.q_proj.weight":
                 torch.zeros(4),
             "encoder.encoder.layers.0.layer_norm.bias": torch.zeros(2),
             "compression.proj.weight": torch.zeros(2),
             "encoder.masked_spec_embed": torch.zeros(2)}
    got = {k: torch.arange(1.0, v.numel() + 1) for k, v in start.items()}
    flip = dict(got, **{"compression.proj.weight": -got[
        "compression.proj.weight"]})
    cos = update_cosines(start, got, flip)
    assert set(cos) == {"feature_projection", "attention", "layer_norm",
                        "compression"}
    assert cos["attention"] == pytest.approx(1.0)
    assert cos["compression"] == pytest.approx(-1.0)


def test_norm_ratios_group_by_name():
    want = {"encoder.encoder.layers.0.attention.q_proj.weight":
                torch.tensor([3.0, 4.0]),
            "encoder.encoder.layers.1.attention.k_proj.weight":
                torch.zeros(2),
            "compression.proj.weight": torch.tensor([1.0, 0.0]),
            "encoder.masked_spec_embed": torch.ones(2)}
    got = dict(want, **{"compression.proj.weight": torch.tensor([0.0, 2.0])})
    assert norm_ratios(got, want) == {"attention": pytest.approx(1.0),
                                      "compression": pytest.approx(2.0)}


def test_parallel_leg_b_on_cpu(tmp_path):
    """Leg B end to end at tiny width on the CPU: the 2-rank gang started
    behind its go file, its dp, tp and fsdp steps against one process,
    the gradient and update cosines, the gradient norms, and the
    tensor-parallel checkpoint restored bit for bit."""
    out = parallel_leg_b(torch.device("cpu"), str(tmp_path), width="tiny")
    assert set(out["leg_b"]) == set(LEG_B)
    for leg in LEG_B:
        assert out["leg_b"][leg]["min_update_cos"] >= PARALLEL_UPDATE_COS
        assert out["leg_b"][leg]["min_grad_cos"] >= PARALLEL_GRAD_COS
        assert out["leg_b"][leg]["max_norm_dev"] <= PARALLEL_NORM_RTOL
        assert len(out["leg_b"][leg]["losses"]) == 2   # the tiny job's


def test_bench_phase_helpers_on_cpu():
    """The bench phase's legs at tiny sizes on the CPU, through a leg
    function and through the command's `main`, where every wrapper runs
    its plain version and counts nothing; its exact launch counts at the
    phase's sizes; its checks refuse a miscount and a non-finite
    number."""
    legs = (("decode", "bench_decode", dict(n_files=4, seconds=1,
                                            repeats=1)),
            ("supcon", "bench_supcon", dict(batch=32, dim=16, repeats=2)),
            ("serving", "main", ["--which", "serving", "--serving_model",
                                 "tiny", "--serving_batch", "2",
                                 "--serving_seconds", "1",
                                 "--serving_repeats", "2"]))
    out, counts, secs = run_bench_legs(torch.device("cpu"), legs)
    assert set(out) == set(counts) == set(secs) == {"decode", "supcon",
                                                    "serving"}
    assert all(n == 0 for c in counts.values() for n in c.values())
    assert out["supcon"]["supcon_cuda_steps_per_sec"] is None
    assert out["serving"]["serving_batch"] == 2
    check_bench(out, counts, {}, XLSR_300M)

    want = bench_expected(BENCH_LEGS, XLSR_300M)
    zero = dict.fromkeys(counts["decode"], 0)
    # serving: 3 x (30 + 1) batches, w8a8 3 x (10 + 1); extract:
    # 3 x (10 + 1); supcon in 'all' 50 + 1
    assert want["serving"] == dict(zero, attention_fwd=24 * 93,
                                   ln_gelu_fwd=7 * 93)
    assert want["serving_w8a8"] == dict(zero, attention_fwd=24 * 33,
                                        ln_gelu_fwd=7 * 33)
    assert want["extract"] == dict(zero, attention_fwd=24 * 33,
                                   ln_gelu_fwd=7 * 33)
    assert want["all"] == dict(zero, supcon=51)
    assert "socket" not in want
    with pytest.raises(RuntimeError, match="bench serving: launches"):
        check_bench(out, counts, {"serving": want["serving"]}, XLSR_300M)
    with pytest.raises(RuntimeError, match="bench socket: launches"):
        check_bench(out, dict(counts, socket=dict(zero, attention_fwd=72,
                                                  ln_gelu_fwd=20)),
                    {}, XLSR_300M)
    with pytest.raises(RuntimeError, match="serving_p50_ms"):
        check_bench(dict(out, serving=dict(out["serving"],
                                           serving_p50_ms=float("nan"))),
                    counts, {}, XLSR_300M)
