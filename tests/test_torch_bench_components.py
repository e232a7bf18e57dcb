"""The port's `bench_components` against the JAX command's functions on
the CPU at a tiny size (`--device cpu`): the same JSON keys (the two
SupCon keys mapped) and the same non-timing fields at the same
arguments, every number finite and above 0; the bench's tiny scorer
against the JAX `SpoofScorer` on the same seeded trees; the port's
native batch decode against the JAX package's and its own per-file
decode, bit for bit; the command's one JSON line."""

import ctypes
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from wav2vec_contr_loss_tpu.cli import bench_components as jax_bench
from wav2vec_contr_loss_tpu.config import Stage1Config as JaxStage1Config
from wav2vec_contr_loss_tpu.config import Stage2Config as JaxStage2Config
from wav2vec_contr_loss_tpu.data.audio import _native_decoder
from wav2vec_contr_loss_tpu.eval import server as jax_server
from wav2vec_contr_loss_tpu.eval.serving import SpoofScorer as JaxScorer
from wav2vec_contr_loss_tpu.models.wav2vec2 import Wav2Vec2Config as JaxConfig
from wav2vec_contr_loss_tpu.train import Stage1Trainer as JaxTrainer

from tests.flac_writer import write_flac
from tests.test_torch_bridge import cap_torch_threads, port_config
from wav2vec_contr_loss_torch.bridge import random_jax_trees
from wav2vec_contr_loss_torch.cli import bench_components as bench
from wav2vec_contr_loss_torch.data import audio

cap_torch_threads()

SR = 16000
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the JAX command's tiny encoder (bench_components.py:291-296)
JAX_TINY = JaxConfig(
    hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
    conv_dim=(16, 16), conv_kernel=(10, 3), conv_stride=(5, 2),
    num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
    apply_spec_augment=False)

# port key -> JAX key where the names differ
SUPCON_KEYS = {"supcon_plain_steps_per_sec": "supcon_xla_steps_per_sec",
               "supcon_cuda_steps_per_sec": "supcon_pallas_steps_per_sec"}


@pytest.fixture
def wake_jax_accept(monkeypatch):
    """The JAX server's accept loop outlives its shutdown on Linux (its
    request_stop only closes the socket), so each JAX socket leg would
    wait out its 30 s join; shut the socket down first, as the port's
    request_stop does. What the JAX server computes is unchanged."""
    stop = jax_server.ScoringServer.request_stop

    def request_stop(self):
        import socket

        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        stop(self)

    monkeypatch.setattr(jax_server.ScoringServer, "request_stop",
                        request_stop)


# leg -> (JAX call, port call, fields that are not timings)
LEGS = {
    "decode": (lambda: jax_bench.bench_decode(n_files=8, seconds=1,
                                              repeats=1),
               lambda: bench.bench_decode(n_files=8, seconds=1, repeats=1),
               ()),
    "rawboost": (lambda: jax_bench.bench_rawboost(batch=4, seconds=1,
                                                  repeats=1),
                 lambda: bench.bench_rawboost(batch=4, seconds=1, repeats=1,
                                              device="cpu"),
                 ()),
    "serving": (lambda: jax_bench.bench_serving(batch=2, seconds=1,
                                                repeats=2, model="tiny"),
                lambda: bench.bench_serving(batch=2, seconds=1, repeats=2,
                                            model="tiny", device="cpu"),
                ("serving_batch", "serving_quant")),
    "extract": (lambda: jax_bench.bench_extract(batch=4, seconds=1,
                                                n_batches=3, model="tiny"),
                lambda: bench.bench_extract(batch=4, seconds=1, n_batches=3,
                                            model="tiny", device="cpu"),
                ("extract_batch",)),
    "extract_w8a8": (lambda: jax_bench.bench_extract(
                         batch=4, seconds=1, n_batches=3, model="tiny",
                         quantize="w8a8"),
                     lambda: bench.bench_extract(
                         batch=4, seconds=1, n_batches=3, model="tiny",
                         quantize="w8a8", device="cpu"),
                     ("extract_batch",)),
    "socket": (lambda: jax_bench.bench_socket(batch=2, seconds=1, clients=2,
                                              per_client=2, model="tiny"),
               lambda: bench.bench_socket(batch=2, seconds=1, clients=2,
                                          per_client=2, model="tiny",
                                          device="cpu"),
               ("socket_batch", "socket_quant", "socket_wire",
                "socket_clients")),
}


def _numbers_ok(out: dict, fixed) -> None:
    for key, value in out.items():
        if key in fixed:
            continue
        assert isinstance(value, float) and math.isfinite(value) \
            and value > 0, (key, value)


@pytest.mark.parametrize("leg", sorted(LEGS))
def test_leg_keys_and_fields_match_jax(leg, wake_jax_accept):
    jax_call, port_call, fixed = LEGS[leg]
    want, got = jax_call(), port_call()
    assert set(got) == set(want)
    for key in fixed:
        assert got[key] == want[key], key
    _numbers_ok(got, fixed)
    json.dumps(got)


def test_supcon_keys_map_to_jax():
    want = jax_bench.bench_supcon(batch=32, dim=16, repeats=2)
    got = bench.bench_supcon(batch=32, dim=16, repeats=2, device="cpu")
    assert {SUPCON_KEYS[k] for k in got} == set(want)
    # on the CPU the kernel leg is not timed: the wrapper would run the
    # plain version there
    assert got["supcon_cuda_steps_per_sec"] is None
    _numbers_ok({k: v for k, v in got.items() if v is not None}, ())


def test_tiny_scorer_matches_jax_scorer():
    """The bench's tiny scorer, in fp32 on the CPU, against the JAX
    `SpoofScorer` on the same `random_jax_trees(seed=0)`."""
    assert port_config(JAX_TINY) == bench.TINY
    got = bench.make_scorer("tiny", seconds=1, device="cpu",
                            compute_dtype="float32")
    cfg2 = JaxStage2Config()
    enc, comp, head = random_jax_trees(
        bench.TINY, comp_dim=cfg2.in_dim, head_type=cfg2.head_type,
        head_hidden=cfg2.hidden_dim, seed=0)
    cfg = JaxStage1Config(batch_size=4, input_dim=32, hidden_dim=cfg2.in_dim,
                          max_duration_seconds=1, use_rawboost=False,
                          finetune_encoder=False, compute_dtype="float32")
    trainer = JaxTrainer(cfg, enc_config=JAX_TINY, enc_params=enc)
    state = trainer.init_state()
    state = state.replace(params=dict(state.params, compression=comp))
    want = JaxScorer(trainer, state, cfg2, head)
    rng = np.random.default_rng(4)
    waves = rng.normal(0, 0.2, (4, SR)).astype(np.float32)
    waves[1, SR // 2:] = 0.0
    a = got.score_waveforms(waves)
    b = want.score_waveforms(waves)
    assert a.shape == (4,) and np.isfinite(a).all()
    # fp32 on both sides: the tolerance of tests/test_torch_serving.py
    np.testing.assert_allclose(a, b, atol=1e-5)


def _jax_decode_batch(paths, target_len):
    """JAX's native batch decode, called as its bench calls it (its
    library declares no argtypes: the length is passed as a long long)."""
    lib = _native_decoder()
    n = len(paths)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    out = np.zeros((n, target_len), np.float32)
    srs = np.zeros(n, np.int32)
    lens = np.zeros(n, np.int64)
    lib.w2v_decode_batch(
        arr, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_longlong(target_len),
        srs.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)), 8)
    return out, srs, lens


def test_batch_decode_matches_jax_and_per_file(tmp_path):
    rng = np.random.default_rng(0)
    paths = []
    for i, n in enumerate((12000, 16000, 21000, 9000)):
        x = rng.normal(0, 0.2, n).astype(np.float32)
        if i % 2:
            p = str(tmp_path / f"clip_{i}.flac")
            write_flac(p, np.clip(x * 32767, -32768, 32767).astype(np.int16),
                       SR)
        else:
            p = str(tmp_path / f"clip_{i}.wav")
            audio.write_wav(p, x, SR)
        paths.append(p)
    paths.insert(2, str(tmp_path / "missing.wav"))
    target = 16000
    out, srs, lens = audio.decode_batch(paths, target, threads=3)
    want = _jax_decode_batch(paths, target)
    for got_a, want_a in zip((out, srs, lens), want):
        np.testing.assert_array_equal(got_a, want_a)
    assert lens[2] < 0 and not out[2].any()
    for i, p in enumerate(paths):
        if i == 2:
            continue
        x, sr = audio._decode_native(p)
        assert sr == srs[i] == SR and lens[i] == x.shape[0]
        np.testing.assert_array_equal(out[i], audio.pad_or_trim(x, target))


def test_command_prints_one_json_line():
    # the tiny model in bf16 on the CPU takes ~0.1 s a batch of 2 one-second
    # clips, so the defaults (8 x 5 s, 30 repeats) are cut here
    out = subprocess.run(
        [sys.executable, "-m", "wav2vec_contr_loss_torch",
         "bench_components", "--device", "cpu", "--serving_model", "tiny",
         "--which", "serving", "--serving_batch", "2", "--serving_seconds",
         "1", "--serving_repeats", "2"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1
    got = json.loads(lines[0])
    assert got["serving_batch"] == 2 and got["serving_quant"] == "none"
    _numbers_ok(got, ("serving_batch", "serving_quant"))
