"""The self-contained serving artifact: load and run it.

`SpoofScorer.export` (eval/serving.py) traces the whole scoring graph,
wire dequantization, encoder, compression, clip pooling and stage-2
head, with `torch.export` and bakes the weights in (fp32, or int8 with
`quantize`). This module reads such a file back and runs it, and imports
only torch and `wav2vec_contr_loss_torch.ops`, which registers the two
custom ops the program calls (`w2v_torch::attention_fwd`,
`w2v_torch::ln_gelu_fwd`): no model, train or eval code, no checkpoint.
A program traced on the card runs the Hopper kernels.

File layout, as the JAX artifact's (wav2vec_contr_loss_tpu/eval/
serving.py:78-92): MAGIC + u32 big-endian header length + JSON header +
the `torch.export.save` bytes. The magic is the port's own, so neither
package takes the other's file. The header records the sample rate and
the quantization (which the program's input does not show), the wire,
`format: "torch.export"` and the device type the program was traced on:
a traced program bakes its device into constants, so it runs only there.

    from wav2vec_contr_loss_torch.eval.artifact import load_exported
    scorer = load_exported("scorer.w2vexport")      # on its device
    logits = scorer(waves)                          # (B, T) -> (B,)
"""

from __future__ import annotations

import io
import json
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import ops  # noqa: F401  (registers the custom ops)

__all__ = ["ExportSpec", "ExportedScorer", "load_exported", "wrap_export",
           "unwrap_export", "EXPORT_MAGIC"]

EXPORT_MAGIC = b"W2VTORC1"
_JAX_MAGIC = b"W2VEXPT1"
_WIRE_DTYPES = {"float32": torch.float32, "int16": torch.int16}


class ExportSpec(NamedTuple):
    """An artifact's input signature and provenance: batch, num_samples
    and wire from the program's input, the rest from the header."""
    batch: int
    num_samples: int
    wire: str                  # 'float32' | 'int16'
    sample_rate: Optional[int] = None
    quantize: Optional[str] = None
    device: Optional[str] = None


def wrap_export(payload: bytes, header: dict) -> bytes:
    h = json.dumps(header).encode()
    return EXPORT_MAGIC + len(h).to_bytes(4, "big") + h + payload


def unwrap_export(blob: bytes) -> Tuple[bytes, dict]:
    """-> (torch.export bytes, header). Refuses a JAX artifact and any
    file without the port's magic."""
    if blob.startswith(_JAX_MAGIC):
        raise ValueError(
            "this is a jax.export artifact of the JAX package "
            "(wav2vec_contr_loss_tpu); load it with "
            "wav2vec_contr_loss_tpu.eval.serving.load_exported")
    if not blob.startswith(EXPORT_MAGIC):
        raise ValueError("not a serving artifact of wav2vec_contr_loss_torch "
                         "(no W2VTORC1 magic)")
    n = int.from_bytes(blob[8:12], "big")
    header = json.loads(blob[12:12 + n].decode())
    if header.get("format") != "torch.export":
        raise ValueError(f"unknown artifact format {header.get('format')!r}")
    return blob[12 + n:], header


class ExportedScorer:
    """A loaded artifact on its device: `scorer(waves)` maps (B, T)
    waves (a tensor or an array, in the wire dtype) to (B,) fp32 logits
    on the device; `run(waves) -> (None, logits)` is `SpoofScorer.run`'s
    shape (no embeddings), so the server and `serve` take either."""

    def __init__(self, program: torch.nn.Module, spec: ExportSpec,
                 device: torch.device):
        self._program = program
        self.spec = spec
        self.device = device
        self.num_samples = spec.num_samples

    def __call__(self, waves) -> torch.Tensor:
        if isinstance(waves, np.ndarray):
            waves = torch.from_numpy(waves)
        want = (self.spec.batch, self.spec.num_samples)
        if (tuple(waves.shape) != want
                or waves.dtype != _WIRE_DTYPES[self.spec.wire]):
            raise ValueError(
                f"the artifact takes {self.spec.wire} waves of shape {want}; "
                f"got {waves.dtype} {tuple(waves.shape)}")
        with torch.inference_mode():
            return self._program(waves.to(self.device, non_blocking=True))

    def run(self, waves) -> Tuple[None, torch.Tensor]:
        return None, self(waves)


def _input_spec(program) -> Tuple[int, int, str]:
    """(batch, num_samples, wire) of the program's one user input."""
    name = program.graph_signature.user_inputs[0]
    node = next(n for n in program.graph.nodes if n.name == name)
    val = node.meta["val"]
    wire = {v: k for k, v in _WIRE_DTYPES.items()}[val.dtype]
    return int(val.shape[0]), int(val.shape[1]), wire


def load_exported(path: str, with_spec: bool = False, device=None):
    """An artifact written by `SpoofScorer.export` -> an `ExportedScorer`
    (and, with `with_spec`, its `ExportSpec`). It runs on the device type
    it was traced on: `device` may name a device of that type and nothing
    else, and a program traced on the card is never run on the CPU."""
    with open(path, "rb") as f:
        payload, header = unwrap_export(f.read())
    traced = header["device"]
    dev = torch.device(traced if device is None else device)
    if dev.type != traced:
        raise ValueError(f"the artifact was traced for {traced!r} and runs "
                         f"only there; device={str(dev)!r} was asked for")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the artifact was traced for the card ('cuda') "
                           "and no CUDA device is available")
    program = torch.export.load(io.BytesIO(payload))
    batch, num_samples, wire = _input_spec(program)
    spec = ExportSpec(batch, num_samples, wire, header.get("sample_rate"),
                      header.get("quantize"), traced)
    scorer = ExportedScorer(program.module(), spec, dev)
    return (scorer, spec) if with_spec else scorer
