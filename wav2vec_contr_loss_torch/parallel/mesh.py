"""The ('data', 'model') device mesh and the parameter layouts on it.

The port of wav2vec_contr_loss_tpu/parallel/mesh.py. One process drives
one card; N processes of a gang (utils/distributed.py) form a
`DeviceMesh` of shape (n_data, n_model), 'model' the inner axis (rank =
data_rank * n_model + model_rank). Every process builds the same global
balanced batch (the sampler's 'global' mode) and feeds its data rank's
contiguous slice (`local_batch`); model ranks of one data row take the
same slice.

Layouts (`apply_layout`, the counterpart of `shard_params`), singly or
composed:

  * 'replicated': data parallelism. Every rank holds every parameter;
    after the backward the gradients are averaged over 'data'
    (collectives.average_gradients).
  * 'fsdp': ZeRO-3 with FSDP2 `fully_shard` on each `EncoderLayer` over
    the 'data' sub-mesh: the layer's parameters, gradients and (since
    the optimizer builds its moments from the sharded parameters) AdamW
    moments are split over 'data'; the layer is gathered for its forward
    and its remat recompute, its gradient reduce-scattered and averaged.
    As in JAX (which shards only `layers/`), the conv extractor, feature
    projection, positional conv, encoder LayerNorm, masked_spec_embed
    and the compression module stay replicated and are averaged like
    the 'replicated' layout's.
  * tensor parallelism over 'model' (when n_model > 1): Megatron's
    column and row slices of each layer's attention and FFN linears
    (`param_sharding_rules`), held as plain local parameters, so the
    kernels receive plain tensors. FSDP2 then shards those slices over
    'data', as the JAX fsdp+tp composes (mesh.py:124-132). With
    `sequence_parallel` the residual stream's frames are also split
    over 'model' (models/wav2vec2.py); the layers' replicated parameters
    (LayerNorms, row biases) then see only their rank's frames, and
    `average_gradients` sums their gradients over 'model'.
  * 'pp': GPipe pipeline parallelism (parallel/pipeline.py), the 'model'
    axis carrying the stages in place of tensor parallelism: stage s
    keeps layers [s*L/S, (s+1)*L/S) and frees the others' parameters
    (each becomes an empty placeholder of the same name, so every rank
    enumerates the same parameters, in one order, for the optimizer and
    the checkpoints). Everything outside the stack is replicated.
    Composes with data parallelism on 'data'; excludes fsdp and
    sequence parallelism (`check_layout`, JAX mesh.py:151-153 and
    config.py:141-160).

`Layout` carries what the trainers need afterwards: the `Shard`, the
process group over which each gradient's shards are spread (the global
norm of a clip), and the way from a parameter's local shard to its full
HF-named tensor and back (checkpoints are layout-free: gathered to full
tensors, a pipeline's layers broadcast from their stage, rank 0 writes,
every rank restores into its own layout).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Iterable, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from .collectives import (Shard, average_gradients, gather_rows,
                          reduce_in_buckets, set_shard)

__all__ = ["make_mesh", "shard_of", "local_batch", "fetch_global",
           "param_sharding_rules", "apply_layout", "check_layout", "Layout",
           "PARAM_SHARDINGS"]

# what param_sharding takes
PARAM_SHARDINGS = ("replicated", "fsdp", "pp")
# a pipeline stage's layer parameters, by their global layer index
_LAYER = re.compile(r"(?:^|\.)layers\.(\d+)\.(.+)$")


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              device_type: Optional[str] = None):
    """The ('data', 'model') `DeviceMesh` over every process of the group
    (which must be up). Pure data parallelism by default; 'model' is the
    inner axis. `device_type` defaults to 'cuda' under NCCL, else
    'cpu'."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs the process group: call "
                           "utils.distributed.maybe_initialize first")
    total = dist.get_world_size()
    if n_model < 1:
        raise ValueError(f"model={n_model} must be >= 1")
    if n_data is None:
        if total % n_model:
            raise ValueError(f"{total} processes not divisible by "
                             f"model={n_model}")
        n_data = total // n_model
    if n_data * n_model != total:
        raise ValueError(f"mesh {n_data}x{n_model} != {total} processes")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (n_data, n_model),
                            mesh_dim_names=("data", "model"))


def shard_of(mesh) -> Shard:
    """This process's `Shard` on `mesh`."""
    return Shard(data_rank=mesh.get_local_rank("data"),
                 n_data=mesh["data"].size(),
                 model_rank=mesh.get_local_rank("model"),
                 n_model=mesh["model"].size(),
                 data_group=mesh.get_group("data"),
                 model_group=mesh.get_group("model"))


def local_batch(batch: Mapping, shard: Shard) -> Dict:
    """This data rank's contiguous rows of a global batch (a mapping of
    arrays or tensors with the batch first), the counterpart of
    `global_batch_from_local`. Refuses a batch that does not divide:
    clips would be dropped."""
    out = {}
    for key, x in batch.items():
        rows = x.shape[0]
        if rows % shard.n_data:
            raise ValueError(f"global batch {rows} not divisible by the "
                             f"'data' axis ({shard.n_data}); clips would be "
                             f"dropped")
        per = rows // shard.n_data
        out[key] = x[shard.data_rank * per:(shard.data_rank + 1) * per]
    return out


def fetch_global(x: torch.Tensor, shard: Shard) -> np.ndarray:
    """A data-sharded (B_local, ...) tensor as the global (B, ...) array
    on the host of every rank; collective: every rank calls it, in the
    same order."""
    with torch.no_grad():
        return gather_rows(x, shard).cpu().numpy()


# Megatron's layout over the port's HF names: the dim of the torch
# (out, in) weight that 'model' splits. Column-parallel q/k/v and the FFN
# up-projection (weight and bias on dim 0), row-parallel out_proj and the
# FFN down-projection (weight on dim 1, bias replicated): one all-reduce
# a block in each direction (_TP_RULES, mesh.py:105-112).
_TP_RULES = [
    (r"(^|.*\.)attention\.(q_proj|k_proj|v_proj)\.(weight|bias)$", 0),
    (r"(^|.*\.)attention\.out_proj\.weight$", 1),
    (r"(^|.*\.)feed_forward\.intermediate_dense\.(weight|bias)$", 0),
    (r"(^|.*\.)feed_forward\.output_dense\.weight$", 1),
]


def param_sharding_rules(name: str, tensor_parallel: bool) -> Optional[int]:
    """The dim of parameter `name` (HF naming) split over 'model', or None
    for a replicated one."""
    if tensor_parallel:
        for pattern, dim in _TP_RULES:
            if re.match(pattern, name):
                return dim
    return None


def check_layout(fsdp: bool = False, pipeline: bool = False,
                 sequence_parallel: bool = False,
                 microbatches: int = 1, batch: Optional[int] = None) -> None:
    """The JAX package's refusals of a layout: pipeline with fsdp
    (mesh.py:151-153) or with sequence parallelism (wav2vec2.py:619-622),
    and a pipeline whose microbatches do not divide the batch
    (pipeline.py:98-101)."""
    if pipeline and fsdp:
        raise ValueError("pipeline and fsdp shard the layer stack on "
                         "different axes — pick one")
    if pipeline and sequence_parallel:
        raise ValueError("sequence_parallel shards frames over the 'model' "
                         "axis, which param_sharding='pp' uses for GPipe "
                         "stages — pick one")
    if pipeline and microbatches < 1:
        raise ValueError(f"pipeline_microbatches={microbatches} must be >= 1")
    if pipeline and batch is not None and batch % microbatches:
        raise ValueError(f"batch {batch} not divisible by "
                         f"pipeline_microbatches={microbatches}")


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if _is_dtensor(t) else t


@dataclasses.dataclass
class Layout:
    """A trainer's layout on the mesh (module docstring)."""

    mesh: object
    shard: Shard
    fsdp: bool
    tensor_parallel: bool
    # under 'pp': the layers a stage holds, and the shapes of a layer's
    # parameters by their name inside the layer
    stage_layers: int = 0
    layer_shapes: Dict[str, torch.Size] = dataclasses.field(
        default_factory=dict)
    # under sequence parallelism: the parameters whose gradients are
    # summed over 'model' (each rank's share from its frames)
    frame_partial: list = dataclasses.field(default_factory=list)

    def tp_dim(self, name: str) -> Optional[int]:
        return param_sharding_rules(name, self.tensor_parallel)

    def owner(self, name: str) -> Optional[int]:
        """The stage that holds parameter `name` under 'pp' (None outside
        the stack, or without a pipeline)."""
        if not self.stage_layers:
            return None
        hit = _LAYER.search(name)
        return None if hit is None else int(hit.group(1)) // self.stage_layers

    def _full_shape(self, name: str) -> torch.Size:
        return self.layer_shapes[_LAYER.search(name).group(2)]

    def norm_group(self, name: str, p: torch.Tensor):
        """The process group over which the shards of parameter `name`
        (p, as the module holds it) are spread, or None for a
        replicated one: a global norm sums its squares over that group."""
        if self.owner(name) is not None:
            return self.shard.model_group
        on_data, on_model = _is_dtensor(p), self.tp_dim(name) is not None
        if on_data and on_model:
            return dist.group.WORLD
        if on_data:
            return self.shard.data_group
        return self.shard.model_group if on_model else None

    def full(self, name: str, t: torch.Tensor,
             like: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The full tensor of parameter `name` from this rank's shard `t`
        (the parameter, or a local tensor shaped like the local shard of
        `like`, such as an AdamW moment); collective. FSDP2's dim-0
        shards are joined with `all_gather` (DTensor's `full_tensor`
        crashes under Gloo with CUDA tensors: PERF.md, PR 10)."""
        like = t if like is None else like
        stage = self.owner(name)
        if stage is not None:   # broadcast from the stage that holds it
            if stage != self.shard.model_rank:
                t = t.new_empty(self._full_shape(name))
            t = t.detach().contiguous()
            group = self.shard.model_group
            dist.broadcast(t, dist.get_global_rank(group, stage), group=group)
            return t
        if _is_dtensor(like):
            t = _join_rows(_local(t), like.shape[0], self.shard.data_group,
                           self.shard.n_data)
        dim = self.tp_dim(name)
        if dim is not None:
            parts = [torch.empty_like(t) for _ in range(self.shard.n_model)]
            dist.all_gather(parts, t.contiguous(),
                            group=self.shard.model_group)
            t = torch.cat(parts, dim)
        return t.detach()

    def local(self, name: str, full: torch.Tensor,
              like: torch.Tensor) -> torch.Tensor:
        """This rank's shard of the full tensor of parameter `name`, shaped
        like the local shard of `like` (the parameter as held)."""
        stage = self.owner(name)
        if stage is not None and stage != self.shard.model_rank:
            return full.new_empty(0)   # another stage's layer
        dim = self.tp_dim(name)
        if dim is not None:
            full = full.chunk(self.shard.n_model, dim)[self.shard.model_rank]
        if _is_dtensor(like):
            full = full.chunk(self.shard.n_data, 0)[self.shard.data_rank]
        want = _local(like).shape
        if full.shape != want:
            raise ValueError(f"{name}: a shard of {tuple(full.shape)} for "
                             f"{tuple(want)}")
        return full

    def full_state_dict(self, module: nn.Module) -> Dict[str, torch.Tensor]:
        """`module.state_dict()` with every shard gathered; collective."""
        return {k: self.full(k, v) for k, v in module.state_dict().items()}

    @torch.no_grad()
    def load_full_state_dict(self, module: nn.Module,
                             sd: Mapping[str, torch.Tensor]) -> None:
        """Copy this rank's shards of the full tensors `sd` into `module`
        (strict: the same names)."""
        own = module.state_dict()
        if set(own) != set(sd):
            raise ValueError(f"state dict keys differ: missing "
                             f"{sorted(set(own) - set(sd))[:5]}, unexpected "
                             f"{sorted(set(sd) - set(own))[:5]}")
        for k, v in own.items():
            _local(v).copy_(self.local(k, sd[k], v))

    def average_gradients(self, params: Iterable[nn.Parameter]) -> None:
        """Under sequence parallelism, first sum over 'model' the
        gradients of the layers' replicated parameters; then average over
        'data' the gradients FSDP2 does not reduce (every trainable
        parameter that is not a DTensor)."""
        partial = [p for p in self.frame_partial if p.requires_grad]
        if partial:
            for p in partial:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            reduce_in_buckets([_local(p.grad) for p in partial],
                              self.shard.model_group)
        average_gradients([p for p in params if not _is_dtensor(p)],
                          self.shard)


def _join_rows(t: torch.Tensor, rows: int, group, n: int) -> torch.Tensor:
    """The (rows, ...) tensor whose `torch.chunk(n)` dim-0 shards (the
    last ones shorter or empty, as FSDP2 cuts them) the ranks of `group`
    hold, one of them `t`."""
    per = -(-rows // n)
    if t.shape[0] < per:
        t = torch.cat([t, t.new_zeros((per - t.shape[0],) + t.shape[1:])])
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts)[:rows]


def _replace(module: nn.Module, name: str, value: torch.Tensor,
             requires_grad: bool) -> None:
    owner, leaf = name.rsplit(".", 1)
    setattr(module.get_submodule(owner), leaf,
            nn.Parameter(value, requires_grad=requires_grad))


def _slice_tensor_parallel(module: nn.Module, shard: Shard) -> None:
    """Replace each column / row parameter of `module` by this model
    rank's slice, a plain Parameter."""
    for name, p in list(module.named_parameters()):
        dim = param_sharding_rules(name, True)
        if dim is None:
            continue
        if p.shape[dim] % shard.n_model:
            raise ValueError(f"{name}: {p.shape[dim]} not divisible by the "
                             f"'model' axis ({shard.n_model})")
        part = p.detach().chunk(shard.n_model, dim)[shard.model_rank]
        _replace(module, name, part.clone(), p.requires_grad)


def _free_other_stages(module: nn.Module, shard: Shard,
                       layout: "Layout") -> None:
    """Under 'pp': give the layers a Shard without a 'model' axis (the
    pipe passes each microbatch's), and replace every parameter of a
    layer another stage holds by an empty placeholder."""
    from ..models.wav2vec2 import TransformerStack

    for stack in (m for m in module.modules()
                  if isinstance(m, TransformerStack)):
        n_layers = len(stack.layers)
        if n_layers % shard.n_model:
            raise ValueError(f"{n_layers} layers not divisible by "
                             f"{shard.n_model} pipeline stages")
        layout.stage_layers = n_layers // shard.n_model
        for i, layer in enumerate(stack.layers):
            set_shard(layer, Shard(data_rank=shard.data_rank,
                                   n_data=shard.n_data,
                                   data_group=shard.data_group))
            layout.layer_shapes.update(
                (n, p.shape) for n, p in layer.named_parameters())
            if i // layout.stage_layers == shard.model_rank:
                continue
            for name, p in list(layer.named_parameters()):
                _replace(layer, name, p.new_empty(0), p.requires_grad)


def apply_layout(modules: Mapping[str, Optional[nn.Module]], mesh,
                 param_sharding: str = "replicated",
                 sequence_parallel: bool = False,
                 pipeline_microbatches: int = 2) -> Layout:
    """Lay the trainer's modules ({'encoder': Wav2Vec2Encoder or None,
    ...}, full weights already loaded on this rank's device) out on
    `mesh`: under 'pp', the stages' layers (module docstring); else
    tensor parallelism first when n_model > 1 (with sequence
    parallelism when asked), then FSDP2 per EncoderLayer over 'data'
    under 'fsdp'. -> the Layout. The optimizer must be built afterwards,
    from the laid-out parameters."""
    from ..models.wav2vec2 import EncoderLayer, SelfAttention

    if param_sharding not in PARAM_SHARDINGS:
        raise ValueError(f"param_sharding={param_sharding!r}: expected one "
                         f"of {PARAM_SHARDINGS}")
    pipeline = param_sharding == "pp"
    check_layout(fsdp=param_sharding == "fsdp", pipeline=pipeline,
                 sequence_parallel=sequence_parallel,
                 microbatches=pipeline_microbatches)
    shard = dataclasses.replace(
        shard_of(mesh), sequence_parallel=sequence_parallel,
        pipeline_microbatches=pipeline_microbatches if pipeline else 0)
    tensor_parallel = shard.n_model > 1 and not pipeline
    layout = Layout(mesh, shard, param_sharding == "fsdp", tensor_parallel)
    layers = []
    for module in modules.values():
        if module is None:
            continue
        set_shard(module, shard)
        layers += [m for m in module.modules() if isinstance(m, EncoderLayer)]
        if pipeline and shard.n_model > 1:
            _free_other_stages(module, shard, layout)
        if tensor_parallel:
            for m in module.modules():
                if (isinstance(m, SelfAttention)
                        and m.num_heads % shard.n_model):
                    raise ValueError(f"{m.num_heads} heads not divisible by "
                                     f"the 'model' axis ({shard.n_model})")
            _slice_tensor_parallel(module, shard)
    if layout.fsdp:
        from torch.distributed.fsdp import fully_shard

        for layer in layers:
            # FSDP2 shards contiguous parameters only; the bridge's
            # (out, in) weights are transposed views
            for name, p in list(layer.named_parameters()):
                if not p.is_contiguous():
                    _replace(layer, name, p.detach().contiguous(),
                             p.requires_grad)
            fully_shard(layer, mesh=mesh["data"])
    if sequence_parallel and tensor_parallel:
        layout.frame_partial = [
            p for layer in layers for name, p in layer.named_parameters()
            if param_sharding_rules(name, True) is None]
    return layout
