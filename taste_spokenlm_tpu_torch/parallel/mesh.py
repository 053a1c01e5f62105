"""The ("data", "model") process mesh over torch.distributed (counterpart
of the JAX parallel/mesh.py: `make_mesh`, `_TP_RULES` / `param_spec`,
`global_batch`, `zero_shard_rule`, `opt_state_shardings`).

`make_mesh(data, model)` lays the world's ranks out as JAX reshapes its
devices, row-major: rank = d * model + m.  The ranks of one d form a model
group, those of one m a data group.  Without a call the mesh is (world, 1).

**The data axis.**  Under pjit every JAX op sees the global batch.  Here
each rank runs the step on its data rank's rows of the global batch
(`local_rows`), and every place where the rows of the global batch meet is
made global on purpose, over the rank's data group, inside
`data_parallel()`, which the train steps open around their forward,
backward and update:

* a mean over the batch's tokens (the stage-1, stage-2 and flow losses,
  the commit loss, the accuracy) divides the rank's own sum by the global
  count (`global_sum`): the ranks' values, and their gradients, add up to
  the global mean and its gradient; the steps sum the metrics;
* the gradients are summed over the data group before the clip
  (`all_reduce_grads_`), so the clip sees the global batch's norm;
* the RVQ's EMA counts and sums are summed over the data group, and its
  dead-code picks are drawn over the global batch's rows (`gather_rows`,
  `rows_at`);
* the audio dropout's noise scale is the global batch's std, and its
  gradient reaches every rank's rows (`global_std`);
* every draw with a batch dimension takes the global shape from the step's
  generator, which every rank seeds alike, and each rank keeps its own
  rows (`draw_rows`);
* ZeRO-1: a rank keeps Adam's moments only for its slice of each parameter
  along the axis `zero_shard_rule` picks over the data group, updates that
  slice and all-gathers the parameter over the data group
  (`all_gather_axis`).  Adam is elementwise, so the update equals the
  unsharded one bit for bit.

The helpers the models and losses call (`draw_rows`, `global_sum`,
`all_reduce_`, `gather_rows`, `rows_at`, `global_std`) are the identity
outside `data_parallel()` and over a data group of one, so a forward
outside a train step (eval, extraction, serving) never communicates, and a
one-process run computes exactly what it did before data parallelism
existed.  With model = 1 the data group is the world, and every
collective is the one a data-only run made.

**The model axis.**  Training replicates along it, as JAX's
`state_shardings` keeps the parameters replicated and shards only Adam's
moments over "data": the ranks of a model group hold the same parameters,
are fed the same rows and compute the same step.  Serving splits the Llama
over it (tensor parallelism, JAX's `_TP_RULES`): `param_spec` is that rule
table in the port's state-dict names, the Llama's modules (models/llama.py,
ops/quantized.py) built with a `ModelAxis` hold their rank's slices
(`quant.shard_state_dict` cuts a full state dict to them), and the
autograd functions below join the slices: `copy_to_model` at the input of a
column-split layer (identity, gradient summed), `reduce_from_model` at the
output of a row-split one (summed), `gather_from_model` for the vocab axis
of the tied head.  Every rank of a model group ends each layer with the same
hidden state and the head with the same logits, so the sampler runs
replicated.

Backends: gloo on the CPU, nccl on CUDA, or gloo on CUDA when the ranks
share a card (NCCL refuses two ranks on one device; `init_distributed`
raises rather than switch).  gloo's CUDA support covers all_reduce and
broadcast, so a gather of CUDA tensors over gloo is an all_reduce of a
zeroed buffer each rank writes its part into, and bf16 is summed in f32.
"""

from __future__ import annotations

import collections
import contextlib
import os
import re
import zlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device: Optional[torch.device] = None,
                     backend: Optional[str] = None) -> None:
    """Join the process group: from `coordinator` ("host:port" of process
    0) with `num_processes` and `process_id`, or from torchrun's environment
    (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT); with neither, stay one
    process.  `backend`: "gloo" or "nccl"; None takes gloo on the CPU and
    nccl on CUDA.  On CUDA a rank takes card LOCAL_RANK under torchrun,
    else its process id modulo the cards.  nccl with more ranks on this
    host (LOCAL_WORLD_SIZE, else the world) than cards raises ValueError:
    ranks sharing a card need backend "gloo"."""
    global _MESH
    dev = torch.device(device or "cpu")
    if coordinator is not None:
        if num_processes is None or process_id is None:
            raise ValueError("--coordinator needs --num-processes and "
                             "--process-id")
        init, world, rank_ = f"tcp://{coordinator}", num_processes, process_id
    elif int(os.environ.get("WORLD_SIZE", "1")) > 1:
        init, world, rank_ = ("env://", int(os.environ["WORLD_SIZE"]),
                              int(os.environ["RANK"]))
    else:
        return
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend {backend!r} (gloo | nccl)")
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        here = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        if backend == "nccl" and here > cards:
            raise ValueError(
                f"nccl with {here} ranks on {cards} card(s): NCCL refuses "
                "two ranks on one device; use backend 'gloo' (the train "
                "CLI's --backend gloo) for ranks that share a card")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK",
                                                 rank_ % cards)))
    elif backend == "nccl":
        raise ValueError("backend 'nccl' needs a CUDA device")
    dist.init_process_group(backend, init_method=init, world_size=world,
                            rank=rank_)
    _MESH = None


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def barrier() -> None:
    if world_size() > 1:
        dist.barrier()


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelAxis:
    """A rank's place on the model axis: its rank in the model group, the
    group's size and the group (None: no collective can run, as for cutting
    shapes)."""
    rank: int
    size: int
    group: Any = None

    def part(self, n: int) -> slice:
        """The rank's block of n items split in `size` equal blocks."""
        k = n // self.size
        return slice(self.rank * k, (self.rank + 1) * k)


@dataclass(frozen=True)
class Mesh:
    data: int
    model: int
    data_rank: int
    model_rank: int
    data_group: Any = None      # None: the world (model == 1)
    model_group: Any = None     # None: no model axis (model == 1)

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data, "model": self.model}

    @property
    def model_axis(self) -> Optional[ModelAxis]:
        """The rank's ModelAxis, None when the model axis has one rank."""
        if self.model == 1:
            return None
        return ModelAxis(self.model_rank, self.model, self.model_group)


_MESH: Optional[Mesh] = None


def make_mesh(data: Optional[int] = None, model: int = 1) -> Mesh:
    """Lay the world out as (data, model), rank = d * model + m, and make it
    the mesh the helpers use.  Every rank calls it, in the same order."""
    global _MESH
    w, r = world_size(), rank()
    if data is None:
        data = w // model
    if data * model != w:
        raise ValueError(f"mesh data {data} x model {model} != the world's "
                         f"{w} processes")
    d, m = divmod(r, model)
    data_group = model_group = None
    if model > 1:
        # dist.new_group is collective: every rank makes every group
        for mm in range(model):
            g = dist.new_group([dd * model + mm for dd in range(data)])
            if mm == m:
                data_group = g
        for dd in range(data):
            g = dist.new_group([dd * model + mm for mm in range(model)])
            if dd == d:
                model_group = g
    _MESH = Mesh(data, model, d, m, data_group, model_group)
    return _MESH


def current_mesh() -> Mesh:
    """The mesh `make_mesh` made, else (world, 1)."""
    return _MESH if _MESH is not None else Mesh(world_size(), 1, rank(), 0)


def data_size() -> int:
    return current_mesh().data


def data_rank() -> int:
    return current_mesh().data_rank


def model_size() -> int:
    return current_mesh().model


def model_rank() -> int:
    return current_mesh().model_rank


def _data_group():
    return current_mesh().data_group


_DATA_PARALLEL = False


@contextlib.contextmanager
def data_parallel():
    """Within: the models' and losses' helpers below span the data group's
    ranks (every rank must run the same code in lockstep)."""
    global _DATA_PARALLEL
    outer, _DATA_PARALLEL = _DATA_PARALLEL, True
    try:
        yield
    finally:
        _DATA_PARALLEL = outer


def span() -> int:
    """The ranks a batch's means and draws span: the data group's size
    inside `data_parallel()`, else 1."""
    return data_size() if _DATA_PARALLEL else 1


def _comm_device() -> torch.device:
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


# ---------------------------------------------------------------------------
# collectives that gloo's CUDA support lacks, built from all_reduce
# ---------------------------------------------------------------------------

COLLECTIVES: collections.Counter = collections.Counter()


def _gloo_cuda(x: torch.Tensor, group) -> bool:
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _all_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """dist.all_reduce (sum) of x in place; over gloo a bf16 / f16 tensor is
    summed in f32 and rounded once."""
    if x.dtype in (torch.bfloat16, torch.float16) \
            and dist.get_backend(group) == "gloo":
        wide = x.float()
        dist.all_reduce(wide, group=group)
        return x.copy_(wide)
    dist.all_reduce(x, group=group)
    return x


def _all_gather(x: torch.Tensor, group=None) -> List[torch.Tensor]:
    """Every rank's x, in group rank order.  gloo on CUDA: each rank writes
    its x into its row of a zeroed buffer and the buffer is summed."""
    n = dist.get_world_size(group)
    if _gloo_cuda(x, group):
        wide = {torch.bool: torch.uint8}.get(x.dtype, x.dtype)
        buf = torch.zeros((n,) + tuple(x.shape), dtype=wide, device=x.device)
        buf[dist.get_rank(group)] = x
        _all_reduce(buf, group)
        return list(buf.to(x.dtype).unbind(0))
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return parts


# ---------------------------------------------------------------------------
# the batch
# ---------------------------------------------------------------------------


def local_rows(batch: Dict) -> Dict:
    """The rank's rows of a global batch (numpy arrays or tensors, rows on
    dim 0): data rank r of w takes rows [r n / w, (r + 1) n / w); the ranks
    of a model group take the same rows.  The counterpart of
    `global_batch`: every rank holds the same global batch (the data stream
    is a function of the seed), and in JAX each process contributes the
    shards its devices own of it.  Raises ValueError on every rank when
    the ranks' batches differ in keys or shapes."""
    w, r = data_size(), data_rank()
    if world_size() == 1:
        return batch
    layout = repr(sorted((k, tuple(v.shape)) for k, v in batch.items()))
    mine = torch.tensor([zlib.crc32(layout.encode())], dtype=torch.int64,
                        device=_comm_device())
    if any(not torch.equal(p, mine) for p in _all_gather(mine)):
        raise ValueError(f"rank {rank()}: the ranks hold global batches of "
                         f"different shapes (this rank's: {layout}); every "
                         "rank must be fed the same global batch")
    if w == 1:
        return batch
    n = next(iter(batch.values())).shape[0]
    if n % w:
        raise ValueError(f"a global batch of {n} rows does not split over "
                         f"{w} data ranks (pad it: scripts/train.py "
                         "_pad_batch)")
    k = n // w
    return {key: v[r * k:(r + 1) * k] for key, v in batch.items()}


def draw_rows(draw: Callable[[Sequence[int]], torch.Tensor],
              shape: Sequence[int], dim: int = 0) -> torch.Tensor:
    """draw(shape) in one process; under a data group, draw(the global
    shape, `shape[dim]` x its size) and keep the data rank's block of `dim`,
    so that each rank gets the rows a one-process run would draw for
    them."""
    w = span()
    if w == 1:
        return draw(tuple(shape))
    full = list(shape)
    full[dim] *= w
    return draw(tuple(full)).narrow(dim, data_rank() * shape[dim], shape[dim])


# ---------------------------------------------------------------------------
# sums over the data group
# ---------------------------------------------------------------------------


def all_reduce_(x: torch.Tensor) -> torch.Tensor:
    """Sum x in place over the data group (no gradient flows through)."""
    if span() > 1:
        _all_reduce(x, _data_group())
    return x


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """A detached copy of x summed over the data group (x itself in one
    process)."""
    if span() == 1:
        return x
    return all_reduce_(x.detach().clone())


class _SumOverRanks(torch.autograd.Function):
    """x summed over the data group, with its gradient: every rank's x
    feeds every rank's sum, so the backward sums the gradient over the
    group."""

    @staticmethod
    def forward(ctx, x):
        return _all_reduce(x.clone(), _data_group())

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad.clone(), _data_group())


def all_reduce_grads_(grads: Sequence[torch.Tensor]) -> None:
    """Sum the gradients over the data group in place, one flat buffer per
    dtype (the optimizer's: over the whole group)."""
    if data_size() == 1:
        return
    groups: Dict[torch.dtype, list] = {}
    for g in grads:
        groups.setdefault(g.dtype, []).append(g)
    for gs in groups.values():
        flat = torch.cat([g.reshape(-1) for g in gs])
        _all_reduce(flat, _data_group())
        off = 0
        for g in gs:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The data ranks' x concatenated on dim 0 in rank order: the global
    batch's rows of a per-row tensor."""
    if span() == 1:
        return x
    return torch.cat(_all_gather(x.contiguous(), _data_group()), dim=0)


def rows_at(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[idx] for `idx` into the global batch's rows of x (each data rank
    holds its block of x's rows): every rank gets the same rows."""
    w = span()
    if w == 1:
        return x[idx]
    n = x.shape[0]
    local = idx - data_rank() * n
    own = (local >= 0) & (local < n)
    out = torch.zeros((idx.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    out[own] = x[local[own]]
    return all_reduce_(out)


def global_std(x: torch.Tensor) -> torch.Tensor:
    """x.std(unbiased=False) over the global batch (x's own in one
    process), differentiable as the one-process std is."""
    if span() == 1:
        return x.std(unbiased=False)
    n = global_sum(torch.tensor(float(x.numel()), device=x.device))
    mean = _SumOverRanks.apply(x.sum()) / n
    return torch.sqrt(_SumOverRanks.apply(((x - mean) ** 2).sum()) / n)


# ---------------------------------------------------------------------------
# ZeRO-1: Adam's moments sharded over the data group
# ---------------------------------------------------------------------------


def zero_shard_rule(shape: Sequence[int], world: int) -> Optional[int]:
    """The axis a tensor of `shape` is sharded on over `world` data ranks:
    the largest axis divisible by it (the first of equal ones); None (kept
    whole on every rank) for scalars, one rank, or no divisible axis.  JAX's
    rule, returning the axis its PartitionSpec names "data"."""
    if world <= 1 or not shape:
        return None
    best = None
    for i, s in enumerate(shape):
        if s % world == 0 and s >= world:
            if best is None or s > shape[best]:
                best = i
    return best


def shard(x: torch.Tensor, axis: Optional[int]) -> torch.Tensor:
    """The data rank's slice of x along `axis` (a view; x itself for
    None)."""
    if axis is None:
        return x
    k = x.shape[axis] // data_size()
    return x.narrow(axis, data_rank() * k, k)


def all_gather_axis(out: torch.Tensor, axis: Optional[int]) -> None:
    """Write every data rank's slice of `out` along `axis` (each rank has
    written its own) into `out` on every rank."""
    if axis is None or data_size() == 1:
        return
    mine = shard(out, axis).contiguous()
    out.copy_(torch.cat(_all_gather(mine, _data_group()), dim=axis))


# ---------------------------------------------------------------------------
# the model axis: JAX's _TP_RULES in the port's names
# ---------------------------------------------------------------------------

_TP = r"(?:q_proj|k_proj|v_proj|gate_proj|up_proj)"
_ROW = r"(?:o_proj|down_proj)"
# a projection of a Llama layer: a LlamaModel's own names, bare or under a
# `language_model.` (JAX's `base/` marks a LoraDense, which only the Llama
# has; the port's float projection is a plain `weight`, as the whisper
# layers' are, so the rule names where a Llama sits)
_LLAMA_LAYER = r"(?:^|(?:^|.*\.)language_model\.)layers\.\d+\.(?:self_attn|mlp)\."

# (torch-name regex, the torch axis split over "model"), first match wins.
# flax's kernel [in, out] is torch's weight [out, in]: P(None, "model") on
# a kernel is dim 0 of the weight, P("model", None) dim 1; base_q keeps
# flax's [in, out].  The fused qkv_proj / gateup_proj match as in JAX (its
# `.*v_proj.*`, `.*up_proj.*`), and an int4 `base_scale` [in/g, out] takes
# P("model") on its groups, as JAX's rule does.
_TP_RULES = [
    (_LLAMA_LAYER + r"\w*" + _TP + r"\w*\.weight$", 0),
    (_LLAMA_LAYER + r"\w*" + _ROW + r"\w*\.weight$", 1),
    (r".*" + _TP + r".*\.base_q$", 1),
    (r".*" + _TP + r".*\.base_scale$", 0),
    (r".*" + _ROW + r".*\.base_q$", 0),
    (r".*embed_tokens\.weight$", 0),
    (r".*embed_tokens\.embedding_q$", 0),
    (r".*embed_tokens\.embedding_scale$", 0),
]


def param_spec(name: str, shape: Sequence[int], model: int) -> Optional[int]:
    """JAX's `param_spec` for the port's state-dict `name` of `shape` over a
    model axis of `model` ranks: the torch axis split, or None
    (replicated).  Like JAX, a rule splits only when the axis divides."""
    if model <= 1:
        return None
    for pattern, axis in _TP_RULES:
        if re.match(pattern, name):
            if len(shape) > axis and shape[axis] % model == 0:
                return axis
            return None
    return None


_LLAMA = re.compile(r"(?:^|.*\.)language_model\.|(?:layers\.\d+|embed_tokens)\.")
_FUSED = re.compile(r".*\.(?:qkv_proj|gateup_proj)\.")


def held_whole(name: str, shape: Sequence[int]) -> bool:
    """Whether the port holds a tensor whole that JAX's rule splits: every
    tensor outside the Llama (the whisper decoder's embed_tokens: the tower
    is not split), the fused qkv_proj / gateup_proj (their columns
    concatenate what the rank slices apart after the product), and the
    int4 group scales (their base_q4 has no rule, and the kernel reads
    every group)."""
    return (not _LLAMA.match(name) or bool(_FUSED.match(name))
            or (name.endswith(".base_scale") and len(shape) == 2))


def tp_axis(name: str, shape: Sequence[int], model: int) -> Optional[int]:
    """The axis the port's rank holds a slice of: `param_spec` unless the
    tensor is held whole."""
    return None if held_whole(name, shape) else param_spec(name, shape, model)


def _check_group(axis: ModelAxis) -> None:
    if axis.group is None:
        raise RuntimeError("a model axis without a process group cannot "
                           "communicate (mesh.make_mesh gives one)")


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the gradient summed over the model group (the input
    of a column-split layer, used by every rank)."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        COLLECTIVES["all_reduce"] += 1
        return _all_reduce(grad.clone(), ctx.axis.group), None


class _ReduceFromModel(torch.autograd.Function):
    """The partial sums of the model group's ranks summed (the output of a
    row-split layer); identity backward."""

    @staticmethod
    def forward(ctx, x, axis):
        COLLECTIVES["all_reduce"] += 1
        return _all_reduce(x.clone(), axis.group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    """The ranks' blocks of the last axis concatenated in rank order; the
    backward keeps the rank's block."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis, ctx.n = axis, x.shape[-1]
        COLLECTIVES["all_gather"] += 1
        return torch.cat(_all_gather(x.contiguous(), axis.group), dim=-1)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(-1, ctx.axis.rank * ctx.n, ctx.n), None


def copy_to_model(x: torch.Tensor, axis: Optional[ModelAxis]) -> torch.Tensor:
    """x, whose gradient is summed over the model group (only where
    autograd records: under no_grad it is x)."""
    if axis is None or not torch.is_grad_enabled():
        return x
    _check_group(axis)
    return _CopyToModel.apply(x, axis)


def reduce_from_model(x: torch.Tensor, axis: Optional[ModelAxis]
                      ) -> torch.Tensor:
    """x summed over the model group."""
    if axis is None:
        return x
    _check_group(axis)
    return _ReduceFromModel.apply(x, axis)


def gather_from_model(x: torch.Tensor, axis: Optional[ModelAxis]
                      ) -> torch.Tensor:
    """The model group's blocks of x's last axis, concatenated."""
    if axis is None:
        return x
    _check_group(axis)
    return _GatherFromModel.apply(x, axis)
