"""Data parallelism over torch.distributed, with ZeRO-1 sharding of Adam's
moments (counterpart of the JAX parallel/mesh.py's "data" axis:
`global_batch`, `zero_shard_rule`, `opt_state_shardings`).

Under pjit every JAX op sees the global batch.  Here each process runs the
step on its own rows of the global batch (`local_rows`), and every place
where the rows of the global batch meet is made global on purpose, inside
`data_parallel()`, which the train steps open around their forward,
backward and update:

* a mean over the batch's tokens (the stage-1, stage-2 and flow losses,
  the commit loss, the accuracy) divides the rank's own sum by the global
  count (`global_sum`): the ranks' values, and their gradients, add up to
  the global mean and its gradient; the steps sum the metrics;
* the gradients are summed over the ranks before the clip
  (`all_reduce_grads_`), so the clip sees the global batch's norm;
* the RVQ's EMA counts and sums are summed over the ranks, and its
  dead-code picks are drawn over the global batch's rows (`gather_rows`,
  `rows_at`);
* the audio dropout's noise scale is the global batch's std, and its
  gradient reaches every rank's rows (`global_std`);
* every draw with a batch dimension takes the global shape from the step's
  generator, which every rank seeds alike, and each rank keeps its own
  rows (`draw_rows`);
* ZeRO-1: a rank keeps Adam's moments only for its slice of each parameter
  along the axis `zero_shard_rule` picks, updates that slice and
  all-gathers the parameter (`all_gather_axis`).  Adam is elementwise, so
  the update equals the unsharded one bit for bit.

The helpers the models and losses call (`draw_rows`, `global_sum`,
`all_reduce_`, `gather_rows`, `rows_at`, `global_std`) are the identity
outside `data_parallel()` and in one process, so a forward outside a train
step (eval, extraction, serving) never communicates, and a one-process run
computes exactly what it did before data parallelism existed.  The
model axis (JAX's `_TP_RULES`, tensor parallelism over "model") is not
ported.
"""

from __future__ import annotations

import contextlib
import os
import zlib
from typing import Callable, Dict, Optional, Sequence

import torch
import torch.distributed as dist

MODEL_AXIS_TODO = ('the model axis (tensor parallelism, JAX\'s _TP_RULES) is '
                   'not ported: ROADMAP.md queue A, "The training harness"')


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device: Optional[torch.device] = None) -> None:
    """Join the data-parallel group: from `coordinator` ("host:port" of
    process 0) with `num_processes` and `process_id`, or from torchrun's
    environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT); with neither,
    stay one process.  gloo on the CPU, nccl on CUDA (one card a process:
    LOCAL_RANK under torchrun, else the process id modulo the cards)."""
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
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK",
                                   rank_ % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=init, world_size=world, rank=rank_)


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


_DATA_PARALLEL = False


@contextlib.contextmanager
def data_parallel():
    """Within: the models' and losses' helpers below span the group's
    ranks (every rank must run the same code in lockstep)."""
    global _DATA_PARALLEL
    outer, _DATA_PARALLEL = _DATA_PARALLEL, True
    try:
        yield
    finally:
        _DATA_PARALLEL = outer


def span() -> int:
    """The ranks a batch's means and draws span: the group's size inside
    `data_parallel()`, else 1."""
    return world_size() if _DATA_PARALLEL else 1


def _comm_device() -> torch.device:
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def check_model_parallel(model: int) -> None:
    if model > 1:
        raise NotImplementedError(f"--model-parallel {model}: "
                                  + MODEL_AXIS_TODO)


def barrier() -> None:
    if world_size() > 1:
        dist.barrier()


# ---------------------------------------------------------------------------
# the batch
# ---------------------------------------------------------------------------


def local_rows(batch: Dict) -> Dict:
    """The rank's rows of a global batch (numpy arrays or tensors, rows on
    dim 0): rank r of w takes rows [r n / w, (r + 1) n / w).  The
    counterpart of `global_batch`: every rank holds the same global batch
    (the data stream is a function of the seed), and in JAX each process
    contributes the shards its devices own of it.  Raises ValueError on
    every rank when the ranks' batches differ in keys or shapes."""
    w, r = world_size(), rank()
    if w == 1:
        return batch
    layout = repr(sorted((k, tuple(v.shape)) for k, v in batch.items()))
    mine = torch.tensor([zlib.crc32(layout.encode())], dtype=torch.int64,
                        device=_comm_device())
    parts = [torch.empty_like(mine) for _ in range(w)]
    dist.all_gather(parts, mine)
    if any(not torch.equal(p, mine) for p in parts):
        raise ValueError(f"rank {r}: the ranks hold global batches of "
                         f"different shapes (this rank's: {layout}); every "
                         "rank must be fed the same global batch")
    n = next(iter(batch.values())).shape[0]
    if n % w:
        raise ValueError(f"a global batch of {n} rows does not split over "
                         f"{w} processes (pad it: scripts/train.py "
                         "_pad_batch)")
    k = n // w
    return {key: v[r * k:(r + 1) * k] for key, v in batch.items()}


def draw_rows(draw: Callable[[Sequence[int]], torch.Tensor],
              shape: Sequence[int], dim: int = 0) -> torch.Tensor:
    """draw(shape) in one process; under a group, draw(the global shape,
    `shape[dim]` x world) and keep the rank's block of `dim`, so that each
    rank gets the rows a one-process run would draw for them."""
    w = span()
    if w == 1:
        return draw(tuple(shape))
    full = list(shape)
    full[dim] *= w
    return draw(tuple(full)).narrow(dim, rank() * shape[dim], shape[dim])


# ---------------------------------------------------------------------------
# sums over the ranks
# ---------------------------------------------------------------------------


def all_reduce_(x: torch.Tensor) -> torch.Tensor:
    """Sum x in place over the ranks (no gradient flows through)."""
    if span() > 1:
        dist.all_reduce(x)
    return x


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """A detached copy of x summed over the ranks (x itself in one
    process)."""
    if span() == 1:
        return x
    return all_reduce_(x.detach().clone())


class _SumOverRanks(torch.autograd.Function):
    """x summed over the ranks, with its gradient: every rank's x feeds
    every rank's sum, so the backward sums the gradient over the ranks."""

    @staticmethod
    def forward(ctx, x):
        out = x.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad)
        return grad


def all_reduce_grads_(grads: Sequence[torch.Tensor]) -> None:
    """Sum the gradients over the ranks in place, one flat buffer per
    dtype (the optimizer's: over the whole group)."""
    if world_size() == 1:
        return
    groups: Dict[torch.dtype, list] = {}
    for g in grads:
        groups.setdefault(g.dtype, []).append(g)
    for gs in groups.values():
        flat = torch.cat([g.reshape(-1) for g in gs])
        dist.all_reduce(flat)
        off = 0
        for g in gs:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The ranks' x concatenated on dim 0 in rank order: the global batch's
    rows of a per-row tensor."""
    w = span()
    if w == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(w)]
    dist.all_gather(parts, x.contiguous())
    return torch.cat(parts, dim=0)


def rows_at(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[idx] for `idx` into the global batch's rows of x (each rank holds
    its block of x's rows): every rank gets the same rows."""
    w = span()
    if w == 1:
        return x[idx]
    n = x.shape[0]
    local = idx - rank() * n
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
# ZeRO-1: Adam's moments sharded over the ranks
# ---------------------------------------------------------------------------


def zero_shard_rule(shape: Sequence[int], world: int) -> Optional[int]:
    """The axis a tensor of `shape` is sharded on over `world` ranks: the
    largest axis divisible by it (the first of equal ones); None (kept
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
    """The rank's slice of x along `axis` (a view; x itself for None)."""
    if axis is None:
        return x
    k = x.shape[axis] // world_size()
    return x.narrow(axis, rank() * k, k)


def all_gather_axis(out: torch.Tensor, axis: Optional[int]) -> None:
    """Write every rank's slice of `out` along `axis` (each rank has
    written its own) into `out` on every rank."""
    if axis is None or world_size() == 1:
        return
    mine = shard(out, axis).contiguous()
    parts = [torch.empty_like(mine) for _ in range(world_size())]
    dist.all_gather(parts, mine)
    out.copy_(torch.cat(parts, dim=axis))
