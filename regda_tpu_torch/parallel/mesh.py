"""Data parallelism over processes: the 'data' axis of the JAX package's mesh
(counterpart of regda_tpu/parallel/mesh.py).

The JAX package shards a batch over a ('data', 'spatial') device mesh and
lets GSPMD place the collectives. The port runs one process per card,
launched by `torchrun` (`RANK`, `WORLD_SIZE`, `LOCAL_RANK`), in a
`torch.distributed` process group: `nccl` on the card, `gloo` on the CPU.
A `DataGroup` names the group, this process's rank and its device.

The rule every data-parallel step keeps is the JAX one: a step on N ranks
over a global batch equals the one-process step on that batch, up to the
order of float reductions. So each quantity that the one-process step
takes over the batch (BatchNorm statistics, loss means and counts, class
frequencies, prototype sums, CORAL's moments, OHEM's k-th loss, GHM's
histogram) is taken over the global batch:
  * every rank computes the same *global* loss from its rows, through
    `all_reduce_sum` on local sums, whose backward all-reduces the
    gradient in turn;
  * so each rank's parameter gradient comes out as N times its share of
    the global gradient, and `average_gradients` divides the sum over
    the ranks by N (the convention of DDP with a synchronised BatchNorm).
Every rank then applies the same update to the same state, which stays
replicated; `assert_replicated` checks that bit for bit.

The 'spatial' axis (image height sharded, a halo exchange around every
convolution) is not ported: ROADMAP queue 1 item 4 holds it. Asking for it
raises.
"""

from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass
from typing import Iterable, Mapping, Optional

import torch
import torch.distributed as dist

SPATIAL_TODO = ("the 'spatial' mesh axis (H sharded with halo exchanges) is not "
                "ported yet: ROADMAP.md queue 1 item 4, the spatial slice")


@dataclass(frozen=True)
class DataGroup:
    """This process's place in a data-parallel process group."""
    rank: int
    size: int
    device: torch.device
    pg: object = None     # the torch.distributed ProcessGroup (None: WORLD)


def _rank_device(device, local_rank: int) -> torch.device:
    device = torch.device(device)
    if device.type != 'cuda':
        return device
    if not torch.cuda.is_available():
        raise RuntimeError(f"rank {local_rank}: no CUDA device for device='{device}'; "
                           "a data-parallel rank runs on its card or on device='cpu'")
    if device.index is None:
        device = torch.device('cuda', local_rank)
    if device.index >= torch.cuda.device_count():
        raise RuntimeError(f'rank {local_rank}: {device} does not exist '
                           f'({torch.cuda.device_count()} cards visible)')
    torch.cuda.set_device(device)
    return device


def data_group(rank: int, world_size: int, device='cuda', *,
               init_method: str = 'env://', local_rank: Optional[int] = None,
               backend: Optional[str] = None, n_spatial: int = 1) -> DataGroup:
    """Join (or, where this process has one, reuse) the default process
    group as `rank` of `world_size` and return its DataGroup. `device`
    'cuda' resolves to `cuda:{local_rank}` (default: `rank`); the backend
    is `nccl` on the card and `gloo` on the CPU unless `backend` names one
    (gloo also takes CUDA tensors, which lets two ranks share one card,
    where NCCL refuses)."""
    if n_spatial != 1:
        raise NotImplementedError(SPATIAL_TODO)
    local_rank = rank if local_rank is None else local_rank
    device = _rank_device(device, local_rank)
    if backend is None:
        backend = 'nccl' if device.type == 'cuda' else 'gloo'
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world_size)
    elif (dist.get_rank(), dist.get_world_size()) != (rank, world_size):
        raise RuntimeError(f'this process is rank {dist.get_rank()} of '
                           f'{dist.get_world_size()}, not {rank} of {world_size}')
    return DataGroup(rank, world_size, device, dist.group.WORLD)


def data_group_from_env(device='cuda', n_spatial: int = 1) -> Optional[DataGroup]:
    """The DataGroup of a process that `torchrun` started (`RANK`,
    `WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR`, `MASTER_PORT`), or None
    outside torchrun: the one-process run."""
    if 'WORLD_SIZE' not in os.environ:
        if n_spatial != 1:
            raise NotImplementedError(SPATIAL_TODO)
        return None
    return data_group(int(os.environ['RANK']), int(os.environ['WORLD_SIZE']), device,
                      local_rank=int(os.environ.get('LOCAL_RANK', os.environ['RANK'])),
                      n_spatial=n_spatial)


def shutdown() -> None:
    """Leave the default process group, where this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def is_primary(group: Optional[DataGroup]) -> bool:
    """True on the rank that logs and writes files (rank 0, or no group)."""
    return group is None or group.rank == 0


# ------------------------------------------------------------------ sharding
def rows(group: Optional[DataGroup], n: int) -> slice:
    """This rank's rows of a global batch of `n`: contiguous blocks of n / N
    rows in rank order. A world size that does not divide the batch is
    refused (the JAX Trainer would quietly use fewer devices)."""
    if group is None:
        return slice(0, n)
    if n % group.size:
        raise ValueError(f'world size {group.size} does not divide the global batch of '
                         f'{n}: run with a world size that divides it')
    b = n // group.size
    return slice(group.rank * b, (group.rank + 1) * b)


def share(group: Optional[DataGroup], n: int) -> slice:
    """This rank's share of `n` items to predict (tiles, images): contiguous
    blocks of ceil(n / N) in rank order, the last ranks holding fewer or
    none. Every prediction path splits its work by this one rule; only a
    training batch, whose rows must be equal, goes by `rows`."""
    if group is None:
        return slice(0, n)
    per = -(-n // group.size)
    return slice(min(group.rank * per, n), min((group.rank + 1) * per, n))


def shard_batch(group: Optional[DataGroup], *arrays):
    """This rank's rows of each array (numpy or tensor) of a global batch."""
    if not arrays:
        return arrays
    sl = rows(group, len(arrays[0]))
    if any(len(a) != len(arrays[0]) for a in arrays):
        raise ValueError('the arrays of a batch differ in length')
    return tuple(a[sl] for a in arrays)


# --------------------------------------------------------------- collectives
class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pg):
        ctx.pg = pg
        y = x.contiguous().clone()
        dist.all_reduce(y, group=pg)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.contiguous().clone()
        dist.all_reduce(g, group=ctx.pg)
        return g, None


def all_reduce_sum(x: torch.Tensor, group: Optional[DataGroup]) -> torch.Tensor:
    """The sum of `x` over the ranks (x itself without a group). Its
    backward all-reduces the gradient: the loss that every rank computes
    from the sum is the same global loss (module docstring)."""
    if group is None:
        return x
    return _AllReduceSum.apply(x, group.pg)


def global_mean(x: torch.Tensor, group: Optional[DataGroup]) -> torch.Tensor:
    """The mean of `x`'s elements over the global batch (`x.mean()` without
    a group); every rank holds as many elements."""
    if group is None:
        return x.mean()
    return all_reduce_sum(x.sum(), group) / (x.numel() * group.size)


def all_gather_rows(x: torch.Tensor, group: Optional[DataGroup]) -> torch.Tensor:
    """Every rank's `x` (equal shapes) concatenated along dim 0 in rank
    order, without a gradient."""
    if group is None:
        return x
    parts = [torch.empty_like(x) for _ in range(group.size)]
    dist.all_gather(parts, x.detach().contiguous(), group=group.pg)
    return torch.cat(parts)


def average_gradients(params: Iterable[torch.nn.Parameter],
                      group: Optional[DataGroup]) -> None:
    """Replace every parameter's gradient by the mean over the ranks (one
    all-reduce of the flattened gradients)."""
    if group is None:
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group.pg)
    flat.div_(group.size)
    off = 0
    for g in grads:
        g.copy_(flat[off:off + g.numel()].view_as(g))
        off += g.numel()


def all_gather_objects(obj, group: Optional[DataGroup]) -> list:
    """Every rank's `obj` (any picklable value), in rank order."""
    if group is None:
        return [obj]
    out = [None] * group.size
    dist.all_gather_object(out, obj, group=group.pg)
    return out


def broadcast_object(obj, group: Optional[DataGroup], src: int = 0):
    """Rank `src`'s `obj` (any picklable value) on every rank."""
    if group is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=group.pg,
                               device=group.device if group.device.type == 'cuda' else None)
    return box[0]


@torch.no_grad()
def broadcast_tensors(tensors: Iterable[torch.Tensor], group: Optional[DataGroup],
                      src: int = 0) -> None:
    """Overwrite each tensor in place with rank `src`'s."""
    if group is None:
        return
    for t in tensors:
        if t.is_contiguous():
            dist.broadcast(t, src=src, group=group.pg)
        else:
            c = t.contiguous()
            dist.broadcast(c, src=src, group=group.pg)
            t.copy_(c)


def broadcast_module(module: torch.nn.Module, group: Optional[DataGroup],
                     src: int = 0) -> None:
    """Make every parameter and buffer of `module` rank `src`'s."""
    broadcast_tensors(list(module.parameters()) + list(module.buffers()), group, src)


def assert_replicated(tensors: Mapping[str, torch.Tensor],
                      group: Optional[DataGroup]) -> None:
    """Raise unless every named tensor is bit-identical on every rank."""
    if group is None:
        return
    for name, t in tensors.items():
        flat = t.detach().contiguous().view(-1)
        if flat.is_floating_point():
            flat = flat.view(torch.int16 if flat.element_size() == 2 else
                             torch.int32 if flat.element_size() == 4 else torch.int64)
        gathered = all_gather_rows(flat[None], group)
        if not bool((gathered == gathered[:1]).all()):
            raise RuntimeError(f'replicated state {name!r} differs between the ranks')


def barrier(group: Optional[DataGroup]) -> None:
    if group is not None:
        dist.barrier(group=group.pg)


@contextlib.contextmanager
def data_parallel(model: torch.nn.Module, group: Optional[DataGroup]):
    """While inside, every module of `model` with a `data_group` attribute
    (the BatchNorms and the head dropouts) works on the global batch of
    `group`; without a group, nothing changes."""
    if group is None:
        yield
        return
    mods = [m for m in model.modules() if hasattr(m, 'data_group')]
    for m in mods:
        m.data_group = group
    try:
        yield
    finally:
        for m in mods:
            m.data_group = None
