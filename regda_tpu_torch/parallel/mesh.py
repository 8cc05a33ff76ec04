"""Data and spatial parallelism over processes: the ('data', 'spatial') mesh
of the JAX package (counterpart of regda_tpu/parallel/mesh.py).

The JAX package shards a batch over a ('data', 'spatial') device mesh and
lets GSPMD place the collectives. The port runs one process per card,
launched by `torchrun` (`RANK`, `WORLD_SIZE`, `LOCAL_RANK`), in a
`torch.distributed` process group: `nccl` on the card, `gloo` on the CPU.
A `DataGroup` names the group, this process's rank and its device.

The group is the 2-D mesh of `make_mesh`: `n_data` x `n_spatial` ranks,
world rank r = d * n_spatial + s (the JAX mesh's device order). The ranks
that share a data coordinate d hold the same images, each the s-th block
of their rows (`height_rows`); `spatial_pg` is their process group and
`data_pg` that of the ranks that share a spatial coordinate. `rank`,
`size` and `pg` mean the whole world.

The rule every parallel step keeps is the JAX one: a step on N ranks
over a global batch equals the one-process step on that batch, up to the
order of float reductions. So each quantity that the one-process step
takes over the batch (BatchNorm statistics, loss means and counts, class
frequencies, prototype sums, CORAL's moments, OHEM's k-th loss, GHM's
histogram) is taken over the global batch, and since every rank holds as
many pixels, a sum over the world is one over the global batch:
  * every rank computes the same *global* loss from its rows, through
    `all_reduce_sum` on local sums, whose backward all-reduces the
    gradient in turn;
  * so each rank's parameter gradient comes out as N times its share of
    the global gradient, and `average_gradients` divides the sum over
    the ranks by N (the convention of DDP with a synchronised BatchNorm).
Every rank then applies the same update to the same state, which stays
replicated; `assert_replicated` checks that bit for bit.

What the one-process step takes over one image's rows is taken over the
spatial group: a convolution or pool that reads rows of its neighbours
takes them by `halo_exchange`, a resize that reads the whole image by
`gather_height`, the instance norm's and the PPM pools' sums by
`spatial_sum`, and a per-image maximum by `all_reduce_max`. The first
three keep the gradient convention above, since each is a sum over the
spatial group of zero-padded parts (`_SpatialStack`): its backward sums
the gradient over the group in turn and keeps this rank's part, so a
halo row's gradient goes back to the rank that owns the row and adds to
what that rank's own rows receive.
"""

from __future__ import annotations

import contextlib
import functools
import os
from dataclasses import dataclass
from typing import Iterable, Mapping, Optional

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class DataGroup:
    """This process's place in an (n_data x n_spatial) process group."""
    rank: int
    size: int
    device: torch.device
    pg: object = None     # the torch.distributed ProcessGroup (None: WORLD)
    n_spatial: int = 1
    spatial_pg: object = None    # the ranks that hold the same images
    data_pg: object = None       # the ranks that hold the same rows of theirs

    @property
    def n_data(self) -> int:
        return self.size // self.n_spatial

    @property
    def data_rank(self) -> int:
        return self.rank // self.n_spatial

    @property
    def spatial_rank(self) -> int:
        return self.rank % self.n_spatial

    @property
    def spatial(self) -> bool:
        """True where image rows are split over more than one rank."""
        return self.n_spatial > 1


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
    group as `rank` of `world_size` and return its DataGroup, the
    (world_size / n_spatial) x n_spatial mesh (module docstring). `device`
    'cuda' resolves to `cuda:{local_rank}` (default: `rank`); the backend
    is `nccl` on the card and `gloo` on the CPU unless `backend` names one
    (gloo also takes CUDA tensors, which lets two ranks share one card,
    where NCCL refuses). With n_spatial > 1 every rank creates the
    spatial subgroups, then the data subgroups, in the same order."""
    if n_spatial < 1 or world_size % n_spatial:
        raise ValueError(f'n_spatial {n_spatial} does not divide the world size {world_size}')
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
    if n_spatial == 1:
        return DataGroup(rank, world_size, device, dist.group.WORLD)
    n_data = world_size // n_spatial
    spatial = [dist.new_group([d * n_spatial + s for s in range(n_spatial)])
               for d in range(n_data)]
    data = [dist.new_group([d * n_spatial + s for d in range(n_data)])
            for s in range(n_spatial)]
    return DataGroup(rank, world_size, device, dist.group.WORLD, n_spatial,
                     spatial[rank // n_spatial], data[rank % n_spatial])


def data_group_from_env(device='cuda', n_spatial: int = 1) -> Optional[DataGroup]:
    """The DataGroup of a process that `torchrun` started (`RANK`,
    `WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR`, `MASTER_PORT`), or None
    outside torchrun: the one-process run."""
    if 'WORLD_SIZE' not in os.environ:
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
    """This rank's rows of a global batch of `n`: contiguous blocks of
    n / n_data rows in data-rank order. An n_data that does not divide the
    batch is refused (the JAX Trainer would quietly use fewer devices)."""
    if group is None:
        return slice(0, n)
    if n % group.n_data:
        axis = 'world size' if group.n_spatial == 1 else 'n_data'
        raise ValueError(f'{axis} {group.n_data} does not divide the global batch of '
                         f'{n}: run with a world size that divides it')
    b = n // group.n_data
    return slice(group.data_rank * b, (group.data_rank + 1) * b)


def check_height(group: Optional[DataGroup], h: int, output_stride: int = 16) -> None:
    """Refuse an image height `h` that the spatial axis cannot split:
    h % (n_spatial * max(16, output_stride)) must be 0, so that every
    rank's block holds whole 16 x 16 label blocks and whole rows of the
    output-stride map, and every stride-2 layer sees an even block."""
    if group is None or not group.spatial:
        return
    unit = group.n_spatial * max(16, output_stride)
    if h % unit:
        raise ValueError(f'image height {h} does not split over {group.n_spatial} spatial '
                         f'ranks: H % (n_spatial * max(16, output_stride)) must be 0, '
                         f'here H % {unit} = {h % unit}')


def height_rows(group: Optional[DataGroup], h: int, output_stride: int = 16) -> slice:
    """This rank's block of the rows of an image of height `h`:
    contiguous blocks of h / n_spatial rows in spatial-rank order."""
    if group is None or not group.spatial:
        return slice(0, h)
    check_height(group, h, output_stride)
    b = h // group.n_spatial
    return slice(group.spatial_rank * b, (group.spatial_rank + 1) * b)


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
    """This rank's part of each array (numpy or tensor) of a global batch:
    its rows of the batch and, on the spatial axis, its block of the image
    height (axis 1) of every array of rank >= 3 (images, labels, region
    maps, soft labels), as the JAX `shard_batch(spatial=True)`."""
    if not arrays:
        return arrays
    sl = rows(group, len(arrays[0]))
    if any(len(a) != len(arrays[0]) for a in arrays):
        raise ValueError('the arrays of a batch differ in length')
    return tuple(a[sl, height_rows(group, a.shape[1])] if a.ndim >= 3 else a[sl]
                 for a in arrays)


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


class _SpatialStack(torch.autograd.Function):
    """(n_spatial, *x.shape): every spatial rank's `x`, in spatial order, as
    the sum over the spatial group of `x` placed in its slot of zeros (an
    all-gather from the one collective that gloo and NCCL both take for
    CUDA tensors). The backward is the same sum of the gradient, of which
    this rank keeps its slot: the sum of what every rank's use of `x`
    sends back."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        buf = x.new_zeros((group.n_spatial,) + tuple(x.shape))
        buf[group.spatial_rank] = x
        dist.all_reduce(buf, group=group.spatial_pg)
        return buf

    @staticmethod
    def backward(ctx, grad):
        g = grad.contiguous().clone()
        dist.all_reduce(g, group=ctx.group.spatial_pg)
        return g[ctx.group.spatial_rank], None


def spatial_sum(x: torch.Tensor, group: Optional[DataGroup]) -> torch.Tensor:
    """The sum of `x` over the ranks that hold the same images (x itself
    off the spatial axis); its backward all-reduces the gradient, as
    `all_reduce_sum`'s."""
    if group is None or not group.spatial:
        return x
    return _AllReduceSum.apply(x, group.spatial_pg)


@torch.no_grad()
def all_reduce_max(x: torch.Tensor, group: Optional[DataGroup]) -> torch.Tensor:
    """The elementwise maximum of `x` over the ranks that hold the same
    images, without a gradient (x itself off the spatial axis)."""
    if group is None or not group.spatial:
        return x
    y = x.contiguous().clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=group.spatial_pg)
    return y


def gather_height(x: torch.Tensor, group: Optional[DataGroup]) -> torch.Tensor:
    """(B, C, h, W) rows of this rank -> (B, C, n_spatial * h, W): the whole
    image height, gathered over the spatial group. Its backward sums the
    gradient over the group and keeps this rank's rows."""
    if group is None or not group.spatial:
        return x
    b, c, h, w = x.shape
    every = _SpatialStack.apply(x.contiguous(), group)
    return every.permute(1, 2, 0, 3, 4).reshape(b, c, group.n_spatial * h, w)


@functools.lru_cache(maxsize=256)
def _halo_index(h: int, n: int, s: int, top: int, bottom: int, mt: int, mb: int,
                device) -> tuple[torch.Tensor, torch.Tensor]:
    """Where the rows of spatial rank s's halos lie in the gathered slabs:
    slab r holds rank r's last `mt` rows, then its first `mb`; index
    n * (mt + mb) is the fill row beyond the image's edge. A halo deeper
    than a block reads the slabs of several ranks."""
    m, fill = mt + mb, n * (mt + mb)
    above = [fill if g < 0 else (g // h) * m + g % h - (h - mt)
             for g in range(s * h - top, s * h)]
    below = [fill if g >= n * h else (g // h) * m + mt + g % h
             for g in range((s + 1) * h, (s + 1) * h + bottom)]
    return (torch.tensor(above, dtype=torch.long, device=device),
            torch.tensor(below, dtype=torch.long, device=device))


def halo_exchange(x: torch.Tensor, top: int, bottom: int, group: Optional[DataGroup],
                  fill: float = 0.0) -> torch.Tensor:
    """On the spatial axis, (B, C, h, W) rows of this rank -> (B, C, top + h
    + bottom, W): x with the `top` image rows above its block and the
    `bottom` rows below it, `fill` beyond the image's edge (0 for a
    convolution's zero padding, -inf for a max pool's). Every rank's
    boundary rows are gathered over the spatial group, so a halo deeper
    than the neighbour's block comes from the ranks beyond it. The
    backward sends each halo row's gradient to the rank that owns the row,
    which adds it to its own."""
    b, c, h, w = x.shape
    n, s = group.n_spatial, group.spatial_rank
    mt, mb = min(top, h), min(bottom, h)
    slab = torch.cat([x[:, :, h - mt:], x[:, :, :mb]], dim=2)
    every = _SpatialStack.apply(slab.contiguous(), group)        # (n, B, C, mt + mb, W)
    flat = torch.cat([every.permute(1, 2, 0, 3, 4).reshape(b, c, n * (mt + mb), w),
                      x.new_full((b, c, 1, w), fill)], dim=2)
    above, below = _halo_index(h, n, s, top, bottom, mt, mb, x.device)
    return torch.cat([flat.index_select(2, above), x, flat.index_select(2, below)], dim=2)


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
    works on the global batch of `group`: the BatchNorms and the head
    dropouts, and on the spatial axis the convolutions and the max pool
    (halos), the PPM pools, the instance norm and the resizes of the
    segmenter; without a group, nothing changes."""
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
