"""Four gloo ranks on the CPU on a (2 data x 2 spatial) group, the JAX
tests' mesh, for tests/test_torch_spatial.py.

Run as `python tests/torch_spatial_child.py OUT` after the test has written
OUT/jax_init.pt (the JAX segmenter's init, converted): starts four ranks
(`torch.multiprocessing` spawn, a `file://` rendezvous in OUT), each of
which writes what the tests hold to OUT/rank<r>.pt:

* `coords`: the rank's mesh coordinates and the world ranks of its
  spatial and data subgroups;
* `ops`: `halo_exchange` (through the segmenter's `Conv2d` and
  `stem_pool`) and `gather_height`, forward and backward on this rank's
  rows of a seeded input, against the unsharded op on the whole input:
  the largest gap of each, and the reference's largest value, on the
  (2 x 2) group and on a (1 x 4) group of all four ranks, where a halo
  deeper than a block reads the blocks of two ranks;
* `lrh`: `homogenize` on this rank's rows against the whole images: the
  kernel's calls, the all-reduced histogram and the labels, both exact;
* `selection`: `pseudo_selection` on this rank's rows against the whole
  images, where the halves' class maxima differ;
* `steps`: the stage-1, stage-2 and stage-3 steps (`CASES`), two steps
  each at 32 px, with the digests and the one-process comparison of
  tests/torch_parallel_child.py (each rank its share of the cases), and
  the histogram kernel's calls in each step;
* `eval`: the eval forward at 128 px, output stride 16 and 8, on the JAX
  init's weights: this rank's rows, and on rank 0 the one-process forward;
* `sgd`: one stage-1 step at 128 px with plain SGD on the JAX init's
  weights, head dropout off: the loss, the update's norm and the digests.
"""

import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from tests.torch_parallel_child import (ATOL, RTOL, STATS_ATOL, STATS_RTOL, batches,  # noqa: E402
                                        build_state, digest, make_step, momentum_norm,
                                        state_tensors)

WORLD, N_SPATIAL = 4, 2
C = 6
# name -> (stage, batch, size, classifier scale, is_ins_norm, step kwargs), as
# tests/torch_parallel_child.py: 32 px gives each spatial rank 16 image rows
# and one row of the stride-16 map, which layer 4's dilation-2 convs and the
# head's reach past; `stage2_remat` checkpoints every residual block
CASES = {
    'stage1': (1, 4, 32, 1.0, False, dict(align_domain=True, bcs=True)),
    'stage2': (2, 4, 32, 30.0, False, dict(bcs=True)),
    'stage3_uvem': (3, 4, 32, 1.0, False, dict(lt='uvem', bcs=True, bct=True)),
    'stage3_ghm': (3, 4, 32, 1.0, False, dict(lt='ghm')),
    'stage2_in': (2, 4, 32, 30.0, True, dict(bcs=True)),
    'stage2_remat': (2, 4, 32, 30.0, True, dict(bcs=True)),
}
REMAT = ('stage2_remat',)
EVAL = dict(batch=2, size=128, strides=(16, 8))
SGD = dict(batch=2, size=128, lr=1e-2, clip=32.0)

# name -> (kernel, stride, padding, dilation, rows a block), None for the
# max pool; the `deep` cases give a block fewer rows than the halo
OPS = {
    'conv7x7s2': (7, 2, 3, 1, 8), 'conv3x3s2': (3, 2, 1, 1, 8),
    'conv3x3d1': (3, 1, 1, 1, 8), 'conv3x3d2': (3, 1, 2, 2, 8),
    'conv3x3d4': (3, 1, 4, 4, 8), 'deep_conv3x3d4': (3, 1, 4, 4, 2),
    'deep_conv7x7s2': (7, 2, 3, 1, 2), 'maxpool': None, 'gather': None,
}


def sgd_inputs():
    """The 128 px stage-1 batch the test also gives the JAX step."""
    rng = np.random.default_rng(11)
    b, hw = SGD['batch'], SGD['size']
    x = rng.normal(size=(b, hw, hw, 3)).astype(np.float32)
    block = rng.integers(0, C, size=(b, 2, 2)).astype(np.int32)
    return x, np.kron(block, np.ones((hw // 2, hw // 2), np.int32))


def eval_inputs():
    return np.random.default_rng(12).normal(
        size=(EVAL['batch'], EVAL['size'], EVAL['size'], 3)).astype(np.float32)


# ------------------------------------------------------------------ ops
def _block(group, h: int) -> slice:
    """This rank's block of h rows (the unit cases' heights are not the
    segmenter's multiples of 16)."""
    b = h // group.n_spatial
    return slice(group.spatial_rank * b, (group.spatial_rank + 1) * b)


def _op_case(name: str, group, n_spatial: int) -> dict:
    from regda_tpu_torch.models.resnet import Conv2d, stem_pool
    from regda_tpu_torch.parallel import gather_height
    rng = np.random.default_rng(sum(map(ord, name)))
    spec = OPS[name]
    block = spec[4] if spec is not None else 8
    x = torch.from_numpy(rng.normal(size=(2, 3, block * n_spatial, 12)).astype(np.float32))
    own = _block(group, x.shape[2])
    if name == 'gather':
        weights = [torch.from_numpy(rng.normal(size=x.shape).astype(np.float32))
                   for _ in range(n_spatial)]
        xs = x[:, :, own].clone().requires_grad_()
        full = gather_height(xs, group)
        (full * weights[group.spatial_rank]).sum().backward()
        return {'fwd': float((full - x).detach().abs().max()),
                'bwd': float((xs.grad - sum(weights)[:, :, own]).abs().max()),
                'scale': float(sum(weights).abs().max())}
    if spec is None:
        op = stem_pool
    else:
        k, stride, pad, dil, _ = spec
        op = Conv2d(3, 4, k, stride, pad, dil)
        with torch.no_grad():
            op.weight.copy_(torch.from_numpy(rng.normal(size=op.weight.shape).astype(np.float32)))
            op.bias.copy_(torch.from_numpy(rng.normal(size=4).astype(np.float32)))
    xr = x.clone().requires_grad_()
    want = op(xr) if spec is not None else op(xr, None)
    weight = torch.from_numpy(rng.normal(size=want.shape).astype(np.float32))
    (want * weight).sum().backward()
    xs = x[:, :, own].clone().requires_grad_()
    if spec is None:
        got = op(xs, group)
    else:
        op.data_group = group
        got = op(xs)
        op.data_group = None
    out_rows = _block(group, want.shape[2])
    (got * weight[:, :, out_rows]).sum().backward()
    return {'fwd': float((got - want[:, :, out_rows]).detach().abs().max()),
            'bwd': float((xs.grad - xr.grad[:, :, own]).abs().max()),
            'scale': max(float(want.detach().abs().max()), float(xr.grad.abs().max()))}


def ops(group) -> dict:
    import torch.distributed as dist
    from regda_tpu_torch.parallel import DataGroup
    line = DataGroup(group.rank, WORLD, group.device, group.pg, WORLD, dist.group.WORLD)
    out = {}
    for mesh, g in (('2x2', group), ('1x4', line)):
        for name in OPS:
            out[f'{mesh}-{name}'] = _op_case(name, g, g.n_spatial)
    return out


# ------------------------------------------------------------------ LRH
class _Calls:
    """Wraps `ops.lrh.segment_hist_labels`: counts its calls and keeps the
    last histogram it returned, which LRH then all-reduces in place."""

    def __init__(self):
        import regda_tpu_torch.ops.lrh as lrh
        self.lrh, self.plain = lrh, lrh.segment_hist_labels
        self.calls, self.last = 0, None

    def __call__(self, *args):
        self.calls += 1
        self.last = self.plain(*args)
        return self.last

    def __enter__(self):
        self.lrh.segment_hist_labels = self
        return self

    def __exit__(self, *exc):
        self.lrh.segment_hist_labels = self.plain


def lrh(group) -> dict:
    from regda_tpu_torch.entry import synthetic_stage2_batch
    from regda_tpu_torch.ops.kernels.segment_hist import segment_hist_labels
    from regda_tpu_torch.ops.lrh import MAX_REGIONS, _clamp_regions, homogenize
    from regda_tpu_torch.parallel import shard_batch
    rng = np.random.default_rng(13)
    regs = synthetic_stage2_batch(rng, 4, 64, C)[3]
    labels = rng.integers(-1, C, size=regs.shape).astype(np.int32)
    own_labels, own_regs = (torch.from_numpy(np.ascontiguousarray(a))
                            for a in shard_batch(group, labels, regs))
    with _Calls() as calls:
        got = homogenize(own_labels, own_regs, 0.5, C, group=group)
    rows = slice(group.data_rank * 2, group.data_rank * 2 + 2)
    lab, reg = (torch.from_numpy(a[rows]) for a in (labels, regs))
    want_hist = segment_hist_labels(lab.reshape(2, -1), _clamp_regions(reg.reshape(2, -1),
                                                                       MAX_REGIONS),
                                    MAX_REGIONS, C)
    h = regs.shape[1] // N_SPATIAL
    want = homogenize(lab, reg, 0.5, C)[:, group.spatial_rank * h:(group.spatial_rank + 1) * h]
    return {'calls': calls.calls, 'hist_equal': bool(torch.equal(calls.last, want_hist)),
            'labels_equal': bool(torch.equal(got, want)),
            'changed': int((want != lab[:, group.spatial_rank * h:
                                        (group.spatial_rank + 1) * h]).sum())}


def selection(group) -> dict:
    """`pseudo_selection` on this rank's rows against the whole images,
    on probabilities whose class maxima differ between the two halves of
    each image (the lower half's logits x 3): equal exactly, where the
    rank's own maxima would select otherwise."""
    from regda_tpu_torch.ops.pseudo import pseudo_selection
    from regda_tpu_torch.parallel import shard_batch
    logits = np.random.default_rng(14).normal(size=(4, 32, 32, C)).astype(np.float32)
    logits[:, 16:] *= 3.0
    probs = torch.softmax(torch.from_numpy(logits), dim=-1).numpy()
    (own,) = shard_batch(group, probs)
    own = torch.from_numpy(np.ascontiguousarray(own))
    rows = slice(group.data_rank * 2, group.data_rank * 2 + 2)
    want = pseudo_selection(torch.from_numpy(probs[rows]))
    want = want[:, group.spatial_rank * 16:(group.spatial_rank + 1) * 16]
    return {'equal': bool(torch.equal(pseudo_selection(own, group=group), want)),
            'own_maxima_differ': int((pseudo_selection(own) != want).sum())}


# ---------------------------------------------------------------- steps
GHM_EDGE_BAND = 1e-5


class _NearEdges:
    """Wraps `ops.losses.ghm_loss`: per call, the number of this rank's
    valid pixels whose |p_y - 1| lies within GHM_EDGE_BAND of an inner
    bin edge k / 30, where two orders of float reduction may bin it
    apart (GHM's binning is discontinuous there)."""

    def __init__(self):
        import regda_tpu_torch.ops.losses as losses
        self.losses, self.plain = losses, losses.ghm_loss
        self.near = []

    def __call__(self, state, logits, labels, *args, **kwargs):
        with torch.no_grad():
            lg = logits.reshape(-1, logits.shape[-1]).float()
            lb = labels.reshape(-1).long()
            valid = lb >= 0
            p = torch.softmax(lg, -1).gather(1, lb.clamp(min=0)[:, None])[:, 0]
            g = (1.0 - p.double())[valid] * 30
            inner = (g.round() > 0) & (g.round() < 30)
            self.near.append(int(((g - g.round()).abs() < GHM_EDGE_BAND * 30)[inner].sum()))
        return self.plain(state, logits, labels, *args, **kwargs)

    def __enter__(self):
        self.losses.ghm_loss = self
        return self

    def __exit__(self, *exc):
        self.losses.ghm_loss = self.plain


def run_case(case: str, group):
    """-> (state, metrics per step, histogram calls per step, GHM near-edge
    pixels per loss call)."""
    from regda_tpu_torch.parallel import shard_batch
    state, step = build_state(case, CASES), make_step(case, group, CASES)
    state.model.encoder.resnet.remat = case in REMAT
    metrics, calls = [], []
    with _NearEdges() as edges:
        for arrays in batches(case, CASES):
            own = shard_batch(group, *arrays)
            with _Calls() as c:
                m = step(state, *(torch.from_numpy(np.ascontiguousarray(a)) for a in own))
            calls.append(c.calls)
            metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics, calls, edges.near


def steps(rank: int, group) -> dict:
    out = {'metrics': {}, 'digests': {}, 'vs_one': {}, 'calls': {}}
    mine = {}
    for i, case in enumerate(CASES):
        state, metrics, calls, _ = run_case(case, group)
        out['metrics'][case], out['calls'][case] = metrics, calls
        tensors = state_tensors(state)
        out['digests'][case] = {k: digest(v) for k, v in tensors.items()}
        if i % WORLD == rank:
            mine[case] = ({k: v.detach().clone() for k, v in tensors.items()
                           if not k.startswith('momentum.')}, momentum_norm(tensors))
        del state, tensors
    for case, (tensors, dp_norm) in mine.items():
        ref, ref_metrics, _, near = run_case(case, None)
        ref_tensors = state_tensors(ref)
        errs = {}
        for k, v in tensors.items():
            a, b = v.double(), ref_tensors[k].double()
            d = (a - b).abs()
            errs[k] = (float(d.max()), float((d / (ATOL + RTOL * b.abs())).max()),
                       float((d / (STATS_ATOL + STATS_RTOL * b.abs())).max()),
                       float(b.abs().max()))
        out['vs_one'][case] = {'metrics': ref_metrics, 'tensors': errs, 'ghm_near': near,
                               'ghm': (tensors['ghm'], ref_tensors['ghm']),
                               'momentum_norm': (dp_norm, momentum_norm(ref_tensors))}
    return out


# ------------------------------------------------------- JAX-held cases
def jax_model(output_stride: int = 16):
    from regda_tpu_torch.models import build_deeplabv2
    model = build_deeplabv2('resnet18', C, output_stride=output_stride)
    model.load_state_dict(torch.load(os.path.join(OUT, 'jax_init.pt'))['state_dict'])
    return model


def eval_forward(rank: int, group) -> dict:
    from regda_tpu_torch.parallel import data_parallel, shard_batch
    x = eval_inputs()
    out = {}
    for stride in EVAL['strides']:
        model = jax_model(stride).eval()
        (own,) = shard_batch(group, x)
        with torch.no_grad(), data_parallel(model, group):
            out[f'os{stride}'] = model(torch.from_numpy(np.ascontiguousarray(own)))
        if rank == 0:
            with torch.no_grad():
                out[f'os{stride}_one'] = model(torch.from_numpy(x))
    return out


class PlainSGD(torch.optim.SGD):
    """optax.chain(clip_by_global_norm(clip), sgd(lr)): the gradients
    scaled by clip / norm where their global norm reaches `clip`, then
    p -= lr * g."""

    def __init__(self, params, lr: float, clip: float):
        super().__init__(params, lr=lr)
        self.clip = clip
        self.grad_norm = None

    @torch.no_grad()
    def step(self, closure=None):
        grads = [p.grad for g in self.param_groups for p in g['params'] if p.grad is not None]
        norm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads))
        self.grad_norm = float(norm)
        torch._foreach_mul_(grads, torch.where(norm < self.clip, 1.0, self.clip / norm))
        super().step()


def sgd_step(group) -> dict:
    from regda_tpu_torch.models.heads import Dropout2d
    from regda_tpu_torch.parallel import shard_batch
    from regda_tpu_torch.train import create_train_state
    from regda_tpu_torch.train.steps import make_stage1_step
    model = jax_model()
    for m in model.modules():
        if isinstance(m, Dropout2d):
            m.p = 0.0
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    opt = PlainSGD(model.parameters(), SGD['lr'], SGD['clip'])
    state = create_train_state(model, opt, torch.Generator(),
                               torch.load(os.path.join(OUT, 'jax_init.pt'))['prototypes'])
    own = shard_batch(group, *sgd_inputs())
    m = make_stage1_step(num_classes=C, group=group)(
        state, *(torch.from_numpy(np.ascontiguousarray(a)) for a in (own[0], own[1], own[0])))
    moved = torch.sqrt(sum(((p.detach() - before[k]).double() ** 2).sum()
                           for k, p in model.named_parameters()))
    return {'metrics': {k: float(v) for k, v in m.items()}, 'update_norm': float(moved),
            'grad_norm': opt.grad_norm,
            'digests': {k: digest(v) for k, v in state_tensors(state).items()}}


def coords(group) -> dict:
    import torch.distributed as dist
    return {'rank': group.rank, 'data_rank': group.data_rank, 'n_data': group.n_data,
            'spatial_rank': group.spatial_rank, 'n_spatial': group.n_spatial,
            'spatial_pg': dist.get_process_group_ranks(group.spatial_pg),
            'data_pg': dist.get_process_group_ranks(group.data_pg)}


def _rank(rank: int, out: str) -> None:
    global OUT
    OUT = out
    torch.set_num_threads(2)
    from regda_tpu_torch.parallel import data_group, shutdown
    group = data_group(rank, WORLD, 'cpu', n_spatial=N_SPATIAL,
                       init_method='file://' + os.path.join(out, 'rendezvous'))
    try:
        result = {'coords': coords(group), 'ops': ops(group), 'lrh': lrh(group),
                  'selection': selection(group),
                  'eval': eval_forward(rank, group), 'sgd': sgd_step(group),
                  'steps': steps(rank, group)}
        torch.save(result, os.path.join(out, f'rank{rank}.pt'))
    finally:
        shutdown()


OUT = None


def main(out: str) -> None:
    import torch.multiprocessing as mp
    os.makedirs(out, exist_ok=True)
    mp.spawn(_rank, args=(out,), nprocs=WORLD, join=True)


if __name__ == '__main__':
    main(sys.argv[1] if len(sys.argv) > 1 else tempfile.mkdtemp())
