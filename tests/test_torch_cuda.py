"""Tests of the port's CUDA kernels on the card (marker `cuda`).

They skip on a machine without a CUDA device. On an H100 run them with

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

(`--noconftest`: tests/conftest.py imports jax, which a GPU host may lack.)

Each kernel is held against its plain PyTorch version on the same device
(the histogram exactly; LayerNorm, attention, the two-way transformer and the
mask head within the tolerances of chip_smoke.py), and the wrapper's launch
counter is checked.
"""

import numpy as np
import pytest
import torch

from regda_tpu_torch.ops.kernels import layernorm as ln
from regda_tpu_torch.ops.kernels import mask_stats as ms
from regda_tpu_torch.ops.kernels import rel_attention as ra
from regda_tpu_torch.ops.kernels import segment_hist as sh
from regda_tpu_torch.ops.kernels import stability as st
from regda_tpu_torch.ops.kernels import two_way as tw
from regda_tpu_torch.ops.kernels import upscale as up
from regda_tpu_torch.ops.lrh import homogenize

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


@pytest.mark.parametrize('b,n,num_regions,num_classes', [
    (8, 512 * 512, 1024, 6), (8, 512 * 512, 1024, 7), (3, 1000, 1024, 6),
    (3, 1001, 64, 7), (2, 3, 64, 6)])
def test_segment_hist_kernel_matches_plain(device, b, n, num_regions, num_classes):
    rng = np.random.default_rng(n)
    labels = torch.from_numpy(rng.integers(-1, num_classes + 2, (b, n)).astype(np.int32))
    regions = torch.from_numpy(rng.integers(-3, num_regions + 50, (b, n)).astype(np.int32))
    before = sh.launches
    got = sh.segment_hist_labels(labels.to(device), regions.to(device),
                                 num_regions, num_classes)
    assert sh.launches == before + 1
    want = sh.segment_hist_labels_plain(labels, regions, num_regions, num_classes)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


def test_segment_hist_kernel_uniform_region(device):
    labels = torch.full((2, 512 * 512), 2, dtype=torch.int32, device=device)
    regions = torch.full((2, 512 * 512), 5, dtype=torch.int32, device=device)
    got = sh.segment_hist_labels(labels, regions, 1024, 6)
    assert float(got[:, 5, 2].min()) == 512 * 512
    assert float(got.sum()) == 2 * 512 * 512


def test_segment_hist_rejects_oversized_histogram(device):
    labels = torch.zeros((1, 64), dtype=torch.int32, device=device)
    with pytest.raises(ValueError):
        sh.segment_hist_labels(labels, labels, 1 << 20, 6)
    # refused before the empty-batch early return too
    empty = torch.zeros((0, 64), dtype=torch.int32, device=device)
    with pytest.raises(ValueError):
        sh.segment_hist_labels(empty, empty, 1 << 20, 6)


def _hist_case(device, b, n, num_regions, num_classes, seed):
    rng = np.random.default_rng(seed)
    labels = torch.from_numpy(rng.integers(-1, num_classes + 1, (b, n)).astype(np.int32))
    regions = torch.from_numpy(rng.integers(-2, num_regions + 2, (b, n)).astype(np.int32))
    want = sh.segment_hist_labels_plain(labels, regions, num_regions, num_classes)
    return labels.to(device), regions.to(device), want


@pytest.mark.parametrize('b,n', [(2, 17), (3, 5), (1, 63), (5, 1), (4, 67), (2, 4 * 16 + 3)])
def test_segment_hist_cluster_edges(device, b, n):
    """Images smaller than 8 blocks x 4 pixels, so that the last blocks of an
    image's cluster count nothing and still take part in the reduction, and
    pixel counts off a multiple of 4 (every row after the first starts
    unaligned)."""
    labels, regions, want = _hist_case(device, b, n, 37, 5, seed=n)
    got = sh.segment_hist_labels(labels, regions, 37, 5)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


def test_segment_hist_at_the_shared_memory_limit(device):
    """R * C at the opt-in limit of a block's shared memory is taken, one more
    region is refused."""
    max_bins = sh._library().segment_hist_max_bins()
    assert max_bins == torch.cuda.get_device_properties(device).shared_memory_per_block_optin // 4
    num_classes = 2
    num_regions = max_bins // num_classes
    labels, regions, want = _hist_case(device, 2, 300_001, num_regions, num_classes, seed=1)
    got = sh.segment_hist_labels(labels, regions, num_regions, num_classes)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    with pytest.raises(ValueError):
        sh.segment_hist_labels(labels, regions, num_regions + 1, num_classes)
    # a refused launch leaves no error behind for the next one
    assert torch.equal(sh.segment_hist_labels(labels, regions, num_regions, num_classes)
                       .cpu(), want)


def test_segment_hist_writes_every_count_in_one_launch(device):
    """The output is not cleared first, so memory the allocator hands back full
    of NaN must come back as exact counts; a call is one kernel and no
    memset, and two calls agree bit for bit."""
    from torch.profiler import ProfilerActivity, profile
    labels, regions, want = _hist_case(device, 8, 512 * 512, 1024, 6, seed=3)
    for _ in range(3):
        junk = torch.full((8, 1024, 6), float('nan'), device=device)
        del junk
        got = sh.segment_hist_labels(labels, regions, 1024, 6)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want)
    again = sh.segment_hist_labels(labels, regions, 1024, 6)
    assert torch.equal(again, got)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sh.segment_hist_labels(labels, regions, 1024, 6)
        torch.cuda.synchronize()
    names = [ev.name for ev in prof.events() if str(ev.device_type).endswith('CUDA')]
    assert len(names) == 1 and 'segment_hist_kernel' in names[0], names


def test_homogenize_card_matches_cpu(device):
    rng = np.random.default_rng(0)
    regions = rng.integers(0, 1100, (4, 1, 1)) * np.ones((4, 64, 64), np.int64)
    regions = (regions + np.kron(rng.integers(0, 300, (4, 8, 8)),
                                 np.ones((8, 8), np.int64))).astype(np.int32)
    pseudo = np.where(rng.random(regions.shape) < 0.2, -1,
                      (regions * 3) % 6).astype(np.int32)
    want = homogenize(torch.from_numpy(pseudo), torch.from_numpy(regions))
    got = homogenize(torch.from_numpy(pseudo).to(device),
                     torch.from_numpy(regions).to(device))
    assert torch.equal(got.cpu(), want)


# bfloat16: kernel and plain round the same float32 value computed in another
# order (one step, 2^-8 relative); attention also rounds its probabilities
# relative to a running maximum (a second step)
_TOL = {('ln', torch.float32): dict(rtol=2e-5, atol=2e-5),
        ('ln', torch.bfloat16): dict(rtol=2 ** -7, atol=1e-5),
        ('attn', torch.float32): dict(rtol=2e-4, atol=2e-4),
        ('attn', torch.bfloat16): dict(rtol=2 ** -6, atol=2 ** -7)}


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('shape', [(2, 64, 64, 768), (24500, 768), (3, 768), (7, 9, 64),
                                   (1001, 1024), (333, 1280)])
def test_layernorm_kernel_matches_plain(device, shape, dtype):
    rng = np.random.default_rng(shape[0])
    x = torch.from_numpy((rng.normal(size=shape) * 2 + 0.5).astype(np.float32)).to(device, dtype)
    w = torch.from_numpy(rng.normal(size=shape[-1]).astype(np.float32)).to(device)
    b = torch.from_numpy(rng.normal(size=shape[-1]).astype(np.float32)).to(device)
    before = ln.launches
    got = ln.layernorm(x, w, b, 1e-6)
    assert ln.launches == before + 1
    want = ln.layernorm_plain(x, w, b, 1e-6)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == x.shape
    assert torch.allclose(got.float(), want.float(), **_TOL['ln', dtype])


def test_layernorm_kernel_rejects_other_widths_and_strides(device):
    w, b = torch.ones(96, device=device), torch.zeros(96, device=device)
    with pytest.raises(ValueError):
        ln.layernorm(torch.zeros(4, 96, device=device), w, b)
    x = torch.zeros(4, 128, device=device)[:, ::2]
    with pytest.raises(ValueError):
        ln.layernorm(x, torch.ones(64, device=device), torch.zeros(64, device=device))


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('b,heads,kh,kw,d', [(5, 12, 64, 64, 64), (1, 12, 64, 64, 64),
                                             (25, 12, 14, 14, 64),
                                             (3, 2, 14, 14, 32), (2, 2, 4, 4, 32),
                                             (2, 3, 5, 7, 64), (2, 2, 14, 14, 80),
                                             (2, 12, 32, 64, 64), (1, 4, 48, 48, 64),
                                             (1, 2, 3, 100, 64)])
def test_rel_attention_kernel_matches_plain(device, b, heads, kh, kw, d, dtype):
    rng = np.random.default_rng(kh * kw + d)
    n = kh * kw
    proj = torch.from_numpy(rng.normal(size=(b, n, 3 * heads * d)).astype(np.float32))
    # the ViT's own layout: a permuted view of the projection's output
    qkv = proj.to(device, dtype).reshape(b, n, 3, heads, d).permute(2, 0, 3, 1, 4)
    rh = torch.from_numpy(rng.normal(size=(b, heads, n, kh)).astype(np.float32)).to(device, dtype)
    rw = torch.from_numpy(rng.normal(size=(b, heads, n, kw)).astype(np.float32)).to(device, dtype)
    before = ra.launches
    got = ra.rel_attention(qkv, rh, rw, scale=d ** -0.5, kh=kh, kw=kw)
    assert ra.launches == before + 1
    want = ra.rel_attention_plain(qkv, rh, rw, d ** -0.5, kh, kw)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.allclose(got.float(), want.float(), **_TOL['attn', dtype])
    assert torch.equal(got, ra.rel_attention(qkv.contiguous(), rh, rw,
                                             scale=d ** -0.5, kh=kh, kw=kw))


def test_rel_attention_kernel_rejects_other_head_dims_and_strides(device):
    rh = rw = torch.zeros(1, 2, 16, 4, device=device)
    with pytest.raises(ValueError):
        ra.rel_attention(torch.zeros(3, 1, 2, 16, 48, device=device), rh, rw,
                         scale=1.0, kh=4, kw=4)
    with pytest.raises(ValueError):
        ra.rel_attention(torch.zeros(3, 1, 2, 16, 64, device=device)[..., ::2], rh, rw,
                         scale=1.0, kh=4, kw=4)
    # a refused launch leaves no error behind for the next one
    out = ra.rel_attention(torch.zeros(3, 1, 2, 16, 64, device=device), rh, rw,
                           scale=1.0, kh=4, kw=4)
    torch.cuda.synchronize()
    assert bool((out == 0).all())


def test_kernel_gradients_go_through_the_plain_versions(device):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(6, 64)).astype(np.float32)).to(device)
    w = torch.from_numpy(rng.normal(size=64).astype(np.float32)).to(device)
    b = torch.zeros(64, device=device)
    grads = []
    for fn in (ln.layernorm, ln.layernorm_plain):
        leaves = [t.clone().requires_grad_() for t in (x, w, b)]
        (fn(*leaves) ** 2).sum().backward()
        grads.append([t.grad for t in leaves])
    for got, want in zip(*grads):
        assert torch.allclose(got, want, rtol=1e-4, atol=1e-4)


def test_sam_encode_card_matches_cpu(device):
    """vit_t SAM in f32: kernels on the card against plain versions on the CPU."""
    from regda_tpu_torch.entry import sam_entry
    model, (images, points, labels) = sam_entry(
        'cpu', vit_config='vit_t', img_size=128, crops=2, points=3, dtype=torch.float32)
    with torch.inference_mode():
        want = model(images[:1], points, labels)
        before = ln.launches, ra.launches
        got = model.to(device)(images[:1].to(device), points.to(device), labels.to(device))
    assert (ln.launches - before[0], ra.launches - before[1]) == (4, 2)
    for g, w in zip(got, want):
        assert torch.allclose(g.cpu(), w, rtol=1e-3, atol=1e-3)


# the two-way transformer and the mask head: float32 within 2e-4; bfloat16 in
# steps of 2^-8 times the largest magnitude of the plain version's result
# (kernel and plain round the same chain but sum in another order)
def _assert_kernel_close(got, want, dtype, steps):
    got, want = got.float(), want.float()
    assert bool(torch.isfinite(got).all())
    if dtype == torch.float32:
        assert torch.allclose(got, want, rtol=2e-4, atol=2e-4)
    else:
        assert float((got - want).abs().max()) <= steps * 2.0 ** -8 * float(want.abs().max())


def _two_way_operands(rng, device, dtype, b, t, n, mlp):
    def f(*shape, scale=1.0):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32)).to(device)
    acts = [f(b, 8, 128), f(b, 8, 128), f(b, 8, 256), f(b, 8, 256),
            f(t, 256), f(t, 256), f(t, 128)]
    for a in acts[:4]:
        a[:, n:] = 0
    maskb = torch.where(torch.arange(8, device=device) < n, 0.0, -1e9)[None].float()
    w = {k: f(*shape, scale=shape[0] ** -0.5 if len(shape) == 2 else 0.1)
         for k, shape in tw._weight_shapes(256, 128, mlp).items()}
    return (*(a.to(dtype) for a in acts), maskb, w)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('b,t,n,mlp', [(64, 4096, 7, 2048), (1, 4096, 7, 2048),
                                       (3, 64, 5, 512), (2, 200, 8, 256), (300, 64, 7, 256),
                                       (256, 1000, 7, 2048)])
def test_two_way_kernel_matches_plain(device, b, t, n, mlp, dtype):
    ops = _two_way_operands(np.random.default_rng(b + t), device, dtype, b, t, n, mlp)
    before = tw.launches
    keys2, qout = tw.two_way_fused(ops)
    assert tw.launches == before + 1
    want_k, want_q = tw.two_way_plain(ops)
    torch.cuda.synchronize()
    assert keys2.dtype == qout.dtype == dtype
    assert keys2.shape == want_k.shape and qout.shape == want_q.shape
    _assert_kernel_close(keys2, want_k, dtype, 8)
    _assert_kernel_close(qout[:, :n], want_q[:, :n], dtype, 8)


def test_two_way_kernel_rejects_other_widths(device):
    ops = _two_way_operands(np.random.default_rng(0), device, torch.float32, 1, 64, 7, 384)
    with pytest.raises(ValueError):
        tw.two_way_fused(ops)


def _upscale_args(rng, device, dtype, b, h, w, m):
    def f(*shape, scale=1.0):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32)).to(device)
    return (f(b, h, w, 256).to(dtype), f(b, m, 32).to(dtype), f(256, 256, scale=1 / 16).to(dtype),
            f(1, 256, scale=0.1), 1 + f(1, 64, scale=0.1), f(1, 64, scale=0.1),
            f(64, 128, scale=1 / 8).to(dtype), f(1, 128, scale=0.1))


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('b,h,w,m,blocked,gated', [
    (64, 64, 64, 3, True, False), (1, 64, 64, 3, False, False), (3, 8, 8, 1, True, False),
    (2, 8, 8, 4, False, False), (5, 12, 12, 3, True, True), (5, 12, 12, 3, False, True)])
def test_upscale_kernel_matches_plain(device, b, h, w, m, blocked, gated, dtype):
    rng = np.random.default_rng(b * h + m)
    args = _upscale_args(rng, device, dtype, b, h, w, m)
    active = None
    if gated:
        active = torch.from_numpy(rng.random(b) < 0.5).to(device)
        active[0], active[1] = True, False
    before = up.launches
    got = up.upscale_hyper_masks(*args, out_dtype=dtype, active=active, blocked=blocked)
    assert up.launches == before + 1
    want = up.upscale_plain(*args, dtype, active, blocked)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    _assert_kernel_close(got, want, dtype, 4)
    if gated:
        assert bool((got[~active] == 0).all())


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('b,h,w,m,blocked,gate,out_dtype', [
    (1, 5, 7, 1, True, None, None), (1, 5, 7, 4, False, None, None),
    (2, 9, 9, 4, True, 'none', None), (3, 5, 7, 3, True, 'all', None),
    (3, 5, 7, 3, False, 'all', None), (2, 9, 9, 4, False, None, torch.float32),
    (1, 64, 64, 4, True, None, torch.float32), (300, 8, 8, 3, True, 'some', None)])
def test_upscale_kernel_tile_edges(device, b, h, w, m, blocked, gate, out_dtype, dtype):
    """The bf16 kernel's tiles of 64 pixels: HW below a tile and past a
    whole number of them (5 x 7, 9 x 9), one prompt (one consumer warpgroup
    idle), more tiles than two per SM, M = 1 and 4, float32 output, every
    prompt gated and none, both layouts."""
    rng = np.random.default_rng(b * h * w + m)
    args = _upscale_args(rng, device, dtype, b, h, w, m)
    active = None
    if gate is not None:
        active = torch.from_numpy(rng.random(b) < 0.5).to(device)
        active[:] = {'all': False, 'none': True}.get(gate, active)
    odt = out_dtype or dtype
    got = up.upscale_hyper_masks(*args, out_dtype=odt, active=active, blocked=blocked)
    want = up.upscale_plain(*args, odt, active, blocked)
    torch.cuda.synchronize()
    assert got.dtype == odt and got.shape == want.shape
    _assert_kernel_close(got, want, torch.float32 if odt == dtype == torch.float32
                         else torch.bfloat16, 4)
    if active is not None:
        assert bool((got[~active] == 0).all())
    if gate == 'all':
        assert not bool(got.any())


def test_upscale_kernel_rejects_other_widths_and_dtypes(device):
    rng = np.random.default_rng(0)
    args = _upscale_args(rng, device, torch.float32, 1, 4, 4, 3)
    with pytest.raises(ValueError):   # src of another dtype than the weights
        up.upscale_hyper_masks(args[0].bfloat16(), *args[1:])
    with pytest.raises(ValueError):   # five hypernetwork rows
        up.upscale_hyper_masks(args[0], torch.zeros(1, 5, 32, device=device), *args[2:])
    narrow = (torch.zeros(1, 4, 4, 64, device=device), torch.zeros(1, 3, 8, device=device),
              torch.zeros(64, 64, device=device), torch.zeros(1, 64, device=device),
              torch.zeros(1, 16, device=device), torch.zeros(1, 16, device=device),
              torch.zeros(16, 32, device=device), torch.zeros(1, 32, device=device))
    with pytest.raises(ValueError):   # C = 64
        up.upscale_hyper_masks(*narrow)
    # a refused launch leaves no error behind for the next one
    out = up.upscale_hyper_masks(*args)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all())


def test_empty_inputs_launch_nothing_and_are_not_counted(device):
    rng = np.random.default_rng(2)
    counts = lambda: (sh.launches, ln.launches, ra.launches, tw.launches,  # noqa: E731
                      tw.cuda_launches, up.launches)
    before = counts()
    empty = torch.zeros((0, 64), dtype=torch.int32, device=device)
    assert sh.segment_hist_labels(empty, empty, 4, 3).shape == (0, 4, 3)
    x = torch.zeros((0, 768), device=device)
    assert ln.layernorm(x, torch.ones(768, device=device),
                        torch.zeros(768, device=device)).shape == (0, 768)
    qkv = torch.zeros((3, 0, 12, 16, 64), device=device)
    rel = torch.zeros((0, 12, 16, 4), device=device)
    assert ra.rel_attention(qkv, rel, rel, scale=0.125, kh=4, kw=4).shape == (0, 12, 16, 64)
    keys2, qout = tw.two_way_fused(_two_way_operands(rng, device, torch.float32, 0, 64, 7, 256))
    assert keys2.shape == (0, 64, 256) and qout.shape == (0, 8, 256)
    with pytest.raises(ValueError, match='image token'):
        tw.two_way_fused(_two_way_operands(rng, device, torch.float32, 2, 0, 7, 256))
    args = _upscale_args(rng, device, torch.float32, 0, 4, 4, 3)
    assert up.upscale_hyper_masks(*args).shape == (0, 3, 16, 16)
    assert up.upscale_hyper_masks(*args, blocked=True).shape == (0, 48, 16)
    assert counts() == before


def test_two_way_counts_the_kernels_it_queues(device):
    rng = np.random.default_rng(3)
    per_call = set()
    for dtype, b, t, mlp in ((torch.float32, 2, 200, 256), (torch.bfloat16, 3, 64, 512),
                             (torch.bfloat16, 64, 4096, 2048)):
        before = tw.launches, tw.cuda_launches
        tw.two_way_fused(_two_way_operands(rng, device, dtype, b, t, 7, mlp))
        assert tw.launches == before[0] + 1
        per_call.add(tw.cuda_launches - before[1])
    torch.cuda.synchronize()
    assert len(per_call) == 1 and per_call.pop() > 0   # the chain is the same for all sizes
    assert tw.cuda_launches - before[1] == 5   # prep, pass A, mid, pass B, final


def test_two_way_bf16_allocates_no_key_scratch(device):
    """keys1 never reaches device memory: at 64 prompts the call holds its
    cast weights, keys2 and the queries, the scratch slots and the partials,
    and less than 64 MB besides, where a (B, T, 256) keys1 buffer is 134 MB."""
    b, t, mlp = 64, 4096, 2048
    ops = _two_way_operands(np.random.default_rng(4), device, torch.bfloat16, b, t, 7, mlp)
    tw.two_way_fused(ops)   # first use: the library and the allocator's pools
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    keys2, qout = tw.two_way_fused(ops)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    _, splits = tw.column_splits(b, t, sms)
    weights = sum(w.numel() * 2 for w in ops[8].values() if w.ndim == 2)
    scratch = b * 5 * 64 * 256 * 2
    partials = b * (splits * (64 * 256 + 2 * 64) + 8 * 256 + 64) * 4
    held = weights + keys2.numel() * 2 + qout.numel() * 2 + scratch + partials
    assert peak <= held + 64 * 2 ** 20, (peak, held)


def test_fast_kernel_gradients_go_through_the_plain_versions(device):
    rng = np.random.default_rng(1)
    args = _upscale_args(rng, device, torch.float32, 1, 4, 4, 3)
    grads = []
    for fn in (up.upscale_hyper_masks, up.upscale_plain):
        leaves = [t.clone().requires_grad_() for t in args]
        (fn(*leaves) ** 2).sum().backward()
        grads.append([t.grad for t in leaves])
    for got, want in zip(*grads):
        assert torch.allclose(got, want, rtol=1e-3, atol=1e-3)
    ops = _two_way_operands(rng, device, torch.float32, 2, 64, 7, 256)
    grads = []
    for fn in (tw.two_way_fused, tw.two_way_plain):
        leaves = [t.clone().requires_grad_() for t in ops[:7]]
        keys2, qout = fn((*leaves, *ops[7:]))
        ((keys2 ** 2).sum() + (qout[:, :7] ** 2).sum()).backward()
        grads.append([t.grad for t in leaves])
    for got, want in zip(*grads):
        assert torch.allclose(got, want, rtol=1e-3, atol=1e-3)


def test_sam_fast_decode_card_matches_cpu_and_stock(device):
    """vit_t SAM in f32: the fast decode's kernels on the card against the
    plain versions on the CPU and against the stock decode on the card."""
    from regda_tpu_torch.entry import sam_entry
    model, (_, points, labels) = sam_entry(
        'cpu', vit_config='vit_t', img_size=128, crops=1, points=5, dtype=torch.float32)
    emb = torch.from_numpy(np.random.default_rng(2).normal(size=(1, 8, 8, 256))
                           .astype(np.float32))
    with torch.inference_mode():
        want = model.decode_points_fast(emb, points, labels, blocked_masks=True)
        model.to(device)
        args = (emb.to(device), points.to(device), labels.to(device))
        before = tw.launches, up.launches
        got = model.decode_points_fast(*args, blocked_masks=True)
        assert (tw.launches - before[0], up.launches - before[1]) == (1, 1)
        stock = model.decode_points(*args)
    for g, w in zip(got, want):
        assert torch.allclose(g.cpu(), w, rtol=1e-3, atol=1e-3)
    assert torch.allclose(up.masks_from_blocked(got[0], 8, 8), stock[0], rtol=1e-3, atol=1e-3)
    assert torch.allclose(got[1], stock[1], rtol=1e-3, atol=1e-3)


def _resize_inputs(device, dtype, m, s, ch, cw, seed):
    from regda_tpu_torch.ops.resize import _interp_matrix_half_pixel
    rng = np.random.default_rng(seed)
    logits = torch.from_numpy((rng.normal(size=(m, s, s)) * 2).astype(np.float32)).to(device, dtype)
    frame = st.ResizeFrame(_interp_matrix_half_pixel(s, ch), _interp_matrix_half_pixel(s, cw),
                           device)
    active = torch.from_numpy(np.arange(m) % 2 == 0).to(device)
    return logits, frame, active


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('entry', ['blocked', 'fused'])
@pytest.mark.parametrize('m,s,ch,cw', [(7, 32, 51, 77), (5, 32, 100, 96), (3, 64, 37, 200)])
def test_stability_kernel_matches_plain(device, m, s, ch, cw, entry, dtype):
    logits, frame, active = _resize_inputs(device, dtype, m, s, ch, cw, seed=ch)
    before = (st.launches_blocked, st.launches_fused)
    if entry == 'blocked':
        blk = st.block_masks(logits, s // 4, s // 4).contiguous()
        inter, union = st.stability_counts_blocked(blk, frame, s // 4, s // 4, 1.0, active)
        assert (st.launches_blocked, st.launches_fused) == (before[0] + 1, before[1])
    else:
        inter, union = st.stability_counts_fused(logits, frame, 1.0, active)
        assert (st.launches_blocked, st.launches_fused) == (before[0], before[1] + 1)
    want_i, want_u = st.stability_counts_plain(logits, frame.m_h, frame.m_wt, 1.0, active)
    torch.cuda.synchronize()
    limit = 1 + (1e-5 if dtype == torch.float32 else 1e-4) * ch * cw
    assert float((inter - want_i).abs().max()) <= limit
    assert float((union - want_u).abs().max()) <= limit
    assert not bool(inter[~active].any() or union[~active].any())
    assert float(union.max()) > 0


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('entry', ['blocked', 'fused'])
@pytest.mark.parametrize('m,s,ch,cw,gate', [
    (5, 32, 20, 300, 'some'), (3, 256, 343, 343, 'some'), (4, 32, 51, 77, None),
    (2, 64, 40, 700, None), (6, 32, 51, 77, 'all')])
def test_stability_kernel_strip_edges(device, m, s, ch, cw, gate, entry, dtype):
    """The kernel's strips and column ownership: a frame shorter than one
    strip, widths that are no multiple of the 256 threads (300, 343) and
    wider than the columns a thread keeps in registers (700), the main
    path's 343^2 frame from 256^2 logits, and every candidate gated."""
    logits, frame, active = _resize_inputs(device, dtype, m, s, ch, cw, seed=ch + cw)
    if gate is None:
        active = None
    elif gate == 'all':
        active[:] = False
    if entry == 'blocked':
        blk = st.block_masks(logits, s // 4, s // 4).contiguous()
        inter, union = st.stability_counts_blocked(blk, frame, s // 4, s // 4, 1.0, active)
    else:
        inter, union = st.stability_counts_fused(logits, frame, 1.0, active)
    want_i, want_u = st.stability_counts_plain(logits, frame.m_h, frame.m_wt, 1.0, active)
    torch.cuda.synchronize()
    limit = 1 + (1e-5 if dtype == torch.float32 else 1e-4) * ch * cw
    assert float((inter - want_i).abs().max()) <= limit
    assert float((union - want_u).abs().max()) <= limit
    if active is not None:
        assert not bool(inter[~active].any() or union[~active].any())
    if gate == 'all':
        assert not bool(inter.any() or union.any())
    else:
        assert float(union.max()) > 0


def test_stability_kernel_non_square_source(device):
    """h != w: planes of (h, w), a (4h, 4w) source, both entries."""
    from regda_tpu_torch.ops.resize import _interp_matrix_half_pixel
    rng = np.random.default_rng(3)
    m, h, w, ch, cw = 4, 8, 12, 40, 50
    blk = torch.from_numpy((rng.normal(size=(m, 16 * h, w)) * 2).astype(np.float32)).to(device)
    frame = st.ResizeFrame(_interp_matrix_half_pixel(4 * h, ch),
                           _interp_matrix_half_pixel(4 * w, cw), device)
    il = st.unblock_masks(blk, h, w).contiguous()
    want = st.stability_counts_plain(il, frame.m_h, frame.m_wt, 1.0)
    for got in (st.stability_counts_blocked(blk, frame, h, w, 1.0),
                st.stability_counts_fused(il, frame, 1.0)):
        torch.cuda.synchronize()
        assert float((got[0] - want[0]).abs().max()) <= 1
        assert float((got[1] - want[1]).abs().max()) <= 1
    bits, boxes, areas = ms.mask_stats_fused(il, frame)
    w_bits, w_boxes, w_areas = ms.mask_stats_plain(il, frame.m_h, frame.m_wt, ch, cw)
    assert torch.equal(bits, w_bits) and torch.equal(boxes, w_boxes)
    assert torch.equal(areas, w_areas)


def test_stability_kernel_refuses_a_dense_matrix(device):
    """A matrix with more than four taps a row has no band form, so no frame;
    and the kernel takes contiguous logits only."""
    dense = np.ones((20, 16), np.float32)
    with pytest.raises(ValueError):
        st.ResizeFrame(dense, dense, device)
    from regda_tpu_torch.ops.resize import _interp_matrix_half_pixel
    frame = st.ResizeFrame(_interp_matrix_half_pixel(8, 20), _interp_matrix_half_pixel(16, 20),
                           device)
    logits = torch.zeros((2, 16, 16), device=device)
    with pytest.raises(ValueError):
        st.stability_counts_fused(logits[:, ::2], frame)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('m,s,ch,cw', [(7, 32, 51, 77), (5, 32, 100, 96), (3, 64, 37, 200)])
def test_mask_stats_kernel_matches_plain(device, m, s, ch, cw, dtype):
    logits, frame, active = _resize_inputs(device, dtype, m, s, ch, cw, seed=cw)
    m_h, m_wt = frame.m_h, frame.m_wt
    logits[m - 1] = -1.0                               # an empty mask
    before = ms.launches
    bits, boxes, areas = ms.mask_stats_fused(logits, frame, active=active)
    assert ms.launches == before + 1
    w_bits, w_boxes, w_areas = ms.mask_stats_plain(logits, m_h, m_wt, ch, cw, active)
    torch.cuda.synchronize()
    assert bits.dtype == torch.uint8 and tuple(bits.shape) == (m, ch, (cw + 7) // 8)
    diff = ms.unpack_bits(bits, cw) != ms.unpack_bits(w_bits, cw)
    if bool(diff.any()):     # only where the plain version's logit is within rounding of 0
        y = torch.matmul(torch.matmul(m_h, logits.float()), m_wt)
        assert float(y[diff].abs().max()) <= 2.0 ** -20 * float(logits.float().abs().max())
    else:
        assert torch.equal(boxes, w_boxes) and torch.equal(areas, w_areas)
    assert not bool(bits[~active].any() or boxes[~active].any() or areas[~active].any())
    assert float(areas[m - 1]) == 0 and not bool(boxes[m - 1].any())
    assert float(areas.max()) > 0


def _check_mask_stats(logits, frame, active):
    """The kernel against the plain version: bits equal except where the plain
    version's resized logit is within 2^-20 of the largest |logit| of 0, boxes
    and areas those of the kernel's own bits, padding bits and gated slots 0."""
    ch, cw = frame.ch, frame.cw
    before = ms.launches
    bits, boxes, areas = ms.mask_stats_fused(logits, frame, active=active)
    assert ms.launches == before + 1
    w_bits, w_boxes, w_areas = ms.mask_stats_plain(logits, frame.m_h, frame.m_wt, ch, cw, active)
    torch.cuda.synchronize()
    assert bits.dtype == torch.uint8 and tuple(bits.shape) == (len(logits), ch, (cw + 7) // 8)
    got = ms.unpack_bits(bits, cw).bool()
    diff = got != ms.unpack_bits(w_bits, cw).bool()
    if bool(diff.any()):
        y = torch.matmul(torch.matmul(frame.m_h, logits.float()), frame.m_wt)
        assert float(y[diff].abs().max()) <= 2.0 ** -20 * float(logits.float().abs().max())
    else:
        assert torch.equal(bits, w_bits)
    eye_h, eye_w = (torch.eye(n, device=logits.device) for n in (ch, cw))
    own = ms.mask_stats_plain(torch.where(got, 1.0, -1.0), eye_h, eye_w, ch, cw)
    assert torch.equal(boxes, own[1]) and torch.equal(areas, own[2])
    assert not bool(ms.unpack_bits(bits, 8 * bits.shape[-1])[..., cw:].any())
    if active is not None:
        assert not bool(bits[~active].any() or boxes[~active].any() or areas[~active].any())
    return bits, boxes, areas


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('m,s,ch,cw,gate', [
    (7, 32, 51, 77, None), (7, 32, 51, 77, 'some'), (5, 32, 100, 96, 'all'),
    (5, 32, 100, 96, 'none'), (3, 64, 37, 200, 'some'), (4, 32, 20, 700, 'some')])
def test_mask_stats_kernel_ragged_frames_and_gates(device, m, s, ch, cw, gate, dtype):
    """phase 1's interleaved ragged frames and gates: a frame shorter than one
    strip, widths off a multiple of 32 and of the bytes of a word, a frame
    wider than the columns the threads keep in registers (700), every slot
    on, some, none."""
    logits, frame, active = _resize_inputs(device, dtype, m, s, ch, cw, seed=ch * cw)
    logits[m - 1] = -1.0                               # an empty mask
    if gate is None:
        active = None
    elif gate != 'some':
        active[:] = gate == 'all'
    bits, boxes, areas = _check_mask_stats(logits, frame, active)
    if gate != 'none':
        assert float(areas[m - 1]) == 0 and not bool(boxes[m - 1].any())
        assert float(areas.max()) > 0
    else:
        assert not bool(bits.any() or boxes.any() or areas.any())


@pytest.mark.parametrize('cw', [1, 7, 9, 77, 32, 64, 96])
def test_mask_stats_kernel_byte_order(device, cw):
    """The packed rows at widths that end inside the first byte, inside a
    32-bit word, and on whole words: a mask whose columns follow a pattern
    that tells neighbouring bits and bytes apart, bit for bit against
    numpy.packbits of the plain version's mask."""
    from regda_tpu_torch.ops.resize import _interp_matrix_half_pixel
    ch, s, sw = 45, 32, max(cw, 4)
    frame = ms.ResizeFrame(_interp_matrix_half_pixel(s, ch), np.eye(cw, sw, dtype=np.float32),
                           device)
    rng = np.random.default_rng(cw)
    cols = np.where(np.arange(sw) % 3 == 1, 1.0, -1.0) * (1 + rng.random(sw))
    rows = 1 + np.arange(s)[:, None] / s               # positive: a column keeps its sign
    logits = np.stack([cols * rows, -cols * rows[::-1]]).astype(np.float32)
    bits, _, _ = _check_mask_stats(torch.from_numpy(logits).to(device), frame, None)
    mask = np.broadcast_to(np.stack([cols[:cw] > 0, cols[:cw] < 0])[:, None], (2, ch, cw))
    assert np.array_equal(bits.cpu().numpy(), np.packbits(mask, axis=-1))


@pytest.mark.parametrize('crop', [512, 343])
def test_mask_stats_kernel_main_path_frames(device, crop):
    """The main path's composed matrices (256^2 bf16 logits to a 512^2 crop 0
    and a 343^2 layer-1 crop), 64 slots, half of them gated."""
    from regda_tpu_torch.models.sam.auto import composed_resize_matrices
    rng = np.random.default_rng(crop)
    m_h, m_w = composed_resize_matrices(1024, (1024, 1024, crop, crop), 256)
    frame = ms.ResizeFrame(m_h, m_w, device)
    logits = torch.from_numpy((rng.normal(size=(64, 256, 256)) * 2).astype(np.float32))
    logits = logits.to(device, torch.bfloat16)
    active = torch.from_numpy(np.arange(64) % 2 == 0).to(device)
    _, _, areas = _check_mask_stats(logits, frame, active)
    assert float(areas.max()) > 0


# ---- the serve path: cuDNN's fused conv epilogue and SegInferencer -----------

@pytest.fixture
def no_tf32():
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.mark.parametrize('cin,cout,k,stride,dilation,residual', [
    (3, 64, 7, 2, 1, False), (256, 64, 1, 1, 1, False), (128, 128, 3, 2, 1, False),
    (512, 512, 3, 1, 2, False), (64, 256, 1, 1, 1, True), (2560, 512, 3, 1, 1, True)])
def test_conv_bias_act_card_matches_cpu(device, no_tf32, cin, cout, k, stride, dilation,
                                        residual):
    """The folded model's conv epilogue: one cuDNN call on the card (bias,
    residual and ReLU fused) against the plain ops on the CPU, f32. The sums
    run to 2560 x 9 products in other orders, on values up to ~5: rtol 1e-4,
    atol 1e-4."""
    from regda_tpu_torch.models.resnet import conv_bias_act
    g = torch.Generator().manual_seed(cin + k)
    x = torch.randn(2, cin, 33, 30, generator=g)
    w = torch.randn(cout, cin, k, k, generator=g) / (cin * k * k) ** 0.5
    b = torch.randn(cout, generator=g)
    pad = dilation * (k // 2)
    out_hw = [(n + 2 * pad - dilation * (k - 1) - 1) // stride + 1 for n in (33, 30)]
    z = torch.randn(2, cout, *out_hw, generator=g) if residual else None
    args = ((stride, stride), (pad, pad), (dilation, dilation), True)
    want = conv_bias_act(x, w, b, *args, z)
    got = conv_bias_act(x.to(device, memory_format=torch.channels_last), w.to(device),
                        b.to(device), *args,
                        None if z is None else z.to(device, memory_format=torch.channels_last))
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


def test_seg_inferencer_card_matches_cpu(device, no_tf32):
    """resnet18, f32, folded and fused, slide + TTA on an image that is not a
    multiple of the tile, and the labels."""
    import copy
    from regda_tpu_torch.entry import seed_bn_statistics
    from regda_tpu_torch.infer import SegInferencer
    from regda_tpu_torch.models import build_deeplabv2
    g = torch.Generator().manual_seed(5)
    model = build_deeplabv2('resnet18', 6, generator=g)
    seed_bn_statistics(model, g)
    image = torch.randn(1, 96, 80, 3, generator=g).numpy()
    cpu = SegInferencer(model.eval(), 6, tile=64, stride=32)
    card = SegInferencer(copy.deepcopy(model).to(device), 6, tile=64, stride=32)
    assert card.model.folded and card.fused_ppm
    want = cpu.predict_probs(image, slide=True, tta=True)
    got = card.predict_probs(image, slide=True, tta=True)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    labels = card.predict_labels(image, slide=True, tta=True)
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 1e-4
    assert np.array_equal(labels[clear], want.argmax(-1)[clear])


def test_folded_fused_forward_matches_stock_bf16(device):
    """ResNet-101 at 2 x 256^2 in bf16: the served forward (folded, fused)
    against the stock forward of the same weights, within chip_smoke.py's
    FOLDED_VS_STOCK_BF16_STEPS (20) bf16 steps of the largest probability."""
    from regda_tpu_torch.entry import serve_entry
    folded, images = serve_entry(device, images=2, size=256, tile=256)
    stock, _ = serve_entry(device, images=2, size=256, tile=256, fold_bn=False)
    got = folded.predict_probs(images, slide=False)
    want = stock.predict_probs(images, slide=False)
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= 20 * 2.0 ** -8 * np.abs(want).max()


_LAYOUT_TRANSPOSES = ('nhwcToNchw', 'nchwToNhwc')
_FUSED_CONVS = ('aten::cudnn_convolution_relu', 'aten::cudnn_convolution_add_relu')
# the elementwise kernels of an add and a ReLU: a fused conv call whose bias,
# residual or ReLU fell out of cuDNN's epilogue would launch some
_ELEMENTWISE = ('CUDAFunctor_add', 'clamp')


def _launched(event) -> list:
    """The device kernels launched under a profiled operator, its children's
    included."""
    return [k.name for k in event.kernels] + [
        name for child in event.cpu_children for name in _launched(child)]


def _profiled_forward(model, x):
    """(probs, the device kernels' names, the fused cuDNN conv calls, the add
    and ReLU kernels launched inside them) of one eval forward."""
    from torch.profiler import ProfilerActivity, profile
    from regda_tpu_torch.models.fused_eval import eval_forward
    with torch.inference_mode():
        eval_forward(model, x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            probs = eval_forward(model, x)
            torch.cuda.synchronize()
    events = prof.events()
    kernels = [ev.name for ev in events if str(ev.device_type).endswith('CUDA')]
    fused = [ev for ev in events if ev.name in _FUSED_CONVS]
    unfused = [k for ev in fused for k in _launched(ev) if any(n in k for n in _ELEMENTWISE)]
    return probs, kernels, len(fused), unfused


def test_f32_folded_forward_runs_no_layout_transposes(device, no_tf32):
    """ResNet-101 at 2 x 256^2, f32, TF32 off, from a channels-last source
    (as the CLIs build it): the folded model is NCHW and its eval forward
    runs no cuDNN layout transpose, as many fused cuDNN conv calls as the
    channels-last folded forward, none of them launching an add or a ReLU
    of its own, and equals it."""
    import copy
    from regda_tpu_torch.entry import seed_bn_statistics
    from regda_tpu_torch.models import build_deeplabv2
    from regda_tpu_torch.models.fold_bn import folded_model
    g = torch.Generator().manual_seed(11)
    model = build_deeplabv2('ResNet101', 6, generator=g)
    seed_bn_statistics(model, g)
    folded = folded_model(model.to(device, memory_format=torch.channels_last).eval())
    assert all(p.is_contiguous() for p in folded.parameters())
    channels_last = copy.deepcopy(folded).to(memory_format=torch.channels_last)
    x = torch.randn(2, 256, 256, 3, generator=g).to(device)
    got, kernels, fused, unfused = _profiled_forward(folded, x)
    want, cl_kernels, cl_fused, cl_unfused = _profiled_forward(channels_last, x)
    transposes = [k for k in kernels if any(t in k for t in _LAYOUT_TRANSPOSES)]
    cl_transposes = [k for k in cl_kernels if any(t in k for t in _LAYOUT_TRANSPOSES)]
    assert transposes == [] and len(cl_transposes) > 0, (transposes, len(cl_transposes))
    assert fused == cl_fused > 100
    assert unfused == [] and cl_unfused == [], (unfused, cl_unfused)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
