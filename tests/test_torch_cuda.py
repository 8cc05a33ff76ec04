"""Tests of the port's CUDA kernels on the card (marker `cuda`).

They skip on a machine without a CUDA device. On an H100 run them with

    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

(`--noconftest`: tests/conftest.py imports jax, which a GPU host may lack.)

Each kernel is held against its plain PyTorch version on the same device
(the histogram exactly; LayerNorm and attention within the tolerances of
chip_smoke.py), and the wrapper's launch counter is checked.
"""

import numpy as np
import pytest
import torch

from regda_tpu_torch.ops.kernels import layernorm as ln
from regda_tpu_torch.ops.kernels import rel_attention as ra
from regda_tpu_torch.ops.kernels import segment_hist as sh
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
                                             (2, 3, 5, 7, 64), (2, 2, 14, 14, 80)])
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
