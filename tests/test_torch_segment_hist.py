"""The port's segment histogram and LRH against the JAX package, on the CPU.

On the CPU the wrapper takes its plain version; it is held exactly against
the Pallas kernel in interpret mode (as tests/test_pallas_lrh.py runs it)
and against the JAX `segment_sum` path. The CUDA kernel itself is held
against the plain version on the card by tests/test_torch_cuda.py and
chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from regda_tpu.ops.labels import one_hot_ignore as jax_one_hot_ignore
from regda_tpu.ops.lrh import homogenize as jax_homogenize
from regda_tpu.ops.lrh import region_histogram as jax_region_histogram
from regda_tpu.ops.pallas.segment_hist import segment_hist_labels_pallas
from regda_tpu_torch.ops import lrh
from regda_tpu_torch.ops.kernels import segment_hist as sh

HIST_CASES = [(64, 6, 2048), (64, 7, 1000), (1024, 6, 2048), (1024, 7, 1001)]


def _ids(seed, b, n, num_regions, num_classes):
    """Labels with -1 and values >= C; region ids with out-of-range values."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(-1, num_classes + 2, (b, n)).astype(np.int32)
    regions = rng.integers(-2, num_regions + 5, (b, n)).astype(np.int32)
    return labels, regions


@pytest.mark.parametrize('num_regions,num_classes,n', HIST_CASES)
def test_plain_hist_matches_pallas_interpret(num_regions, num_classes, n):
    labels, regions = _ids(n + num_regions, 2, n, num_regions, num_classes)
    want = np.asarray(segment_hist_labels_pallas(
        jnp.asarray(labels), jnp.asarray(regions), num_regions, num_classes,
        interpret=True))
    before = sh.launches
    got = sh.segment_hist_labels(torch.from_numpy(labels),
                                 torch.from_numpy(regions), num_regions, num_classes)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert sh.launches == before  # the plain version is not a kernel launch


@pytest.mark.parametrize('num_regions,num_classes,n', HIST_CASES)
def test_region_histogram_matches_segment_sum(num_regions, num_classes, n):
    labels, regions = _ids(7 * n + num_classes, 2, n, num_regions, num_classes)
    labels = np.where(labels >= num_classes, -1, labels)  # one-hot input
    want = np.asarray(jax_region_histogram(
        jax_one_hot_ignore(jnp.asarray(labels), num_classes),
        jnp.asarray(regions), num_regions, use_pallas=False))
    oh = torch.nn.functional.one_hot(torch.from_numpy(labels).long() + 1,
                                     num_classes + 1)[..., 1:].float()
    got = lrh.region_histogram(oh, torch.from_numpy(regions), num_regions)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize('bad', ['int64', 'shape', 'strided', 'meta', 'no_regions'])
def test_wrapper_rejects(bad):
    lab = torch.zeros((2, 64), dtype=torch.int32)
    reg = torch.zeros((2, 64), dtype=torch.int32)
    r, c = 16, 6
    if bad == 'int64':
        lab = lab.long()
    elif bad == 'shape':
        reg = reg[:, :32].contiguous()
    elif bad == 'strided':
        lab = torch.zeros((2, 128), dtype=torch.int32)[:, ::2]
    elif bad == 'meta':
        lab, reg = lab.to('meta'), reg.to('meta')
    elif bad == 'no_regions':
        r = 0
    with pytest.raises((TypeError, ValueError)):
        sh.segment_hist_labels(lab, reg, r, c)


def _ragged_maps(seed, b, h, w, num_regions, num_classes):
    """Region maps of rectangles of random size, with over-budget and negative
    ids, and pseudo-labels that mostly follow the region, with noise and -1."""
    rng = np.random.default_rng(seed)
    regions = np.zeros((b, h, w), np.int32)
    for i in range(b):
        for _ in range(40):
            y0, x0 = rng.integers(0, h), rng.integers(0, w)
            dh, dw = rng.integers(2, h // 2), rng.integers(2, w // 2)
            regions[i, y0:y0 + dh, x0:x0 + dw] = rng.integers(-1, num_regions + 40)
    pseudo = (regions * 5 + 1) % num_classes
    noise = rng.random((b, h, w))
    pseudo = np.where(noise < 0.25, rng.integers(-1, num_classes, (b, h, w)), pseudo)
    pseudo = np.where(noise > 0.9, -1, pseudo)
    return pseudo.astype(np.int32), regions


@pytest.mark.parametrize('num_regions', [32, 1024])
@pytest.mark.parametrize('use_pallas', [False, True])
def test_homogenize_matches_jax(use_pallas, num_regions):
    pseudo, regions = _ragged_maps(num_regions + use_pallas, 2, 64, 48,
                                   num_regions, 6)
    want = np.asarray(jax_homogenize(jnp.asarray(pseudo), jnp.asarray(regions),
                                     percent=0.5, num_classes=6,
                                     num_regions=num_regions, use_pallas=use_pallas))
    got = lrh.homogenize(torch.from_numpy(pseudo), torch.from_numpy(regions),
                         percent=0.5, num_classes=6, num_regions=num_regions)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want != pseudo).any()  # LRH changed some labels


@pytest.mark.parametrize('kind', ['over_budget', 'one_region_one_label', 'ignore_c7_odd_n',
                                  'one_pixel', 'last_bin_only'])
def test_hist_edge_cases_match_pallas_interpret(kind):
    """Inputs at the edges of what is counted, against the Pallas kernel in
    interpret mode: every region id over the budget (all zeros); one region
    and one label over the whole image; C = 7 with ignore labels at B = 3 and
    an odd N; N = 1; every pixel in the last bin of the histogram."""
    rng = np.random.default_rng(len(kind))
    num_regions, num_classes, b, n = 64, 6, 2, 1000
    if kind == 'over_budget':
        labels = rng.integers(0, num_classes, (b, n))
        regions = rng.integers(num_regions, num_regions + 500, (b, n))
    elif kind == 'one_region_one_label':
        labels, regions = np.full((b, n), 3), np.full((b, n), 17)
    elif kind == 'ignore_c7_odd_n':
        num_classes, b, n = 7, 3, 1001
        labels = np.where(rng.random((b, n)) < 0.3, -1, rng.integers(0, 9, (b, n)))
        regions = rng.integers(-1, num_regions + 3, (b, n))
    elif kind == 'one_pixel':
        b, n = 3, 1
        labels, regions = np.array([[2], [-1], [5]]), np.array([[0], [1], [63]])
    else:
        labels = np.full((b, n), num_classes - 1)
        regions = np.full((b, n), num_regions - 1)
    labels, regions = labels.astype(np.int32), regions.astype(np.int32)
    want = np.asarray(segment_hist_labels_pallas(
        jnp.asarray(labels), jnp.asarray(regions), num_regions, num_classes, interpret=True))
    got = sh.segment_hist_labels(torch.from_numpy(labels), torch.from_numpy(regions),
                                 num_regions, num_classes)
    np.testing.assert_array_equal(got.numpy(), want)
    if kind == 'over_budget':
        assert not want.any()
    elif kind in ('one_region_one_label', 'last_bin_only'):
        assert (want.reshape(b, -1).sum(1) == n).all() and np.count_nonzero(want) == b
