"""The plain versions of the port's two mask post-processing kernels
(regda_tpu_torch/ops/kernels/{stability,mask_stats}.py) and the band form that
the CUDA kernels read (ops/kernels/_band.py) against the JAX package.

On CPU tensors `stability_counts_blocked`, `stability_counts_fused` and
`mask_stats_fused` take their plain PyTorch versions; those are what the CUDA
kernels are held against on the card (tests/test_torch_cuda.py,
chip_smoke.py). Here the same numpy-seeded inputs go through them and through
the JAX package's three stability Pallas kernels and `mask_stats_fused`
(interpret mode off-TPU, as tests/test_sam.py runs them) and their XLA twin.

Tolerances: stability counts in float32 within 1 count, the JAX tests' own
(a resized logit within an ulp of +-offset may fall on either side); in
bfloat16 within 1 + 1e-3 * ch * cw (the row-resized intermediate is rounded to
bfloat16, and the two packages sum it in another order). Mask statistics are
float32 and must be equal: bits, boxes and areas.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from regda_tpu.models.sam import pallas_stability as jst
from regda_tpu.models.sam.pallas_stats import mask_stats_fused as jax_mask_stats_fused
from regda_tpu.ops.resize import _interp_matrix_half_pixel as jax_interp_matrix
from regda_tpu_torch.models.sam.auto import composed_resize_matrices
from regda_tpu_torch.ops.kernels import _band
from regda_tpu_torch.ops.kernels import mask_stats as ms
from regda_tpu_torch.ops.kernels import stability as st
from regda_tpu_torch.ops.resize import _interp_matrix_half_pixel


def _t(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if dtype is None else t.to(dtype)


def _f(m_h, m_w):
    """The frame that the wrappers take: m_h (ch, SH), m_w (cw, SW)."""
    return _band.ResizeFrame(m_h, m_w)


@pytest.mark.parametrize('n_in,n_out', [(32, 51), (32, 77), (256, 1024), (1024, 343),
                                        (128, 96), (64, 64), (5, 3), (1, 4)])
def test_interp_matrix_matches_jax(n_in, n_out):
    got = _interp_matrix_half_pixel(n_in, n_out)
    assert got.dtype == np.float32 and got.shape == (n_out, n_in)
    np.testing.assert_array_equal(got, jax_interp_matrix(n_in, n_out))


def test_block_unblock_roundtrip_and_match_jax():
    rng = np.random.RandomState(3)
    m, h, w = 3, 4, 6
    x = rng.randn(m, 4 * h, 4 * w).astype(np.float32)
    blk = st.block_masks(_t(x), h, w)
    assert tuple(blk.shape) == (m, 16 * h, w)
    np.testing.assert_array_equal(blk.numpy(), np.asarray(jst.block_masks(jnp.asarray(x), h, w)))
    np.testing.assert_array_equal(st.unblock_masks(blk, h, w).numpy(), x)
    np.testing.assert_array_equal(
        st.unblock_masks(blk, h, w).numpy(),
        np.asarray(jst.unblock_masks(jnp.asarray(blk.numpy()), h, w)))
    # the layout's definition: pixel (4y + 2dy + gy, 4x + 2dx + gx)
    y, xx, dy, dx, gy, gx = 2, 5, 1, 0, 1, 1
    assert blk[1, (dy * 8 + dx * 4 + gy * 2 + gx) * h + y, xx] == \
        x[1, 4 * y + 2 * dy + gy, 4 * xx + 2 * dx + gx]


# ------------------------------------------------------------------ stability

def _stability_case(seed, m=7, h=8, ch=51, cw=77):
    rng = np.random.RandomState(seed)
    s = 4 * h
    m_h = jax_interp_matrix(s, ch).astype(np.float32)
    m_w = jax_interp_matrix(s, cw).astype(np.float32)
    blk = (rng.randn(m, 16 * h, h) * 2.0).astype(np.float32)
    return blk, m_h, m_w, h


def _jax_counts(reference, blk, m_h, m_w, h, active=None, dtype=jnp.float32):
    blk_j = jnp.asarray(blk).astype(dtype)
    il = jst.unblock_masks(blk_j, h, h)
    mh, mw, mwt = jnp.asarray(m_h), jnp.asarray(m_w), jnp.asarray(m_w.T)
    act = None if active is None else jnp.asarray(active.astype(np.int32))
    if reference == 'xla':
        out = jst.stability_counts_xla(il, mh, mwt, offset=1.0)
    elif reference == 'fused':
        out = jst.stability_counts_fused(il, mh, mwt, offset=1.0, active=act)
    elif reference == 'blocked':
        out = jst.stability_counts_blocked(blk_j, mh, mw, h, h, offset=1.0, active=act)
    else:
        out = jst.stability_counts_blocked_v2(blk_j, mh, mw, h, h, offset=1.0, active=act)
    return tuple(np.asarray(o) for o in out)


@pytest.mark.parametrize('entry', ['blocked', 'fused', 'plain'])
@pytest.mark.parametrize('reference', ['xla', 'fused', 'blocked', 'blocked_v2'])
def test_stability_counts_match_jax(entry, reference):
    blk, m_h, m_w, h = _stability_case(seed=2)
    before = (st.launches_blocked, st.launches_fused)
    il = st.unblock_masks(_t(blk), h, h)
    if entry == 'blocked':
        inter, union = st.stability_counts_blocked(_t(blk), _f(m_h, m_w), h, h, 1.0)
    elif entry == 'fused':
        inter, union = st.stability_counts_fused(il, _f(m_h, m_w), 1.0)
    else:
        inter, union = st.stability_counts_plain(il, _t(m_h), _t(m_w.T), 1.0)
    assert (st.launches_blocked, st.launches_fused) == before   # CPU: the plain version
    assert inter.dtype == union.dtype == torch.float32 and tuple(inter.shape) == (7,)
    want_i, want_u = _jax_counts(reference, blk, m_h, m_w, h)
    np.testing.assert_allclose(inter.numpy(), want_i, atol=1)
    np.testing.assert_allclose(union.numpy(), want_u, atol=1)
    assert 0 < union.max() <= 51 * 77 and (inter <= union).all()


def test_stability_counts_non_square_source():
    """h != w: the blocked layout's planes are (h, w), the source (4h, 4w)."""
    rng = np.random.RandomState(11)
    m, h, w, ch, cw = 4, 8, 12, 40, 50
    m_h = jax_interp_matrix(4 * h, ch).astype(np.float32)
    m_w = jax_interp_matrix(4 * w, cw).astype(np.float32)
    blk = (rng.randn(m, 16 * h, w) * 2.0).astype(np.float32)
    inter, union = st.stability_counts_blocked(_t(blk), _f(m_h, m_w), h, w, 1.0)
    il = st.unblock_masks(_t(blk), h, w)
    assert tuple(il.shape) == (m, 4 * h, 4 * w)
    inter_f, union_f = st.stability_counts_fused(il, _f(m_h, m_w), 1.0)
    # the JAX kernels and their twin take square sources only: the counts
    # from the definition in float64, on JAX's unblocking
    x = np.asarray(jst.unblock_masks(jnp.asarray(blk), h, w), np.float64)
    y = np.einsum('hs,msw,cw->mhc', m_h.astype(np.float64), x, m_w.astype(np.float64))
    want_i, want_u = (y > 1.0).sum((1, 2)), (y > -1.0).sum((1, 2))
    for got, want in ((inter, want_i), (union, want_u), (inter_f, want_i), (union_f, want_u)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1)


@pytest.mark.parametrize('entry', ['blocked', 'fused'])
def test_stability_counts_gate(entry):
    """Active candidates agree with the JAX kernels' (whose gated lanes are
    undefined); gated ones are exactly zero here."""
    blk, m_h, m_w, h = _stability_case(seed=5)
    active = np.arange(7) % 2 == 1
    if entry == 'blocked':
        inter, union = st.stability_counts_blocked(_t(blk), _f(m_h, m_w), h, h, 1.0,
                                                   _t(active))
    else:
        inter, union = st.stability_counts_fused(st.unblock_masks(_t(blk), h, h), _f(m_h, m_w),
                                                 1.0, _t(active.astype(np.int32)))
    for reference in ('fused', 'blocked', 'blocked_v2'):
        want_i, want_u = _jax_counts(reference, blk, m_h, m_w, h, active)
        np.testing.assert_allclose(inter.numpy()[active], want_i[active], atol=1)
        np.testing.assert_allclose(union.numpy()[active], want_u[active], atol=1)
    assert not inter.numpy()[~active].any() and not union.numpy()[~active].any()


def test_stability_counts_bfloat16_matches_jax():
    """bfloat16 logits: matrices rounded to bfloat16, float32 sums, the
    intermediate rounded to bfloat16, as the JAX twin does it."""
    blk, m_h, m_w, h = _stability_case(seed=7, m=6, ch=96, cw=72)
    inter, union = st.stability_counts_blocked(_t(blk, torch.bfloat16), _f(m_h, m_w), h, h)
    want_i, want_u = _jax_counts('xla', blk, m_h, m_w, h, dtype=jnp.bfloat16)
    limit = 1 + 1e-3 * 96 * 72
    assert np.abs(inter.numpy() - want_i).max() <= limit
    assert np.abs(union.numpy() - want_u).max() <= limit
    score = inter / union.clamp(min=1)
    assert np.abs(score.numpy() - want_i / np.maximum(want_u, 1)).max() <= 2e-3


def test_stability_counts_on_composed_matrices():
    """The main path's matrices: the composed chain of a 343-like crop
    (1024 -> 343 gives weights that bfloat16 does not hold exactly)."""
    rng = np.random.RandomState(9)
    key_hw = (128, 96, 43, 32)
    m_h, m_w = composed_resize_matrices(128, key_hw, 32)
    assert m_h.shape == (43, 32) and m_w.shape == (32, 32)
    logits = (rng.randn(5, 32, 32) * 2).astype(np.float32)
    inter, union = st.stability_counts_fused(_t(logits), _f(m_h, m_w))
    want_i, want_u = jst.stability_counts_xla(jnp.asarray(logits), jnp.asarray(m_h),
                                              jnp.asarray(m_w.T), offset=1.0)
    np.testing.assert_allclose(inter.numpy(), np.asarray(want_i), atol=1)
    np.testing.assert_allclose(union.numpy(), np.asarray(want_u), atol=1)
    # and the counts straight from the definition, in float64
    y = np.einsum('hs,msw,cw->mhc', m_h.astype(np.float64), logits, m_w.astype(np.float64))
    np.testing.assert_allclose(union.numpy(), (y > -1.0).sum((1, 2)), atol=1)


@pytest.mark.parametrize('bad', ['dtype', 'blk_shape', 'matrix', 'active', 'empty'])
def test_stability_wrappers_check_their_input(bad):
    blk, m_h, m_w, h = _stability_case(seed=1)
    if bad == 'dtype':
        with pytest.raises(TypeError):
            st.stability_counts_blocked(_t(blk, torch.float64), _f(m_h, m_w), h, h)
    elif bad == 'blk_shape':
        with pytest.raises(ValueError):
            st.stability_counts_blocked(_t(blk), _f(m_h, m_w), h + 1, h)
    elif bad == 'matrix':
        with pytest.raises(ValueError):
            st.stability_counts_fused(st.unblock_masks(_t(blk), h, h), _f(m_h, m_w[:, :-4]))
    elif bad == 'active':
        with pytest.raises(ValueError):
            st.stability_counts_blocked(_t(blk), _f(m_h, m_w), h, h, 1.0,
                                        torch.ones(3, dtype=torch.bool))
    else:
        inter, union = st.stability_counts_blocked(_t(blk[:0]), _f(m_h, m_w), h, h)
        assert tuple(inter.shape) == tuple(union.shape) == (0,)


# ----------------------------------------------------------------- band form

@pytest.mark.parametrize('key_hw,low', [((1024, 1024, 512, 512), 256),
                                        ((1024, 1024, 343, 343), 256),
                                        ((128, 96, 43, 32), 32), ((128, 128, 200, 37), 32)])
def test_band_form_holds_the_composed_matrices(key_hw, low):
    """What the CUDA kernels read: at most four adjacent taps a row, and the
    taps put back give the matrix; a banded resize equals the dense one."""
    rng = np.random.RandomState(0)
    x = rng.randn(low, low).astype(np.float32)
    for m in composed_resize_matrices(key_hw[0] if low == 32 else 1024, key_hw, low):
        start, taps = _band.band_form_numpy(m)
        assert start.dtype == np.int32 and taps.shape == (len(m), _band.TAPS)
        assert start.min() >= 0 and start.max() + _band.TAPS <= low
        back = np.zeros_like(m)
        for i in range(_band.TAPS):
            back[np.arange(len(m)), start + i] = taps[:, i]
        np.testing.assert_array_equal(back, m)
        banded = sum(taps[:, i, None] * x[start + i] for i in range(_band.TAPS))
        np.testing.assert_allclose(banded, m @ x, rtol=1e-5, atol=1e-5)


def test_band_form_is_cached_and_follows_the_tensor():
    """A frame holds the dense matrices and, per rounding dtype, their band
    forms, made once on the host from the numpy matrices."""
    m_h, m_w = composed_resize_matrices(128, (128, 96, 96, 72), 32)
    frame = _f(m_h, m_w)
    assert (frame.ch, frame.sh, frame.cw, frame.sw) == (96, 32, 72, 32)
    np.testing.assert_array_equal(frame.m_h.numpy(), m_h)
    np.testing.assert_array_equal(frame.m_w.numpy(), m_w)
    np.testing.assert_array_equal(frame.m_wt.numpy(), m_w.T)
    first = frame.bands(torch.float32)
    assert all(a is b for a, b in zip(frame.bands(torch.float32), first))
    for (start, taps), m in zip((first[:2], first[2:]), (m_h, m_w)):
        want_start, want_taps = _band.band_form_numpy(m)
        np.testing.assert_array_equal(start.numpy(), want_start)
        np.testing.assert_array_equal(taps.numpy(), want_taps)
    rounded = frame.bands(torch.bfloat16)
    for i in (1, 3):
        assert torch.equal(rounded[i], rounded[i].bfloat16().float())
        assert not torch.equal(rounded[i], first[i])
        assert torch.equal(rounded[i - 1], first[i - 1])
    with torch.inference_mode():       # made under inference mode, used outside it
        late = _f(m_h, m_w)
    assert torch.equal(late.bands(torch.bfloat16)[3], rounded[3])


def test_band_form_refuses_a_dense_matrix():
    with pytest.raises(ValueError):
        _band.band_form_numpy(np.ones((5, 16), np.float32))
    with pytest.raises(ValueError):
        _band.band_form_numpy(np.ones((5, 3), np.float32))
    with pytest.raises(ValueError):
        _f(np.ones((20, 16), np.float32), np.eye(16, dtype=np.float32))


# ----------------------------------------------------------------- mask stats

def _stats_reference(logits_np, m_h, m_wt, ch, cw):
    """numpy reference: composed resize -> binarize at crop resolution ->
    inclusive boxes ([0, 0, 0, 0] when empty), areas, bit-pack."""
    y = np.einsum('hs,msw->mhw', m_h, logits_np.astype(np.float32))
    y = np.einsum('mhw,wc->mhc', y, m_wt)
    masks = y > 0.0
    boxes, areas = [], []
    for mm in masks:
        ys, xs = np.nonzero(mm)
        boxes.append([xs.min(), ys.min(), xs.max(), ys.max()] if ys.size else [0, 0, 0, 0])
        areas.append(ys.size)
    return (np.packbits(masks, axis=-1), np.asarray(boxes, np.float32),
            np.asarray(areas, np.float32), masks)


@pytest.mark.parametrize('ch,cw', [(100, 96), (51, 77)])
@pytest.mark.parametrize('gate', [False, True])
def test_mask_stats_match_jax_and_numpy(ch, cw, gate):
    rng = np.random.RandomState(0)
    m, s = 6, 32
    m_h = jax_interp_matrix(s, ch).astype(np.float32)
    m_wt = np.ascontiguousarray(jax_interp_matrix(s, cw).T.astype(np.float32))
    logits = (rng.randn(m, s, s) * 3).astype(np.float32)
    logits[4] = -1.0                                  # an empty mask
    active = np.array([1, 0, 1, 1, 1, 0], bool) if gate else np.ones(m, bool)
    before = ms.launches
    bits, boxes, areas = ms.mask_stats_fused(_t(logits), _f(m_h, m_wt.T),
                                             active=_t(active) if gate else None)
    assert ms.launches == before
    cwb = -(-cw // 8)
    assert bits.dtype == torch.uint8 and tuple(bits.shape) == (m, ch, cwb)
    assert boxes.dtype == areas.dtype == torch.float32
    jp, jb, ja = jax_mask_stats_fused(jnp.asarray(logits), jnp.asarray(m_h), jnp.asarray(m_wt),
                                      ch, cw, active=jnp.asarray(active.astype(np.int32)))
    wp, wb, wa, masks = _stats_reference(logits, m_h, m_wt, ch, cw)
    np.testing.assert_array_equal(bits.numpy()[active], wp[active])
    np.testing.assert_array_equal(boxes.numpy()[active], wb[active])
    np.testing.assert_array_equal(areas.numpy()[active], wa[active])
    # the TPU layout pads the frame to (8, 128) tiles; the frame itself is equal
    np.testing.assert_array_equal(bits.numpy()[active], np.asarray(jp)[active][:, :ch, :cwb])
    np.testing.assert_array_equal(boxes.numpy()[active], np.asarray(jb)[active])
    np.testing.assert_array_equal(areas.numpy()[active], np.asarray(ja)[active])
    assert not bits.numpy()[~active].any() and not boxes.numpy()[~active].any() \
        and not areas.numpy()[~active].any()
    assert areas[4] == 0 and not boxes[4].any()
    np.testing.assert_array_equal(
        np.unpackbits(bits.numpy(), axis=-1)[active][:, :, :cw].astype(bool), masks[active])
    np.testing.assert_array_equal(ms.unpack_bits(bits, cw).numpy().astype(bool)[active],
                                  masks[active])


def test_mask_stats_bfloat16_logits_are_widened():
    """bfloat16 logits are computed on as float32 (the matrices are not
    rounded), as the JAX kernel widens them. The seed is pinned where no
    resized logit lies within float32 rounding of 0 (seed 4 lands one there:
    numpy's and PyTorch's sums then fall on different sides)."""
    rng = np.random.RandomState(5)
    m_h, m_w = composed_resize_matrices(128, (128, 128, 96, 96), 32)
    logits = _t((rng.randn(4, 32, 32) * 3).astype(np.float32), torch.bfloat16)
    got = ms.mask_stats_fused(logits, _f(m_h, m_w))
    want = _stats_reference(logits.float().numpy(), m_h, np.ascontiguousarray(m_w.T), 96, 96)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    jp, jb, ja = jax_mask_stats_fused(jnp.asarray(logits.float().numpy()).astype(jnp.bfloat16),
                                      jnp.asarray(m_h), jnp.asarray(m_w.T), 96, 96)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(jp)[:, :96, :12])
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ja))


@pytest.mark.parametrize('cw', [1, 7, 8, 9, 77])
def test_pack_bits_is_numpy_packbits(cw):
    rng = np.random.RandomState(cw)
    mask = rng.rand(3, 5, cw) < 0.5
    packed = ms.pack_bits(_t(mask))
    np.testing.assert_array_equal(packed.numpy(), np.packbits(mask, axis=-1))
    np.testing.assert_array_equal(ms.unpack_bits(packed, cw).numpy().astype(bool), mask)


@pytest.mark.parametrize('bad', ['dtype', 'matrix', 'active', 'empty'])
def test_mask_stats_checks_its_input(bad):
    m_h, m_w = composed_resize_matrices(128, (128, 128, 96, 96), 32)
    logits, frame = torch.zeros(3, 32, 32), _f(m_h, m_w)
    if bad == 'dtype':
        with pytest.raises(TypeError):
            ms.mask_stats_fused(logits.double(), frame)
    elif bad == 'matrix':
        with pytest.raises(ValueError):
            ms.mask_stats_fused(logits[:, :, :28], frame)
    elif bad == 'active':
        with pytest.raises(ValueError):
            ms.mask_stats_fused(logits, frame, active=torch.ones(2))
    else:
        bits, boxes, areas = ms.mask_stats_fused(logits[:0], frame)
        assert tuple(bits.shape) == (0, 96, 12) and tuple(boxes.shape) == (0, 4)
        assert tuple(areas.shape) == (0,)


def _stats_vs_jax(logits, m_h, m_w, active=None):
    """The port's mask statistics and the JAX kernel's on the same inputs, and
    the float64 resize that decides each pixel away from 0."""
    ch, cw = len(m_h), len(m_w)
    m_wt = np.ascontiguousarray(m_w.T)
    got = ms.mask_stats_fused(_t(logits), _f(m_h, m_w),
                              active=None if active is None else _t(active))
    jact = np.ones(len(logits), np.int32) if active is None else active.astype(np.int32)
    jp, jb, ja = jax_mask_stats_fused(jnp.asarray(logits), jnp.asarray(m_h), jnp.asarray(m_wt),
                                      ch, cw, active=jnp.asarray(jact))
    want = (np.asarray(jp)[:, :ch, :(cw + 7) // 8], np.asarray(jb), np.asarray(ja))
    y64 = np.einsum('hs,msw,cw->mhc', m_h.astype(np.float64), logits.astype(np.float64),
                    m_w.astype(np.float64))
    return [g.numpy() for g in got], want, y64


@pytest.mark.parametrize('crop', [512, 343])
def test_mask_stats_on_the_main_path_matrices_match_jax(crop):
    """The composed chain of the main path's two frames, a 512^2 crop of a
    1024^2 key (crop 0 of a tile) and a 343^2 layer-1 crop, from S = 32 logits:
    bits equal the JAX kernel's wherever the float64 resize is not within
    float32 rounding of 0, and the boxes and areas are those of the bits."""
    rng = np.random.RandomState(crop)
    s = 32
    m_h, m_w = composed_resize_matrices(1024, (1024, 1024, crop, crop), s)
    assert m_h.shape == (crop, s)
    logits = (rng.randn(3, s, s) * 2).astype(np.float32)
    logits[2] = rng.randn(s, s).astype(np.float32) - 2.5     # a few small islands
    (bits, boxes, areas), (jbits, jboxes, jareas), y64 = _stats_vs_jax(logits, m_h, m_w)
    near_zero = np.abs(y64) <= 1e-5 * np.abs(logits).max()
    assert near_zero.mean() < 1e-3
    mask = np.unpackbits(bits, axis=-1)[..., :crop].astype(bool)
    jmask = np.unpackbits(jbits, axis=-1)[..., :crop].astype(bool)
    np.testing.assert_array_equal(mask[~near_zero], (y64 > 0)[~near_zero])
    np.testing.assert_array_equal(jmask[~near_zero], mask[~near_zero])
    assert not np.unpackbits(bits, axis=-1)[..., crop:].any()   # padding bits
    own = _stats_reference(np.where(mask, 1.0, -1.0).astype(np.float32),
                           np.eye(crop, dtype=np.float32), np.eye(crop, dtype=np.float32),
                           crop, crop)
    np.testing.assert_array_equal(boxes, own[1])
    np.testing.assert_array_equal(areas, own[2])
    if (mask == jmask).all():
        np.testing.assert_array_equal(boxes, jboxes)
        np.testing.assert_array_equal(areas, jareas)
    assert 0 < areas[2] < areas[:2].max()


def test_mask_stats_every_slot_gated_off():
    """All flags 0: zero bits, boxes and areas, and no launch; the same slots
    ungated equal the JAX kernel's."""
    rng = np.random.RandomState(11)
    m_h, m_w = composed_resize_matrices(128, (128, 128, 61, 45), 32)
    logits = (rng.randn(4, 32, 32) * 3).astype(np.float32)
    before = ms.launches
    bits, boxes, areas = ms.mask_stats_fused(_t(logits), _f(m_h, m_w),
                                             active=torch.zeros(4, dtype=torch.bool))
    assert ms.launches == before
    assert tuple(bits.shape) == (4, 61, 6)
    assert not bits.any() and not boxes.any() and not areas.any()
    got, want, _ = _stats_vs_jax(logits, m_h, m_w, active=np.ones(4, bool))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_mask_stats_one_slot_matches_jax():
    """M = 1, on a frame narrower than one 32-bit word of bits (cw = 21)."""
    rng = np.random.RandomState(12)
    m_h, m_w = composed_resize_matrices(128, (128, 112, 70, 21), 32)
    logits = (rng.randn(1, 32, 32) * 3).astype(np.float32)
    got, want, y64 = _stats_vs_jax(logits, m_h, m_w)
    assert got[0].shape == (1, 70, 3) and got[1].shape == (1, 4) and got[2].shape == (1,)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[2][0] == (y64 > 0).sum()
