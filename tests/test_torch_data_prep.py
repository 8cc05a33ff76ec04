"""The port's data preparation held against the JAX package on the CPU: the
ISPRS tilers and their CLIs, SLIC / LSC superpixels, connectivity,
edge shrinking, superpixel statistics, `get_superpixels`, LDA-SLIC,
and the superpixel view of label refinement.

Tolerances and what is held:
  * tiles: both packages tile the same synthetic scenes (written by imageio,
    as tests/test_data_prep.py writes them, and by PIL, as a machine without
    imageio would); the trees have the same split directories and file
    names, and every tile decodes to the same array. The PNG bytes may
    differ (two encoders). Dropped scenes write nothing in either.
  * SLIC / LSC labels: equal on images whose segments are unambiguous (the
    blocky images of tests/test_data_prep.py, the offset colour edge). On
    uniform noise the per-pixel agreement with JAX is held at >= 0.99
    (NOISE_AGREEMENT): both run float32 k-means whose centre sums are
    added in another order (XLA's segment sums, PyTorch's `index_add_`),
    so a pixel almost tied between two centres may go the other way; it is
    1.0 on every case here today.
  * connectivity, edge shrinking, `get_superpixels`' files: equal; superpixel
    means and the similarity graph rtol 1e-6; the superpixel view and
    `label_refine(mode='s'|'all')` rtol 1e-6, atol 1e-7; modes 'p' and 'l'
    beside them at tests/test_torch_ops.py's rtol 1e-5, atol 1e-6 (the
    prototype view's float32 matmuls round a few ulps apart).
"""

import importlib
import os
import shutil
import warnings
import zipfile

import imageio.v2 as iio
import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

import regda_tpu.data_prep.superpixels as jsp
import regda_tpu.data_prep.tiling as jtl
import regda_tpu_torch.data_prep.superpixels as tsp
import regda_tpu_torch.data_prep.tiling as ttl
import regda_tpu_torch.ops.refine as trefine
import regda_tpu_torch.ops.slic as tslic
from regda_tpu_torch.tools import convert_potsdam, convert_potsdam_rgb, convert_vaihingen

# regda_tpu.ops exports functions under these modules' names
jrefine = importlib.import_module('regda_tpu.ops.refine')
jslic = importlib.import_module('regda_tpu.ops.slic')

NOISE_AGREEMENT = 0.99
TORCH_THREADS = 2


@pytest.fixture(scope='module', autouse=True)
def _few_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(TORCH_THREADS)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def tmp(tmp_path):
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _imread(path):
    with warnings.catch_warnings():
        warnings.simplefilter('ignore', DeprecationWarning)   # imageio's tifffile
        return iio.imread(path)


def _imwrite(path, array, writer):
    if writer == 'imageio':
        with warnings.catch_warnings():
            warnings.simplefilter('ignore', DeprecationWarning)
            iio.imwrite(path, array)
    else:
        Image.fromarray(array).save(path)


def _write_scene(tmp, name, shape=(600, 600), channels=4, label=False, writer='imageio'):
    path = os.path.join(tmp, name)
    if label:
        rng = np.random.RandomState(0)
        array = jtl.ISPRS_PALETTE_RGB[rng.randint(0, 7, shape)].astype(np.uint8)
        array[:5, :5] = (12, 34, 56)        # unmatched colours
    else:
        array = np.random.RandomState(1).randint(0, 255, shape + (channels,), np.uint8)
    _imwrite(path, array, writer)
    return path


def _tree(root):
    """{relative path: decoded array} of every PNG under root."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = np.asarray(Image.open(p))
    return out


def _assert_same_tree(got_root, want_root):
    got, want = _tree(got_root), _tree(want_root)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---------------------------------------------------------------------------
# tiling
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('h,w,clip', [(1000, 700, 512), (512, 512, 512), (600, 600, 512),
                                      (6000, 6000, 512), (2000, 2500, 512), (511, 513, 64)])
def test_tile_boxes_match_jax(h, w, clip):
    got = ttl.tile_boxes(h, w, clip)
    np.testing.assert_array_equal(got, jtl.tile_boxes(h, w, clip))
    assert ((got[:, 2] - got[:, 0]) == min(clip, w)).all()


def test_rgb_label_to_ids_match_jax():
    colors = np.concatenate([ttl.ISPRS_PALETTE_RGB, [[12, 34, 56]]], 0)
    img = colors.reshape(1, 8, 3).astype(np.uint8)
    for unmatched in (0, 5):
        got = ttl.rgb_label_to_ids(img, unmatched=unmatched)
        np.testing.assert_array_equal(got, jtl.rgb_label_to_ids(img, unmatched=unmatched))
    np.testing.assert_array_equal(ttl.rgb_label_to_ids(img)[0], [0, 1, 2, 3, 4, 5, 0, 0])


@pytest.mark.parametrize('writer', ['imageio', 'pil'])
@pytest.mark.parametrize('rgb', [False, True])
def test_convert_potsdam_scene_matches_jax(tmp, rgb, writer):
    img = _write_scene(tmp, 'top_potsdam_2_10_RGBIR.tif', writer=writer)
    lab = _write_scene(tmp, 'top_potsdam_2_10_label.tif', channels=3, label=True, writer=writer)
    val = _write_scene(tmp, 'top_potsdam_7_8_RGBIR.tif', shape=(700, 512), writer=writer)
    counts = {}
    for name, pkg in (('jax', jtl), ('torch', ttl)):
        cfg = pkg.TilerConfig(out_dir=str(tmp / name), clip_size=512, rgb=rgb)
        counts[name] = [pkg.convert_potsdam_scene(p, cfg) for p in (img, lab, val)]
    assert counts['torch'] == counts['jax'] == [4, 4, 2]
    _assert_same_tree(tmp / 'torch', tmp / 'jax')
    tiles = sorted(os.listdir(tmp / 'torch' / 'img_dir' / 'train'))
    assert tiles[0] == '2_10_0_0_512_512.png'
    src = _imread(img)
    t = np.asarray(Image.open(tmp / 'torch' / 'img_dir' / 'train' / tiles[0]))
    want = src[:512, :512, [0, 1, 2] if rgb else [3, 0, 1]]
    np.testing.assert_array_equal(t, want)
    assert sorted(os.listdir(tmp / 'torch' / 'img_dir' / 'val')) == [
        '7_8_0_0_512_512.png', '7_8_0_188_512_700.png']
    lab_tile = np.asarray(Image.open(tmp / 'torch' / 'ann_dir' / 'train' / tiles[0]))
    assert lab_tile.max() <= 5 and lab_tile[0, 0] == 0


@pytest.mark.parametrize('scene', ['6_7', '4_12'])
def test_convert_potsdam_dropped_scenes(tmp, scene):
    img = _write_scene(tmp, f'top_potsdam_{scene}_RGBIR.tif', shape=(64, 64))
    for name, pkg in (('jax', jtl), ('torch', ttl)):
        assert pkg.convert_potsdam_scene(img, pkg.TilerConfig(out_dir=str(tmp / name))) == 0
    assert not (tmp / 'torch').exists() and not (tmp / 'jax').exists()


@pytest.mark.parametrize('writer', ['imageio', 'pil'])
def test_convert_vaihingen_scene_matches_jax(tmp, writer):
    img = _write_scene(tmp, 'top_mosaic_09cm_area11.tif', channels=3, writer=writer)
    lab = _write_scene(tmp, 'top_mosaic_09cm_area6.tif', channels=3, label=True, writer=writer)
    for name, pkg in (('jax', jtl), ('torch', ttl)):
        cfg = pkg.TilerConfig(out_dir=str(tmp / name))
        assert pkg.convert_vaihingen_scene(img, cfg, is_label=False) == 4
        assert pkg.convert_vaihingen_scene(lab, cfg, is_label=True) == 4
    _assert_same_tree(tmp / 'torch', tmp / 'jax')
    t = np.asarray(Image.open(tmp / 'torch' / 'img_dir' / 'val' / 'area11_0_0_512_512.png'))
    np.testing.assert_array_equal(t, _imread(img)[:512, :512])
    ann = np.asarray(Image.open(tmp / 'torch' / 'ann_dir' / 'test' / 'area6_0_0_512_512.png'))
    assert ann[0, 0] == 5                  # Vaihingen's unmatched colour


def test_iter_source_rasters_matches_jax(tmp):
    raw = tmp / 'raw'
    raw.mkdir()
    _write_scene(raw, 'top_potsdam_2_10_RGBIR.tif', shape=(32, 32))
    inner = tmp / 'inner'
    inner.mkdir()
    _write_scene(inner, 'top_potsdam_3_10_RGBIR.tif', shape=(32, 32))
    with zipfile.ZipFile(raw / 'a.zip', 'w') as zf:
        zf.write(inner / 'top_potsdam_3_10_RGBIR.tif', 'sub/top_potsdam_3_10_RGBIR.tif')
    got = [os.path.basename(p) for p in ttl.iter_source_rasters(str(raw))]
    want = [os.path.basename(p) for p in jtl.iter_source_rasters(str(raw))]
    assert got == want == ['top_potsdam_2_10_RGBIR.tif', 'top_potsdam_3_10_RGBIR.tif']


def test_converter_clis_match_jax(tmp):
    raw = tmp / 'raw'
    raw.mkdir()
    _write_scene(raw, 'top_potsdam_2_10_RGBIR.tif', shape=(300, 260))
    _write_scene(raw, 'top_potsdam_2_10_label.tif', shape=(300, 260), channels=3, label=True)
    _write_scene(raw, 'top_potsdam_6_7_RGBIR.tif', shape=(300, 260))
    vimg, vlab = tmp / 'vimg', tmp / 'vlab'
    vimg.mkdir()
    vlab.mkdir()
    _write_scene(vimg, 'top_mosaic_09cm_area1.tif', shape=(200, 250), channels=3)
    _write_scene(vlab, 'top_mosaic_09cm_area1.tif', shape=(200, 250), channels=3, label=True)

    assert convert_potsdam.main([str(raw), '-o', str(tmp / 'p'), '--clip_size', '128']) == 18
    assert convert_potsdam_rgb.main([str(raw), '-o', str(tmp / 'prgb'),
                                     '--clip_size', '128']) == 18
    assert convert_vaihingen.main(['--image-dir', str(vimg), '--label-dir', str(vlab),
                                   '-o', str(tmp / 'v'), '--clip_size', '128']) == 8
    for out, rgb in (('p', False), ('prgb', True)):
        cfg = jtl.TilerConfig(out_dir=str(tmp / f'j{out}'), clip_size=128, rgb=rgb)
        for p in jtl.iter_source_rasters(str(raw)):
            jtl.convert_potsdam_scene(p, cfg)
        _assert_same_tree(tmp / out, tmp / f'j{out}')
    cfg = jtl.TilerConfig(out_dir=str(tmp / 'jv'), clip_size=128)
    jtl.convert_vaihingen_scene(str(vimg / 'top_mosaic_09cm_area1.tif'), cfg, False)
    jtl.convert_vaihingen_scene(str(vlab / 'top_mosaic_09cm_area1.tif'), cfg, True)
    _assert_same_tree(tmp / 'v', tmp / 'jv')


def test_read_raster_keeps_associated_alpha_bands_raw(tmp):
    """tifffile tags a 4th band as associated alpha; PIL would divide the
    colour bands by it."""
    x = np.random.RandomState(2).randint(0, 255, (20, 30, 4), np.uint8)
    _imwrite(str(tmp / 'a.tif'), x, 'imageio')
    assert Image.open(tmp / 'a.tif').tile[0][3][0] == 'RGBa'
    np.testing.assert_array_equal(ttl.read_raster(str(tmp / 'a.tif')), x)


# ---------------------------------------------------------------------------
# SLIC / LSC
# ---------------------------------------------------------------------------

def _blocky_image(h=64, w=64, s=16, seed=3):
    rng = np.random.RandomState(seed)
    base = rng.rand(h // s, w // s, 3).astype(np.float32)
    return np.repeat(np.repeat(base, s, 0), s, 1)


def _both(fn_name, img, **kw):
    want = np.asarray(getattr(jslic, fn_name)(jnp.asarray(img), **kw))
    got = getattr(tslic, fn_name)(torch.from_numpy(img), **kw)
    assert got.dtype == torch.int32
    return got.numpy(), want


def test_srgb_to_lab_matches_jax():
    img = np.random.RandomState(0).rand(16, 16, 3).astype(np.float32)
    got = tslic.srgb_to_lab(torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(got, np.asarray(jslic.srgb_to_lab(jnp.asarray(img))),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize('fn_name,kw,img', [
    ('slic', dict(region_size=16, iterations=5), _blocky_image()),
    ('lsc', dict(region_size=16, iterations=5), _blocky_image(32, 32, 16, seed=0)),
    ('slic', dict(region_size=16, iterations=10, compactness=20.0), _blocky_image(64, 32)),
    ('lsc', dict(region_size=16, iterations=20), _blocky_image(64, 48)),
])
def test_blocky_segments_equal_jax(fn_name, kw, img):
    got, want = _both(fn_name, img, **kw)
    np.testing.assert_array_equal(got, want)
    s = kw['region_size']
    for i in range(img.shape[0] // s):
        for j in range(img.shape[1] // s):
            assert len(np.unique(got[i * s:(i + 1) * s, j * s:(j + 1) * s])) == 1


def test_lsc_boundary_adherence_equals_jax():
    img = np.zeros((32, 32, 3), np.float32)
    img[:, 11:] = 0.9
    got, want = _both('lsc', img, region_size=16, iterations=8)
    np.testing.assert_array_equal(got, want)
    assert not np.isin(got[:, :11], np.unique(got[:, 11:])).any()


@pytest.mark.parametrize('fn_name,iterations', [('slic', 5), ('slic', 10), ('lsc', 5),
                                                ('lsc', 20)])
@pytest.mark.parametrize('size', [64, 96])
def test_noise_agreement_with_jax(fn_name, iterations, size):
    img = np.random.RandomState(4).rand(size, size, 3).astype(np.float32)
    got, want = _both(fn_name, img, region_size=16, iterations=iterations)
    assert (got == want).mean() >= NOISE_AGREEMENT
    # locality: every label from its pixel's 3x3 grid neighbourhood
    g = size // 16
    gy, gx = np.mgrid[0:size, 0:size] // 16
    assert (np.abs(got // g - gy) <= 1).all() and (np.abs(got % g - gx) <= 1).all()


def test_slic_rejects_a_ragged_grid():
    with pytest.raises(ValueError, match='region_size'):
        tslic.slic(torch.zeros(40, 32, 3), region_size=16)


def test_enforce_connectivity_matches_jax():
    m = np.zeros((20, 20), np.int32)
    m[2:5, 2:5] = 7
    m[12:18, 12:18] = 7
    m[0, 19] = 3
    pair = np.zeros((8, 8), np.int32)
    pair[0, 0:2] = 1
    pair[0, 2:4] = 2
    noisy = tslic.lsc(torch.from_numpy(np.random.RandomState(6).rand(64, 64, 3)
                                       .astype(np.float32)), iterations=5).numpy()
    for labels, min_size in ((m, 4), (pair, 4), (noisy, 25), (noisy, 60)):
        got = tsp.enforce_connectivity(labels, min_size)
        np.testing.assert_array_equal(got, jsp.enforce_connectivity(labels, min_size))
        assert got.dtype == np.int32
        sizes = np.bincount(got.reshape(-1))
        assert sorted(np.unique(got)) == list(range(got.max() + 1))
        if labels is not pair:
            assert (sizes >= min_size).all()


@pytest.mark.parametrize('win_size,fill', [(2, 99), (3, None), (1, None)])
def test_edge_shrink_matches_jax(win_size, fill):
    labels = np.zeros((24, 20), np.int32)
    labels[:, 8:] = 1
    labels[15:, 3:12] = 2
    got = tslic.edge_shrink(torch.from_numpy(labels), win_size=win_size, fill=fill)
    want = np.asarray(jslic.edge_shrink(jnp.asarray(labels), win_size=win_size, fill=fill))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_superpixel_stats_and_adjacency_match_jax():
    rng = np.random.RandomState(7)
    labels = rng.randint(0, 5, (12, 10)).astype(np.int32)
    feats = rng.rand(12, 10, 3).astype(np.float32)
    s, cnts = tslic.superpixel_stats(torch.from_numpy(labels), torch.from_numpy(feats), 7)
    js, jcnts = jslic.superpixel_stats(jnp.asarray(labels), jnp.asarray(feats), 7)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6)
    np.testing.assert_array_equal(cnts.numpy(), np.asarray(jcnts))
    assert cnts[5:].sum() == 0
    a = tslic.adjacency(s, sigma=0.5)
    np.testing.assert_allclose(a.numpy(), np.asarray(jslic.adjacency(js, sigma=0.5)),
                               rtol=1e-6, atol=1e-7)
    assert np.allclose(np.diag(a.numpy()), 1.0)


@pytest.mark.parametrize('method', ['lsc', 'slic'])
def test_get_superpixels_matches_jax(tmp, method):
    d = tmp / 'img'
    d.mkdir()
    Image.fromarray((_blocky_image(32, 32, 16) * 255).astype(np.uint8)).save(d / 't.png')
    Image.fromarray(np.random.RandomState(8).randint(0, 255, (48, 64, 3), np.uint8)).save(
        d / 'u.png')
    kw = dict(region_size=16, iterations=5, method=method)
    assert jsp.get_superpixels(str(d), str(tmp / 'jax' / 'sup'), **kw) == 2
    assert tsp.get_superpixels(str(d), str(tmp / 'torch' / 'sup'), device='cpu', **kw) == 2
    for sub in ('sup', 'sup_vis', 'sup_shrink', 'sup_shrink_vis'):
        names = sorted(os.listdir(tmp / 'torch' / sub))
        assert names == sorted(os.listdir(tmp / 'jax' / sub))
        for f in names:
            got = np.asarray(Image.open(tmp / 'torch' / sub / f))
            want = _imread(tmp / 'jax' / sub / f)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want, err_msg=f'{sub}/{f}')
    labels = np.asarray(Image.open(tmp / 'torch' / 'sup' / 't.tif'))
    assert labels.shape == (32, 32) and labels.dtype == np.int32
    assert np.asarray(Image.open(tmp / 'torch' / 'sup_shrink' / 't.tif')).max() <= 4


def test_lda_slic_matches_jax():
    rng = np.random.RandomState(5)
    img = rng.rand(32, 32, 3).astype(np.float32)
    labels = (img[..., 0] > 0.5).astype(np.int64)
    for n in (2, 3):
        got = tsp.lda_slic(img, labels, n_components=n, region_size=16, iterations=2,
                           device='cpu')
        want = np.asarray(jsp.lda_slic(img, labels, n_components=n, region_size=16,
                                       iterations=2))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(tsp.lda_project(img.reshape(-1, 3), labels.reshape(-1), n),
                                   jsp.lda_project(img.reshape(-1, 3), labels.reshape(-1), n),
                                   rtol=1e-5, atol=1e-6)


def test_superpixel_entry_points_run_on_the_card_by_default(tmp):
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    (tmp / 'img').mkdir()
    with pytest.raises(RuntimeError, match='CUDA'):
        tsp.get_superpixels(str(tmp / 'img'), str(tmp / 'sup'))
    with pytest.raises(RuntimeError, match='CUDA'):
        tsp.lda_slic(np.zeros((16, 16, 3), np.float32), np.zeros((16, 16), np.int64))


# ---------------------------------------------------------------------------
# the superpixel view of label refinement
# ---------------------------------------------------------------------------

def _refine_inputs(seed=0, b=2, h=32, w=32, c=6, k=16):
    rng = np.random.default_rng(seed)
    feat = rng.normal(size=(b, h // 16, w // 16, k)).astype(np.float32)
    preds = [rng.normal(size=(b, h // 16, w // 16, c)).astype(np.float32) for _ in range(2)]
    logits = 3 * rng.normal(size=(b, h, w, c)).astype(np.float32)
    soft = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    protos = rng.normal(size=(c, k)).astype(np.float32)
    sup = np.kron(rng.integers(0, 12, size=(b, h // 8, w // 8)),
                  np.ones((8, 8), np.int64)).astype(np.int32)
    sup[:, :3] = 15                      # the edge-shrink fill id: ignored
    return feat, preds, soft.astype(np.float32), protos, sup


def test_superpixel_weight_matches_jax():
    _, _, soft, _, sup = _refine_inputs()
    got_w, got_ign = trefine.superpixel_weight(torch.from_numpy(soft), torch.from_numpy(sup), 16)
    want_w, want_ign = jrefine.superpixel_weight(jnp.asarray(soft), jnp.asarray(sup), 16)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(got_ign.numpy(), np.asarray(want_ign))
    assert got_ign.shape == (2, 32, 32, 1) and got_ign[:, :3].all()


@pytest.mark.parametrize('mode', ['s', 'all', 'p', 'l'])
@pytest.mark.parametrize('with_sup', [True, False])
def test_label_refine_with_superpixels_matches_jax(mode, with_sup):
    feat, preds, soft, protos, sup = _refine_inputs(1)
    kw = dict(sup_ids=sup, num_sup=16) if with_sup else {}
    got = trefine.label_refine(torch.from_numpy(feat), [torch.from_numpy(p) for p in preds],
                               torch.from_numpy(soft), torch.from_numpy(protos), mode=mode,
                               **{k: torch.from_numpy(v) if k == 'sup_ids' else v
                                  for k, v in kw.items()})
    want = jrefine.label_refine(jnp.asarray(feat), [jnp.asarray(p) for p in preds],
                                jnp.asarray(soft), jnp.asarray(protos), mode=mode,
                                **{k: jnp.asarray(v) if k == 'sup_ids' else v
                                   for k, v in kw.items()})
    tol = (dict(rtol=1e-6, atol=1e-7) if mode in ('s', 'all')
           else dict(rtol=1e-5, atol=1e-6))         # tests/test_torch_ops.py's
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    if mode == 's' and not with_sup:
        assert torch.equal(got, torch.from_numpy(soft))


def test_label_refine_superpixels_need_num_sup():
    feat, preds, soft, protos, sup = _refine_inputs(2)
    with pytest.raises(ValueError, match='num_sup'):
        trefine.label_refine(torch.from_numpy(feat), [torch.from_numpy(p) for p in preds],
                             torch.from_numpy(soft), torch.from_numpy(protos), mode='s',
                             sup_ids=torch.from_numpy(sup))
