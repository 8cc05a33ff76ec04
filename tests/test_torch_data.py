"""The port's tile loader against the JAX package's, on the CPU.

A seeded tree of 96 x 96 PNG tiles (mask ids 0..7, so ids >= 6 map to the
ignore label), SAM region maps and 'prob' labels (.npy) goes through the
port's `DALoader` and the JAX package's, each with its own package's
transform stacks built by its own `configs/_base.py`. Tolerance: none; every
batch (image, cls, sup, fname) is bit-identical, for two epochs, on the
native and on the Python path, with 0 and 2 worker threads. The port's
native binding also builds atomically: six processes that load it at once
from a fresh tree all find it.
"""

import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from configs import _base as jax_base
from regda_tpu.datasets import DALoader as JaxLoader
from regda_tpu.datasets.basedata import TileDataset as JaxTileDataset
from regda_tpu_torch import native
from regda_tpu_torch.configs import _base as port_base
from regda_tpu_torch.datasets import DALoader, TileDataset, make_loader

ROOT = Path(__file__).resolve().parents[1]
STATS = ((120.0, 80.0, 80.0), (50.0, 40.0, 40.0))
HW, CROP, N = 96, 64, 5


@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp('tiles')
    rng = np.random.default_rng(0)
    dirs = {k: root / k / 'train' for k in ('img_dir', 'ann_dir', 'reg_dir', 'prob_dir')}
    for d in dirs.values():
        d.mkdir(parents=True)
    for i in range(N):
        Image.fromarray(rng.integers(0, 256, (HW, HW, 3), dtype=np.uint8)).save(
            dirs['img_dir'] / f't{i}.png')
        Image.fromarray(rng.integers(0, 8, (HW, HW), dtype=np.uint8)).save(
            dirs['ann_dir'] / f't{i}.png')
        Image.fromarray(rng.integers(0, 50, (HW, HW)).astype(np.int32), mode='I').save(
            dirs['reg_dir'] / f't{i}.tif')
        prob = rng.random((HW, HW, 6)).astype(np.float32)
        np.save(dirs['prob_dir'] / f't{i}.png.npy', prob / prob.sum(-1, keepdims=True))
    return root


def _config(base, tree, stack: str, native_on: bool, workers: int) -> dict:
    """One loader config of `stack`, built by `base` (either package's
    configs/_base.py): the source's train stack, stage 2's target loader
    (the prob-target stack over id labels with region maps), a stage-3
    style 'prob' label loader, and the eval stack."""
    cfg = dict(image_dir=[str(tree / 'img_dir' / 'train')],
               mask_dir=[str(tree / 'ann_dir' / 'train')], training=True,
               batch_size=2, num_workers=workers, native=native_on, CV=dict(k=10, i=-1))
    if stack == 'train':
        cfg['transforms'] = base.train_transforms(*STATS, crop=CROP)
    elif stack == 'prob_target':
        cfg.update(transforms=base.prob_target_transforms(*STATS, crop=CROP),
                   read_sup=True)
    elif stack == 'prob_labels':
        cfg.update(transforms=base.prob_target_transforms(*STATS, crop=CROP),
                   mask_dir=[str(tree / 'prob_dir' / 'train')], label_type='prob',
                   read_sup=True)
    else:
        cfg.update(transforms=base.eval_transforms(*STATS), training=False)
    return cfg


def _epochs(loader, n=2):
    return [batch for _ in range(n) for batch in loader]


@pytest.mark.parametrize('workers', [0, 2])
@pytest.mark.parametrize('native_on', [True, False], ids=['native', 'python'])
@pytest.mark.parametrize('stack', ['train', 'prob_target', 'prob_labels', 'eval'])
def test_batches_equal_the_jax_loader(tree, stack, native_on, workers):
    port = DALoader(_config(port_base, tree, stack, native_on, workers), 'IsprsDA', seed=7)
    jax_loader = JaxLoader(_config(jax_base, tree, stack, native_on, workers), 'IsprsDA', seed=7)
    got, want = _epochs(port), _epochs(jax_loader)
    assert len(got) == len(want) == (4 if stack != 'eval' else 6)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        assert g['fname'] == w['fname']
        for key in set(g) - {'fname'}:
            assert g[key].dtype == w[key].dtype, key
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)
    takes_native = native_on and stack != 'prob_labels' and native.available()
    assert port.paths == {'native': len(got) if takes_native else 0,
                          'python': 0 if takes_native else len(got)}
    if stack == 'prob_labels':
        assert got[0]['cls'].shape == (2, CROP, CROP, 6)
        assert got[0]['cls'].dtype == np.float32


@pytest.mark.parametrize('training', [True, False])
def test_cross_validation_folds_equal_the_jax_loader(training):
    for n, k, i in ((5, 2, 0), (5, 2, 1), (23, 10, 3), (23, 10, 9)):
        got = DALoader.compute_cv_subset(n, dict(k=k, i=i), training, seed=11)
        want = JaxLoader.compute_cv_subset(n, dict(k=k, i=i), training, seed=11)
        np.testing.assert_array_equal(got, want)
    assert DALoader.compute_cv_subset(5, dict(k=2, i=-1), training, 11) is None


@pytest.mark.parametrize('dataset', ['IsprsDA', 'LoveDA'])
def test_id_labels_offset_and_ignore(tree, dataset):
    """IsprsDA: offset 0, ids >= 6 -> -1; LoveDA: offset -1 (0 -> -1),
    ids >= 7 after the offset -> -1."""
    args = ([str(tree / 'img_dir' / 'train')], [str(tree / 'ann_dir' / 'train')])
    got = TileDataset(dataset, *args).read_raw(1)
    want = JaxTileDataset(dataset, *args).read_raw(1)
    raw = np.asarray(Image.open(tree / 'ann_dir' / 'train' / 't1.png')).astype(np.int64)
    offset, classes = (0, 6) if dataset == 'IsprsDA' else (-1, 7)
    expect = raw + offset
    expect[expect >= classes] = -1
    np.testing.assert_array_equal(got['cls'], expect)
    np.testing.assert_array_equal(got['cls'], want['cls'])
    assert got['cls'].dtype == np.int32
    assert (got['cls'] == -1).any() and got['cls'].max() == classes - 1


def test_decode_png_matches_pil(tree):
    if not native.available():
        pytest.skip('g++ or libpng missing: the loader takes the Python path')
    for sub in ('img_dir', 'ann_dir'):
        p = str(tree / sub / 'train' / 't0.png')
        np.testing.assert_array_equal(native.decode_png(p), np.asarray(Image.open(p)))


def test_threaded_loader_raises_a_failed_read(tree, tmp_path):
    """A tile that cannot be read ends the epoch with the error, not with a
    short epoch."""
    shutil.copytree(tree, tmp_path / 'broken')
    for mask in (tmp_path / 'broken' / 'ann_dir' / 'train').glob('*.png'):
        mask.unlink()
    cfg = _config(port_base, tmp_path / 'broken', 'train', False, 2)
    with pytest.raises(FileNotFoundError):
        list(DALoader(cfg, 'IsprsDA'))


def test_make_loader_logs_its_path(tree):
    class Log:
        lines = []

        def info(self, msg):
            self.lines.append(msg)

    log = Log()
    loader = make_loader(_config(port_base, tree, 'train', True, 0), 'IsprsDA', logger=log)
    assert isinstance(loader, DALoader)
    path = 'native' if native.available() else 'Python'
    assert log.lines == [f'host loader over {N} tiles: {path} decode path']


_LOAD = '''
import importlib.util, sys
spec = importlib.util.spec_from_file_location('regda_native_binding', sys.argv[1])
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
print(mod.available())
'''


def test_native_build_is_atomic(tmp_path):
    """Six processes load the binding from a fresh tree at once, so all of
    them build: each renames its own finished library into place, and all
    find one (where g++ and libpng exist; else all find none)."""
    src = tmp_path / 'regda_tpu_torch' / 'native'
    src.mkdir(parents=True)
    for name in ('__init__.py', 'regda_native.cpp'):
        shutil.copy(ROOT / 'regda_tpu_torch' / 'native' / name, src / name)
    procs = [subprocess.Popen([sys.executable, '-c', _LOAD, str(src / '__init__.py')],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(6)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    said = {out.strip() for out, _ in outs}
    assert len(said) == 1, outs
    if native.available():   # this process found the toolchain and libpng
        assert said == {'True'}
    built = list((tmp_path / 'regda_tpu_torch' / '_build').glob('*'))
    assert [p.suffix for p in built] == (['.so'] if said == {'True'} else [])
    assert not (src / 'libregda_native.so').exists()   # never beside the source
