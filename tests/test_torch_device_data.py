"""The port's device-resident data path (regda_tpu_torch/datasets/device_data.py)
against the JAX package's (regda_tpu/datasets/device_data.py), on the CPU.

A seeded tree of 64 x 64 PNG tiles (ids 0..7, so ids >= 6 map to the
ignore label), SAM region maps and float32 soft labels (.npy) is cached by
both packages, each with the stacks of its own `configs/_base.py`, cropped
to 32 where a stack crops. Tolerances:
  * the aug spec, the geometric ops (every op code and `indep` flag set on
    uint8 images, int8 labels, int16 region maps and bf16 soft labels),
    the index order, labels, region maps, file names and the soft labels'
    float16 -> bf16 rounding: exact;
  * images, and the soft labels of a batch: rtol 0, atol 1e-6 (the same
    float32 subtract and divide on both sides);
  * the decisions' frequencies: within 5 binomial standard deviations of
    the host stacks' probabilities over 24,000 draws;
  * a stage-1 step fed a device batch against the step fed the host
    batch: rtol 1e-6.
Then the slice as a whole: the data-parallel and spatial split of a device
batch, and `train_src` and `train_ssl_reg --gen 1` end to end on
`st.regda.tiny_smoke` with REGDA_DEVICE_DATA=1 and `--device cpu`.
"""

import glob
import logging
import os
import shutil
import tempfile
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from configs import _base as jax_base
from regda_tpu.datasets import device_data as jdd
from regda_tpu_torch import parallel
from regda_tpu_torch.aug import (Compose, Normalize, OneOf, RandomCrop, RandomHorizontalFlip,
                                 RandomRotate90, RandomVerticalFlip)
from regda_tpu_torch.configs import _base as port_base
from regda_tpu_torch.datasets import (DALoader, DeviceCacheTooLarge, DeviceEvalSet,
                                      DeviceLoader, TileDataset, device_data_enabled,
                                      get_eval_set, make_loader)
from regda_tpu_torch.datasets import device_data as pdd
from regda_tpu_torch.datasets.device_data import Decisions, assemble_batch, batch_tensor
from regda_tpu_torch.models import build_deeplabv2
from regda_tpu_torch.train import create_train_state, make_optimizer
from regda_tpu_torch.train.loop import Trainer
from regda_tpu_torch.train.steps import make_stage1_step

HW, CROP, N, C = 64, 32, 6, 6
STATS = ((120.0, 80.0, 80.0), (50.0, 40.0, 40.0))
DRAWS = 24000


@pytest.fixture(scope='module', autouse=True)
def _few_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _no_device_data_env(monkeypatch):
    monkeypatch.delenv('REGDA_DEVICE_DATA', raising=False)
    monkeypatch.delenv('REGDA_DEVICE_DATA_BUDGET', raising=False)


def _write_tree(root: Path, n: int = N, hw: int = HW, big_region: bool = False):
    rng = np.random.default_rng(0)
    dirs = {k: root / k / 'train' for k in ('img_dir', 'ann_dir', 'reg_dir', 'prob_dir')}
    for d in dirs.values():
        d.mkdir(parents=True)
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, (hw, hw, 3), dtype=np.uint8)).save(
            dirs['img_dir'] / f't{i}.png')
        Image.fromarray(rng.integers(0, 8, (hw, hw), dtype=np.uint8)).save(
            dirs['ann_dir'] / f't{i}.png')
        reg = rng.integers(0, 50, (hw, hw)).astype(np.int32)
        if big_region:
            reg[0, 0] = 40000
        Image.fromarray(reg, mode='I').save(dirs['reg_dir'] / f't{i}.tif')
        prob = rng.random((hw, hw, C)).astype(np.float32)
        np.save(dirs['prob_dir'] / f't{i}.png.npy', prob / prob.sum(-1, keepdims=True))
    return dirs


@pytest.fixture(scope='module')
def tree():
    with tempfile.TemporaryDirectory(prefix='regda_device_data_') as tmp:
        yield _write_tree(Path(tmp))


def _config(base, dirs, stack: str, **extra) -> dict:
    """A loader config built by `base` (either package's configs/_base.py):
    'train' (source stack over id labels), 'prob' (the prob-target stack
    over soft labels and region maps), 'region' (the prob-target stack over
    id labels and region maps, stage 2's target), 'eval', 'plain' (crop =
    tile and Normalize: no random decision)."""
    cfg = dict(image_dir=[str(dirs['img_dir'])], mask_dir=[str(dirs['ann_dir'])],
               training=True, batch_size=2, num_workers=0, native=False,
               CV=dict(k=10, i=-1))
    if stack == 'train':
        cfg['transforms'] = base.train_transforms(*STATS, crop=CROP)
    elif stack in ('prob', 'region'):
        cfg.update(transforms=base.prob_target_transforms(*STATS, crop=CROP), read_sup=True)
        if stack == 'prob':
            cfg.update(mask_dir=[str(dirs['prob_dir'])], label_type='prob')
    elif stack == 'eval':
        cfg.update(transforms=base.eval_transforms(*STATS), training=False, batch_size=1)
    else:
        cfg.update(transforms=base.Compose([base.RandomCrop(HW), base.Normalize(*STATS)]),
                   read_sup=True)
    cfg.update(extra)
    return cfg


def _numpy(v):
    if isinstance(v, torch.Tensor):
        return (v.float() if v.dtype == torch.bfloat16 else v).numpy()
    return np.asarray(v, np.float32 if v.dtype == jnp.bfloat16 else None)


def _host(batch: dict) -> dict:
    """A batch (the port's tensors or JAX arrays) as numpy, bf16 as float32."""
    return {k: v if k == 'fname' else _numpy(v) for k, v in batch.items()}


def _assert_batch(got: dict, want: dict, float_atol: float = 1e-6):
    assert got.keys() == want.keys(), (got.keys(), want.keys())
    for k in got:
        if k == 'fname':
            assert list(got[k]) == list(want[k])
            continue
        g, w = got[k], want[k]
        assert g.shape == w.shape and g.dtype == w.dtype, (k, g.shape, w.shape, g.dtype, w.dtype)
        if g.dtype.kind == 'f':
            np.testing.assert_allclose(g, w, rtol=0, atol=float_atol, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


# --------------------------------------------------------------- aug specs

@pytest.mark.parametrize('stack', ['train', 'eval', 'prob'])
def test_parse_aug_spec_equals_jax(stack):
    def build(base):
        return {'train': base.train_transforms(*STATS, crop=CROP),
                'eval': base.eval_transforms(*STATS),
                'prob': base.prob_target_transforms(*STATS, crop=CROP)}[stack]

    got, want = pdd.parse_aug_spec(build(port_base)), jdd.parse_aug_spec(build(jax_base))
    assert got is not None and got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
        else:
            assert got[k] == want[k], k
    assert pdd.parse_aug_spec(None) == jdd.parse_aug_spec(None)


@pytest.mark.parametrize('case', ['inner_prob', 'non_square', 'after_normalize'])
def test_parse_aug_spec_rejects_what_jax_rejects(case):
    from regda_tpu import aug as jaug

    def build(a):
        norm = a.Normalize(*STATS)
        if case == 'inner_prob':
            return a.Compose([a.RandomCrop(CROP), a.OneOf(
                [a.RandomHorizontalFlip(), a.RandomVerticalFlip(), a.RandomRotate90()],
                p=0.75), norm])
        if case == 'non_square':
            return a.Compose([a.RandomCrop((CROP, CROP // 2)), norm])
        return a.Compose([a.RandomCrop(CROP), norm, a.RandomHorizontalFlip(0.5)])

    port_aug = types.SimpleNamespace(
        Compose=Compose, Normalize=Normalize, OneOf=OneOf, RandomCrop=RandomCrop,
        RandomHorizontalFlip=RandomHorizontalFlip, RandomVerticalFlip=RandomVerticalFlip,
        RandomRotate90=RandomRotate90)
    assert jdd.parse_aug_spec(build(jaug)) is None
    assert pdd.parse_aug_spec(build(port_aug)) is None


# ------------------------------------------------------------ geometric ops

def _array(kind: str, rng, b: int, s: int = 6):
    """(numpy for JAX, tensor for the port) of one kind of cached array."""
    if kind == 'image':
        a = rng.integers(0, 256, (b, s, s, 3), dtype=np.uint8)
        return a, torch.from_numpy(a)
    if kind == 'labels':
        a = rng.integers(-1, 6, (b, s, s)).astype(np.int8)
        return a, torch.from_numpy(a)
    if kind == 'regions':
        a = rng.integers(0, 32767, (b, s, s)).astype(np.int16)
        return a, torch.from_numpy(a)
    t = torch.from_numpy(rng.random((b, s, s, C)).astype(np.float32)).bfloat16()
    return jnp.asarray(t.float().numpy(), jnp.bfloat16), t


def _geo(kind: str, t: torch.Tensor, stack: str, ops: torch.Tensor) -> np.ndarray:
    """`assemble_batch` over the cache `t` (one array per sample, in the slot
    of its kind: images, cls or sup), no crop and no Normalize: the
    geometric ops alone, cast as a batch casts them."""
    b, s = t.shape[:2]
    images = t if kind == 'image' else torch.zeros(b, s, s, 3, dtype=torch.uint8)
    cls = t if kind in ('labels', 'soft') else None
    sup = t if kind == 'regions' else None
    out = assemble_batch(dict(kind=stack, crop=None, clamp=False), images, cls, sup,
                         torch.arange(b), Decisions(None, None, ops), kind == 'soft')
    return out[{'image': 'image', 'labels': 'cls', 'soft': 'cls', 'regions': 'sup'}[kind]].numpy()


@pytest.mark.parametrize('kind', ['image', 'labels', 'regions', 'soft'])
def test_geometric_ops_equal_jax(kind):
    rng = np.random.default_rng(1)
    geo, indep = jax.jit(jdd._geo_switch), jax.jit(jdd._apply_indep)
    x, t = _array(kind, rng, 7)
    got = _geo(kind, t, 'oneof', torch.arange(7))
    for op in range(7):
        want = _numpy(geo(x[op], op)).astype(got.dtype)
        np.testing.assert_array_equal(got[op], want, err_msg=f'op {op}')
    flags = np.array([[h, v, r] for h in (0, 1) for v in (0, 1) for r in (0, 1)], bool)
    x, t = _array(kind, rng, 8)
    got = _geo(kind, t, 'indep', torch.from_numpy(flags))
    for i, f in enumerate(flags):
        want = _numpy(indep(x[i], f)).astype(got.dtype)
        np.testing.assert_array_equal(got[i], want, err_msg=f'flags {f}')


# -------------------------------------------------------- forced batches

def _jax_decisions(spec: dict, key, b: int, crop: bool) -> Decisions:
    """The decisions that the JAX `make_batch_fn` draws from `key`, by its
    own key derivation (device_data.py:make_batch_fn)."""
    kc, ko = jax.random.split(key)
    y = x = None
    if crop:
        ys, xs = [], []
        for k in jax.random.split(kc, b):
            ky, kx = jax.random.split(k)
            ys.append(int(jax.random.randint(ky, (), 0, HW - CROP + 1)))
            xs.append(int(jax.random.randint(kx, (), 0, HW - CROP + 1)))
        y, x = torch.tensor(ys), torch.tensor(xs)
    ops = jdd._draw_ops(spec, ko, b)
    return Decisions(y, x, None if ops is None else torch.from_numpy(np.array(ops)))


@pytest.mark.parametrize('stack', ['train', 'prob', 'region', 'plain'])
def test_forced_batch_equals_jax(tree, stack):
    port = DeviceLoader(_config(port_base, tree, stack), 'IsprsDA', device='cpu')
    jl = jdd.DeviceLoader(_config(jax_base, tree, stack), 'IsprsDA')
    idx = np.array([4, 1, 4, 0], np.int64)
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        want = jl._fn(jl._images, jl._cls, jl._sup, idx.astype(np.int32), key)
        dec = _jax_decisions(jl.spec, key, len(idx), stack != 'plain')
        got = port.sample(idx, dec)
        del got['fname']
        _assert_batch(_host(got), _host(want))


# ------------------------------------------------- the iteration protocol

@pytest.mark.parametrize('labels', ['id', 'prob', 'cv'])
def test_loader_equals_jax_and_host_without_randomness(tree, labels):
    """Crop = tile and Normalize only: epoch by epoch the same index order
    and batches as the JAX DeviceLoader and the port's host DALoader."""
    extra = {'id': {}, 'cv': dict(CV=dict(k=3, i=1)),
             'prob': dict(mask_dir=[str(tree['prob_dir'])], label_type='prob')}[labels]
    port = DeviceLoader(_config(port_base, tree, 'plain', **extra), 'IsprsDA', seed=5,
                        device='cpu')
    jl = jdd.DeviceLoader(_config(jax_base, tree, 'plain', **extra), 'IsprsDA', seed=5)
    host = DALoader(_config(port_base, tree, 'plain', **extra), 'IsprsDA', seed=5)
    assert len(port) == len(jl) == len(host) == (2 if labels == 'cv' else 3)
    for _ in range(2):
        for got, want, h in zip(port, jl, host, strict=True):
            got = _host(got)
            _assert_batch(got, _host(want))
            if labels == 'prob':
                # the cache's two roundings: float32 -> float16 -> bf16
                h['cls'] = torch.from_numpy(h['cls'].astype(np.float16)).bfloat16().float().numpy()
            _assert_batch(got, h)


# ---------------------------------------------------- decision statistics

def _within_5_sigma(counts: np.ndarray, probs, n: int):
    probs = np.asarray(probs, np.float64)
    sigma = np.sqrt(n * probs * (1 - probs))
    assert (np.abs(counts - n * probs) <= 5 * sigma).all(), (counts / n, probs)


def test_decision_distributions():
    g = torch.Generator().manual_seed(0)
    oneof = pdd.parse_aug_spec(port_base.train_transforms(*STATS, crop=CROP))
    dec = pdd.draw_decisions(oneof, (HW, HW), DRAWS, g)
    # OneOf(p=0.75): nothing 1/4; hflip, vflip, rot90 3/4 * 1/3 each, k 1/4 each
    _within_5_sigma(np.bincount(dec.ops.numpy(), minlength=7), [0.25] * 3 + [0.0625] * 4, DRAWS)
    for off in (dec.y, dec.x):
        counts = np.bincount(off.numpy())
        assert off.min() == 0 and off.max() == HW - CROP and (counts > 0).all()
        _within_5_sigma(counts, [1 / (HW - CROP + 1)] * (HW - CROP + 1), DRAWS)
    indep = pdd.parse_aug_spec(port_base.prob_target_transforms(*STATS, crop=CROP))
    flags = pdd.draw_decisions(indep, (HW, HW), DRAWS, g).ops.numpy()
    _within_5_sigma(flags.sum(0), [0.5] * 3, DRAWS)
    # no crop where crop = tile: no offsets drawn
    assert pdd.draw_decisions(oneof, (CROP, CROP), 4, g).y is None


def test_seed_decides_the_batches(tree):
    cfg = _config(port_base, tree, 'train')
    a, b, c = (DeviceLoader(cfg, 'IsprsDA', seed=s, device='cpu') for s in (3, 3, 4))
    batches = [list(loader) for loader in (a, b, c)]
    for x, y in zip(batches[0], batches[1], strict=True):
        _assert_batch(_host(x), _host(y), float_atol=0)
    assert any(not np.array_equal(_host(x)['image'], _host(y)['image'])
               for x, y in zip(batches[0], batches[2]))


# --------------------------------------------------------------- eval sets

@pytest.mark.parametrize('cv', [-1, 1])
def test_eval_set_equals_jax(tree, cv):
    extra = dict(CV=dict(k=3, i=cv))
    got = list(DeviceEvalSet(_config(port_base, tree, 'eval', **extra), 'IsprsDA', device='cpu'))
    want = list(jdd.DeviceEvalSet(_config(jax_base, tree, 'eval', **extra), 'IsprsDA'))
    host = list(DALoader(_config(port_base, tree, 'eval', **extra), 'IsprsDA'))
    assert len(got) == len(want) == (N if cv < 0 else 2)
    for g, w in zip(got, want, strict=True):
        _assert_batch(_host(g), _host(w))
    # the fold's tiles, sorted, as the host loader holds them
    assert sorted(b['fname'][0] for b in host) == [b['fname'][0] for b in got]


def test_eval_set_cache_keys(tree):
    cfg_a = _config(port_base, tree, 'eval')
    cfg_b = _config(port_base, tree, 'eval', transforms=port_base.eval_transforms(
        (0.0, 0.0, 0.0), (1.0, 1.0, 1.0)))
    ea, eb = get_eval_set(cfg_a, 'IsprsDA', device='cpu'), get_eval_set(cfg_b, 'IsprsDA',
                                                                        device='cpu')
    assert ea is not eb
    assert not np.allclose(next(iter(ea))['image'].numpy(), next(iter(eb))['image'].numpy())
    assert get_eval_set(dict(cfg_a), 'IsprsDA', device='cpu') is ea
    fold = get_eval_set(dict(cfg_a, CV=dict(k=3, i=0)), 'IsprsDA', device='cpu')
    assert fold is not ea and len(fold) == 2 and len(ea) == N


def test_budget_and_crop_guards(tree, monkeypatch):
    with pytest.raises(DeviceCacheTooLarge):
        DeviceLoader(_config(port_base, tree, 'train'), 'IsprsDA', budget_bytes=16, device='cpu')
    with pytest.raises(ValueError, match='exceeds cached tile'):
        DeviceLoader(_config(port_base, tree, 'train',
                             transforms=port_base.train_transforms(*STATS, crop=2 * HW)),
                     'IsprsDA', device='cpu')
    monkeypatch.setenv('REGDA_DEVICE_DATA_BUDGET', '64')
    with pytest.raises(DeviceCacheTooLarge):
        DeviceEvalSet(_config(port_base, tree, 'eval'), 'IsprsDA', device='cpu')
    with pytest.raises(DeviceCacheTooLarge):
        DeviceLoader(_config(port_base, tree, 'train'), 'IsprsDA', device='cpu')


def test_no_card_raises_rather_than_moving(tree):
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        DeviceLoader(_config(port_base, tree, 'train'), 'IsprsDA')


def test_batch_tensor_refuses_other_devices_and_dtypes():
    t = torch.zeros(2, 4, 4, 3)
    assert batch_tensor(t, 'cpu', torch.float32) is t
    with pytest.raises(ValueError, match='not on cpu'):
        batch_tensor(torch.zeros(2, device='meta'), 'cpu')
    with pytest.raises(ValueError, match='torch.float64'):
        batch_tensor(t.double(), 'cpu', torch.float32)
    up = batch_tensor(np.zeros((2, 3), np.float64), 'cpu', torch.float32)
    assert up.dtype == torch.float32


# ----------------------------------------------------------------- routing

class _Log:
    def __init__(self):
        self.info_lines, self.warnings = [], []

    def info(self, msg):
        self.info_lines.append(msg)

    def warning(self, msg):
        self.warnings.append(msg)


@pytest.mark.parametrize('switch', ['env_on', 'config_on', 'env_off', 'absent'])
def test_make_loader_routes(tree, monkeypatch, switch):
    cfg = _config(port_base, tree, 'train')
    if switch == 'env_on':
        monkeypatch.setenv('REGDA_DEVICE_DATA', '1')
    elif switch == 'config_on':
        cfg['device_data'] = True
    elif switch == 'env_off':
        monkeypatch.setenv('REGDA_DEVICE_DATA', '0')
        cfg['device_data'] = True
    log = _Log()
    loader = make_loader(cfg, 'IsprsDA', logger=log, device='cpu')
    on = switch in ('env_on', 'config_on')
    assert device_data_enabled(cfg) is on
    assert isinstance(loader, DeviceLoader if on else DALoader)
    assert log.info_lines == ([f'device-resident data: {N} tiles cached on cpu'] if on
                              else [f'host loader over {N} tiles: Python decode path'])
    assert not log.warnings


@pytest.mark.parametrize('reason', ['budget', 'region_id'])
def test_make_loader_falls_back_with_a_warning(tree, monkeypatch, caplog, reason, tmp_path):
    monkeypatch.setenv('REGDA_DEVICE_DATA', '1')
    if reason == 'budget':
        monkeypatch.setenv('REGDA_DEVICE_DATA_BUDGET', '16')
        cfg = _config(port_base, tree, 'train')
    else:
        cfg = _config(port_base, _write_tree(tmp_path, n=2, big_region=True), 'region')
    with caplog.at_level(logging.WARNING):
        loader = make_loader(cfg, 'IsprsDA', device='cpu')
    assert isinstance(loader, DALoader)
    why = '> 16 bytes' if reason == 'budget' else 'region id exceeds the int16 cache'
    assert any('device data disabled' in r.message and why in r.message
               and 'falling back to host loader' in r.message for r in caplog.records)


# ------------------------------------------------------ the slice as a whole

def _trainer(tmp_path, seed: int = 0):
    model = build_deeplabv2('resnet18', num_classes=C,
                            generator=torch.Generator().manual_seed(seed))
    state = create_train_state(model, make_optimizer(model, 1e-2, 10),
                               torch.Generator().manual_seed(seed))
    cfg = types.SimpleNamespace(SOURCE_DATA_CONFIG=dict(batch_size=2), DATASETS='IsprsDA',
                                SNAPSHOT_DIR=str(tmp_path), TARGET_SET='Vaihingen')
    return Trainer(model, cfg, None, state,
                   make_stage1_step(align_domain=True, num_classes=C, ignore_label=-1))


def test_stage1_step_on_device_batch_equals_host_batch(tree, tmp_path):
    """One resnet18 stage-1 step (CORAL on) fed a DeviceLoader batch with
    the identity decisions equals the step fed the host batch of the same
    tiles under the eval stack."""
    loader = DeviceLoader(_config(port_base, tree, 'train',
                                  transforms=port_base.train_transforms(*STATS, crop=HW)),
                          'IsprsDA', device='cpu')
    ds = TileDataset('IsprsDA', image_dir=[str(tree['img_dir'])],
                     mask_dir=[str(tree['ann_dir'])],
                     transforms=port_base.eval_transforms(*STATS))
    src, tgt = np.array([3, 0]), np.array([5, 2])
    identity = Decisions(None, None, torch.zeros(2, dtype=torch.long))
    bs, bt = (loader.sample(idx, identity) for idx in (src, tgt))
    hs, ht = ({k: np.stack([ds[int(i)][k] for i in idx]) for k in ('image', 'cls')}
              for idx in (src, tgt))
    results = []
    for args in (dict(images_s=bs['image'], label_s=bs['cls'], images_t=bt['image']),
                 dict(images_s=hs['image'], label_s=hs['cls'].astype(np.int32),
                      images_t=ht['image'])):
        trainer = _trainer(tmp_path)
        metrics = trainer.run_step(**args)
        results.append(({k: float(v) for k, v in metrics.items()},
                        {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}))
    (m_dev, p_dev), (m_host, p_host) = results
    for k in m_host:
        np.testing.assert_allclose(m_dev[k], m_host[k], rtol=1e-6, err_msg=k)
    for k in p_host:
        np.testing.assert_allclose(p_dev[k].double().numpy(), p_host[k].double().numpy(),
                                   rtol=1e-6, atol=0, err_msg=k)


@pytest.mark.parametrize('mesh', [(2, 1), (1, 2)])
def test_device_batch_splits_like_the_one_process_batch(tree, mesh):
    """Every rank's DeviceLoader draws the one-process global batch from the
    same seed; shard_batch gives each rank its rows (data axis) and its
    height block (spatial axis), contiguous once taken by the Trainer."""
    n_data, n_spatial = mesh
    cfg = _config(port_base, tree, 'prob', batch_size=4)
    one = next(iter(DeviceLoader(cfg, 'IsprsDA', seed=9, device='cpu')))
    keys = ('image', 'cls', 'sup')
    for rank in range(n_data * n_spatial):
        group = parallel.DataGroup(rank=rank, size=n_data * n_spatial,
                                   device=torch.device('cpu'), n_spatial=n_spatial)
        mine = next(iter(DeviceLoader(cfg, 'IsprsDA', seed=9, device='cpu')))
        parts = parallel.shard_batch(group, *(mine[k] for k in keys))
        rows = slice(group.data_rank * 4 // n_data, (group.data_rank + 1) * 4 // n_data)
        block = CROP // n_spatial
        height = slice(group.spatial_rank * block, (group.spatial_rank + 1) * block)
        for k, part in zip(keys, parts):
            taken = batch_tensor(part, 'cpu')
            assert taken.is_contiguous()
            torch.testing.assert_close(taken, one[k][rows, height], rtol=0, atol=0)


def _device_data_chain(root: Path):
    """train_src -> init_prototypes -> train_ssl_reg --gen 1 on tiny_smoke,
    2 steps a stage, with device data on; records every step's metrics and
    what `get_eval_set` gave the eval and the pseudo-label pass, in order."""
    from unittest import mock
    from regda_tpu_torch.tools import init_prototypes, train_src, train_ssl_reg
    cfg_name = 'st.regda.tiny_smoke'
    seen = types.SimpleNamespace(metrics=[], sets=[])

    def recorder(fn, out):
        def wrapped(*args, **kwargs):
            result = fn(*args, **kwargs)
            out.append(result)
            return result
        return wrapped

    src = root / 'log' / 'src'
    common = ['--config-path', cfg_name, '--device', 'cpu']
    with mock.patch.object(Trainer, 'run_step', recorder(Trainer.run_step, seen.metrics)), \
            mock.patch.object(pdd, 'get_eval_set', recorder(pdd.get_eval_set, seen.sets)):
        seen.src = train_src.main([*common, '--align-domain', '1'])
        init_prototypes.main([*common, '--ckpt-model', str(src / 'Vaihingen_best.pth'),
                              '--ckpt-proto', str(src / 'prototypes_best')])
        seen.ssl = train_ssl_reg.main([*common, '--ckpt-model', str(src / 'Vaihingen_best.pth'),
                                       '--ckpt-proto', str(src / 'prototypes_best.npy'),
                                       '--gen', '1', '--refine-label', '1', '--sam-refine',
                                       '--percent', '0.5', '--lt', 'uvem'])
    return seen


def test_stage_clis_run_on_device_data(monkeypatch):
    tmp = tempfile.mkdtemp(prefix='regda_device_chain_')
    try:
        root = Path(tmp) / 'smoke'
        monkeypatch.setenv('REGDA_SMOKE_ROOT', str(root))
        monkeypatch.setenv('REGDA_SMOKE_STEPS', '2')
        monkeypatch.setenv('REGDA_DEVICE_DATA', '1')
        seen = _device_data_chain(root)
        for run in (seen.src, seen.ssl):
            assert isinstance(run.source, DeviceLoader) and isinstance(run.target, DeviceLoader)
        assert seen.ssl.target.dataset.label_type == 'prob'
        assert len(seen.metrics) == 4
        for m in seen.metrics:
            assert all(np.isfinite(float(v)) for v in m.values()), m
        # stage 1's eval at its last step, stage 3's pseudo-label pass, then
        # its evals at steps 1 and 2: one val set, built once and kept
        assert len(seen.sets) == 4
        assert all(isinstance(s, DeviceEvalSet) for s in seen.sets)
        val, pseudo = seen.sets[0], seen.sets[1]
        assert seen.sets[2] is val and seen.sets[3] is val and val.ds.cls_paths
        assert pseudo is not val and not pseudo.ds.cls_paths     # images and names only
        # two loaders a stage, and init_prototypes' one in the stage-1 directory
        for stage, loaders in (('src', 3), ('ssl', 2)):
            text = ''.join(open(f).read() for f in glob.glob(str(root / 'log' / stage / '*.log')))
            assert text.count('device-resident data: 4 tiles cached on cpu') == loaders, stage
            assert 'falling back' not in text and 'disabled' not in text
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
