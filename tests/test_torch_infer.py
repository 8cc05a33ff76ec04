"""The port's serve path against the JAX package on the CPU: tiling, TTA,
sliding-window accumulation, BatchNorm folding, the fused dual-PPM forward,
the segmenter's variants, `SegInferencer`, the pixel metrics and the
configs.

Models are resnet18 at 64 px or less, float32, with the JAX model's
variables (non-trivial BN scales, biases and running statistics) carried
into the port by `from_jax_variables`; head dropout is off on both sides.

Tolerances. Functions that only move and add values (TTA, the slide's
accumulation, the fold's per-channel products) are held within 1e-6. Eval
outputs are held at rtol 1e-4, atol 1e-5, as tests/test_torch_model.py holds
them (XLA and oneDNN sum the convolutions in another order). Train forwards
are held at atol 1e-4, that file's train tolerance: batch-statistics BNs
over a 2 x 4 x 4 stride-16 map amplify float32 rounding (against a float64
run of the port, the JAX float32 features are 1.1e-4 off, the port's 5.6e-5).
Without instance norm the heads' train-mode BNs see unnormalized features
and the JAX float32 logits are 3.1e-4 from that float64 run (the port's
4e-5), so that variant's train forward is held at atol 4e-4.
"""

import copy
import functools
import sys

import numpy as np
import pytest
import torch

import flax.linen as nn
import jax
import jax.numpy as jnp

from regda_tpu.infer import SegInferencer as JaxInferencer
from regda_tpu.models.deeplabv2 import build_deeplabv2 as jax_build
from regda_tpu.models.fold_bn import fold_batchnorm as jax_fold
from regda_tpu.models.fold_bn import folded_model as jax_folded_model
from regda_tpu.models.fused_eval import fused_dual_ppm_eval as jax_fused
from regda_tpu.ops.slide import slide_inference as jax_slide
from regda_tpu.ops.slide import tile_positions as jax_tile_positions
from regda_tpu.ops.tta import tta_apply as jax_tta
from regda_tpu.utils.metrics import PixelMetricIgnore as JaxMetric
from regda_tpu_torch.infer import SegInferencer
from regda_tpu_torch.models import build_deeplabv2
from regda_tpu_torch.models.fold_bn import fold_batchnorm, folded_model
from regda_tpu_torch.models.fused_eval import fused_dual_ppm_eval, supports_fused_heads
from regda_tpu_torch.models.heads import Dropout2d
from regda_tpu_torch.ops.slide import slide_inference, tile_positions
from regda_tpu_torch.ops.tta import tta_apply
from regda_tpu_torch.utils.convert import from_jax_variables
from regda_tpu_torch.utils.metrics import PixelMetricIgnore

RTOL, ATOL = 1e-4, 1e-5
TRAIN_ATOL = 1e-4
TRAIN_NO_INS_NORM_ATOL = 4e-4
MOVE_TOL = 1e-6
C = 6
SIZE = 64


def _no_dropout(next_fun, args, kwargs, context):
    if isinstance(context.module, nn.Dropout) and context.method_name == '__call__':
        return args[0]
    return next_fun(*args, **kwargs)


def _randomize_bn(tree, rng, stats: bool):
    """BN scales and running variances in [0.5, 1.5), biases and means
    normal(0, 0.1): folding them moves every kernel."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomize_bn(v, rng, stats)
        elif stats or 'scale' in tree:
            big = k in ('scale', 'var')
            out[k] = (rng.uniform(0.5, 1.5, v.shape) if big
                      else rng.normal(0.0, 0.1, v.shape)).astype(np.float32)
        else:
            out[k] = v
    return out


@functools.lru_cache(maxsize=None)
def _make_pair(**kw):
    """(JAX model, its variables, the port model carrying them) for resnet18
    with the DeeplabV2 settings `kw`."""
    jmodel = jax_build('resnet18', num_classes=C, **kw)
    variables = jax.tree.map(np.asarray, jmodel.init(
        {'params': jax.random.PRNGKey(0)}, jnp.zeros((1, SIZE, SIZE, 3)), train=False))
    rng = np.random.default_rng(0)
    variables = {'params': _randomize_bn(variables['params'], rng, stats=False),
                 'batch_stats': _randomize_bn(variables['batch_stats'], rng, stats=True)}
    tmodel = build_deeplabv2('resnet18', num_classes=C, **kw)
    tmodel.load_state_dict(from_jax_variables(variables), strict=True)
    for m in tmodel.modules():
        if isinstance(m, Dropout2d):
            m.p = 0.0
    return jmodel, variables, tmodel


def _pair(**kw):
    return _make_pair(**dict(sorted(kw.items())))


def _image(seed, h=SIZE, w=SIZE, b=2):
    return np.random.default_rng(seed).normal(size=(b, h, w, 3)).astype(np.float32)


# ---- tiling, TTA and the slide's accumulation -------------------------------

@pytest.mark.parametrize('h,w,tile,stride', [
    (1024, 1024, 512, 256), (96, 80, 64, 32), (50, 40, 32, 16), (20, 100, 32, 16),
    (64, 64, 64, 32), (513, 700, 512, 256), (6000, 6000, 512, 512)])
def test_tile_positions_match_jax(h, w, tile, stride):
    assert tile_positions(h, w, tile, stride) == jax_tile_positions(h, w, tile, stride)


def _position_fn(lib):
    """A deterministic stand-in for a model whose output depends on where a
    pixel sits in its tile and on its values, in numpy-like `lib`."""
    def fn(t):
        h, w = t.shape[1:3]
        ramp = (lib.arange(h, dtype=lib.float32)[:, None] * 0.031
                + lib.arange(w, dtype=lib.float32)[None, :] * 0.017)
        base = t.sum(-1) + t[..., 0] * ramp
        return lib.stack([base * (i + 1) + ramp * i for i in range(4)], axis=-1)
    return fn


@pytest.mark.parametrize('b,s', [(2, 8), (3, 13)])
def test_tta_apply_matches_jax(b, s):
    """TTA rotates, so its images are square (slide tiles are)."""
    x = _image(1, s, s, b)
    want = np.asarray(jax_tta(_position_fn(jnp), jnp.asarray(x)))
    got = tta_apply(_position_fn(torch), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=MOVE_TOL, atol=MOVE_TOL)


@pytest.mark.parametrize('h,w,tile,stride,tta', [
    (64, 64, 32, 16, False), (50, 40, 32, 16, True), (20, 24, 32, 16, False),
    (20, 40, 32, 16, True), (96, 80, 64, 32, True)])
def test_slide_inference_matches_jax(h, w, tile, stride, tta):
    """Count-normalized sums, with zero padding where the image is smaller
    than a tile (h = 20) and end-aligned edge tiles."""
    x = _image(2, h, w)
    want = np.asarray(jax_slide(_position_fn(jnp), jnp.asarray(x), 4, tile, stride, tta))
    got = slide_inference(_position_fn(torch), torch.from_numpy(x), 4, tile, stride, tta)
    assert got.shape == (2, h, w, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=MOVE_TOL, atol=MOVE_TOL)


# ---- BatchNorm folding and the fused forward ---------------------------------

@pytest.mark.parametrize('kw', [{}, {'multi_layer': False}])
def test_fold_batchnorm_matches_jax(kw):
    _, variables, tmodel = _pair(**kw)
    want = from_jax_variables(jax.tree.map(np.asarray, jax_fold(variables)))
    got = fold_batchnorm(tmodel.state_dict())
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=MOVE_TOL,
                                   atol=MOVE_TOL, err_msg=k)
    folded = folded_model(tmodel)
    assert set(folded.state_dict()) == set(want)
    assert not any('running' in k for k in folded.state_dict())


def test_fold_batchnorm_leaves_a_folded_state_dict_unchanged():
    _, _, tmodel = _pair()
    once = fold_batchnorm(tmodel.state_dict())
    again = fold_batchnorm(once)
    assert set(again) == set(once) and all(again[k] is once[k] for k in once)


def test_folded_model_is_inference_only():
    folded = folded_model(_pair()[2])
    with pytest.raises(RuntimeError, match='inference-only'):
        folded.train()(torch.from_numpy(_image(3)))


def _jax_eval(jmodel, variables, x, kind):
    if kind == 'stock':
        return jmodel.apply(variables, x, train=False)
    fmodel, fvars = jax_folded_model(jmodel), jax_fold(variables)
    if kind == 'folded':
        return fmodel.apply(fvars, x, train=False)
    return jax_fused(fmodel, fvars, x)


@pytest.mark.parametrize('kind', ['folded', 'fused'])
def test_folded_and_fused_eval_match_jax(kind):
    jmodel, variables, tmodel = _pair()
    x = _image(4)
    want = np.asarray(_jax_eval(jmodel, variables, jnp.asarray(x), kind))
    folded = folded_model(tmodel)
    assert supports_fused_heads(folded) and not supports_fused_heads(tmodel.eval())
    with torch.no_grad():
        t = torch.from_numpy(x)
        got = (folded(t) if kind == 'folded' else fused_dual_ppm_eval(folded, t)).numpy()
        stock = tmodel.eval()(t).numpy()
    assert got.shape == (2, SIZE, SIZE, C)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, stock, rtol=RTOL, atol=ATOL)


def _as(model, memory_format):
    return copy.deepcopy(model).to(memory_format=memory_format)


@pytest.mark.parametrize('dtype,tf32,source,want', [
    (torch.float32, False, torch.channels_last, torch.contiguous_format),
    (torch.float32, False, torch.contiguous_format, torch.contiguous_format),
    (torch.float32, True, torch.contiguous_format, torch.channels_last),
    (torch.bfloat16, False, torch.contiguous_format, torch.channels_last),
], ids=['f32-from-channels-last', 'f32-from-nchw', 'tf32-from-nchw', 'bf16-from-nchw'])
def test_folded_model_layout_follows_the_precision(monkeypatch, dtype, tf32, source, want):
    """float32 with cuDNN's TF32 off folds into NCHW-contiguous weights,
    bf16 or TF32 into channels-last ones, whatever the source's layout; the
    folded model's encoder gets its input in that layout."""
    monkeypatch.setattr(torch.backends.cudnn, 'allow_tf32', tf32)
    model = build_deeplabv2('resnet18', num_classes=C, dtype=dtype)
    model.load_state_dict(_pair()[2].state_dict())
    folded = folded_model(_as(model, source))
    convs = [p for p in folded.parameters() if p.dim() == 4]
    assert len(convs) > 20 and all(p.is_contiguous(memory_format=want) for p in convs)
    seen = []
    folded.encoder.register_forward_pre_hook(
        lambda _, args: seen.append(args[0].is_contiguous(memory_format=want)))
    with torch.no_grad():
        out = folded(torch.from_numpy(_image(7)))
    assert seen == [True] and out.shape == (2, SIZE, SIZE, C)


@pytest.mark.parametrize('kind', ['folded', 'fused'])
def test_nchw_folded_eval_of_a_channels_last_source_matches_jax(monkeypatch, kind):
    """The f32 folded model of a channels-last source, with TF32 off (the
    CLIs' setting), is NCHW and still gives the JAX package's folded and
    fused forwards."""
    monkeypatch.setattr(torch.backends.cudnn, 'allow_tf32', False)
    jmodel, variables, tmodel = _pair()
    x = _image(4)
    want = np.asarray(_jax_eval(jmodel, variables, jnp.asarray(x), kind))
    folded = folded_model(_as(tmodel, torch.channels_last))
    assert folded.encoder.resnet.conv1.weight.is_contiguous()
    with torch.no_grad():
        t = torch.from_numpy(x)
        got = (folded(t) if kind == 'folded' else fused_dual_ppm_eval(folded, t)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


VARIANTS = {
    'aspp': dict(use_ppm=False),
    'single_ppm': dict(multi_layer=False),
    'single_aspp': dict(multi_layer=False, use_ppm=False),
    'no_ins_norm': dict(is_ins_norm=False),
}


@pytest.mark.parametrize('variant', sorted(VARIANTS))
def test_variant_eval_forward_matches_jax(variant):
    jmodel, variables, tmodel = _pair(**VARIANTS[variant])
    x = _image(5)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = tmodel.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == (2, SIZE, SIZE, C)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('variant', sorted(VARIANTS))
def test_variant_train_forward_matches_jax(variant):
    kw = VARIANTS[variant]
    jmodel, variables, tmodel = _pair(**kw)
    x = _image(6)
    with nn.intercept_methods(_no_dropout):
        want, _ = jmodel.apply(variables, jnp.asarray(x), train=True, mutable=['batch_stats'],
                               rngs={'dropout': jax.random.PRNGKey(0)})
    model = build_deeplabv2('resnet18', num_classes=C, **kw)
    model.load_state_dict(from_jax_variables(variables), strict=True)
    for m in model.modules():
        if isinstance(m, Dropout2d):
            m.p = 0.0
    got = model.train()(torch.from_numpy(x))
    assert len(got) == len(want) == (3 if kw.get('multi_layer', True) else 2)
    atol = TRAIN_ATOL if kw.get('is_ins_norm', True) else TRAIN_NO_INS_NORM_ATOL
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=RTOL, atol=atol)


# ---- SegInferencer ------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _inferencers():
    jmodel, variables, tmodel = _pair()
    return (JaxInferencer(jmodel, variables, C, tile=64, stride=32),
            SegInferencer(tmodel, C, tile=64, stride=32))


@pytest.mark.parametrize('slide,tta', [(True, False), (False, True), (True, True)])
def test_seg_inferencer_probs_match_jax(slide, tta):
    jinf, tinf = _inferencers()
    assert tinf.fold_bn and tinf.model.folded and tinf.fused_ppm
    h, w = (96, 80) if slide else (64, 64)   # whole-image TTA rotates: square only
    x = _image(7, h, w, b=1)
    want = jinf.predict_probs(x, slide=slide, tta=tta)
    got = tinf.predict_probs(x, slide=slide, tta=tta)
    assert got.shape == want.shape == (1, h, w, C) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_seg_inferencer_labels_match_jax():
    jinf, tinf = _inferencers()
    x = _image(8, 96, 80, b=1)
    probs = jinf.predict_probs(x, slide=True, tta=True)
    want = jinf.predict_labels(x, slide=True, tta=True)
    got = tinf.predict_labels(x, slide=True, tta=True)
    assert got.dtype == np.int32 and got.shape == (1, 96, 80)
    top2 = np.sort(probs, axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 1e-4    # labels may differ only at near-ties
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(got[clear], want[clear])


def test_seg_inferencer_multiscale_matches_jax():
    jinf, tinf = _inferencers()
    x = _image(9, 48, 40, b=1)
    scales = (0.75, 1.5)
    want = jinf.predict_multiscale(x, scales=scales)
    got = tinf.predict_multiscale(x, scales=scales)
    assert got.shape == (1, 48, 40, C)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_seg_inferencer_update_variables_refolds():
    _, variables, _ = _pair()
    inf = SegInferencer(build_deeplabv2('resnet18', C), C, tile=64, stride=32)
    inf.update_variables(from_jax_variables(variables))
    x = _image(10, b=1)
    _, tinf = _inferencers()
    np.testing.assert_array_equal(inf.predict_probs(x, slide=False),
                                  tinf.predict_probs(x, slide=False))


def test_seg_inferencer_reads_its_switches_once(monkeypatch):
    _, _, tmodel = _pair()
    monkeypatch.setenv('REGDA_NO_FOLD_BN', '1')
    monkeypatch.setenv('REGDA_NO_FUSED_PPM', '1')
    inf = SegInferencer(tmodel, C, tile=64, stride=32)
    assert not inf.fold_bn and not inf.fused_ppm and inf.model is tmodel
    monkeypatch.delenv('REGDA_NO_FOLD_BN')
    monkeypatch.delenv('REGDA_NO_FUSED_PPM')
    assert not inf.fused_ppm    # the forward does not read the environment again
    assert SegInferencer(tmodel, C).fused_ppm


# ---- metrics and configs -----------------------------------------------------

@pytest.mark.parametrize('names,ignore', [(None, ()), (('bg', 'a', 'b', 'c', 'd', 'e'), (0,)),
                                          (('bg', 'a', 'b', 'c', 'd', 'e'), (0, 3))])
def test_pixel_metric_matches_jax(names, ignore):
    rng = np.random.default_rng(11)
    y_true = rng.integers(-1, C, size=(3, 40, 40))
    y_pred = np.where(rng.random(y_true.shape) < 0.6, y_true, rng.integers(0, C, y_true.shape))
    y_pred = np.clip(y_pred, 0, C - 1)
    jm, tm = JaxMetric(C, names, ignore_labels=ignore), PixelMetricIgnore(C, names, ignore_labels=ignore)
    for b in range(3):
        jm.forward(y_true[b], y_pred[b])
        tm.forward(y_true[b], y_pred[b])
    np.testing.assert_array_equal(tm.confusion_matrix, jm.confusion_matrix)
    (jtb, jmiou), (ttb, tmiou) = jm.summary_all(), tm.summary_all()
    assert str(ttb) == str(jtb) and tmiou == jmiou


def _plain(v):
    """A config value as plain data: transform objects by class name and
    attributes, arrays as lists."""
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    if isinstance(v, np.ndarray):
        return v.tolist()
    if hasattr(v, '__dict__') and not isinstance(v, type):
        return (type(v).__name__, _plain(vars(v)))
    return v


@pytest.mark.parametrize('name', ['tiny_smoke', 'tiny_smoke_loveda', '2vaihingen', '2potsdam',
                                  '2rural', '2urban', 'pRgb2vaihingen', 'pRgb2potsdam',
                                  '2vaihingen_tsne', '2potsdam_tsne'])
def test_import_config_matches_top_level(name, tmp_path, monkeypatch):
    from regda_tpu.utils.tools import import_config as jax_import_config
    from regda_tpu_torch.utils.tools import import_config
    monkeypatch.setenv('REGDA_SMOKE_ROOT', str(tmp_path / 'isprs'))
    monkeypatch.setenv('REGDA_SMOKE_ROOT_LOVEDA', str(tmp_path / 'loveda'))
    for mod in (f'configs.st.regda.{name}', f'regda_tpu_torch.configs.st.regda.{name}'):
        monkeypatch.delitem(sys.modules, mod, raising=False)
    want = jax_import_config(f'st.regda.{name}', copy=False, create=False)
    got = import_config(f'st.regda.{name}', copy=False, create=False)
    assert got.__name__.startswith('regda_tpu_torch.configs.')
    names = sorted(k for k in vars(want) if k.isupper())
    assert names == sorted(k for k in vars(got) if k.isupper())
    for k in names:
        assert _plain(getattr(got, k)) == _plain(getattr(want, k)), k
    rng = np.random.default_rng(12)
    sample = {'image': rng.uniform(0, 255, (530, 520, 3)).astype(np.float32),
              'cls': rng.integers(0, C, (530, 520)).astype(np.int64)}
    for cfg in ('TEST_DATA_CONFIG', 'SOURCE_DATA_CONFIG', 'TARGET_DATA_CONFIG'):
        a = getattr(got, cfg)['transforms'](sample, np.random.default_rng(13))
        b = getattr(want, cfg)['transforms'](sample, np.random.default_rng(13))
        assert sorted(a) == sorted(b)
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=f'{cfg} {key}')
