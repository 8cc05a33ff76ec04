"""The port's pseudo-label analysis and its SAM stability check on the CPU,
held against the JAX package.

  * `tile_bin_stats` on tests/test_utils_extra.py's cases, and against the
    JAX function on seeded random probabilities: the selected and correct
    pixels in all equal exactly; per bin, the counts equal except for
    pixels whose entropy lies within 1e-5 of a bin edge (the port bins a
    float64 entropy, JAX a float32 one; such pixels are counted and may
    move one bin); acc and diffi rtol 1e-5 in the bins both fill alike.
  * `analysis_pseudo_labels` over two tiles equals the JAX sweep (counts
    exactly, acc / diffi rtol 1e-5) and writes the three plots;
    `class_distribution` / `da_class_bar` equal JAX's.
  * `check_sam_stability --device cpu` at vit_t on one 96^2 tile writes its
    report (the JAX tool's keys, plus the device) to --out and nothing else.
  * The port's tool and tools/check_sam_stability.py, given one `.pth` and
    the same flags, report the same: candidate, flip and region counts and
    the region agreements exactly, the deltas, percentiles and thresholds
    rtol 1e-5 / atol 1e-6 (float32 on both sides; JAX with
    REGDA_SAM_NO_IOU_GATE=1 so that it scores every candidate, as the port's
    tool always does).
"""

import functools
import importlib.util
import json
import math
import os
import shutil
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

import regda_tpu.models.sam as jsam
import regda_tpu.models.sam.auto as jauto
from regda_tpu import analysis as janalysis
from regda_tpu_torch import analysis as tanalysis
from regda_tpu_torch.models.sam.convert import sam_from_jax_variables
from regda_tpu_torch.tools import check_sam_stability

TORCH_THREADS = 2
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def _stats(probs, gt, c, range_cnt):
    got = tanalysis.tile_bin_stats(torch.from_numpy(probs), torch.from_numpy(gt), c,
                                   range_cnt=range_cnt)
    want = janalysis.tile_bin_stats(jnp.asarray(probs), jnp.asarray(gt), c,
                                    range_cnt=range_cnt)
    return ({k: v.numpy() for k, v in got.items()},
            {k: np.asarray(v, np.float64) for k, v in want.items()})


def test_tile_bin_stats_confident_correct():
    c, h, w = 4, 8, 8
    gt = np.random.RandomState(0).randint(0, c, (h, w))
    probs = np.full((h, w, c), 0.01, np.float32)
    probs[np.arange(h)[:, None], np.arange(w)[None], gt] = 0.97
    got, want = _stats(probs, gt, c, 10)
    assert got['cnt_used'].sum() == h * w and got['cnt_used'][:3].sum() == h * w
    np.testing.assert_array_equal(got['cnt_true'], got['cnt_used'])
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


def test_tile_bin_stats_uniform_probs_unused():
    c, h, w = 4, 8, 8
    probs = np.full((h, w, c), 1.0 / c, np.float32)
    gt = np.zeros((h, w), np.int64)
    got, want = _stats(probs, gt, c, 10)
    assert got['cnt_used'].sum() == 0 and got['diffi'][-1] > 0.7
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


def _random_tile(rng, h, w, c, scale=3.0):
    logits = scale * rng.standard_normal((h, w, c)).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    gt = np.where(rng.random((h, w)) < 0.8, logits.argmax(-1), rng.integers(-1, c, (h, w)))
    return probs.astype(np.float32), gt.astype(np.int32)


@pytest.mark.parametrize('c,range_cnt', [(6, 100), (4, 20), (7, 50)])
def test_tile_bin_stats_matches_jax(c, range_cnt):
    probs, gt = _random_tile(np.random.default_rng(c), 48, 40, c)
    got, want = _stats(probs, gt, c, range_cnt)
    for k in ('cnt_used', 'cnt_true'):
        assert got[k].sum() == want[k].sum(), k
    p = probs.astype(np.float64)
    pos = -(p * np.log(np.clip(p, 1e-7, None))).sum(-1) / (math.log(c) / range_cnt)
    near_edge = int((np.abs(pos - np.round(pos)) < 1e-5 * range_cnt).sum())
    for k in ('cnt_used', 'cnt_true'):
        assert np.abs(got[k] - want[k]).sum() <= 2 * near_edge, k
    alike = got['cnt_used'] == want['cnt_used']
    for k in ('acc', 'diffi'):
        np.testing.assert_allclose(got[k][alike], want[k][alike], rtol=1e-5, atol=1e-7)
    assert got['cnt_used'].sum() > 0


def _write_pairs(tmp, c=4, h=16, w=16, n=2, seed=1):
    lbl_dir, psd_dir = tmp / 'ann', tmp / 'pseudo'
    lbl_dir.mkdir()
    psd_dir.mkdir()
    rng = np.random.default_rng(seed)
    for i in range(n):
        probs, gt = _random_tile(rng, h, w, c)
        Image.fromarray(np.where(gt < 0, 255, gt).astype(np.uint8)).save(lbl_dir / f't{i}.png')
        np.save(psd_dir / f't{i}.npy', probs)
    return str(lbl_dir), str(psd_dir)


def test_analysis_pseudo_labels_matches_jax(tmp):
    c = 4
    lbl_dir, psd_dir = _write_pairs(tmp, c)
    got = tanalysis.analysis_pseudo_labels(lbl_dir, psd_dir, n_classes=c, range_cnt=20,
                                           out_dir=str(tmp / 'plots'), device='cpu')
    want = janalysis.analysis_pseudo_labels(lbl_dir, psd_dir, n_classes=c, range_cnt=20)
    assert got.keys() == want.keys()
    for k in ('x', 'cnt_used', 'cnt_true'):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ('acc', 'diffi'):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-7, err_msg=k)
    assert got['cnt_used'].sum() > 0
    for f in ('tradeoff.png', 'noise_rate.png', 'counts.png'):
        assert os.path.getsize(tmp / 'plots' / f) > 0
    again = tanalysis.analysis_pseudo_labels(lbl_dir, psd_dir, n_classes=c, range_cnt=20,
                                             device='cpu')
    np.testing.assert_array_equal(again['cnt_used'], got['cnt_used'])


def test_analysis_pseudo_labels_refuses_unpaired_trees(tmp):
    lbl_dir, psd_dir = _write_pairs(tmp)
    os.remove(os.path.join(psd_dir, 't1.npy'))
    with pytest.raises(ValueError, match='pseudo maps'):
        tanalysis.analysis_pseudo_labels(lbl_dir, psd_dir, n_classes=4, device='cpu')


def test_analysis_runs_on_the_card_by_default(tmp):
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    lbl_dir, psd_dir = _write_pairs(tmp)
    with pytest.raises(RuntimeError, match='CUDA'):
        tanalysis.analysis_pseudo_labels(lbl_dir, psd_dir, n_classes=4)


def test_class_distribution_and_bar_match_jax(tmp):
    d1, d2 = tmp / 'a', tmp / 'b'
    d1.mkdir()
    d2.mkdir()
    Image.fromarray(np.array([[0, 0], [1, 2]], np.uint8)).save(d1 / 'm.png')
    Image.fromarray(np.array([[2, 2], [2, 1]], np.uint8)).save(d2 / 'm.png')
    Image.fromarray(np.array([[2, 7], [0, 1]], np.uint8)).save(d2 / 'n.png')
    for offset in (0, -1):
        np.testing.assert_allclose(tanalysis.class_distribution(str(d1), 3, offset),
                                   janalysis.class_distribution(str(d1), 3, offset), rtol=1e-7)
    np.testing.assert_allclose(tanalysis.class_distribution(str(d1), 3), [0.5, 0.25, 0.25])
    got = tanalysis.da_class_bar(str(d1), str(d2), ['bg', 'a', 'b'], str(tmp / 'bar.png'))
    want = janalysis.da_class_bar(str(d1), str(d2), ['bg', 'a', 'b'], str(tmp / 'jbar.png'))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-7)
    assert os.path.getsize(tmp / 'bar.png') > 0


# keys of tools/check_sam_stability.py's report
JAX_REPORT_KEYS = {
    'stability_delta': {'n_candidates', 'mean_abs', 'p95_abs', 'max_abs',
                        'decision_flips_at_0.95', 'flip_rate', 'decision_flips_at_median',
                        'flip_rate_at_median', 'score_dist_fast', 'score_dist_exact',
                        'iou_dist'},
    'auto_thresholds': {'iou', 'stability'},
    'regions_crop0': {'region_counts_fast', 'region_counts_exact',
                      'assigned_pixel_agreement', 'pairwise_same_region_agreement'},
    'regions_crop1': {'region_counts_fast', 'region_counts_exact',
                      'assigned_pixel_agreement', 'pairwise_same_region_agreement'},
    'config': {'vit_config', 'tiles', 'size', 'seed', 'checkpoint'},
}


def test_check_sam_stability_writes_only_its_out(tmp):
    out = tmp / 'report.json'
    stability_json = os.path.join(ROOT, 'PERF_stability.json')
    before = os.stat(stability_json).st_mtime_ns
    report = check_sam_stability.main([
        '--device', 'cpu', '--vit-config', 'vit_t', '--img-size', '128', '--tiles', '1',
        '--size', '96', '--points-per-side', '8', '--points-per-batch', '32',
        '--area-threshold', '16', '--auto-thresh', '--out', str(out)])
    assert os.listdir(tmp) == ['report.json']
    assert os.stat(stability_json).st_mtime_ns == before
    assert json.loads(out.read_text()) == json.loads(json.dumps(report))
    assert set(report) == set(JAX_REPORT_KEYS)
    for k, keys in JAX_REPORT_KEYS.items():
        extra = {'device'} if k == 'config' else set()
        assert set(report[k]) == keys | extra, k
    delta = report['stability_delta']
    assert delta['n_candidates'] == 8 * 8 * 3
    assert 0.0 <= delta['flip_rate'] <= 1.0 and 0.0 <= delta['flip_rate_at_median'] <= 1.0
    assert report['config']['device'] == 'cpu'
    for layers in (0, 1):
        regions = report[f'regions_crop{layers}']
        assert len(regions['region_counts_fast']) == len(regions['region_counts_exact']) == 1


def test_check_sam_stability_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    with pytest.raises(RuntimeError, match='CUDA'):
        check_sam_stability.main(['--vit-config', 'vit_t', '--tiles', '1'])


def _run_jax_stability_tool(monkeypatch, argv):
    """tools/check_sam_stability.py's `main` in process, at float32, with
    `argv`; it sets a compilation cache of its own, restored afterwards."""
    spec = importlib.util.spec_from_file_location(
        'jax_check_sam_stability', os.path.join(ROOT, 'tools', 'check_sam_stability.py'))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    monkeypatch.setattr(jsam, 'Sam', functools.partial(jsam.Sam, dtype=jnp.float32))
    monkeypatch.setattr(jauto, 'SamRegionGenerator',
                        functools.partial(jauto.SamRegionGenerator, compute_dtype=jnp.float32))
    monkeypatch.setattr(sys, 'argv', ['check_sam_stability.py'] + argv)
    monkeypatch.setenv('REGDA_SAM_NO_IOU_GATE', '1')
    cache = jax.config.jax_compilation_cache_dir
    try:
        tool.main()
    finally:
        jax.config.update('jax_compilation_cache_dir', cache)


def test_check_sam_stability_matches_the_jax_tool(tmp, monkeypatch):
    """One checkpoint through both tools. The weights are a JAX vit_t init
    with the mask head's upscaling convolutions scaled by 3, so that the
    masks straddle the stability offsets: the scores spread over 0.1-0.95,
    candidates flip at 0.95 and at the median, and the two modes' region
    maps differ."""
    img = 128
    model = jsam.Sam(vit_config='vit_t', img_size=img, dtype=jnp.float32)
    variables = model.init({'params': jax.random.PRNGKey(0)}, jnp.zeros((1, img, img, 3)),
                           jnp.zeros((1, 1, 2)), jnp.ones((1, 1), jnp.int32))
    state = {k: v * 3 if k.startswith('mask_decoder.output_upscaling.') else v
             for k, v in sam_from_jax_variables(variables).items()}
    ckpt = tmp / 'sam_vit_t.pth'
    torch.save(state, ckpt)
    flags = ['--vit-config', 'vit_t', '--img-size', str(img), '--tiles', '1', '--size', '96',
             '--points-per-side', '8', '--points-per-batch', '32', '--area-threshold', '16',
             '--auto-thresh', '--checkpoint', str(ckpt)]
    monkeypatch.setattr(check_sam_stability, 'Sam',
                        functools.partial(check_sam_stability.Sam, dtype=torch.float32))
    got = check_sam_stability.main(['--device', 'cpu'] + flags)
    _run_jax_stability_tool(monkeypatch, ['--out', str(tmp / 'jax.json')] + flags)
    want = json.loads((tmp / 'jax.json').read_text())

    delta, want_delta = got['stability_delta'], want['stability_delta']
    exact_keys = ('n_candidates', 'decision_flips_at_0.95', 'flip_rate',
                  'decision_flips_at_median', 'flip_rate_at_median')
    assert {k: delta[k] for k in exact_keys} == {k: want_delta[k] for k in exact_keys}
    assert delta['n_candidates'] == 8 * 8 * 3
    assert delta['decision_flips_at_0.95'] > 0 and delta['decision_flips_at_median'] > 0
    for k in ('mean_abs', 'p95_abs', 'max_abs'):
        np.testing.assert_allclose(delta[k], want_delta[k], rtol=1e-5, atol=1e-6, err_msg=k)
    assert delta['mean_abs'] > 0.05
    for dist in ('score_dist_fast', 'score_dist_exact', 'iou_dist'):
        for q, v in want_delta[dist].items():
            np.testing.assert_allclose(delta[dist][q], v, rtol=1e-5, atol=1e-6,
                                       err_msg=f'{dist} {q}')
    for k, v in want['auto_thresholds'].items():
        np.testing.assert_allclose(got['auto_thresholds'][k], v, rtol=1e-5, atol=1e-6, err_msg=k)
    for layers in (0, 1):
        key = f'regions_crop{layers}'
        assert got[key] == want[key], key
    assert got['regions_crop0']['region_counts_fast'] != got['regions_crop0']['region_counts_exact']
