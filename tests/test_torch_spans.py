"""The port's profiler spans (regda_tpu_torch/utils/profiling.py:span) on
the CPU, at tiny sizes (resnet18 at 64 px, batch 2 a domain; a vit_t region
generator on one 96^2 tile): with no profiler active no span enters
`record_function`; under `torch.profiler` each instrumented entry yields its
spans, each once where the entry runs its phase once, nested and in order.
"""

import collections
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from regda_tpu_torch.entry import (sam_regions_entry, serve_entry, stage2_state, stage3_state,
                                   synthetic_soft_labels, synthetic_stage2_batch)
from regda_tpu_torch.train import steps as tsteps
from regda_tpu_torch.train.loop import Trainer
from regda_tpu_torch.utils import profiling

HW, B = 64, 2
LAYERS = ('loop', 'step', 'infer', 'sam', 'kernel')
SAM_STAGES = ('encode', 'decode', 'stability', 'select', 'mask_stats', 'preprocess', 'nms',
              'paint', 'download')
# everything passes the filters, so that a region is painted and downloaded
SAM_OPEN = dict(points_per_side=4, points_per_batch=8, pred_iou_thresh=-1e9,
                stability_score_thresh=0.0, mask_budget=16)


@pytest.fixture(scope='module', autouse=True)
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _trainer(tmp_path):
    state, step = stage2_state('cpu', resnet='resnet18')
    cfg = types.SimpleNamespace(SOURCE_DATA_CONFIG=dict(batch_size=B), DATASETS='IsprsDA',
                                SNAPSHOT_DIR=str(tmp_path), TARGET_SET='Vaihingen')
    return Trainer(state.model, cfg, None, state, step)


def _batch(seed=1):
    return synthetic_stage2_batch(np.random.default_rng(seed), B, HW)


def _run_stage2(tmp_path):
    images_s, label_s, images_t, regs_t = _batch()
    _trainer(tmp_path).run_step(i_iter=0, images_s=images_s, label_s=label_s,
                                images_t=images_t, regs_t=regs_t)


def _run_stage1(tmp_path):
    state, _ = stage2_state('cpu', resnet='resnet18')
    images_s, label_s, images_t, _ = (torch.from_numpy(a) for a in _batch())
    tsteps.make_stage1_step(align_domain=True, num_classes=6)(state, images_s, label_s,
                                                              images_t)


def _run_stage3(tmp_path):
    state, step = stage3_state('cpu', resnet='resnet18')
    rng = np.random.default_rng(1)
    images_s, label_s, images_t, regs_t = synthetic_stage2_batch(rng, B, HW)
    soft = synthetic_soft_labels(rng, B, HW)
    step(state, *(torch.from_numpy(a) for a in (images_s, label_s, images_t, soft, regs_t)))


def _inferencer():
    return serve_entry('cpu', dtype=torch.float32, resnet='resnet18', images=1, size=96,
                       tile=64, stride=32)


def _run_labels(tmp_path):
    inf, images = _inferencer()
    inf.predict_labels(images, slide=True, tta=True)


def _run_probs(tmp_path):
    inf, images = _inferencer()
    inf.predict_probs(images, slide=False, tta=False)


def _run_multiscale(tmp_path):
    inf, images = _inferencer()
    inf.predict_multiscale(images, scales=(0.5, 1.0))


def _run_regions(tmp_path, blocked_masks=True):
    gen, tiles = sam_regions_entry('cpu', vit_config='vit_t', img_size=128, tile=96, tiles=1,
                                   dtype=torch.float32, crop_n_layers=0,
                                   blocked_masks=blocked_masks, **SAM_OPEN)
    assert not gen.timing
    assert gen.generate_regions_batch(tiles)[0].max() > 0


ENTRIES = {'stage1': _run_stage1, 'stage2_run_step': _run_stage2, 'stage3': _run_stage3,
           'predict_labels': _run_labels, 'predict_probs': _run_probs,
           'predict_multiscale': _run_multiscale, 'sam_regions': _run_regions}


def _spans(entry, *args) -> dict:
    """name -> [(start, end), ...] of the port's spans while `entry` runs
    under a CPU profiler, in the order they opened."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        entry(*args)
    out = collections.defaultdict(list)
    for e in sorted(prof.events(), key=lambda e: e.time_range.start):
        if e.name.split('.', 1)[0] in LAYERS:
            out[e.name].append((e.time_range.start, e.time_range.end))
    return out


def _within(inner, outer) -> bool:
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def _once(spans, *names):
    for name in names:
        assert len(spans[name]) == 1, (name, spans[name])
    return [spans[name][0] for name in names]


def test_span_is_the_shared_null_context_without_a_profiler():
    assert not torch.autograd._profiler_enabled()
    assert profiling.span('step.forward') is profiling.span('kernel.two_way')
    with profiling.span('step.forward') as got:
        assert got is None


def test_span_names_its_region_under_a_profiler():
    def nested():
        with profiling.span('loop.run_step'):
            with profiling.span('loop.upload'):
                torch.ones(3).add_(1)
    spans = _spans(nested)
    outer, inner = _once(spans, 'loop.run_step', 'loop.upload')
    assert _within(inner, outer)


@pytest.mark.parametrize('entry', sorted(ENTRIES))
def test_no_record_function_without_a_profiler(entry, tmp_path, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError('record_function entered with no profiler active')

    monkeypatch.setattr(torch.profiler, 'record_function', refuse)
    ENTRIES[entry](tmp_path)


def test_stage2_run_step_spans(tmp_path):
    spans = _spans(_run_stage2, tmp_path)
    run, upload, fwd, pseudo, hist, bwd, opt = _once(
        spans, 'loop.run_step', 'loop.upload', 'step.forward', 'step.pseudo_label',
        'kernel.segment_hist', 'step.backward', 'step.optimizer')
    assert all(_within(s, run) for s in (upload, fwd, bwd, opt))
    assert _within(pseudo, fwd) and _within(hist, pseudo)
    assert upload[1] <= fwd[0] and fwd[1] <= bwd[0] and bwd[1] <= opt[0]
    assert not spans['step.grad_allreduce']     # no group


@pytest.mark.parametrize('entry', ['stage1', 'stage3'])
def test_stage1_and_stage3_step_spans(entry, tmp_path):
    spans = _spans(ENTRIES[entry], tmp_path)
    fwd, bwd, opt = _once(spans, 'step.forward', 'step.backward', 'step.optimizer')
    assert fwd[1] <= bwd[0] and bwd[1] <= opt[0]
    if entry == 'stage3':
        pseudo, hist = _once(spans, 'step.pseudo_label', 'kernel.segment_hist')
        assert _within(pseudo, fwd) and _within(hist, pseudo)
    else:
        assert not spans['step.pseudo_label'] and not spans['kernel.segment_hist']


@pytest.mark.parametrize('entry', ['predict_labels', 'predict_probs', 'predict_multiscale'])
def test_inferencer_spans(entry, tmp_path):
    spans = _spans(ENTRIES[entry], tmp_path)
    predict, upload, fwd, download = _once(spans, 'infer.predict', 'infer.upload',
                                           'infer.forward', 'infer.download')
    assert all(_within(s, predict) for s in (upload, fwd, download))
    assert upload[1] <= fwd[0] and fwd[1] <= download[0]
    # a new inferencer tunes its one signature, or one a scale
    tunes = spans['infer.tune']
    assert len(tunes) == (2 if entry == 'predict_multiscale' else 1)
    assert all(_within(t, fwd) for t in tunes)


def test_a_repeated_signature_opens_no_tune_span():
    inf, images = _inferencer()
    inf.predict_labels(images, slide=True, tta=True)
    spans = _spans(lambda: inf.predict_labels(images, slide=True, tta=True))
    assert spans['infer.forward'] and not spans['infer.tune'] and inf.tuned == 1


@pytest.mark.parametrize('blocked_masks', [True, False])
def test_sam_stage_and_kernel_spans(blocked_masks, tmp_path):
    spans = _spans(_run_regions, tmp_path, blocked_masks)
    assert all(spans[f'sam.{stage}'] for stage in SAM_STAGES), sorted(spans)
    stability = 'kernel.stability_blocked' if blocked_masks else 'kernel.stability_fused'
    kernels = ('kernel.layernorm', 'kernel.rel_attention', 'kernel.two_way', 'kernel.upscale',
               stability, 'kernel.mask_stats')
    assert all(spans[k] for k in kernels), sorted(spans)
    assert all(any(_within(s, e) for e in spans['sam.encode'])
               for s in spans['kernel.rel_attention'])
    assert all(any(_within(s, d) for d in spans['sam.decode']) for s in spans['kernel.two_way'])


def test_trainer_log_line_gives_the_pace_since_the_previous_line(tmp_path):
    trainer = _trainer(tmp_path)
    lines = []
    trainer.logger = types.SimpleNamespace(info=lines.append)
    images_s, label_s, images_t, regs_t = _batch()
    for i in range(2):
        metrics = trainer.run_step(i_iter=i, images_s=images_s, label_s=label_s,
                                   images_t=images_t, regs_t=regs_t)
        trainer.maybe_log(i, metrics)
    assert len(lines) == 1 and len(trainer.step_seconds) == 2
    ms = float(lines[0].split(' ms/step')[0].rsplit(' ', 1)[1])
    assert ms >= 1e3 * trainer.step_seconds[0] and 'items/s' in lines[0]
