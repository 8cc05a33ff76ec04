"""perfbench/work/spans.py and the readers of the program's spans, on a
hand-built trace whose busy intervals, spans and runtime events are known:
each reader gives the exact answer, None where the slice holds no span of
its name, and idle under nested or overlapping spans counts once."""

import pytest

from perfbench import harness
from perfbench.work import bounds, spans

B = harness.ROOT / 'perfbench'

# a slice of 1 s and 2 items; the device busy over [0, .2], [.3, .6], [.8, 1]
# (two operations overlap), so idle over [.2, .3] and [.6, .8]: 30 %
DEVICE = [('k0', 'kernel', 0.0, 0.2), ('k1', 'kernel', 0.3, 0.5),
          ('copy', 'gpu_memcpy', 0.45, 0.6), ('k2', 'kernel', 0.8, 1.0)]
HOST = [
    # the optimizer twice: idle .1 in each, .35 s of host
    ('step.optimizer', 'user_annotation', 0.15, 0.35),
    ('step.optimizer', 'user_annotation', 0.55, 0.7),
    # an operator of the same name is no span
    ('step.optimizer', 'cpu_op', 0.0, 1.0),
    # the backward, nested and overlapping: union [.7, .95], idle [.7, .8]
    ('step.backward', 'user_annotation', 0.7, 0.9),
    ('step.backward', 'user_annotation', 0.72, 0.78),
    ('step.backward', 'user_annotation', 0.85, 0.95),
    # the upload: .07 s of host
    ('loop.upload', 'user_annotation', 0.0, 0.05),
    ('loop.upload', 'user_annotation', 0.5, 0.52),
    # the predict: one past the slice's end (clipped, no idle), one idle .1
    ('infer.predict', 'user_annotation', 0.1, 0.4),
    ('infer.predict', 'user_annotation', 0.9, 1.2),
    # launches: 4 start inside the optimizer, one after it, one is a copy
    ('cudaLaunchKernel', 'cuda_runtime', 0.16, 0.161),
    ('cudaLaunchKernel', 'cuda_runtime', 0.34, 0.341),
    ('cudaLaunchKernel', 'cuda_runtime', 0.36, 0.361),
    ('cudaMemcpyAsync', 'cuda_runtime', 0.2, 0.21),
    ('cudaLaunchKernel', 'cuda_runtime', 0.6, 0.601),
    ('cudaLaunchKernelExC', 'cuda_runtime', 0.65, 0.651),
]
EXPECTED = {'train.optimizer_ms': 175.0, 'train.optimizer_launches': 2.0,
            'train.optimizer_idle_pct': 20.0, 'train.backward_idle_pct': 10.0,
            'train.upload_host_ms': 35.0, 'eval.idle_in_program_pct': 10.0}


def ctx(host=HOST, device=DEVICE, items=2):
    return harness.Context(None, {}, 0.0, harness.Trace(1.0, items, list(device), list(host)))


def read(metric, context):
    return harness.load_module(B / 'metrics' / f'{metric}.py').read(context)


@pytest.mark.parametrize('metric', sorted(EXPECTED))
def test_reader_gives_the_exact_answer(metric):
    assert read(metric, ctx()) == pytest.approx(EXPECTED[metric], abs=1e-9)


@pytest.mark.parametrize('metric', sorted(EXPECTED))
def test_reader_is_none_without_its_span(metric):
    assert read(metric, ctx(host=[h for h in HOST if h[1] != 'user_annotation'])) is None
    assert read(metric, harness.Context(None, {}, 0.0, None)) is None


def test_launches_are_none_in_a_trace_without_the_device():
    cpu_only = [h for h in HOST if h[1] != 'cuda_runtime']
    assert read('train.optimizer_launches', ctx(host=cpu_only, device=[])) is None


def test_nested_and_overlapping_spans_count_once():
    assert spans.spans(ctx().trace, 'step.backward') == [[0.7, 0.95]]
    doubled = HOST + [h for h in HOST if h[0] == 'step.optimizer' and h[1] == 'user_annotation']
    c = ctx(host=doubled)
    assert spans.idle_pct(c, 'step.optimizer') == pytest.approx(20.0)
    assert spans.host_ms(c, 'step.optimizer') == pytest.approx(175.0)
    assert spans.launches(c, 'step.optimizer') == pytest.approx(2.0)


def test_parts_of_the_idle_share_stay_within_it():
    c = ctx()
    whole = bounds.idle_pct(c)
    assert whole == pytest.approx(30.0)
    assert (read('train.optimizer_idle_pct', c) + read('train.backward_idle_pct', c)
            <= whole + 1e-9)
    assert read('eval.idle_in_program_pct', c) <= whole


def test_union_and_overlap_by_hand():
    assert spans.union([(0.5, 0.7), (-1.0, 0.1), (0.6, 0.9), (0.95, 2.0), (0.3, 0.3)],
                       1.0) == [[0.0, 0.1], [0.5, 0.9], [0.95, 1.0]]
    assert spans.overlap_s([[0.0, 0.1], [0.5, 0.9]], [[0.05, 0.6], [0.8, 1.0]]) == \
        pytest.approx(0.05 + 0.1 + 0.1)
