"""BENCHMARK.json and the files it names hold together, and a cell of an
existing traffic kind is found from data files alone."""

import json
import re

import pytest

from perfbench import harness

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
BENCH = harness.load_json(harness.ROOT / 'BENCHMARK.json')
B = harness.ROOT / 'perfbench'


def test_top_level_keys():
    assert set(BENCH) == {'command', 'paths', 'run_seconds', 'configs', 'workloads',
                          'end_to_end', 'per_layer'}
    assert BENCH['paths'] == ['perfbench'] and BENCH['command'][1] == 'perfbench/run.py'
    assert 1 <= BENCH['run_seconds'] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize('cell', [w['name'] for w in BENCH['workloads']])
def test_each_cell_names_what_exists(cell):
    w = next(w for w in BENCH['workloads'] if w['name'] == cell)
    assert NAME.match(cell) and NAME.match(w['traffic']) and w['chips'] in (1, 4)
    assert 0 < len(w['why']) <= 200
    c = next(c for c in BENCH['configs'] if c['name'] == w['config'])
    config = harness.load_json(harness.ROOT / c['file'])
    assert config['name'] == c['name'] and config['reduced'] == c['reduced']
    mix = harness.load_json(B / 'traffic' / f"{w['traffic']}.json")
    assert (B / 'runners' / f"{mix['runner']}.py").is_file()
    runner = harness.load_module(B / 'runners' / f"{mix['runner']}.py")
    assert all(callable(getattr(runner, f)) for f in ('setup', 'window', 'check', 'control'))
    limits = harness.load_json(B / 'limits' / f'{cell}.json')
    assert limits and all(v > 0 for v in limits.values())
    e2e = harness.cell_metrics(BENCH, cell, False)
    layers = harness.cell_metrics(BENCH, cell, True)
    assert 'setup_s' in {m['name'] for m in e2e} and len(e2e) >= 2 and layers


@pytest.mark.parametrize('metric', BENCH['end_to_end'] + BENCH['per_layer'],
                         ids=lambda m: m['name'])
def test_each_metric_has_a_reader(metric):
    assert NAME.match(metric['name']) and UNIT.match(metric['unit'])
    assert metric['better'] in ('lower', 'higher')
    assert callable(harness.load_module(B / 'metrics' / f"{metric['name']}.py").read)
    cells = {w['name'] for w in BENCH['workloads']}
    assert set(metric.get('workloads', [])) <= cells
    if 'moves' in metric:
        moved = next(m for m in BENCH['end_to_end'] if m['name'] == metric['moves'])
        assert set(metric['workloads']) <= set(moved.get('workloads', cells))
        assert metric['source'] in ('device_trace', 'program_span', 'program_counter',
                                    'host_clock')
    else:
        assert metric['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= metric['bound'] <= 0.25


def test_a_cell_added_as_data_is_found(tiny_root):
    cell, bench = harness.load_cell('tiny_stage2', tiny_root)
    assert cell.config['model']['backbone'] == 'resnet18' and cell.mix['crop'] == 64
    assert cell.runner().__name__ == 'perfbench_stage_step'
    names = {m['name'] for m in harness.cell_metrics(bench, 'tiny_stage2', True)}
    assert {'train_mfu', 'train.idle_pct', 'segment_hist_roofline'} <= names
    assert {m['name'] for m in harness.cell_metrics(bench, 'tiny_eval', False)} == {
        'eval_tiles_per_s', 'eval_p95_ms', 'setup_s'}
