"""Whole runs of the tiny cells on the CPU (the harness's look for a card
skipped): the result line's keys, the references agreeing with the port,
and `correct` false under each fault a cell can have."""

import json
import time

import pytest
import torch

from perfbench import faults, harness


def run(root, cell, trace=False, seconds=1.0, seed=2 ** 31 + 5):
    c, bench = harness.load_cell(cell, root)
    return harness.run_cell(c, bench, seed, seconds, trace, torch.device('cpu'), time.time())


@pytest.mark.parametrize('cell', ['tiny_stage2', 'tiny_eval'])
def test_sound_run_is_correct_and_well_formed(tiny_root, cell, capsys):
    result = run(tiny_root, cell, trace=True)
    assert list(result)[:5] == ['correct', 'attempted', 'failed', 'metrics', 'device']
    assert list(result)[-1] == 'checks'
    assert result['correct'], result['checks']
    assert result['attempted'] > 0 and result['failed'] == 0
    dev = result['device']
    assert {'platform', 'kind', 'count', 'memory_peak_bytes', 'busy_s', 'window_s'} <= set(dev)
    assert all(len(v) <= 10 for v in result['breakdown'].values())
    assert all(set(c) == {'value', 'limit'} for c in result['checks'].values())
    harness.print_result(result)
    out, err = capsys.readouterr()
    assert json.loads(out.strip().splitlines()[-1]) == json.loads(json.dumps(result))
    assert err.strip().splitlines()[-1].startswith('check ')


def test_untraced_run_reports_end_to_end_metrics(tiny_root):
    result = run(tiny_root, 'tiny_eval')
    assert set(result['metrics']) == {'eval_tiles_per_s', 'eval_p95_ms', 'setup_s'}
    assert 'busy_s' not in result['device'] and 'breakdown' not in result


@pytest.mark.parametrize('cell,fault', [('tiny_stage2', 'unchanged'),
                                        ('tiny_stage2', 'half_batch'),
                                        ('tiny_eval', 'altered')])
def test_a_fault_is_caught(tiny_root, cell, fault):
    with faults.FAULTS[fault]():
        result = run(tiny_root, cell, seconds=0.5)
    assert not result['correct'], result['checks']
