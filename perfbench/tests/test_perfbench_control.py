"""The control of each cell comes out as not correct: the plain reference
in TF32, the precision below the configuration's float32 with TF32 off,
put in the program's place, fails at least one of the cell's limits. On
the card only (TF32 exists there alone), at the cell's configuration with
fewer and smaller crops; `control.py` reads it at the cell's own size."""

import pytest

from perfbench import harness

SMALL = {'r101_stage2_step': {'batch': 2, 'crop': 256},
         'r101_eval_tta': {'tile': 256, 'pool': 2}}


@pytest.mark.cuda
@pytest.mark.parametrize('cell', sorted(SMALL))
@pytest.mark.parametrize('seed', [11, 2 ** 31 + 12])
def test_control_fails_a_limit(cuda_device, cell, seed):
    c, _ = harness.load_cell(cell)
    c.mix = dict(c.mix, **SMALL[cell])
    c.config = dict(c.config, eval=dict(c.config['eval'], tile=256, stride=128))
    numbers = c.runner().control(c, seed, cuda_device)
    assert any(v > c.limits[k] for k, v in numbers.items()), numbers
