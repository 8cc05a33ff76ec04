"""The benchmark's inputs are functions of the seed."""

import numpy as np
import pytest
import torch

from perfbench import inputs
from perfbench.reference import deeplabv2 as ref

BIG = 2 ** 31 + 987654321


@pytest.mark.parametrize('seed', [0, 7, BIG, 2 ** 40 + 3])
def test_stage2_pool_is_the_seeds(seed):
    a = inputs.stage2_pool(seed, 2, 2, 64, 6, 30)
    b = inputs.stage2_pool(seed, 2, 2, 64, 6, 30)
    for x, y in zip(a, b):
        for u, v in zip(x, y):
            np.testing.assert_array_equal(u, v)
    c = inputs.stage2_pool(seed + 1, 2, 2, 64, 6, 30)
    assert not np.array_equal(a[0][0], c[0][0])
    # distinct batches: every row differs
    assert not np.array_equal(a[0][0], a[1][0])
    regs = a[0][3]
    assert regs.min() >= 0 and regs.max() <= 30 and regs.dtype == np.int32


def test_eval_tiles_are_the_seeds():
    a = inputs.eval_tiles(BIG, 2, 32, (1, 2, 3), (4, 5, 6))
    b = inputs.eval_tiles(BIG, 2, 32, (1, 2, 3), (4, 5, 6))
    np.testing.assert_array_equal(a[1], b[1])
    assert a[0].shape == (1, 32, 32, 3) and a[0].dtype == np.float32
    assert not np.array_equal(a[0], inputs.eval_tiles(BIG + 1, 1, 32, (1, 2, 3), (4, 5, 6))[0])


def test_weights_are_the_seeds():
    model = {'backbone': 'resnet18', 'num_classes': 6, 'fc_dim': 512,
             'ppm_scales': [1, 2, 3, 6], 'ppm_dim': 512, 'head_dropout': 0.1}
    shapes = ref.shapes(model)
    a = inputs.seeded_weights(shapes, BIG, 'cpu')
    b = inputs.seeded_weights(shapes, BIG, 'cpu')
    c = inputs.seeded_weights(shapes, BIG + 1, 'cpu')
    assert set(a) == set(shapes)
    for k in a:
        assert tuple(a[k].shape) == shapes[k]
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    w = 'encoder.resnet.conv1.weight'
    assert not torch.equal(a[w], c[w])
    var = a['encoder.resnet.bn1.running_var']
    assert float(var.min()) >= 0.5 and float(var.max()) < 2.0
    assert float(a[w].std()) == pytest.approx(1 / (3 * 49) ** 0.5, rel=0.1)
