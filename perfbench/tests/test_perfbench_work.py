"""The operation and byte counts of perfbench/work against hand counts and
against torch's own FLOP counter on the plain reference."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench.reference import deeplabv2 as ref
from perfbench.work import bounds, deeplabv2 as work

MODEL = {'backbone': 'resnet18', 'num_classes': 6, 'fc_dim': 512, 'ppm_scales': [1, 2, 3, 6],
         'ppm_dim': 512, 'head_dropout': 0.1}


def test_conv_flops_by_hand():
    # a 3x3 conv of 2 -> 4 channels on 5 x 5 outputs: 2 * 2 * 4 * 9 * 25
    assert work.conv_flops(2, 4, 3, 5, 5) == 3600


def test_segment_hist_bytes_by_hand():
    # 2 images of 16 pixels: labels and regions 2 * 16 * 4 bytes each, a
    # histogram of 2 * 3 * 4 float32
    assert bounds.segment_hist_bytes(2, 16, 3, 4) == 2 * 2 * 16 * 4 + 2 * 3 * 4 * 4
    assert bounds.segment_hist_bound_s(8, 512 ** 2, 1024, 6) == pytest.approx(
        (16 * 512 ** 2 * 4 + 8 * 1024 * 6 * 4) / 3.35e12)


@pytest.mark.parametrize('backbone', ['resnet18', 'resnet101'])
def test_forward_flops_match_torch_counter(backbone):
    model = dict(MODEL, backbone=backbone, fc_dim=512 if backbone == 'resnet18' else 2048)
    net = ref.build(model).eval()
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        net(torch.zeros(1, 3, 64, 96))
    assert work.forward_flops(model, 64, 96) == counter.get_total_flops()


def test_encoder_backward_flops_match_torch_counter():
    net = ref.build(MODEL).train()
    enc, stem = work.encoder_flops('resnet18', 64, 64)
    with FlopCounterMode(display=False) as counter:
        net.encoder.resnet(torch.zeros(2, 3, 64, 64)).sum().backward()
    # forward, the weights' gradients, the inputs' gradients but the image's
    assert 2 * (3 * enc - stem) == counter.get_total_flops()


def test_stage2_step_flops_composition():
    enc, stem = work.encoder_flops('resnet18', 64, 64)
    heads = 2 * work.head_flops(MODEL, 64, 64)
    rows = 2 * 4 * 4
    coral = 2 * 2 * 2 * rows * 512 * 512
    assert work.stage2_step_flops(MODEL, 2, 64, 64) == 2 * (6 * enc + 4 * heads - 2 * stem) + coral
    assert work.eval_tile_flops(MODEL, 64) == 8 * work.forward_flops(MODEL, 64, 64)
