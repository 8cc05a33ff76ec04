"""The port stands alone: it imports no JAX, and `chip_smoke.py` refuses to
run without a CUDA device instead of falling back to the CPU."""

import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / 'regda_tpu_torch'

_FORWARD = r'''
import sys
import numpy as np
import torch
import regda_tpu_torch.entry, regda_tpu_torch.ops.lrh, regda_tpu_torch.utils.convert
import regda_tpu_torch.models.sam.convert, regda_tpu_torch.ops.kernels.layernorm
import regda_tpu_torch.ops.kernels.rel_attention, regda_tpu_torch.ops.kernels.stability
import regda_tpu_torch.ops.kernels.mask_stats, regda_tpu_torch.ops.kernels._band
import regda_tpu_torch.models.sam.auto, regda_tpu_torch.tools.seg_everything
import regda_tpu_torch.datasets, regda_tpu_torch.native, regda_tpu_torch.train.loop
import regda_tpu_torch.datasets.device_data
import regda_tpu_torch.utils.checkpoint, regda_tpu_torch.utils.eval
import regda_tpu_torch.utils.profiling, regda_tpu_torch.tools.train_src
import regda_tpu_torch.tools.init_prototypes, regda_tpu_torch.tools.train_align_reg
import regda_tpu_torch.tools.eval, regda_tpu_torch.pseudo, regda_tpu_torch.tools.train_ssl_reg
import regda_tpu_torch.tools.lrh_mechanism, regda_tpu_torch.tools.run_parity
import regda_tpu_torch.ops.slic, regda_tpu_torch.data_prep.tiling, regda_tpu_torch.analysis
import regda_tpu_torch.data_prep.superpixels, regda_tpu_torch.tools.check_sam_stability
import regda_tpu_torch.tools.convert_potsdam, regda_tpu_torch.tools.convert_potsdam_rgb
import regda_tpu_torch.tools.convert_vaihingen, regda_tpu_torch.tools.remat_memory
import regda_tpu_torch.utils.convert
from regda_tpu_torch.models import build_deeplabv2
from regda_tpu_torch.ops.lrh import homogenize
model = build_deeplabv2('resnet18', 6, generator=torch.Generator().manual_seed(0))
with torch.no_grad():
    probs = model.eval()(torch.randn(1, 32, 32, 3))
assert probs.shape == (1, 32, 32, 6)
remat = build_deeplabv2('resnet18', 6, output_stride=8, remat=True).train()
remat(torch.randn(2, 32, 32, 3))[0].sum().backward()
sup = regda_tpu_torch.data_prep.superpixels.superpixel_labels(
    np.zeros((32, 32, 3), np.uint8), torch.device('cpu'), iterations=2)
assert sup.shape == (32, 32)
labels = homogenize(torch.zeros(1, 32, 32, dtype=torch.int32),
                    torch.ones(1, 32, 32, dtype=torch.int32))
state, step = regda_tpu_torch.entry.stage3_state('cpu', resnet='resnet18', lt='ghm')
rng = np.random.default_rng(0)
images_s, label_s, images_t, regs = regda_tpu_torch.entry.synthetic_stage2_batch(rng, 2, 32)
soft = regda_tpu_torch.entry.synthetic_soft_labels(rng, 2, 32)
metrics = step(state, *(torch.from_numpy(a) for a in (images_s, label_s, images_t, soft, regs)))
assert state.step == 1 and state.ghm.acc_sum.sum() > 0
sam, (images, points, pt_labels) = regda_tpu_torch.entry.sam_entry(
    'cpu', vit_config='vit_t', img_size=64, crops=1, points=2)
with torch.no_grad():
    masks, iou = sam(images, points, pt_labels)
assert masks.shape == (2, 3, 16, 16) and iou.shape == (2, 3)
gen, tiles = regda_tpu_torch.entry.sam_regions_entry(
    'cpu', vit_config='vit_t', img_size=64, tiles=2, tile=48, dtype=torch.float32,
    points_per_side=2, points_per_batch=4, pred_iou_thresh=-1e9, stability_score_thresh=0.0)
maps = gen.generate_regions_batch(tiles, area_threshold=4)
assert len(maps) == 2 and maps[0].shape == (48, 48) and maps[0].dtype == np.int32
import tempfile
import regda_tpu_torch.parallel, regda_tpu_torch.parallel.mesh, regda_tpu_torch.ops.mix
import regda_tpu_torch.ops.whiten, regda_tpu_torch.ops.losses_extra, regda_tpu_torch.ops.align_losses
import regda_tpu_torch.utils.ema, regda_tpu_torch.models.transnorm
import regda_tpu_torch.models.discriminators, regda_tpu_torch.models.deeplab_mmd
import regda_tpu_torch.models.spixelnet
from regda_tpu_torch.train.steps import make_stage2_step
from regda_tpu_torch import parallel
with tempfile.TemporaryDirectory() as tmp:
    group = parallel.data_group(0, 1, 'cpu', init_method='file://' + tmp + '/rdv')
    state, _ = regda_tpu_torch.entry.stage2_state('cpu', resnet='resnet18')
    make_stage2_step(num_classes=6, group=group)(state, *(torch.from_numpy(a) for a in (
        images_s, label_s, images_t, regs)))
    parallel.assert_replicated({'prototypes': state.prototypes}, group)
    parallel.shutdown()
regda_tpu_torch.entry.dryrun_data_parallel(1, 'cpu')
feats = torch.tensor([[2, 1, 3, 0], [5, 6, 7, 8], [1, 2, 3, 4], [2, 3, 4, 5], [0, 1, 0, 1],
                      [5, 1, 3, 1]], dtype=torch.float32).reshape(1, 1, 6, 4)
assert float(regda_tpu_torch.ops.whiten.class_ware_whitening(
    feats, torch.tensor([1, 0, 0, 1, 0, 0]).reshape(1, 1, 6), [1, 2])) == 12.4375
g = torch.Generator().manual_seed(0)
mixed = regda_tpu_torch.ops.mix.cutmix(g, torch.rand(2, 8, 8, 3), torch.zeros(2, 8, 8),
                                       torch.rand(2, 8, 8, 3), torch.ones(2, 8, 8))
loss, _ = regda_tpu_torch.ops.losses_extra.gdp_loss(
    regda_tpu_torch.ops.losses_extra.GDPState.create(), torch.randn(1, 4, 4, 3),
    torch.zeros(1, 4, 4, dtype=torch.long))
A = regda_tpu_torch.ops.align_losses
assert torch.isfinite(A.class_align_loss(torch.randn(6, 8), torch.randn(6, 8)))
ema = regda_tpu_torch.utils.ema.ema_register(torch.nn.Linear(2, 2))
with torch.no_grad():
    regda_tpu_torch.models.transnorm.TransNorm(4).train()(torch.randn(4, 3, 3, 4))
    regda_tpu_torch.models.discriminators.FCDiscriminator(6, ndf=4)(torch.zeros(1, 32, 32, 6))
    regda_tpu_torch.models.deeplab_mmd.DeeplabV2MMD('resnet18', inchannels=512).eval()(
        torch.zeros(1, 32, 32, 3))
    assert len(regda_tpu_torch.models.spixelnet.SpixelNet().eval()(torch.zeros(1, 32, 32, 3))) == 8
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'regda_tpu'))
print('LOADED', bad)
assert not bad, bad
'''


def _env():
    env = {k: v for k, v in os.environ.items() if k not in ('XLA_FLAGS',)}
    env['PYTHONPATH'] = str(ROOT)
    return env


def test_region_entry_raises_without_a_card():
    import torch
    from regda_tpu_torch.entry import sam_regions_entry
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    with pytest.raises(RuntimeError, match='CUDA'):
        sam_regions_entry()


def test_port_imports_no_jax_at_runtime():
    res = subprocess.run([sys.executable, '-c', _FORWARD], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert 'LOADED []' in res.stdout


@pytest.mark.parametrize('path', sorted(str(p.relative_to(ROOT))
                                        for p in PORT.rglob('*.py')))
def test_port_source_has_no_jax_import(path):
    text = (ROOT / path).read_text()
    hits = re.findall(r'^\s*(?:import|from)\s+(jax|jaxlib|flax|optax|orbax|regda_tpu)\b',
                      text, flags=re.M)
    assert not hits, (path, hits)


@pytest.mark.parametrize('where', ['checkout', 'alone'])
def test_chip_smoke_fails_without_cuda(where, tmp_path):
    """No CUDA device here: the script exits non-zero at once, printing no
    result, from a checkout and from a directory holding only the script."""
    if where == 'alone':
        shutil.copy(ROOT / 'chip_smoke.py', tmp_path / 'chip_smoke.py')
        cwd, env = tmp_path, {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    else:
        cwd, env = ROOT, _env()
    res = subprocess.run([sys.executable, 'chip_smoke.py'], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    assert 'CUDA' in res.stderr
