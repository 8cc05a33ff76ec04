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
import torch
import regda_tpu_torch.entry, regda_tpu_torch.ops.lrh, regda_tpu_torch.utils.convert
import regda_tpu_torch.models.sam.convert, regda_tpu_torch.ops.kernels.layernorm
import regda_tpu_torch.ops.kernels.rel_attention, regda_tpu_torch.ops.kernels.stability
import regda_tpu_torch.ops.kernels.mask_stats, regda_tpu_torch.ops.kernels._band
import regda_tpu_torch.models.sam.auto, regda_tpu_torch.tools.seg_everything
from regda_tpu_torch.models import build_deeplabv2
from regda_tpu_torch.ops.lrh import homogenize
model = build_deeplabv2('resnet18', 6, generator=torch.Generator().manual_seed(0))
with torch.no_grad():
    probs = model.eval()(torch.randn(1, 32, 32, 3))
assert probs.shape == (1, 32, 32, 6)
labels = homogenize(torch.zeros(1, 32, 32, dtype=torch.int32),
                    torch.ones(1, 32, 32, dtype=torch.int32))
sam, (images, points, pt_labels) = regda_tpu_torch.entry.sam_entry(
    'cpu', vit_config='vit_t', img_size=64, crops=1, points=2)
with torch.no_grad():
    masks, iou = sam(images, points, pt_labels)
assert masks.shape == (2, 3, 16, 16) and iou.shape == (2, 3)
import numpy as np
gen, tiles = regda_tpu_torch.entry.sam_regions_entry(
    'cpu', vit_config='vit_t', img_size=64, tiles=2, tile=48, dtype=torch.float32,
    points_per_side=2, points_per_batch=4, pred_iou_thresh=-1e9, stability_score_thresh=0.0)
maps = gen.generate_regions_batch(tiles, area_threshold=4)
assert len(maps) == 2 and maps[0].shape == (48, 48) and maps[0].dtype == np.int32
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
