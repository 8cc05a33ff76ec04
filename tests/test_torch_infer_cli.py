"""The port's single-image CLI (`python -m regda_tpu_torch.tools.infer_single`)
end to end on the CPU, against the JAX package's `tools/infer_single.py` on
the same `.pth`, and its checkpoint load's key check.

Both CLIs run as subprocesses on `st.regda.tiny_smoke` (its synthetic tree
in a temporary directory) with a seeded resnet18 checkpoint and a seeded
96 x 96 PNG, sliding window on, TTA off. Their `prediction.png` must be
equal except at pixels whose two largest probabilities (the port's, float32)
lie within 1e-4 of each other, where float32 rounding may pick either.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from regda_tpu_torch.datasets import get_meta
from regda_tpu_torch.entry import seed_bn_statistics
from regda_tpu_torch.infer import SegInferencer
from regda_tpu_torch.models import build_deeplabv2
from regda_tpu_torch.tools.infer_single import load_checkpoint

ROOT = Path(__file__).resolve().parents[1]
NEAR_TIE = 1e-4


@pytest.fixture(scope='module')
def case(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('infer_cli')
    generator = torch.Generator().manual_seed(3)
    model = build_deeplabv2('resnet18', 6, generator=generator)
    seed_bn_statistics(model, generator)
    ckpt = tmp / 'ckpt.pth'
    torch.save(model.state_dict(), ckpt)
    rng = np.random.default_rng(4)
    (tmp / 'img_dir').mkdir()
    (tmp / 'ann_dir').mkdir()
    image = tmp / 'img_dir' / 'tile.png'
    Image.fromarray(rng.integers(0, 256, (96, 96, 3), dtype=np.uint8)).save(image)
    Image.fromarray(rng.integers(0, 6, (96, 96), dtype=np.uint8)).save(tmp / 'ann_dir' / 'tile.png')
    env = {k: v for k, v in os.environ.items() if k != 'XLA_FLAGS'}
    env.update(PYTHONPATH=str(ROOT), REGDA_SMOKE_ROOT=str(tmp / 'smoke'),
               JAX_PLATFORMS='cpu', REGDA_NO_COMPILE_CACHE='1')
    return tmp, model, ckpt, image, env


def _run(args, env):
    res = subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout + res.stderr


def test_cli_prediction_equals_the_jax_cli(case, monkeypatch):
    tmp, model, ckpt, image, env = case
    port_dir, jax_dir = tmp / 'port', tmp / 'jax'
    common = ['st.regda.tiny_smoke', str(ckpt), str(image), '--tta', '0']
    _run(['-m', 'regda_tpu_torch.tools.infer_single', *common, '--device', 'cpu',
          '--save-dir', str(port_dir), '--gt', '1'], env)
    _run(['tools/infer_single.py', *common, '--save-dir', str(jax_dir)], env)

    got = np.asarray(Image.open(port_dir / 'prediction.png'))
    want = np.asarray(Image.open(jax_dir / 'prediction.png'))
    assert got.shape == want.shape == (96, 96) and got.dtype == np.uint8

    # the port's probabilities on the same input, to find the near-ties
    monkeypatch.setenv('REGDA_SMOKE_ROOT', env['REGDA_SMOKE_ROOT'])
    from regda_tpu_torch.utils.tools import import_config
    cfg = import_config('st.regda.tiny_smoke', copy=False, create=False)
    img = np.asarray(Image.open(image)).astype(np.float32)
    batch = cfg.TEST_DATA_CONFIG['transforms']({'image': img}, np.random.default_rng(0))['image'][None]
    probs = SegInferencer(model, 6).predict_probs(batch, slide=True, tta=False)[0]
    top2 = np.sort(probs, axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > NEAR_TIE
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(got[clear], want[clear])
    np.testing.assert_array_equal(got, probs.argmax(-1))

    color = Image.open(port_dir / 'prediction_color.png')
    assert color.mode == 'P'
    assert color.getpalette()[:18] == get_meta('IsprsDA').palette
    np.testing.assert_array_equal(np.asarray(color), got)
    assert (port_dir / 'gt.png').exists()


def test_checkpoint_load_raises_on_a_renamed_or_missing_key(case, tmp_path):
    _, model, ckpt, _, _ = case
    state = torch.load(ckpt, weights_only=True)
    key = 'layer5.conv_last.0.weight'
    renamed = {('layer5.conv_last.0.kernel' if k == key else k): v for k, v in state.items()}
    missing = {k: v for k, v in state.items() if k != 'encoder.resnet.bn1.running_var'}
    for name, bad, named in (('renamed', renamed, 'layer5.conv_last.0.kernel'),
                             ('missing', missing, 'encoder.resnet.bn1.running_var')):
        path = tmp_path / f'{name}.pth'
        torch.save(bad, path)
        with pytest.raises(KeyError, match=named.replace('.', r'\.')):
            load_checkpoint(build_deeplabv2('resnet18', 6), str(path))
    # what a reference checkpoint may carry beyond the model: BN step counts
    extra = dict(state, **{'encoder.resnet.bn1.num_batches_tracked': torch.tensor(5)})
    torch.save(extra, tmp_path / 'extra.pth')
    target = build_deeplabv2('resnet18', 6)
    load_checkpoint(target, str(tmp_path / 'extra.pth'))
    assert all(torch.equal(v, state[k]) for k, v in target.state_dict().items())


def test_checkpoint_load_refuses_a_directory(tmp_path):
    with pytest.raises(ValueError, match='directory'):
        load_checkpoint(build_deeplabv2('resnet18', 6), str(tmp_path))
