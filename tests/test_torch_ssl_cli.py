"""The port's stage-3 CLI, its pseudo-label generator and its parity tool
on the CPU, held against the JAX package.

The chain (`train_src` -> `init_prototypes` -> `train_ssl_reg --lt ghm`,
LRH and refine on) runs in this process through `main(argv)` with `--device
cpu` on `st.regda.tiny_smoke` (a temporary REGDA_SMOKE_ROOT,
REGDA_SMOKE_STEPS=2); stage 3 starts from stage 1's checkpoint, which costs
a stage-2 run less and is a checkpoint like any other. Against the JAX
package:
  * the JAX `load_pytree` of stage 3's `_best.pth` gives the port's eval
    probabilities within 1e-4 absolute, and `evaluate`'s mIoU equals the
    JAX `utils/eval.py:evaluate`'s on it, to the table's 5 decimals (as
    tests/test_torch_train_cli.py holds stages 1 and 2);
  * `gener_target_pseudo` from the same weights over the same DALoader
    batches (slide 48 / 16 + TTA on the 64^2 tiles) writes the same file
    names, probabilities within 1e-5 absolute, and palette PNGs whose labels
    are equal except at pixels with a probability within 1e-5 of its
    class's threshold (counted); the JAX loader reads the port's `.npy`
    files into the port's batches.
The GHM histogram survives `_state.pth` exactly, and `--auto-resume`
continues the stage; `run_parity --steps 2` and its `--mechanism` write
their table and JSON to a temporary directory and leave PARITY.md as it is;
without a card the parity tool refuses to start.
"""

import hashlib
import json
import os
import shutil
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from regda_tpu.datasets import DALoader as JaxLoader
from regda_tpu.infer import SegInferencer as JaxInferencer
from regda_tpu.models import build_deeplabv2 as jax_build
from regda_tpu.pseudo import gener_target_pseudo as jax_gener
from regda_tpu.utils.checkpoint import load_pytree
from regda_tpu.utils.eval import evaluate as jax_evaluate
from regda_tpu.utils.tools import import_config as jax_import_config
from regda_tpu_torch.datasets import DALoader
from regda_tpu_torch.infer import SegInferencer
from regda_tpu_torch.models import build_deeplabv2
from regda_tpu_torch.pseudo import gener_target_pseudo
from regda_tpu_torch.tools import eval as eval_cli
from regda_tpu_torch.tools import init_prototypes, run_parity, train_src, train_ssl_reg
from regda_tpu_torch.train import create_train_state, make_optimizer
from regda_tpu_torch.train.loop import Trainer
from regda_tpu_torch.train.steps import make_stage3_step
from regda_tpu_torch.utils.checkpoint import load_checkpoint
from regda_tpu_torch.utils.tools import get_console_file_logger, import_config

ROOT = Path(__file__).resolve().parents[1]
CFG = 'st.regda.tiny_smoke'
C = 6


TORCH_THREADS = 2


@pytest.fixture(scope='module', autouse=True)
def _few_torch_threads():
    """Two intra-op threads a process, here and in the parity tool's
    stage processes: in a parallel test run the default pool's spinning
    workers cost the other workers their cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(TORCH_THREADS)
    yield
    torch.set_num_threads(threads)


class _Probe:
    """Wraps the CLI's `gener_target_pseudo` and reads what it wrote before
    the CLI removes it."""

    def __init__(self):
        self.arrays = {}

    def __call__(self, cfg, inferencer, loader, path, **kw):
        gener_target_pseudo(cfg, inferencer, loader, path, **kw)
        self.arrays = {f: np.load(os.path.join(path, f)) for f in sorted(os.listdir(path))}


def _ssl_args(src, *extra):
    return ['--config-path', CFG, '--ckpt-model', str(src / 'Vaihingen_best.pth'),
            '--ckpt-proto', str(src / 'prototypes_best.npy'), '--gen', '1',
            '--refine-label', '1', '--sam-refine', '--percent', '0.5', '--lt', 'ghm',
            '--device', 'cpu', *extra]


@pytest.fixture(scope='module')
def chain(tmp_path_factory):
    root = tmp_path_factory.mktemp('ssl') / 'smoke'
    env = {'REGDA_SMOKE_ROOT': str(root), 'REGDA_SMOKE_STEPS': '2'}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    probe = _Probe()
    try:
        src, ssl = root / 'log' / 'src', root / 'log' / 'ssl'
        train_src.main(['--config-path', CFG, '--align-domain', '1', '--device', 'cpu'])
        init_prototypes.main(['--config-path', CFG, '--ckpt-model',
                              str(src / 'Vaihingen_best.pth'), '--ckpt-proto',
                              str(src / 'prototypes_best'), '--device', 'cpu'])
        orig = train_ssl_reg.gener_target_pseudo
        train_ssl_reg.gener_target_pseudo = probe
        try:
            run = train_ssl_reg.main(_ssl_args(src))
        finally:
            train_ssl_reg.gener_target_pseudo = orig
        yield types.SimpleNamespace(root=root, src=src, ssl=ssl, run=run, probe=probe, env=env)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(root, ignore_errors=True)     # ~0.5 GB of checkpoints


def _use_tree(chain, monkeypatch):
    for k, v in chain.env.items():
        monkeypatch.setenv(k, v)


def _jax_cfg(chain, snapshot_dir, monkeypatch):
    """The JAX package's own copy of the config, over the chain's tree."""
    _use_tree(chain, monkeypatch)
    sys.modules.pop(f'configs.{CFG}', None)
    cfg = jax_import_config(CFG, copy=False, create=False)
    cfg.SNAPSHOT_DIR = str(snapshot_dir)
    return cfg


def test_ssl_cli_writes_checkpoints_and_removes_pseudo_labels(chain):
    for name in ('Vaihingen_curr.pth', 'Vaihingen_best.pth', 'Vaihingen_state.pth',
                 'Vaihingen_state.pth.json'):
        assert (chain.ssl / name).is_file(), name
    assert not (chain.ssl / 'pseudo_label').exists()
    assert chain.run.pseudo_label == str(chain.ssl / 'pseudo_label')
    assert len(os.listdir(chain.ssl / 'pseudo_label_color')) == 4
    assert sorted(chain.probe.arrays) == [f't{i}.png.npy' for i in range(4)]
    for a in chain.probe.arrays.values():
        assert a.shape == (64, 64, C) and a.dtype == np.float32
        np.testing.assert_allclose(a.sum(-1), 1.0, atol=1e-5)
    trainer = chain.run.trainer
    assert trainer.state.step == 2 and len(trainer.eval_seconds) == 2   # at 0 and at the end
    assert trainer.state.ghm.acc_sum.sum() > 0
    assert chain.run.target.dataset.label_type == 'prob'


def test_jax_reads_the_ssl_checkpoint_with_the_same_eval_forward(chain):
    ckpt = chain.ssl / 'Vaihingen_best.pth'
    image = np.random.default_rng(0).normal(size=(2, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jax_build('resnet18', C).apply(load_pytree(str(ckpt)),
                                                     jnp.asarray(image), train=False))
    model = build_deeplabv2('resnet18', C)
    load_checkpoint(model, str(ckpt))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(image)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_ssl_eval_miou_equals_jax(chain, tmp_path, monkeypatch):
    ckpt = chain.ssl / 'Vaihingen_best.pth'
    _use_tree(chain, monkeypatch)
    _, got = eval_cli.main(['--config-path', CFG, '--ckpt-path', str(ckpt), '--test', '1',
                            '--device', 'cpu'])
    cfg = _jax_cfg(chain, tmp_path / 'jax', monkeypatch)
    _, want = jax_evaluate(jax_build('resnet18', C), None, cfg, is_training=False,
                           ckpt_path=str(ckpt), test=True)
    assert got == want and 0.0 <= got <= 1.0


def test_resume_restores_the_ghm_histogram_exactly(chain, monkeypatch):
    _use_tree(chain, monkeypatch)
    cfg = import_config(CFG, create=False, copy=False, postfix='/ssl')
    model = build_deeplabv2('resnet18', C, generator=torch.Generator().manual_seed(7))
    fresh = create_train_state(model, make_optimizer(model, 1e-2, 10), torch.Generator())
    trainer = Trainer(model, cfg, get_console_file_logger('resume', logdir=str(chain.ssl)),
                      fresh, make_stage3_step(lt='ghm', num_classes=C))
    assert not trainer.state.ghm.acc_sum.any()
    assert trainer.try_resume() == 2
    want = chain.run.trainer.state
    assert torch.equal(trainer.state.ghm.acc_sum, want.ghm.acc_sum)
    assert torch.equal(trainer.state.class_freq_t.freq, want.class_freq_t.freq)
    assert torch.equal(trainer.state.prototypes, want.prototypes)


def test_auto_resume_continues_stage3(chain, tmp_path, monkeypatch):
    """`--auto-resume 1 --gen 0` on a copy of the chain's tree, its
    pseudo-labels put back where the first run wrote them, restores stage 3
    at its step 2 and, with the run lengthened to 3 steps, takes one more."""
    root = tmp_path / 'smoke'
    shutil.copytree(chain.root, root)
    pseudo = root / 'log' / 'ssl' / 'pseudo_label'
    pseudo.mkdir()
    for name, a in chain.probe.arrays.items():
        np.save(pseudo / name, a)
    monkeypatch.setenv('REGDA_SMOKE_ROOT', str(root))
    monkeypatch.setenv('REGDA_SMOKE_STEPS', '3')
    argv = _ssl_args(root / 'log' / 'src', '--auto-resume', '1')
    argv[argv.index('--gen') + 1] = '0'
    run = train_ssl_reg.main(argv)
    assert len(run.trainer.step_seconds) == 1
    assert run.trainer.state.step == 3 and run.trainer.state.optimizer.count == 3
    assert not torch.equal(run.trainer.state.ghm.acc_sum, chain.run.trainer.state.ghm.acc_sum)
    assert not os.path.exists(run.pseudo_label)
    shutil.rmtree(root)


def test_gener_target_pseudo_matches_jax(chain, tmp_path, monkeypatch):
    ckpt = str(chain.src / 'Vaihingen_best.pth')
    _use_tree(chain, monkeypatch)
    cfg = import_config(CFG, create=False, copy=False)
    cfg.SNAPSHOT_DIR = str(tmp_path / 'port')
    jcfg = _jax_cfg(chain, tmp_path / 'jax', monkeypatch)
    model = build_deeplabv2('resnet18', C)
    load_checkpoint(model, ckpt)
    port_dir, jax_dir = tmp_path / 'port' / 'pseudo', tmp_path / 'jax' / 'pseudo'
    gener_target_pseudo(cfg, SegInferencer(model.eval(), C, tile=48, stride=16),
                        DALoader(cfg.PSEUDO_DATA_CONFIG, cfg.DATASETS), str(port_dir),
                        size=cfg.PSEUDO_SIZE)
    jax_gener(jcfg, JaxInferencer(jax_build('resnet18', C), load_pytree(ckpt), C, tile=48,
                                  stride=16),
              JaxLoader(jcfg.PSEUDO_DATA_CONFIG, jcfg.DATASETS), str(jax_dir),
              size=jcfg.PSEUDO_SIZE)

    names = sorted(os.listdir(port_dir))
    assert names == sorted(os.listdir(jax_dir)) == [f't{i}.png.npy' for i in range(4)]
    colors = sorted(os.listdir(f'{port_dir}_color'))
    assert colors == sorted(os.listdir(f'{jax_dir}_color')) == [f't{i}.png' for i in range(4)]
    near_total = 0
    for name, color in zip(names, colors):
        got, want = np.load(port_dir / name), np.load(jax_dir / name)
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        thr = np.maximum(got.reshape(-1, C).max(0) * cfg.CUTOFF_TOP, cfg.CUTOFF_LOW)
        near = (np.abs(got - thr) <= 1e-5).any(-1)
        lab_t = np.asarray(Image.open(f'{port_dir}_color/{color}'))
        lab_j = np.asarray(Image.open(f'{jax_dir}_color/{color}'))
        assert not ((lab_t != lab_j) & ~near).any(), name
        near_total += int(near.sum())
    assert near_total <= 4 * 64 * 64 // 100     # few pixels sit on a threshold

    # both loaders read the port's files into the same 'prob' batches
    port_target = dict(cfg.TARGET_DATA_CONFIG, mask_dir=[str(port_dir)])
    jax_target = dict(jcfg.TARGET_DATA_CONFIG, mask_dir=[str(port_dir)])
    for p, j in zip(DALoader(port_target, cfg.DATASETS), JaxLoader(jax_target, jcfg.DATASETS)):
        assert list(p['fname']) == list(j['fname'])
        for k in ('image', 'cls', 'sup'):
            np.testing.assert_array_equal(p[k], j[k], err_msg=k)
        assert p['cls'].shape[-1] == C


def _digest(path: Path) -> str:
    return hashlib.sha256(path.read_bytes()).hexdigest()


def test_run_parity_and_mechanism_write_their_tables(tmp_path, monkeypatch):
    kept = {p: _digest(ROOT / p) for p in ('PARITY.md', 'parity_results.json')}
    monkeypatch.setenv('REGDA_PARITY_ROOT', str(tmp_path / 'work'))
    monkeypatch.setenv('OMP_NUM_THREADS', str(TORCH_THREADS))
    out = tmp_path / 'out'
    results = run_parity.main(['--steps', '2', '--device', 'cpu', '--out', str(out)])
    assert sorted(results) == ['stage1_source_only', 'stage2_full', 'stage2_no_lrh',
                               'stage2_no_refine', 'stage3_ssl']
    assert all(0.0 <= miou <= 1.0 and it >= 1 for miou, it in results.values())
    table = (out / 'PARITY_torch.md').read_text()
    assert '| stage 3 (self-training from stage-2 full) |' in table and 'device: cpu' in table
    saved = json.loads((out / 'parity_results_torch.json').read_text())
    assert saved['steps_per_stage'] == 2 and saved['seconds']['train_ssl_reg'] > 0

    run_parity.main(['--mechanism', '--device', 'cpu', '--out', str(out)])
    body = (out / 'PARITY_torch.md').read_text()
    assert body.startswith(table.rstrip('\n'))
    assert '## LRH mechanism (pseudo-label quality vs ground truth)' in body
    assert (tmp_path / 'work' / 'lrh_mechanism.json').is_file()
    assert {p: _digest(ROOT / p) for p in kept} == kept
    shutil.rmtree(tmp_path / 'work')     # ~1.5 GB of checkpoints


def test_run_parity_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    env = dict(os.environ, PYTHONPATH=str(ROOT), REGDA_PARITY_ROOT=str(tmp_path / 'work'))
    res = subprocess.run([sys.executable, '-m', 'regda_tpu_torch.tools.run_parity',
                          '--steps', '2', '--out', str(tmp_path)], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert 'no CUDA device' in res.stderr, res.stderr[-2000:]
    assert not (tmp_path / 'work').exists()
