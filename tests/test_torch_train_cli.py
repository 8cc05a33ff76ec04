"""The port's stage CLIs end to end on the CPU, and their checkpoints held
against the JAX package.

The four CLIs (`regda_tpu_torch.tools.{train_src,init_prototypes,
train_align_reg,eval}`) run in this process through `main(argv)` with
`--device cpu` on `st.regda.tiny_smoke` (its synthetic tree under a
temporary REGDA_SMOKE_ROOT, REGDA_SMOKE_STEPS=2), chained as the README
gives them. Against the JAX package, on the files the chain wrote:
  * the JAX `load_pytree` of the port's `_best.pth` gives the port's eval
    probabilities within 1e-4 absolute (f32 forwards of two frameworks);
  * `evaluate`'s mIoU equals the JAX `utils/eval.py:evaluate`'s on the same
    `.pth` and split (the port's best, and JAX-initialised variables carried
    over by `from_jax_variables`), to the metric table's 5 decimals;
  * init_prototypes' output equals the JAX accumulation over the JAX loader
    on the same checkpoint and tree (rtol 1e-4, atol 1e-4: sums of features
    that agree to ~2e-5 can cancel to near zero).
The Trainer's full state survives `save_state` -> a fresh `try_resume`
exactly, and one more step from both gives identical parameters; a failing
background save re-raises at `join_saver`; without a card, each CLI (stage
3's and the LRH-mechanism tool's too) refuses to run unless `--device cpu`
is given.
"""

import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from regda_tpu.datasets import DALoader as JaxLoader
from regda_tpu.models import build_deeplabv2 as jax_build
from regda_tpu.ops.prototypes import prototype_finalize as jax_finalize
from regda_tpu.train.steps import make_proto_accum_step
from regda_tpu.utils.checkpoint import load_pytree
from regda_tpu.utils.eval import evaluate as jax_evaluate
from regda_tpu.utils.tools import import_config as jax_import_config
from regda_tpu_torch.models import build_deeplabv2
from regda_tpu_torch.tools import eval as eval_cli
from regda_tpu_torch.tools import init_prototypes, train_align_reg, train_src
from regda_tpu_torch.train import create_train_state, make_optimizer
from regda_tpu_torch.train import loop as loop_module
from regda_tpu_torch.train.loop import Trainer
from regda_tpu_torch.train.steps import make_stage1_step
from regda_tpu_torch.utils.checkpoint import load_checkpoint
from regda_tpu_torch.utils.convert import from_jax_variables
from regda_tpu_torch.utils.tools import get_console_file_logger, import_config

ROOT = Path(__file__).resolve().parents[1]
CFG = 'st.regda.tiny_smoke'
C = 6


@pytest.fixture(scope='module')
def chain(tmp_path_factory):
    root = tmp_path_factory.mktemp('chain') / 'smoke'
    env = {'REGDA_SMOKE_ROOT': str(root), 'REGDA_SMOKE_STEPS': '2'}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        src, align = root / 'log' / 'src', root / 'log' / 'align'
        stage1 = train_src.main(['--config-path', CFG, '--align-domain', '1',
                                 '--device', 'cpu'])
        protos, counts = init_prototypes.main([
            '--config-path', CFG, '--ckpt-model', str(src / 'Vaihingen_best.pth'),
            '--ckpt-proto', str(src / 'prototypes_best'), '--device', 'cpu'])
        stage2 = train_align_reg.main([
            '--config-path', CFG, '--ckpt-model', str(src / 'Vaihingen_best.pth'),
            '--ckpt-proto', str(src / 'prototypes_best.npy'), '--align-domain', '1',
            '--refine-label', '1', '--sam-refine', '--percent', '0.5', '--device', 'cpu'])
        table, miou = eval_cli.main(['--config-path', CFG, '--ckpt-path',
                                     str(align / 'Vaihingen_best.pth'), '--test', '1',
                                     '--device', 'cpu'])
        yield types.SimpleNamespace(root=root, src=src, align=align, stage1=stage1,
                                    protos=protos, counts=counts, stage2=stage2,
                                    table=table, miou=miou, env=env)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


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


def test_chain_writes_its_checkpoints(chain):
    for stage_dir, run in ((chain.src, chain.stage1), (chain.align, chain.stage2)):
        for name in ('Vaihingen_curr.pth', 'Vaihingen_best.pth', 'Vaihingen_state.pth',
                     'Vaihingen_state.pth.json', 'prototypes_best.npy'):
            assert (stage_dir / name).is_file(), (stage_dir, name)
        assert (stage_dir / 'vis-Vaihingen_best').is_dir()
        assert run.trainer.state.step == 2
        assert run.trainer.eval_seconds and run.trainer.mIoU_max > 0
    assert len(chain.stage2.trainer.eval_seconds) == 2          # at step 0 and at the end
    assert chain.protos.shape == (C, 512) and np.isfinite(chain.protos).all()
    assert chain.counts.sum() > 0
    np.testing.assert_array_equal(np.load(chain.src / 'prototypes_best.npy'), chain.protos)
    final = np.load(chain.align / 'prototypes_best.npy')
    np.testing.assert_array_equal(final, chain.stage2.trainer.state.prototypes.numpy())
    assert 0.0 <= chain.miou <= 1.0


def test_best_checkpoint_loads_strictly(chain):
    model = build_deeplabv2('resnet18', C)
    load_checkpoint(model, str(chain.align / 'Vaihingen_best.pth'))
    state = torch.load(chain.align / 'Vaihingen_best.pth', weights_only=True)
    assert model.state_dict().keys() == state.keys()


def test_jax_reads_the_port_checkpoint_with_the_same_eval_forward(chain):
    ckpt = chain.align / 'Vaihingen_best.pth'
    image = np.random.default_rng(0).normal(size=(2, 64, 64, 3)).astype(np.float32)
    want = np.asarray(jax_build('resnet18', C).apply(load_pytree(str(ckpt)),
                                                     jnp.asarray(image), train=False))
    model = build_deeplabv2('resnet18', C)
    load_checkpoint(model, str(ckpt))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(image)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize('weights', ['port_best', 'jax_init'])
def test_eval_miou_equals_jax(chain, tmp_path, monkeypatch, weights):
    if weights == 'port_best':
        ckpt = chain.align / 'Vaihingen_best.pth'
    else:   # JAX variables carried to a .pth that the port's CLIs load
        variables = jax.tree.map(np.asarray, jax_build('resnet18', C).init(
            {'params': jax.random.PRNGKey(5)}, jnp.zeros((1, 64, 64, 3)), train=False))
        ckpt = tmp_path / 'port' / 'jax_init.pth'
        ckpt.parent.mkdir()
        torch.save(from_jax_variables(variables), ckpt)
    _use_tree(chain, monkeypatch)
    _, got = eval_cli.main(['--config-path', CFG, '--ckpt-path', str(ckpt), '--test', '1',
                            '--device', 'cpu'])
    cfg = _jax_cfg(chain, tmp_path / 'jax', monkeypatch)
    _, want = jax_evaluate(jax_build('resnet18', C), None, cfg, is_training=False,
                           ckpt_path=str(ckpt), test=True)
    assert got == want
    assert (ckpt.parent / f'vis-{ckpt.name}').is_dir()


def test_init_prototypes_equal_the_jax_accumulation(chain, tmp_path, monkeypatch):
    cfg = _jax_cfg(chain, tmp_path, monkeypatch)
    variables = load_pytree(str(chain.src / 'Vaihingen_best.pth'))
    accum = jax.jit(make_proto_accum_step(jax_build('resnet18', C)), static_argnums=(5, 6))
    data_sum, data_cnt = jnp.zeros((C, 512)), jnp.zeros((C, 1))
    for batch in JaxLoader(cfg.SOURCE_DATA_CONFIG, cfg.DATASETS):
        data_sum, data_cnt = accum(variables, data_sum, data_cnt, jnp.asarray(batch['image']),
                                   jnp.asarray(batch['cls'].astype(np.int32)), C, -1)
    np.testing.assert_array_equal(chain.counts, np.asarray(data_cnt))
    np.testing.assert_allclose(chain.protos, np.asarray(jax_finalize(data_sum, data_cnt)),
                               rtol=1e-4, atol=1e-4)


@pytest.fixture
def trainer_factory(chain, tmp_path, monkeypatch):
    _use_tree(chain, monkeypatch)
    cfg = import_config(CFG, create=True, copy=False, postfix='/resume')
    cfg.SNAPSHOT_DIR = str(tmp_path / 'resume')
    os.makedirs(cfg.SNAPSHOT_DIR)
    logger = get_console_file_logger('resume', logdir=cfg.SNAPSHOT_DIR)
    rng = np.random.default_rng(1)
    batch = dict(images_s=rng.normal(size=(2, 64, 64, 3)).astype(np.float32),
                 label_s=rng.integers(-1, C, size=(2, 64, 64)).astype(np.int32),
                 images_t=rng.normal(size=(2, 64, 64, 3)).astype(np.float32))

    def make(seed: int) -> Trainer:
        model = build_deeplabv2('resnet18', C, generator=torch.Generator().manual_seed(seed))
        state = create_train_state(model, make_optimizer(model, 1e-2, 10),
                                   torch.Generator().manual_seed(seed))
        return Trainer(model, cfg, logger, state,
                       make_stage1_step(align_domain=True, bcs=True, num_classes=C))

    return make, batch


def _flat_tensors(tree, prefix=''):
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat_tensors(v, f'{prefix}/{k}')
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat_tensors(v, f'{prefix}/{i}')


def test_save_state_then_resume_restores_everything(trainer_factory):
    make, batch = trainer_factory
    first = make(seed=0)
    for _ in range(2):
        first.run_step(**batch)
    first.mIoU_max, first.iter_max = 0.25, 2
    first.save_state()

    second = make(seed=1)
    assert second.try_resume() == 2
    assert (second.mIoU_max, second.iter_max) == (0.25, 2)
    assert second.state.optimizer.count == first.state.optimizer.count == 2
    want = dict(_flat_tensors(first.host_state()))
    got = dict(_flat_tensors(second.host_state()))
    assert got.keys() == want.keys() and len(got) > 100
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert torch.equal(second.state.generator.get_state(), first.state.generator.get_state())

    for t in (first, second):     # dropout on: the generators must agree too
        t.run_step(**batch)
    for (k, a), b in zip(first.model.state_dict().items(), second.model.state_dict().values()):
        assert torch.equal(a, b), k


def test_failing_background_save_reraises_at_join(trainer_factory, monkeypatch):
    make, batch = trainer_factory
    trainer = make(seed=0)
    trainer.run_step(**batch)

    def disk_full(path, obj):
        raise OSError('disk full')

    monkeypatch.setattr(loop_module, 'save_state_dict', disk_full)
    assert trainer._async_ckpt
    trainer.maybe_eval(0, stop_steps=1)
    with pytest.raises(RuntimeError, match='async checkpoint') as info:
        trainer.join_saver()
    assert isinstance(info.value.__cause__, OSError)
    trainer.join_saver()          # consumed: a second join is a no-op


def test_auto_resume_continues_a_stage(chain, tmp_path, monkeypatch):
    """`--auto-resume 1` on a copy of the chain's tree restores stage 1 at
    its step 2 and, with the run lengthened to 3 steps, takes one more."""
    import shutil
    root = tmp_path / 'smoke'
    shutil.copytree(chain.root, root)
    monkeypatch.setenv('REGDA_SMOKE_ROOT', str(root))
    monkeypatch.setenv('REGDA_SMOKE_STEPS', '3')
    run = train_src.main(['--config-path', CFG, '--align-domain', '1', '--auto-resume', '1',
                          '--device', 'cpu'])
    assert len(run.trainer.step_seconds) == 1
    assert run.trainer.state.step == 3 and run.trainer.state.optimizer.count == 3
    assert run.trainer.mIoU_max >= chain.stage1.trainer.mIoU_max


def test_import_config_twice_keeps_one_postfix(chain, monkeypatch):
    _use_tree(chain, monkeypatch)
    base = os.path.join(str(chain.root), 'log')
    src = import_config(CFG, create=False, copy=False, postfix='/src')
    assert src.SNAPSHOT_DIR == base + '/src'
    align = import_config(CFG, create=False, copy=False, postfix='/align')
    assert align.SNAPSHOT_DIR == base + '/align'
    assert import_config(CFG, create=False, copy=False).SNAPSHOT_DIR == base


_CLI_ARGS = {'train_src': [],
             'init_prototypes': ['--ckpt-model', 'x.pth', '--ckpt-proto', 'p'],
             'train_align_reg': ['--ckpt-model', 'x.pth', '--ckpt-proto', 'p.npy'],
             'train_ssl_reg': ['--ckpt-model', 'x.pth', '--ckpt-proto', 'p.npy'],
             'lrh_mechanism': ['--ckpt-model', 'x.pth', '--ckpt-proto', 'p.npy'],
             'eval': ['--ckpt-path', 'x.pth']}


def _run_cli(name, args, env):
    return subprocess.run([sys.executable, '-m', f'regda_tpu_torch.tools.{name}',
                           '--config-path', CFG, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize('name', sorted(_CLI_ARGS))
def test_cli_without_a_card_raises(chain, name):
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    env = dict(os.environ, PYTHONPATH=str(ROOT), **chain.env)
    res = _run_cli(name, _CLI_ARGS[name], env)
    assert res.returncode != 0
    assert 'no CUDA device' in res.stderr, res.stderr[-2000:]


def test_eval_cli_runs_as_a_module_on_the_cpu(chain):
    env = dict(os.environ, PYTHONPATH=str(ROOT), **chain.env)
    res = _run_cli('eval', ['--ckpt-path', str(chain.align / 'Vaihingen_best.pth'),
                            '--test', '1', '--device', 'cpu'], env)
    assert res.returncode == 0, res.stderr[-2000:]
    assert str(chain.miou) in res.stderr      # the table's mean row
