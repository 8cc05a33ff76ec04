"""The segmenter's last two settings in the port, `remat` and
`output_stride`, held against themselves and against the JAX package on
the CPU, and the stage CLIs reading `REMAT` from their config.

  * `remat=True` checkpoints every residual block: the port with and
    without it gives the same loss, parameter gradients and BN running
    statistics (rtol 1e-6; the recompute runs the same float32 ops), the
    blocks run their forward a second time in the backward, and the
    running statistics move once a step, not again in the recompute.
  * The port with `remat=True` against the JAX model with `remat=True` on
    tests/test_model.py:112's inputs (resnet18, 2x32^2, the same loss),
    dropout off on both sides (its bits differ by framework): loss and BN
    running statistics rtol 1e-5 (atol 1e-5). The parameter gradients of
    the two frameworks do not agree elementwise at this size in train mode:
    the PPM scale-1 branch normalizes float32 rounding noise
    (tests/test_torch_model.py), and even without instance norm the JAX
    float32 gradients sit 1.5 % of each tensor's largest value from a
    float64 run of the port, the port's float32 ones 0.14 %. So the
    gradients are held by what remat must not do: the gap between the
    port's and JAX's gradients with remat equals the gap without it,
    within 1e-6 of each tensor's largest value.
  * The gradients held directly: without instance norm and at batch 8
    (8x32^2), where no branch normalizes rounding noise, the port's remat
    gradients equal JAX's remat gradients at rtol 1e-5 with an atol of
    5e-5 of each tensor's largest value (measured: at most 2.4e-5 of it;
    float32 convolutions and BN backwards sum in another order in each
    framework, so an elementwise rtol alone cannot hold for the elements
    near zero).
  * The eval forward at output stride 8, 16 and 32 against JAX (resnet18,
    64 px, rtol/atol 1e-4); 12 raises; `folded_model` keeps the stride.
  * `tools/remat_memory.py` refuses to run without a card.
  * `train_src`, `train_align_reg` and `train_ssl_reg` on
    `st.regda.tiny_smoke_remat` (REMAT = True) build a checkpointed model
    and give the losses of the same runs on `st.regda.tiny_smoke`.
"""

import os
import shutil
from unittest import mock

import numpy as np
import pytest
import torch

import flax.linen as nn
import jax
import jax.numpy as jnp

from regda_tpu.models.deeplabv2 import build_deeplabv2 as jax_build
from regda_tpu_torch.models import build_deeplabv2
from regda_tpu_torch.models.fold_bn import folded_model
from regda_tpu_torch.models.heads import Dropout2d
from regda_tpu_torch.models.resnet import BasicBlock, stage_plan
from regda_tpu_torch.tools import (init_prototypes, remat_memory, train_align_reg, train_src,
                                   train_ssl_reg)
from regda_tpu_torch.train.loop import Trainer
from regda_tpu_torch.utils.convert import from_jax_variables

C = 6
TORCH_THREADS = 2


@pytest.fixture(scope='module', autouse=True)
def _few_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(TORCH_THREADS)
    yield
    torch.set_num_threads(threads)


def _no_dropout(next_fun, args, kwargs, context):
    if isinstance(context.module, nn.Dropout) and context.method_name == '__call__':
        return args[0]
    return next_fun(*args, **kwargs)


def _inputs():
    """tests/test_model.py:112's inputs."""
    x = np.random.RandomState(0).randn(2, 32, 32, 3).astype(np.float32)
    labels = np.random.RandomState(1).randint(0, 6, (2, 2, 2))
    return x, labels


def _counted_blocks(calls: list):
    """Appends to `calls` at every residual block forward."""
    forward = BasicBlock.forward

    def counted(self, x):
        calls.append(1)
        return forward(self, x)
    return mock.patch.object(BasicBlock, 'forward', counted)


def _port_model(remat: bool, variables=None, seed: int = 0, **kw):
    model = build_deeplabv2('resnet18', C, remat=remat,
                            generator=torch.Generator().manual_seed(seed), **kw)
    if variables is not None:
        model.load_state_dict(from_jax_variables(variables))
    for m in model.modules():
        if isinstance(m, Dropout2d):
            m.p = 0.0
    return model.train()


def _port_loss_grads(model, x, labels):
    p1, p2, _ = model(torch.from_numpy(x))
    logits = (p1 + p2).reshape(-1, C)
    onehot = torch.nn.functional.one_hot(torch.from_numpy(labels).reshape(-1).long(), C)
    loss = -(onehot * torch.log_softmax(logits, -1)).sum()
    model.zero_grad()
    loss.backward()
    grads = {k: p.grad.detach().clone() for k, p in model.named_parameters()}
    stats = {k: v.clone() for k, v in model.state_dict().items() if 'running' in k}
    return float(loss.detach()), grads, stats


def test_remat_matches_no_remat_and_recomputes_blocks():
    x, labels = _inputs()
    plain = _port_model(False, seed=3)
    ckpt = _port_model(True, seed=3)
    ckpt.load_state_dict(plain.state_dict())
    assert ckpt.remat and ckpt.encoder.resnet.remat and not plain.remat
    before = {k: v.clone() for k, v in ckpt.state_dict().items() if 'running' in k}

    calls = []
    with _counted_blocks(calls):
        loss_c, grads_c, stats_c = _port_loss_grads(ckpt, x, labels)
    loss_p, grads_p, stats_p = _port_loss_grads(plain, x, labels)

    # 8 blocks, each run in the forward and again in the backward's recompute
    assert len(calls) == 16
    np.testing.assert_allclose(loss_c, loss_p, rtol=1e-6)
    assert grads_c.keys() == grads_p.keys()
    for k in grads_p:
        np.testing.assert_allclose(grads_c[k].numpy(), grads_p[k].numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    moved = 0
    for k in stats_p:
        # once a forward: equal to the plain model's single update
        np.testing.assert_allclose(stats_c[k].numpy(), stats_p[k].numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
        moved += not torch.equal(stats_c[k], before[k])
    assert moved == len(stats_p)


def test_remat_not_applied_in_eval_or_without_grad():
    model = _port_model(True, seed=4)
    x = torch.randn(1, 32, 32, 3, generator=torch.Generator().manual_seed(5))
    calls = []
    with mock.patch('regda_tpu_torch.models.resnet.checkpoint') as ckpt, \
            _counted_blocks(calls):
        with torch.no_grad():
            model.train()(x)
        model.eval()(x)
        folded_model(model)(x)
    assert not ckpt.called
    assert len(calls) == 24    # three forwards of 8 blocks, none checkpointed


def _jax_loss_grads(remat: bool, x, labels, **kw):
    jmodel = jax_build('resnet18', num_classes=C, remat=remat, **kw)
    variables = jax.tree.map(np.asarray, jmodel.init(
        {'params': jax.random.PRNGKey(0)}, jnp.asarray(x), train=False))

    def loss_fn(params):
        with nn.intercept_methods(_no_dropout):
            (p1, p2, _), upd = jmodel.apply(
                {'params': params, 'batch_stats': variables['batch_stats']},
                jnp.asarray(x), train=True, mutable=['batch_stats'])
        logits = (p1 + p2).reshape(-1, C)
        onehot = jax.nn.one_hot(jnp.asarray(labels).reshape(-1), C)
        return -(onehot * jax.nn.log_softmax(logits)).sum(), upd

    (loss, upd), grads = jax.value_and_grad(loss_fn, has_aux=True)(variables['params'])
    grads = from_jax_variables({'params': jax.tree.map(np.asarray, grads)})
    stats = from_jax_variables({'batch_stats': jax.tree.map(np.asarray, upd['batch_stats'])})
    return variables, float(loss), grads, stats


def test_remat_matches_jax_remat():
    x, labels = _inputs()
    runs = {}
    for remat in (True, False):
        variables, jloss, jgrads, jstats = _jax_loss_grads(remat, x, labels)
        runs[remat] = (jloss, jgrads, jstats, *_port_loss_grads(
            _port_model(remat, variables), x, labels))
    jloss, jgrads, jstats, loss, grads, stats = runs[True]
    _, jgrads_plain, _, _, grads_plain, _ = runs[False]

    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    assert stats.keys() == jstats.keys()
    for k in jstats:
        np.testing.assert_allclose(stats[k].numpy(), jstats[k].numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    # remat leaves the gradients' gap between the frameworks as it is
    assert grads.keys() == jgrads.keys()
    for k in jgrads:
        scale = float(jgrads_plain[k].abs().max())
        np.testing.assert_allclose((grads[k] - jgrads[k]).numpy(),
                                   (grads_plain[k] - jgrads_plain[k]).numpy(),
                                   rtol=0, atol=1e-6 * scale + 1e-8, err_msg=k)


def test_remat_grads_match_jax_remat_at_batch_8():
    x = np.random.RandomState(0).randn(8, 32, 32, 3).astype(np.float32)
    labels = np.random.RandomState(1).randint(0, 6, (8, 2, 2))
    variables, jloss, jgrads, jstats = _jax_loss_grads(True, x, labels, is_ins_norm=False)
    model = _port_model(True, variables, is_ins_norm=False)
    assert model.remat
    loss, grads, stats = _port_loss_grads(model, x, labels)

    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    assert stats.keys() == jstats.keys()
    for k in jstats:
        np.testing.assert_allclose(stats[k].numpy(), jstats[k].numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    assert grads.keys() == jgrads.keys()
    for k in jgrads:
        scale = float(jgrads[k].abs().max())
        np.testing.assert_allclose(grads[k].numpy(), jgrads[k].numpy(),
                                   rtol=1e-5, atol=5e-5 * scale, err_msg=k)


@pytest.mark.parametrize('output_stride', [8, 16, 32])
def test_eval_forward_output_stride_matches_jax(output_stride):
    size = 64
    jmodel = jax_build('resnet18', num_classes=C, output_stride=output_stride)
    variables = jax.tree.map(np.asarray, jmodel.init(
        {'params': jax.random.PRNGKey(1)}, jnp.zeros((1, size, size, 3)), train=False))
    rng = np.random.default_rng(output_stride)
    variables['batch_stats'] = jax.tree.map(
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32), variables['batch_stats'])
    x = rng.normal(size=(2, size, size, 3)).astype(np.float32)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x), train=False))

    model = build_deeplabv2('resnet18', C, output_stride=output_stride)
    model.load_state_dict(from_jax_variables(variables))
    model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
        feat = model.features(torch.from_numpy(x))
        folded = folded_model(model)
        got_folded = folded(torch.from_numpy(x)).numpy()
    assert feat.shape[-2:] == (size // output_stride, size // output_stride)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert folded.output_stride == output_stride
    np.testing.assert_allclose(got_folded, want, rtol=1e-4, atol=1e-4)


def test_remat_memory_tool_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    with pytest.raises(RuntimeError, match='CUDA'):
        remat_memory.main([])


def test_stage_plan_is_the_jax_plan():
    from regda_tpu.models.resnet import _stage_plan
    for os_ in (8, 16, 32):
        assert [tuple(p) for p in _stage_plan(os_)] == list(stage_plan(os_))


@pytest.mark.parametrize('output_stride', [4, 12, 64])
def test_other_output_stride_raises(output_stride):
    with pytest.raises(ValueError, match='output_stride'):
        build_deeplabv2('resnet18', C, output_stride=output_stride)


# ---------------------------------------------------------------------------
# the stage CLIs read REMAT
# ---------------------------------------------------------------------------

def _run_chain(root, cfg):
    """train_src -> init_prototypes -> train_align_reg -> train_ssl_reg on
    `cfg`, two steps a stage; -> ({stage: [losses a step]}, {stage: remat})."""
    losses, remat = {}, {}
    stage = {'name': None}

    def run_step(self, i_iter=-1, **arrays):
        metrics = orig(self, i_iter, **arrays)
        losses.setdefault(stage['name'], []).append(
            {k: float(v) for k, v in metrics.items()})
        remat[stage['name']] = self.model.remat
        return metrics

    orig = Trainer.run_step
    src, align = root / 'log' / 'src', root / 'log' / 'align'
    common = ['--config-path', cfg, '--device', 'cpu']
    with mock.patch.object(Trainer, 'run_step', run_step):
        stage['name'] = 'train_src'
        train_src.main([*common, '--align-domain', '1'])
        init_prototypes.main([*common, '--ckpt-model', str(src / 'Vaihingen_best.pth'),
                              '--ckpt-proto', str(src / 'prototypes_best')])
        stage['name'] = 'train_align_reg'
        train_align_reg.main([*common, '--ckpt-model', str(src / 'Vaihingen_best.pth'),
                              '--ckpt-proto', str(src / 'prototypes_best.npy'),
                              '--align-domain', '1', '--refine-label', '1', '--sam-refine',
                              '--percent', '0.5'])
        stage['name'] = 'train_ssl_reg'
        train_ssl_reg.main([*common, '--ckpt-model', str(align / 'Vaihingen_best.pth'),
                            '--ckpt-proto', str(align / 'prototypes_best.npy'), '--gen', '1',
                            '--refine-label', '1', '--sam-refine', '--percent', '0.5',
                            '--lt', 'uvem'])
    return losses, remat


def test_stage_clis_read_remat(tmp_path):
    # one synthetic tree for both runs; each run starts from an empty log
    root = tmp_path / 'smoke'
    runs = {}
    saved = {k: os.environ.get(k) for k in ('REGDA_SMOKE_ROOT', 'REGDA_SMOKE_STEPS')}
    os.environ.update(REGDA_SMOKE_ROOT=str(root), REGDA_SMOKE_STEPS='2')
    try:
        for cfg in ('st.regda.tiny_smoke', 'st.regda.tiny_smoke_remat'):
            runs[cfg] = _run_chain(root, cfg)
            shutil.rmtree(root / 'log')
    finally:
        shutil.rmtree(root, ignore_errors=True)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    (plain, plain_remat), (ckpt, ckpt_remat) = runs.values()
    stages = ('train_src', 'train_align_reg', 'train_ssl_reg')
    assert plain_remat == dict.fromkeys(stages, False)
    assert ckpt_remat == dict.fromkeys(stages, True)
    for name in stages:
        assert len(plain[name]) == len(ckpt[name]) == 2, name
        for got, want in zip(ckpt[name], plain[name]):
            assert got.keys() == want.keys()
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6,
                                           err_msg=f'{name} {k}')
