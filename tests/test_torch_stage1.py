"""One stage-1 step and one prototype-accumulation pass of the port against
the JAX package's from the same weights, on the CPU: resnet18, 64 px, C = 6,
batch 2 per domain, f32, head dropout off on both sides (Flax's bits and
torch's differ), with align_domain off and on, class balance on, and the
OHEM source loss.

Tolerances, float32 on both sides (tests/test_torch_step.py gives the
reasons at length; the stage-1 step is the stage-2 step without its
pseudo-label branch):
  * losses rtol 1e-4: train-mode forwards agree to ~1e-4 absolute;
  * parameters after the SGD update atol 1e-5, the PPM scale-1 BN
    parameters (`ppm_0_bn`) atol 1e-4;
  * batch_stats rtol 1e-4, atol 1e-5; the class-balance EMA rtol 1e-6;
  * prototype sums rtol 1e-4 (atol 1e-4: a sum of up to 32 features that
    agree to ~2e-5 each can cancel to near zero), pixel counts exact, and
    every BN running statistic of the port's model unchanged by the pass;
  * `ohem_cross_entropy_loss` rtol 1e-5: one log-softmax and a mean.
"""

import numpy as np
import pytest
import torch

import flax.linen as nn
import jax
import jax.numpy as jnp

from regda_tpu.models.deeplabv2 import build_deeplabv2 as jax_build
from regda_tpu.ops.losses import ohem_cross_entropy_loss as jax_ohem
from regda_tpu.train import create_train_state as jax_state
from regda_tpu.train import make_optimizer as jax_optimizer
from regda_tpu.train.steps import make_proto_accum_step, make_stage1_step as jax_stage1
from regda_tpu.utils.torch_convert import torch_state_dict_to_variables
from regda_tpu_torch.entry import synthetic_stage2_batch
from regda_tpu_torch.models import build_deeplabv2
from regda_tpu_torch.models.heads import Dropout2d
from regda_tpu_torch.ops.losses import ohem_cross_entropy_loss
from regda_tpu_torch.train import create_train_state, make_optimizer
from regda_tpu_torch.train.steps import make_stage1_step, proto_accum_step
from regda_tpu_torch.utils.convert import from_jax_variables

C, HW, B, FEAT = 6, 64, 2, 512
LR, STOP = 1e-2, 10      # stop_steps 10: no warmup, lr(0) = 1e-2
FLAGS = {'plain': dict(align_domain=False), 'align': dict(align_domain=True),
         'bcs': dict(align_domain=False, bcs=True),
         'ohem': dict(align_domain=True, ls='OhemCrossEntropy')}


def _no_dropout(next_fun, args, kwargs, context):
    if isinstance(context.module, nn.Dropout) and context.method_name == '__call__':
        return args[0]
    return next_fun(*args, **kwargs)


@pytest.fixture(scope='module')
def start():
    jmodel = jax_build('resnet18', num_classes=C)
    variables = jax.tree.map(np.array, jmodel.init(
        {'params': jax.random.PRNGKey(0)}, jnp.zeros((1, HW, HW, 3)), train=False))
    batch = synthetic_stage2_batch(np.random.default_rng(0), B, HW, C)[:3]
    return jmodel, variables, batch


def _port_model(variables):
    model = build_deeplabv2('resnet18', num_classes=C)
    model.load_state_dict(from_jax_variables(variables))
    for m in model.modules():
        if isinstance(m, Dropout2d):
            m.p = 0.0
    return model


@pytest.fixture(scope='module', params=sorted(FLAGS))
def stepped(request, start):
    jmodel, variables, batch = start
    flags = FLAGS[request.param]
    tx = jax_optimizer(LR, stop_steps=STOP)
    state = jax_state(jmodel, tx, jax.random.PRNGKey(0), num_classes=C,
                      feat_dim=FEAT, variables=variables)
    with nn.intercept_methods(_no_dropout):
        jnew, jmetrics = jax.jit(jax_stage1(jmodel, tx, num_classes=C, **flags))(
            state, *(jnp.asarray(a) for a in batch))

    tmodel = _port_model(variables)
    tstate = create_train_state(tmodel, make_optimizer(tmodel, LR, STOP), torch.Generator())
    tmetrics = make_stage1_step(num_classes=C, **flags)(
        tstate, *(torch.from_numpy(a) for a in batch))
    tvars = torch_state_dict_to_variables(
        {k: v.detach().numpy() for k, v in tmodel.state_dict().items()})
    return jnew, jmetrics, tstate, tmetrics, tvars


@pytest.mark.parametrize('name', ['total', 'loss_seg', 'loss_domain'])
def test_stage1_loss_terms_match_jax(stepped, name):
    _, jmetrics, _, tmetrics, _ = stepped
    np.testing.assert_allclose(float(tmetrics[name]), float(jmetrics[name]), rtol=1e-4)


def test_stage1_counters_and_class_balance_match_jax(stepped):
    jnew, _, tstate, _, _ = stepped
    assert tstate.step == int(jnew.step) == 1
    assert tstate.optimizer.count == 1
    np.testing.assert_allclose(tstate.class_freq_s.freq.numpy(),
                               np.asarray(jnew.class_freq_s.freq), rtol=1e-6)
    assert tuple(tstate.prototypes.shape) == (C, FEAT) and not tstate.prototypes.any()


def test_stage1_params_match_jax(stepped):
    jnew, _, _, _, tvars = stepped

    def check(path, got, want):
        noisy = any(getattr(k, 'key', None) == 'ppm_0_bn' for k in path)
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-4 if noisy else 1e-5,
                                   err_msg=jax.tree_util.keystr(path))

    jax.tree_util.tree_map_with_path(check, tvars['params'], jnew.params)


def test_stage1_batch_stats_match_jax(stepped):
    jnew, _, _, _, tvars = stepped
    jax.tree.map(lambda g, w: np.testing.assert_allclose(
        g, np.asarray(w), rtol=1e-4, atol=1e-5), tvars['batch_stats'], jnew.batch_stats)


@pytest.fixture(scope='module')
def accumulated(start):
    jmodel, variables, (images, labels, _) = start
    labels = labels.copy()
    labels[0, :32, :32] = -1          # an ignored block
    accum = jax.jit(make_proto_accum_step(jmodel), static_argnums=(5, 6))
    with nn.intercept_methods(_no_dropout):
        jsum, jcnt = accum(variables, jnp.zeros((C, FEAT)), jnp.zeros((C, 1)),
                           jnp.asarray(images), jnp.asarray(labels), C, -1)
    tmodel = _port_model(variables)
    before = {k: v.clone() for k, v in tmodel.state_dict().items()}
    tsum, tcnt = proto_accum_step(tmodel, torch.zeros(C, FEAT), torch.zeros(C, 1),
                                  torch.from_numpy(images), torch.from_numpy(labels), C, -1)
    return (np.asarray(jsum), np.asarray(jcnt)), (tsum.numpy(), tcnt.numpy()), before, tmodel


def test_proto_accum_counts_equal_jax(accumulated):
    (_, jcnt), (_, tcnt), _, _ = accumulated
    np.testing.assert_array_equal(tcnt, jcnt)
    assert tcnt.sum() == B * (HW // 16) ** 2 - 4    # the ignored block's 4 cells


def test_proto_accum_sums_match_jax(accumulated):
    (jsum, _), (tsum, _), _, _ = accumulated
    assert np.abs(jsum).max() > 1.0
    np.testing.assert_allclose(tsum, jsum, rtol=1e-4, atol=1e-4)


def test_proto_accum_leaves_bn_statistics_unchanged(accumulated):
    *_, before, tmodel = accumulated
    after = tmodel.state_dict()
    assert after.keys() == before.keys()
    for k, v in before.items():
        assert torch.equal(after[k], v), k
    assert tmodel.training     # the reference's pass runs in train mode


@pytest.mark.parametrize('case', ['hard_set', 'top_n_min', 'weighted', 'all_ignored'])
def test_ohem_cross_entropy_matches_jax(case):
    """hard_set: more than n_valid // 5 losses above -log(0.7), which are
    kept; top_n_min: confident logits leave fewer, so the n_min largest are
    kept instead."""
    rng = np.random.default_rng(3)
    logits = (2.0 * rng.normal(size=(2, 8, 8, C))).astype(np.float32)
    labels = rng.integers(-1, C, size=(2, 8, 8)).astype(np.int32)
    if case == 'top_n_min':
        sure = (labels >= 0) & (rng.random(labels.shape) < 0.9)
        onehot = np.eye(C, dtype=np.float32)[np.maximum(labels, 0)]
        logits += 12.0 * onehot * sure[..., None]
    nll = -np.take_along_axis(np.log(np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)),
                              np.maximum(labels, 0)[..., None], -1)[..., 0]
    n_hard, n_min = int(((labels >= 0) & (nll > -np.log(0.7))).sum()), int((labels >= 0).sum()) // 5
    assert (n_hard < n_min) == (case == 'top_n_min') or case == 'all_ignored'
    if case == 'all_ignored':
        labels[:] = -1
    weight = rng.random(2 * 8 * 8).astype(np.float32) if case == 'weighted' else None
    got = ohem_cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                                  pixel_weight=None if weight is None else torch.from_numpy(weight))
    want = jax_ohem(jnp.asarray(logits), jnp.asarray(labels),
                    pixel_weight=None if weight is None else jnp.asarray(weight))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
