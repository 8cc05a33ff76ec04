"""The port's data-parallel stage steps on two gloo ranks on the CPU
(tests/torch_parallel_child.py), held to the one-process port step on the
same global batch, to each other, and once to the JAX step.

The rule (regda_tpu_torch/parallel/mesh.py, as tests/sharded_stages_child.py
holds the JAX mesh): a step on N ranks over a global batch equals the
one-process step on that batch, up to the order of float reductions.
The cases (resnet18, 32 px, 4 rows a domain unless named, two steps each,
head dropout on, drawn from the global batch's mask): stage 1 with CORAL and
the source class balance (`bcs`); stage 2 with LRH and `bcs`, and with one
row a rank (so each rank's PPM scale-1 BN holds one value a channel and
normalizes by the global two); stage 3 with UVEM and both class balances,
GHM, and OHEM (its k-th loss over the gathered losses). They run the
segmenter without instance norm, and `stage2_in` repeats stage 2 with it,
the default.

Tolerances, float32:
  * losses rtol 1e-5: each is a sum over the ranks in place of one sum;
  * prototypes, class-frequency EMAs and GHM bins after the two steps
    rtol 1e-5, atol 1e-6;
  * BN running statistics rtol 1e-4, atol 1e-5 (tests/test_torch_step.py's
    batch_stats): the second step's forward reads parameters that the
    first update moved within the parameter tolerance below;
  * parameters rtol 1e-5, atol 5e-5: the second update moves each by lr
    (1e-2) times its gradient, and the gradient that reaches the first
    convolution sums every layer's through BNs over two to sixteen values a
    channel at this size, whose backward divides by their batch deviation
    (measured: 3.7e-5 apart at most, at `encoder.resnet.conv1.weight` with
    one row a rank; a gradient N times too large moves them by ~1e-3);
  * with instance norm (`stage2_in`), losses rtol 2e-5 and parameters
    atol 1e-4: the PPM scale-1 branch pools an exactly
    zero-mean map, so its BN normalizes rounding noise (ROADMAP queue 3
    item 6), which another order of reduction redraws. Forward, that moves
    the x30 classifier's losses by up to 1.04e-5 of themselves; backward, the branch's BN scales the noise
    by 1 / sqrt(eps) into the gradients, and the scale-1 BN bias comes out
    up to 5e-5 apart (tests/test_torch_step.py's `ppm_0_bn`);
  * the momentum buffers, the sum of the gradients: their joint L2 norm
    rtol 1e-4 (measured: 2.4e-5 at most). The stage-1 and stage-3 cases
    without instance norm update unclipped, so that a gradient N times too
    large shows; the others clip at norm 32, as the recipe does, since
    their gradient norms reach 1e4 (the x30 classifier). Elementwise the
    buffers part by up to 12 % of a tensor's largest value, through the BNs
    over few values a channel;
  * the ranks' states (parameters, buffers, momentum, prototypes, EMAs,
    GHM bins) bit for bit (SHA-256 of every tensor);
  * the two-rank stage-2 step (one row a rank, instance norm on) against
    the JAX step at tests/test_torch_step.py's tolerances: losses rtol
    1e-4, parameters atol 1e-5 (`ppm_0_bn` 1e-4), BN statistics and
    prototypes rtol 1e-4 / atol 1e-5, the class balance rtol 1e-6.
"""

import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

import flax.linen as nn
import jax
import jax.numpy as jnp

from regda_tpu.models.deeplabv2 import build_deeplabv2 as jax_build
from regda_tpu.train import create_train_state as jax_state
from regda_tpu.train import make_optimizer as jax_optimizer
from regda_tpu.train.steps import make_stage2_step as jax_stage2
from regda_tpu.utils.torch_convert import torch_state_dict_to_variables
from regda_tpu_torch import parallel
from regda_tpu_torch.entry import synthetic_stage2_batch
from regda_tpu_torch.parallel.mesh import SPATIAL_TODO
from regda_tpu_torch.utils.convert import from_jax_variables
from tests.torch_parallel_child import ATOL, CASES, JAX_CASE, RTOL, STATS_ATOL, STATS_RTOL

ROOT = Path(__file__).resolve().parents[1]
C = 6


def _no_dropout(next_fun, args, kwargs, context):
    if isinstance(context.module, nn.Dropout) and context.method_name == '__call__':
        return args[0]
    return next_fun(*args, **kwargs)


def start_child(which: str, out: str) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS='2')
    return subprocess.Popen([sys.executable, str(ROOT / 'tests' / 'torch_parallel_child.py'),
                             which, out], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def finish_child(proc: subprocess.Popen, out: str) -> list:
    try:
        stdout, stderr = proc.communicate(timeout=900)
    finally:
        proc.kill()
    assert proc.returncode == 0, stdout[-3000:] + stderr[-6000:]
    return [torch.load(os.path.join(out, f'rank{r}.pt'), weights_only=False) for r in (0, 1)]


def run_child(which: str, out: str) -> list:
    return finish_child(start_child(which, out), out)


@pytest.fixture(scope='module')
def ranks():
    torch.set_num_threads(2)
    out = tempfile.mkdtemp(prefix='regda_parallel_')
    try:
        jmodel = jax_build('resnet18', num_classes=C)
        hw = JAX_CASE['size']
        variables = jax.tree.map(np.array, jmodel.init(
            {'params': jax.random.PRNGKey(0)}, jnp.zeros((1, hw, hw, 3)), train=False))
        for head in ('layer5', 'layer6'):
            variables['params'][head]['conv_last_out']['kernel'] *= 30.0
        rng = np.random.default_rng(0)
        protos = rng.normal(size=(C, 512)).astype(np.float32)
        batch = synthetic_stage2_batch(rng, JAX_CASE['batch'], hw, C)
        torch.save({'state_dict': from_jax_variables(variables),
                    'prototypes': torch.from_numpy(protos)}, os.path.join(out, 'jax_init.pt'))
        child = start_child('steps', out)      # the JAX step compiles meanwhile

        tx = jax_optimizer(JAX_CASE['lr'], stop_steps=JAX_CASE['stop'])
        state = jax_state(jmodel, tx, jax.random.PRNGKey(0), num_classes=C,
                          feat_dim=512, variables=variables)
        state = state.replace(prototypes=jnp.asarray(protos))
        with nn.intercept_methods(_no_dropout):
            jnew, jmetrics = jax.jit(jax_stage2(jmodel, tx, num_classes=C))(
                state, *(jnp.asarray(a) for a in batch))
        results = finish_child(child, out)
        yield results, (jnew, jmetrics, variables)
    finally:
        shutil.rmtree(out, ignore_errors=True)


def _in(case: str) -> bool:
    return CASES[case][4]


def _vs_one(ranks, case: str) -> dict:
    """The one-process comparison of `case`, from whichever rank ran it."""
    (r0, r1), _ = ranks
    return {**r0['vs_one'], **r1['vs_one']}[case]


@pytest.mark.parametrize('case', list(CASES))
def test_losses_equal_the_one_process_step(ranks, case):
    (r0, r1), _ = ranks
    want = _vs_one(ranks, case)['metrics']
    for got in (r0['metrics'][case], r1['metrics'][case]):
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=2e-5 if _in(case) else 1e-5,
                                           err_msg=f'{case} {k}')


@pytest.mark.parametrize('case', list(CASES))
def test_state_equals_the_one_process_step(ranks, case):
    errs = _vs_one(ranks, case)['tensors']
    assert {'prototypes', 'class_freq_s', 'class_freq_t', 'ghm'} <= errs.keys()
    dp_norm, one_norm = _vs_one(ranks, case)['momentum_norm']
    assert one_norm > 0
    np.testing.assert_allclose(dp_norm, one_norm, rtol=1e-4, err_msg=case)
    for name, (abs_err, ratio, stats_ratio, _) in errs.items():
        if name.endswith(('running_mean', 'running_var')):
            assert stats_ratio <= 1.0, (case, name, abs_err, f'rtol {STATS_RTOL} atol {STATS_ATOL}')
        elif name.startswith('model.'):
            assert ratio <= 1.0 or abs_err <= (1e-4 if _in(case) else 5e-5), (case, name, abs_err)
        else:
            assert ratio <= 1.0, (case, name, abs_err, f'rtol {RTOL} atol {ATOL}')


@pytest.mark.parametrize('case', list(CASES) + ['jax'])
def test_replicated_state_is_bit_identical_on_the_ranks(ranks, case):
    (r0, r1), _ = ranks
    d0, d1 = r0['digests'][case], r1['digests'][case]
    assert d0.keys() == d1.keys() and len(d0) > 100
    assert [k for k in d0 if d0[k] != d1[k]] == []


def test_the_steps_reach_their_losses(ranks):
    (r0, _), _ = ranks
    m = r0['metrics']
    for case, key in (('stage3_ghm', 'loss_target'), ('stage3_uvem', 'loss_target'),
                      ('stage3_ohem', 'loss_target'), ('stage2', 'loss_align'),
                      ('stage1', 'loss_domain')):
        assert all(step[key] > 0 for step in m[case]), (case, key)


def test_two_rank_stage2_step_matches_jax(ranks):
    (r0, _), (jnew, jmetrics, before) = ranks
    for name in ('total', 'loss_seg', 'loss_align', 'loss_domain'):
        np.testing.assert_allclose(r0['metrics']['jax'][0][name], float(jmetrics[name]),
                                   rtol=1e-4, err_msg=name)
    np.testing.assert_allclose(r0['jax_prototypes'].numpy(), np.asarray(jnew.prototypes),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(r0['jax_class_freq_s'].numpy(),
                               np.asarray(jnew.class_freq_s.freq), rtol=1e-6)
    tvars = torch_state_dict_to_variables(
        {k: v.numpy() for k, v in r0['jax_state'].items()})
    moved = jax.tree.leaves(jax.tree.map(
        lambda a, b: float(np.abs(np.asarray(a) - b).max()), jnew.params, before['params']))
    assert max(moved) > 1e-4

    def check(path, got, want):
        noisy = any(getattr(k, 'key', None) == 'ppm_0_bn' for k in path)
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-4 if noisy else 1e-5,
                                   err_msg=jax.tree_util.keystr(path))

    jax.tree_util.tree_map_with_path(check, tvars['params'], jnew.params)
    jax.tree.map(lambda g, w: np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4,
                                                         atol=1e-5),
                 tvars['batch_stats'], jnew.batch_stats)


# ------------------------------------------------------- without a process
def test_a_world_size_that_does_not_divide_the_batch_is_refused():
    group = parallel.DataGroup(rank=1, size=3, device=torch.device('cpu'))
    assert parallel.rows(group, 6) == slice(2, 4)
    with pytest.raises(ValueError, match='does not divide the global batch of 4'):
        parallel.shard_batch(group, np.zeros((4, 2)))


def test_the_spatial_axis_raises_and_names_its_roadmap_item():
    assert 'ROADMAP.md queue 1 item 4' in SPATIAL_TODO
    with pytest.raises(NotImplementedError, match='spatial'):
        parallel.data_group(0, 1, 'cpu', n_spatial=2)
    with pytest.raises(NotImplementedError, match='spatial'):
        parallel.data_group_from_env('cpu', n_spatial=2)


def test_without_torchrun_there_is_no_group(monkeypatch):
    monkeypatch.delenv('WORLD_SIZE', raising=False)
    assert parallel.data_group_from_env('cpu') is None


def test_a_rank_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip('this machine has a card')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        parallel.data_group(0, 1, 'cuda')
