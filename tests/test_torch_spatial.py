"""The port's 'spatial' mesh axis on four gloo ranks on the CPU, a (2 data x
2 spatial) group (tests/torch_spatial_child.py), held to the one-process
port step and forward, to each other, and to the JAX package.

The rule (regda_tpu_torch/parallel/mesh.py, as tests/sharded_stages_child.py
holds the JAX mesh): a step on an (n_data x n_spatial) group over a global
batch equals the one-process step on that batch, up to the order of float
reductions. Each spatial rank holds half of every image's rows.

Cases and tolerances, float32:
  * `halo_exchange` (through the segmenter's `Conv2d` and `stem_pool`) and
    `gather_height`, forward and backward, against the unsharded op on the
    whole input, on the (2 x 2) group and on a (1 x 4) group, with blocks
    of 8 rows and of 2 (a halo deeper than a block: past the image's edge,
    and on four ranks across two blocks): forward bit for bit, backward
    within 1e-6 of the largest value (another order of the same adds);
  * LRH on this rank's rows: one histogram call a rank, the all-reduced
    histogram and the homogenized labels exactly the whole images';
  * the pseudo-label selection on this rank's rows exactly the whole
    images', on maps whose halves' class maxima differ (so that a rank's
    own maxima would select otherwise);
  * the stage-1 (CORAL, `bcs`), stage-2 (classifier x30, so that LRH moves
    labels; with instance norm; with remat) and stage-3 (UVEM with `bcs` and
    `bct`; GHM) steps, two each at 32 px, against the one-process port step
    at tests/test_torch_parallel.py's tolerances, the ranks' states bit for
    bit alike, one histogram call a stage-2 and stage-3 step. GHM bins each
    pixel's |p_y - 1| at the edges k / 30, a step function: where the
    one-process run has a pixel within 1e-5 of an inner edge, another order
    of reduction may move it to the next bin. Then (and only then) the GHM
    bins are held to their sum (rtol 1e-5) and to that many pixels' moves,
    and the GHM case's losses to rtol 1e-4: one such pixel moved the second
    step's target loss by 1.4e-5 of itself;
  * the eval forward at 128 px, output stride 16 and 8, on the JAX init's
    weights: against the one-process forward and against the JAX package's
    `model.apply` (rtol 2e-4, atol 2e-5, as tests/sharded_stages_child.py);
  * one stage-1 step at 128 px with plain SGD (clip 32, lr 1e-2) against
    the JAX package's unsharded step: loss rtol 1e-4, the update's norm
    rtol 1e-3, as tests/sharded_stages_child.py holds its mesh; the
    gradient's norm stays below the clip, so the update shows it;
  * `dryrun_data_parallel(4, 'cpu', n_spatial=2)`, the counterpart of
    `__graft_entry__.dryrun_multichip(4)`;
  * the refusals: a height that does not split, an n_data that does not
    divide the batch, a Trainer on the spatial axis.
"""

import os
import shutil
import subprocess
import sys
import tempfile
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import flax.linen as nn
import jax
import jax.numpy as jnp
import optax

from regda_tpu.models.deeplabv2 import build_deeplabv2 as jax_build
from regda_tpu.train import create_train_state as jax_state
from regda_tpu.train.steps import make_stage1_step as jax_stage1
from regda_tpu_torch import parallel
from regda_tpu_torch.entry import dryrun_data_parallel
from regda_tpu_torch.models import build_deeplabv2
from regda_tpu_torch.train.loop import Trainer
from regda_tpu_torch.utils.convert import from_jax_variables
from tests.torch_parallel_child import ATOL, RTOL, STATS_ATOL, STATS_RTOL
from tests.torch_spatial_child import CASES, EVAL, OPS, SGD, eval_inputs, sgd_inputs

ROOT = Path(__file__).resolve().parents[1]
C = 6
WORLD = 4


def _no_dropout(next_fun, args, kwargs, context):
    if isinstance(context.module, nn.Dropout) and context.method_name == '__call__':
        return args[0]
    return next_fun(*args, **kwargs)


def _jax_side(variables):
    """The JAX eval forwards at 128 px (output stride 16 and 8) and the
    unsharded stage-1 step with plain SGD at 128 px."""
    x = jnp.asarray(eval_inputs())
    probs = {}
    for stride in EVAL['strides']:
        model = jax_build('resnet18', num_classes=C, output_stride=stride)
        probs[stride] = np.asarray(jax.jit(lambda v, x: model.apply(v, x, train=False))(
            variables, x))
    model = jax_build('resnet18', num_classes=C)
    tx = optax.chain(optax.clip_by_global_norm(SGD['clip']), optax.sgd(SGD['lr']))
    state = jax_state(model, tx, jax.random.PRNGKey(0), num_classes=C, feat_dim=512,
                      variables=variables)
    images, labels = (jnp.asarray(a) for a in sgd_inputs())
    with nn.intercept_methods(_no_dropout):
        new, metrics = jax.jit(jax_stage1(model, tx, num_classes=C))(state, images, labels,
                                                                      images)
    moved = jax.tree.leaves(jax.tree.map(
        lambda a, b: jnp.sum((a - b).astype(jnp.float32) ** 2), new.params, state.params))
    return probs, float(metrics['total']), float(np.sqrt(sum(float(m) for m in moved)))


@pytest.fixture(scope='module')
def ranks():
    torch.set_num_threads(2)
    out = tempfile.mkdtemp(prefix='regda_spatial_')
    try:
        jmodel = jax_build('resnet18', num_classes=C)
        variables = jax.tree.map(np.array, jmodel.init(
            {'params': jax.random.PRNGKey(0)}, jnp.zeros((1, 32, 32, 3)), train=False))
        protos = np.random.default_rng(0).normal(size=(C, 512)).astype(np.float32)
        torch.save({'state_dict': from_jax_variables(variables),
                    'prototypes': torch.from_numpy(protos)}, os.path.join(out, 'jax_init.pt'))
        env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS='2')
        child = subprocess.Popen([sys.executable, str(ROOT / 'tests' / 'torch_spatial_child.py'),
                                  out], env=env, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
        try:
            jax_side = _jax_side(variables)      # compiles while the ranks run
            stdout, stderr = child.communicate(timeout=900)
        finally:
            child.kill()
        assert child.returncode == 0, stdout[-3000:] + stderr[-6000:]
        yield ([torch.load(os.path.join(out, f'rank{r}.pt'), weights_only=False)
                for r in range(WORLD)], jax_side)
    finally:
        shutil.rmtree(out, ignore_errors=True)


def test_the_group_is_make_meshs_data_by_spatial_grid(ranks):
    results, _ = ranks
    for r, res in enumerate(results):
        d, s = divmod(r, 2)
        assert res['coords'] == {'rank': r, 'data_rank': d, 'n_data': 2, 'spatial_rank': s,
                                 'n_spatial': 2, 'spatial_pg': [2 * d, 2 * d + 1],
                                 'data_pg': [s, 2 + s]}


@pytest.mark.parametrize('case', [f'{m}-{op}' for m in ('2x2', '1x4') for op in OPS])
def test_halo_exchange_and_gather_height_match_the_unsharded_op(ranks, case):
    results, _ = ranks
    for r, res in enumerate(results):
        got = res['ops'][case]
        assert got['fwd'] == 0.0, (case, r, got)
        assert got['bwd'] <= 1e-6 * got['scale'], (case, r, got)


def test_lrh_counts_each_block_once_and_votes_from_the_whole_image(ranks):
    results, _ = ranks
    for res in results:
        assert res['lrh']['calls'] == 1
        assert res['lrh']['hist_equal'] and res['lrh']['labels_equal']
    assert sum(res['lrh']['changed'] for res in results) > 0


def test_pseudo_selection_takes_each_images_class_maxima(ranks):
    results, _ = ranks
    for res in results:
        assert res['selection']['equal']
    assert sum(res['selection']['own_maxima_differ'] for res in results) > 0


def _vs_one(ranks, case: str) -> dict:
    results, _ = ranks
    merged = {}
    for res in results:
        merged.update(res['steps']['vs_one'])
    return merged[case]


def _ghm_moves(ranks, case: str) -> int:
    """How many pixels of the one-process run lie within the band of a GHM
    bin edge (0 for the cases without GHM)."""
    return sum(_vs_one(ranks, case)['ghm_near'])


@pytest.mark.parametrize('case', list(CASES))
def test_losses_equal_the_one_process_step(ranks, case):
    results, _ = ranks
    want = _vs_one(ranks, case)['metrics']
    rtol = 2e-5 if CASES[case][4] else 1e-5
    if _ghm_moves(ranks, case):
        rtol = 1e-4
    for res in results:
        got = res['steps']['metrics'][case]
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=rtol, err_msg=f'{case} {k}')


@pytest.mark.parametrize('case', list(CASES))
def test_state_equals_the_one_process_step(ranks, case):
    vs = _vs_one(ranks, case)
    errs = vs['tensors']
    assert {'prototypes', 'class_freq_s', 'class_freq_t', 'ghm'} <= errs.keys()
    dp_norm, one_norm = vs['momentum_norm']
    assert one_norm > 0
    np.testing.assert_allclose(dp_norm, one_norm, rtol=1e-4, err_msg=case)
    moves = _ghm_moves(ranks, case)
    ins_norm = CASES[case][4]
    for name, (abs_err, ratio, stats_ratio, _) in errs.items():
        if name == 'ghm' and moves:
            got, want = vs['ghm']
            np.testing.assert_allclose(float(got.sum()), float(want.sum()), rtol=RTOL)
            assert abs_err <= 0.01 * moves + ATOL, (case, abs_err, moves)
        elif name.endswith(('running_mean', 'running_var')):
            assert stats_ratio <= 1.0, (case, name, abs_err, f'rtol {STATS_RTOL} atol {STATS_ATOL}')
        elif name.startswith('model.'):
            assert ratio <= 1.0 or abs_err <= (1e-4 if ins_norm else 5e-5), (case, name, abs_err)
        else:
            assert ratio <= 1.0, (case, name, abs_err, f'rtol {RTOL} atol {ATOL}')


@pytest.mark.parametrize('case', list(CASES) + ['sgd'])
def test_replicated_state_is_bit_identical_on_the_ranks(ranks, case):
    results, _ = ranks
    digests = [res['sgd']['digests'] if case == 'sgd' else res['steps']['digests'][case]
               for res in results]
    assert len(digests[0]) > 100
    for d in digests[1:]:
        assert d.keys() == digests[0].keys()
        assert [k for k in d if d[k] != digests[0][k]] == []


def test_each_pseudo_label_step_counts_its_histogram_once_a_rank(ranks):
    results, _ = ranks
    for res in results:
        for case in CASES:
            want = 0 if CASES[case][0] == 1 else 1
            assert res['steps']['calls'][case] == [want, want], case


def test_the_steps_reach_their_losses(ranks):
    results, _ = ranks
    m = results[0]['steps']['metrics']
    for case, key in (('stage3_ghm', 'loss_target'), ('stage3_uvem', 'loss_target'),
                      ('stage2', 'loss_align'), ('stage1', 'loss_domain')):
        assert all(step[key] > 0 for step in m[case]), (case, key)


def _assembled(results, key: str) -> np.ndarray:
    """The (B, H, W, C) eval output from the four ranks' blocks: rows of a
    data rank's images by spatial rank, images by data rank."""
    return torch.cat([torch.cat([results[2 * d + s]['eval'][key] for s in range(2)], dim=1)
                      for d in range(2)]).numpy()


@pytest.mark.parametrize('stride', EVAL['strides'])
def test_eval_forward_equals_the_one_process_forward(ranks, stride):
    results, _ = ranks
    got = _assembled(results, f'os{stride}')
    assert got.shape == (EVAL['batch'], EVAL['size'], EVAL['size'], C)
    np.testing.assert_allclose(got, results[0]['eval'][f'os{stride}_one'].numpy(),
                               rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize('stride', EVAL['strides'])
def test_eval_forward_matches_jax(ranks, stride):
    results, (probs, _, _) = ranks
    np.testing.assert_allclose(_assembled(results, f'os{stride}'), probs[stride],
                               rtol=2e-4, atol=2e-5)


def test_stage1_step_at_128px_matches_the_unsharded_jax_step(ranks):
    results, (_, loss, update_norm) = ranks
    assert update_norm > 1e-6
    for res in results:
        sgd = res['sgd']
        assert sgd['grad_norm'] < SGD['clip']
        np.testing.assert_allclose(sgd['metrics']['total'], loss, rtol=1e-4)
        np.testing.assert_allclose(sgd['update_norm'], update_norm, rtol=1e-3)


def test_dryrun_on_a_two_by_two_group(capfd):
    dryrun_data_parallel(4, 'cpu', n_spatial=2)
    assert ('dryrun_data_parallel(4): 4 ranks on cpu (2 data x 2 spatial)'
            in capfd.readouterr().out)


# ------------------------------------------------------- without a process
def _spatial(rank: int = 0, size: int = 4, n_spatial: int = 2) -> parallel.DataGroup:
    return parallel.DataGroup(rank=rank, size=size, device=torch.device('cpu'),
                              n_spatial=n_spatial)


def test_a_height_that_does_not_split_is_refused():
    group = _spatial(rank=3)
    assert parallel.height_rows(group, 64) == slice(32, 64)
    assert parallel.shard_batch(group, np.zeros((4, 64, 8)))[0].shape == (2, 32, 8)
    with pytest.raises(ValueError, match=r'H % \(n_spatial \* max\(16, output_stride\)\)'):
        parallel.shard_batch(group, np.zeros((4, 48, 8, 3)))
    model = build_deeplabv2('resnet18', C, output_stride=32)
    with parallel.data_parallel(model, group), pytest.raises(ValueError, match='H % 64 = 32'):
        model(torch.zeros(1, 16, 32, 3))


def test_an_n_data_that_does_not_divide_the_batch_is_refused():
    group = _spatial(rank=1, size=6)
    assert (group.n_data, group.data_rank, group.spatial_rank) == (3, 0, 1)
    assert parallel.rows(group, 6) == slice(0, 2)
    with pytest.raises(ValueError, match='n_data 3 does not divide the global batch of 4'):
        parallel.shard_batch(group, np.zeros((4, 32, 32)))


def test_the_trainer_stays_on_the_data_axis():
    cfg = types.SimpleNamespace(SOURCE_DATA_CONFIG={'batch_size': 2}, DATASETS='IsprsDA')
    with pytest.raises(ValueError, match='data axis only'):
        Trainer(torch.nn.Linear(1, 1), cfg, None, None, None, _spatial())


def test_n_spatial_must_divide_the_world():
    with pytest.raises(ValueError, match='n_spatial 3 does not divide the world size 4'):
        parallel.data_group(0, 4, 'cpu', n_spatial=3)
