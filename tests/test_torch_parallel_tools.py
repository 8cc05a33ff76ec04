"""The port's data-parallel tools on two gloo ranks on the CPU
(tests/torch_parallel_child.py `tools`): `SegInferencer` with a group and
the pseudo-labels made through it, `SamRegionGenerator` with a group, the
stage-2 CLI and `seg_everything --data-mesh 2` with torchrun's environment,
and `dryrun_data_parallel`, each held to its one-process run; and the
stage-1 CLI started by torchrun itself.

Tolerances, float32:
  * the inferencer's probabilities and the pseudo-label maps rtol 1e-5,
    atol 1e-6 (each rank runs its rows as a batch of its own), its labels
    exactly;
  * region maps exactly: phase 1 runs tile by tile, so a tile's map does
    not depend on the rest of its batch;
  * the stage-2 CLI (tiny_smoke: two steps at lr 1e-2 of the default model,
    a global batch of 2, so one row a rank): the written `_curr.pth` atol
    1e-3, the prototypes atol 1e-4, the best mIoU equal, the
    ranks' final states bit for bit. At a batch of 2 the PPM's BNs
    normalize two values a channel (and, with instance norm, rounding
    noise; ROADMAP queue 3 item 6), so another order of reduction, or only
    another thread count of the one-process run, moves the first conv by
    5e-5 to 5e-4 and the scale-1 BN bias by 1.7e-4 after two updates,
    and the prototypes, an EMA at 0.996 of the moved features, by 3e-5
    (measured). So this hold checks the CLI's plumbing (the ranks meet,
    take their rows, evaluate through the group, write once and resume
    from one state), not the scale of the gradient: a gradient N times too
    large may stay within it. tests/test_torch_parallel.py holds the steps
    themselves to 1e-4 and closer, where that fault shows.
"""

import os
import shutil
import tempfile
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from regda_tpu_torch.entry import dryrun_data_parallel, sam_regions_entry, serve_entry
from regda_tpu_torch.parallel import DataGroup
from regda_tpu_torch.tools import seg_everything, train_align_reg
from regda_tpu_torch.train.loop import Trainer
from tests.test_torch_parallel import finish_child, start_child
from tests.torch_parallel_child import (SAM_KW, SEG_ARGS, cli_args, digest, pseudo_labels,
                                        state_tensors, write_start, write_tiles)


@pytest.fixture(scope='module')
def ranks():
    torch.set_num_threads(2)
    out = tempfile.mkdtemp(prefix='regda_parallel_tools_')
    saved = {k: os.environ.get(k) for k in ('REGDA_SMOKE_ROOT', 'REGDA_SMOKE_STEPS')}
    try:
        write_start(os.path.join(out, 'start'))
        write_tiles(os.path.join(out, 'mesh'))
        child = start_child('tools', out)     # the one-process CLI runs meanwhile
        os.environ.update(REGDA_SMOKE_ROOT=os.path.join(out, 'one'), REGDA_SMOKE_STEPS='2')
        ns = train_align_reg.main(cli_args(os.path.join(out, 'start')))
        results = finish_child(child, out)
        yield types.SimpleNamespace(out=out, results=results, one=ns)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(out, ignore_errors=True)


def test_seg_inferencer_with_a_group_equals_one_process(ranks):
    inf, images = serve_entry('cpu', dtype=torch.float32, resnet='resnet18', images=3,
                              size=64, tile=64, stride=32)
    probs = inf.predict_probs(images, slide=True, tta=True)
    labels = inf.predict_labels(images, slide=True, tta=False)
    for r in ranks.results:
        assert r['probs'].shape == probs.shape == (3, 64, 64, 6)
        np.testing.assert_allclose(r['probs'], probs, rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(r['labels'], labels)


def test_pseudo_labels_through_a_group_equal_one_process(ranks, tmp_path, monkeypatch):
    """`gener_target_pseudo` through the inferencer with a group: the first
    rank writes every tile's maps, equal to the one-process run's."""
    monkeypatch.setenv('REGDA_SMOKE_ROOT', os.path.join(ranks.out, 'smoke'))
    inf, _ = serve_entry('cpu', dtype=torch.float32, resnet='resnet18', images=3,
                         size=64, tile=64, stride=32)
    pseudo_labels(inf, str(tmp_path / 'pseudo'))
    two = os.path.join(ranks.out, 'pseudo')
    names = sorted(os.listdir(tmp_path / 'pseudo'))
    assert len(names) == 4 and sorted(os.listdir(two)) == names
    assert sorted(os.listdir(two + '_color')) == sorted(os.listdir(tmp_path / 'pseudo_color'))
    for n in names:
        np.testing.assert_allclose(np.load(os.path.join(two, n)),
                                   np.load(tmp_path / 'pseudo' / n), rtol=1e-5, atol=1e-6)


def test_region_generator_with_a_group_equals_one_process(ranks):
    gen, tiles = sam_regions_entry('cpu', **SAM_KW)
    want = gen.generate_regions_batch(tiles, area_threshold=4)
    assert len(want) == 3 and any(m.max() > 0 for m in want)
    for r in ranks.results:
        assert len(r['maps']) == 3
        for got, w in zip(r['maps'], want):
            np.testing.assert_array_equal(got, w)


def test_stage2_cli_on_two_ranks_equals_one_process(ranks):
    two = os.path.join(ranks.out, 'two_steps')        # copied before the resumed run
    one = os.path.join(ranks.out, 'one', 'log', 'align')
    a = torch.load(os.path.join(two, 'Vaihingen_curr.pth'))
    b = torch.load(os.path.join(one, 'Vaihingen_curr.pth'))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), rtol=0.0, atol=1e-3, err_msg=k)
    np.testing.assert_allclose(np.load(os.path.join(two, 'prototypes_best.npy')),
                               np.load(os.path.join(one, 'prototypes_best.npy')),
                               rtol=0.0, atol=1e-4)
    assert ranks.one.trainer.state.step == 2
    for r in ranks.results:
        assert r['cli_miou'] == ranks.one.trainer.mIoU_max


def test_stage2_cli_ranks_hold_one_state(ranks):
    d0, d1 = (r['cli_digest'] for r in ranks.results)
    assert d0 == d1 and len(d0) > 100
    one = {k: digest(v) for k, v in state_tensors(ranks.one.trainer.state).items()}
    assert one.keys() == d0.keys()


def test_stage2_cli_resumes_on_every_rank_from_the_first_ranks_state(ranks):
    """`--auto-resume 1` with 3 steps after a 2-step run: the first rank
    reads `_state.pth` and broadcasts it; both ranks resume at step 2, take
    step 3, and hold one state."""
    r0, r1 = ranks.results
    assert r0['resumed_step'] == r1['resumed_step'] == 3
    assert r0['resumed_digest'] == r1['resumed_digest']
    assert r0['resumed_digest'] != r0['cli_digest']


def test_seg_everything_data_mesh_writes_the_one_process_maps(ranks, tmp_path):
    """`--data-mesh 2` under torchrun's variables: each rank makes and writes
    its share of every batch of tiles through the generator's group."""
    one = write_tiles(str(tmp_path))
    seg_everything.main(['--img-dirs', one] + SEG_ARGS)
    one = one.replace('img_dir', 'reg_dir')
    two = os.path.join(ranks.out, 'mesh', 'reg_dir', 'train')
    names = sorted(os.listdir(one))
    assert names == ['t0.tif', 't1.tif', 't2.tif']
    assert sorted(os.listdir(two)) == names
    painted = 0
    for n in names:
        a = np.asarray(Image.open(os.path.join(one, n)))
        b = np.asarray(Image.open(os.path.join(two, n)))
        np.testing.assert_array_equal(b, a)
        painted += int(a.max() > 0)
    assert painted > 0


def test_seg_everything_data_mesh_needs_the_fast_path():
    with pytest.raises(SystemExit, match='requires --fast 1'):
        seg_everything.main(['--img-dirs', 'x', '--data-mesh', '2', '--fast', '0',
                             '--device', 'cpu'])


@pytest.fixture
def scratch_dir():
    path = tempfile.mkdtemp(prefix='regda_torchrun_')
    yield Path(path)
    shutil.rmtree(path, ignore_errors=True)     # ~0.6 GB of checkpoints


def test_train_src_runs_under_torchrun(scratch_dir):
    """`torchrun --nproc_per_node 2 -m regda_tpu_torch.tools.train_src ...
    --device cpu`: the ranks meet through torchrun's environment (gloo),
    the first rank alone logs and writes the checkpoints, and the state
    holds both steps."""
    import socket
    import subprocess
    import sys
    with socket.socket() as sock:
        sock.bind(('127.0.0.1', 0))
        port = sock.getsockname()[1]
    root = scratch_dir / 'smoke'
    env = dict(os.environ, REGDA_SMOKE_ROOT=str(root), REGDA_SMOKE_STEPS='2',
               OMP_NUM_THREADS='2', PYTHONPATH=str(Path(__file__).resolve().parents[1]))
    res = subprocess.run(
        [sys.executable, '-m', 'torch.distributed.run', '--nproc_per_node', '2',
         '--master_addr', '127.0.0.1', '--master_port', str(port), '-m',
         'regda_tpu_torch.tools.train_src', '--config-path', 'st.regda.tiny_smoke',
         '--align-domain', '1', '--device', 'cpu'],
        env=env, cwd=scratch_dir, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-4000:]
    src = root / 'log' / 'src'
    assert len(list(src.glob('*.log'))) == 1
    state = torch.load(src / 'Vaihingen_state.pth', weights_only=True)
    assert state['step'] == 2
    assert torch.load(src / 'Vaihingen_best.pth', weights_only=True).keys() == \
        state['model'].keys()


def test_dryrun_data_parallel_on_two_cpu_ranks(capfd):
    dryrun_data_parallel(2, 'cpu')
    assert 'dryrun_data_parallel(2): 2 ranks on cpu' in capfd.readouterr().out


def test_trainer_refuses_a_world_size_that_does_not_divide_the_batch():
    cfg = types.SimpleNamespace(SOURCE_DATA_CONFIG={'batch_size': 2}, DATASETS='IsprsDA')
    group = DataGroup(rank=0, size=3, device=torch.device('cpu'))
    model = torch.nn.Linear(1, 1)
    with pytest.raises(ValueError, match='world size 3 does not divide the global batch of 2'):
        Trainer(model, cfg, None, None, None, group)
