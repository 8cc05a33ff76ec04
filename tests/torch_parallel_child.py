"""Two gloo ranks on the CPU for tests/test_torch_parallel*.py.

Run as `python tests/torch_parallel_child.py {steps|tools} OUT`: starts two
ranks (`torch.multiprocessing` spawn, a `file://` rendezvous in OUT), each
running one set of data-parallel cases on its rows of seeded global
batches, and writes what the tests hold to OUT/rank<r>.pt.

* `steps`: the stage-1, stage-2 and stage-3 steps (`CASES`), two steps
  each. Every rank records its metrics and a SHA-256 of every tensor of its
  state (the tests compare the ranks' digests); rank 0 also runs the
  one-process step on the whole batch from the same state and records, per
  state tensor, the largest |dp - one| and the largest |dp - one| / (atol +
  rtol |one|) at the two tolerances below and the largest |one|, so that no 150 MB state needs to leave the process; and for
  the `jax` case (one step, head dropout off, as tests/test_torch_step.py)
  the stepped model's state_dict, which the test holds to the JAX step.
* `tools`: `SegInferencer(group=...)` on three images (odd: the last rank
  pads), `gener_target_pseudo` through that inferencer over the tiny_smoke
  target tiles, `SamRegionGenerator(group=...)` on three tiles, the stage-2
  CLI `train_align_reg` for two steps with RANK / WORLD_SIZE / LOCAL_RANK
  set as torchrun sets them, then `--auto-resume 1` for a third, and
  `seg_everything --data-mesh 2` under the same variables over OUT/mesh
  (tiles the test writes first); the test runs each in one process and
  compares.
"""

import hashlib
import os
import shutil
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

WORLD = 2
C = 6
RTOL, ATOL = 1e-5, 1e-6             # prototypes, EMAs, GHM bins (and parameters)
STATS_RTOL, STATS_ATOL = 1e-4, 1e-5 # BN running statistics after two steps

# name -> (stage, batch, size, classifier scale, is_ins_norm, step kwargs).
# Stage 2 scales the classifier up so that pseudo-labels pass selection and
# LRH changes some; stage 3 keeps it as drawn: with saturated softmaxes a
# pixel's GHM gradient norm |p_y - 1| lands on a bin edge within float
# rounding, where two reduction orders may bin it apart. The `_in` case
# runs the default model, with instance norm (tests/test_torch_parallel.py
# says what that changes); the others run it without.
CASES = {
    'stage1': (1, 4, 32, 1.0, False, dict(align_domain=True, bcs=True)),
    'stage2': (2, 4, 32, 30.0, False, dict(bcs=True)),
    'stage2_one_row': (2, 2, 32, 30.0, False, {}),
    'stage3_uvem': (3, 4, 32, 1.0, False, dict(lt='uvem', bcs=True, bct=True)),
    'stage3_ghm': (3, 4, 32, 1.0, False, dict(lt='ghm')),
    'stage3_ohem': (3, 4, 32, 1.0, False, dict(lt='ohem', bct=True)),
    'stage2_in': (2, 4, 32, 30.0, True, dict(bcs=True)),
}
JAX_CASE = dict(batch=2, size=64, lr=1e-2, stop=10)    # tests/test_torch_step.py


def build_state(case: str):
    from regda_tpu_torch.models import build_deeplabv2
    from regda_tpu_torch.train import create_train_state, make_optimizer
    _, _, _, scale, ins_norm, _ = CASES[case]
    model = build_deeplabv2('resnet18', C, is_ins_norm=ins_norm,
                            generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for head in (model.layer5, model.layer6):
            head.conv_last[4].weight.mul_(scale)
    protos = np.random.default_rng(0).normal(size=(C, 512)).astype(np.float32)
    # stop_steps 20: the first update's lr is 0 (warmup), the second's 1e-2.
    # No clipping where the gradients are of a moderate size (the classifier
    # as drawn, no instance norm), so that the update shows their scale
    clip = 1e9 if scale == 1.0 and not ins_norm else 32.0
    return create_train_state(model, make_optimizer(model, 1e-2, 20, clip_norm=clip),
                              torch.Generator().manual_seed(3), torch.from_numpy(protos))


def make_step(case: str, group):
    from regda_tpu_torch.train.steps import (make_stage1_step, make_stage2_step,
                                             make_stage3_step)
    stage, _, _, _, _, kw = CASES[case]
    make = {1: make_stage1_step, 2: make_stage2_step, 3: make_stage3_step}[stage]
    return make(num_classes=C, group=group, **kw)


def batches(case: str):
    """Two global batches of `case`, numpy, in the step's argument order."""
    from regda_tpu_torch.entry import synthetic_soft_labels, synthetic_stage2_batch
    stage, b, size, _, _, _ = CASES[case]
    rng = np.random.default_rng(1)
    out = []
    for _ in range(2):
        images_s, label_s, images_t, regs = synthetic_stage2_batch(rng, b, size, C)
        soft = synthetic_soft_labels(rng, b, size, C)
        out.append({1: (images_s, label_s, images_t),
                    2: (images_s, label_s, images_t, regs),
                    3: (images_s, label_s, images_t, soft, regs)}[stage])
    return out


def state_tensors(state) -> dict:
    out = {f'model.{k}': v for k, v in state.model.state_dict().items()}
    out.update(prototypes=state.prototypes, class_freq_s=state.class_freq_s.freq,
               class_freq_t=state.class_freq_t.freq, ghm=state.ghm.acc_sum)
    for name, p in state.model.named_parameters():
        buf = state.optimizer.state.get(p, {}).get('momentum_buffer')
        if buf is not None:
            out[f'momentum.{name}'] = buf
    return out


def momentum_norm(tensors: dict) -> float:
    """The L2 norm of all momentum buffers together: the SGD velocity, a
    scale that clipping the update leaves visible."""
    return float(torch.sqrt(sum((v.double() ** 2).sum() for k, v in tensors.items()
                                if k.startswith('momentum.'))))


def digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.detach().contiguous().numpy().tobytes()).hexdigest()


def run_case(case: str, group):
    from regda_tpu_torch.parallel import shard_batch
    state, step = build_state(case), make_step(case, group)
    metrics = []
    for arrays in batches(case):
        own = shard_batch(group, *arrays)
        m = step(state, *(torch.from_numpy(np.ascontiguousarray(a)) for a in own))
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def run_jax_case(group):
    """One stage-2 step at tests/test_torch_step.py's inputs and weights
    (the JAX model's init, converted by the test into `jax_init.pt`), head
    dropout off."""
    from regda_tpu_torch.entry import synthetic_stage2_batch
    from regda_tpu_torch.models import build_deeplabv2
    from regda_tpu_torch.models.heads import Dropout2d
    from regda_tpu_torch.parallel import shard_batch
    from regda_tpu_torch.train import create_train_state, make_optimizer
    from regda_tpu_torch.train.steps import make_stage2_step
    init = torch.load(os.path.join(OUT, 'jax_init.pt'))
    model = build_deeplabv2('resnet18', num_classes=C)
    model.load_state_dict(init['state_dict'])
    for m in model.modules():
        if isinstance(m, Dropout2d):
            m.p = 0.0
    state = create_train_state(model, make_optimizer(model, JAX_CASE['lr'], JAX_CASE['stop']),
                               torch.Generator(), init['prototypes'])
    rng = np.random.default_rng(0)
    rng.normal(size=(C, 512))                     # the prototypes' draw
    batch = synthetic_stage2_batch(rng, JAX_CASE['batch'], JAX_CASE['size'], C)
    own = shard_batch(group, *batch)
    metrics = make_stage2_step(num_classes=C, group=group)(
        state, *(torch.from_numpy(np.ascontiguousarray(a)) for a in own))
    return state, {k: float(v) for k, v in metrics.items()}


def steps(rank: int, group) -> dict:
    out = {'metrics': {}, 'digests': {}, 'vs_one': {}}
    mine = {}   # case -> (state tensors less momentum, momentum norm), this rank's share
    for i, case in enumerate(CASES):
        state, metrics = run_case(case, group)
        out['metrics'][case] = metrics
        tensors = state_tensors(state)
        out['digests'][case] = {k: digest(v) for k, v in tensors.items()}
        if i % WORLD == rank:
            mine[case] = ({k: v.detach().clone() for k, v in tensors.items()
                           if not k.startswith('momentum.')}, momentum_norm(tensors))
        del state, tensors
    state, metrics = run_jax_case(group)
    out['metrics']['jax'] = [metrics]
    out['digests']['jax'] = {k: digest(v) for k, v in state_tensors(state).items()}
    if rank == 0:
        out['jax_state'] = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
        out['jax_prototypes'] = state.prototypes.clone()
        out['jax_class_freq_s'] = state.class_freq_s.freq.clone()
    del state
    # the one-process steps, each rank its share of the cases, side by side
    for case, (tensors, dp_norm) in mine.items():
        ref, ref_metrics = run_case(case, None)
        ref_tensors = state_tensors(ref)
        errs = {}
        for k, v in tensors.items():
            a, b = v.double(), ref_tensors[k].double()
            d = (a - b).abs()
            errs[k] = (float(d.max()), float((d / (ATOL + RTOL * b.abs())).max()),
                       float((d / (STATS_ATOL + STATS_RTOL * b.abs())).max()),
                       float(b.abs().max()))
        out['vs_one'][case] = {'metrics': ref_metrics, 'tensors': errs,
                               'momentum_norm': (dp_norm, momentum_norm(ref_tensors))}
    return out


def pseudo_labels(inferencer, path: str) -> None:
    """Offline pseudo-labels of the tiny_smoke target tiles into `path`."""
    from regda_tpu_torch.datasets import DALoader
    from regda_tpu_torch.pseudo import gener_target_pseudo
    from regda_tpu_torch.utils.tools import import_config
    cfg = import_config(CFG, create=False, copy=False)
    gener_target_pseudo(cfg, inferencer, DALoader(cfg.PSEUDO_DATA_CONFIG, cfg.DATASETS),
                        path, size=cfg.PSEUDO_SIZE)


def tools(rank: int, group) -> dict:
    from regda_tpu_torch.entry import sam_regions_entry, serve_entry
    from regda_tpu_torch.tools import seg_everything, train_align_reg
    out = {}
    inf, images = serve_entry('cpu', dtype=torch.float32, resnet='resnet18', images=3,
                              size=64, tile=64, stride=32)
    inf.group = group
    out['probs'] = inf.predict_probs(images, slide=True, tta=True)
    out['labels'] = inf.predict_labels(images, slide=True, tta=False)
    pseudo_labels(inf, os.path.join(OUT, 'pseudo'))
    gen, tiles = sam_regions_entry('cpu', **SAM_KW)
    gen.group = group
    out['maps'] = gen.generate_regions_batch(tiles, area_threshold=4)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(WORLD), LOCAL_RANK=str(rank),
                      REGDA_SMOKE_ROOT=os.path.join(OUT, 'smoke'), REGDA_SMOKE_STEPS='2')
    ns = train_align_reg.main(cli_args(os.path.join(OUT, 'start')))
    out['cli_miou'] = ns.trainer.mIoU_max
    out['cli_digest'] = {k: digest(v) for k, v in state_tensors(ns.trainer.state).items()}
    if rank == 0:      # what the two steps wrote, before the resumed run writes again
        align = os.path.join(OUT, 'smoke', 'log', 'align')
        shutil.copytree(align, os.path.join(OUT, 'two_steps'),
                        ignore=shutil.ignore_patterns('vis-*', '*.log', '*.py'))
    # one step more from the state the first rank wrote, read there and broadcast
    os.environ['REGDA_SMOKE_STEPS'] = '3'
    ns = train_align_reg.main(cli_args(os.path.join(OUT, 'start')) + ['--auto-resume', '1'])
    out['resumed_step'] = ns.trainer.state.step
    out['resumed_digest'] = {k: digest(v) for k, v in state_tensors(ns.trainer.state).items()}
    seg_everything.main(['--img-dirs', os.path.join(OUT, 'mesh', 'img_dir', 'train'),
                         '--data-mesh', str(WORLD)] + SEG_ARGS)
    return out


# seg_everything's flags for the --data-mesh test: vit_t at 64 px, every
# mask kept, so that NMS paints regions
SEG_ARGS = ['--model-type', 'vit_t', '--img-size', '64', '--points-per-side', '4',
            '--pred-iou-thresh=-1e9', '--stability-thresh', '0', '--area-threshold', '4',
            '--batch-tiles', '2', '--device', 'cpu']


def write_tiles(root: str) -> str:
    """Three seeded 48^2 tiles under root/img_dir/train; -> that directory."""
    from PIL import Image
    img_dir = os.path.join(root, 'img_dir', 'train')
    os.makedirs(img_dir)
    rng = np.random.default_rng(7)
    for i in range(3):
        Image.fromarray(rng.integers(0, 256, (48, 48, 3), dtype=np.uint8)).save(
            os.path.join(img_dir, f't{i}.png'))
    return img_dir


SAM_KW = dict(vit_config='vit_t', img_size=64, tiles=3, tile=48, dtype=torch.float32,
              points_per_side=4, points_per_batch=8, pred_iou_thresh=-1e9,
              stability_score_thresh=0.0, crop_n_layers=1)
CFG = 'st.regda.tiny_smoke'


def cli_args(start: str) -> list:
    """The stage-2 CLI's arguments from a start directory holding `model.pth`
    and `protos.npy`."""
    return ['--config-path', CFG, '--ckpt-model', os.path.join(start, 'model.pth'),
            '--ckpt-proto', os.path.join(start, 'protos.npy'), '--align-domain', '1',
            '--refine-label', '1', '--sam-refine', '--percent', '0.5', '--device', 'cpu']


def write_start(start: str) -> None:
    """A seeded resnet18 checkpoint (classifier x 30, so that pseudo-labels
    pass selection) and seeded prototypes for the stage-2 CLI (the test
    writes them before it starts the `tools` ranks)."""
    from regda_tpu_torch.models import build_deeplabv2
    os.makedirs(start, exist_ok=True)
    model = build_deeplabv2('resnet18', C, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        for head in (model.layer5, model.layer6):
            head.conv_last[4].weight.mul_(30.0)
    torch.save(model.state_dict(), os.path.join(start, 'model.pth'))
    np.save(os.path.join(start, 'protos.npy'),
            np.random.default_rng(5).normal(size=(C, 512)).astype(np.float32))


def _rank(rank: int, which: str, out: str) -> None:
    global OUT
    OUT = out
    torch.set_num_threads(2)
    from regda_tpu_torch.parallel import data_group, shutdown
    group = data_group(rank, WORLD, 'cpu',
                       init_method='file://' + os.path.join(out, 'rendezvous'))
    try:
        result = (steps if which == 'steps' else tools)(rank, group)
        torch.save(result, os.path.join(out, f'rank{rank}.pt'))
    finally:
        shutdown()


OUT = None


def main(which: str, out: str) -> None:
    import torch.multiprocessing as mp
    os.makedirs(out, exist_ok=True)
    if which == 'tools':
        os.environ.update(REGDA_SMOKE_ROOT=os.path.join(out, 'smoke'), REGDA_SMOKE_STEPS='2')
        import regda_tpu_torch.configs.st.regda.tiny_smoke  # noqa: F401  writes the tree once
    mp.spawn(_rank, args=(which, out), nprocs=WORLD, join=True)


if __name__ == '__main__':
    main(sys.argv[1], sys.argv[2] if len(sys.argv) > 2 else tempfile.mkdtemp())
