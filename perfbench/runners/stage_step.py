"""Runner of the stage-step traffic: the window drives the port's
`Trainer.run_step` as `regda_tpu_torch.tools.train_align_reg.main` calls it,
on numpy batches cycled from a pool made from the seed, so that each step
pays run_step's own upload of its host arrays and no decode.

Set-up builds the state as `main` does (the config's optimizer, the
prototypes, a dropout generator, `make_stage2_step` with the recipe's
flags, the `Trainer`), from seeded weights in place of the checkpoints, and
runs the first `checked_steps` steps through the window's own call on
distinct batches; they warm every shape up. The state before them, the
first gradient as the optimizer holds it after step one, and the state
after the last are kept on the host for the check.

The check frees the program, runs the plain reference (reference/stage2.py)
over the same batches from the same weights, prototypes and dropout seed,
and compares each step's loss, the first gradient's norm and the norm of
the parameters' change, leaf by leaf. A window step whose loss is not
finite counts as failed.
"""

from __future__ import annotations

import gc
import logging
import time
import types

import torch

from perfbench import harness, inputs
from perfbench.reference import compare
from perfbench.reference import deeplabv2 as ref_model
from perfbench.reference import stage2 as ref_stage2


def _program_config(cell):
    from regda_tpu_torch.utils.tools import import_config
    return import_config(cell.config['program']['config'], create=False, copy=False,
                         postfix='/align')


def build_model(model_cfg: dict, state: dict, device):
    """The program's DeepLabv2 with `state`'s weights, on `device` (built
    there, not on the host), channels-last, as the CLIs build it."""
    from regda_tpu_torch.models import build_deeplabv2
    with torch.device(device):
        model = build_deeplabv2(model_cfg['backbone'], model_cfg['num_classes'],
                                fc_dim=model_cfg['fc_dim'])
    model.load_state_dict(state)
    return model.to(memory_format=torch.channels_last)


def dropout_seed(seed: int) -> int:
    return inputs.sub_seed(seed, 4)


def setup(cell, seed: int, device):
    from regda_tpu_torch.datasets import get_meta
    from regda_tpu_torch.train import create_train_state, make_optimizer
    from regda_tpu_torch.train import steps as program_steps
    from regda_tpu_torch.train.loop import Trainer
    from regda_tpu_torch.utils.tools import disable_tf32

    disable_tf32()
    m, r, mix = cell.config['model'], cell.config['recipe'], cell.mix
    cfg = _program_config(cell)
    meta = get_meta(cfg.DATASETS)
    model = build_model(m, inputs.seeded_weights(ref_model.shapes(m), seed, device), device)
    optimizer = make_optimizer(model, r['lr'], r['stop_steps'], momentum=r['momentum'],
                               weight_decay=r['weight_decay'], power=r['power'])
    protos = torch.from_numpy(inputs.seeded_prototypes(m['num_classes'], m['fc_dim'], seed))
    state = create_train_state(model, optimizer,
                               torch.Generator(device=device).manual_seed(dropout_seed(seed)),
                               protos)
    step_fn = program_steps.make_stage2_step(
        align_domain=r['align_domain'], refine_label=r['refine_label'],
        refine_mode=r['refine_mode'], refine_temp=r['refine_temp'],
        sam_refine=r['sam_refine'], percent=r['percent'], pcl_temp=r['pcl_temp'],
        proto_decay=r['proto_decay'], num_classes=meta.num_classes,
        ignore_label=meta.ignore_label, cutoff_top=r['cutoff_top'], cutoff_low=r['cutoff_low'])
    logger = logging.getLogger('perfbench.stage_step')
    logger.addHandler(logging.NullHandler())
    logger.propagate = False
    trainer = Trainer(model, cfg, logger, state, step_fn)

    pool = inputs.stage2_pool(seed, mix['pool'], mix['batch'], mix['crop'],
                              m['num_classes'], mix['max_region_id'])
    params = dict(model.named_parameters())
    before = {k: p.detach().to('cpu', copy=True) for k, p in params.items()}
    losses, first_grad = [], None
    for i in range(mix['checked_steps']):
        metrics = _step(trainer, pool, i)
        losses.append(float(metrics['total']))
        if i == 0:
            wd = r['weight_decay']
            opt_state = trainer.state.optimizer.state
            first_grad = {k: (opt_state[p]['momentum_buffer'].cpu() - wd * before[k])
                          if p in opt_state else torch.zeros_like(before[k])
                          for k, p in params.items()}
    after = {k: p.detach().to('cpu', copy=True) for k, p in params.items()}
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
    return types.SimpleNamespace(cell=cell, seed=seed, device=device, trainer=trainer,
                                 pool=pool, step=mix['checked_steps'], losses=losses,
                                 first_grad=first_grad, before=before, after=after)


def _step(trainer, pool, i: int):
    images_s, label_s, images_t, regs_t = pool[i % len(pool)]
    metrics = trainer.run_step(i_iter=i, images_s=images_s, label_s=label_s,
                               images_t=images_t, regs_t=regs_t)
    trainer.maybe_log(i, metrics)
    return metrics


def window(system, seconds: float, tracer) -> dict:
    trainer, pool = system.trainer, system.pool
    totals = []
    i = system.step
    tracer.start()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        totals.append(_step(trainer, pool, i)['total'])
        i += 1
        tracer.item_done()
    if system.device.type == 'cuda':
        torch.cuda.synchronize(system.device)
    window_s = time.perf_counter() - t0
    finite = int(torch.isfinite(torch.stack(totals)).sum()) if totals else 0
    batch = system.cell.mix['batch']
    return {'steps': len(totals), 'finite_steps': finite, 'window_s': window_s,
            'crops': 2 * batch * len(totals), 'batch': batch,
            'crop': system.cell.mix['crop']}


def reference_readings(cell, seed: int, pool: list, device, tf32: bool = False):
    """The reference's losses, first (clipped) gradient and the change of
    its parameters over the checked steps, as name -> host tensor."""
    m, r = cell.config['model'], cell.config['recipe']
    with ref_model.tf32(tf32):
        model = ref_model.build(m).to(device)
        model.load_state_dict(inputs.seeded_weights(ref_model.shapes(m), seed, device))
        protos = torch.from_numpy(inputs.seeded_prototypes(m['num_classes'], m['fc_dim'],
                                                           seed)).to(device)
        step = ref_stage2.Stage2(model, protos, r, m['num_classes'],
                                 torch.Generator(device=device).manual_seed(dropout_seed(seed)))
        names = [k for k, _ in model.named_parameters()]
        before = {k: p.detach().to('cpu', copy=True) for k, p in model.named_parameters()}
        losses, first_grad = [], None
        for i in range(cell.mix['checked_steps']):
            losses.append(step.step(*pool[i % len(pool)]))
            if i == 0:
                first_grad = {k: g.cpu() for k, g in zip(names, step.clipped_grads)}
        change = {k: p.detach().cpu() - before[k] for k, p in model.named_parameters()}
    return losses, first_grad, change


def program_readings(system):
    change = {k: system.after[k] - system.before[k] for k in system.before}
    return system.losses, system.first_grad, change


def free(system) -> None:
    system.trainer = None
    gc.collect()
    if system.device.type == 'cuda':
        torch.cuda.empty_cache()


def check(system, samples) -> harness.Check:
    free(system)
    numbers = compare.training(program_readings(system),
                               reference_readings(system.cell, system.seed, system.pool,
                                                  system.device))
    return harness.Check(numbers, system.cell.limits, samples['steps'],
                         samples['steps'] - samples['finite_steps'])


def control(cell, seed: int, device) -> dict:
    """The numbers of the control: the reference in TF32, the precision
    below the configuration's float32 with TF32 off, in the program's place."""
    pool = inputs.stage2_pool(seed, cell.mix['pool'], cell.mix['batch'], cell.mix['crop'],
                              cell.config['model']['num_classes'], cell.mix['max_region_id'])
    return compare.training(reference_readings(cell, seed, pool, device, tf32=True),
                            reference_readings(cell, seed, pool, device))
