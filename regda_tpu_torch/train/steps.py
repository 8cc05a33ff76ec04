"""The stage-1, prototype-init, stage-2 and stage-3 steps (counterparts of
regda_tpu/train/steps.py:make_stage1_step, make_proto_accum_step,
make_stage2_step and make_stage3_step).

References: tools/train_src.py:108-141 (stage 1), tools/init_prototypes.py
:101-112 (prototype init), tools/train_align_reg.py:144-196 (stage 2),
tools/train_ssl_reg.py:198-241 (stage 3). Same flags, defaults and order as
the JAX steps. Stage 2: source forward -> prototype EMA -> target forward ->
soft labels -> refine -> selection -> LRH -> downscale -> losses -> clip ->
SGD. Stage 3: both forwards -> refine of the loaded soft labels by the
prototypes from before this step -> selection -> LRH -> prototype EMA ->
losses at the labels' full resolution -> clip -> SGD. The pseudo-label
branch carries no gradient (the JAX package's stop_gradient), so it runs
under `torch.no_grad()`; LRH has no backward, and autograd carries the rest.

A train step updates the state in place (model, optimizer, prototypes,
class balance, step count) and returns detached 0-dim loss tensors.

Every step takes `group`, a `parallel.DataGroup`: it is then one rank's
part of a data-parallel step whose images are this rank's rows of the
global batch. The BatchNorms, the head dropout, the losses, the class
balance, the prototypes and the GHM histogram work on the global batch,
the gradients are averaged over the ranks before the update, and the
metrics are the global losses, so that the step equals the one-process
step on the global batch (parallel/mesh.py). On the group's spatial axis
the images, labels, region maps and soft labels are this rank's block of
rows: the segmenter exchanges its halos, each resize of the stride-16
maps to the labels' size takes the whole image's rows (`resize_rows`), and
the pseudo-label selection and LRH take their per-image maxima and
histograms over the ranks that hold the image. Without a group nothing
changes.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from regda_tpu_torch.ops import losses as L
from regda_tpu_torch.ops.labels import downscale_label, one_hot_ignore
from regda_tpu_torch.ops.lrh import MAX_REGIONS, homogenize
from regda_tpu_torch.ops.prototypes import prototype_accumulate, prototype_update
from regda_tpu_torch.ops.pseudo import pseudo_selection
from regda_tpu_torch.ops.refine import label_refine
from regda_tpu_torch.ops.resize import resize_rows
from regda_tpu_torch.parallel.mesh import DataGroup, average_gradients, data_parallel
from regda_tpu_torch.train.state import TrainState
from regda_tpu_torch.utils.profiling import span


def _flat(feat):
    return feat.reshape(-1, feat.shape[-1])


def _source_loss(ls: str, bcs: bool, num_classes: int, class_temp: float,
                 ignore_label: int = -1, group: Optional[DataGroup] = None):
    """fn(preds, labels, cb_state) -> (loss, cb_state), one loss per head
    averaged, with the class-balance EMA updated once per head (as the
    reference's loss_calc)."""
    losses = {'CrossEntropy': L.cross_entropy_loss,
              'OhemCrossEntropy': L.ohem_cross_entropy_loss}
    if ls not in losses:
        raise ValueError(f'source loss {ls!r}: expected one of {sorted(losses)}')
    base = losses[ls]

    def fn(preds, labels, cb_state):
        hw = tuple(labels.shape[-2:])
        total = 0.0
        for p in preds:
            p = resize_rows(p, hw, group)
            w = None
            if bcs:
                w, cb_state = L.class_balance_weights(
                    cb_state, labels, num_classes, ignore_label,
                    temperature=class_temp, group=group)
            total = total + base(p, labels, ignore_label, pixel_weight=w, group=group)
        return total / len(preds), cb_state

    return fn


def make_stage1_step(*, align_domain: bool = False, ls: str = 'CrossEntropy',
                     bcs: bool = False, class_temp: float = 2.0,
                     num_classes: int = 6, ignore_label: int = -1,
                     group: Optional[DataGroup] = None) -> Callable:
    """Returns step(state, images_s, label_s, images_t) -> metrics: CE on
    the source (both heads averaged, optionally class-balanced) and, with
    `align_domain`, CORAL between the source and target features. The
    target forward runs only with `align_domain`, as in the JAX step, so
    without it the BN statistics see no target batch."""
    src_loss = _source_loss(ls, bcs, num_classes, class_temp, ignore_label, group)

    def step(state: TrainState, images_s, label_s, images_t):
        model = state.model
        model.train()
        with data_parallel(model, group):
            with span('step.forward'):
                p_s1, p_s2, feat_s = model(images_s, state.generator)
                loss_seg, cb_state = src_loss([p_s1, p_s2], label_s, state.class_freq_s)
                if align_domain:
                    _, _, feat_t = model(images_t, state.generator)
                    loss_domain = L.coral_loss(_flat(feat_s), _flat(feat_t), group=group)
                    loss = loss_seg + loss_domain
                else:
                    loss_domain = torch.zeros((), device=loss_seg.device)
                    loss = loss_seg
            _update(state, loss, group)
        state.class_freq_s = cb_state
        state.step += 1
        return {'total': loss.detach(), 'loss_seg': loss_seg.detach(),
                'loss_domain': loss_domain.detach()}

    return step


def _update(state: TrainState, loss: torch.Tensor, group: Optional[DataGroup]) -> None:
    """Backward, the gradients averaged over the ranks, the SGD update.
    Runs inside `data_parallel`: a checkpointed block's recompute in the
    backward runs its BatchNorms over the global batch again."""
    with span('step.backward'):
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
    if group is not None:
        with span('step.grad_allreduce'):
            average_gradients(state.model.parameters(), group)
    with span('step.optimizer'):
        state.optimizer.step()


@torch.no_grad()
def proto_accum_step(model, data_sum, data_cnt, images_s, label_s,
                     num_classes: int, ignore_label: int = -1,
                     group: Optional[DataGroup] = None):
    """One source pass of prototype init: per-class sums and counts of the
    stride-16 features under the 16x majority-vote labels -> (sum, cnt).

    The reference never switches to eval here (init_prototypes.py:87-109),
    so the features come from the train-mode forward (batch statistics);
    the JAX step discards that forward's statistics update, so every BN
    running statistic is restored afterwards. Only the encoder runs: the
    heads' outputs are discarded there and change nothing that is kept."""
    model.train()
    saved = [b.clone() for b in model.buffers()]
    with data_parallel(model, group):
        feat = model.features(images_s).permute(0, 2, 3, 1)
    for b, s in zip(model.buffers(), saved):
        b.copy_(s)
    lbl_down = downscale_label(label_s, 16, num_classes, ignore_label)
    onehot = one_hot_ignore(lbl_down.reshape(-1), num_classes, ignore_label)
    return prototype_accumulate(data_sum, data_cnt, _flat(feat.float()), onehot, group)


def make_stage2_step(*, align_domain: bool = True,
                     refine_label: bool = True, refine_mode: str = 'all',
                     refine_temp: float = 2.0, sam_refine: bool = True,
                     percent: float = 0.5, ls: str = 'CrossEntropy',
                     bcs: bool = False, class_temp: float = 2.0,
                     pcl_temp: float = 8.0, proto_decay: float = 0.996,
                     num_classes: int = 6, ignore_label: int = -1,
                     cutoff_top: float = 0.8, cutoff_low: float = 0.6,
                     group: Optional[DataGroup] = None) -> Callable:
    """Returns step(state, images_s, label_s, images_t, regs_t) -> metrics."""
    src_loss = _source_loss(ls, bcs, num_classes, class_temp, ignore_label, group)

    def step(state: TrainState, images_s, label_s, images_t, regs_t):
        model = state.model
        model.train()
        with data_parallel(model, group):
            return body(state, model, images_s, label_s, images_t, regs_t)

    def body(state: TrainState, model, images_s, label_s, images_t, regs_t):
        with span('step.forward'):
            p_s1, p_s2, feat_s = model(images_s, state.generator)
            with torch.no_grad():
                label_s_down = downscale_label(label_s, 16, num_classes, ignore_label)
                oh_s = one_hot_ignore(label_s_down.reshape(-1), num_classes, ignore_label)
                protos = prototype_update(state.prototypes, _flat(feat_s.detach()),
                                          oh_s, proto_decay, group)

            p_t1, p_t2, feat_t = model(images_t, state.generator)
            with torch.no_grad():
                hw = tuple(images_t.shape[1:3])
                x1 = resize_rows(p_t1.detach(), hw, group)
                x2 = resize_rows(p_t2.detach(), hw, group)
                label_t_soft = (torch.softmax(x1, -1) + torch.softmax(x2, -1)) * 0.5
                with span('step.pseudo_label'):
                    if refine_label:
                        label_t_soft = label_refine(
                            feat_t.detach(), [p_t1.detach(), p_t2.detach()],
                            label_t_soft, protos, mode=refine_mode, temp=refine_temp, group=group)
                    label_t_hard = pseudo_selection(label_t_soft, cutoff_top,
                                                    cutoff_low, ignore_label, group)
                    if sam_refine:
                        label_t_hard = homogenize(label_t_hard, regs_t, percent, num_classes,
                                                  ignore_label, MAX_REGIONS, group)
                    label_t = downscale_label(label_t_hard, 16, num_classes, ignore_label)

            loss_seg, cb_state = src_loss([p_s1, p_s2], label_s, state.class_freq_s)
            loss_domain = (L.coral_loss(_flat(feat_s), _flat(feat_t), group=group)
                           if align_domain else torch.zeros((), device=loss_seg.device))
            loss_align = 0.5 * (
                L.prototype_contrastive_loss(protos, _flat(feat_s), label_s_down,
                                             pcl_temp, ignore_label, group)
                + L.prototype_contrastive_loss(protos, _flat(feat_t), label_t,
                                               pcl_temp, ignore_label, group))
            loss = loss_seg + loss_domain + loss_align

        _update(state, loss, group)
        state.prototypes = protos
        state.class_freq_s = cb_state
        state.step += 1
        return {'total': loss.detach(), 'loss_seg': loss_seg.detach(),
                'loss_align': loss_align.detach(),
                'loss_domain': loss_domain.detach()}

    return step


def make_stage3_step(*, refine_label: bool = True, refine_mode: str = 'all',
                     refine_temp: float = 2.0, sam_refine: bool = True,
                     percent: float = 0.5, ls: str = 'CrossEntropy',
                     lt: str = 'uvem', bcs: bool = False, bct: bool = False,
                     class_temp: float = 2.0, uvem_m: float = 0.2,
                     uvem_t: float = 0.7, uvem_g: float = 4.0,
                     proto_decay: float = 0.996, num_classes: int = 6,
                     ignore_label: int = -1, cutoff_top: float = 0.8,
                     cutoff_low: float = 0.6,
                     group: Optional[DataGroup] = None) -> Callable:
    """Returns step(state, images_s, label_s, images_t, label_t_prob,
    regs_t) -> metrics (`total`, `loss_source`, `loss_target`), where
    label_t_prob (B, H, W, C) are the offline pseudo-label probabilities.

    The target loss (`lt`: 'uvem'/'ours', 'ups', 'ohem', 'focal', 'ghm',
    else CE) runs on each head resized to the hard labels' resolution and
    averages the two; with `bct` (and an `lt` that takes weights, or
    'ohem', which moves the EMA but ignores them) the target class-balance
    EMA updates once per head, and the GHM histogram threads through both
    heads (balance.py:437-457)."""
    src_loss = _source_loss(ls, bcs, num_classes, class_temp, ignore_label, group)
    targets = ('ours', 'uvem', 'ups', 'ohem', 'focal', 'ghm', 'none', 'ce')
    if lt not in targets:
        raise ValueError(f'target loss {lt!r}: expected one of {targets}')

    def target_loss(preds, label_hard, label_soft, cb_state, ghm):
        hw = tuple(label_hard.shape[-2:])
        total = 0.0
        for p in preds:
            p = resize_rows(p, hw, group)
            w = None
            if bct and lt in ('ours', 'uvem', 'ups', 'ohem', 'none', 'ce'):
                w, cb_state = L.class_balance_weights(
                    cb_state, label_hard, num_classes, ignore_label,
                    temperature=class_temp, group=group)
            if lt in ('ours', 'uvem'):
                loss = L.uvem_loss(p, label_hard, label_soft, uvem_m, uvem_t, uvem_g,
                                   ignore_label, pixel_weight=w, group=group)
            elif lt == 'ups':
                loss = L.ups_loss(p, label_hard, label_soft, uvem_t, ignore_label,
                                  pixel_weight=w, group=group)
            elif lt == 'ohem':
                loss = L.ohem_cross_entropy_loss(p, label_hard, ignore_label, group=group)
            elif lt == 'focal':
                loss = L.focal_loss(p, label_hard, 2.0, ignore_label, group=group)
            elif lt == 'ghm':
                loss, ghm = L.ghm_loss(ghm, p, label_hard, ignore_label=ignore_label,
                                       group=group)
            else:
                loss = L.cross_entropy_loss(p, label_hard, ignore_label, pixel_weight=w,
                                            group=group)
            total = total + loss
        return total / len(preds), cb_state, ghm

    def step(state: TrainState, images_s, label_s, images_t, label_t_prob, regs_t):
        model = state.model
        model.train()
        with data_parallel(model, group):
            return body(state, model, images_s, label_s, images_t, label_t_prob, regs_t)

    def body(state: TrainState, model, images_s, label_s, images_t, label_t_prob, regs_t):
        with span('step.forward'):
            p_s1, p_s2, feat_s = model(images_s, state.generator)
            p_t1, p_t2, feat_t = model(images_t, state.generator)
            with torch.no_grad():
                with span('step.pseudo_label'):
                    label_t_soft = label_t_prob
                    if refine_label:
                        # the prototypes from before this step's EMA update
                        label_t_soft = label_refine(
                            feat_t.detach(), [p_t1.detach(), p_t2.detach()],
                            label_t_soft, state.prototypes, mode=refine_mode, temp=refine_temp,
                            group=group)
                    label_t_hard = pseudo_selection(label_t_soft, cutoff_top, cutoff_low,
                                                    ignore_label, group)
                    if sam_refine:
                        label_t_hard = homogenize(label_t_hard, regs_t, percent, num_classes,
                                                  ignore_label, MAX_REGIONS, group)
                label_s_down = downscale_label(label_s, 16, num_classes, ignore_label)
                oh_s = one_hot_ignore(label_s_down.reshape(-1), num_classes, ignore_label)
                protos = prototype_update(state.prototypes, _flat(feat_s.detach()),
                                          oh_s, proto_decay, group)

            loss_source, cb_s = src_loss([p_s1, p_s2], label_s, state.class_freq_s)
            loss_target, cb_t, ghm = target_loss([p_t1, p_t2], label_t_hard, label_t_soft,
                                                 state.class_freq_t, state.ghm)
            loss = loss_source + loss_target

        _update(state, loss, group)
        state.prototypes = protos
        state.class_freq_s, state.class_freq_t, state.ghm = cb_s, cb_t, ghm
        state.step += 1
        return {'total': loss.detach(), 'loss_source': loss_source.detach(),
                'loss_target': loss_target.detach()}

    return step
