"""train_mfu: the stage-2 step's operations (perfbench/work/deeplabv2.py,
from the configuration's shapes) times the steps of the traced slice, over
its length, as a share of the card's float32 peak (the precision the
configuration states), in %."""

from perfbench.work import bounds, deeplabv2


def read(ctx):
    model, s = ctx.cell.config['model'], ctx.samples
    flops = deeplabv2.stage2_step_flops(model, s['batch'], s['crop'], s['crop'])
    return bounds.mfu_pct(ctx, flops, ctx.cell.config['precision'])
