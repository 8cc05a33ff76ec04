"""eval_mfu: the 8 views' forward operations of a tile (perfbench/work/
deeplabv2.py) times the tiles of the traced slice, over its length, as a
share of the card's float32 peak, in %."""

from perfbench.work import bounds, deeplabv2


def read(ctx):
    flops = deeplabv2.eval_tile_flops(ctx.cell.config['model'], ctx.samples['tile'])
    return bounds.mfu_pct(ctx, flops, ctx.cell.config['precision'])
