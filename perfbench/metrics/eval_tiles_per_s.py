"""eval_tiles_per_s: the tiles whose labels reached the host in the window
over the window's seconds."""


def read(ctx):
    s = ctx.samples
    return s['tiles'] / s['window_s'] if 'tiles' in s and s['window_s'] > 0 else None
