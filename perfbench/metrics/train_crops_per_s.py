"""train_crops_per_s: the 512^2 crops (source and target) of every step
completed in the window over the window's seconds; the window ends in a
synchronize."""


def read(ctx):
    s = ctx.samples
    return s['crops'] / s['window_s'] if 'crops' in s and s['window_s'] > 0 else None
