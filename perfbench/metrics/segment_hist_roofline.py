"""segment_hist_roofline: the LRH histogram kernel's launches in the traced
slice, their bound (perfbench/work/bounds.py, at the cell's shapes: B
images of N pixels, R region bins, C classes) over their device time, in %."""

from perfbench.work import bounds


def read(ctx):
    s, model = ctx.samples, ctx.cell.config['model']
    bound = bounds.segment_hist_bound_s(s['batch'], s['crop'] ** 2,
                                        ctx.cell.mix['lrh_regions'], model['num_classes'])
    return bounds.roofline_pct(ctx, 'segment_hist', bound)
