"""eval_p95_ms: the 95th percentile over all tiles of the window of the
time from the call with the numpy tile to its labels on the host."""

import numpy as np


def read(ctx):
    lat = ctx.samples.get('latencies_s')
    return float(np.percentile(lat, 95)) * 1e3 if lat else None
