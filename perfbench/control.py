"""Readings that the limits of a cell's check are set from; the benchmark's
own runs never run this. On the chip, from the root of a checkout:

  python3 perfbench/control.py --workload <cell> --seeds 1 2 3 --what control
  python3 perfbench/control.py --workload <cell> --seeds 4 5 6 --what half_batch

`--what control` reads the control: the plain reference, computed in the
precision below the one the configuration states, in the program's place.
`--what sound` runs the program as a run does (set-up, a window of
`--seconds`, the check) and `--what <fault>` the same with a fault of
`perfbench/faults.py` planted. Each seed prints one JSON line of the
numbers the check compares.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import faults, harness  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seeds', type=int, nargs='+', required=True)
    parser.add_argument('--what', required=True, choices=['control', 'sound', *faults.FAULTS])
    parser.add_argument('--seconds', type=float, default=0.0)
    args = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print('control.py reads on the card; none found', file=sys.stderr)
        return 2
    cell, bench = harness.load_cell(args.workload, ROOT)
    device = torch.device('cuda', 0)
    for seed in args.seeds:
        t0 = time.time()
        if args.what == 'control':
            numbers = cell.runner().control(cell, seed, device)
        else:
            fault = faults.FAULTS.get(args.what)
            with fault() if fault else contextlib.nullcontext():
                result = harness.run_cell(cell, bench, seed, args.seconds, False, device, t0)
            numbers = {k: v['value'] for k, v in result['checks'].items()}
            numbers['correct'] = result['correct']
            numbers['attempted'] = result['attempted']
        print(json.dumps({'workload': args.workload, 'what': args.what, 'seed': seed,
                          'seconds': round(time.time() - t0, 3), **numbers}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == '__main__':
    sys.exit(main())
