"""Run one cell of the benchmark of `regda_tpu_torch` once, on this machine:

  python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It sets the cell up from the seed, measures
for `--seconds`, checks what the window produced against the plain
reference, and prints the comparisons as the last lines on standard error
and the result as one JSON object on the last line of standard output.
It refuses to run (exit code 2, no result) without as many CUDA devices
as the cell asks for, and fails (exit code 3, no result) where the
process holds JAX, the JAX package or the root `configs` package once the
window has closed.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / 'perfbench' / '.cache'
# the program's kernel caches stay inside the checkout, at fixed paths (its
# nvcc builds already go to regda_tpu_torch/_build/)
os.environ['TRITON_CACHE_DIR'] = str(CACHE / 'triton')
os.environ['TORCH_EXTENSIONS_DIR'] = str(CACHE / 'torch_extensions')
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import harness  # noqa: E402

STARTED = harness.process_start_epoch()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seed', type=int, required=True)
    parser.add_argument('--seconds', type=float, required=True)
    parser.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    cell, bench = harness.load_cell(args.workload, ROOT)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f'perfbench: {args.workload} needs {cell.chips} CUDA device(s); this machine '
              f'has {torch.cuda.device_count() if torch.cuda.is_available() else 0}',
              file=sys.stderr)
        return 2
    result = harness.run_cell(cell, bench, args.seed, args.seconds, bool(args.trace),
                              torch.device('cuda', 0), STARTED)
    loaded = harness.forbidden_modules(sys.modules)
    if loaded:
        print(f'perfbench: the run loaded {loaded}', file=sys.stderr)
        return 3
    harness.print_result(result)
    return 0


if __name__ == '__main__':
    sys.exit(main())
