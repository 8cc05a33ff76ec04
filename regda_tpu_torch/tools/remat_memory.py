"""Where the stage-2 step's memory goes on the card, with and without remat.

For each setting, from a fresh seeded state (`entry.stage2_state`,
ResNet-101, C = 6, float32, TF32 off) and one seeded batch of 8 crops of
512^2 a domain: the memory that the train forward of both domains holds for
the backward, then the step's peak over what was resident before it. A
model with `remat=True` keeps only each residual block's input through the
forward and recomputes the rest in the backward, so the first number shows
what remat saves and the second what the step then needs at its worst.

  python -m regda_tpu_torch.tools.remat_memory [--resnet ResNet101]
      [--batch 8] [--size 512]

Prints one line per setting and returns {remat: {'held_gib', 'peak_gib',
'resident_gib'}}. Needs a card: allocator statistics are the card's.
"""

from __future__ import annotations

from argparse import ArgumentParser

import numpy as np
import torch

from regda_tpu_torch.entry import _device, stage2_state, synthetic_stage2_batch
from regda_tpu_torch.utils.tools import disable_tf32


def build_parser() -> ArgumentParser:
    parser = ArgumentParser(description='Stage-2 memory with and without remat.')
    parser.add_argument('--resnet', default='ResNet101')
    parser.add_argument('--batch', type=int, default=8, help='crops a domain')
    parser.add_argument('--size', type=int, default=512)
    parser.add_argument('--seed', type=int, default=8)
    return parser


def measure(device, remat: bool, arrays, resnet: str) -> dict:
    """GiB held by the train forward of both domains, and the step's peak
    over the resident memory before it, from a fresh state."""
    state, step = stage2_state(device, resnet=resnet, remat=remat)
    batch = [torch.from_numpy(a).to(device) for a in arrays]
    torch.cuda.synchronize(device)
    base = torch.cuda.memory_allocated(device)
    outs = [state.model(batch[i], state.generator) for i in (0, 2)]
    held = torch.cuda.memory_allocated(device) - base
    del outs
    state.model.zero_grad(set_to_none=True)
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    step(state, *batch)
    torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device) - base
    del state, step, batch
    torch.cuda.empty_cache()
    return {'held_gib': held / 2**30, 'peak_gib': peak / 2**30, 'resident_gib': base / 2**30}


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    device = _device('cuda')
    disable_tf32()
    arrays = synthetic_stage2_batch(np.random.default_rng(args.seed), args.batch, args.size)
    report = {}
    for remat in (False, True):
        r = report[remat] = measure(device, remat, arrays, args.resnet)
        print(f'[remat_memory] {args.resnet} stage 2, 2x{args.batch}x{args.size}^2 f32, '
              f'{"with" if remat else "without"} remat: the two domains\' train forward holds '
              f'{r["held_gib"]:.2f} GiB, the step peaks {r["peak_gib"]:.2f} GiB over the '
              f'{r["resident_gib"]:.2f} resident')
    return report


if __name__ == '__main__':
    main()
