"""Accuracy-parity evidence for the port: stages 1 -> 2 -> 3 + ablations on
`parity_smoke`, with the mIoU trajectory written to PARITY_torch.md.

The port's counterpart of tools/run_parity.py, with the same flags; the JAX
script's `--tpu` is `--device` here (default cuda), passed to every stage.
Each stage runs the port's own CLI as a process of its own, `python -m
regda_tpu_torch.tools.{train_src,init_prototypes,train_align_reg,
train_ssl_reg}` on `st.regda.parity_smoke` (the learnable synthetic set:
a real domain gap, region maps aligned with the label cells), in the
working tree REGDA_PARITY_ROOT (default: regda_parity_torch under the
temporary directory), and reads each run's best mIoU from its
`Vaihingen_state.pth.json`. The orderings the table tests:

    stage1 (source only)            < stage2 (align + refine + LRH)
    stage2 no-LRH                  <= stage2 with LRH
    stage2 no-refine no-LRH        <= stage2 full
    stage3 (self-training)         >= stage2

    python -m regda_tpu_torch.tools.run_parity --steps 600

The table, with each stage's seconds and the device, goes to
`<out>/PARITY_torch.md` and the numbers to `<out>/parity_results_torch.json`
(`--out`, default the repository's root); `--mechanism` and `--lrh-seeds`
replace their own section of PARITY_torch.md.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

from regda_tpu_torch.entry import _device

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CONFIG = 'st.regda.parity_smoke'
MARKDOWN, RESULTS = 'PARITY_torch.md', 'parity_results_torch.json'


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description='Multi-stage mIoU trajectory of the port.')
    ap.add_argument('--steps', type=int, default=200)
    ap.add_argument('--device', type=str, default='cuda')
    ap.add_argument('--out', type=str, default=REPO,
                    help=f'directory of {MARKDOWN} and {RESULTS}')
    ap.add_argument('--fresh', action='store_true', help='wipe the parity workspace first')
    ap.add_argument('--start-at', default='src',
                    choices=['src', 'align', 'align-ablations', 'ssl'],
                    help='skip stages already completed in the workspace')
    ap.add_argument('--lrh-seeds', type=int, default=0,
                    help='instead of the pipeline, rerun the stage-2 full-vs-no-LRH '
                         'pair for N seeds (from the existing stage-1 checkpoint) and '
                         'write a seed-variance section')
    ap.add_argument('--mechanism', action='store_true',
                    help='instead of the pipeline, score the pseudo-label pipeline '
                         'before/after LRH against ground truth (lrh_mechanism, from '
                         'the existing stage-1 checkpoint) and write its section')
    ap.add_argument('--only-src', action='store_true',
                    help='stop after stage 1 + prototype init')
    ap.add_argument('--section-label', default='',
                    help='suffix for the section written by --lrh-seeds / --mechanism')
    return ap


class Runner:
    """Runs the port's CLIs as processes in one parity workspace and keeps
    each run's wall seconds."""

    def __init__(self, root: str, device: str, steps: int):
        self.root, self.device, self.steps = root, device, steps
        self.env = dict(os.environ, REGDA_PARITY_ROOT=root)
        self.env['PYTHONPATH'] = os.pathsep.join(
            p for p in (REPO, os.environ.get('PYTHONPATH')) if p)
        self.seconds: dict[str, float] = {}

    def stage(self, tool: str, extra, tag: str = '', env=None):
        env = dict(env or self.env, REGDA_PARITY_TAG=tag, REGDA_PARITY_STEPS=str(self.steps))
        cmd = [sys.executable, '-m', f'regda_tpu_torch.tools.{tool}',
               '--config-path', CONFIG, *extra, '--device', self.device]
        print('+', ' '.join(cmd), f'[tag={tag!r}]', flush=True)
        t0 = time.perf_counter()
        subprocess.run(cmd, check=True, cwd=REPO, env=env)
        self.seconds[f'{tool}{tag}'] = self.seconds.get(f'{tool}{tag}', 0.0) + (
            time.perf_counter() - t0)

    def miou(self, tag: str, stage_dir: str) -> tuple[float, int]:
        path = os.path.join(self.root, 'log' + tag, stage_dir, 'Vaihingen_state.pth.json')
        with open(path) as f:
            meta = json.load(f)
        return float(meta['mIoU_max']), int(meta['iter_max'])


def device_line(device: str) -> str:
    """The device a run used: the card's name and power limit as nvidia-smi
    gives them, or the device's name."""
    if not device.startswith('cuda'):
        return device
    try:
        out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                              '--format=csv,noheader'], capture_output=True,
                             text=True, check=True).stdout.strip().splitlines()
        return out[0]
    except (OSError, subprocess.CalledProcessError, IndexError):
        import torch
        return f'{torch.cuda.get_device_name(0)}, power limit not read'


def replace_section(body: str, heading: str, section_lines) -> str:
    """Replace (or append) the `## heading` section, leaving every other
    section intact (matched on the full heading line)."""
    marker = f'\n## {heading}\n'
    if marker in body:
        start = body.index(marker)
        nxt = body.find('\n## ', start + 1)
        body = body[:start] + (body[nxt:] if nxt != -1 else '\n')
    return body.rstrip('\n') + '\n' + '\n'.join(section_lines)


def _write_section(out: str, heading: str, section) -> None:
    path = os.path.join(out, MARKDOWN)
    body = open(path).read() if os.path.exists(path) else '# PARITY_torch\n'
    with open(path, 'w') as f:
        f.write(replace_section(body, heading, section))
    print('\n'.join(section))


def mechanism(args, run: Runner, src_log: str, device: str) -> None:
    out = os.path.join(run.root, 'lrh_mechanism.json')
    cmd = [sys.executable, '-m', 'regda_tpu_torch.tools.lrh_mechanism',
           '--config-path', CONFIG, '--ckpt-model', f'{src_log}/src/Vaihingen_best.pth',
           '--ckpt-proto', f'{src_log}/src/prototypes_best.npy', '--json-out', out,
           '--device', args.device]
    print('+', ' '.join(cmd), flush=True)
    subprocess.run(cmd, check=True, cwd=REPO, env=run.env)
    with open(out) as f:
        m = json.load(f)
    b, a, t = m['before'], m['after'], m['transitions']
    heading = 'LRH mechanism (pseudo-label quality vs ground truth)'
    if args.section_label:
        heading += f' ({args.section_label})'
    _write_section(args.out, heading, [
        '', f'## {heading}', '',
        'The stage-2 pipeline (refine -> pseudo_selection -> homogenize) scored '
        'against ground truth on the target train tiles, stage-1 checkpoint '
        f'(`regda_tpu_torch/tools/lrh_mechanism.py`), on {device}:', '',
        '| stage | coverage | acc on labeled px |', '|---|---|---|',
        f"| before LRH | {b['coverage']:.3f} | {b['acc_labeled']:.3f} |",
        f"| after LRH | {a['coverage']:.3f} | {a['acc_labeled']:.3f} |", '',
        f"- pixels LRH flipped (n={t['flipped']['n']}): accuracy "
        f"{t['flipped']['acc_before']:.3f} -> {t['flipped']['acc_after']:.3f};",
        f"- pixels LRH filled (ignore -> class, n={t['filled']['n']}): "
        f"{t['filled']['acc']:.3f} accurate;",
        f"- pixels LRH dropped (class -> ignore, n={t['dropped']['n']}): "
        f"{t['dropped']['acc_before']:.3f} accurate before.", '',
        'Reproduce: `python -m regda_tpu_torch.tools.run_parity --mechanism`'
        + (f' --section-label "{args.section_label}"' if args.section_label else '') + '.',
        ''])


def lrh_seeds(args, run: Runner, src_log: str, device: str) -> None:
    s2_common = ['--ckpt-model', f'{src_log}/src/Vaihingen_best.pth',
                 '--ckpt-proto', f'{src_log}/src/prototypes_best.npy', '--align-domain', '1']
    pairs = []
    for seed in range(args.lrh_seeds):
        env = dict(run.env, REGDA_SEED=str(2333 + 101 * seed))
        run.stage('train_align_reg', s2_common + ['--refine-label', '1', '--sam-refine',
                                                  '--percent', '0.5'], f'-s{seed}', env)
        run.stage('train_align_reg', s2_common + ['--refine-label', '1'],
                  f'-s{seed}-nolrh', env)
        full, _ = run.miou(f'-s{seed}', 'align')
        nolrh, _ = run.miou(f'-s{seed}-nolrh', 'align')
        pairs.append((full, nolrh))
        print(f'seed {seed}: full={full:.4f} no-lrh={nolrh:.4f} '
              f'delta={full - nolrh:+.4f}', flush=True)
    d = np.asarray([f - n for f, n in pairs])
    heading = 'LRH ablation, seed variance'
    if args.section_label:
        heading += f' ({args.section_label})'
    _write_section(args.out, heading, [
        '', f'## {heading}', '',
        f'Stage-2 full vs no-LRH over {len(d)} seeds (steps={run.steps}, same '
        f'stage-1 checkpoint), on {device}:', '',
        '| seed | full | no-LRH | delta |', '|---|---|---|---|',
        *[f'| {i} | {f:.4f} | {n:.4f} | {f - n:+.4f} |' for i, (f, n) in enumerate(pairs)],
        '', f'- mean delta {d.mean():+.4f}, std {d.std():.4f}.', '',
        f'Reproduce: `python -m regda_tpu_torch.tools.run_parity --lrh-seeds {len(d)} '
        f'--steps {run.steps} --start-at align`.', ''])


def main(argv=None) -> dict | None:
    """Returns the pipeline's results (None for --mechanism / --lrh-seeds)."""
    args = build_parser().parse_args(argv)
    _device(args.device)      # no card: refuse before any stage starts
    root = os.environ.get('REGDA_PARITY_ROOT',
                          os.path.join(tempfile.gettempdir(), 'regda_parity_torch'))
    if args.fresh and os.path.isdir(root):
        shutil.rmtree(root)
    os.makedirs(args.out, exist_ok=True)
    run = Runner(root, args.device, args.steps)
    device = device_line(args.device)
    src_log = os.path.join(root, 'log')
    at = ['src', 'align', 'align-ablations', 'ssl'].index(args.start_at)

    if args.mechanism:
        mechanism(args, run, src_log, device)
        return None
    if args.lrh_seeds:
        lrh_seeds(args, run, src_log, device)
        return None

    t0 = time.perf_counter()
    if at <= 0:
        run.stage('train_src', ['--align-domain', '1'])
        run.stage('init_prototypes', ['--ckpt-model', f'{src_log}/src/Vaihingen_best.pth',
                                      '--ckpt-proto', f'{src_log}/src/prototypes_best',
                                      '--stage', '1'])
    if args.only_src:
        miou, it = run.miou('', 'src')
        print(f'stage-1 only: best mIoU {miou:.4f} at iter {it} (workspace {root})')
        return None

    s2_common = ['--ckpt-model', f'{src_log}/src/Vaihingen_best.pth',
                 '--ckpt-proto', f'{src_log}/src/prototypes_best.npy', '--align-domain', '1']
    if at <= 1:
        run.stage('train_align_reg', s2_common + ['--refine-label', '1', '--sam-refine',
                                                  '--percent', '0.5'])
    if at <= 2:
        run.stage('train_align_reg', s2_common + ['--refine-label', '1'], '-nolrh')
        run.stage('train_align_reg', s2_common + ['--refine-label', '0'], '-norefine')

    # stage 3 from the full stage 2, its prototypes recomputed on that model
    run.stage('init_prototypes', ['--ckpt-model', f'{src_log}/align/Vaihingen_best.pth',
                                  '--ckpt-proto', f'{src_log}/align/prototypes_best',
                                  '--stage', '2'])
    run.stage('train_ssl_reg', ['--ckpt-model', f'{src_log}/align/Vaihingen_best.pth',
                                '--ckpt-proto', f'{src_log}/align/prototypes_best.npy',
                                '--gen', '1', '--refine-label', '1', '--sam-refine',
                                '--percent', '0.5'])
    total = time.perf_counter() - t0

    rows = [('stage 1 (source-only, CORAL)', 'stage1_source_only', '', 'src', 'train_src'),
            ('stage 2 full (refine + LRH + PCL)', 'stage2_full', '', 'align',
             'train_align_reg'),
            ('stage 2, no LRH (`--sam-refine` off)', 'stage2_no_lrh', '-nolrh', 'align',
             'train_align_reg-nolrh'),
            ('stage 2, no refine/LRH (`--refine-label 0`)', 'stage2_no_refine', '-norefine',
             'align', 'train_align_reg-norefine'),
            ('stage 3 (self-training from stage-2 full)', 'stage3_ssl', '', 'ssl',
             'train_ssl_reg')]
    results = {key: run.miou(tag, d) for _, key, tag, d, _ in rows}
    with open(os.path.join(args.out, RESULTS), 'w') as f:
        json.dump({'steps_per_stage': args.steps, 'device': device,
                   'seconds': {**run.seconds, 'total': total},
                   **{k: {'mIoU': v[0], 'iter': v[1]} for k, v in results.items()}},
                  f, indent=2)

    s1, s2 = results['stage1_source_only'][0], results['stage2_full'][0]
    s2n, s3 = results['stage2_no_lrh'][0], results['stage3_ssl'][0]
    lines = [
        '# PARITY_torch — multi-stage mIoU trajectory of the port (synthetic smoke evidence)',
        '',
        'The port\'s stage CLIs (`python -m regda_tpu_torch.tools.*`) chained as the '
        'recipe chains them, on the learnable `parity_smoke` set '
        '(`regda_tpu_torch/configs/st/regda/parity_smoke.py`): the counterpart of '
        'PARITY.md, which holds the JAX package\'s run.',
        '',
        f'Steps per stage: {args.steps}; model resnet18; 64px tiles; target-domain val '
        f'mIoU (best over the run); device: {device}.',
        '',
        '| pipeline stage | best target mIoU | at iter | seconds (process) |',
        '|---|---|---|---|',
        *[f'| {label} | {results[key][0]:.4f} | {results[key][1]} | '
          + (f'{run.seconds[sec]:.1f} |' if sec in run.seconds else 'not run here |')
          for label, key, _, _, sec in rows],
        '',
        f'Prototype passes: {run.seconds.get("init_prototypes", 0.0):.1f} s; the whole '
        f'pipeline {total:.1f} s.',
        '',
        '## Reading',
        '',
        f'- adaptation gain (stage 2 full vs stage 1): **{s2 - s1:+.4f}**',
        f'- LRH contribution (stage 2 full vs no-LRH): **{s2 - s2n:+.4f}**',
        f'- self-training gain (stage 3 vs stage 2): **{s3 - s2:+.4f}**',
        '',
        f'Reproduce: `python -m regda_tpu_torch.tools.run_parity --steps {args.steps} '
        f'--device {args.device}`.',
        '',
    ]
    with open(os.path.join(args.out, MARKDOWN), 'w') as f:
        f.write('\n'.join(lines))
    print('\n'.join(lines))
    return results


if __name__ == '__main__':
    main()
