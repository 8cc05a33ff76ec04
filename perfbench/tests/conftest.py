"""The benchmark's own tests: `python -m pytest perfbench/tests -q` from
the root of the repository (on the CPU; the tests marked `cuda` run on a
card with `-m cuda` and skip elsewhere)."""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench.harness import load_json  # noqa: E402

TINY_MODEL = {'backbone': 'resnet18', 'fc_dim': 512}
# cell -> (its traffic mix, the mix, its limits, the cell it stands in for)
TINY_CELLS = {
    'tiny_stage2': ('stage2_tiny', {'runner': 'stage_step', 'batch': 2, 'crop': 64, 'pool': 3,
                                    'max_region_id': 30, 'lrh_regions': 1024,
                                    'checked_steps': 3, 'trace_items': 2},
                    {'loss_gap': 1e-4, 'grad_gap': 0.05, 'change_gap': 0.05},
                    'r101_stage2_step'),
    'tiny_eval': ('tta_tiny', {'runner': 'eval_tta', 'tile': 64, 'pool': 3, 'warmup': 1,
                               'trace_items': 3},
                  {'prob_gap': 1e-4}, 'r101_eval_tta'),
}


def pytest_configure(config):
    config.addinivalue_line('markers', 'cuda: needs a CUDA device (skips without one); '
                                       'run on the card with `-m cuda`')


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip('no CUDA device')
    return torch.device('cuda', 0)


def add_tiny_cells(root: Path) -> None:
    """Add, as data files and BENCHMARK.json entries alone, a tiny
    configuration (ResNet-18 at 64 px) and a cell of each traffic kind."""
    bench = load_json(root / 'BENCHMARK.json')
    config = load_json(root / 'perfbench/configs/deeplabv2-r101-regda.json')
    config['name'] = 'deeplabv2-r18-tiny'
    config['model'].update(TINY_MODEL)
    config['eval'].update(tile=64, stride=32)
    (root / 'perfbench/configs/deeplabv2-r18-tiny.json').write_text(
        json.dumps(config))
    bench['configs'].append({'name': 'deeplabv2-r18-tiny', 'source': 'https://example.org/tiny',
                             'file': 'perfbench/configs/deeplabv2-r18-tiny.json',
                             'reduced': ['backbone'], 'why': 'CPU tests'})
    for cell, (traffic, mix, limits, like) in TINY_CELLS.items():
        (root / f'perfbench/traffic/{traffic}.json').write_text(json.dumps(mix))
        (root / f'perfbench/limits/{cell}.json').write_text(json.dumps(limits))
        bench['workloads'].append({'name': cell, 'config': 'deeplabv2-r18-tiny',
                                   'traffic': traffic, 'chips': 1, 'why': 'CPU tests'})
        for m in bench['end_to_end'] + bench['per_layer']:
            if like in m.get('workloads', []):
                m['workloads'].append(cell)
    (root / 'BENCHMARK.json').write_text(json.dumps(bench))


@pytest.fixture(scope='session')
def tiny_root(tmp_path_factory) -> Path:
    """A copy of BENCHMARK.json and perfbench/ with the tiny cells added."""
    root = tmp_path_factory.mktemp('bench')
    shutil.copy(ROOT / 'BENCHMARK.json', root / 'BENCHMARK.json')
    shutil.copytree(ROOT / 'perfbench', root / 'perfbench',
                    ignore=shutil.ignore_patterns('.cache', '__pycache__', 'tests'))
    add_tiny_cells(root)
    return root
