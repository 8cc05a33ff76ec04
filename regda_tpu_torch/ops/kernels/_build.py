"""Build the port's CUDA sources with nvcc and load them through ctypes.

The sources in `regda_tpu_torch/csrc/` have a plain C interface, so they
compile in seconds without PyTorch's headers. The shared library goes to
`regda_tpu_torch/_build/` (git-ignored), named by a hash of the sources and
flags, so an edited source rebuilds and an unchanged one loads at once. The
build runs at first use, never on import; a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / 'csrc'
BUILD_DIR = PACKAGE_DIR / '_build'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-lineinfo', '-Xptxas', '-v', '-shared', '-Xcompiler', '-fPIC')

_loaded: dict[Path, ctypes.CDLL] = {}


def find_nvcc() -> str:
    for cand in (os.path.join(os.environ.get('CUDA_HOME', ''), 'bin', 'nvcc'),
                 shutil.which('nvcc') or '', '/usr/local/cuda/bin/nvcc'):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError('nvcc not found (set CUDA_HOME or put nvcc on PATH); '
                       'the CUDA kernels of regda_tpu_torch build at first use')


def library_path(name: str, csrc_dir: Path = CSRC_DIR) -> Path:
    """Where `<csrc_dir>/<name>.cu` builds to, keyed by its sources and flags."""
    digest = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for src in sorted(Path(csrc_dir).glob('*.cu*')):  # the .cu and any .cuh it includes
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f'lib{name}_{digest.hexdigest()[:16]}.so'


def load_library(name: str, csrc_dir: Path = CSRC_DIR) -> ctypes.CDLL:
    """Compile `<csrc_dir>/<name>.cu` (by default this package's) if its
    library is missing, then dlopen it."""
    lib_path = library_path(name, csrc_dir)
    if lib_path in _loaded:
        return _loaded[lib_path]
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
        os.close(fd)
        cmd = [find_nvcc(), *NVCC_FLAGS, '-o', tmp, str(Path(csrc_dir) / f'{name}.cu')]
        res = subprocess.run(cmd, capture_output=True, text=True)
        log = lib_path.with_suffix('.log')
        log.write_text(' '.join(cmd) + '\n' + res.stdout + res.stderr)
        if res.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f'nvcc failed for {name}.cu (rc {res.returncode}):'
                               f'\n{res.stdout}{res.stderr}')
        os.replace(tmp, lib_path)  # atomic: concurrent builders agree
    _loaded[lib_path] = ctypes.CDLL(str(lib_path))
    return _loaded[lib_path]


def build_log(name: str) -> str:
    """nvcc's output for the current build of `name` (ptxas register and
    shared-memory use), or '' if it was not built in this checkout."""
    log = library_path(name).with_suffix('.log')
    return log.read_text() if log.exists() else ''
