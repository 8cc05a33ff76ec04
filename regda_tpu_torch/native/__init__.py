"""ctypes binding of the native tile-loading pipeline (the port's copy of
regda_tpu/native/__init__.py; the source, `regda_native.cpp`, sits beside
this file).

The shared library is built with g++ at first use into the git-ignored
`regda_tpu_torch/_build/`, named by a hash of the source and the command, so
an edited source rebuilds and an unchanged one loads at once. The build
writes a temporary file and renames it into place, so processes that build
at the same time never load a half-written library. Where g++ or libpng is
missing, `available()` is False and the loader takes the Python path: both
paths consume the same RNG decisions, so their batches are bit-identical
(tests/test_torch_data.py). This is a host decode path, not a device kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().with_name('regda_native.cpp')
BUILD_DIR = SRC.parents[1] / '_build'
CXX_FLAGS = ('-O3', '-shared', '-fPIC')
LIBS = ('-lpng', '-lz', '-pthread')

_lock = threading.Lock()
_lib = None
_failed = False


def library_path() -> Path:
    digest = hashlib.sha256(' '.join(CXX_FLAGS + LIBS).encode())
    digest.update(SRC.read_bytes())
    return BUILD_DIR / f'libregda_native_{digest.hexdigest()[:16]}.so'


def _build(lib_path: Path) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
    os.close(fd)
    cmd = ['g++', *CXX_FLAGS, '-o', tmp, str(SRC), *LIBS]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        os.unlink(tmp)
        return False
    os.replace(tmp, lib_path)   # atomic: concurrent builders agree
    return True


def _load():
    global _lib, _failed
    with _lock:
        if _lib is not None or _failed:
            return _lib
        lib_path = library_path()
        if not lib_path.exists() and not _build(lib_path):
            _failed = True
            return None
        try:
            lib = ctypes.CDLL(str(lib_path))
        except OSError:
            _failed = True
            return None
        i32p = ctypes.POINTER(ctypes.c_int32)
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.rn_decode_png.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            i32p, i32p, i32p]
        lib.rn_decode_png.restype = ctypes.c_int
        lib.rn_load_batch.argtypes = [
            ctypes.c_int, ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(i32p),
            i32p, f32p, f32p, ctypes.c_float,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            f32p, i32p, i32p, ctypes.c_int]
        lib.rn_load_batch.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def decode_png(path: str, max_bytes: int = 512 * 512 * 4 * 4) -> np.ndarray:
    lib = _load()
    if lib is None:
        raise RuntimeError('the native library is not available')
    buf = np.empty(max_bytes, np.uint8)
    h = ctypes.c_int32()
    w = ctypes.c_int32()
    c = ctypes.c_int32()
    rc = lib.rn_decode_png(
        path.encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        max_bytes, ctypes.byref(h), ctypes.byref(w), ctypes.byref(c))
    if rc < 0:
        raise IOError(f'rn_decode_png({path}) -> {rc}')
    arr = buf[:rc].reshape(h.value, w.value, c.value)
    return arr[..., 0] if c.value == 1 else arr.copy()


def load_batch(img_paths, mask_paths, sups, params: np.ndarray,
               mean, std, clamp: bool, offset: int, num_classes: int,
               ignore_label: int, crop: int, nthreads: int = 4):
    """Decode + fused-augment a batch.

    Args:
      img_paths: list[str]. mask_paths: list[str] | None.
      sups: list of (H, W) int32 arrays or None (pre-decoded region maps).
      params: (n, 6) int32 [x0, y0, crop, hflip, vflip, rotk] per sample.
      mean/std: 3-vectors in 0-255 units; clamp: min(img, 1.0) after norm.
    Returns (img (n,crop,crop,3) f32, mask (n,crop,crop) i32 | None,
             sup (n,crop,crop) i32 | None).
    """
    lib = _load()
    if lib is None:
        raise RuntimeError('the native library is not available')
    n = len(img_paths)
    params = np.ascontiguousarray(params, np.int32)
    if params.shape != (n, 6):
        raise ValueError(f'params {params.shape} for {n} images; expected ({n}, 6)')
    i32p = ctypes.POINTER(ctypes.c_int32)

    c_img = (ctypes.c_char_p * n)(*[p.encode() for p in img_paths])
    c_msk = None
    out_mask = None
    if mask_paths is not None:
        c_msk = (ctypes.c_char_p * n)(*[p.encode() for p in mask_paths])
        out_mask = np.empty((n, crop, crop), np.int32)
    c_sup = None
    out_sup = None
    sup_arrays = []  # keep references alive
    if sups is not None:
        c_sup = (i32p * n)()
        for i, s in enumerate(sups):
            s = np.ascontiguousarray(s, np.int32)
            sup_arrays.append(s)
            c_sup[i] = s.ctypes.data_as(i32p)
        out_sup = np.empty((n, crop, crop), np.int32)

    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    out_img = np.empty((n, crop, crop, 3), np.float32)

    f32p = ctypes.POINTER(ctypes.c_float)
    rc = lib.rn_load_batch(
        n, c_img, c_msk, c_sup,
        params.ctypes.data_as(i32p),
        mean.ctypes.data_as(f32p), std.ctypes.data_as(f32p),
        ctypes.c_float(1.0 if clamp else -1e38),
        offset, num_classes, ignore_label, crop,
        out_img.ctypes.data_as(f32p),
        out_mask.ctypes.data_as(i32p) if out_mask is not None else None,
        out_sup.ctypes.data_as(i32p) if out_sup is not None else None,
        nthreads)
    if rc != 0:
        raise IOError(f'rn_load_batch -> {rc}')
    return out_img, out_mask, out_sup
