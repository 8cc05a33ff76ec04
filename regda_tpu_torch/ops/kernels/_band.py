"""The composed resize matrices of one crop frame, dense for the plain
versions and in band form for the stability and mask-stats kernels.

A half-pixel linear interpolation matrix has two taps a row, and the chain
that SAM's mask post-processing composes (low-res -> model frame -> unpad ->
crop size) at most four, all next to each other. The TPU kernels multiply by
the dense matrix because a matrix unit is what that chip has; the CUDA kernels
read, for each output row, the first source index and `TAPS` weights.

The matrices are made on the host as numpy arrays, and so is the band form:
`ResizeFrame` takes them there, once, and uploads both. A matrix with
non-zeros more than `TAPS` apart in a row raises.
"""

from __future__ import annotations

import numpy as np
import torch

TAPS = 4


def band_form_numpy(a: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(rows, n) matrix -> (start (rows,) int32, taps (rows, TAPS) float32) with
    a[r, start[r] + i] == taps[r, i] and every other entry of the row zero."""
    rows, n = a.shape
    if n < TAPS:
        raise ValueError(f'a resize matrix needs at least {TAPS} columns, got {n}')
    nz = a != 0
    first = np.where(nz.any(1), nz.argmax(1), 0)
    last = np.where(nz.any(1), n - 1 - nz[:, ::-1].argmax(1), 0)
    if int((last - first).max(initial=0)) >= TAPS:
        raise ValueError(f'a row of the resize matrix has non-zeros {int((last - first).max())} '
                         f'columns apart; the kernels take at most {TAPS} adjacent taps '
                         f'(a composed half-pixel linear resize has no more)')
    start = np.minimum(first, n - TAPS).astype(np.int32)
    taps = np.take_along_axis(a, start[:, None] + np.arange(TAPS)[None], axis=1)
    return start, np.ascontiguousarray(taps, np.float32)


class ResizeFrame:
    """Resize of (SH, SW) logits to a (ch, cw) frame by m_h (ch, SH) along the
    rows and m_w (cw, SW) along the columns, float32 numpy arrays.

    `m_h`, `m_w` and `m_wt` (SW, cw) are the dense matrices on `device`, which
    the plain versions multiply by. `bands(dtype)` is what the kernels read:
    (h_start, h_taps, w_start, w_taps) on `device`, the band forms of the two
    matrices with their entries rounded to `dtype` first.
    """

    def __init__(self, m_h: np.ndarray, m_w: np.ndarray, device='cpu'):
        m_h, m_w = (np.ascontiguousarray(m, np.float32) for m in (m_h, m_w))
        if m_h.ndim != 2 or m_w.ndim != 2:
            raise ValueError(f'the resize matrices must be 2-D, got {m_h.shape} and {m_w.shape}')
        (self.ch, self.sh), (self.cw, self.sw) = m_h.shape, m_w.shape
        self._host = (m_h, m_w)
        self._bands: dict = {}
        self.m_h = torch.from_numpy(m_h).to(device)
        self.m_w = torch.from_numpy(m_w).to(device)
        self.m_wt = torch.from_numpy(np.ascontiguousarray(m_w.T)).to(device)
        self.device = self.m_h.device
        self.bands(torch.float32)        # a matrix that has no band form raises here

    def bands(self, round_to: torch.dtype) -> tuple[torch.Tensor, ...]:
        if round_to not in self._bands:
            forms = []
            for m in self._host:
                rounded = torch.from_numpy(m).to(round_to).float().numpy()
                forms += [torch.from_numpy(a).to(self.device) for a in band_form_numpy(rounded)]
            self._bands[round_to] = tuple(forms)
        return self._bands[round_to]
