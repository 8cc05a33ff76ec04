"""Faults planted under the timed path, for the benchmark's own tests and
for `control.py`: each is a context manager that breaks the program in
one way a run must catch (`correct` false).

- `unchanged`: the optimizer's step does nothing, so a train step returns
  its state unchanged;
- `half_batch`: the stage-2 step sees the first half of each batch, its
  means taken over those rows;
- `altered`: every answer of `SegInferencer.predict_labels` has its first
  8 x 8 pixels moved to the next class.

(The cells run on one chip, so no exchange between chips can be left out.)
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(owner, name, value):
    old = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, old)


def unchanged():
    from regda_tpu_torch.train import state
    return _patched(state.PolySGD, 'step', lambda self, closure=None: None)


def half_batch():
    from regda_tpu_torch.train import steps
    make = steps.make_stage2_step

    def make_half(**kw):
        step = make(**kw)
        return lambda state, *arrays: step(state, *(a[:a.shape[0] // 2] for a in arrays))

    return _patched(steps, 'make_stage2_step', make_half)


def altered():
    from regda_tpu_torch import infer
    predict = infer.SegInferencer.predict_labels

    def predict_altered(self, *args, **kw):
        labels = predict(self, *args, **kw).copy()
        labels[..., :8, :8] = (labels[..., :8, :8] + 1) % self.num_classes
        return labels

    return _patched(infer.SegInferencer, 'predict_labels', predict_altered)


FAULTS = {'unchanged': unchanged, 'half_batch': half_batch, 'altered': altered}
