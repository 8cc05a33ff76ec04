"""Pixel metrics: streaming confusion matrix -> per-class IoU/F1/precision/
recall table with ignorable classes.

The port's copy of regda_tpu/utils/metrics.py: the port imports nothing of the JAX package.

Parity target: regda/gast/metrics.py:19-65 (`PixelMetricIgnore`, itself on
ever's PixelMetric): accumulate a dense confusion matrix, report per-class
iou/f1/precision/recall rounded to 5 decimals, pop ignored class rows
(class 0 for IsprsDA), append a mean row, render as an ASCII table
(prettytable isn't in this image, so a minimal clone lives here).
"""

from __future__ import annotations

import numpy as np


class AsciiTable:
    """Minimal prettytable-compatible renderer."""

    def __init__(self):
        self.field_names: list[str] = []
        self.rows: list[list] = []

    def add_row(self, row):
        self.rows.append([str(x) for x in row])

    def __str__(self):
        cols = [self.field_names] + self.rows
        widths = [max(len(r[i]) for r in cols) for i in range(len(self.field_names))]
        sep = '+' + '+'.join('-' * (w + 2) for w in widths) + '+'
        def fmt(row):
            return '| ' + ' | '.join(s.center(w) for s, w in zip(row, widths)) + ' |'
        lines = [sep, fmt(self.field_names), sep]
        lines += [fmt(r) for r in self.rows]
        lines.append(sep)
        return '\n'.join(lines)


class PixelMetricIgnore:
    def __init__(self, num_classes: int, class_names=None, logdir=None,
                 logger=None, ignore_labels=()):
        self.num_classes = num_classes
        self._class_names = list(class_names) if class_names else None
        self.logger = logger
        self.ignore_labels = sorted(ignore_labels, reverse=True)
        self._cm = np.zeros((num_classes, num_classes), np.int64)

    def forward(self, y_true: np.ndarray, y_pred: np.ndarray):
        y_true = np.asarray(y_true).ravel()
        y_pred = np.asarray(y_pred).ravel()
        ok = (y_true >= 0) & (y_true < self.num_classes)
        idx = y_true[ok] * self.num_classes + y_pred[ok]
        self._cm += np.bincount(idx, minlength=self.num_classes ** 2
                                ).reshape(self.num_classes, self.num_classes)

    @property
    def confusion_matrix(self):
        return self._cm.copy()

    def summary_all(self, dec: int = 5):
        cm = self._cm.astype(np.float64)
        tp = np.diag(cm)
        fp = cm.sum(axis=0) - tp
        fn = cm.sum(axis=1) - tp
        with np.errstate(divide='ignore', invalid='ignore'):
            iou = tp / (tp + fp + fn)
            precision = tp / (tp + fp)
            recall = tp / (tp + fn)
            f1 = 2 * precision * recall / (precision + recall)
        iou = np.round(np.nan_to_num(iou), dec).tolist()
        f1 = np.round(np.nan_to_num(f1), dec).tolist()
        precision = np.round(np.nan_to_num(precision), dec).tolist()
        recall = np.round(np.nan_to_num(recall), dec).tolist()
        class_names = list(self._class_names) if self._class_names else None

        for idx in self.ignore_labels:
            for lst in (iou, f1, precision, recall):
                lst.pop(idx)
            if class_names:
                class_names.pop(idx)

        miou = float(np.round(np.mean(iou), dec))
        mf1 = float(np.round(np.mean(f1), dec))
        mprec = float(np.round(np.mean(precision), dec))
        mrecall = float(np.round(np.mean(recall), dec))

        tb = AsciiTable()
        if class_names:
            tb.field_names = ['name', 'class', 'iou', 'f1', 'precision', 'recall']
            for i, (a, b, c, d) in enumerate(zip(iou, f1, precision, recall)):
                tb.add_row([class_names[i], i, a, b, c, d])
            tb.add_row(['', 'mean', miou, mf1, mprec, mrecall])
        else:
            tb.field_names = ['class', 'iou', 'f1', 'precision', 'recall']
            for i, (a, b, c, d) in enumerate(zip(iou, f1, precision, recall)):
                tb.add_row([i, a, b, c, d])
            tb.add_row(['mean', miou, mf1, mprec, mrecall])

        if self.logger is not None:
            self.logger.info('\n' + str(tb))
        return tb, miou
