"""Classification/regression result containers (reference:
dex-net/src/dexnet/learning/analysis.py:32-194).

The port's own copy of ``pointnetgpd_tpu/learning/analysis.py`` (numpy only).
"""

from __future__ import annotations

import numpy as np


class ConfusionMatrix:
    """Running confusion matrix over integer labels."""

    def __init__(self, num_categories: int):
        self.num_categories = num_categories
        self.matrix = np.zeros((num_categories, num_categories), dtype=np.int64)

    def update(self, predictions, labels):
        for p, t in zip(np.atleast_1d(predictions), np.atleast_1d(labels)):
            self.matrix[int(t), int(p)] += 1

    @property
    def accuracy(self):
        total = self.matrix.sum()
        return float(np.trace(self.matrix)) / max(total, 1)

    def precision(self, category: int) -> float:
        denom = self.matrix[:, category].sum()
        return float(self.matrix[category, category]) / max(denom, 1)

    def recall(self, category: int) -> float:
        denom = self.matrix[category, :].sum()
        return float(self.matrix[category, category]) / max(denom, 1)


class ClassificationResult:
    def __init__(self, pred_probs, labels):
        self.pred_probs = np.asarray(pred_probs)
        self.labels = np.asarray(labels)

    @property
    def predictions(self):
        return np.argmax(self.pred_probs, axis=-1)

    @property
    def accuracy(self):
        return float(np.mean(self.predictions == self.labels))

    @property
    def error_rate(self):
        return 1.0 - self.accuracy

    def top_k_accuracy(self, k: int):
        topk = np.argsort(-self.pred_probs, axis=-1)[:, :k]
        return float(np.mean([t in row for t, row in zip(self.labels, topk)]))

    def confusion_matrix(self):
        cm = ConfusionMatrix(self.pred_probs.shape[-1])
        cm.update(self.predictions, self.labels)
        return cm


class RegressionResult:
    def __init__(self, predictions, targets):
        self.predictions = np.asarray(predictions)
        self.targets = np.asarray(targets)

    @property
    def mse(self):
        return float(np.mean((self.predictions - self.targets) ** 2))

    @property
    def mae(self):
        return float(np.mean(np.abs(self.predictions - self.targets)))

    @property
    def r2(self):
        ss_res = np.sum((self.targets - self.predictions) ** 2)
        ss_tot = np.sum((self.targets - self.targets.mean()) ** 2)
        return float(1.0 - ss_res / max(ss_tot, 1e-16))
