"""Running-average meters (counterpart of ``houv_tpu/utils/meters.py``):
``AverageValueMeter`` and ``SplitMeterGrid``, the 2x2 grid of meters by
(rot_level, match_level) that the registration evaluation reports."""

from __future__ import annotations

import numpy as np


class AverageValueMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.sum = 0.0
        self.count = 0

    def update(self, value, n: int = 1):
        self.sum += float(value) * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)


class SplitMeterGrid:
    """Grid of meter dicts indexed by (rot_level, match_level)."""

    def __init__(self, shape=(2, 2),
                 metrics=("RotE", "transE", "MSE", "RMSE", "recall")):
        self.shape = shape
        self.metrics = metrics
        self.grid = [[{m: AverageValueMeter() for m in metrics}
                      for _ in range(shape[1])] for _ in range(shape[0])]

    def reset(self):
        for row in self.grid:
            for meters in row:
                for m in meters.values():
                    m.reset()

    def update(self, rot_level, match_level, values: dict):
        """Per-sample levels (int arrays) and per-sample metric arrays: each
        bucket's meters take the mean of its samples, weighted by their
        count."""
        rot_level = np.asarray(rot_level)
        match_level = np.asarray(match_level)
        for i in range(self.shape[0]):
            for j in range(self.shape[1]):
                sel = (rot_level == i) & (match_level == j)
                n = int(sel.sum())
                if n == 0:
                    continue
                for name, arr in values.items():
                    self.grid[i][j][name].update(
                        float(np.asarray(arr)[sel].mean()), n)

    def logs(self):
        for i in range(self.shape[0]):
            for j in range(self.shape[1]):
                parts = [f"curr_{name}: {m.avg:f}; "
                         for name, m in self.grid[i][j].items()]
                yield f"[rot_level {i}, match_level {j}] " + "".join(parts)
