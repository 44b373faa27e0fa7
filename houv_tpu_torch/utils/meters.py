"""Running-average meter (counterpart of ``houv_tpu/utils/meters.py``)."""

from __future__ import annotations


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
