"""Batching and sharding (counterpart of ``houv_tpu/data/pipeline.py``):
a numpy batch iterator over any dataset with ``__len__`` and ``get_batch``,
and the reference's contiguous [l, r) dataset sharding."""

from __future__ import annotations

from typing import Iterator

import numpy as np


def shard_ranges(total: int, n_shards: int) -> list[tuple[int, int]]:
    """Split [0, total) into n_shards near-equal contiguous ranges."""
    base, rem = divmod(total, n_shards)
    out = []
    start = 0
    for i in range(n_shards):
        size = base + (1 if i < rem else 0)
        out.append((start, start + size))
        start += size
    return out


def batch_iterator(
    dataset,
    batch_size: int,
    *,
    shuffle: bool = False,
    drop_last: bool = False,
    pad_last: bool = False,
    seed: int | None = None,
    rng: np.random.Generator | None = None,
) -> Iterator[dict]:
    """Yield batch dicts; each gains 'valid', the count of real rows.

    ``pad_last`` repeats the final indices up to ``batch_size`` so every
    batch has one shape; ``drop_last`` drops a short final batch."""
    n = len(dataset)
    order = np.arange(n)
    rng = rng or np.random.default_rng(seed)
    if shuffle:
        rng.shuffle(order)
    for start in range(0, n, batch_size):
        idx = order[start:start + batch_size]
        valid = len(idx)
        if valid < batch_size:
            if drop_last:
                return
            if pad_last:
                idx = np.resize(idx, batch_size)
        batch = dataset.get_batch(idx, rng=rng)
        batch["valid"] = np.asarray(valid, np.int32)
        yield batch
