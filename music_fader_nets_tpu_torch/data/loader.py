"""Fixed-shape batch iteration (copy of
`music_fader_nets_tpu/data/loader.py::batch_iterator`): one numpy gather a
batch, the same numpy shuffle, so a seed gives the JAX package's batch
order."""
from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np


def batch_iterator(arrays: Dict[str, np.ndarray], batch_size: int,
                   shuffle: bool = True, seed: Optional[int] = None,
                   drop_last: bool = True) -> Iterator[Dict[str, np.ndarray]]:
    """Dict batches with leading axis `batch_size`; the last partial batch
    is dropped by default (reference DataLoader, shapes kept static)."""
    n = len(next(iter(arrays.values())))
    idx = np.arange(n)
    if shuffle:
        np.random.default_rng(seed).shuffle(idx)
    end = n - (n % batch_size) if drop_last else n
    for s in range(0, end, batch_size):
        sel = idx[s: s + batch_size]
        yield {k: v[sel] for k, v in arrays.items()}


def num_batches(arrays: Dict[str, np.ndarray], batch_size: int,
                drop_last: bool = True) -> int:
    n = len(next(iter(arrays.values())))
    return n // batch_size if drop_last else -(-n // batch_size)
