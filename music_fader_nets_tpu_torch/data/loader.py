"""Fixed-shape batch iteration (copy of
`music_fader_nets_tpu/data/loader.py::batch_iterator`): one numpy gather a
batch, the same numpy shuffle, so a seed gives the JAX package's batch
order; and each process's shard of a corpus for data-parallel training."""
from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np
import torch.distributed as dist


def shard_arrays_for_process(arrays: Dict[str, np.ndarray],
                             process_index: Optional[int] = None,
                             process_count: Optional[int] = None
                             ) -> Dict[str, np.ndarray]:
    """This process's shard of a corpus dict (JAX :16-46): a contiguous
    slice of n // process_count items, so every rank yields the same
    number of fixed-shape batches, as the lockstep collectives of a
    data-parallel step need; the < process_count remainder is dropped on
    every rank. The index and count default to the rank and world size of
    the initialised default process group; without one, or with one
    process, the arrays come back unchanged. On a mesh with a model axis
    pass the mesh's `data_index` and `n_data`: the ranks of a model group
    share their rows. Raises ValueError when a shard would be empty."""
    live = dist.is_available() and dist.is_initialized()
    pc = process_count if process_count is not None else (
        dist.get_world_size() if live else 1)
    pi = process_index if process_index is not None else (
        dist.get_rank() if live else 0)
    if pc <= 1:
        return arrays
    n = len(next(iter(arrays.values())))
    per = n // pc
    if per == 0:
        raise ValueError(f"corpus of {n} items cannot be sharded over "
                         f"{pc} processes")
    start = pi * per
    return {k: v[start: start + per] for k, v in arrays.items()}


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
