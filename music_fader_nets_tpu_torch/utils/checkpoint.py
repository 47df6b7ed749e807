"""Parameter trees between numpy and the port's tensors.

The port keeps the JAX package's parameter tree — the same nested dict
names, the same input-major layouts — so a JAX params tree converts with
`params_from_numpy(jax.tree.map(np.asarray, params), device)` and back with
`params_to_numpy`, copying values and changing nothing else.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch


def params_from_numpy(tree: Any, device="cpu") -> Any:
    """Nested dict (or list/tuple) of numpy arrays -> the same structure of
    tensors on `device`; float arrays become float32."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device) for v in tree)
    arr = np.asarray(tree)
    if np.issubdtype(arr.dtype, np.floating):
        arr = arr.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def params_to_numpy(tree: Any) -> Any:
    """Inverse of `params_from_numpy`: tensors -> numpy arrays on the host."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_to_numpy(v) for v in tree)
    return tree.detach().cpu().numpy()


def tree_to(tree: Any, device) -> Any:
    """Move every tensor of a nested dict/list to `device` (no copy where a
    tensor already lies there)."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to(v, device) for v in tree)
    return tree.to(device)
