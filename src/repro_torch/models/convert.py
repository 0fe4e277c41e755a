"""Weights carried across from the JAX package.

`params_from_numpy` takes the reference's `init_params` output after
``jax.tree.map(np.asarray, ...)`` and gives the port's tree: the same
structure (dicts, lists), the same leaf order and the same dtypes, each leaf
a tensor on ``device``.  ``bfloat16`` leaves (numpy's `ml_dtypes` dtype)
travel as their int16 bits, as in `repro_torch._tree`.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._tree import tree_map

__all__ = ["params_from_numpy"]


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if str(a.dtype) == "bfloat16":
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True, order="C"))
    return t.to(device)


def params_from_numpy(tree, device="cuda"):
    """A tree of numpy arrays -> the same tree of tensors on ``device``."""
    return tree_map(lambda a: _tensor(a, device), tree)
