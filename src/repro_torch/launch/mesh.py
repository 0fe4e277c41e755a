"""Production mesh construction (a FUNCTION — importing this touches no
device state; devices are only counted when the function is called)."""
from __future__ import annotations

import math

import torch

from repro_torch.distributed.sharding import make_mesh


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """16x16 devices per pod; 2 pods in multi-pod mode (512 devices).

    By default over ``cuda:0 … cuda:n-1``, raising RuntimeError when fewer
    are visible.  ``device`` repeats one device at every position instead:
    ``"meta"`` is the dry run's mesh (`launch/dryrun.py`), the counterpart
    of the reference's 512 forced host devices."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    if device is not None:
        return make_mesh(shape, axes, devices=[device] * n)
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < n:
        raise RuntimeError(
            f"need {n} devices, found {found} — the production mesh is "
            f"{'x'.join(map(str, shape))} CUDA devices in one process")
    return make_mesh(shape, axes, devices=[torch.device("cuda", i) for i in range(n)])
