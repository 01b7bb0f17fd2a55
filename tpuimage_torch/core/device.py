"""Where an entry point runs: on the card unless the caller asks for the
CPU. There is no silent fall back to the host."""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``device``, or ``cuda`` when it is None; raises RuntimeError when
    the card is asked for and there is none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the host")
    return dev


def as_input(x, device=None) -> torch.Tensor:
    """A tensor stays where the caller put it (or goes to an explicit
    ``device``); an array goes to ``resolve_device(device)``."""
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(resolve_device(device))
    arr = np.ascontiguousarray(x)
    if not arr.flags.writeable:        # a read-only buffer (a JAX array's, say): a copy
        arr = arr.copy()
    return torch.from_numpy(arr).to(resolve_device(device))
