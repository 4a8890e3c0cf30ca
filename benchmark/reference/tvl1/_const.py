"""Host constants on a device, made once a (key, device)."""

from __future__ import annotations

from typing import Callable, Hashable

import numpy as np
import torch

_CACHE: dict = {}


def device_constant(key: Hashable, make: Callable[[], np.ndarray], device) -> torch.Tensor:
    device = torch.device(device)
    hit = _CACHE.get((key, device))
    if hit is None:
        hit = _CACHE[(key, device)] = torch.from_numpy(np.ascontiguousarray(make())).to(device)
    return hit
