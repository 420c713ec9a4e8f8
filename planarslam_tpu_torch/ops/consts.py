"""Device-resident constants, uploaded once per (name, device).

A per-frame function that builds a device tensor from a host constant
(``torch.as_tensor(table, device=...)``, ``torch.tensor(1.2, device=...)``)
pays a pageable host-to-device copy on every call. ``const`` keeps one
tensor per (name, device) instead, ``computed`` one that torch computes on
the device; callers never write into what they return.
"""

from __future__ import annotations

from typing import Callable, Hashable, Union

import numpy as np
import torch

_CACHE: dict = {}


def const(name: Hashable, value: Union[np.ndarray, Callable[[], np.ndarray]],
          device) -> torch.Tensor:
    """The tensor of ``value`` on ``device``, built at the first request.
    ``value`` is an array or a function returning one (called only when the
    tensor is not cached yet). ``name`` identifies the value: two different
    values must not share one."""
    key = (name, str(device))
    t = _CACHE.get(key)
    if t is None:
        arr = value() if callable(value) else value
        t = torch.as_tensor(np.asarray(arr), device=device)
        _CACHE[key] = t
    return t


def computed(name: Hashable, fn: Callable[[torch.device], torch.Tensor],
             device) -> torch.Tensor:
    """The tensor ``fn(device)`` computes on ``device``, computed at the
    first request (a table that must carry the bits of torch's own
    operations there). ``name`` identifies the value as for ``const``."""
    key = (name, str(device))
    t = _CACHE.get(key)
    if t is None:
        t = fn(torch.device(device))
        _CACHE[key] = t
    return t


def literal(value, dtype: torch.dtype, device) -> torch.Tensor:
    """The tensor of a number (0-d) or of a tuple of numbers (1-d) on
    ``device``, one per (value, dtype, device)."""
    key = (("literal", value, dtype), str(device))
    t = _CACHE.get(key)
    if t is None:
        t = torch.tensor(value, dtype=dtype, device=device)
        _CACHE[key] = t
    return t
