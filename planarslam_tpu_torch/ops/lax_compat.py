"""Torch counterparts of the JAX reductions whose torch defaults differ.

``top_k`` orders ties lower-index-first as ``lax.top_k`` does (``torch.topk``
promises no tie order). ``nanmedian`` averages the two middle values as
``jnp.nanmedian`` does (``torch.nanmedian`` returns the lower one). ``mod``
is ``jnp.mod`` for floats (fmod, then shifted into the divisor's sign;
``torch.remainder`` rounds differently). ``linspace`` is ``jnp.linspace``'s
formula, start * (1 - t) + stop * t, in float32.
``jax.ops.segment_sum`` becomes an accumulating ``index_put_``: on CUDA
it sorts the indices and sums each segment in one pass, so equal inputs
give equal sums from run to run (``index_add_`` adds with float atomics in
no fixed order).
"""

from __future__ import annotations

import numpy as np
import torch


def top_k(x: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last dim, ties to the
    lower index first."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def nanmedian(x: torch.Tensor) -> torch.Tensor:
    """Median of the non-NaN entries of x, NaN when there are none. No host
    sync: the count and the two middle ranks stay on the device."""
    s, _ = torch.sort(x.reshape(-1))  # NaNs sort to the end
    n = torch.sum(~torch.isnan(s)).to(torch.float32)
    q = 0.5 * (n - 1.0)
    low = torch.floor(q)
    high = torch.ceil(q)
    hw = q - low
    lw = 1.0 - hw
    last = n - 1.0
    low = torch.clamp(torch.minimum(low, last), min=0.0).to(torch.int64)
    high = torch.clamp(torch.minimum(high, last), min=0.0).to(torch.int64)
    return s[low] * lw + s[high] * hw


def mod(x: torch.Tensor, y: float) -> torch.Tensor:
    """jnp.mod(x, y) for float x and a positive scalar y."""
    r = torch.fmod(x, y)
    return torch.where((r != 0) & (r < 0), r + y, r)


def linspace(start: float, stop: float, num: int) -> np.ndarray:
    """jnp.linspace(start, stop, num) (endpoint included) as float32 numpy."""
    f = np.float32
    div = num - 1
    t = (np.arange(div, dtype=f) / f(div)).astype(f)
    out = (f(start) * (f(1) - t) + f(stop) * t).astype(f)
    return np.concatenate([out, [f(stop)]]).astype(f)


def segment_sum(values: torch.Tensor, seg: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """out[s] = sum of values[i] with seg[i] == s (seg in [0, num_segments))."""
    out = torch.zeros((num_segments,) + tuple(values.shape[1:]),
                      dtype=values.dtype, device=values.device)
    return out.index_put_((seg.to(torch.int64),), values, accumulate=True)

