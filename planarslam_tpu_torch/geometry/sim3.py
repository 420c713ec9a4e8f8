"""Sim(3) similarity transforms on torch tensors.

Port of ``planarslam_tpu/geometry/sim3.py``. A Sim3 is a dict of R
(..., 3, 3), t (..., 3) and s (...), acting as x' = s R x + t; the scale
stays apart from the 4x4 so that the SE(3) helpers still apply to (R, t).
The tangent chart is 7-dof [rho, phi, sigma]. Functions are batched over
leading dimensions.
"""

from __future__ import annotations

import torch

from planarslam_tpu_torch.device import resolve_device
from planarslam_tpu_torch.geometry import se3

_EPS = 1e-8


def make(R, t, s):
    """Pack (R (..., 3, 3), t (..., 3), s (...)) into a Sim3."""
    return {"R": R, "t": t, "s": s}


def identity(dtype=torch.float32, device="cuda"):
    """The identity Sim3 on `device` (the card unless asked for the CPU)."""
    device = resolve_device(device)
    return make(torch.eye(3, dtype=dtype, device=device),
                torch.zeros(3, dtype=dtype, device=device),
                torch.ones((), dtype=dtype, device=device))


def apply(S, pts):
    return (S["s"][..., None, None] * (pts @ S["R"].transpose(-1, -2))
            + S["t"][..., None, :])


def compose(S1, S2):
    """S1 o S2 (S2 applied first)."""
    R = S1["R"] @ S2["R"]
    s = S1["s"] * S2["s"]
    t = S1["s"][..., None] * (S1["R"] @ S2["t"][..., None])[..., 0] + S1["t"]
    return make(R, t, s)


def inverse(S):
    Rt = S["R"].transpose(-1, -2)
    s_inv = 1.0 / torch.clamp(S["s"], min=_EPS)
    t = -s_inv[..., None] * (Rt @ S["t"][..., None])[..., 0]
    return make(Rt, t, s_inv)


def exp(xi):
    """7-dof tangent [rho(3), phi(3), sigma(1)] -> Sim3, with the SE(3)
    translation part (the JAX module's first-order form, exact enough for
    Gauss-Newton steps near the identity)."""
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    T = se3.se3_exp(torch.cat([rho, phi], dim=-1))
    return make(se3.so3_exp(phi), T[..., :3, 3], torch.exp(sigma))


def log(S):
    phi = se3.so3_log(S["R"])
    sigma = torch.log(torch.clamp(S["s"], min=_EPS))
    rho = se3.se3_log(se3.rt_to_T(S["R"], S["t"]))[..., :3]
    return torch.cat([rho, phi, sigma[..., None]], dim=-1)


def from_se3(T, s=None):
    if s is None:
        s = torch.ones(T.shape[:-2], dtype=T.dtype, device=T.device)
    return make(T[..., :3, :3], T[..., :3, 3], s)


def to_se3(S):
    """(R, t) as a 4x4, the scale dropped (RGB-D loops fix it to 1)."""
    return se3.rt_to_T(S["R"], S["t"])
