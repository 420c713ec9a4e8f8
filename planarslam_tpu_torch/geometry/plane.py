"""Minimal plane parameterization and structural residuals.

Port of ``planarslam_tpu/geometry/plane.py``: planes are Hessian-form
4-vectors (n, d) with n·x + d = 0, ||n|| = 1 and d >= 0; errors between
planes live in a minimal 2/3-dof chart built on the MEASURED normal's
tangent basis (finite gradients everywhere, see the JAX module docstring).
"""

from __future__ import annotations

import numpy as np
import torch

from planarslam_tpu_torch.ops.consts import literal

_EPS = 1e-9


def _safe_norm(v, dim=-1):
    """Norm with a well-defined gradient at v = 0. The epsilon is a tensor
    of v's dtype: a Python float added to a 0-d sum makes torch.func's
    forward mode carry a float64 tangent."""
    eps = literal(_EPS, v.dtype, v.device)
    return torch.sqrt(torch.sum(v * v, dim=dim) + eps)


def normalize(coeffs):
    """Scale (a, b, c, d) to unit normal and flip so d >= 0."""
    n = _safe_norm(coeffs[..., :3])[..., None]
    c = coeffs / n
    return c * torch.where(c[..., 3:4] < 0, -1.0, 1.0)


def transform(T, coeffs):
    """Transform plane coefficients by a point transform T (x' = T x).

    Output is NOT re-canonicalized (sign preserved)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    n = coeffs[..., :3]
    d = coeffs[..., 3]
    n_new = (R @ n[..., None])[..., 0]
    d_new = d - torch.sum(n_new * t, dim=-1)
    return torch.cat([n_new, d_new[..., None]], dim=-1)


def tangent_basis(n):
    """Two orthonormal vectors spanning the plane perpendicular to n (...,3)."""
    ax = torch.abs(n)
    e = torch.eye(3, dtype=n.dtype, device=n.device)
    ex, ey, ez = (e[i].expand(n.shape) for i in range(3))
    seed = torch.where((ax[..., 0:1] <= ax[..., 1:2]) & (ax[..., 0:1] <= ax[..., 2:3]),
                       ex, torch.where(ax[..., 1:2] <= ax[..., 2:3], ey, ez))
    b1 = torch.linalg.cross(n, seed)
    b1 = b1 / _safe_norm(b1)[..., None]
    b2 = torch.linalg.cross(n, b1)
    return b1, b2


def _hemi_align(p, ref_n):
    """Flip plane p so its normal lies in the hemisphere of ref_n."""
    dot = torch.sum(p[..., :3] * ref_n, dim=-1, keepdim=True)
    return p * torch.where(dot < 0, -1.0, 1.0)


def ominus(p_est, p_meas):
    """3-dof error: 2 angular dofs + distance difference."""
    p_est = normalize(p_est)
    p_meas = normalize(p_meas)
    b1, b2 = tangent_basis(p_meas[..., :3])
    n_e = p_est[..., :3]
    return torch.stack([
        torch.sum(b1 * n_e, dim=-1),
        torch.sum(b2 * n_e, dim=-1),
        p_est[..., 3] - p_meas[..., 3],
    ], dim=-1)


def ominus_par(p_est, p_meas):
    """2-dof parallel-plane error (anti-parallel counts as parallel)."""
    p_est = normalize(p_est)
    p_meas = normalize(p_meas)
    n_e = p_est[..., :3]
    n_m = _hemi_align(p_meas, n_e)[..., :3]
    b1, b2 = tangent_basis(n_m)
    return torch.stack([
        torch.sum(b1 * n_e, dim=-1),
        torch.sum(b2 * n_e, dim=-1),
    ], dim=-1)


def ominus_ver(p_est, p_meas):
    """2-dof perpendicular-plane error; second component identically 0."""
    p_est = normalize(p_est)
    p_meas = normalize(p_meas)
    dot = torch.sum(p_est[..., :3] * p_meas[..., :3], dim=-1)
    return torch.stack([dot, torch.zeros_like(dot)], dim=-1)


def transform_np(T, coeffs):
    """Host (numpy) version of `transform`."""
    T = np.asarray(T)
    c = np.asarray(coeffs)
    single = c.ndim == 1
    c2 = np.atleast_2d(c)
    n_new = c2[:, :3] @ T[:3, :3].T
    d_new = c2[:, 3] - n_new @ T[:3, 3]
    out = np.concatenate([n_new, d_new[:, None]], axis=-1)
    return out[0] if single else out


def point_plane_distance(coeffs, pts):
    """Signed distance of points (..., N, 3) to plane (..., 4)."""
    c = normalize(coeffs)
    return torch.sum(pts * c[..., None, :3], dim=-1) + c[..., None, 3]
