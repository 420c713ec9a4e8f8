"""Two-view triangulation of matched keyframe features.

The JAX package has no module of its own for this: the DLT and its gates
are inline in ``planarslam_tpu/slam/device_mapper.py::_mapping_step_impl``
(``tri_one``: the 4x4 DLT at ``:135-150``, ``proj_gate`` at ``:155-161``,
``good`` at ``:165-166``). ``planarslam_tpu/solvers/triangulation.py`` serves
only the dead RGB-D ``initializer.py`` and has no counterpart here.

Kernel K5 ``triangulate_two_view`` (``csrc/triangulate.cu``) computes, per
(neighbour, feature) pair, the smallest right singular vector of the DLT
matrix, the point, the finite check and both reprojection chi2 gates;
``triangulate_two_view_plain`` is its plain PyTorch version. Both take the
nullspace in float64 (the JAX function's float32 SVD is the same vector up
to its rounding) and return float32 points.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from planarslam_tpu_torch import kernels

CHI2_TWO_VIEW = 5.991


def _projection(K, T: torch.Tensor) -> torch.Tensor:
    """K [R | t] (..., 3, 4) in float64 from poses (..., 4, 4)."""
    fx, fy, cx, cy = K
    Kmat = torch.tensor([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]],
                        dtype=torch.float64, device=T.device)
    return Kmat @ T[..., :3, :].to(torch.float64)


def _proj_gate(T, X, uv, inv_s2, K) -> torch.Tensor:
    """z > 0.05 and reprojection chi2 < 5.991 (the JAX proj_gate); T
    (..., 4, 4) broadcasts against the leading dimensions of X."""
    fx, fy, cx, cy = K
    pc = torch.einsum("...j,...ij->...i", X, T[..., :3, :3]) + T[..., :3, 3]
    z = pc[..., 2]
    zc = torch.clamp(z, min=1e-9)
    u = fx * pc[..., 0] / zc + cx
    v = fy * pc[..., 1] / zc + cy
    err = ((u - uv[..., 0]) ** 2 + (v - uv[..., 1]) ** 2) * inv_s2
    return (z > 0.05) & (err < CHI2_TWO_VIEW)


def triangulate_two_view_plain(own_uv, own_level, uv2, level2, has, own_T,
                               nb_T, K, scale_factor: float
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K5. own_uv (K, 2), own_level (K,), uv2 (NB, K, 2) and
    level2 (NB, K) the matched neighbour features, has (NB, K) bool, own_T
    (4, 4), nb_T (NB, 4, 4). Returns X (NB, K, 3) float32 world points and
    good (NB, K) int32."""
    K = tuple(float(np.float32(v)) for v in K)
    P1 = _projection(K, own_T)
    P2 = _projection(K, nb_T)[:, None]
    u1 = own_uv.to(torch.float64)[None].expand(uv2.shape)
    u2 = uv2.to(torch.float64)
    A = torch.stack([
        u1[..., 0:1] * P1[2] - P1[0],
        u1[..., 1:2] * P1[2] - P1[1],
        u2[..., 0:1] * P2[..., 2, :] - P2[..., 0, :],
        u2[..., 1:2] * P2[..., 2, :] - P2[..., 1, :],
    ], dim=-2)
    Xh = torch.linalg.svd(A)[2][..., -1, :]
    w = Xh[..., 3:]
    w = torch.where(torch.abs(w) < 1e-12, 1e-12, w)
    X = (Xh[..., :3] / w).to(torch.float32)
    finite = torch.all(torch.isfinite(X), dim=-1)
    sf = torch.tensor(scale_factor, dtype=torch.float32, device=X.device)
    s2a = torch.pow(sf, -2.0 * own_level.to(torch.float32))
    s2b = torch.pow(sf, -2.0 * level2.to(torch.float32))
    good = (has & finite & _proj_gate(own_T, X, own_uv, s2a, K)
            & _proj_gate(nb_T[:, None], X, uv2, s2b, K))
    return X, good.to(torch.int32)


def triangulate_two_view(own_uv: torch.Tensor, own_level: torch.Tensor,
                         uv2: torch.Tensor, level2: torch.Tensor,
                         has: torch.Tensor, own_T: torch.Tensor,
                         nb_T: torch.Tensor, K: Tuple[float, float, float,
                                                      float],
                         scale_factor: float
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5 wrapper; the arguments and results of
    ``triangulate_two_view_plain``."""
    if kernels.on_cpu(own_uv, own_level, uv2, level2, has, own_T, nb_T):
        return triangulate_two_view_plain(own_uv, own_level, uv2, level2,
                                          has, own_T, nb_T, K, scale_factor)
    nb, k = has.shape
    kernels.check(own_uv, "own_uv", torch.float32, (k, 2))
    kernels.check(own_level, "own_level", torch.int32, (k,))
    kernels.check(uv2, "uv2", torch.float32, (nb, k, 2))
    kernels.check(level2, "level2", torch.int32, (nb, k))
    kernels.check(has, "has", torch.bool, (nb, k))
    kernels.check(own_T, "own_T", torch.float32, (4, 4))
    kernels.check(nb_T, "nb_T", torch.float32, (nb, 4, 4))
    X = torch.empty((nb, k, 3), dtype=torch.float32, device=has.device)
    good = torch.empty((nb, k), dtype=torch.int32, device=has.device)
    fx, fy, cx, cy = (float(v) for v in K)
    with torch.cuda.device(has.device):
        kernels.launch("psl_triangulate_two_view", kernels.ptr(own_uv),
                       kernels.ptr(own_level), kernels.ptr(uv2),
                       kernels.ptr(level2), kernels.ptr(has),
                       kernels.ptr(own_T), kernels.ptr(nb_T), nb, k, fx, fy,
                       cx, cy, float(scale_factor), kernels.ptr(X),
                       kernels.ptr(good))
    kernels.LAUNCHES["triangulate_two_view"] += 1
    return X, good
