"""Two-view triangulation: of matched keyframe features, and the DLT of
``planarslam_tpu/solvers/triangulation.py``.

The mapping step's DLT and its gates are inline in
``planarslam_tpu/slam/device_mapper.py::_mapping_step_impl`` (``tri_one``:
the 4x4 DLT at ``:135-150``, ``proj_gate`` at ``:155-161``, ``good`` at
``:165-166``). Kernel K5 ``triangulate_two_view`` (``csrc/triangulate.cu``)
computes, per (neighbour, feature) pair, the smallest right singular vector
of the DLT matrix, the point, the finite check and both reprojection chi2
gates; ``triangulate_two_view_plain`` is its plain PyTorch version.

``triangulate`` and ``reprojection_checks`` are the JAX module's two
functions (``:16-40``, ``:43-58``), which the monocular initializer
(``solvers/initializer.py``) calls. Kernel K50 ``triangulate_dlt`` (a
second entry of ``csrc/triangulate.cu``) runs either: its DLT mode takes
the projection matrices P1, P2 as given and returns the point and its
finite flag per pair, its gates mode the cheirality and chi2 tests of both
views; ``triangulate_plain`` and ``reprojection_checks_plain`` are its plain
versions. Every function takes a leading batch where given one.

The nullspaces are taken in float64 (the JAX functions' float32 SVD is the
same vector up to its rounding) and the points returned in float32. The
gates are float32, every product and sum its own rounded op in the order
K50 repeats.
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


def triangulate_plain(P1, P2, uv1, uv2) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K50's DLT mode. P1, P2 (..., 3, 4) and uv1, uv2 (...,
    N, 2) float32. Returns X (..., N, 3) float32 points and ok (..., N) bool,
    their finite mask; the null vector in float64, w clamped at 1e-12."""
    P1 = P1.to(torch.float64)[..., None, :, :]
    P2 = P2.to(torch.float64)[..., None, :, :]
    u1 = uv1.to(torch.float64)
    u2 = uv2.to(torch.float64)
    A = torch.stack([
        u1[..., 0:1] * P1[..., 2, :] - P1[..., 0, :],
        u1[..., 1:2] * P1[..., 2, :] - P1[..., 1, :],
        u2[..., 0:1] * P2[..., 2, :] - P2[..., 0, :],
        u2[..., 1:2] * P2[..., 2, :] - P2[..., 1, :],
    ], dim=-2)
    Xh = torch.linalg.svd(A)[2][..., -1, :]
    w = Xh[..., 3:]
    w = torch.where(torch.abs(w) < 1e-12, 1e-12, w)
    X = (Xh[..., :3] / w).to(torch.float32)
    return X, torch.all(torch.isfinite(X), dim=-1)


def _empty(shape, dtype, dev) -> torch.Tensor:
    """K50's output allocator."""
    return torch.empty(shape, dtype=dtype, device=dev)


def triangulate(P1: torch.Tensor, P2: torch.Tensor, uv1: torch.Tensor,
                uv2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K50 wrapper (DLT mode); the arguments and results of
    ``triangulate_plain``: P1, P2 (3, 4) and uv1, uv2 (N, 2), or B problems
    with every tensor given a leading B (one launch). On the card X and ok
    are views of one byte buffer (13 B N,), X's bytes then ok's, which a
    caller pulls with one copy (``kernels.pull``)."""
    args = (P1, P2, uv1, uv2)
    if kernels.on_cpu(*args):
        return triangulate_plain(*args)
    one = uv1.dim() == 2
    if one:
        args = tuple(a[None] for a in args)
    b, n = args[2].shape[:2]
    for name, a, shape in (("P1", args[0], (b, 3, 4)),
                           ("P2", args[1], (b, 3, 4)),
                           ("uv1", args[2], (b, n, 2)),
                           ("uv2", args[3], (b, n, 2))):
        kernels.check(a, name, torch.float32, shape)
    buf = _empty((13 * b * n,), torch.uint8, uv1.device)
    base = kernels.ptr(buf)
    with torch.cuda.device(uv1.device):
        kernels.launch("psl_triangulate_dlt", *map(kernels.ptr, args), n, b,
                       base, base + 12 * b * n)
    kernels.LAUNCHES["triangulate_dlt"] += 1
    lead = (n,) if one else (b, n)
    X = buf.narrow(0, 0, 12 * b * n).view(torch.float32).view(lead + (3,))
    return X, buf.narrow(0, 12 * b * n, b * n).view(torch.bool).view(lead)


def _view_gate(X, T, uv, inv_s2, K, chi2_gate: float) -> torch.Tensor:
    """z > 0.05 and chi2 < chi2_gate of the points X (..., N, 3) in the view
    T (..., 4, 4): the JAX proj_err, each product and sum its own float32
    op, in the order K50's gates mode repeats."""
    fx, fy, cx, cy = K
    R, t = T[..., :3, :3], T[..., :3, 3]
    x, y, z = X[..., 0], X[..., 1], X[..., 2]

    def cam(a):
        return ((x * R[..., a, 0:1] + y * R[..., a, 1:2])
                + z * R[..., a, 2:3]) + t[..., a:a + 1]

    pcx, pcy, pcz = cam(0), cam(1), cam(2)
    zc = torch.clamp(pcz, min=1e-9)
    du = (fx * pcx / zc + cx) - uv[..., 0]
    dv = (fy * pcy / zc + cy) - uv[..., 1]
    err = (du * du + dv * dv) * inv_s2
    return (pcz > 0.05) & (err < chi2_gate)


def reprojection_checks_plain(X, T1, T2, uv1, uv2, K, inv_sigma2_1,
                              inv_sigma2_2, chi2_gate: float = CHI2_TWO_VIEW
                              ) -> torch.Tensor:
    """Plain version of K50's gates mode: cheirality (z > 0.05) and the
    reprojection chi2 < chi2_gate in both views. X (..., N, 3), T1, T2
    (..., 4, 4) camera-from-world, uv1, uv2 (..., N, 2), K (fx, fy, cx, cy);
    inv_sigma2_1, inv_sigma2_2 numbers or (..., N) tensors. Returns the mask
    (..., N)."""
    K = tuple(float(np.float32(v)) for v in K)
    return (_view_gate(X, T1, uv1, inv_sigma2_1, K, chi2_gate)
            & _view_gate(X, T2, uv2, inv_sigma2_2, K, chi2_gate))


def reprojection_checks(X: torch.Tensor, T1: torch.Tensor, T2: torch.Tensor,
                        uv1: torch.Tensor, uv2: torch.Tensor, K,
                        inv_sigma2_1, inv_sigma2_2,
                        chi2_gate: float = CHI2_TWO_VIEW) -> torch.Tensor:
    """K50 wrapper (gates mode); the arguments and result of
    ``reprojection_checks_plain``: one problem, or B with every tensor given
    a leading B (one launch). An inverse sigma^2 is a number or a tensor of
    the points' shape."""
    tensors = (X, T1, T2, uv1, uv2) + tuple(
        s for s in (inv_sigma2_1, inv_sigma2_2) if torch.is_tensor(s))
    if kernels.on_cpu(*tensors):
        return reprojection_checks_plain(X, T1, T2, uv1, uv2, K,
                                         inv_sigma2_1, inv_sigma2_2,
                                         chi2_gate)
    if X.dim() == 2:
        per = [s[None] if torch.is_tensor(s) else s
               for s in (inv_sigma2_1, inv_sigma2_2)]
        return reprojection_checks(X[None], T1[None], T2[None], uv1[None],
                                   uv2[None], K, *per, chi2_gate)[0]
    b, n = X.shape[:2]
    kernels.check(X, "X", torch.float32, (b, n, 3))
    kernels.check(T1, "T1", torch.float32, (b, 4, 4))
    kernels.check(T2, "T2", torch.float32, (b, 4, 4))
    kernels.check(uv1, "uv1", torch.float32, (b, n, 2))
    kernels.check(uv2, "uv2", torch.float32, (b, n, 2))
    ptrs, scalars = [], []
    for name, s in (("inv_sigma2_1", inv_sigma2_1),
                    ("inv_sigma2_2", inv_sigma2_2)):
        if torch.is_tensor(s):
            kernels.check(s, name, torch.float32, (b, n))
            ptrs.append(kernels.ptr(s))
            scalars.append(0.0)
        else:
            ptrs.append(None)
            scalars.append(float(np.float32(s)))
    mask = _empty((b, n), torch.bool, X.device)
    fx, fy, cx, cy = (float(np.float32(v)) for v in K)
    with torch.cuda.device(X.device):
        kernels.launch("psl_reprojection_checks", kernels.ptr(X),
                       kernels.ptr(T1), kernels.ptr(T2), kernels.ptr(uv1),
                       kernels.ptr(uv2), *ptrs, *scalars, n, b, fx, fy, cx,
                       cy, float(np.float32(chi2_gate)), kernels.ptr(mask))
    kernels.LAUNCHES["triangulate_dlt"] += 1
    return mask
