"""PnP RANSAC for relocalization without depth.

Port of ``planarslam_tpu/solvers/pnp.py``: each RANSAC hypothesis is a
6-point DLT (direct linear transform) whose rotation is projected onto
SO(3) with a uniform scale; hypotheses are a fixed batch drawn from
``np.random.default_rng(11)`` (the JAX module's seed, so both packages
draw the same picks), and inliers are counted by scale-aware reprojection
chi2.

Kernel K7 ``pnp_dlt_hypotheses`` (``csrc/pnp_dlt.cu``) solves and scores
every hypothesis; ``pnp_dlt_hypotheses_plain`` is its plain PyTorch
version. Both take the DLT nullspace in float64 and score in float32. The
argmax over hypotheses and the final inlier mask stay plain.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from planarslam_tpu_torch import kernels
from planarslam_tpu_torch.device import resolve_device
from planarslam_tpu_torch.solvers.sim3_solver import _pad_bucket


def _dlt_pose(xw: torch.Tensor, xn: torch.Tensor) -> torch.Tensor:
    """6+ point DLT for a batch: world points (H, M, 3) and normalized image
    points (H, M, 2) -> T_cw (H, 4, 4) float32, computed in float64.
    Degenerate picks give a pose the inlier count rejects."""
    xw = xw.to(torch.float64)
    xn = xn.to(torch.float64)
    h, m = xw.shape[:2]
    Xh = torch.cat([xw, torch.ones((h, m, 1), dtype=torch.float64,
                                   device=xw.device)], dim=-1)
    zeros = torch.zeros_like(Xh)
    rows_u = torch.cat([Xh, zeros, -xn[..., 0:1] * Xh], dim=-1)
    rows_v = torch.cat([zeros, Xh, -xn[..., 1:2] * Xh], dim=-1)
    A = torch.cat([rows_u, rows_v], dim=1)  # (H, 2M, 12)
    P = torch.linalg.svd(A, full_matrices=True)[2][:, -1].reshape(h, 3, 4)
    depths = torch.einsum("hmk,hk->hm", Xh, P[:, 2])
    P = P * torch.where(depths.sum(dim=1) < 0, -1.0, 1.0)[:, None, None]
    U, S, Vt = torch.linalg.svd(P[:, :, :3])
    scale = S.mean(dim=1)
    D = torch.ones((h, 3), dtype=torch.float64, device=xw.device)
    D[:, 2] = torch.sign(torch.linalg.det(U @ Vt))
    R = U @ (D[:, :, None] * Vt)
    t = P[:, :, 3] / torch.clamp(scale, min=1e-9)[:, None]
    T = torch.zeros((h, 4, 4), dtype=torch.float64, device=xw.device)
    T[:, :3, :3] = R
    T[:, :3, 3] = t
    T[:, 3, 3] = 1.0
    return T.to(torch.float32)


def _inliers(T, xw, uv_n, inv_sigma2, valid, chi2_gate: float):
    """(H, N) reprojection inliers of each pose, in float32."""
    pc = torch.einsum("nj,hij->hni", xw, T[:, :3, :3]) + T[:, None, :3, 3]
    z = pc[..., 2]
    pred = pc[..., :2] / torch.clamp(z, min=1e-6)[..., None]
    chi2 = torch.sum((pred - uv_n[None]) ** 2, dim=-1) * inv_sigma2[None]
    return (chi2 < chi2_gate) & (z > 0.05) & valid[None]


def pnp_dlt_hypotheses_plain(xw, uv_n, inv_sigma2, valid, picks,
                             chi2_gate: float):
    """Plain version of K7. xw (N, 3), uv_n (N, 2), inv_sigma2 (N,) float32,
    valid (N,) bool, picks (H, 6) int32. Returns scores (H,) int32 (-1 where
    T is not finite) and T (H, 4, 4) float32."""
    p = picks.to(torch.int64)
    T = _dlt_pose(xw[p], uv_n[p])
    n_in = _inliers(T, xw, uv_n, inv_sigma2, valid, chi2_gate).sum(dim=1)
    ok = torch.all(torch.isfinite(T).reshape(T.shape[0], -1), dim=1)
    return torch.where(ok, n_in, -1).to(torch.int32), T


def pnp_dlt_hypotheses(xw: torch.Tensor, uv_n: torch.Tensor,
                       inv_sigma2: torch.Tensor, valid: torch.Tensor,
                       picks: torch.Tensor, chi2_gate: float):
    """K7 wrapper; the arguments and results of
    ``pnp_dlt_hypotheses_plain``."""
    if kernels.on_cpu(xw, uv_n, inv_sigma2, valid, picks):
        return pnp_dlt_hypotheses_plain(xw, uv_n, inv_sigma2, valid, picks,
                                        chi2_gate)
    n = xw.shape[0]
    h = picks.shape[0]
    kernels.check(xw, "xw", torch.float32, (n, 3))
    kernels.check(uv_n, "uv_n", torch.float32, (n, 2))
    kernels.check(inv_sigma2, "inv_sigma2", torch.float32, (n,))
    kernels.check(valid, "valid", torch.bool, (n,))
    kernels.check(picks, "picks", torch.int32, (h, 6))
    scores = torch.empty((h,), dtype=torch.int32, device=xw.device)
    T = torch.empty((h, 4, 4), dtype=torch.float32, device=xw.device)
    with torch.cuda.device(xw.device):
        kernels.launch("psl_pnp_dlt_hypotheses", kernels.ptr(xw),
                       kernels.ptr(uv_n), kernels.ptr(inv_sigma2),
                       kernels.ptr(valid), kernels.ptr(picks), n, h,
                       float(np.float32(chi2_gate)), kernels.ptr(scores),
                       kernels.ptr(T))
    kernels.LAUNCHES["pnp_dlt_hypotheses"] += 1
    return scores, T


def _pnp_ransac(xw, uv_n, valid, inv_sigma2, picks, chi2_gate: float):
    """Best hypothesis (ties: the first index, as jnp.argmax) and its
    inlier mask. Returns (T (4, 4), inl (N,), score)."""
    scores, Ts = pnp_dlt_hypotheses(xw, uv_n, inv_sigma2, valid, picks,
                                    chi2_gate)
    best = torch.argmax(scores)
    T = Ts[best]
    inl = _inliers(T[None], xw, uv_n, inv_sigma2, valid, chi2_gate)[0]
    return T, inl, scores[best]


def pnp_ransac(
    pts_w: np.ndarray,            # (N, 3) map points
    uv: np.ndarray,               # (N, 2) observed pixels (undistorted)
    valid: np.ndarray,            # (N,) bool
    K: Tuple[float, float, float, float],
    inv_sigma2: Optional[np.ndarray] = None,
    chi2_gate: float = 5.991,
    n_hyp: int = 128,
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray, int]:
    """RANSAC PnP on `device`. Returns (T_cw, inlier mask, n_inliers).

    chi2 is evaluated in normalized coordinates scaled back to pixels by
    fx * fy inside inv_sigma2 (pass per-level 1/sigma^2)."""
    device = resolve_device(device)
    fx, fy, cx, cy = K
    n = len(pts_w)
    if n < 6 or valid.sum() < 6:
        return np.eye(4, dtype=np.float32), np.zeros(n, bool), 0
    uv_n = np.stack([(uv[:, 0] - cx) / fx, (uv[:, 1] - cy) / fy], axis=-1)
    if inv_sigma2 is None:
        inv_sigma2 = np.ones(n, np.float32)
    cap = _pad_bucket(n)
    xw_p = np.zeros((cap, 3), np.float32)
    uv_p = np.zeros((cap, 2), np.float32)
    is2_p = np.ones(cap, np.float32)
    v_p = np.zeros(cap, bool)
    xw_p[:n] = pts_w
    uv_p[:n] = uv_n
    is2_p[:n] = inv_sigma2
    v_p[:n] = valid
    rng = np.random.default_rng(11)
    picks = rng.integers(0, max(n, 1), (n_hyp, 6)).astype(np.int32)
    f2 = np.float32(fx * fy)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    T, inl, _ = _pnp_ransac(put(xw_p), put(uv_p), put(v_p),
                            put((is2_p * f2).astype(np.float32)), put(picks),
                            chi2_gate)
    inl = inl.cpu().numpy()[:n]
    return T.cpu().numpy(), inl, int(inl.sum())
