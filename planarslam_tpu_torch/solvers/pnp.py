"""PnP RANSAC for relocalization without depth.

Port of ``planarslam_tpu/solvers/pnp.py``: each RANSAC hypothesis is a
6-point DLT (direct linear transform) whose rotation is projected onto
SO(3) with a uniform scale; hypotheses are a fixed batch drawn from
``np.random.default_rng(11)`` (the JAX module's seed, so both packages
draw the same picks), and inliers are counted by scale-aware reprojection
chi2.

Kernel K7 ``pnp_dlt_hypotheses`` (``csrc/pnp_dlt.cu``) solves and scores
every hypothesis, a warp's parallel Jacobi SVD each; ``pnp_dlt_hypotheses_plain``
is its plain PyTorch version. Both take the DLT nullspace in float64 and score
in float32. Kernel K46 ``pnp_select`` (the same source) takes the first best
hypothesis and its final inlier mask and count into one packed row;
``pnp_select_plain`` is its plain version. On the card a RANSAC is K7, K46
and one pull of the packed row, with no PyTorch op between them.
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
    """(H, N) reprojection inliers of each pose, in float32. Every product
    and sum is its own rounded op in the order K7 and K46 repeat: a camera
    coordinate ((x R0 + y R1) + z R2) + t, chi2 (du du + dv dv) / sigma^2."""
    R, t = T[:, :3, :3], T[:, :3, 3]
    x, y, z = (xw[None, :, k] for k in range(3))

    def cam(a):
        return ((x * R[:, a, 0:1] + y * R[:, a, 1:2]) + z * R[:, a, 2:3]) \
            + t[:, a:a + 1]

    pcx, pcy, pcz = cam(0), cam(1), cam(2)
    zc = torch.clamp(pcz, min=1e-6)
    du = pcx / zc - uv_n[None, :, 0]
    dv = pcy / zc - uv_n[None, :, 1]
    chi2 = (du * du + dv * dv) * inv_sigma2[None]
    return (chi2 < chi2_gate) & (pcz > 0.05) & valid[None]


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
    ``pnp_dlt_hypotheses_plain``, or of B problems with every tensor given
    a leading B (one launch)."""
    args = (xw, uv_n, inv_sigma2, valid, picks)
    if xw.dim() == 2:
        if kernels.on_cpu(*args):
            return pnp_dlt_hypotheses_plain(*args, chi2_gate)
        scores, T = pnp_dlt_hypotheses(*[a[None] for a in args], chi2_gate)
        return scores[0], T[0]
    if kernels.on_cpu(*args):
        return kernels.per_problem(pnp_dlt_hypotheses_plain, args, chi2_gate)
    b, n = xw.shape[:2]
    h = picks.shape[1]
    kernels.check(xw, "xw", torch.float32, (b, n, 3))
    kernels.check(uv_n, "uv_n", torch.float32, (b, n, 2))
    kernels.check(inv_sigma2, "inv_sigma2", torch.float32, (b, n))
    kernels.check(valid, "valid", torch.bool, (b, n))
    kernels.check(picks, "picks", torch.int32, (b, h, 6))
    scores = torch.empty((b, h), dtype=torch.int32, device=xw.device)
    T = torch.empty((b, h, 4, 4), dtype=torch.float32, device=xw.device)
    with torch.cuda.device(xw.device):
        kernels.launch("psl_pnp_dlt_hypotheses", kernels.ptr(xw),
                       kernels.ptr(uv_n), kernels.ptr(inv_sigma2),
                       kernels.ptr(valid), kernels.ptr(picks), n, h, b,
                       float(np.float32(chi2_gate)), kernels.ptr(scores),
                       kernels.ptr(T))
    kernels.LAUNCHES["pnp_dlt_hypotheses"] += 1
    return scores, T


# floats of a packed RANSAC row before its inlier mask: T (16) and the
# count's int32 bits
PNP_PACKED = 17


def pnp_select_plain(xw, uv_n, inv_sigma2, valid, scores, Ts,
                     chi2_gate: float):
    """Plain version of K46: the first hypothesis of the largest score (as
    jnp.argmax), and its inlier mask at that T. Inputs of K7 for one
    problem, scores (H,) and Ts (H, 4, 4) its outputs. Returns the packed
    row (17 + N,) float32: T, the inlier count's int32 bits, the mask as 0
    / 1."""
    T = Ts[torch.argmax(scores)]
    inl = _inliers(T[None], xw, uv_n, inv_sigma2, valid, chi2_gate)[0]
    count = inl.sum(dtype=torch.int32).reshape(1).view(torch.float32)
    return torch.cat([T.reshape(16), count, inl.to(torch.float32)])


def pnp_select(xw, uv_n, inv_sigma2, valid, scores, Ts, chi2_gate: float):
    """K46 wrapper; the arguments and result of ``pnp_select_plain``, or of
    B problems with every tensor given a leading B (one launch, one block a
    problem)."""
    args = (xw, uv_n, inv_sigma2, valid, scores, Ts)
    if xw.dim() == 2:
        if kernels.on_cpu(*args):
            return pnp_select_plain(*args, chi2_gate)
        return pnp_select(*[a[None] for a in args], chi2_gate)[0]
    if kernels.on_cpu(*args):
        return torch.stack([pnp_select_plain(*[a[i] for a in args], chi2_gate)
                            for i in range(xw.shape[0])])
    b, n = xw.shape[:2]
    h = scores.shape[1]
    kernels.check(xw, "xw", torch.float32, (b, n, 3))
    kernels.check(uv_n, "uv_n", torch.float32, (b, n, 2))
    kernels.check(inv_sigma2, "inv_sigma2", torch.float32, (b, n))
    kernels.check(valid, "valid", torch.bool, (b, n))
    kernels.check(scores, "scores", torch.int32, (b, h))
    kernels.check(Ts, "Ts", torch.float32, (b, h, 4, 4))
    out = torch.empty((b, PNP_PACKED + n), dtype=torch.float32,
                      device=xw.device)
    with torch.cuda.device(xw.device):
        kernels.launch("psl_pnp_select", kernels.ptr(xw), kernels.ptr(uv_n),
                       kernels.ptr(inv_sigma2), kernels.ptr(valid),
                       kernels.ptr(scores), kernels.ptr(Ts), n, h, b,
                       float(np.float32(chi2_gate)), kernels.ptr(out))
    kernels.LAUNCHES["pnp_select"] += 1
    return out


def unpack_pnp(row: np.ndarray, n: int):
    """A packed row of K46 on the host -> (T (4, 4), inlier mask (n,),
    count)."""
    T = row[:16].reshape(4, 4).copy()
    count = int(row[16:17].view(np.int32)[0])
    return T, row[PNP_PACKED:PNP_PACKED + n] > 0, count


def _pnp_ransac(xw, uv_n, valid, inv_sigma2, picks, chi2_gate: float):
    """K7 then K46 (their plain versions on the CPU): the packed row (17 +
    N,) of the best hypothesis (ties: the first index, as jnp.argmax), or
    (B, 17 + N) for tensors with a leading B. With a leading B nothing runs
    between the launches."""
    scores, Ts = pnp_dlt_hypotheses(xw, uv_n, inv_sigma2, valid, picks,
                                    chi2_gate)
    return pnp_select(xw, uv_n, inv_sigma2, valid, scores, Ts, chi2_gate)


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
    """RANSAC PnP on `device`: one upload, K7 and K46, one pull. Returns
    (T_cw, inlier mask, n_inliers).

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
    xw_t, uv_t, v_t, is2_t, picks_t = kernels.upload(
        [a[None] for a in (xw_p, uv_p, v_p, (is2_p * f2).astype(np.float32),
                           picks)], device)
    row = _pnp_ransac(xw_t, uv_t, v_t, is2_t, picks_t, chi2_gate)
    T, inl, _ = unpack_pnp(row.cpu().numpy()[0], n)
    return T, inl, int(inl.sum())
