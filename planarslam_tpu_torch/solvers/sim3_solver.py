"""Closed-form rigid alignment (Horn) inside a fixed-hypothesis RANSAC.

Port of the RGB-D half of ``planarslam_tpu/solvers/sim3_solver.py``
(``horn_align``, ``_ransac_align``, ``_pad_bucket``, ``_pad_pair``,
``horn_ransac_se3``, ``_refine_relative``, ``refine_relative_se3``).
Scale is fixed to 1, as the RGB-D paths of the JAX module use it; the
similarity variant ``horn_ransac_sim3`` is on no path and is not ported.

Kernel K6 ``horn_align_batch`` (``csrc/horn_align.cu``) aligns one weight
row per block and counts that row's inliers; ``horn_align_batch_plain`` is
its plain PyTorch version. A RANSAC launches it twice: the 64 one-hot
hypothesis rows, then the single row of the inlier refit. Hypotheses come
from ``np.random.default_rng(7)``, as in the JAX module, so both packages
draw the same triplets.

Kernel K32 ``refine_relative`` (``csrc/refine_relative.cu``) runs the
loop-edge refinement, all eight Gauss-Newton steps of one problem in one
block and one launch; ``_refine_relative_plain`` is its plain version,
with the analytic Jacobian of the bidirectional reprojection.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from planarslam_tpu_torch import kernels
from planarslam_tpu_torch.device import resolve_device
from planarslam_tpu_torch.geometry import se3


def horn_align(src: torch.Tensor, dst: torch.Tensor, weights: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted closed-form alignment dst ~ R src + t for each weight row.

    src, dst: (N, 3); weights: (H, N) nonnegative. Returns R (H, 3, 3) and
    t (H, 3), float32, computed in float64: R = U diag(1, 1, det(U V^T)) V^T
    of the SVD of the centred cross-covariance (the JAX function's SVD form
    of Horn's method)."""
    s = src.to(torch.float64)
    d = dst.to(torch.float64)
    w = weights.to(torch.float64)
    w = w / torch.clamp(w.sum(dim=1, keepdim=True), min=1e-9)
    mu_s = w @ s
    mu_d = w @ d
    xs = s[None] - mu_s[:, None]
    xd = d[None] - mu_d[:, None]
    C = torch.einsum("hn,hni,hnj->hij", w, xd, xs)
    U, _, Vt = torch.linalg.svd(C)
    sign = torch.sign(torch.linalg.det(U @ Vt))
    D = torch.ones((C.shape[0], 3), dtype=torch.float64, device=C.device)
    D[:, 2] = sign
    R = U @ (D[:, :, None] * Vt)
    t = mu_d - torch.einsum("hij,hj->hi", R, mu_s)
    return R.to(torch.float32), t.to(torch.float32)


def horn_align_batch_plain(src, dst, valid, weights, threshold: float):
    """Plain version of K6. src, dst (N, 3) float32; valid (N,) float32;
    weights (H, N) float32. Returns R (H, 3, 3), t (H, 3), n_inl (H,)
    int32 and inl (H, N) bool at |R src + t - dst|^2 < threshold^2."""
    R, t = horn_align(src, dst, weights)
    pred = torch.einsum("nj,hij->hni", src, R) + t[:, None]
    err = torch.sum((pred - dst[None]) ** 2, dim=-1)
    thr = torch.tensor(threshold, dtype=torch.float32, device=src.device)
    inl = (err < thr * thr) & (valid[None] > 0)
    return R, t, inl.sum(dim=1).to(torch.int32), inl


def horn_align_batch(src: torch.Tensor, dst: torch.Tensor,
                     valid: torch.Tensor, weights: torch.Tensor,
                     threshold: float):
    """K6 wrapper; the arguments and results of ``horn_align_batch_plain``."""
    if kernels.on_cpu(src, dst, valid, weights):
        return horn_align_batch_plain(src, dst, valid, weights, threshold)
    h, n = weights.shape
    kernels.check(src, "src", torch.float32, (n, 3))
    kernels.check(dst, "dst", torch.float32, (n, 3))
    kernels.check(valid, "valid", torch.float32, (n,))
    kernels.check(weights, "weights", torch.float32, (h, n))
    dev = src.device
    R = torch.empty((h, 3, 3), dtype=torch.float32, device=dev)
    t = torch.empty((h, 3), dtype=torch.float32, device=dev)
    n_inl = torch.empty((h,), dtype=torch.int32, device=dev)
    inl = torch.empty((h, n), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        kernels.launch("psl_horn_align_batch", kernels.ptr(src),
                       kernels.ptr(dst), kernels.ptr(valid),
                       kernels.ptr(weights), h, n,
                       float(np.float32(threshold)), kernels.ptr(R),
                       kernels.ptr(t), kernels.ptr(n_inl), kernels.ptr(inl))
    kernels.LAUNCHES["horn_align_batch"] += 1
    return R, t, n_inl, inl


def _ransac_align(src, dst, valid, triplets, threshold: float):
    """Score every triplet hypothesis, refit on the best one's inliers.
    Returns R (3, 3), t (3,), the refit's inlier count (0-d int32) and
    inlier mask (N,)."""
    n = src.shape[0]
    w = torch.zeros((triplets.shape[0], n), dtype=torch.float32,
                    device=src.device)
    w.scatter_(1, triplets.to(torch.int64), 1.0)
    w = w * valid[None] + 1e-9
    _, _, n_inl, inl = horn_align_batch(src, dst, valid, w, threshold)
    best = torch.argmax(n_inl)  # ties: the first index, as jnp.argmax
    w_refit = (inl[best].to(torch.float32) + 1e-9)[None]
    R, t, n_inl, inl = horn_align_batch(src, dst, valid,
                                        w_refit.contiguous(), threshold)
    return R[0], t[0], n_inl[0], inl[0]


def _pad_bucket(n: int) -> int:
    """Padded correspondence capacity (the JAX module's static shape
    buckets, kept so both draw hypotheses over the same padded arrays)."""
    for cap in (64, 256, 1024, 4096):
        if n <= cap:
            return cap
    return ((n + 4095) // 4096) * 4096


def _pad_pair(src, dst, n_hyp, seed=7):
    n = len(src)
    cap = _pad_bucket(n)
    s = np.zeros((cap, 3), np.float32)
    d = np.zeros((cap, 3), np.float32)
    s[:n] = src
    d[:n] = dst
    v = np.zeros((cap,), np.float32)
    v[:n] = 1.0
    rng = np.random.default_rng(seed)
    picks = rng.integers(0, max(n, 1), (n_hyp, 3)).astype(np.int32)
    return s, d, v, picks


def horn_ransac_se3(src: np.ndarray, dst: np.ndarray,
                    threshold: float = 0.10, n_hyp: int = 64,
                    device="cuda") -> Tuple[np.ndarray, int, np.ndarray]:
    """RANSAC rigid alignment dst ~ T src on `device`. Returns (T (4, 4),
    n_inliers, inlier mask)."""
    device = resolve_device(device)
    n = len(src)
    if n < 3:
        return np.eye(4, dtype=np.float32), 0, np.zeros(n, bool)
    s, d, v, picks = _pad_pair(src, dst, n_hyp)

    def put(a):
        return torch.from_numpy(a).to(device)

    R, t, n_inl, inl = _ransac_align(put(s), put(d), put(v), put(picks),
                                     threshold)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = R.cpu().numpy()
    T[:3, 3] = t.cpu().numpy()
    return T, int(n_inl), inl.cpu().numpy()[:n]


def _proj_jac(p, K):
    """project() of the refinement (z clamped at 1e-6) and its Jacobian
    d(u, v)/dp (..., 2, 3); the clamp passes no derivative to z below
    1e-6, as jnp.maximum and torch.clamp do."""
    fx, fy, cx, cy = K
    z = torch.clamp(p[..., 2], min=1e-6)
    front = p[..., 2] > 1e-6
    uv = torch.stack([fx * p[..., 0] / z + cx, fy * p[..., 1] / z + cy],
                     dim=-1)
    zero = torch.zeros_like(z)
    z2 = z * z
    J = torch.stack([
        torch.stack([fx / z, zero,
                     torch.where(front, -fx * p[..., 0] / z2, zero)], -1),
        torch.stack([zero, fy / z,
                     torch.where(front, -fy * p[..., 1] / z2, zero)], -1)],
        dim=-2)
    return uv, J


def _refine_relative_plain(T12_init, s_init, pts1_c, pts2_c, uv1, uv2, valid,
                           K, fix_scale: bool = True, n_iters: int = 8,
                           huber_chi2: float = 10.0):
    """Plain version of K32 for one problem. Gauss-Newton refinement of the
    relative transform between two cameras: bidirectional reprojection
    (camera 2's points into camera 1 through S12 = (s R12, t12), camera
    1's into camera 2 through S12^-1) with Huber weights on each
    correspondence's chi2. 7-dof tangent [rho, phi, sigma] on the left of
    T12, sigma frozen when fix_scale. The Jacobian is analytic, as
    jax.jacfwd of the JAX module's residual gives it at xi = 0:
      p21 = s R p2 + t:  d/drho = I, d/dphi = -hat(p21), d/dsigma = s R p2;
      p12 = R^T (p1 - t) / s:  d/drho = -R^T / s, d/dphi = R^T hat(p1) / s,
        d/dsigma = -p12,
    with the sigma column exactly 0 when fix_scale. Runs without a host
    sync."""
    eye7 = torch.eye(7, dtype=torch.float32, device=T12_init.device)
    T, s = T12_init, s_init
    n = pts1_c.shape[0]
    v = valid[:, None, None]
    for _ in range(n_iters):
        R, t = T[:3, :3], T[:3, 3]
        s_c = torch.clamp(s, min=1e-9)
        sR2 = s * (pts2_c @ R.T)
        p21 = sR2 + t
        p12 = (pts1_c - t) @ R / s_c
        uv_21, P1 = _proj_jac(p21, K)
        uv_12, P2 = _proj_jac(p12, K)
        r1 = (uv1 - uv_21) * valid[:, None]
        r2 = (uv2 - uv_12) * valid[:, None]
        sig = 0.0 if fix_scale else 1.0  # the sigma column
        Rt = R.T.expand(n, 3, 3)
        D1 = torch.cat([torch.eye(3, device=R.device).expand(n, 3, 3),
                        -se3.hat(p21), sig * sR2[..., None]], dim=-1)
        D2 = torch.cat([-Rt / s_c, Rt @ se3.hat(pts1_c) / s_c,
                        -sig * torch.where(s > 1e-9, p12, 0.0)[..., None]],
                       dim=-1)
        J = torch.cat([(-(P1 @ D1) * v).reshape(-1, 7),
                       (-(P2 @ D2) * v).reshape(-1, 7)])
        r0 = torch.cat([r1.reshape(-1), r2.reshape(-1)])
        chi2 = torch.sum(r0.reshape(2, -1, 2) ** 2, dim=-1)
        w = torch.where(chi2 > huber_chi2,
                        torch.sqrt(huber_chi2 / torch.clamp(chi2, min=1e-9)),
                        1.0)
        Jw = J * torch.repeat_interleave(w.reshape(-1), 2)[:, None]
        dx = -torch.linalg.solve_ex(Jw.T @ J + 1e-6 * eye7, Jw.T @ r0,
                                    check_errors=False)[0]
        ok = torch.all(torch.isfinite(dx))
        T_new = se3.se3_exp(dx[:6]) @ T
        s_new = s if fix_scale else s * torch.exp(dx[6])
        T = torch.where(ok, T_new, T)
        s = torch.where(ok, s_new, s)
    return T, s


def refine_relative(T12_init, s_init, pts1_c, pts2_c, uv1, uv2, valid, K,
                    fix_scale: bool = True, n_iters: int = 8,
                    huber_chi2: float = 10.0):
    """K32 wrapper: B refinement problems with a leading batch dimension.
    T12_init (B, 4, 4), s_init (B,), pts1_c, pts2_c (B, N, 3), uv1, uv2
    (B, N, 2), valid (B, N) float32. Returns T (B, 4, 4) and s (B,).
    One block per problem runs all n_iters steps in one launch."""
    if kernels.on_cpu(T12_init, s_init, pts1_c, pts2_c, uv1, uv2, valid):
        return kernels.per_problem(
            _refine_relative_plain,
            (T12_init, s_init, pts1_c, pts2_c, uv1, uv2, valid), K,
            fix_scale, n_iters, huber_chi2)
    B, N = valid.shape
    f32 = torch.float32
    kernels.check(T12_init, "T12_init", f32, (B, 4, 4))
    kernels.check(s_init, "s_init", f32, (B,))
    for name, x, d in (("pts1_c", pts1_c, 3), ("pts2_c", pts2_c, 3),
                       ("uv1", uv1, 2), ("uv2", uv2, 2)):
        kernels.check(x, name, f32, (B, N, d))
    kernels.check(valid, "valid", f32, (B, N))
    T = torch.empty((B, 4, 4), dtype=f32, device=valid.device)
    s = torch.empty((B,), dtype=f32, device=valid.device)
    fx, fy, cx, cy = (float(np.float32(x)) for x in K)
    with torch.cuda.device(valid.device):
        kernels.launch("psl_refine_relative", kernels.ptr(T12_init),
                       kernels.ptr(s_init), kernels.ptr(pts1_c),
                       kernels.ptr(pts2_c), kernels.ptr(uv1),
                       kernels.ptr(uv2), kernels.ptr(valid), B, N, fx, fy,
                       cx, cy, int(fix_scale), n_iters,
                       float(np.float32(huber_chi2)), kernels.ptr(T),
                       kernels.ptr(s))
    kernels.LAUNCHES["refine_relative"] += 1
    return T, s


def refine_relative_se3(T12_init: np.ndarray, pts1_c: np.ndarray,
                        pts2_c: np.ndarray, uv1: np.ndarray, uv2: np.ndarray,
                        valid: np.ndarray,
                        K: Tuple[float, float, float, float],
                        fix_scale: bool = True, device="cuda"):
    """Host wrapper of the refinement on `device`. Returns (T12, s)."""
    device = resolve_device(device)
    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
            device)

    T, s = refine_relative(
        put(T12_init)[None], torch.ones(1, device=device),
        put(pts1_c)[None], put(pts2_c)[None], put(uv1)[None],
        put(uv2)[None], put(valid)[None], tuple(float(v) for v in K),
        fix_scale=fix_scale)
    return T[0].cpu().numpy(), float(s[0])
