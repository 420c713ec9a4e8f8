"""Closed-form rigid or similarity alignment (Horn) inside a
fixed-hypothesis RANSAC.

Port of ``planarslam_tpu/solvers/sim3_solver.py`` (``horn_align``,
``_ransac_align``, ``_pad_bucket``, ``_pad_pair``, ``horn_ransac_se3``,
``horn_ransac_sim3``, ``_refine_relative``, ``refine_relative_se3``). The
RGB-D paths fix the scale to 1 (``horn_ransac_se3``); ``horn_ransac_sim3``
frees it, as the JAX module's similarity variant does.

Kernel K6 ``horn_align_batch`` (``csrc/horn_align.cu``) aligns one weight
row per block and counts that row's inliers, in three modes: given weight
rows (``horn_align_batch``), the 64 hypothesis triplets whose one-hot rows
it forms as it reads them (``horn_triplets``), and the refit on the best
triplet's inliers (``horn_refit``), which writes one packed row. A RANSAC
is one upload, a triplet launch, a refit launch and one pull, with no
PyTorch op between the launches. Each wrapper sits beside its plain version
(``*_plain``), which the CPU runs. Hypotheses come from
``np.random.default_rng(7)``, as in the JAX module, so both packages draw
the same triplets.

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


def horn_align(src: torch.Tensor, dst: torch.Tensor, weights: torch.Tensor,
               with_scale: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Weighted closed-form alignment dst ~ s R src + t for each weight row.

    src, dst: (N, 3); weights: (H, N) nonnegative. Returns R (H, 3, 3), t
    (H, 3) and s (H,), float32, computed in float64: R = U diag(1, 1,
    det(U V^T)) V^T of the SVD of the centred cross-covariance (the JAX
    function's SVD form of Horn's method), s = sum(S diag(D)) / max(var,
    1e-12) with the scale, else 1."""
    s = src.to(torch.float64)
    d = dst.to(torch.float64)
    w = weights.to(torch.float64)
    w = w / torch.clamp(w.sum(dim=1, keepdim=True), min=1e-9)
    mu_s = w @ s
    mu_d = w @ d
    xs = s[None] - mu_s[:, None]
    xd = d[None] - mu_d[:, None]
    C = torch.einsum("hn,hni,hnj->hij", w, xd, xs)
    U, S, Vt = torch.linalg.svd(C)
    sign = torch.sign(torch.linalg.det(U @ Vt))
    D = torch.ones((C.shape[0], 3), dtype=torch.float64, device=C.device)
    D[:, 2] = sign
    R = U @ (D[:, :, None] * Vt)
    Rmu = torch.einsum("hij,hj->hi", R, mu_s)
    if with_scale:
        var = torch.sum(w * torch.sum(xs * xs, dim=-1), dim=1)
        scale = torch.sum(S * D, dim=1) / torch.clamp(var, min=1e-12)
        t = mu_d - scale[:, None] * Rmu
    else:
        scale = torch.ones(C.shape[0], dtype=torch.float64, device=C.device)
        t = mu_d - Rmu
    return R.to(torch.float32), t.to(torch.float32), scale.to(torch.float32)


def _horn_rows_plain(src, dst, valid, weights, threshold: float,
                     with_scale: bool = False):
    """Each weight row's alignment and inliers: R (H, 3, 3), t (H, 3), s
    (H,), n_inl (H,) int32 and inl (H, N) bool at |s R src + t - dst|^2 <
    threshold^2 on valid points."""
    R, t, s = horn_align(src, dst, weights, with_scale)
    pred = torch.einsum("nj,hij->hni", src, R)
    if with_scale:
        pred = s[:, None, None] * pred
    pred = pred + t[:, None]
    err = torch.sum((pred - dst[None]) ** 2, dim=-1)
    thr = torch.tensor(threshold, dtype=torch.float32, device=src.device)
    inl = (err < thr * thr) & (valid[None] > 0)
    return R, t, s, inl.sum(dim=1).to(torch.int32), inl


def horn_align_batch_plain(src, dst, valid, weights, threshold: float):
    """Plain version of K6's weights mode. src, dst (N, 3) float32; valid
    (N,) float32; weights (H, N) float32. Returns R (H, 3, 3), t (H, 3),
    n_inl (H,) int32 and inl (H, N) bool at |R src + t - dst|^2 <
    threshold^2."""
    R, t, _, n_inl, inl = _horn_rows_plain(src, dst, valid, weights,
                                           threshold)
    return R, t, n_inl, inl


def horn_align_batch(src: torch.Tensor, dst: torch.Tensor,
                     valid: torch.Tensor, weights: torch.Tensor,
                     threshold: float):
    """K6 wrapper, weights mode; the arguments and results of
    ``horn_align_batch_plain``."""
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


def triplet_weights(valid: torch.Tensor, triplets: torch.Tensor
                    ) -> torch.Tensor:
    """The (H, N) one-hot rows of H hypothesis triplets, as the JAX module
    forms them: zeros.at[tri].set(1) * valid + 1e-9 (a repeated index
    weighs 1). K6's triplet mode forms the same bits as it reads them."""
    w = torch.zeros((triplets.shape[0], valid.shape[0]), dtype=torch.float32,
                    device=valid.device)
    w.scatter_(1, triplets.to(torch.int64), 1.0)
    return w * valid[None] + 1e-9


def horn_triplets_plain(src, dst, valid, triplets, threshold: float,
                        with_scale: bool = False):
    """Plain version of K6's triplet mode for one problem: src, dst (N, 3),
    valid (N,) float32, triplets (H, 3) int32. Returns R (H, 3, 3), t (H,
    3), s (H,), n_inl (H,) int32 and inl (H, N) bool."""
    return _horn_rows_plain(src, dst, valid, triplet_weights(valid, triplets),
                            threshold, with_scale)


def horn_triplets(src, dst, valid, triplets, threshold: float,
                  with_scale: bool = False):
    """K6 wrapper, triplet mode; the arguments and results of
    ``horn_triplets_plain``, or of B problems with every tensor given a
    leading B (one launch, a block per problem and triplet)."""
    args = (src, dst, valid, triplets)
    if src.dim() == 2:
        if kernels.on_cpu(*args):
            return horn_triplets_plain(*args, threshold, with_scale)
        return tuple(x[0] for x in horn_triplets(
            *[a[None] for a in args], threshold, with_scale))
    if kernels.on_cpu(*args):
        return kernels.per_problem(horn_triplets_plain, args, threshold,
                                   with_scale)
    b, n = valid.shape
    h = triplets.shape[1]
    kernels.check(src, "src", torch.float32, (b, n, 3))
    kernels.check(dst, "dst", torch.float32, (b, n, 3))
    kernels.check(valid, "valid", torch.float32, (b, n))
    kernels.check(triplets, "triplets", torch.int32, (b, h, 3))
    dev = src.device
    R = torch.empty((b, h, 3, 3), dtype=torch.float32, device=dev)
    t = torch.empty((b, h, 3), dtype=torch.float32, device=dev)
    s = torch.empty((b, h), dtype=torch.float32, device=dev)
    n_inl = torch.empty((b, h), dtype=torch.int32, device=dev)
    inl = torch.empty((b, h, n), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        kernels.launch("psl_horn_triplets", kernels.ptr(src),
                       kernels.ptr(dst), kernels.ptr(valid),
                       kernels.ptr(triplets), n, h, b,
                       float(np.float32(threshold)), int(with_scale),
                       kernels.ptr(R), kernels.ptr(t), kernels.ptr(s),
                       kernels.ptr(n_inl), kernels.ptr(inl))
    kernels.LAUNCHES["horn_align_batch"] += 1
    return R, t, s, n_inl, inl


# floats of a packed Horn RANSAC row before its inlier mask: R (9), t (3),
# s and the count's int32 bits
HORN_PACKED = 14


def horn_refit_plain(src, dst, valid, n_inl, inl, threshold: float,
                     with_scale: bool = False):
    """Plain version of K6's refit mode for one problem: the first row of
    the largest count in n_inl (H,) (as jnp.argmax), realigned on its
    inliers inl (H, N) with weights inl + 1e-9. Returns the packed row (14
    + N,) float32: R, t, s, the refit's inlier count's int32 bits, its mask
    as 0 / 1."""
    w = (inl[torch.argmax(n_inl)].to(torch.float32) + 1e-9)[None]
    R, t, s, count, mask = _horn_rows_plain(src, dst, valid, w, threshold,
                                            with_scale)
    return torch.cat([R.reshape(9), t.reshape(3), s, count.view(torch.float32),
                      mask[0].to(torch.float32)])


def horn_refit(src, dst, valid, n_inl, inl, threshold: float,
               with_scale: bool = False):
    """K6 wrapper, refit mode; the arguments and result of
    ``horn_refit_plain``, or of B problems with every tensor given a leading
    B (one launch, a block per problem)."""
    args = (src, dst, valid, n_inl, inl)
    if src.dim() == 2:
        if kernels.on_cpu(*args):
            return horn_refit_plain(*args, threshold, with_scale)
        return horn_refit(*[a[None] for a in args], threshold, with_scale)[0]
    if kernels.on_cpu(*args):
        return torch.stack([horn_refit_plain(*[a[i] for a in args], threshold,
                                             with_scale)
                            for i in range(src.shape[0])])
    b, n = valid.shape
    h = n_inl.shape[1]
    kernels.check(src, "src", torch.float32, (b, n, 3))
    kernels.check(dst, "dst", torch.float32, (b, n, 3))
    kernels.check(valid, "valid", torch.float32, (b, n))
    kernels.check(n_inl, "n_inl", torch.int32, (b, h))
    kernels.check(inl, "inl", torch.bool, (b, h, n))
    out = torch.empty((b, HORN_PACKED + n), dtype=torch.float32,
                      device=src.device)
    with torch.cuda.device(src.device):
        kernels.launch("psl_horn_refit", kernels.ptr(src), kernels.ptr(dst),
                       kernels.ptr(valid), kernels.ptr(n_inl),
                       kernels.ptr(inl), n, h, b,
                       float(np.float32(threshold)), int(with_scale),
                       kernels.ptr(out))
    kernels.LAUNCHES["horn_align_batch"] += 1
    return out


def unpack_horn(row: np.ndarray, n: int):
    """A packed refit row on the host -> (R (3, 3), t (3,), s, n_inl,
    inlier mask (n,))."""
    return (row[:9].reshape(3, 3).copy(), row[9:12].copy(), float(row[12]),
            int(row[13:14].view(np.int32)[0]),
            row[HORN_PACKED:HORN_PACKED + n] > 0)


def _ransac_align_plain(src, dst, valid, triplets, threshold: float,
                        with_scale: bool = False):
    """Plain version of the RANSAC: every triplet hypothesis scored, the
    refit on the first best one's inliers. Returns the packed row (14 +
    N,)."""
    _, _, _, n_inl, inl = horn_triplets_plain(src, dst, valid, triplets,
                                              threshold, with_scale)
    return horn_refit_plain(src, dst, valid, n_inl, inl, threshold,
                            with_scale)


def _ransac_align(src, dst, valid, triplets, threshold: float,
                  with_scale: bool = False):
    """K6's triplet launch, then its refit launch (their plain versions on
    the CPU): the packed row (14 + N,), or (B, 14 + N) for tensors with a
    leading B. With a leading B nothing runs between the launches."""
    _, _, _, n_inl, inl = horn_triplets(src, dst, valid, triplets, threshold,
                                        with_scale)
    return horn_refit(src, dst, valid, n_inl, inl, threshold, with_scale)


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


def _horn_ransac(src, dst, threshold: float, n_hyp: int, device,
                 with_scale: bool):
    """One upload, _ransac_align, one pull: (R, t, s, n_inl, inl (n,))."""
    s, d, v, picks = _pad_pair(src, dst, n_hyp)
    row = _ransac_align(*kernels.upload([a[None] for a in (s, d, v, picks)],
                                        device), threshold, with_scale)
    return unpack_horn(row.cpu().numpy()[0], len(src))


def horn_ransac_se3(src: np.ndarray, dst: np.ndarray,
                    threshold: float = 0.10, n_hyp: int = 64,
                    device="cuda") -> Tuple[np.ndarray, int, np.ndarray]:
    """RANSAC rigid alignment dst ~ T src on `device`. Returns (T (4, 4),
    n_inliers, inlier mask)."""
    device = resolve_device(device)
    n = len(src)
    if n < 3:
        return np.eye(4, dtype=np.float32), 0, np.zeros(n, bool)
    R, t, _, n_inl, inl = _horn_ransac(src, dst, threshold, n_hyp, device,
                                       False)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = R
    T[:3, 3] = t
    return T, n_inl, inl


def horn_ransac_sim3(src: np.ndarray, dst: np.ndarray,
                     threshold: float = 0.10, n_hyp: int = 64,
                     device="cuda"):
    """RANSAC similarity alignment dst ~ s R src + t on `device` (the
    scale free, as for monocular loops). Returns (T (4, 4) of (R, t), s,
    n_inliers, inlier mask)."""
    device = resolve_device(device)
    n = len(src)
    if n < 3:
        return np.eye(4, dtype=np.float32), 1.0, 0, np.zeros(n, bool)
    R, t, s, n_inl, inl = _horn_ransac(src, dst, threshold, n_hyp, device,
                                       True)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = R
    T[:3, 3] = t
    return T, s, n_inl, inl


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
