"""Closed-form rigid alignment (Horn) inside a fixed-hypothesis RANSAC.

Port of the RGB-D relocalization half of
``planarslam_tpu/solvers/sim3_solver.py`` (``horn_align``,
``_ransac_align``, ``_pad_bucket``, ``_pad_pair``, ``horn_ransac_se3``).
Scale is fixed to 1, as the RGB-D path of the JAX module uses it; the
similarity variant and ``refine_relative_se3`` belong to loop closing.

Kernel K6 ``horn_align_batch`` (``csrc/horn_align.cu``) aligns one weight
row per block and counts that row's inliers; ``horn_align_batch_plain`` is
its plain PyTorch version. A RANSAC launches it twice: the 64 one-hot
hypothesis rows, then the single row of the inlier refit. Hypotheses come
from ``np.random.default_rng(7)``, as in the JAX module, so both packages
draw the same triplets.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from planarslam_tpu_torch import kernels


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
                    threshold: float = 0.10, n_hyp: int = 64, device="cpu"
                    ) -> Tuple[np.ndarray, int, np.ndarray]:
    """RANSAC rigid alignment dst ~ T src on `device`. Returns (T (4, 4),
    n_inliers, inlier mask)."""
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
