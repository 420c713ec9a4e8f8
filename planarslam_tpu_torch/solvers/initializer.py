"""Monocular two-view initializer (H/F dual-model RANSAC).

Port of ``planarslam_tpu/solvers/initializer.py``, the rebuild of the
reference's ``Initializer`` (``src/Initializer.cc:49-123``): parallel
RANSAC over a fundamental matrix (8-point) and a homography (4-point DLT),
symmetric-transfer scoring, the reference's RH = SH / (SH + SF) selection,
then pose recovery through the essential matrix and triangulation with
cheirality checks. In the reference's RGB-D pipeline this path is dead
code (the call is disabled at ``src/Tracking.cc:1316``); no path of the
System reaches it.

Kernel K48 ``two_view_hypotheses`` (``csrc/two_view.cu``) solves and scores
every hypothesis (a warp's Jacobi solve for F and one for H, the block's
threads scoring both over the N correspondences);
``two_view_hypotheses_plain`` is its plain version. Kernel K49
``two_view_select`` (the same source) takes the first best F and H and
their final inlier masks into one packed row; ``two_view_select_plain`` is
its plain version. The model functions (``_eight_point_F``,
``_four_point_H``, ``_score_F``, ``_score_H``) are batched plain PyTorch:
the null vectors in float64, the scores in float32 with every product and
sum its own rounded op in the order the kernels repeat.

On the card an ``initialize_two_view`` is one pinned upload, K48, K49 and
one pull of the packed row; then, after the host's E decomposition, one
pinned upload of the four candidate projections and their points, one K50
launch (``triangulation.triangulate``, its X and ok views of one buffer)
over them and one pull (``kernels.pull``).

As in the JAX module, the 8-point system is built on raw pixels
(``_normalize_pts`` is defined and never called) and the picks are drawn
with replacement; both are faults of the reference, kept for parity.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from planarslam_tpu_torch import kernels
from planarslam_tpu_torch.device import resolve_device
from planarslam_tpu_torch.solvers import triangulation

# the score gates of the reference's CheckFundamental / CheckHomography
TH_F, TH_SCORE = 3.841, 5.991
N_HYP = 128
# floats of a packed K49 row before its two masks: F 9, H 9, sf, sh
TWO_VIEW_PACKED = 20


class InitResult(NamedTuple):
    success: bool
    T_21: np.ndarray        # pose of view 2 w.r.t. view 1 (unit translation)
    points3d: np.ndarray    # (N, 3) triangulated points in view-1 frame
    inliers: np.ndarray     # (N,) bool
    used_homography: bool
    score_h: float
    score_f: float


def _normalize_pts(x):
    """Hartley normalization of (N, 2) points: (points, T). Defined and, as
    in the JAX module, never called."""
    mean = x.mean(dim=0)
    d = torch.mean(torch.abs(x - mean), dim=0).clamp(min=1e-9)
    T = torch.tensor([[1 / float(d[0]), 0.0, -float(mean[0]) / float(d[0])],
                      [0.0, 1 / float(d[1]), -float(mean[1]) / float(d[1])],
                      [0.0, 0.0, 1.0]], dtype=x.dtype, device=x.device)
    xh = torch.cat([x, torch.ones_like(x[:, :1])], dim=-1)
    return (xh @ T.T)[:, :2], T


def _null_vector(A: torch.Tensor) -> torch.Tensor:
    """The last right singular vector (full matrices) of A (..., M, 9)."""
    return torch.linalg.svd(A, full_matrices=True)[2][..., -1, :]


def _eight_point_F(x1, x2):
    """x1, x2 (..., 8, 2) float32 pixels -> F (..., 3, 3) float32: the
    null vector of the 8 x 9 system in float64, then rank 2."""
    x1 = x1.to(torch.float64)
    x2 = x2.to(torch.float64)
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    A = torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1,
                     torch.ones_like(u1)], dim=-1)
    F = _null_vector(A).reshape(*A.shape[:-2], 3, 3)
    U, S, Vt = torch.linalg.svd(F)
    S = torch.cat([S[..., :2], torch.zeros_like(S[..., 2:])], dim=-1)
    return (U @ torch.diag_embed(S) @ Vt).to(torch.float32)


def _four_point_H(x1, x2):
    """DLT homography from 4 points: x1, x2 (..., 4, 2) float32 -> H (...,
    3, 3) float32, the null vector of the 8 x 9 system in float64."""
    x1 = x1.to(torch.float64)
    x2 = x2.to(torch.float64)
    u, v = x1[..., 0], x1[..., 1]
    x, y = x2[..., 0], x2[..., 1]
    one, zero = torch.ones_like(u), torch.zeros_like(u)
    r1 = torch.stack([-u, -v, -one, zero, zero, zero, x * u, x * v, x], -1)
    r2 = torch.stack([zero, zero, zero, -u, -v, -one, y * u, y * v, y], -1)
    A = torch.stack([r1, r2], dim=-2).reshape(*u.shape[:-1], 8, 9)
    return _null_vector(A).reshape(*A.shape[:-2], 3, 3).to(torch.float32)


def _rows(M, x, y, transpose: bool):
    """The three coordinates of M @ (x, y, 1) (M^T @ (x, y, 1) with
    `transpose`) for M (..., 3, 3) against points (N,): (x m0 + y m1) + m2,
    each (..., N)."""
    def m(a, k):
        return M[..., k, a:a + 1] if transpose else M[..., a, k:k + 1]
    return [(x * m(a, 0) + y * m(a, 1)) + m(a, 2) for a in range(3)]


def _line_dist(M, xa, ya, xb, yb, sigma2, transpose: bool):
    """The squared distance of (xb, yb) to the epipolar line of (xa, ya)
    over sigma^2."""
    l0, l1, l2 = _rows(M, xa, ya, transpose)
    num = (l0 * xb + l1 * yb) + l2
    return (num * num / ((l0 * l0 + l1 * l1) + 1e-12)) / sigma2


def _transfer_dist(M, xa, ya, xb, yb, sigma2):
    """The squared distance of (xb, yb) to M @ (xa, ya, 1) dehomogenized
    (|w| < 1e-12 -> 1e-12) over sigma^2."""
    p0, p1, p2 = _rows(M, xa, ya, False)
    w = torch.where(torch.abs(p2) < 1e-12, 1e-12, p2)
    dx = p0 / w - xb
    dy = p1 / w - yb
    return (dx * dx + dy * dy) / sigma2


def _score(d1, d2, th: float, th_score: float, valid):
    """(score (...), inliers (..., N)) of the distances in both views."""
    inl = (d1 < th) & (d2 < th) & valid
    score = torch.sum(torch.where((d1 < th) & valid, th_score - d1, 0.0)
                      + torch.where((d2 < th) & valid, th_score - d2, 0.0),
                      dim=-1)
    return score, inl


def _score_F(F, x1h, x2h, sigma2, valid):
    """Symmetric epipolar-transfer score (reference CheckFundamental) of F
    (..., 3, 3) over x1h, x2h (N, 3): (score (...), inliers (..., N))."""
    x1, y1, x2, y2 = x1h[:, 0], x1h[:, 1], x2h[:, 0], x2h[:, 1]
    d2 = _line_dist(F, x1, y1, x2, y2, sigma2, False)
    d1 = _line_dist(F, x2, y2, x1, y1, sigma2, True)
    return _score(d1, d2, TH_F, TH_SCORE, valid)


def _h_inverse(H):
    """inv(H + 1e-12 I) of H (..., 3, 3) float32: the float32 sum, then the
    adjugate over the determinant in float64, each product and sum in the
    order K48 and K49 repeat, rounded to float32."""
    Hp = (H + 1e-12 * torch.eye(3, dtype=H.dtype, device=H.device)).to(
        torch.float64)
    h = [[Hp[..., i, j] for j in range(3)] for i in range(3)]

    def cof(i, j):
        r0, r1 = [k for k in range(3) if k != i]
        c0, c1 = [k for k in range(3) if k != j]
        minor = h[r0][c0] * h[r1][c1] - h[r0][c1] * h[r1][c0]
        return minor if (i + j) % 2 == 0 else -minor

    c = [[cof(i, j) for j in range(3)] for i in range(3)]
    det = (h[0][0] * c[0][0] + h[0][1] * c[0][1]) + h[0][2] * c[0][2]
    inv = torch.stack([torch.stack([c[j][i] / det for j in range(3)], -1)
                       for i in range(3)], -2)
    return inv.to(torch.float32)


def _score_H(H, x1h, x2h, sigma2, valid):
    """Symmetric transfer score (reference CheckHomography) of H (..., 3,
    3): (score (...), inliers (..., N))."""
    x1, y1, x2, y2 = x1h[:, 0], x1h[:, 1], x2h[:, 0], x2h[:, 1]
    d2 = _transfer_dist(H, x1, y1, x2, y2, sigma2)
    d1 = _transfer_dist(_h_inverse(H), x2, y2, x1, y1, sigma2)
    return _score(d1, d2, TH_SCORE, TH_SCORE, valid)


def _homogeneous(uv):
    return torch.cat([uv, torch.ones_like(uv[:, :1])], dim=-1)


def two_view_picks(n: int, n_hyp: int = N_HYP) -> np.ndarray:
    """The JAX module's picks: (n_hyp, 8) int32 indices into the n true
    rows, drawn with replacement from np.random.default_rng(17); the H
    hypotheses take the first 4 of each."""
    rng = np.random.default_rng(17)
    return rng.integers(0, max(n, 1), (n_hyp, 8)).astype(np.int32)


def _finite_or(score, M):
    ok = torch.all(torch.isfinite(M).reshape(*M.shape[:-2], 9), dim=-1)
    return torch.where(ok, score, -1.0)


def two_view_hypotheses_plain(uv1, uv2, valid, sigma2, picks):
    """Plain version of K48. uv1, uv2 (N, 2) float32, valid (N,) bool,
    sigma2 (1,) float32, picks (H, 8) int32. Returns sf, sh (H,) float32
    (-1 where the model is not finite) and Fs, Hs (H, 3, 3) float32."""
    p = picks.to(torch.int64)
    Fs = _eight_point_F(uv1[p], uv2[p])
    Hs = _four_point_H(uv1[p[:, :4]], uv2[p[:, :4]])
    x1h, x2h = _homogeneous(uv1), _homogeneous(uv2)
    sf = _finite_or(_score_F(Fs, x1h, x2h, sigma2, valid)[0], Fs)
    sh = _finite_or(_score_H(Hs, x1h, x2h, sigma2, valid)[0], Hs)
    return sf, sh, Fs, Hs


def _empty(shape, dtype, dev) -> torch.Tensor:
    """K48's and K49's output allocator."""
    return torch.empty(shape, dtype=dtype, device=dev)


def two_view_hypotheses(uv1: torch.Tensor, uv2: torch.Tensor,
                        valid: torch.Tensor, sigma2: torch.Tensor,
                        picks: torch.Tensor):
    """K48 wrapper; the arguments and results of
    ``two_view_hypotheses_plain``, or of B problems with every tensor given
    a leading B (one launch)."""
    args = (uv1, uv2, valid, sigma2, picks)
    if uv1.dim() == 2:
        if kernels.on_cpu(*args):
            return two_view_hypotheses_plain(*args)
        return tuple(o[0] for o in two_view_hypotheses(*[a[None]
                                                         for a in args]))
    if kernels.on_cpu(*args):
        return kernels.per_problem(two_view_hypotheses_plain, args)
    b, n = uv1.shape[:2]
    h = picks.shape[1]
    kernels.check(uv1, "uv1", torch.float32, (b, n, 2))
    kernels.check(uv2, "uv2", torch.float32, (b, n, 2))
    kernels.check(valid, "valid", torch.bool, (b, n))
    kernels.check(sigma2, "sigma2", torch.float32, (b, 1))
    kernels.check(picks, "picks", torch.int32, (b, h, 8))
    dev = uv1.device
    sf = _empty((b, h), torch.float32, dev)
    sh = _empty((b, h), torch.float32, dev)
    Fs = _empty((b, h, 3, 3), torch.float32, dev)
    Hs = _empty((b, h, 3, 3), torch.float32, dev)
    with torch.cuda.device(dev):
        kernels.launch("psl_two_view_hypotheses", kernels.ptr(uv1),
                       kernels.ptr(uv2), kernels.ptr(valid),
                       kernels.ptr(sigma2), kernels.ptr(picks), n, h, b,
                       kernels.ptr(sf), kernels.ptr(sh), kernels.ptr(Fs),
                       kernels.ptr(Hs))
    kernels.LAUNCHES["two_view_hypotheses"] += 1
    return sf, sh, Fs, Hs


def two_view_select_plain(uv1, uv2, valid, sigma2, sf, sh, Fs, Hs):
    """Plain version of K49: the first hypotheses of the largest sf and sh
    (as jnp.argmax), and the final inlier masks of their F and H. Inputs of
    K48 for one problem and its outputs. Returns the packed row (20 + 2 N,)
    float32: F 9, H 9, sf, sh, the F mask and the H mask as 0 / 1."""
    bf, bh = torch.argmax(sf), torch.argmax(sh)
    F, H = Fs[bf], Hs[bh]
    x1h, x2h = _homogeneous(uv1), _homogeneous(uv2)
    _, inl_f = _score_F(F, x1h, x2h, sigma2, valid)
    _, inl_h = _score_H(H, x1h, x2h, sigma2, valid)
    return torch.cat([F.reshape(9), H.reshape(9), sf[bf].reshape(1),
                      sh[bh].reshape(1), inl_f.to(torch.float32),
                      inl_h.to(torch.float32)])


def two_view_select(uv1, uv2, valid, sigma2, sf, sh, Fs, Hs):
    """K49 wrapper; the arguments and result of ``two_view_select_plain``,
    or of B problems with every tensor given a leading B (one launch, one
    block a problem)."""
    args = (uv1, uv2, valid, sigma2, sf, sh, Fs, Hs)
    if uv1.dim() == 2:
        if kernels.on_cpu(*args):
            return two_view_select_plain(*args)
        return two_view_select(*[a[None] for a in args])[0]
    if kernels.on_cpu(*args):
        return torch.stack([two_view_select_plain(*[a[i] for a in args])
                            for i in range(uv1.shape[0])])
    b, n = uv1.shape[:2]
    h = sf.shape[1]
    kernels.check(uv1, "uv1", torch.float32, (b, n, 2))
    kernels.check(uv2, "uv2", torch.float32, (b, n, 2))
    kernels.check(valid, "valid", torch.bool, (b, n))
    kernels.check(sigma2, "sigma2", torch.float32, (b, 1))
    kernels.check(sf, "sf", torch.float32, (b, h))
    kernels.check(sh, "sh", torch.float32, (b, h))
    kernels.check(Fs, "Fs", torch.float32, (b, h, 3, 3))
    kernels.check(Hs, "Hs", torch.float32, (b, h, 3, 3))
    out = _empty((b, TWO_VIEW_PACKED + 2 * n), torch.float32, uv1.device)
    with torch.cuda.device(uv1.device):
        kernels.launch("psl_two_view_select", kernels.ptr(uv1),
                       kernels.ptr(uv2), kernels.ptr(valid),
                       kernels.ptr(sigma2), kernels.ptr(sf), kernels.ptr(sh),
                       kernels.ptr(Fs), kernels.ptr(Hs), n, h, b,
                       kernels.ptr(out))
    kernels.LAUNCHES["two_view_select"] += 1
    return out


def _dual_ransac(uv1, uv2, valid, sigma2, picks):
    """K48 then K49 (their plain versions on the CPU): the packed row (20 +
    2 N,) of the best F and H, or (B, 20 + 2 N) for tensors with a leading
    B. With a leading B nothing runs between the launches."""
    sf, sh, Fs, Hs = two_view_hypotheses(uv1, uv2, valid, sigma2, picks)
    return two_view_select(uv1, uv2, valid, sigma2, sf, sh, Fs, Hs)


def unpack_two_view(row: np.ndarray, n: int):
    """A packed row on the host -> (F, H, sf, sh, inl_f, inl_h), the JAX
    module's ``_dual_ransac`` results."""
    k = TWO_VIEW_PACKED
    return (row[:9].reshape(3, 3).copy(), row[9:18].reshape(3, 3).copy(),
            row[18], row[19], row[k:k + n] > 0, row[k + n:k + 2 * n] > 0)


def two_view_candidates(F: np.ndarray, Kmat: np.ndarray):
    """The essential-matrix pose recovery's four candidates of a float32 F:
    T21s (4, 4, 4), the first view's projection K [I | 0] (3, 4) and each
    candidate's K [R | t] (4, 3, 4), float32, the JAX module's host
    operations in its order."""
    E = Kmat.T @ F @ Kmat
    U, _, Vt = np.linalg.svd(E)
    if np.linalg.det(U) < 0:
        U = -U
    if np.linalg.det(Vt) < 0:
        Vt = -Vt
    W = np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1]], np.float32)
    t = U[:, 2]
    t = t / max(np.linalg.norm(t), 1e-9)
    candidates = [(U @ W @ Vt, t), (U @ W @ Vt, -t),
                  (U @ W.T @ Vt, t), (U @ W.T @ Vt, -t)]
    T21s = np.tile(np.eye(4, dtype=np.float32), (len(candidates), 1, 1))
    for T21, (R, tt) in zip(T21s, candidates):
        T21[:3, :3] = R
        T21[:3, 3] = tt
    P1 = Kmat @ np.eye(4, dtype=np.float32)[:3]
    return T21s, P1, np.stack([Kmat @ T[:3] for T in T21s])


def initialize_two_view(uv1: np.ndarray, uv2: np.ndarray, valid: np.ndarray,
                        K: Tuple[float, float, float, float],
                        sigma: float = 1.0, device="cuda") -> InitResult:
    """Full two-view initialization from matched pixel coordinates, on
    `device`: one pinned upload, K48 and K49, one pull; the host's model
    selection and E decomposition; one pinned upload, K50 over the four
    candidates, one pull."""
    device = resolve_device(device)
    fx, fy, cx, cy = K
    Kmat = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)
    n = len(uv1)
    uv1 = np.asarray(uv1).astype(np.float32)
    uv2 = np.asarray(uv2).astype(np.float32)
    ins = kernels.upload([uv1[None], uv2[None],
                          np.asarray(valid, bool)[None],
                          np.full((1, 1), sigma * sigma, np.float32),
                          two_view_picks(n)[None]], device)
    row = _dual_ransac(*ins).cpu().numpy()[0]
    F, H, sf, sh, inl_f, inl_h = unpack_two_view(row, n)
    sf, sh = float(sf), float(sh)
    rh = sh / max(sh + sf, 1e-9)  # reference model-selection heuristic
    use_h = rh > 0.40
    inliers = inl_h if use_h else inl_f
    if inliers.sum() < 8:
        return InitResult(False, np.eye(4, dtype=np.float32),
                          np.zeros((n, 3), np.float32), np.zeros(n, bool),
                          use_h, sh, sf)

    T21s, P1, P2s = two_view_candidates(F, Kmat)
    sel = np.flatnonzero(inliers)
    m = len(T21s)
    tri = kernels.upload([np.broadcast_to(P1, (m, 3, 4)), P2s,
                          np.broadcast_to(uv1[sel], (m, len(sel), 2)),
                          np.broadcast_to(uv2[sel], (m, len(sel), 2))],
                         device)
    Xs, fins = kernels.pull(*triangulation.triangulate(*tri))

    best = None
    for T21, X, fin in zip(T21s, Xs, fins):
        z1 = X[:, 2]
        X2 = X @ T21[:3, :3].T + T21[:3, 3]
        good = int(((z1 > 0) & (X2[:, 2] > 0) & fin).sum())
        if best is None or good > best[0]:
            best = (good, T21, X)
    n_good, T21, X = best
    pts = np.zeros((n, 3), np.float32)
    pts[sel] = X
    ok = n_good > 0.7 * len(sel) and n_good >= 8
    return InitResult(bool(ok), T21, pts, inliers, bool(use_h), sh, sf)
