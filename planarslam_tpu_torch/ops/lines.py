"""Line-segment detection, band descriptors, 3D line lifting and guided
line matching.

Port of ``planarslam_tpu/ops/lines.py``. Detection is a
gradient-aligned Hough transform restricted to the strongest edge pixels
(an exact top-k here where the JAX module asks for ``approx_max_k``, which
is exact on the CPU), descriptors are LBD-style band statistics, and 3D
lifting is a fixed-table 2-point RANSAC with a PCA refit.

On the card each stage is a hand-written kernel on a leading batch of
frames (B = 1 on the streaming path): the 5-tap blur is K17, detection K20
and descriptors K21 (``csrc/lines.cu``), lifting K22 and the guided search
K23 (``csrc/line_lift_search.cu``), and the mutual descriptor matching of
two frames' segments, ``match_lines`` (no caller on the tracking path), K47
beside them. Each wrapper sits beside its plain version (``*_plain``),
which is what the CPU runs.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from planarslam_tpu_torch import kernels
from planarslam_tpu_torch.config import CameraConfig, LineConfig
from planarslam_tpu_torch.ops import image as image_ops
from planarslam_tpu_torch.ops.consts import const
from planarslam_tpu_torch.ops.eig3 import eigh_sym3x3
from planarslam_tpu_torch.ops.lax_compat import (linspace, mod, nanmedian,
                                                 segment_sum, top_k)

PI = math.pi


class LineFeatures(NamedTuple):
    uv_s: torch.Tensor    # (L, 2) 2D start endpoint
    uv_e: torch.Tensor    # (L, 2) 2D end endpoint
    line2d: torch.Tensor  # (L, 3) normalized line equation (a,b,c), a^2+b^2=1
    angle: torch.Tensor   # (L,) segment direction angle in [0, pi)
    response: torch.Tensor  # (L,) accumulated gradient support
    desc: torch.Tensor    # (L, D) float band descriptor (L2-normalized)
    p3d_s: torch.Tensor   # (L, 3) camera-frame 3D start (0 if none)
    p3d_e: torch.Tensor   # (L, 3) camera-frame 3D end
    has_3d: torch.Tensor  # (L,) bool
    valid: torch.Tensor   # (L,) bool


N_THETA = 36  # orientation bins over [0, pi)
S_BINS = 96   # position-histogram bins along a line
N_EDGE = 6144  # the strongest edge pixels the per-line work sees
RHO_RES = 2.0
# launches issued by one call of csrc/lines.cu::psl_detect_lines (besides
# a memset)
DETECT_LAUNCHES = 8
# csrc/line_lift_search.cu::psl_search_lines runs a problem of up to this
# many map lines as one cluster of blocks, one launch; above, two launches
SEARCH_CLUSTER_ROWS = 256


def search_launches(M: int) -> int:
    """K23's launches for one call over M map lines (its C entry reports
    what it made; this is what a caller expects)."""
    return 1 if M <= SEARCH_CLUSTER_ROWS else 2


class LineDetection(NamedTuple):
    """detect_lines' outputs for a batch of B frames (L = cfg.max_lines)."""

    uv_s: torch.Tensor      # (B, L, 2)
    uv_e: torch.Tensor      # (B, L, 2)
    line2d: torch.Tensor    # (B, L, 3)
    angle: torch.Tensor     # (B, L)
    response: torch.Tensor  # (B, L)
    valid: torch.Tensor     # (B, L) bool
    gx: torch.Tensor        # (B, H, W) Sobel gradients of the blurred frame
    gy: torch.Tensor        # (B, H, W)


def hough_shape(h: int, w: int) -> Tuple[float, int]:
    """(diag, n_rho) of an h x w frame's Hough accumulator."""
    diag = math.hypot(h, w)
    return diag, 2 * int(diag / RHO_RES) + 3


def _edge_slots(blurred: torch.Tensor, grad_threshold: float, E: int):
    """The edge stencil and the top-E edge pixels of one (H, W) blurred
    frame: (gx, gy, top_mag, top_pix, flat_t, flat_r), the slots ordered
    by magnitude descending, ties to the lower pixel; a slot whose
    magnitude is 0 is no edge."""
    h, w = blurred.shape
    dev = blurred.device
    gx, gy = image_ops.sobel_gradients(blurred)
    mag = torch.sqrt(gx * gx + gy * gy + 1e-12)

    ang_g = torch.atan2(gy, gx)
    q = torch.remainder(torch.round(ang_g / (PI / 4)).to(torch.int32), 4)
    shifts = [(0, 1), (1, 1), (1, 0), (1, -1)]

    def sh(a, dy, dx):
        return torch.roll(torch.roll(a, -dy, 0), -dx, 1)

    nms_keep = torch.zeros_like(mag, dtype=torch.bool)
    for k, (dy, dx) in enumerate(shifts):
        fwd = sh(mag, dy, dx)
        bwd = sh(mag, -dy, -dx)
        nms_keep = nms_keep | ((q == k) & (mag >= fwd) & (mag >= bwd))
    edge = nms_keep & (mag > grad_threshold)

    theta = mod(ang_g + PI / 2.0, PI)
    t_bin = torch.clamp((theta * N_THETA / PI).to(torch.int32), 0,
                        N_THETA - 1)

    vv = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w)
    uu = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w)
    n_ang = theta + PI / 2.0
    ca, sa = torch.cos(n_ang), torch.sin(n_ang)
    rho = uu * ca + vv * sa

    edge_score = torch.where(edge, mag, 0.0).reshape(-1)
    top_mag, top_pix = top_k(edge_score, E)
    return (gx, gy, top_mag, top_pix, t_bin.reshape(-1)[top_pix],
            rho.reshape(-1)[top_pix])


def _hough(top_mag: torch.Tensor, flat_t: torch.Tensor, flat_r: torch.Tensor,
           diag: float, n_rho: int) -> torch.Tensor:
    """The (N_THETA, n_rho) Hough vote of the edge slots: each bin sums the
    magnitudes of its slots in slot order (lax_compat.segment_sum)."""
    bin_id = flat_t * n_rho + torch.clamp(
        ((flat_r + diag) / RHO_RES).to(torch.int32), 0, n_rho - 1)
    hough = segment_sum(torch.where(top_mag > 0.0, top_mag, 0.0), bin_id,
                        N_THETA * n_rho)
    return hough.reshape(N_THETA, n_rho)


def _peaks(hough2d: torch.Tensor, L: int):
    """(top_val, top_idx) of the L best peaks of a Hough vote: bins not
    below their 3 x 3 maximum (theta wrapped, -inf beyond the rho range)
    keep their vote, the others score 0; ties go to the lower bin, so with
    fewer than L nonzero peaks the rest are the first zero-scored bins."""
    hp = torch.cat([hough2d[-1:], hough2d, hough2d[:1]], dim=0)
    local_max = image_ops.maxpool_3x3(hp)[1:-1]
    is_peak = hough2d >= local_max
    peak_score = torch.where(is_peak, hough2d, 0.0).reshape(-1)
    return top_k(peak_score, L)


def _longest_run(hist: torch.Tensor, threshold: float):
    """(run_start, run_end) per line of an (L, S_BINS) position histogram:
    occupied bins (above threshold) with single and double gaps filled
    between occupied neighbours (wrapping around the bins), then the
    longest run, the first of equal ones."""
    occupied = hist > (threshold * 1.0)
    left_near = torch.roll(occupied, 1, 1) | torch.roll(occupied, 2, 1)
    right_near = torch.roll(occupied, -1, 1) | torch.roll(occupied, -2, 1)
    occupied = occupied | (left_near & right_near)

    idx_row = torch.arange(S_BINS, dtype=torch.int32,
                           device=hist.device)[None, :]
    last_zero = torch.cummax(
        torch.where(occupied, -1, idx_row).to(torch.int32), dim=1).values
    run_len_at = torch.where(occupied, idx_row - last_zero, 0)
    run_len = run_len_at.amax(dim=1)
    run_end = torch.argmax(run_len_at, dim=1).to(torch.int32)
    return run_end - run_len + 1, run_end


def _line_support(flat_mag: torch.Tensor, top_pix: torch.Tensor,
                  flat_t: torch.Tensor, flat_r: torch.Tensor,
                  top_idx: torch.Tensor, w: int, diag: float, n_rho: int):
    """Each peak's line: (theta_l, rho_l, dirx, diry) (L,), its supporting
    edge slots, their position s_coord along the line and its bin s_bin
    (L, E), and the (L, S_BINS) position histogram of the supporters'
    magnitudes (each bin a segment sum)."""
    L = top_idx.shape[0]
    flat_edge = flat_mag > 0.0
    flat_u = (top_pix % w).to(torch.float32)
    flat_v = (top_pix // w).to(torch.float32)
    pk_t = top_idx // n_rho
    pk_r = top_idx % n_rho

    theta_l = (pk_t.to(torch.float32) + 0.5) * PI / N_THETA
    rho_l = (pk_r.to(torch.float32) + 0.5) * RHO_RES - diag

    dt = torch.abs(flat_t[None, :] - pk_t[:, None])
    dt = torch.minimum(dt, N_THETA - dt)
    support = (flat_edge[None, :] & (dt <= 1)
               & (torch.abs(flat_r[None, :] - rho_l[:, None]) < 1.5 * RHO_RES))

    dirx, diry = -torch.sin(theta_l + PI / 2), torch.cos(theta_l + PI / 2)
    s_coord = flat_u[None, :] * dirx[:, None] + flat_v[None, :] * diry[:, None]
    s_norm = (s_coord + diag) / (2 * diag)
    s_bin = torch.clamp((s_norm * S_BINS).to(torch.int32), 0, S_BINS - 1)

    lin_ids = torch.arange(L, dtype=torch.int32,
                           device=flat_mag.device)[:, None]
    seg_id = (lin_ids * S_BINS + s_bin).reshape(-1)
    seg_w = torch.where(support, flat_mag[None, :], 0.0).reshape(-1)
    hist = segment_sum(seg_w, seg_id, L * S_BINS).reshape(L, S_BINS)
    return theta_l, rho_l, dirx, diry, support, s_coord, s_bin, hist


def _detect_one(blurred: torch.Tensor, cfg: LineConfig,
                grad_threshold: float) -> LineDetection:
    """Plain detection on one (H, W) blurred frame (unbatched fields)."""
    dev = blurred.device
    h, w = blurred.shape
    L = cfg.max_lines
    diag, n_rho = hough_shape(h, w)

    # restrict all per-line work to the strongest E edge pixels
    E = min(N_EDGE, h * w)
    gx, gy, flat_mag, top_pix, flat_t, flat_r = _edge_slots(
        blurred, grad_threshold, E)
    top_val, top_idx = _peaks(_hough(flat_mag, flat_t, flat_r, diag, n_rho),
                              L)
    theta_l, rho_l, dirx, diry, support, s_coord, s_bin, hist = \
        _line_support(flat_mag, top_pix, flat_t, flat_r, top_idx, w, diag,
                      n_rho)
    run_start, run_end = _longest_run(hist, grad_threshold)

    in_run = ((s_bin >= run_start[:, None]) & (s_bin <= run_end[:, None])
              & support)
    s_lo = torch.where(in_run, s_coord, math.inf).amin(dim=1)
    s_hi = torch.where(in_run, s_coord, -math.inf).amax(dim=1)
    resp = torch.where(in_run, flat_mag[None, :], 0.0).sum(dim=1)

    nx, ny = torch.cos(theta_l + PI / 2), torch.sin(theta_l + PI / 2)
    foot = torch.stack([rho_l * nx, rho_l * ny], dim=-1)
    dvec = torch.stack([dirx, diry], dim=-1)
    uv_s = foot + s_lo[:, None] * dvec
    uv_e = foot + s_hi[:, None] * dvec

    length = s_hi - s_lo
    valid = ((top_val > 0) & (length >= cfg.min_length_px)
             & torch.isfinite(s_lo) & torch.isfinite(s_hi))

    order_score = torch.where(valid, resp, -1.0)
    keep_val, keep_idx = top_k(order_score, L)
    keep_mask = keep_val > 0
    if cfg.keep_top < L:
        keep_mask = keep_mask & (torch.arange(L, device=dev) < cfg.keep_top)

    uv_s = uv_s[keep_idx]
    uv_e = uv_e[keep_idx]
    resp = resp[keep_idx]
    theta_out = mod(theta_l[keep_idx], PI)
    valid = keep_mask

    ones = torch.ones((L, 1), dtype=torch.float32, device=dev)
    p1 = torch.cat([uv_s, ones], dim=-1)
    p2 = torch.cat([uv_e, ones], dim=-1)
    l_eq = torch.linalg.cross(p1, p2)
    norm = torch.sqrt(l_eq[:, 0] ** 2 + l_eq[:, 1] ** 2 + 1e-12)
    l_eq = l_eq / norm[:, None]
    return LineDetection(uv_s, uv_e, l_eq, theta_out, resp, valid, gx, gy)


def detect_lines_plain(blurred: torch.Tensor, cfg: LineConfig,
                       grad_threshold: float = 40.0) -> LineDetection:
    """Plain version of K20: gradient-aligned Hough line detection on
    (B, H, W) 5-tap blurred frames, one frame at a time."""
    per = [_detect_one(b, cfg, grad_threshold) for b in blurred]
    return LineDetection(*[torch.stack(f) for f in zip(*per)])


def detect_lines(blurred: torch.Tensor, cfg: LineConfig,
                 grad_threshold: float = 40.0) -> LineDetection:
    """K20 wrapper: line detection on (B, H, W) float32 5-tap blurred
    frames (K17's output) in one C call of DETECT_LAUNCHES launches. The
    gradients and the edge slots are the plain version's bits; the Hough
    votes, histograms and responses are sums in fixed orders of the
    kernel's own, equal to the plain version's to float rounding."""
    if kernels.on_cpu(blurred):
        return detect_lines_plain(blurred, cfg, grad_threshold)
    kernels.check(blurred, "blurred", torch.float32)
    if blurred.dim() != 3:
        raise ValueError(f"blurred: expected (B, H, W), got "
                         f"{tuple(blurred.shape)}")
    b, h, w = blurred.shape
    L, dev = cfg.max_lines, blurred.device
    diag, n_rho = hough_shape(h, w)
    E = min(N_EDGE, h * w)
    lib = kernels.cuda_lib()
    words = lib.psl_detect_lines_scratch_words(h, w, b, E, L, n_rho)
    scratch = torch.empty(words, dtype=torch.int32, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    gx = torch.empty((b, h, w), **f32)
    gy = torch.empty((b, h, w), **f32)
    uv_s = torch.empty((b, L, 2), **f32)
    uv_e = torch.empty((b, L, 2), **f32)
    line2d = torch.empty((b, L, 3), **f32)
    angle = torch.empty((b, L), **f32)
    resp = torch.empty((b, L), **f32)
    valid = torch.empty((b, L), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        kernels.launch("psl_detect_lines", kernels.ptr(blurred), h, w, b, E,
                       L, n_rho, cfg.keep_top, float(grad_threshold),
                       float(cfg.min_length_px), diag, kernels.ptr(scratch),
                       kernels.ptr(gx), kernels.ptr(gy), kernels.ptr(uv_s),
                       kernels.ptr(uv_e), kernels.ptr(line2d),
                       kernels.ptr(angle), kernels.ptr(resp),
                       kernels.ptr(valid))
    kernels.LAUNCHES["detect_lines"] += DETECT_LAUNCHES
    return LineDetection(uv_s, uv_e, line2d, angle, resp, valid, gx, gy)


def select_top_e(score: torch.Tensor, E: int):
    """K20's selection stage alone on (B, H, W) float32 scores >= 0 on the
    card (csrc/lines.cu::psl_lines_select, a memset and four launches):
    (values, pixels)
    (B, E), each frame's E largest scores as lax_compat.top_k orders them,
    the pixels int32. For the tests of the stage; detect_lines runs it
    inside its own launches."""
    kernels.check(score, "score", torch.float32)
    if score.dim() != 3 or score.device.type != "cuda":
        raise ValueError(f"score: expected (B, H, W) on the card, got "
                         f"{tuple(score.shape)} on {score.device}")
    b, h, w = score.shape
    dev = score.device
    words = kernels.cuda_lib().psl_lines_select_scratch_words(h, w, b, E)
    scratch = torch.empty(words, dtype=torch.int32, device=dev)
    pix = torch.empty((b, E), dtype=torch.int32, device=dev)
    val = torch.empty((b, E), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        kernels.launch("psl_lines_select", kernels.ptr(score), h, w, b, E,
                       kernels.ptr(scratch), kernels.ptr(pix),
                       kernels.ptr(val))
    return val, pix


N_BANDS = 9
BAND_WIDTH = 2.0  # pixels between band center lines
N_SAMPLES_DESC = 24
_DESC_ALPHAS = linspace(0.05, 0.95, N_SAMPLES_DESC)
_BAND_OFF = ((np.arange(N_BANDS) - (N_BANDS - 1) / 2.0)
             * BAND_WIDTH).astype(np.float32)


def _descriptors_one(gx: torch.Tensor, gy: torch.Tensor, uv_s: torch.Tensor,
                     uv_e: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Plain descriptors of one frame's (L,) segments."""
    dev = gx.device
    d = uv_e - uv_s
    length = torch.sqrt(torch.sum(d * d, dim=-1) + 1e-9)
    t = d / length[:, None]
    n = torch.stack([-t[:, 1], t[:, 0]], dim=-1)

    alphas = const("lines.desc_alphas", _DESC_ALPHAS, dev)
    band_off = const("lines.band_off", _BAND_OFF, dev)
    centers = (uv_s[:, None, None, :]
               + alphas[None, None, :, None] * d[:, None, None, :]
               + band_off[None, :, None, None] * n[:, None, None, :])
    sx = image_ops.bilinear_sample(gx, centers)
    sy = image_ops.bilinear_sample(gy, centers)
    g_par = sx * t[:, None, None, 0] + sy * t[:, None, None, 1]
    g_per = sx * n[:, None, None, 0] + sy * n[:, None, None, 1]

    feats = []
    for g in (g_par, g_per):
        pos = torch.clamp(g, min=0.0)
        neg = torch.clamp(-g, min=0.0)
        for comp in (pos, neg):
            feats.append(comp.mean(dim=-1))
            feats.append(comp.std(dim=-1, correction=0))
    desc = torch.cat(feats, dim=-1)
    desc = desc / torch.sqrt(torch.sum(desc * desc, dim=-1, keepdim=True)
                             + 1e-9)
    return desc * valid[:, None]


def line_descriptors_plain(gx: torch.Tensor, gy: torch.Tensor,
                           uv_s: torch.Tensor, uv_e: torch.Tensor,
                           valid: torch.Tensor) -> torch.Tensor:
    """Plain version of K21: LBD-style band descriptors, per band the mean
    and deviation of the positive and negative gradient parts parallel and
    perpendicular to the line, L2-normalized. gx, gy (B, H, W); uv_s, uv_e
    (B, L, 2); valid (B, L). Returns (B, L, N_BANDS * 8) float32."""
    return torch.stack([_descriptors_one(*a)
                        for a in zip(gx, gy, uv_s, uv_e, valid)])


def line_descriptors(gx: torch.Tensor, gy: torch.Tensor, uv_s: torch.Tensor,
                     uv_e: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """K21 wrapper: band descriptors of (B, L) segments in one launch; equal
    to the plain version to float rounding (its means and deviations reduce
    in PyTorch's order)."""
    if kernels.on_cpu(gx, gy, uv_s, uv_e, valid):
        return line_descriptors_plain(gx, gy, uv_s, uv_e, valid)
    b, h, w = gx.shape
    L = uv_s.shape[1]
    for t, name in ((gx, "gx"), (gy, "gy")):
        kernels.check(t, name, torch.float32, (b, h, w))
    kernels.check(uv_s, "uv_s", torch.float32, (b, L, 2))
    kernels.check(uv_e, "uv_e", torch.float32, (b, L, 2))
    kernels.check(valid, "valid", torch.bool, (b, L))
    alphas = const("lines.desc_alphas", _DESC_ALPHAS, gx.device)
    desc = torch.empty((b, L, N_BANDS * 8), dtype=torch.float32,
                       device=gx.device)
    with torch.cuda.device(gx.device):
        kernels.launch("psl_line_descriptors", kernels.ptr(gx),
                       kernels.ptr(gy), h, w, w - 1.001, h - 1.001,
                       kernels.ptr(uv_s), kernels.ptr(uv_e),
                       kernels.ptr(valid), b, L, kernels.ptr(alphas),
                       N_SAMPLES_DESC, BAND_WIDTH, kernels.ptr(desc))
    kernels.LAUNCHES["line_descriptors"] += 1
    return desc


def ransac_table(n_samples: int, iters: int) -> np.ndarray:
    """Fixed 2-point hypothesis table (iters, 2), numpy seed 99."""
    rng = np.random.default_rng(99)
    hyp = rng.integers(0, n_samples, (iters, 2))
    hyp[:, 1] = (hyp[:, 0] + 1 + rng.integers(0, n_samples - 1, iters)) \
        % n_samples
    return hyp.astype(np.int64)


def _lift_tables(cfg: LineConfig, dev) -> Tuple[torch.Tensor, torch.Tensor]:
    """The depth sample positions and the hypothesis table on `dev`."""
    S = cfg.n_depth_samples
    alphas = const(("lines.depth_alphas", S),
                   lambda: linspace(0.02, 0.98, S), dev)
    hyp = const(("lines.ransac_table", S, cfg.ransac_iters),
                lambda: ransac_table(S, cfg.ransac_iters), dev)
    return alphas, hyp


def _lift_one(depth: torch.Tensor, cam: CameraConfig, cfg: LineConfig,
              uv_s: torch.Tensor, uv_e: torch.Tensor, valid: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain lifting of one frame's (L,) segments."""
    dev = depth.device
    S = cfg.n_depth_samples
    alphas, hyp = _lift_tables(cfg, dev)
    pts2d = uv_s[:, None, :] + alphas[None, :, None] * (uv_e - uv_s)[:, None, :]
    z = image_ops.nearest_sample(depth, pts2d)
    z_ok = z > 1e-6
    x = (pts2d[..., 0] - cam.cx) / cam.fx * z
    y = (pts2d[..., 1] - cam.cy) / cam.fy * z
    p3 = torch.stack([x, y, z], dim=-1)

    sigma = cfg.depth_c1 * z * z + cfg.depth_c2 * z + cfg.depth_c3
    sigma = torch.clamp(sigma, min=2e-3)

    a = p3[:, hyp[:, 0], :]
    b = p3[:, hyp[:, 1], :]
    dvec = b - a
    dlen = torch.sqrt(torch.sum(dvec * dvec, dim=-1, keepdim=True) + 1e-12)
    dunit = dvec / dlen
    hyp_ok = z_ok[:, hyp[:, 0]] & z_ok[:, hyp[:, 1]] & (dlen[..., 0] > 0.02)

    rel = p3[:, None, :, :] - a[:, :, None, :]
    proj = torch.sum(rel * dunit[:, :, None, :], dim=-1, keepdim=True)
    perp = rel - proj * dunit[:, :, None, :]
    dist = torch.sqrt(torch.sum(perp * perp, dim=-1) + 1e-18)
    gate = 1.5 * sigma[:, None, :] + 0.01
    inl = (dist < gate) & z_ok[:, None, :]
    n_inl = torch.sum(inl, dim=-1).to(torch.int32) * hyp_ok
    best_h = torch.argmax(n_inl, dim=-1)
    best_inl = torch.gather(
        inl, 1, best_h[:, None, None].expand(-1, 1, S))[:, 0]
    best_n = torch.gather(n_inl, 1, best_h[:, None])[:, 0]

    wgt = best_inl.to(torch.float32)
    wsum = torch.clamp(wgt.sum(dim=-1, keepdim=True), min=1.0)
    mean = torch.sum(p3 * wgt[..., None], dim=1) / wsum
    cen = (p3 - mean[:, None, :]) * wgt[..., None]
    cov = torch.einsum("lsi,lsj->lij", cen, cen)
    cov = cov / wsum[..., None] + 1e-12 * torch.eye(3, device=dev)
    _, evecs = eigh_sym3x3(cov)
    dir3 = evecs[..., :, 2]

    s_par = torch.sum((p3 - mean[:, None, :]) * dir3[:, None, :], dim=-1)
    s_lo = torch.where(best_inl, s_par, math.inf).amin(dim=-1)
    s_hi = torch.where(best_inl, s_par, -math.inf).amax(dim=-1)
    p_s = mean + s_lo[:, None] * dir3
    p_e = mean + s_hi[:, None] * dir3

    has = (valid & (best_n >= int(0.6 * S))
           & torch.isfinite(s_lo) & torch.isfinite(s_hi)
           & ((s_hi - s_lo) > 0.05))
    zero = torch.zeros_like(p_s)
    return (torch.where(has[:, None], p_s, zero),
            torch.where(has[:, None], p_e, zero), has)


def lift_lines_3d_plain(depth: torch.Tensor, cam: CameraConfig,
                        cfg: LineConfig, uv_s: torch.Tensor,
                        uv_e: torch.Tensor, valid: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K22: sample depths along each 2D segment and fit a
    3D line robustly. depth (B, H, W); uv_s, uv_e (B, L, 2); valid (B, L).
    Returns (p3d_s (B, L, 3), p3d_e (B, L, 3), has_3d (B, L))."""
    per = [_lift_one(d, cam, cfg, s, e, v)
           for d, s, e, v in zip(depth, uv_s, uv_e, valid)]
    return tuple(torch.stack(f) for f in zip(*per))


def lift_lines_3d(depth: torch.Tensor, cam: CameraConfig, cfg: LineConfig,
                  uv_s: torch.Tensor, uv_e: torch.Tensor, valid: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K22 wrapper: 3D lifting of (B, L) segments in one launch; the
    inlier counts are the plain version's, the fit agrees to float
    rounding."""
    if kernels.on_cpu(depth, uv_s, uv_e, valid):
        return lift_lines_3d_plain(depth, cam, cfg, uv_s, uv_e, valid)
    b, h, w = depth.shape
    L = uv_s.shape[1]
    kernels.check(depth, "depth", torch.float32)
    kernels.check(uv_s, "uv_s", torch.float32, (b, L, 2))
    kernels.check(uv_e, "uv_e", torch.float32, (b, L, 2))
    kernels.check(valid, "valid", torch.bool, (b, L))
    dev = depth.device
    S = cfg.n_depth_samples
    alphas, hyp = _lift_tables(cfg, dev)
    p3d_s = torch.empty((b, L, 3), dtype=torch.float32, device=dev)
    p3d_e = torch.empty((b, L, 3), dtype=torch.float32, device=dev)
    has = torch.empty((b, L), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        kernels.launch("psl_lift_lines_3d", kernels.ptr(depth), h, w,
                       kernels.ptr(uv_s), kernels.ptr(uv_e),
                       kernels.ptr(valid), b, L, kernels.ptr(alphas), S,
                       kernels.ptr(hyp), cfg.ransac_iters, cam.fx, cam.fy,
                       cam.cx, cam.cy, cfg.depth_c1, cfg.depth_c2,
                       cfg.depth_c3, int(0.6 * S), kernels.ptr(p3d_s),
                       kernels.ptr(p3d_e), kernels.ptr(has))
    kernels.LAUNCHES["lift_lines_3d"] += 1
    return p3d_s, p3d_e, has


def _line_features(det: LineDetection, desc, lifted) -> LineFeatures:
    """The batched stage outputs as LineFeatures with a leading B."""
    p3s, p3e, has3d = lifted
    return LineFeatures(uv_s=det.uv_s, uv_e=det.uv_e, line2d=det.line2d,
                        angle=det.angle, response=det.response, desc=desc,
                        p3d_s=p3s, p3d_e=p3e, has_3d=has3d, valid=det.valid)


def extract_line_features_plain(gray: torch.Tensor, depth: torch.Tensor,
                                cam: CameraConfig, cfg: LineConfig
                                ) -> LineFeatures:
    """The line front end composed of the plain versions."""
    det = detect_lines_plain(image_ops.blur(gray, 5, 1.0)[None], cfg)
    desc = line_descriptors_plain(det.gx, det.gy, det.uv_s, det.uv_e,
                                  det.valid)
    lifted = lift_lines_3d_plain(depth[None], cam, cfg, det.uv_s, det.uv_e,
                                 det.valid)
    return LineFeatures(*[x[0] for x in _line_features(det, desc, lifted)])


@record_function("lines.extract_line_features")
def extract_line_features(gray: torch.Tensor, depth: torch.Tensor,
                          cam: CameraConfig, cfg: LineConfig) -> LineFeatures:
    """Full line front end for one frame, gray and depth (H, W), or for B
    frames (B, H, W), every output then with a leading B. On the card: one
    K17 launch, then K20 (one call), K21 and K22 for all frames, with
    allocations only between them."""
    if gray.dim() == 2:
        return LineFeatures(*[x[0] for x in _extract_lines_batched(
            gray[None], depth[None], cam, cfg)])
    return _extract_lines_batched(gray, depth, cam, cfg)


def _extract_lines_batched(gray: torch.Tensor, depth: torch.Tensor,
                           cam: CameraConfig, cfg: LineConfig
                           ) -> LineFeatures:
    """extract_line_features of B frames (B, H, W)."""
    if kernels.on_cpu(gray, depth):
        return kernels.per_problem(extract_line_features_plain,
                                   [gray, depth], cam, cfg)
    det = detect_lines(image_ops.gaussian_blur(gray, 5, 1.0), cfg)
    desc = line_descriptors(det.gx, det.gy, det.uv_s, det.uv_e, det.valid)
    lifted = lift_lines_3d(depth, cam, cfg, det.uv_s, det.uv_e, det.valid)
    return _line_features(det, desc, lifted)


def _adaptive_sim_gate(best: torch.Tensor, cand: torch.Tensor,
                       min_sim: float, floor: float,
                       lam: float = 1.0) -> torch.Tensor:
    """Per-frame MAD-adaptive acceptance threshold on best-match
    similarities, trusted only when >= 6 candidates clear the quality bar
    halfway between floor and min_sim (see the JAX module)."""
    bn = torch.where(cand, best, math.nan)
    med = nanmedian(bn)
    mad = 1.4826 * nanmedian(torch.abs(bn - med))
    th_adapt = torch.clamp(med - lam * mad, floor, min_sim)
    quality_bar = 0.5 * (floor + min_sim)
    earned = torch.sum((cand & (best >= quality_bar)).to(torch.int32)) >= 6
    th = torch.where(earned & torch.isfinite(th_adapt), th_adapt,
                     torch.full_like(th_adapt, min_sim))
    return best > th


def _first_max(x: torch.Tensor, dim: int):
    """(value, index) of the largest entry along dim in jnp.argmax's and
    lax.top_k's order: NaN above every number, the first index among
    equals."""
    best = torch.amax(x, dim=dim, keepdim=True)
    hit = (x == best) | (torch.isnan(x) & torch.isnan(best))
    n = x.shape[dim]
    pos = torch.arange(n, dtype=torch.int64, device=x.device)
    pos = pos.reshape([-1 if d == dim % x.dim() else 1
                       for d in range(x.dim())])
    idx = torch.amin(torch.where(hit, pos, n), dim=dim)
    return best.squeeze(dim), idx


def match_lines_plain(desc_a: torch.Tensor, desc_b: torch.Tensor,
                      valid_a: torch.Tensor, valid_b: torch.Tensor,
                      angle_a: torch.Tensor, angle_b: torch.Tensor,
                      max_angle: float = 0.26, ratio: float = 0.85,
                      min_sim: float = 0.75, sim_floor: float = 0.45):
    """Plain version of K47: mutual nearest-neighbour line matching on band
    descriptors with an orientation gate, the MAD-adaptive similarity gate
    and the ratio test. desc_a (A, D), desc_b (B, D), valid (A,), (B,)
    bool, angle (A,), (B,). Each similarity is the chain d = 0 .. D - 1 of
    rounded products and sums that K47 repeats; the top two of a row and a
    column's best row take NaN above every number and the first index
    among equals (lax.top_k's and jnp.argmax's order). Returns idx (A,)
    int32 (the matched segment of B, or -1) and best (A,), each row's best
    gated similarity."""
    a, b = desc_a[:, None, :], desc_b[None, :, :]
    sim = a[..., 0] * b[..., 0]
    for d in range(1, desc_a.shape[-1]):
        sim = sim + a[..., d] * b[..., d]
    da = torch.abs(angle_a[:, None] - angle_b[None, :])
    da = torch.minimum(da, PI - da)
    gate = valid_a[:, None] & valid_b[None, :] & (da < max_angle)
    sim = torch.where(gate, sim, -1.0)
    best, best_idx = _first_max(sim, 1)
    cols = torch.arange(sim.shape[1], device=sim.device)
    second = torch.amax(torch.where(cols[None] == best_idx[:, None],
                                    -math.inf, sim), dim=1)
    ok = (_adaptive_sim_gate(best, best > -0.5, min_sim, sim_floor)
          & ((1 - best) < ratio * (1 - second) + 1e-9))
    _, back = _first_max(sim, 0)
    rows = torch.arange(sim.shape[0], device=sim.device)
    ok = ok & (back[best_idx] == rows)
    return torch.where(ok, best_idx, -1).to(torch.int32), best


def match_lines(desc_a: torch.Tensor, desc_b: torch.Tensor,
                valid_a: torch.Tensor, valid_b: torch.Tensor,
                angle_a: torch.Tensor, angle_b: torch.Tensor,
                max_angle: float = 0.26, ratio: float = 0.85,
                min_sim: float = 0.75, sim_floor: float = 0.45):
    """Mutual line matching of two frames' segments: K47 on the card, the
    plain version on the CPU. Returns (idx (A,), best (A,)); with every
    tensor given a leading B, B problems in one launch (one block a
    problem), (idx (B, A), best (B, A))."""
    args = (desc_a, desc_b, valid_a, valid_b, angle_a, angle_b)
    kw = dict(max_angle=max_angle, ratio=ratio, min_sim=min_sim,
              sim_floor=sim_floor)
    if desc_a.dim() == 2:
        if kernels.on_cpu(*args):
            return match_lines_plain(*args, **kw)
        idx, best = match_lines(*[t[None] for t in args], **kw)
        return idx[0], best[0]
    if kernels.on_cpu(*args):
        return kernels.per_problem(match_lines_plain, args, **kw)
    b, A, D = desc_a.shape
    B = desc_b.shape[1]
    for t, name, shape in ((desc_a, "desc_a", (b, A, D)),
                           (desc_b, "desc_b", (b, B, D)),
                           (angle_a, "angle_a", (b, A)),
                           (angle_b, "angle_b", (b, B))):
        kernels.check(t, name, torch.float32, shape)
    kernels.check(valid_a, "valid_a", torch.bool, (b, A))
    kernels.check(valid_b, "valid_b", torch.bool, (b, B))
    dev = desc_a.device
    idx = torch.empty((b, A), dtype=torch.int32, device=dev)
    best = torch.empty((b, A), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        kernels.launch("psl_match_lines", kernels.ptr(desc_a),
                       kernels.ptr(desc_b), kernels.ptr(valid_a),
                       kernels.ptr(valid_b), kernels.ptr(angle_a),
                       kernels.ptr(angle_b), A, B, D, b, max_angle, ratio,
                       min_sim, sim_floor, 0.5 * (sim_floor + min_sim),
                       kernels.ptr(idx), kernels.ptr(best))
    kernels.LAUNCHES["match_lines"] += 1
    return idx, best


def search_lines_by_projection_plain(
        sw_w: torch.Tensor, ew_w: torch.Tensor, desc_m: torch.Tensor,
        valid_m: torch.Tensor, T_cw: torch.Tensor, f_uv_s: torch.Tensor,
        f_uv_e: torch.Tensor, f_angle: torch.Tensor, f_desc: torch.Tensor,
        f_valid: torch.Tensor, K: Tuple[float, float, float, float],
        image_wh: Tuple[float, float], radius: float = 12.0,
        max_angle: float = 0.26, min_sim: float = 0.7,
        sim_floor: float = 0.45):
    """Plain version of K23: guided line matching by projection. Project
    each map line's endpoints through T_cw, gate frame segments on endpoint
    distance to the projected infinite line, overlap, direction and
    descriptor similarity; best match per map line, duplicates resolved per
    frame line. Returns (idx (M,) frame-line index or -1, sim (M,))."""
    fx, fy, cx, cy = K
    W, H = image_wh
    R, t = T_cw[:3, :3], T_cw[:3, 3]
    ps = sw_w @ R.T + t
    pe = ew_w @ R.T + t
    zs, ze = ps[:, 2], pe[:, 2]
    in_front = (zs > 0.05) & (ze > 0.05)
    us = fx * ps[:, 0] / torch.clamp(zs, min=1e-6) + cx
    vs = fy * ps[:, 1] / torch.clamp(zs, min=1e-6) + cy
    ue = fx * pe[:, 0] / torch.clamp(ze, min=1e-6) + cx
    ve = fy * pe[:, 1] / torch.clamp(ze, min=1e-6) + cy
    on_s = (us >= 0) & (us < W) & (vs >= 0) & (vs < H)
    on_e = (ue >= 0) & (ue < W) & (ve >= 0) & (ve < H)
    vis = valid_m & in_front & (on_s | on_e)

    dx, dy = ue - us, ve - vs
    nrm = torch.sqrt(dx * dx + dy * dy) + 1e-9
    a = -dy / nrm
    b = dx / nrm
    c = -(a * us + b * vs)
    ang_p = mod(torch.atan2(dy, dx), PI)

    def dist_to(uv):
        return torch.abs(a[:, None] * uv[None, :, 0]
                         + b[:, None] * uv[None, :, 1] + c[:, None])

    close = (dist_to(f_uv_s) < radius) & (dist_to(f_uv_e) < radius)
    mid = 0.5 * (f_uv_s + f_uv_e)
    rel_u = mid[None, :, 0] - us[:, None]
    rel_v = mid[None, :, 1] - vs[:, None]
    tpar = (rel_u * dx[:, None] + rel_v * dy[:, None]) / (nrm[:, None] ** 2)
    overlap = (tpar > -0.25) & (tpar < 1.25)

    da = torch.abs(ang_p[:, None] - f_angle[None, :])
    da = torch.minimum(da, PI - da)

    sim = desc_m @ f_desc.T
    gate = (vis[:, None] & f_valid[None, :] & close & overlap
            & (da < max_angle))
    sim = torch.where(gate, sim, -1.0)
    best = torch.argmax(sim, dim=1)
    best_sim = torch.amax(sim, dim=1)
    ok = _adaptive_sim_gate(best_sim, best_sim > -0.5, min_sim, sim_floor)
    back = torch.argmax(sim, dim=0)
    ok = ok & (back[best] == torch.arange(sim.shape[0], device=sim.device))
    return torch.where(ok, best, -1).to(torch.int32), best_sim


def search_lines_by_projection_batched(
        sw_w: torch.Tensor, ew_w: torch.Tensor, desc_m: torch.Tensor,
        valid_m: torch.Tensor, T_cw: torch.Tensor, f_uv_s: torch.Tensor,
        f_uv_e: torch.Tensor, f_angle: torch.Tensor, f_desc: torch.Tensor,
        f_valid: torch.Tensor, K: Tuple[float, float, float, float],
        image_wh: Tuple[float, float], radius: float = 12.0,
        max_angle: float = 0.26, min_sim: float = 0.7,
        sim_floor: float = 0.45):
    """K23 wrapper: the guided search of B problems (every tensor with a
    leading B) in one C call of search_launches(M) launches: one cluster of
    blocks per problem up to SEARCH_CLUSTER_ROWS map lines, the row tiles
    and then the gate above. Returns (idx (B, M) int32, sim (B, M)). The
    descriptor products are chains of fused multiply-adds in index order:
    the plain version's products on the card (a library matrix product)
    agree to float rounding."""
    args = (sw_w, ew_w, desc_m, valid_m, T_cw, f_uv_s, f_uv_e, f_angle,
            f_desc, f_valid)
    kw = dict(K=K, image_wh=image_wh, radius=radius, max_angle=max_angle,
              min_sim=min_sim, sim_floor=sim_floor)
    if kernels.on_cpu(*args):
        per = [search_lines_by_projection_plain(*a, **kw) for a in zip(*args)]
        return tuple(torch.stack(f) for f in zip(*per))
    (sw_w, ew_w, desc_m, valid_m, T_cw, f_uv_s, f_uv_e, f_angle, f_desc,
     f_valid) = [t.contiguous() for t in args]
    b, M, D = desc_m.shape
    L = f_desc.shape[1]
    for t, name, shape in ((sw_w, "sw_w", (b, M, 3)), (ew_w, "ew_w", (b, M, 3)),
                           (T_cw, "T_cw", (b, 4, 4)),
                           (f_uv_s, "f_uv_s", (b, L, 2)),
                           (f_uv_e, "f_uv_e", (b, L, 2)),
                           (f_angle, "f_angle", (b, L)),
                           (f_desc, "f_desc", (b, L, D)),
                           (desc_m, "desc_m", (b, M, D))):
        kernels.check(t, name, torch.float32, shape)
    kernels.check(valid_m, "valid_m", torch.bool, (b, M))
    kernels.check(f_valid, "f_valid", torch.bool, (b, L))
    dev = desc_m.device
    lib = kernels.cuda_lib()
    scratch = torch.empty(lib.psl_search_lines_scratch_words(M, L, b),
                          dtype=torch.int32, device=dev)
    idx = torch.empty((b, M), dtype=torch.int32, device=dev)
    sim = torch.empty((b, M), dtype=torch.float32, device=dev)
    fx, fy, cx, cy = K
    W, H = image_wh
    launches = ctypes.c_int(0)
    with torch.cuda.device(dev):
        kernels.launch("psl_search_lines", kernels.ptr(sw_w),
                       kernels.ptr(ew_w), kernels.ptr(desc_m),
                       kernels.ptr(valid_m), kernels.ptr(T_cw), M,
                       kernels.ptr(f_uv_s), kernels.ptr(f_uv_e),
                       kernels.ptr(f_angle), kernels.ptr(f_desc),
                       kernels.ptr(f_valid), L, D, b, fx, fy, cx, cy, W, H,
                       radius, max_angle, min_sim, sim_floor,
                       0.5 * (sim_floor + min_sim), kernels.ptr(scratch),
                       kernels.ptr(idx), kernels.ptr(sim),
                       ctypes.addressof(launches))
    kernels.LAUNCHES["search_lines_by_projection"] += launches.value
    return idx, sim


@record_function("lines.search_lines_by_projection")
def search_lines_by_projection(
        sw_w: torch.Tensor, ew_w: torch.Tensor, desc_m: torch.Tensor,
        valid_m: torch.Tensor, T_cw: torch.Tensor, f_uv_s: torch.Tensor,
        f_uv_e: torch.Tensor, f_angle: torch.Tensor, f_desc: torch.Tensor,
        f_valid: torch.Tensor, K: Tuple[float, float, float, float],
        image_wh: Tuple[float, float], radius: float = 12.0,
        max_angle: float = 0.26, min_sim: float = 0.7,
        sim_floor: float = 0.45):
    """Guided line matching by projection of M map lines against a frame's
    L segments: K23 on the card, the plain version on the CPU. Returns (idx
    (M,) frame-line index or -1, sim (M,)). With T_cw (B, 4, 4), every
    tensor carries a leading B: the B problems of
    search_lines_by_projection_batched."""
    args = (sw_w, ew_w, desc_m, valid_m, T_cw, f_uv_s, f_uv_e, f_angle,
            f_desc, f_valid)
    kw = dict(K=K, image_wh=image_wh, radius=radius, max_angle=max_angle,
              min_sim=min_sim, sim_floor=sim_floor)
    if T_cw.dim() == 3:
        return search_lines_by_projection_batched(*args, **kw)
    if kernels.on_cpu(*args):
        return search_lines_by_projection_plain(*args, **kw)
    idx, sim = search_lines_by_projection_batched(*[t[None] for t in args],
                                                  **kw)
    return idx[0], sim[0]
