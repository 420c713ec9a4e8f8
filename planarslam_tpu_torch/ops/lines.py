"""Line-segment detection, band descriptors, 3D line lifting and guided
line matching.

Port of ``planarslam_tpu/ops/lines.py`` (the tracking path's part: the
relocalization-only ``match_lines`` is not ported). Detection is a
gradient-aligned Hough transform restricted to the strongest edge pixels
(an exact top-k here where the JAX module asks for ``approx_max_k``, which
is exact on the CPU), descriptors are LBD-style band statistics, and 3D
lifting is a fixed-table 2-point RANSAC with a PCA refit.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch
from torch.profiler import record_function

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


def smoothed_gradients(gray: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sobel (gx, gy) of the 5-tap, sigma 1 blur of the frame (K17 on the
    card): what detection and descriptors both read."""
    return image_ops.sobel_gradients(image_ops.gaussian_blur(gray, 5, 1.0))


def detect_lines(gray: torch.Tensor, cfg: LineConfig,
                 grad_threshold: float = 40.0, grads=None
                 ) -> Tuple[torch.Tensor, ...]:
    """Gradient-aligned Hough line detection. Returns (uv_s, uv_e, line2d,
    angle, response, valid) with capacity cfg.max_lines. `grads` is
    smoothed_gradients(gray) where the caller has it already."""
    dev = gray.device
    h, w = gray.shape
    L = cfg.max_lines
    diag = math.hypot(h, w)
    rho_res = 2.0
    n_rho = 2 * int(diag / rho_res) + 3

    gx, gy = smoothed_gradients(gray) if grads is None else grads
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

    # restrict all per-line work to the strongest E edge pixels
    E = min(6144, h * w)
    edge_score = torch.where(edge, mag, 0.0).reshape(-1)
    top_mag, top_pix = top_k(edge_score, E)
    flat_edge = top_mag > 0.0
    flat_t = t_bin.reshape(-1)[top_pix]
    flat_r = rho.reshape(-1)[top_pix]
    flat_u = uu.reshape(-1)[top_pix]
    flat_v = vv.reshape(-1)[top_pix]
    flat_mag = top_mag

    bin_id = flat_t * n_rho + torch.clamp(
        ((flat_r + diag) / rho_res).to(torch.int32), 0, n_rho - 1)
    hough = segment_sum(torch.where(flat_edge, flat_mag, 0.0), bin_id,
                        N_THETA * n_rho)
    hough2d = hough.reshape(N_THETA, n_rho)
    hp = torch.cat([hough2d[-1:], hough2d, hough2d[:1]], dim=0)
    local_max = image_ops.maxpool_3x3(hp)[1:-1]
    is_peak = hough2d >= local_max
    peak_score = torch.where(is_peak, hough2d, 0.0).reshape(-1)
    top_val, top_idx = top_k(peak_score, L)
    pk_t = top_idx // n_rho
    pk_r = top_idx % n_rho

    theta_l = (pk_t.to(torch.float32) + 0.5) * PI / N_THETA
    rho_l = (pk_r.to(torch.float32) + 0.5) * rho_res - diag

    dt = torch.abs(flat_t[None, :] - pk_t[:, None])
    dt = torch.minimum(dt, N_THETA - dt)
    support = (flat_edge[None, :] & (dt <= 1)
               & (torch.abs(flat_r[None, :] - rho_l[:, None]) < 1.5 * rho_res))

    dirx, diry = -torch.sin(theta_l + PI / 2), torch.cos(theta_l + PI / 2)
    s_coord = flat_u[None, :] * dirx[:, None] + flat_v[None, :] * diry[:, None]
    s_norm = (s_coord + diag) / (2 * diag)
    s_bin = torch.clamp((s_norm * S_BINS).to(torch.int32), 0, S_BINS - 1)

    lin_ids = torch.arange(L, dtype=torch.int32, device=dev)[:, None]
    seg_id = (lin_ids * S_BINS + s_bin).reshape(-1)
    seg_w = torch.where(support, flat_mag[None, :], 0.0).reshape(-1)
    hist = segment_sum(seg_w, seg_id, L * S_BINS).reshape(L, S_BINS)

    occupied = hist > (grad_threshold * 1.0)
    left_near = torch.roll(occupied, 1, 1) | torch.roll(occupied, 2, 1)
    right_near = torch.roll(occupied, -1, 1) | torch.roll(occupied, -2, 1)
    occupied = occupied | (left_near & right_near)

    idx_row = torch.arange(S_BINS, dtype=torch.int32, device=dev)[None, :]
    last_zero = torch.cummax(
        torch.where(occupied, -1, idx_row).to(torch.int32), dim=1).values
    run_len_at = torch.where(occupied, idx_row - last_zero, 0)
    run_len = run_len_at.amax(dim=1)
    run_end = torch.argmax(run_len_at, dim=1).to(torch.int32)
    run_start = run_end - run_len + 1

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
    return uv_s, uv_e, l_eq, theta_out, resp, valid


N_BANDS = 9
BAND_WIDTH = 2.0  # pixels between band center lines
N_SAMPLES_DESC = 24
_DESC_ALPHAS = linspace(0.05, 0.95, N_SAMPLES_DESC)
_BAND_OFF = ((np.arange(N_BANDS) - (N_BANDS - 1) / 2.0)
             * BAND_WIDTH).astype(np.float32)


def line_descriptors(gray: torch.Tensor, uv_s: torch.Tensor,
                     uv_e: torch.Tensor, valid: torch.Tensor, grads=None
                     ) -> torch.Tensor:
    """LBD-style band descriptor: per band, mean and std of the gradient
    components parallel/perpendicular to the line, L2-normalized.
    (L, N_BANDS * 8) float32. `grads` is smoothed_gradients(gray) where the
    caller has it already."""
    dev = gray.device
    gx, gy = smoothed_gradients(gray) if grads is None else grads
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


def ransac_table(n_samples: int, iters: int) -> np.ndarray:
    """Fixed 2-point hypothesis table (iters, 2), numpy seed 99."""
    rng = np.random.default_rng(99)
    hyp = rng.integers(0, n_samples, (iters, 2))
    hyp[:, 1] = (hyp[:, 0] + 1 + rng.integers(0, n_samples - 1, iters)) \
        % n_samples
    return hyp.astype(np.int64)


def lift_lines_3d(depth: torch.Tensor, cam: CameraConfig, cfg: LineConfig,
                  uv_s: torch.Tensor, uv_e: torch.Tensor, valid: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sample depths along each 2D segment and robustly fit a 3D line.
    Returns (p3d_s (L,3), p3d_e (L,3), has_3d (L,))."""
    dev = depth.device
    S = cfg.n_depth_samples
    alphas = const(("lines.depth_alphas", S),
                   lambda: linspace(0.02, 0.98, S), dev)
    pts2d = uv_s[:, None, :] + alphas[None, :, None] * (uv_e - uv_s)[:, None, :]
    z = image_ops.nearest_sample(depth, pts2d)
    z_ok = z > 1e-6
    x = (pts2d[..., 0] - cam.cx) / cam.fx * z
    y = (pts2d[..., 1] - cam.cy) / cam.fy * z
    p3 = torch.stack([x, y, z], dim=-1)

    sigma = cfg.depth_c1 * z * z + cfg.depth_c2 * z + cfg.depth_c3
    sigma = torch.clamp(sigma, min=2e-3)

    hyp = const(("lines.ransac_table", S, cfg.ransac_iters),
                lambda: ransac_table(S, cfg.ransac_iters), dev)
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


@record_function("lines.extract_line_features")
def extract_line_features(gray: torch.Tensor, depth: torch.Tensor,
                          cam: CameraConfig, cfg: LineConfig) -> LineFeatures:
    """Full line front end for one frame."""
    grads = smoothed_gradients(gray)  # once for detection and descriptors
    uv_s, uv_e, l_eq, angle, resp, valid = detect_lines(gray, cfg,
                                                        grads=grads)
    desc = line_descriptors(gray, uv_s, uv_e, valid, grads=grads)
    p3s, p3e, has3d = lift_lines_3d(depth, cam, cfg, uv_s, uv_e, valid)
    return LineFeatures(uv_s=uv_s, uv_e=uv_e, line2d=l_eq, angle=angle,
                        response=resp, desc=desc, p3d_s=p3s, p3d_e=p3e,
                        has_3d=has3d, valid=valid)


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


@record_function("lines.search_lines_by_projection")
def search_lines_by_projection(
        sw_w: torch.Tensor, ew_w: torch.Tensor, desc_m: torch.Tensor,
        valid_m: torch.Tensor, T_cw: torch.Tensor, f_uv_s: torch.Tensor,
        f_uv_e: torch.Tensor, f_angle: torch.Tensor, f_desc: torch.Tensor,
        f_valid: torch.Tensor, K: Tuple[float, float, float, float],
        image_wh: Tuple[float, float], radius: float = 12.0,
        max_angle: float = 0.26, min_sim: float = 0.7,
        sim_floor: float = 0.45):
    """Guided line matching by projection: project each map line's
    endpoints through T_cw, gate frame segments on endpoint distance to the
    projected infinite line, overlap, direction and descriptor similarity;
    best match per map line, duplicates resolved per frame line.
    Returns (idx (M,) frame-line index or -1, sim (M,))."""
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
