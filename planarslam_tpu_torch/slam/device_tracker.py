"""The per-frame device tracking step and the state it carries.

Port of the streaming half of ``planarslam_tpu/slam/device_tracker.py``.
One call of ``fused_track_step`` issues, on the current CUDA stream and
with no host sync, the whole per-frame pipeline:

    extraction (points / lines / planes / normals)
  -> Manhattan rotation tracking
  -> frame-to-frame matching (projection search, brute-force fallback)
  -> pose optimization, rotation-frozen when the Manhattan frame tracked
  -> local-map point matching against the device-resident map window
  -> on-device plane association
  -> full pose optimization over point / line / plane residuals
  -> keyframe-policy statistics, packed into one float32 bundle.

The JAX module branches between the rotation-frozen and the full first
solve with ``lax.cond``; here the branch is a device-side mask: one
``pose_optimize`` call whose ``rotation_fixed`` is the bool tensor
``use_manh`` (see ``solvers/pose_opt.py``).

The previous frame's features and landmarks stay on the device between
frames (``LastState``). The host reads the packed bundle ``pipeline_depth``
frames later (``Tracking``).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from planarslam_tpu_torch.config import SystemConfig
from planarslam_tpu_torch.device import resolve_device
from planarslam_tpu_torch.geometry import plane as plane_geo
from planarslam_tpu_torch.geometry import se3
from planarslam_tpu_torch.ops import manhattan as manhattan_ops
from planarslam_tpu_torch.ops import matching
from planarslam_tpu_torch.ops.frontend import PointFeatures
from planarslam_tpu_torch.ops.lines import (LineFeatures,
                                            search_lines_by_projection)
from planarslam_tpu_torch.ops.planes import PlaneFeatures
from planarslam_tpu_torch.slam.frame import FrameFeatures, extract_frame
from planarslam_tpu_torch.solvers import pose_opt

WIN_PTS = 4096   # local-map point window capacity
WIN_LNS = 256    # local-map line window capacity
ASSOC_CLOUD = 512  # per-plane cloud subsample for on-device association


class LastState(NamedTuple):
    """Device-resident previous-frame state."""

    feats: FrameFeatures
    pt3d_w: torch.Tensor    # (K, 3) world positions of features with depth
    valid3d: torch.Tensor   # (K,) bool
    T_cw: torch.Tensor      # (4, 4) this frame's optimized pose
    velocity: torch.Tensor  # (4, 4) motion model T_cw_k @ inv(T_cw_{k-1})


class DeviceWindow(NamedTuple):
    """Device-resident local-map window (rebuilt on map mutation)."""

    pt_xyz: torch.Tensor      # (WIN_PTS, 3)
    pt_desc: torch.Tensor     # (WIN_PTS, 8) int32 bit patterns
    pt_normal: torch.Tensor   # (WIN_PTS, 3)
    pt_min_d: torch.Tensor    # (WIN_PTS,)
    pt_max_d: torch.Tensor    # (WIN_PTS,)
    pt_valid: torch.Tensor    # (WIN_PTS,) bool
    ln_sw: torch.Tensor       # (WIN_LNS, 3)
    ln_ew: torch.Tensor       # (WIN_LNS, 3)
    ln_desc: torch.Tensor     # (WIN_LNS, D)
    ln_valid: torch.Tensor    # (WIN_LNS,) bool
    pl_coeffs: torch.Tensor   # (Mp, 4) world plane coeffs
    pl_cloud: torch.Tensor    # (Mp, C, 3)
    pl_cloud_n: torch.Tensor  # (Mp,) int64
    pl_valid: torch.Tensor    # (Mp,) bool


class StepResult(NamedTuple):
    packed: torch.Tensor    # (B,) float32 packed host bundle
    new_state: LastState


class BundleLayout:
    """Static layout of the packed host bundle."""

    def __init__(self, cfg: SystemConfig):
        K = cfg.orb.max_keypoints
        L = cfg.lines.max_lines
        P = cfg.planes.max_planes
        self.fields = [
            ("T_out", (4, 4), np.float32),
            ("R_cm", (3, 3), np.float32),
            ("flags", (4,), np.float32),       # manh_success, use_manh,
                                               # n_in_stage1, n_in_stage2
            ("ff_idx", (K,), np.int32),        # last-feat -> cur-feat match
            ("win_idx", (K,), np.int32),       # cur-feat -> window point slot
            ("pt_inlier", (K,), np.int32),     # stage-2 point inlier mask
            ("win_found", (WIN_PTS,), np.int32),
            ("win_visible", (WIN_PTS,), np.int32),
            ("ln_win_idx", (L,), np.int32),
            ("ln_win_found", (WIN_LNS,), np.int32),
            ("ln_win_visible", (WIN_LNS,), np.int32),
            ("pl_direct", (P,), np.int32),     # frame plane -> map plane slot
            ("pl_par", (P,), np.int32),
            ("pl_ver", (P,), np.int32),
            ("pl_coeffs_w", (P, 4), np.float32),  # frame planes in world
            ("pl_valid", (P,), np.int32),
            ("kf_stats", (4,), np.float32),    # tracked_close, nontracked_
                                               # close, n_depth, n_tracked
        ]
        self.sizes = [int(np.prod(s)) for _, s, _ in self.fields]
        self.total = sum(self.sizes)

    def unpack(self, flat: np.ndarray) -> dict:
        out = {}
        off = 0
        for (name, shape, dtype), size in zip(self.fields, self.sizes):
            chunk = flat[off:off + size]
            if dtype == np.int32:
                chunk = chunk.view(np.int32)
            out[name] = chunk.reshape(shape).copy()
            off += size
        return out


def _f32_bits(a: torch.Tensor) -> torch.Tensor:
    """Flatten to float32: ints keep their bit pattern, floats and bools
    convert by value."""
    if a.dtype == torch.int32:
        return a.reshape(-1).view(torch.float32)
    if a.dtype in (torch.int64, torch.int16, torch.uint8):
        return a.to(torch.int32).reshape(-1).view(torch.float32)
    return a.to(torch.float32).reshape(-1)


@record_function("device_tracker._pack")
def _pack(layout: BundleLayout, **arrays) -> torch.Tensor:
    parts = []
    for name, shape, dtype in layout.fields:
        a = arrays[name]
        if dtype == np.int32:
            a = a.to(torch.int32)
        parts.append(_f32_bits(a))
    return torch.cat(parts)


def to_gray_depth(gray_raw: torch.Tensor, depth_raw: torch.Tensor,
                  cfg: SystemConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Native sensor formats (uint8 gray, uint16 depth) -> float32 gray in
    [0, 255] and depth in metres. Float inputs pass through as float32."""
    gray = gray_raw.to(torch.float32)
    if depth_raw.dtype in (torch.uint16, torch.int32):
        depth = depth_raw.to(torch.float32) / float(
            np.float32(cfg.camera.depth_map_factor))
    else:
        depth = depth_raw.to(torch.float32)
    return gray, depth


def unpack_frame(frame_u8: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(3, H, W) uint8 [gray, depth_lo, depth_hi] -> (gray uint8, depth as
    int32 holding the uint16 value)."""
    lo = frame_u8[1].to(torch.int32)
    hi = frame_u8[2].to(torch.int32)
    return frame_u8[0], torch.bitwise_or(lo, torch.bitwise_left_shift(hi, 8))


def pack_frame(gray: np.ndarray, depth: np.ndarray):
    """Host-side packing of a uint8 gray + uint16 depth frame into one
    (3, H, W) uint8 upload; None for other dtypes."""
    if gray.dtype != np.uint8 or depth.dtype != np.uint16:
        return None
    H, W = gray.shape
    out = np.empty((3, H, W), np.uint8)
    out[0] = gray
    out[1] = (depth & 0xFF).astype(np.uint8)
    out[2] = (depth >> 8).astype(np.uint8)
    return out


@record_function("device_tracker._state_from")
def _state_from(feats: FrameFeatures, T_cw, velocity,
                cfg: SystemConfig) -> LastState:
    cam = cfg.camera
    z = feats.points.depth
    has = (z > 0) & feats.points.valid
    x = (feats.points.uv[:, 0] - cam.cx) / cam.fx * z
    y = (feats.points.uv[:, 1] - cam.cy) / cam.fy * z
    pc = torch.stack([x, y, torch.clamp(z, min=0.0)], dim=-1)
    pw = se3.transform_points(se3.T_inv(T_cw), pc)
    return LastState(feats=feats, pt3d_w=torch.where(has[:, None], pw, 0.0),
                     valid3d=has, T_cw=T_cw, velocity=velocity)


@record_function("device_tracker._associate_planes_device")
def _associate_planes_device(feats: FrameFeatures, T_cw, win: DeviceWindow,
                             cfg: SystemConfig):
    """On-device PlaneMatcher: direct, parallel and vertical partners."""
    pcfg = cfg.planes
    pi_w = plane_geo.transform(se3.T_inv(T_cw), feats.planes.coeffs)
    nf_norm = torch.clamp(torch.linalg.norm(pi_w[:, :3], dim=-1), min=1e-9)
    nf = pi_w[:, :3] / nf_norm[:, None]
    nm = win.pl_coeffs[:, :3] / torch.clamp(
        torch.linalg.norm(win.pl_coeffs[:, :3], dim=-1, keepdim=True),
        min=1e-9)
    cos = torch.abs(nf @ nm.T)
    both = feats.planes.valid[:, None] & win.pl_valid[None, :]

    d_f = pi_w[:, 3] / nf_norm
    dots = torch.einsum("mcj,pj->pmc", win.pl_cloud, nf)
    dist = torch.abs(dots + d_f[:, None, None])
    c_ids = torch.arange(win.pl_cloud.shape[1], device=cos.device)
    dist = torch.where(c_ids[None, None, :] < win.pl_cloud_n[None, :, None],
                       dist, torch.inf)
    dmin = dist.amin(dim=-1)

    direct_ok = both & (cos > pcfg.assoc_angle) & (dmin < pcfg.assoc_dist)
    dscore = torch.where(direct_ok, dmin, torch.inf)
    best = torch.argmin(dscore, dim=-1)
    has_direct = torch.isfinite(dscore.amin(dim=-1))
    direct = torch.where(has_direct, best, -1).to(torch.int32)

    mp_ids = torch.arange(cos.shape[1], device=cos.device)[None, :]
    not_self = ~(has_direct[:, None] & (mp_ids == direct[:, None]))
    par_score = torch.where(both & not_self & (cos > pcfg.parallel_threshold),
                            cos, -1.0)
    par = torch.where(par_score.amax(dim=-1) > 0,
                      torch.argmax(par_score, dim=-1), -1).to(torch.int32)
    ver_score = torch.where(both & not_self & (cos < pcfg.vertical_threshold),
                            cos, 2.0)
    ver = torch.where(ver_score.amin(dim=-1) < 2.0,
                      torch.argmin(ver_score, dim=-1), -1).to(torch.int32)
    return direct, par, ver, pi_w


def fused_track_step(gray: torch.Tensor, depth: torch.Tensor,
                     T_override: torch.Tensor, use_override: torch.Tensor,
                     R_wm: torch.Tensor, manh_enabled: torch.Tensor,
                     last: LastState, win_flat: torch.Tensor,
                     weights: pose_opt.PoseOptWeights,
                     cfg: SystemConfig) -> StepResult:
    gray, depth = to_gray_depth(gray, depth, cfg)
    feats = extract_frame(gray, depth, cfg)
    return _track_core(feats, T_override, use_override, R_wm, manh_enabled,
                       last, win_flat, weights, cfg)


def fused_track_step_packed(frame_u8: torch.Tensor, T_override, use_override,
                            R_wm, manh_enabled, last: LastState, win_flat,
                            weights, cfg: SystemConfig) -> StepResult:
    """fused_track_step over one packed (3, H, W) uint8 sensor upload."""
    gray, depth16 = unpack_frame(frame_u8)
    return fused_track_step(gray, depth16, T_override, use_override, R_wm,
                            manh_enabled, last, win_flat, weights, cfg)


def _with_rotation(T: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    out = T.clone()
    out[:3, :3] = R
    return out


def _in_view(T, pts, K, cam) -> torch.Tensor:
    pc = se3.transform_points(T, pts)
    uv = se3.project(K, pc)
    return ((pc[:, 2] > 0.05) & (uv[:, 0] >= 0) & (uv[:, 0] < cam.width)
            & (uv[:, 1] >= 0) & (uv[:, 1] < cam.height))


def _track_core(feats: FrameFeatures, T_override, use_override, R_wm,
                manh_enabled, last: LastState, win_flat: torch.Tensor,
                weights: pose_opt.PoseOptWeights,
                cfg: SystemConfig) -> StepResult:
    """Everything after extraction: Manhattan tracking, matching, pose
    optimization, bundle packing."""
    win = unpack_window(win_flat, cfg)
    dev = win_flat.device
    cam = cfg.camera
    K = (cam.fx, cam.fy, cam.cx, cam.cy)
    wh = (float(cam.width), float(cam.height))
    layout = BundleLayout(cfg)
    with record_function("device_tracker.predict"):
        eye4 = torch.eye(4, dtype=torch.float32, device=dev)

        T_last = torch.where(use_override, T_override, last.T_cw)
        velocity = torch.where(use_override, eye4, last.velocity)
        T_pred = velocity @ T_last

        # ---- Manhattan rotation tracking (normals + line directions) ----------
        ln_vec = feats.lines.p3d_e - feats.lines.p3d_s
        ln_len = torch.linalg.norm(ln_vec, dim=-1, keepdim=True)
        ln_dir = ln_vec / torch.clamp(ln_len, min=1e-9)
        ln_dir_ok = feats.lines.has_3d & feats.lines.valid & (ln_len[:, 0] > 0.1)
    manh = manhattan_ops.track_manhattan_frame(
        T_pred[:3, :3] @ R_wm,
        torch.cat([feats.normals, ln_dir], dim=0),
        torch.cat([feats.normals_valid, ln_dir_ok], dim=0),
        cone_sin=cfg.manhattan.cone_sin_track,
        kernel=cfg.manhattan.mean_shift_kernel,
        min_support=cfg.manhattan.min_axis_support)
    use_manh = manh_enabled & manh.success
    T_init = torch.where(use_manh, _with_rotation(T_pred, manh.R_cm @ R_wm.T),
                         T_pred)

    # ---- frame-to-frame matching ----------------------------------------
    pts = feats.points
    proj = matching.search_by_projection(
        last.pt3d_w, last.feats.points.desc, last.valid3d, T_init,
        pts.uv, pts.desc, pts.level, pts.valid, pts.u_right,
        K=K, image_wh=wh, bf=cam.bf, scale_factor=cfg.orb.scale_factor,
        radius=15.0, max_dist=cfg.matcher.th_high,
        level_window=cfg.orb.n_levels)
    bf_res = matching.match_descriptors(
        last.feats.points.desc, pts.desc, last.valid3d, pts.valid,
        max_dist=cfg.matcher.th_low, ratio=0.9)
    inv_s2 = matching.level_inv_sigma2(cfg.orb.scale_factor,
                                       cfg.orb.n_levels, dev)

    with record_function("device_tracker.point_observations"):
        # the brute-force fallback below MIN_PROJ_MATCHES projection
        # matches, the rotation histogram and obs1's gathers (K26)
        fm = matching.frame_match_select(
            proj.idx[None], bf_res.idx[None], last.feats.points.angle[None],
            pts.angle[None], pts.uv[None], pts.u_right[None],
            pts.level[None], inv_s2)
        ff_idx = fm.ff_idx[0]
        obs1 = pose_opt.PointObs(xw=last.pt3d_w, uv=fm.uv[0],
                                 u_right=fm.u_right[0],
                                 inv_sigma2=fm.inv_sigma2[0],
                                 valid=fm.valid[0])

    # ---- line + plane association at the predicted pose -------------------
    lm_idx, _ = search_lines_by_projection(
        win.ln_sw, win.ln_ew, win.ln_desc, win.ln_valid, T_init,
        feats.lines.uv_s, feats.lines.uv_e, feats.lines.angle,
        feats.lines.desc, feats.lines.valid, K=K, image_wh=wh, radius=14.0)
    with record_function("device_tracker.line_observations"):
        la = matching.assemble_line_obs(lm_idx[None], win.ln_sw[None],
                                        win.ln_ew[None],
                                        feats.lines.valid[None])
        ln_slot = la.ln_slot[0]
        line_obs = pose_opt.LineObs(
            xw_s=la.xw_s[0], xw_e=la.xw_e[0], line2d=feats.lines.line2d,
            inv_sigma2=la.inv_sigma2[0], valid=la.valid[0])

    pl_direct, pl_par, pl_ver, _ = _associate_planes_device(
        feats, T_init, win, cfg)
    Mp = win.pl_coeffs.shape[0]

    def plane_block(ids):
        j = torch.clamp(ids, 0, Mp - 1).to(torch.int64)
        return pose_opt.PlaneObs(pi_w=win.pl_coeffs[j],
                                 pi_obs=feats.planes.coeffs,
                                 valid=(ids >= 0) & feats.planes.valid)

    with record_function("device_tracker.plane_observations"):
        pl_obs = plane_block(pl_direct)
        par_obs = plane_block(pl_par)
        ver_obs = plane_block(pl_ver)

    # rotation-frozen solve where the Manhattan frame tracked, full pose
    # otherwise: one solve, the branch is the device-side mask use_manh
    res1 = pose_opt.pose_optimize(T_init, K, cam.bf, points=obs1,
                                  lines=line_obs, planes=pl_obs,
                                  par_planes=par_obs, ver_planes=ver_obs,
                                  weights=weights, rotation_fixed=use_manh)
    enough1 = res1.n_point_inliers >= cfg.tracking.min_matches_track
    T1 = torch.where(enough1, res1.T_cw, T_init)

    # ---- local-map point matching ---------------------------------------
    win_res = matching.search_by_projection(
        win.pt_xyz, win.pt_desc, win.pt_valid, T1,
        pts.uv, pts.desc, pts.level, pts.valid, pts.u_right,
        K=K, image_wh=wh, bf=cam.bf, scale_factor=cfg.orb.scale_factor,
        radius=4.0, max_dist=cfg.matcher.th_high,
        view_normals=win.pt_normal,
        dist_range=(win.pt_min_d, win.pt_max_d), level_window=1)
    with record_function("device_tracker.map_observations"):
        # window matches first, the frame-to-frame landmarks fill the rest
        # (K27)
        pa = matching.assemble_point_obs(
            win_res.idx[None], ff_idx[None], last.pt3d_w[None],
            win.pt_xyz[None], pts.valid[None], pts.u_right[None],
            pts.level[None], inv_s2)
        feat_slot = pa.feat_slot[0]
        has_slot = feat_slot >= 0
        obs2_valid = pa.valid[0]
        obs2 = pose_opt.PointObs(xw=pa.xw[0], uv=pts.uv,
                                 u_right=pa.u_right[0],
                                 inv_sigma2=pa.inv_sigma2[0],
                                 valid=obs2_valid)

    # ---- final full pose optimization ------------------------------------
    res2 = pose_opt.pose_optimize(T1, K, cam.bf, points=obs2, lines=line_obs,
                                  planes=pl_obs, par_planes=par_obs,
                                  ver_planes=ver_obs, weights=weights,
                                  rotation_fixed=False)
    ok2 = res2.n_point_inliers >= cfg.tracking.min_matches_local_map // 2
    T_out = torch.where(ok2, res2.T_cw, T1)

    with record_function("device_tracker.keyframe_stats"):
        inl = res2.point_inlier
        feat_slot_out = torch.where(inl | ~has_slot, feat_slot, -1)

        ln_win_found = lm_idx >= 0
        ln_win_visible = win.ln_valid & _in_view(
            T_out, 0.5 * (win.ln_sw + win.ln_ew), K, cam)
        win_found = win_res.idx >= 0
        win_visible = win.pt_valid & _in_view(T_out, win.pt_xyz, K, cam)

        close = (pts.depth > 0) & (pts.depth < cam.depth_threshold)
        tracked = obs2_valid & inl
        kf_stats = torch.stack([
            torch.sum((close & tracked).to(torch.float32)),
            torch.sum((close & ~tracked & pts.valid).to(torch.float32)),
            torch.sum((pts.depth > 0).to(torch.float32)),
            torch.sum(tracked.to(torch.float32)),
        ])

    packed = _pack(
        layout, T_out=T_out, R_cm=manh.R_cm,
        flags=torch.stack([manh.success.to(torch.float32),
                           use_manh.to(torch.float32),
                           res1.n_point_inliers.to(torch.float32),
                           res2.n_point_inliers.to(torch.float32)]),
        ff_idx=ff_idx, win_idx=feat_slot_out, pt_inlier=inl,
        win_found=win_found, win_visible=win_visible, ln_win_idx=ln_slot,
        ln_win_found=ln_win_found, ln_win_visible=ln_win_visible,
        pl_direct=pl_direct, pl_par=pl_par, pl_ver=pl_ver,
        pl_coeffs_w=plane_geo.transform(se3.T_inv(T_out),
                                        feats.planes.coeffs),
        pl_valid=feats.planes.valid, kf_stats=kf_stats)

    new_vel = T_out @ se3.T_inv(T_last)
    return StepResult(packed=packed,
                      new_state=_state_from(feats, T_out, new_vel, cfg))


# ---------------------------------------------------------------------------
# keyframe feature pull: one packed float32 buffer, plane label downsampled


def _label_ds(h: int) -> int:
    return max(1, min(4, h // 120))


def feature_shapes(cfg: SystemConfig):
    """(dtype, shape) of every FrameFeatures leaf, in pack order, derived
    from the configuration (the pixel label at its downsampled size)."""
    K = cfg.orb.max_keypoints
    L = cfg.lines.max_lines
    D = cfg.lines.desc_dim
    P = cfg.planes.max_planes
    H, W = cfg.camera.height, cfg.camera.width
    ds = _label_ds(H)
    f, i, u, b = np.float32, np.int32, np.uint32, np.bool_
    return FrameFeatures(
        points=PointFeatures(uv=(f, (K, 2)), uv_raw=(f, (K, 2)),
                             response=(f, (K,)), level=(i, (K,)),
                             angle=(f, (K,)), desc=(u, (K, 8)),
                             depth=(f, (K,)), u_right=(f, (K,)),
                             valid=(b, (K,))),
        lines=LineFeatures(uv_s=(f, (L, 2)), uv_e=(f, (L, 2)),
                           line2d=(f, (L, 3)), angle=(f, (L,)),
                           response=(f, (L,)), desc=(f, (L, D)),
                           p3d_s=(f, (L, 3)), p3d_e=(f, (L, 3)),
                           has_3d=(b, (L,)), valid=(b, (L,))),
        planes=PlaneFeatures(coeffs=(f, (P, 4)), centroid=(f, (P, 3)),
                             count=(i, (P,)), valid=(b, (P,)),
                             pixel_label=(i, (-(-H // ds), -(-W // ds)))),
        normals=(f, (cfg.manhattan.max_normals, 3)),
        normals_valid=(b, (cfg.manhattan.max_normals,)))


def _flatten(feats: FrameFeatures) -> list:
    return [*feats.points, *feats.lines, *feats.planes, feats.normals,
            feats.normals_valid]


def _unflatten(leaves: list) -> FrameFeatures:
    np_ = len(PointFeatures._fields)
    nl = len(LineFeatures._fields)
    npl = len(PlaneFeatures._fields)
    pts = PointFeatures(*leaves[:np_])
    lns = LineFeatures(*leaves[np_:np_ + nl])
    pls = PlaneFeatures(*leaves[np_ + nl:np_ + nl + npl])
    return FrameFeatures(points=pts, lines=lns, planes=pls,
                         normals=leaves[-2], normals_valid=leaves[-1])


class FeatsHostLayout:
    """Layout for pulling a FrameFeatures to the host as one float32 buffer
    (ints bitcast, bools as 0/1), plane label downsampled and block-
    upsampled back to (H, W) on unpack. Descriptors come back as uint32."""

    def __init__(self, cfg: SystemConfig):
        self.leaves = _flatten(feature_shapes(cfg))
        self.sizes = [int(np.prod(s)) for _, s in self.leaves]
        self.total = sum(self.sizes)
        self._hw = (cfg.camera.height, cfg.camera.width)

    def unpack(self, flat: np.ndarray) -> FrameFeatures:
        out = []
        off = 0
        for (dtype, shape), size in zip(self.leaves, self.sizes):
            chunk = flat[off:off + size]
            if dtype == np.bool_:
                arr = chunk > 0.5
            elif dtype in (np.int32, np.uint32):
                arr = chunk.view(dtype)
            else:
                arr = chunk.astype(dtype)
            out.append(arr.reshape(shape).copy())
            off += size
        feats = _unflatten(out)
        H, W = self._hw
        ds = _label_ds(H)
        lbl = np.repeat(np.repeat(feats.planes.pixel_label, ds, 0),
                        ds, 1)[:H, :W]
        return feats._replace(planes=feats.planes._replace(pixel_label=lbl))


def pack_feats(feats: FrameFeatures) -> torch.Tensor:
    """Flatten a FrameFeatures to one (total,) float32 device tensor
    (FeatsHostLayout order, plane label downsampled)."""
    ds = _label_ds(feats.planes.pixel_label.shape[0])
    feats = feats._replace(planes=feats.planes._replace(
        pixel_label=feats.planes.pixel_label[::ds, ::ds]))
    return torch.cat([_f32_bits(a) for a in _flatten(feats)])


def feats_to_numpy(feats: FrameFeatures) -> FrameFeatures:
    """Device FrameFeatures -> numpy (descriptors as uint32)."""
    out = _unflatten([a.cpu().numpy() for a in _flatten(feats)])
    return out._replace(points=out.points._replace(
        desc=out.points.desc.view(np.uint32)))


# ---------------------------------------------------------------------------
# local-map window: one packed float32 upload


def build_window(slam_map, kf_ids: np.ndarray, cfg: SystemConfig,
                 device) -> Tuple[torch.Tensor, np.ndarray, np.ndarray]:
    """Gather the local-map window from the host map and upload it as one
    packed float32 buffer. Returns (packed device tensor, pt_ids
    (WIN_PTS,), ln_ids (WIN_LNS,)); the id arrays map window slots back to
    map landmark ids (-1 for padding)."""
    flat, pt_pad, ln_pad = build_window_host(slam_map, kf_ids, cfg)
    return torch.from_numpy(flat).to(device), pt_pad, ln_pad


def build_window_host(slam_map, kf_ids: np.ndarray, cfg: SystemConfig):
    m = slam_map
    pt_ids = m.local_map_points(kf_ids, cap=WIN_PTS)
    ln_ids = m.local_map_lines(kf_ids, cap=WIN_LNS)
    pt_pad = np.full(WIN_PTS, -1, np.int64)
    pt_pad[:len(pt_ids)] = pt_ids
    ln_pad = np.full(WIN_LNS, -1, np.int64)
    ln_pad[:len(ln_ids)] = ln_ids
    ip = np.clip(pt_pad, 0, None)
    il = np.clip(ln_pad, 0, None)
    parts = [
        m.pt_xyz[ip].astype(np.float32),
        m.pt_desc[ip].view(np.float32),
        m.pt_normal[ip].astype(np.float32),
        m.pt_min_dist[ip].astype(np.float32),
        m.pt_max_dist[ip].astype(np.float32),
        (pt_pad >= 0).astype(np.float32),
        m.ln_sw[il].astype(np.float32),
        m.ln_ew[il].astype(np.float32),
        m.ln_desc[il].astype(np.float32),
        (ln_pad >= 0).astype(np.float32),
        m.pl_coeffs.astype(np.float32),
        _subsample_clouds_fixed(m).astype(np.float32),
        np.minimum(m.pl_cloud_n, ASSOC_CLOUD).astype(np.float32),
        m.pl_valid.astype(np.float32),
    ]
    flat = np.concatenate([p.reshape(-1) for p in parts])
    return flat, pt_pad, ln_pad


@record_function("device_tracker.unpack_window")
def unpack_window(flat: torch.Tensor, cfg: SystemConfig) -> DeviceWindow:
    """Views into build_window's packed buffer."""
    W, Wl = WIN_PTS, WIN_LNS
    Mp = cfg.map.max_planes
    ld = cfg.lines.desc_dim
    shapes = [
        (W, 3), (W, 8), (W, 3), (W,), (W,), (W,),
        (Wl, 3), (Wl, 3), (Wl, ld), (Wl,),
        (Mp, 4), (Mp, ASSOC_CLOUD, 3), (Mp,), (Mp,),
    ]
    fields = []
    off = 0
    for shp in shapes:
        n = int(np.prod(shp))
        fields.append(flat[off:off + n].reshape(shp))
        off += n
    (pt_xyz, pt_desc_f, pt_normal, pt_min_d, pt_max_d, pt_valid_f,
     ln_sw, ln_ew, ln_desc, ln_valid_f,
     pl_coeffs, pl_cloud, pl_cloud_n_f, pl_valid_f) = fields
    return DeviceWindow(
        pt_xyz=pt_xyz, pt_desc=pt_desc_f.view(torch.int32),
        pt_normal=pt_normal, pt_min_d=pt_min_d, pt_max_d=pt_max_d,
        pt_valid=pt_valid_f > 0.5,
        ln_sw=ln_sw, ln_ew=ln_ew, ln_desc=ln_desc,
        ln_valid=ln_valid_f > 0.5,
        pl_coeffs=pl_coeffs, pl_cloud=pl_cloud,
        pl_cloud_n=pl_cloud_n_f.to(torch.int64),
        pl_valid=pl_valid_f > 0.5,
    )


def _subsample_clouds_fixed(m) -> np.ndarray:
    """_subsample_clouds with the shape forced to (Mp, ASSOC_CLOUD, 3)."""
    sub = _subsample_clouds(m)
    mp, c, _ = sub.shape
    if c == ASSOC_CLOUD:
        return sub
    out = np.zeros((mp, ASSOC_CLOUD, 3), sub.dtype)
    out[:, :min(c, ASSOC_CLOUD)] = sub[:, :ASSOC_CLOUD]
    return out


def _subsample_clouds(m) -> np.ndarray:
    """Strided subsample of each plane's cloud to ASSOC_CLOUD points."""
    full = m.pl_cloud
    mp, c, _ = full.shape
    if c <= ASSOC_CLOUD:
        return full
    n = np.maximum(m.pl_cloud_n.astype(np.int64), 1)
    idx = (np.arange(ASSOC_CLOUD)[None, :] * n[:, None]) // ASSOC_CLOUD
    return np.take_along_axis(full, idx[:, :, None], axis=1)


# ---------------------------------------------------------------------------
# state carried across from the JAX package (numpy in, tensors out)


def _tensor_from(x, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a)).to(device)


_NESTED = {(LastState, "feats"): FrameFeatures,
           (FrameFeatures, "points"): PointFeatures,
           (FrameFeatures, "lines"): LineFeatures,
           (FrameFeatures, "planes"): PlaneFeatures}


def _convert(cls, src, device):
    vals = {}
    for name in cls._fields:
        v = src[name] if isinstance(src, dict) else getattr(src, name)
        sub = _NESTED.get((cls, name))
        vals[name] = (_convert(sub, v, device) if sub is not None
                      else _tensor_from(v, device))
    return cls(**vals)


def state_from_numpy(last, win_flat: np.ndarray, device="cuda"
                     ) -> Tuple[LastState, torch.Tensor]:
    """A JAX ``LastState`` (any object or dict with the same field names,
    holding numpy arrays) and the packed window of ``build_window`` (numpy)
    -> the port's LastState and window tensor. Descriptors arrive as uint32
    and become int32 bit patterns."""
    device = resolve_device(device)
    state = _convert(LastState, last, device)
    return state, _tensor_from(np.asarray(win_flat, np.float32), device)


def map_from_numpy(src, cfg: SystemConfig):
    """A port SlamMap holding copies of another map's arrays and counters
    (any object with SlamMap's attributes, such as the JAX package's map):
    slam/map.py stays a verbatim copy, so the conversion lives here."""
    import copy

    from planarslam_tpu_torch.slam.map import SlamMap

    out = SlamMap(cfg)
    for name, value in vars(src).items():
        if name == "cfg":
            continue
        setattr(out, name, value.copy() if isinstance(value, np.ndarray)
                else copy.deepcopy(value))
    return out


def loop_closer_from_numpy(src, cfg: SystemConfig, slam_map,
                           device="cuda"):
    """A port LoopClosing over `slam_map` carrying another loop closer's
    state (any object with LoopClosing's attributes, such as the JAX
    package's): the consistency streaks, loop count, last loop keyframe,
    last fuse count and run_gba; its keyframe database's sampled bit
    positions come along (the sketches live in the map)."""
    from planarslam_tpu_torch.slam.loop_closing import LoopClosing
    from planarslam_tpu_torch.slam.retrieval import KeyFrameDatabase

    db = KeyFrameDatabase(cfg)
    db.bit_positions = np.array(src.db.bit_positions)
    out = LoopClosing(cfg, slam_map, kf_db=db, run_gba=bool(src.run_gba),
                      device=device)
    out._consistency = {int(k): int(v) for k, v in src._consistency.items()}
    out.loops_closed = int(src.loops_closed)
    out.last_loop_kf = int(src.last_loop_kf)
    out.last_fuse_count = int(src.last_fuse_count)
    return out
