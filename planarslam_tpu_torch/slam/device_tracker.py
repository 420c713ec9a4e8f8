"""The per-frame device tracking step and the state it carries.

Port of the streaming half of ``planarslam_tpu/slam/device_tracker.py``.
One call of ``fused_track_step`` issues, on the current CUDA stream and
with no host sync, the whole per-frame pipeline:

    extraction (points / lines / planes / normals)
  -> Manhattan rotation tracking
  -> frame-to-frame matching (projection search, brute-force fallback)
  -> pose optimization, rotation-frozen when the Manhattan frame tracked
  -> local-map point matching against the device-resident map window
  -> on-device plane association (K30)
  -> full pose optimization over point / line / plane residuals
  -> keyframe-policy statistics, packed into one float32 bundle with the
     carried state (K31).

The JAX module branches between the rotation-frozen and the full first
solve with ``lax.cond``; here the branch is a device-side mask: one
``pose_optimize`` call whose ``rotation_fixed`` is the bool tensor
``use_manh`` (see ``solvers/pose_opt.py``).

Every input of the step carries a leading batch dimension B: B
independent lanes (sequences) step together, one launch of each kernel for
all of them, as ``jax.vmap`` of the JAX step does
(``planarslam_tpu/parallel/replay.py``). Streaming tracking is the same
step at B = 1.

The previous frame's features and landmarks stay on the device between
frames (``LastState``). The host reads the packed bundle ``pipeline_depth``
frames later (``Tracking``).

K36 ``step_prelude`` (``csrc/step_prelude.cu``, plain version
``step_prelude_plain``) is the prelude between extraction and K15: the
override and velocity selections, the predicted pose, the line directions
and the Manhattan prediction; K15's epilogue then forms the initial pose
(``ops/manhattan.py::init_select_plain``).

K30 ``_associate_planes_device`` (plain version ``_associate_planes_plain``)
and K31 ``finish_step`` (plain version ``finish_step_plain``) are in
``csrc/step_tail.cu``; both take a leading batch dimension. Their plain
versions spell every 3 x 3 product, dot and norm in a fixed order
(``planes.dot3``), which the kernels repeat.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from planarslam_tpu_torch import kernels
from planarslam_tpu_torch.config import PlaneConfig, SystemConfig
from planarslam_tpu_torch.device import resolve_device
from planarslam_tpu_torch.geometry import se3
from planarslam_tpu_torch.ops import manhattan as manhattan_ops
from planarslam_tpu_torch.ops import matching
from planarslam_tpu_torch.ops.frontend import PointFeatures
from planarslam_tpu_torch.ops.lines import (LineFeatures,
                                            search_lines_by_projection)
from planarslam_tpu_torch.ops.consts import literal
from planarslam_tpu_torch.ops.planes import PlaneFeatures, dot3
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
        # each field's first word: K31's offset table
        self.offsets = np.cumsum([0] + self.sizes[:-1]).astype(np.int32)

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


def depth_scale(cfg: SystemConfig) -> float:
    """float32(1) / float32(depth_map_factor). JAX's jitted division of the
    raw depth by float32(depth_map_factor) is one product with this
    reciprocal (XLA rewrites the division by a constant); the plain decode
    and K37 take the same product, which PyTorch also takes on the card."""
    return float(np.float32(1) / np.float32(cfg.camera.depth_map_factor))


def to_gray_depth(gray_raw: torch.Tensor, depth_raw: torch.Tensor,
                  cfg: SystemConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Native sensor formats (uint8 gray, uint16 depth) -> float32 gray in
    [0, 255] and depth in metres (raw times depth_scale(cfg)). Float inputs
    pass through as float32."""
    gray = gray_raw.to(torch.float32)
    if depth_raw.dtype in (torch.uint16, torch.int32):
        depth = depth_raw.to(torch.float32) * depth_scale(cfg)
    else:
        depth = depth_raw.to(torch.float32)
    return gray, depth


def unpack_frame(frame_u8: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., 3, H, W) uint8 [gray, depth_lo, depth_hi] -> (gray uint8, depth
    as int32 holding the uint16 value), each (..., H, W)."""
    gray, lo, hi = frame_u8.unbind(-3)
    return gray, torch.bitwise_or(lo.to(torch.int32), torch.bitwise_left_shift(
        hi.to(torch.int32), 8))


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


# ---------------------------------------------------------------------------
# K37: the step's sensor decode and window casts


def decode_step_inputs_plain(frame_u8: torch.Tensor, win_flat: torch.Tensor,
                             cfg: SystemConfig
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        "DeviceWindow"]:
    """Plain version of K37: the packed (B, 3, H, W) uint8 frames unpacked
    and decoded (float32 grey and depth in metres, (B, H, W) each) and the
    windows (B, S) unpacked with their casts."""
    gray, depth = to_gray_depth(*unpack_frame(frame_u8), cfg)
    return gray, depth, unpack_window(win_flat, cfg)


# how K37 reads a lane's depth (csrc/step_decode.cu's DepthKind)
_DEPTH_KIND = {torch.int32: 2, torch.uint16: 3}


@record_function("device_tracker.decode_step_inputs")
def _decode(win_flat: torch.Tensor, cfg: SystemConfig,
            frame: Optional[torch.Tensor] = None,
            gray: Optional[torch.Tensor] = None,
            depth: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor, "DeviceWindow"]:
    """K37 wrapper: the windows win_flat (B, S) float32 and either the
    packed frames `frame` (B, 3, H, W) uint8 or the frames `gray`, `depth`
    (B, H, W), each uint8 / int32 or uint16 sensor values or float (which
    pass through undecoded). One launch for all of it on the card; the
    plain version on the CPU. Returns (gray, depth, DeviceWindow), the
    window's float fields views of win_flat."""
    tensors = [t for t in (frame, gray, depth) if t is not None]
    if kernels.on_cpu(win_flat, *tensors):
        if frame is not None:
            return decode_step_inputs_plain(frame, win_flat, cfg)
        return (*to_gray_depth(gray, depth, cfg), unpack_window(win_flat, cfg))
    win_flat = win_flat.contiguous()
    if win_flat.dim() != 2:
        raise ValueError(f"win_flat: expected (B, S), got "
                         f"{tuple(win_flat.shape)}")
    b, S = win_flat.shape
    layout = _window_fields(cfg.map.max_planes, cfg.lines.desc_dim)
    kernels.check(win_flat, "win_flat", torch.float32, (b, layout[-1][2]
                                                        + layout[-1][3]))
    dev = win_flat.device
    gray_src = depth_src = depth_hi = None
    g_stride = d_stride = 0
    kind = 0
    if frame is not None:
        frame = frame.contiguous()
        kernels.check(frame, "frame", torch.uint8, (b, 3, *frame.shape[2:]))
        h, w = frame.shape[2:]
        hw = h * w
        gray_src = depth_src = kernels.ptr(frame)
        depth_src += hw
        depth_hi = depth_src + hw
        g_stride = d_stride = 3 * hw
        kind = 1
    else:
        h, w = gray.shape[1:]
        hw = h * w
        if gray.dtype == torch.uint8:
            gray = gray.contiguous()
            kernels.check(gray, "gray", torch.uint8, (b, h, w))
            gray_src, g_stride = kernels.ptr(gray), hw
        if depth.dtype in _DEPTH_KIND:
            depth = depth.contiguous()
            kernels.check(depth, "depth", depth.dtype, (b, h, w))
            depth_src, d_stride = kernels.ptr(depth), hw
            kind = _DEPTH_KIND[depth.dtype]
    gray_out = (_empty((b, h, w), torch.float32, dev) if gray_src is not None
                else gray.to(torch.float32))
    depth_out = (_empty((b, h, w), torch.float32, dev) if kind
                 else depth.to(torch.float32))
    views = window_views(win_flat, cfg)
    off = {name: o for name, _, o, _ in layout}
    n_pt, n_ln, n_pl = (views[k].shape[-1] for k in
                        ("pt_valid", "ln_valid", "pl_valid"))
    flags = {k: _empty((b, views[k].shape[-1]), torch.bool, dev)
             for k in ("pt_valid", "ln_valid", "pl_valid")}
    cloud_n = _empty((b, n_pl), torch.int64, dev)
    with torch.cuda.device(dev):
        kernels.launch(
            "psl_decode_step_inputs", gray_src, g_stride, depth_src,
            depth_hi, d_stride, kind, hw, b, depth_scale(cfg),
            kernels.ptr(gray_out) if gray_src is not None else None,
            kernels.ptr(depth_out) if kind else None, kernels.ptr(win_flat),
            S, off["pt_valid"], n_pt, off["ln_valid"], n_ln,
            off["pl_valid"], off["pl_cloud_n"], n_pl,
            *[kernels.ptr(flags[k]) for k in ("pt_valid", "ln_valid",
                                               "pl_valid")],
            kernels.ptr(cloud_n))
    kernels.LAUNCHES["decode_step_inputs"] += 1
    views.update(flags, pl_cloud_n=cloud_n,
                 pt_desc=views["pt_desc"].view(torch.int32))
    return gray_out, depth_out, DeviceWindow(**views)


def decode_step_inputs(frame_u8, win_flat, cfg: SystemConfig,
                       device="cuda"
                       ) -> Tuple[torch.Tensor, torch.Tensor, "DeviceWindow"]:
    """The tracking step's inputs from the packed (B, 3, H, W) uint8 sensor
    frames (gray, depth_lo, depth_hi) and the packed (B, S) float32 local-
    map windows (tensors or numpy arrays, moved to `device`): float32 grey
    and depth in metres (B, H, W) and the DeviceWindow. K37 on the card,
    decode_step_inputs_plain on the CPU."""
    dev = resolve_device(device)
    return _decode(torch.as_tensor(win_flat).to(dev), cfg,
                   frame=torch.as_tensor(frame_u8).to(dev))


def _t_inv(T: torch.Tensor):
    """T_inv(T) as (rows of R^T, t'): row i of R^T is column i of R, and
    t'_i = -(column i of R . t)."""
    R, t = T[:3, :3], T[:3, 3]
    rows = [R[:, i] for i in range(3)]
    return rows, [-dot3(r, t) for r in rows]


def _plane_to_world(T_cw: torch.Tensor, coeffs: torch.Tensor
                    ) -> torch.Tensor:
    """plane_geo.transform(T_inv(T_cw), coeffs) in a fixed order: (P, 4)
    camera-frame planes to the world."""
    rows, tw = _t_inv(T_cw)
    n = coeffs[:, :3].unbind(-1)
    n_w = [dot3(r, n) for r in rows]
    return torch.stack([*n_w, coeffs[:, 3] - dot3(n_w, tw)], dim=-1)


def _lift_features(pts: PointFeatures, T_cw: torch.Tensor, cam
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """World positions (K, 3) of the features with depth (0 elsewhere) at
    pose T_cw, and that mask (K,)."""
    z = pts.depth
    has = (z > 0) & pts.valid
    x = (pts.uv[:, 0] - cam.cx) / cam.fx * z
    y = (pts.uv[:, 1] - cam.cy) / cam.fy * z
    pc = (x, y, torch.clamp(z, min=0.0))
    rows, tw = _t_inv(T_cw)
    pw = torch.stack([dot3(r, pc) + t for r, t in zip(rows, tw)], dim=-1)
    return torch.where(has[:, None], pw, 0.0), has


def lift_state_plain(uv: torch.Tensor, depth: torch.Tensor,
                     valid: torch.Tensor, T_cw: torch.Tensor,
                     cfg: SystemConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K38's lift for one lane: the world points (K, 3) of
    the features uv (K, 2), depth (K,), valid (K,) at T_cw (4, 4), 0 where
    a feature has no depth, and that mask."""
    return _lift_features(PointFeatures(
        uv=uv, uv_raw=None, response=None, level=None, angle=None,
        desc=None, depth=depth, u_right=None, valid=valid), T_cw, cfg.camera)


def lift_state(uv: torch.Tensor, depth: torch.Tensor, valid: torch.Tensor,
               T_cw: torch.Tensor, cfg: SystemConfig
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K38 wrapper: B lanes' features, uv (B, K, 2) float32, depth (B, K)
    float32, valid (B, K) bool, at their poses T_cw (B, 4, 4) float32 (read
    on the device). Returns the world points (B, K, 3), 0 where a feature
    has no depth, and that mask (B, K) bool. One launch."""
    cam = cfg.camera
    if kernels.on_cpu(uv, depth, valid, T_cw):
        return kernels.per_problem(lift_state_plain, [uv, depth, valid, T_cw],
                                   cfg)
    uv, depth, valid, T_cw = [t.contiguous() for t in (uv, depth, valid,
                                                        T_cw)]
    b, k = valid.shape
    kernels.check(uv, "uv", torch.float32, (b, k, 2))
    kernels.check(depth, "depth", torch.float32, (b, k))
    kernels.check(valid, "valid", torch.bool, (b, k))
    kernels.check(T_cw, "T_cw", torch.float32, (b, 4, 4))
    dev = uv.device
    pt3d_w = _empty((b, k, 3), torch.float32, dev)
    valid3d = _empty((b, k), torch.bool, dev)
    with torch.cuda.device(dev):
        kernels.launch("psl_lift_state", kernels.ptr(uv), kernels.ptr(depth),
                       kernels.ptr(valid), kernels.ptr(T_cw), k, b,
                       float(cam.cx), float(cam.cy),
                       kernels.scalar_reciprocal(cam.fx),
                       kernels.scalar_reciprocal(cam.fy),
                       kernels.ptr(pt3d_w), kernels.ptr(valid3d))
    kernels.LAUNCHES["lift_state"] += 1
    return pt3d_w, valid3d


@record_function("device_tracker._state_from")
def _state_from(feats: FrameFeatures, T_cw, velocity,
                cfg: SystemConfig) -> LastState:
    """The carried state of a frame tracked at T_cw: its features, their
    world points and mask (lift_state: K38 on the card, its plain version
    on the CPU), T_cw and the velocity. feats, T_cw (4, 4) and velocity of
    one lane, or each with a leading B."""
    pts = feats.points
    one = T_cw.dim() == 2
    lead = (lambda t: t[None]) if one else (lambda t: t)
    pt3d_w, has = lift_state(lead(pts.uv), lead(pts.depth), lead(pts.valid),
                             lead(T_cw), cfg)
    if one:
        pt3d_w, has = pt3d_w[0], has[0]
    return LastState(feats=feats, pt3d_w=pt3d_w, valid3d=has, T_cw=T_cw,
                     velocity=velocity)


def _empty(shape, dtype, dev) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=dev)


# ---------------------------------------------------------------------------
# K30: plane association


class PlaneAssoc(NamedTuple):
    """K30's outputs (a leading B from the wrapper)."""

    direct: torch.Tensor     # (P,) int32 map plane matched directly, or -1
    par: torch.Tensor        # (P,) int32 parallel partner, or -1
    ver: torch.Tensor        # (P,) int32 vertical partner, or -1
    pi_w: torch.Tensor       # (P, 4) the frame planes in the world
    obs_pi_w: torch.Tensor   # (3, P, 4) the map planes of direct, par, ver
    obs_valid: torch.Tensor  # (3, P) bool: matched and a valid frame plane


def _associate_planes_plain(coeffs, valid, T_cw, pl_coeffs, pl_cloud,
                            pl_cloud_n, pl_valid, pcfg: PlaneConfig
                            ) -> PlaneAssoc:
    """Plain version of K30 for one step: the on-device PlaneMatcher, the
    direct, parallel and vertical partners of the P frame planes (coeffs
    (P, 4), valid (P,)) among the Mp map planes (pl_coeffs (Mp, 4),
    pl_cloud (Mp, C, 3), pl_cloud_n (Mp,) int64, pl_valid (Mp,)), and the
    three plane observation blocks of the pose solver."""
    pi_w = _plane_to_world(T_cw, coeffs)
    n_w = pi_w[:, :3].unbind(-1)
    nf_norm = torch.clamp(torch.sqrt(dot3(n_w, n_w)), min=1e-9)
    nf = [c / nf_norm for c in n_w]
    m_n = pl_coeffs[:, :3].unbind(-1)
    nm_norm = torch.clamp(torch.sqrt(dot3(m_n, m_n)), min=1e-9)
    nm = [c / nm_norm for c in m_n]
    cos = torch.abs(dot3([c[:, None] for c in nf], [c[None, :] for c in nm]))
    both = valid[:, None] & pl_valid[None, :]

    d_f = pi_w[:, 3] / nf_norm
    dots = dot3([c[None] for c in pl_cloud.unbind(-1)],
                [c[:, None, None] for c in nf])
    dist = torch.abs(dots + d_f[:, None, None])
    c_ids = torch.arange(pl_cloud.shape[1], device=cos.device)
    dist = torch.where(c_ids[None, None, :] < pl_cloud_n[None, :, None],
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
    ids = torch.stack([direct, par, ver])
    j = torch.clamp(ids, 0, pl_coeffs.shape[0] - 1).to(torch.int64)
    return PlaneAssoc(direct, par, ver, pi_w, pl_coeffs[j],
                      (ids >= 0) & valid[None, :])


@record_function("device_tracker._associate_planes_device")
def _associate_planes_device(coeffs, valid, T_cw, pl_coeffs, pl_cloud,
                             pl_cloud_n, pl_valid, pcfg: PlaneConfig
                             ) -> PlaneAssoc:
    """K30 wrapper: B steps, coeffs (B, P, 4) float32, valid (B, P) bool,
    T_cw (B, 4, 4) float32 read on the device, pl_coeffs (B, Mp, 4),
    pl_cloud (B, Mp, C, 3) float32, pl_cloud_n (B, Mp) int64, pl_valid
    (B, Mp) bool. Returns PlaneAssoc with a leading B. One launch, a
    cluster of 8 blocks per step."""
    tensors = [coeffs, valid, T_cw, pl_coeffs, pl_cloud, pl_cloud_n,
               pl_valid]
    if kernels.on_cpu(*tensors):
        return kernels.per_problem(_associate_planes_plain, tensors, pcfg)
    coeffs, valid, T_cw, pl_coeffs, pl_cloud, pl_cloud_n, pl_valid = [
        t.contiguous() for t in tensors]
    b, p = valid.shape
    mp, c = pl_cloud.shape[1:3]
    kernels.check(coeffs, "coeffs", torch.float32, (b, p, 4))
    kernels.check(valid, "valid", torch.bool, (b, p))
    kernels.check(T_cw, "T_cw", torch.float32, (b, 4, 4))
    kernels.check(pl_coeffs, "pl_coeffs", torch.float32, (b, mp, 4))
    kernels.check(pl_cloud, "pl_cloud", torch.float32, (b, mp, c, 3))
    kernels.check(pl_cloud_n, "pl_cloud_n", torch.int64, (b, mp))
    kernels.check(pl_valid, "pl_valid", torch.bool, (b, mp))
    dev = coeffs.device
    out = PlaneAssoc(direct=_empty((b, p), torch.int32, dev),
                     par=_empty((b, p), torch.int32, dev),
                     ver=_empty((b, p), torch.int32, dev),
                     pi_w=_empty((b, p, 4), torch.float32, dev),
                     obs_pi_w=_empty((b, 3, p, 4), torch.float32, dev),
                     obs_valid=_empty((b, 3, p), torch.bool, dev))
    with torch.cuda.device(dev):
        kernels.launch("psl_associate_planes",
                       *[kernels.ptr(t) for t in (coeffs, valid, T_cw,
                                                  pl_coeffs, pl_cloud,
                                                  pl_cloud_n, pl_valid)],
                       p, mp, c, b, float(pcfg.assoc_angle),
                       float(pcfg.assoc_dist),
                       float(pcfg.parallel_threshold),
                       float(pcfg.vertical_threshold),
                       *[kernels.ptr(t) for t in out])
    kernels.LAUNCHES["associate_planes"] += 1
    return out


def fused_track_step(gray: torch.Tensor, depth: torch.Tensor,
                     T_override: torch.Tensor, use_override: torch.Tensor,
                     R_wm: torch.Tensor, manh_enabled: torch.Tensor,
                     last: LastState, win_flat: torch.Tensor,
                     weights: pose_opt.PoseOptWeights,
                     cfg: SystemConfig) -> StepResult:
    """B lanes' tracking step: gray, depth (B, H, W) (uint8 / uint16-as-
    int32 sensor values or float32), T_override (B, 4, 4), use_override
    (B,) bool, R_wm (B, 3, 3), manh_enabled (B,) bool, the carried state
    and the packed windows (B, S), each with the leading B. The frames'
    decode and the windows' casts are one K37 launch."""
    gray, depth, win = _decode(win_flat, cfg, gray=gray, depth=depth)
    feats = extract_frame(gray, depth, cfg)
    return _track_core(feats, T_override, use_override, R_wm, manh_enabled,
                       last, win, weights, cfg)


def fused_track_step_packed(frame_u8: torch.Tensor, T_override, use_override,
                            R_wm, manh_enabled, last: LastState, win_flat,
                            weights, cfg: SystemConfig) -> StepResult:
    """fused_track_step over packed (B, 3, H, W) uint8 sensor frames."""
    gray, depth, win = _decode(win_flat, cfg, frame=frame_u8)
    feats = extract_frame(gray, depth, cfg)
    return _track_core(feats, T_override, use_override, R_wm, manh_enabled,
                       last, win, weights, cfg)


def _in_view(T, pts, K, cam) -> torch.Tensor:
    p = pts.unbind(-1)
    pc = torch.stack([dot3(T[i, :3], p) + T[i, 3] for i in range(3)], dim=-1)
    uv = se3.project(K, pc)
    return ((pc[:, 2] > 0.05) & (uv[:, 0] >= 0) & (uv[:, 0] < cam.width)
            & (uv[:, 1] >= 0) & (uv[:, 1] < cam.height))


# ---------------------------------------------------------------------------
# K31: the step's tail


class StepTail(NamedTuple):
    """What the tracking step's tail reads (a leading B in the wrapper)."""

    T_cand: torch.Tensor      # (4, 4) the final solve's pose
    n_in2: torch.Tensor       # () int64 its point inliers
    T1: torch.Tensor          # (4, 4) the pose the final solve started from
    n_in1: torch.Tensor       # () int64 the first solve's point inliers
    T_last: torch.Tensor      # (4, 4) the previous pose (override applied)
    R_cm: torch.Tensor        # (3, 3) Manhattan rotation
    manh_success: torch.Tensor  # () bool
    use_manh: torch.Tensor    # () bool
    ff_idx: torch.Tensor      # (K,) int32 last-feature -> feature match
    feat_slot: torch.Tensor   # (K,) int32 feature -> window point slot
    inl: torch.Tensor         # (K,) bool final point inliers
    obs2_valid: torch.Tensor  # (K,) bool final point observations
    pt_uv: torch.Tensor       # (K, 2) float32
    pt_depth: torch.Tensor    # (K,) float32
    pt_valid: torch.Tensor    # (K,) bool
    win_idx: torch.Tensor     # (Wp,) int32 window point -> feature, or -1
    win_xyz: torch.Tensor     # (Wp, 3) float32
    win_valid: torch.Tensor   # (Wp,) bool
    lm_idx: torch.Tensor      # (Wl,) int32 window line -> frame line, or -1
    ln_sw: torch.Tensor       # (Wl, 3) float32
    ln_ew: torch.Tensor       # (Wl, 3) float32
    ln_valid: torch.Tensor    # (Wl,) bool
    ln_slot: torch.Tensor     # (L,) int32 frame line -> window line slot
    pl_direct: torch.Tensor   # (P,) int32
    pl_par: torch.Tensor      # (P,) int32
    pl_ver: torch.Tensor      # (P,) int32
    pl_coeffs: torch.Tensor   # (P, 4) float32 camera-frame planes
    pl_valid: torch.Tensor    # (P,) bool


class StepOut(NamedTuple):
    """K31's outputs (a leading B from the wrapper)."""

    packed: torch.Tensor    # (total,) float32 BundleLayout bundle
    T_out: torch.Tensor     # (4, 4) the step's pose
    velocity: torch.Tensor  # (4, 4) T_out T_inv(T_last)
    pt3d_w: torch.Tensor    # (K, 3) carried world points
    valid3d: torch.Tensor   # (K,) bool


def _times_inv(T: torch.Tensor, T_last: torch.Tensor) -> torch.Tensor:
    """T @ T_inv(T_last), each entry ((a0 b0 + a1 b1) + a2 b2) + a3 b3."""
    rows, tw = _t_inv(T_last)
    Ti = torch.stack([torch.stack([r[0], r[1], r[2], t])
                      for r, t in zip(rows, tw)]
                     + [literal((0.0, 0.0, 0.0, 1.0), T.dtype, T.device)])
    return (((T[:, 0:1] * Ti[0:1] + T[:, 1:2] * Ti[1:2])
             + T[:, 2:3] * Ti[2:3]) + T[:, 3:4] * Ti[3:4])


def finish_step_plain(t: StepTail, cfg: SystemConfig) -> StepOut:
    """Plain version of K31 for one step: the final pose (the last solve's
    where it kept enough inliers), the outlier-free window slots, the found
    and visible flags of the window, the keyframe counts, the planes in the
    world, the packed bundle, the carried world points and the velocity."""
    cam = cfg.camera
    K = (cam.fx, cam.fy, cam.cx, cam.cy)
    ok2 = t.n_in2 >= cfg.tracking.min_matches_local_map // 2
    T_out = torch.where(ok2, t.T_cand, t.T1)
    with record_function("device_tracker.keyframe_stats"):
        feat_slot_out = torch.where(t.inl | ~(t.feat_slot >= 0), t.feat_slot,
                                    -1)
        ln_win_visible = t.ln_valid & _in_view(
            T_out, 0.5 * (t.ln_sw + t.ln_ew), K, cam)
        win_visible = t.win_valid & _in_view(T_out, t.win_xyz, K, cam)
        close = (t.pt_depth > 0) & (t.pt_depth < cam.depth_threshold)
        tracked = t.obs2_valid & t.inl
        kf_stats = torch.stack([
            torch.sum((close & tracked).to(torch.float32)),
            torch.sum((close & ~tracked & t.pt_valid).to(torch.float32)),
            torch.sum((t.pt_depth > 0).to(torch.float32)),
            torch.sum(tracked.to(torch.float32)),
        ])
    packed = _pack(
        BundleLayout(cfg), T_out=T_out, R_cm=t.R_cm,
        flags=torch.stack([t.manh_success.to(torch.float32),
                           t.use_manh.to(torch.float32),
                           t.n_in1.to(torch.float32),
                           t.n_in2.to(torch.float32)]),
        ff_idx=t.ff_idx, win_idx=feat_slot_out, pt_inlier=t.inl,
        win_found=t.win_idx >= 0, win_visible=win_visible,
        ln_win_idx=t.ln_slot, ln_win_found=t.lm_idx >= 0,
        ln_win_visible=ln_win_visible, pl_direct=t.pl_direct,
        pl_par=t.pl_par, pl_ver=t.pl_ver,
        pl_coeffs_w=_plane_to_world(T_out, t.pl_coeffs),
        pl_valid=t.pl_valid, kf_stats=kf_stats)
    pts = PointFeatures(uv=t.pt_uv, uv_raw=None, response=None, level=None,
                        angle=None, desc=None, depth=t.pt_depth,
                        u_right=None, valid=t.pt_valid)
    pt3d_w, valid3d = _lift_features(pts, T_out, cam)
    return StepOut(packed, T_out, _times_inv(T_out, t.T_last), pt3d_w,
                   valid3d)


# dtype of each StepTail field on the card
_TAIL_DTYPES = {"n_in2": torch.int64, "n_in1": torch.int64,
                "manh_success": torch.bool, "use_manh": torch.bool,
                "inl": torch.bool, "obs2_valid": torch.bool,
                "pt_valid": torch.bool, "win_valid": torch.bool,
                "ln_valid": torch.bool, "pl_valid": torch.bool,
                "ff_idx": torch.int32, "feat_slot": torch.int32,
                "win_idx": torch.int32, "lm_idx": torch.int32,
                "ln_slot": torch.int32, "pl_direct": torch.int32,
                "pl_par": torch.int32, "pl_ver": torch.int32}


@record_function("device_tracker.finish_step")
def finish_step(t: StepTail, cfg: SystemConfig) -> StepOut:
    """K31 wrapper: B steps, every field of t with a leading B (poses and
    counts read on the device). Returns StepOut with a leading B."""
    if kernels.on_cpu(*t):
        return kernels.per_problem(
            lambda *f: finish_step_plain(StepTail(*f), cfg), list(t))
    t = StepTail(*[x.contiguous() for x in t])
    b, k = t.inl.shape
    wp, wl = t.win_idx.shape[1], t.lm_idx.shape[1]
    n_l, n_p = t.ln_slot.shape[1], t.pl_direct.shape[1]
    shapes = dict(T_cand=(4, 4), n_in2=(), T1=(4, 4), n_in1=(),
                  T_last=(4, 4), R_cm=(3, 3), manh_success=(), use_manh=(),
                  pt_uv=(k, 2), win_xyz=(wp, 3), ln_sw=(wl, 3),
                  ln_ew=(wl, 3), pl_coeffs=(n_p, 4))
    lengths = dict(ff_idx=k, feat_slot=k, inl=k, obs2_valid=k, pt_depth=k,
                   pt_valid=k, win_idx=wp, win_valid=wp, lm_idx=wl,
                   ln_valid=wl, ln_slot=n_l, pl_direct=n_p, pl_par=n_p,
                   pl_ver=n_p, pl_valid=n_p)
    for name, x in zip(StepTail._fields, t):
        shape = shapes.get(name, (lengths.get(name),))
        kernels.check(x, name, _TAIL_DTYPES.get(name, torch.float32),
                      (b, *shape))
    layout = BundleLayout(cfg)
    # csrc/step_tail.cu's enum Field names the 17 fields in this order
    assert len(layout.fields) == 17
    sizes = {f[0]: n for f, n in zip(layout.fields, layout.sizes)}
    widths = dict(ff_idx=k, ln_win_idx=n_l, pl_direct=n_p, win_found=wp,
                  ln_win_found=wl)
    if any(sizes[f] != n for f, n in widths.items()):
        raise ValueError(f"finish_step: widths {widths} differ from the "
                         f"bundle layout's {sizes}")
    cam = cfg.camera
    dev = t.inl.device
    out = StepOut(packed=_empty((b, layout.total), torch.float32, dev),
                  T_out=_empty((b, 4, 4), torch.float32, dev),
                  velocity=_empty((b, 4, 4), torch.float32, dev),
                  pt3d_w=_empty((b, k, 3), torch.float32, dev),
                  valid3d=_empty((b, k), torch.bool, dev))
    with torch.cuda.device(dev):
        kernels.launch("psl_finish_step", *[kernels.ptr(x) for x in t],
                       k, n_l, n_p, wp, wl, b,
                       int(cfg.tracking.min_matches_local_map // 2),
                       float(cam.fx), float(cam.fy), float(cam.cx),
                       float(cam.cy), kernels.scalar_reciprocal(cam.fx),
                       kernels.scalar_reciprocal(cam.fy), float(cam.width),
                       float(cam.height), float(cam.depth_threshold),
                       kernels.host_ptr(layout.offsets), layout.total,
                       *[kernels.ptr(x) for x in out])
    kernels.LAUNCHES["finish_step"] += 1
    return out


# ---------------------------------------------------------------------------
# K36: the step's prelude


class Prelude(NamedTuple):
    """K36's outputs (every field with the lanes' leading B)."""

    T_last: torch.Tensor      # (4, 4) the previous pose, override applied
    T_pred: torch.Tensor      # (4, 4) velocity @ T_last
    dirs: torch.Tensor        # (Nn + L, 3) normals, then line directions
    dirs_valid: torch.Tensor  # (Nn + L,) bool
    R_init: torch.Tensor      # (3, 3) T_pred[:3, :3] @ R_wm


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a b + c rounded once to float32: the product of two float32 values is
    exact in float64, so the float64 sum rounded to float32 is the fused
    multiply-add (K36 computes it the same way)."""
    return (a.double() * b.double() + c.double()).float()


def _mat4_cublas(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A @ B of (..., 4, 4) float32 in the order the library's product takes
    on the card: fma(a1, b1, a0 b0) + fma(a3, b3, a2 b2)."""
    a = [A[..., :, k:k + 1] for k in range(4)]
    b = [B[..., k:k + 1, :] for k in range(4)]
    return (_fma(a[1], b[1], a[0] * b[0]) + _fma(a[3], b[3], a[2] * b[2]))


def _mat3_cublas(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A @ B of (..., 3, 3) float32, A a 4 x 4's corner, in the order the
    library's product takes on the card: fma(a1, b1, a0 b0) + a2 b2."""
    a = [A[..., :, k:k + 1] for k in range(3)]
    b = [B[..., k:k + 1, :] for k in range(3)]
    return _fma(a[1], b[1], a[0] * b[0]) + a[2] * b[2]


def step_prelude_plain(T_override, use_override, T_cw, velocity, p3d_s,
                       p3d_e, has_3d, ln_valid, normals, normals_valid,
                       R_wm) -> Prelude:
    """Plain version of K36 (every input with a leading B): the override
    and velocity selections, T_pred = velocity @ T_last, the line
    directions (valid when lifted, valid and longer than 0.1 m) after the
    normals, and R_init = T_pred[:3, :3] @ R_wm. Each product, sum, norm
    and division is spelled in the float form the step's PyTorch ops took
    on the card before K36 (measured on an H100: the 4 x 4 and 3 x 3 matrix
    products above, |v| = sqrt((v0^2 + v2^2) + v1^2), IEEE division), so
    the tracking step keeps its bits."""
    over = use_override[:, None, None]
    T_last = torch.where(over, T_override, T_cw)
    eye = torch.eye(4, dtype=torch.float32, device=T_cw.device)
    T_pred = _mat4_cublas(torch.where(over, eye, velocity), T_last)
    v = (p3d_e - p3d_s).unbind(-1)
    ln_len = torch.sqrt((v[0] * v[0] + v[2] * v[2]) + v[1] * v[1])
    den = torch.clamp(ln_len, min=1e-9)
    ln_dir = torch.stack([c / den for c in v], dim=-1)
    ln_ok = has_3d & ln_valid & (ln_len > 0.1)
    return Prelude(T_last, T_pred, torch.cat([normals, ln_dir], dim=1),
                   torch.cat([normals_valid, ln_ok], dim=1),
                   _mat3_cublas(T_pred[:, :3, :3], R_wm))


@record_function("device_tracker.step_prelude")
def step_prelude(T_override, use_override, T_cw, velocity, p3d_s, p3d_e,
                 has_3d, ln_valid, normals, normals_valid, R_wm) -> Prelude:
    """K36 wrapper: B lanes, T_override, T_cw, velocity (B, 4, 4) float32,
    use_override (B,) bool, the frame lines' p3d_s, p3d_e (B, L, 3) float32
    and has_3d, ln_valid (B, L) bool, normals (B, Nn, 3) float32,
    normals_valid (B, Nn) bool, R_wm (B, 3, 3) float32. Returns Prelude."""
    tensors = [T_override, use_override, T_cw, velocity, p3d_s, p3d_e,
               has_3d, ln_valid, normals, normals_valid, R_wm]
    if kernels.on_cpu(*tensors):
        return step_prelude_plain(*tensors)
    (T_override, use_override, T_cw, velocity, p3d_s, p3d_e, has_3d,
     ln_valid, normals, normals_valid, R_wm) = [t.contiguous()
                                                for t in tensors]
    b, n_l = ln_valid.shape
    nn = normals_valid.shape[1]
    for t, name, dtype, shape in (
            (T_override, "T_override", torch.float32, (4, 4)),
            (use_override, "use_override", torch.bool, ()),
            (T_cw, "T_cw", torch.float32, (4, 4)),
            (velocity, "velocity", torch.float32, (4, 4)),
            (p3d_s, "p3d_s", torch.float32, (n_l, 3)),
            (p3d_e, "p3d_e", torch.float32, (n_l, 3)),
            (has_3d, "has_3d", torch.bool, (n_l,)),
            (normals, "normals", torch.float32, (nn, 3)),
            (normals_valid, "normals_valid", torch.bool, (nn,)),
            (R_wm, "R_wm", torch.float32, (3, 3))):
        kernels.check(t, name, dtype, (b, *shape))
    dev = T_cw.device
    out = Prelude(T_last=_empty((b, 4, 4), torch.float32, dev),
                  T_pred=_empty((b, 4, 4), torch.float32, dev),
                  dirs=_empty((b, nn + n_l, 3), torch.float32, dev),
                  dirs_valid=_empty((b, nn + n_l), torch.bool, dev),
                  R_init=_empty((b, 3, 3), torch.float32, dev))
    with torch.cuda.device(dev):
        kernels.launch("psl_step_prelude",
                       *[kernels.ptr(t) for t in tensors[:8]], n_l,
                       kernels.ptr(normals), kernels.ptr(normals_valid), nn,
                       kernels.ptr(R_wm), b, *[kernels.ptr(t) for t in out])
    kernels.LAUNCHES["step_prelude"] += 1
    return out


def _track_core(feats: FrameFeatures, T_override, use_override, R_wm,
                manh_enabled, last: LastState, win: DeviceWindow,
                weights: pose_opt.PoseOptWeights,
                cfg: SystemConfig) -> StepResult:
    """Everything after extraction, for B lanes (every input with a
    leading B, the windows decoded by K37): Manhattan tracking, matching,
    plane association, pose optimization, bundle packing. One launch of
    each kernel serves all lanes."""
    dev = win.pt_xyz.device
    cam = cfg.camera
    K = (cam.fx, cam.fy, cam.cx, cam.cy)
    wh = (float(cam.width), float(cam.height))
    ln = feats.lines

    # ---- prediction and Manhattan rotation tracking (K36, K15) ----------
    pre = step_prelude(T_override, use_override, last.T_cw, last.velocity,
                       ln.p3d_s, ln.p3d_e, ln.has_3d, ln.valid, feats.normals,
                       feats.normals_valid, R_wm)
    manh = manhattan_ops.track_manhattan_frame(
        pre.R_init, pre.dirs, pre.dirs_valid,
        cone_sin=cfg.manhattan.cone_sin_track,
        kernel=cfg.manhattan.mean_shift_kernel,
        min_support=cfg.manhattan.min_axis_support,
        init=manhattan_ops.InitSelect(pre.T_pred, R_wm, manh_enabled))
    use_manh, T_init = manh.use_manh, manh.T_init

    # ---- frame-to-frame matching ----------------------------------------
    pts = feats.points
    last_pts = last.feats.points
    proj = matching.search_by_projection(
        last.pt3d_w, last_pts.desc, last.valid3d, T_init,
        pts.uv, pts.desc, pts.level, pts.valid, pts.u_right,
        K=K, image_wh=wh, bf=cam.bf, scale_factor=cfg.orb.scale_factor,
        radius=15.0, max_dist=cfg.matcher.th_high,
        level_window=cfg.orb.n_levels)
    bf_res = matching.match_descriptors(
        last_pts.desc, pts.desc, last.valid3d, pts.valid,
        max_dist=cfg.matcher.th_low, ratio=0.9)
    inv_s2 = matching.level_inv_sigma2(cfg.orb.scale_factor,
                                       cfg.orb.n_levels, dev)
    # the brute-force fallback below MIN_PROJ_MATCHES projection matches,
    # the rotation histogram and obs1's gathers (K26)
    fm = matching.frame_match_select(
        proj.idx, bf_res.idx, last_pts.angle, pts.angle, pts.uv, pts.u_right,
        pts.level, inv_s2)
    obs1 = pose_opt.PointObs(xw=last.pt3d_w, uv=fm.uv, u_right=fm.u_right,
                             inv_sigma2=fm.inv_sigma2, valid=fm.valid)

    # ---- line + plane association at the predicted pose -------------------
    lm_idx, _ = search_lines_by_projection(
        win.ln_sw, win.ln_ew, win.ln_desc, win.ln_valid, T_init,
        ln.uv_s, ln.uv_e, ln.angle, ln.desc, ln.valid, K=K, image_wh=wh,
        radius=14.0)
    la = matching.assemble_line_obs(lm_idx, win.ln_sw, win.ln_ew, ln.valid)
    line_obs = pose_opt.LineObs(xw_s=la.xw_s, xw_e=la.xw_e,
                                line2d=ln.line2d, inv_sigma2=la.inv_sigma2,
                                valid=la.valid)

    # plane association at the predicted pose, with the three plane
    # observation blocks of the pose solver (K30)
    assoc = _associate_planes_device(
        feats.planes.coeffs, feats.planes.valid, T_init, win.pl_coeffs,
        win.pl_cloud, win.pl_cloud_n, win.pl_valid, cfg.planes)
    pl_obs, par_obs, ver_obs = (
        pose_opt.PlaneObs(pi_w=assoc.obs_pi_w[:, k],
                          pi_obs=feats.planes.coeffs,
                          valid=assoc.obs_valid[:, k]) for k in range(3))

    # rotation-frozen solve where the Manhattan frame tracked, full pose
    # otherwise: one solve, the branch is the device-side mask use_manh
    res1 = pose_opt.pose_optimize(T_init, K, cam.bf, points=obs1,
                                  lines=line_obs, planes=pl_obs,
                                  par_planes=par_obs, ver_planes=ver_obs,
                                  weights=weights, rotation_fixed=use_manh)
    enough1 = res1.n_point_inliers >= cfg.tracking.min_matches_track
    T1 = torch.where(enough1[:, None, None], res1.T_cw, T_init)

    # ---- local-map point matching ---------------------------------------
    win_res = matching.search_by_projection(
        win.pt_xyz, win.pt_desc, win.pt_valid, T1,
        pts.uv, pts.desc, pts.level, pts.valid, pts.u_right,
        K=K, image_wh=wh, bf=cam.bf, scale_factor=cfg.orb.scale_factor,
        radius=4.0, max_dist=cfg.matcher.th_high,
        view_normals=win.pt_normal,
        dist_range=(win.pt_min_d, win.pt_max_d), level_window=1)
    # window matches first, the frame-to-frame landmarks fill the rest (K27)
    pa = matching.assemble_point_obs(
        win_res.idx, fm.ff_idx, last.pt3d_w, win.pt_xyz, pts.valid,
        pts.u_right, pts.level, inv_s2)
    obs2 = pose_opt.PointObs(xw=pa.xw, uv=pts.uv, u_right=pa.u_right,
                             inv_sigma2=pa.inv_sigma2, valid=pa.valid)

    # ---- final full pose optimization ------------------------------------
    res2 = pose_opt.pose_optimize(T1, K, cam.bf, points=obs2, lines=line_obs,
                                  planes=pl_obs, par_planes=par_obs,
                                  ver_planes=ver_obs, weights=weights,
                                  rotation_fixed=False)

    # the final pose, the window flags, the keyframe counts, the packed
    # bundle and the carried state (K31)
    out = finish_step(StepTail(
        T_cand=res2.T_cw, n_in2=res2.n_point_inliers, T1=T1,
        n_in1=res1.n_point_inliers, T_last=pre.T_last, R_cm=manh.R_cm,
        manh_success=manh.success, use_manh=use_manh, ff_idx=fm.ff_idx,
        feat_slot=pa.feat_slot, inl=res2.point_inlier, obs2_valid=pa.valid,
        pt_uv=pts.uv, pt_depth=pts.depth, pt_valid=pts.valid,
        win_idx=win_res.idx, win_xyz=win.pt_xyz, win_valid=win.pt_valid,
        lm_idx=lm_idx, ln_sw=win.ln_sw, ln_ew=win.ln_ew,
        ln_valid=win.ln_valid, ln_slot=la.ln_slot, pl_direct=assoc.direct,
        pl_par=assoc.par, pl_ver=assoc.ver, pl_coeffs=feats.planes.coeffs,
        pl_valid=feats.planes.valid), cfg)
    return StepResult(packed=out.packed, new_state=LastState(
        feats=feats, pt3d_w=out.pt3d_w, valid3d=out.valid3d,
        T_cw=out.T_out, velocity=out.velocity))


# ---------------------------------------------------------------------------
# stacked lanes: the carried state of B lanes


def state_leaves(state: LastState) -> list:
    """The tensors of a LastState, in a fixed order."""
    return _flatten(state.feats) + [state.pt3d_w, state.valid3d, state.T_cw,
                                    state.velocity]


def state_of_leaves(leaves: list) -> LastState:
    n = len(leaves) - 4
    return LastState(_unflatten(leaves[:n]), *leaves[n:])


def lanes(state: LastState) -> LastState:
    """One lane's unbatched LastState as a B = 1 stack (views)."""
    return state_of_leaves([t[None] for t in state_leaves(state)])


def stack_states(states: list) -> LastState:
    """B-lane stacks (each a LastState with a leading lane dimension) into
    one, lanes in order: one concatenation per leaf."""
    return state_of_leaves([torch.cat(ts) for ts in zip(
        *[state_leaves(s) for s in states])])


def insert_lane(stack: LastState, state: LastState, lane: int) -> None:
    """Write a B = 1 stack into lane `lane` of `stack`, in place: one
    device-to-device copy per leaf (the lanes of a stack are not views of
    one buffer, since the step's kernels write each leaf apart)."""
    for dst, src in zip(state_leaves(stack), state_leaves(state)):
        dst[lane:lane + 1].copy_(src)


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


def pack_feats_slice(feats_stack: FrameFeatures, lane: int) -> torch.Tensor:
    """pack_feats of lane `lane` of stacked (B, ...) features: the keyframe
    feature pull of a lane of a batched step."""
    return pack_feats(_unflatten([x[lane] for x in _flatten(feats_stack)]))


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


@functools.lru_cache(maxsize=None)
def _window_fields(max_planes: int, desc_dim: int) -> tuple:
    """(name, shape, offset, size) of each field of build_window's packed
    buffer, in DeviceWindow's order: the offset table, built once per
    configuration."""
    W, Wl, Mp = WIN_PTS, WIN_LNS, max_planes
    shapes = [(W, 3), (W, 8), (W, 3), (W,), (W,), (W,),
              (Wl, 3), (Wl, 3), (Wl, desc_dim), (Wl,),
              (Mp, 4), (Mp, ASSOC_CLOUD, 3), (Mp,), (Mp,)]
    out, off = [], 0
    for name, shp in zip(DeviceWindow._fields, shapes):
        n = int(np.prod(shp))
        out.append((name, shp, off, n))
        off += n
    return tuple(out)


def window_views(flat: torch.Tensor, cfg: SystemConfig) -> dict:
    """Each field of build_window's packed buffer (S,), or of B lanes'
    windows (B, S), as a float32 view (with the leading B)."""
    lead = flat.shape[:-1]
    return {name: flat[..., off:off + n].reshape(*lead, *shp)
            for name, shp, off, n in _window_fields(cfg.map.max_planes,
                                                    cfg.lines.desc_dim)}


@record_function("device_tracker.unpack_window")
def unpack_window(flat: torch.Tensor, cfg: SystemConfig) -> DeviceWindow:
    """Views into build_window's packed buffer (S,), or into B lanes'
    windows (B, S), every field then with the leading B; the flags compared
    > 0.5 and the cloud counts cast to int64 (K37's casts, plain)."""
    v = window_views(flat, cfg)
    v.update(pt_desc=v["pt_desc"].view(torch.int32),
             pt_valid=v["pt_valid"] > 0.5, ln_valid=v["ln_valid"] > 0.5,
             pl_cloud_n=v["pl_cloud_n"].to(torch.int64),
             pl_valid=v["pl_valid"] > 0.5)
    return DeviceWindow(**v)


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
