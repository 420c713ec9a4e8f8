"""Per-frame ORB feature extraction (the hot path).

Port of ``planarslam_tpu/ops/frontend.py``: pyramid (K16) -> dense FAST
scores (K1) -> NMS + per-tile top-k (K18) -> blur (K17) -> orientation +
steered BRIEF (K2) -> level scaling, undistortion and RGB-D pseudo-stereo
depth association (K19, ``point_epilogue``). Outputs are fixed-capacity
tensors with validity masks (capacity = ORBConfig.max_keypoints).

On the card every stage is one launch for all pyramid levels (the pyramid
one per level above 0), on the (B, n_pixels) level buffer of
``ops/levels.py`` for a batch of B frames (B = 1 for one frame); on the CPU
the plain versions run level by level, frame by frame.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from planarslam_tpu_torch import kernels
from planarslam_tpu_torch.config import CameraConfig, ORBConfig
from planarslam_tpu_torch.ops import fast, image, orb
from planarslam_tpu_torch.ops.consts import const
from planarslam_tpu_torch.ops.levels import LevelTable, level_table

EDGE_BORDER = 19  # reference EDGE_THRESHOLD (`src/ORBextractor.cc`)


class PointFeatures(NamedTuple):
    """Per-frame keypoint block (capacity K = orb.max_keypoints)."""

    uv: torch.Tensor        # (K, 2) float32 undistorted level-0 pixel coords
    uv_raw: torch.Tensor    # (K, 2) float32 distorted (as-detected) coords
    response: torch.Tensor  # (K,) float32 FAST score
    level: torch.Tensor     # (K,) int32 pyramid level
    angle: torch.Tensor     # (K,) float32 orientation (radians)
    desc: torch.Tensor      # (K, 8) int32 packed rBRIEF bit patterns
    depth: torch.Tensor     # (K,) float32 metres (-1 if unknown)
    u_right: torch.Tensor   # (K,) float32 pseudo-stereo right u (-1 if unknown)
    valid: torch.Tensor     # (K,) bool


def undistort_points(uv: torch.Tensor, cam: CameraConfig, iters: int = 5
                     ) -> torch.Tensor:
    """Invert the radial-tangential model by fixed-point iteration."""
    if not cam.has_distortion:
        return uv
    fx, fy, cx, cy = cam.fx, cam.fy, cam.cx, cam.cy
    k1, k2, p1, p2, k3 = cam.k1, cam.k2, cam.p1, cam.p2, cam.k3
    xd = (uv[..., 0] - cx) / fx
    yd = (uv[..., 1] - cy) / fy
    xu, yu = xd, yd
    for _ in range(iters):
        r2 = xu * xu + yu * yu
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2 * p1 * xu * yu + p2 * (r2 + 2 * xu * xu)
        dy = p1 * (r2 + 2 * yu * yu) + 2 * p2 * xu * yu
        xu = (xd - dx) / radial
        yu = (yd - dy) / radial
    return torch.stack([xu * fx + cx, yu * fy + cy], dim=-1)


class PointEpilogue(NamedTuple):
    """What point_epilogue adds to the selected keypoints, (B, K[, 2])."""

    uv: torch.Tensor
    uv_raw: torch.Tensor
    response: torch.Tensor
    level: torch.Tensor
    depth: torch.Tensor
    u_right: torch.Tensor
    valid: torch.Tensor


def orb_level_table(height: int, width: int, cfg: ORBConfig) -> LevelTable:
    """The level table of an (height, width) frame under `cfg`."""
    return level_table(height, width, cfg.n_levels, cfg.scale_factor,
                       cfg.n_features, cfg.tile)


def _check_capacity(table: LevelTable, capacity: int) -> None:
    if table.n_slots > capacity:
        raise ValueError(f"n_features {table.n_slots} exceeds max_keypoints "
                         f"{capacity}")


def point_epilogue_plain(uv_level: torch.Tensor, response: torch.Tensor,
                         valid: torch.Tensor, depth: torch.Tensor,
                         cam: CameraConfig, table: LevelTable, capacity: int
                         ) -> PointEpilogue:
    """Plain version of K19, the tail of extract_point_features: level
    coordinates to level-0 pixels, zero padding to `capacity` slots,
    undistortion, nearest depth at the detected coordinates and the
    pseudo-stereo right coordinate."""
    _check_capacity(table, capacity)
    dev = uv_level.device
    quotas = table.column("quota")
    key = (table.n_slots, tuple(table.scale), tuple(quotas))
    scale = const(("frontend.slot_scale",) + key,
                  lambda: np.repeat(table.scale, quotas), dev)
    level = const(("frontend.slot_level",) + key,
                  lambda: np.repeat(np.arange(table.n_levels, dtype=np.int32),
                                    quotas), dev)
    uv_raw = uv_level * scale[None, :, None]
    response = torch.where(valid, response, 0.0)
    level = level[None].expand(uv_level.shape[0], -1)
    pad = capacity - table.n_slots
    if pad:
        uv_raw = torch.nn.functional.pad(uv_raw, (0, 0, 0, pad))
        response = torch.nn.functional.pad(response, (0, pad))
        level = torch.nn.functional.pad(level, (0, pad))
    valid = response > 0.0
    uv = undistort_points(uv_raw, cam)

    # RGB-D pseudo-stereo: depth at the detected (distorted) coordinates
    d = torch.stack([image.nearest_sample(dm, p)
                     for dm, p in zip(depth, uv_raw)])
    has_d = (d > 1e-6) & valid
    u_right = torch.where(has_d, uv[..., 0] - cam.bf / torch.clamp(d, min=1e-6),
                          -1.0)
    return PointEpilogue(uv=uv, uv_raw=uv_raw, response=response, level=level,
                         depth=torch.where(has_d, d, -1.0), u_right=u_right,
                         valid=valid)


def point_epilogue(uv_level: torch.Tensor, response: torch.Tensor,
                   valid: torch.Tensor, depth: torch.Tensor,
                   cam: CameraConfig, table: LevelTable, capacity: int
                   ) -> PointEpilogue:
    """K19 wrapper. uv_level (B, n_slots, 2) float32 level coordinates,
    response (B, n_slots) float32 and valid (B, n_slots) bool as
    select_keypoints_levels returns them; depth (B, H, W) float32 metres.
    One launch, one thread per slot of the `capacity`."""
    if kernels.on_cpu(uv_level, response, valid, depth):
        return point_epilogue_plain(uv_level, response, valid, depth, cam,
                                    table, capacity)
    _check_capacity(table, capacity)
    b, n = uv_level.shape[0], table.n_slots
    kernels.check(uv_level, "uv_level", torch.float32, (b, n, 2))
    kernels.check(response, "response", torch.float32, (b, n))
    kernels.check(valid, "valid", torch.bool, (b, n))
    kernels.check(depth, "depth", torch.float32)
    if depth.dim() != 3 or depth.shape[0] != b:
        raise ValueError(f"depth: expected ({b}, H, W), got "
                         f"{tuple(depth.shape)}")
    dev = uv_level.device

    def out(dtype, *tail):
        return torch.empty((b, capacity) + tail, dtype=dtype, device=dev)

    res = PointEpilogue(uv=out(torch.float32, 2), uv_raw=out(torch.float32, 2),
                        response=out(torch.float32), level=out(torch.int32),
                        depth=out(torch.float32), u_right=out(torch.float32),
                        valid=out(torch.bool))
    with torch.cuda.device(dev):
        kernels.launch(
            "psl_point_epilogue", kernels.ptr(uv_level),
            kernels.ptr(response), kernels.ptr(valid), kernels.ptr(depth),
            depth.shape[1], depth.shape[2], kernels.host_ptr(table.ints),
            kernels.host_ptr(table.scale), table.n_levels, b, capacity,
            cam.fx, cam.fy, cam.cx, cam.cy, cam.bf, cam.k1, cam.k2, cam.p1,
            cam.p2, cam.k3, int(cam.has_distortion),
            *[kernels.ptr(t) for t in res])
    kernels.LAUNCHES["point_epilogue"] += 1
    return res


def _batch_features(angle, desc, ep: PointEpilogue) -> PointFeatures:
    """The batched stage outputs as one PointFeatures with a leading B."""
    return PointFeatures(uv=ep.uv, uv_raw=ep.uv_raw, response=ep.response,
                         level=ep.level, angle=angle, desc=desc,
                         depth=ep.depth, u_right=ep.u_right, valid=ep.valid)


def _features(angle, desc, ep: PointEpilogue) -> PointFeatures:
    """Frame 0 of the batched stage outputs as one PointFeatures."""
    return PointFeatures(*[x[0] for x in _batch_features(angle, desc, ep)])


def extract_point_features_plain(gray: torch.Tensor, depth: torch.Tensor,
                                 cam: CameraConfig, cfg: ORBConfig
                                 ) -> PointFeatures:
    """The front end composed of the plain versions, level by level (what
    the CPU runs)."""
    table = orb_level_table(*gray.shape, cfg)
    quotas = table.column("quota")
    tiles = table.column("tile")
    k = cfg.max_keypoints
    _check_capacity(table, k)
    levels = image.build_pyramid(gray, cfg.n_levels, cfg.scale_factor)

    uvs, resps, valids, angs, descs = [], [], [], [], []
    for l, img_l in enumerate(levels):
        if quotas[l] == 0:
            continue
        score = fast.fast_score_plain(img_l)
        uv_l, resp_l, valid_l = fast.select_keypoints(
            score, tile=int(tiles[l]), k_total=int(quotas[l]),
            min_score=float(cfg.min_th_fast), border=EDGE_BORDER)
        blur_l = image.blur(img_l, ksize=7, sigma=2.0)
        ang_l, desc_l = orb.orb_describe_plain(img_l, blur_l, uv_l, valid_l)
        uvs.append(uv_l)
        resps.append(resp_l)
        valids.append(valid_l)
        angs.append(ang_l)
        descs.append(desc_l)

    pad = k - table.n_slots
    angle = torch.nn.functional.pad(torch.cat(angs), (0, pad))
    desc = torch.nn.functional.pad(torch.cat(descs), (0, 0, 0, pad))
    ep = point_epilogue_plain(torch.cat(uvs)[None], torch.cat(resps)[None],
                              torch.cat(valids)[None], depth[None], cam,
                              table, k)
    return _features(angle[None], desc[None], ep)


@record_function("frontend.extract_point_features")
def extract_point_features(gray: torch.Tensor, depth: torch.Tensor,
                           cam: CameraConfig, cfg: ORBConfig) -> PointFeatures:
    """Full ORB front end for one frame. gray: (H, W) f32 [0,255],
    depth: (H, W) f32 metres (0 = invalid); or B frames (B, H, W), every
    output then with a leading B. On the card: one launch each of K16, K1,
    K18 (two), K17, K2 and K19 for all levels and frames."""
    if gray.dim() == 2:
        return PointFeatures(*[x[0] for x in _extract_points_batched(
            gray[None], depth[None], cam, cfg)])
    return _extract_points_batched(gray, depth, cam, cfg)


def _extract_points_batched(gray: torch.Tensor, depth: torch.Tensor,
                            cam: CameraConfig, cfg: ORBConfig
                            ) -> PointFeatures:
    """extract_point_features of B frames (B, H, W)."""
    if kernels.on_cpu(gray, depth):
        return kernels.per_problem(extract_point_features_plain,
                                   [gray, depth], cam, cfg)
    table = orb_level_table(*gray.shape[1:], cfg)
    k = cfg.max_keypoints
    _check_capacity(table, k)
    buf = image.build_pyramid_levels(gray, table, cfg.scale_factor)
    scores = fast.fast_score_levels(buf, table)
    uv_l, resp, valid = fast.select_keypoints_levels(
        scores, table, float(cfg.min_th_fast), EDGE_BORDER)
    blur = image.gaussian_blur_levels(buf, table, ksize=7, sigma=2.0)
    angle, desc = orb.orb_describe_levels(buf, blur, uv_l, valid, table, k)
    ep = point_epilogue(uv_l, resp, valid, depth, cam, table, k)
    return _batch_features(angle, desc, ep)
