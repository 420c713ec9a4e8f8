"""Per-frame perception: points, lines, planes and surface normals.

Port of ``planarslam_tpu/slam/frame.py``. The JAX module fuses the four
extractions into one XLA program; here they are issued in order on the
current CUDA stream (no host sync between them), for one frame or for a
batch of frames with a leading B. Returns fixed-capacity feature blocks.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from planarslam_tpu_torch.config import SystemConfig
from planarslam_tpu_torch.ops import lines as line_ops
from planarslam_tpu_torch.ops import planes as plane_ops
from planarslam_tpu_torch.ops.frontend import PointFeatures, extract_point_features
from planarslam_tpu_torch.ops.lines import LineFeatures
from planarslam_tpu_torch.ops.planes import PlaneFeatures


class FrameFeatures(NamedTuple):
    points: PointFeatures
    lines: LineFeatures
    planes: PlaneFeatures
    normals: torch.Tensor        # (Nn, 3) subsampled surface normals
    normals_valid: torch.Tensor  # (Nn,) bool


def _normal_stride(cfg: SystemConfig) -> int:
    h, w = cfg.camera.height, cfg.camera.width
    budget = cfg.manhattan.max_normals
    s = 1
    while (h // s) * (w // s) > budget:
        s += 1
    return s


def extract_frame(gray: torch.Tensor, depth: torch.Tensor,
                  cfg: SystemConfig) -> FrameFeatures:
    """gray: (H, W) float32 in [0, 255]; depth: (H, W) float32 metres; or
    B frames (B, H, W), every feature block then with a leading B (one
    launch of each kernel for all frames)."""
    pts = extract_point_features(gray, depth, cfg.camera, cfg.orb)
    lns = line_ops.extract_line_features(gray, depth, cfg.camera, cfg.lines)
    # planes read the raw depth; normals read an edge-preserving smoothed one
    pls = plane_ops.extract_planes(depth, cfg.camera, cfg.planes)
    n, v = plane_ops.frame_normals(depth, cfg.camera, cfg.planes.smooth_window,
                                   _normal_stride(cfg),
                                   cfg.manhattan.max_normals)
    return FrameFeatures(points=pts, lines=lns, planes=pls, normals=n,
                         normals_valid=v)


def unproject_points(feats: PointFeatures, cfg: SystemConfig,
                     T_wc: np.ndarray) -> np.ndarray:
    """World 3D positions for features with depth (host helper, numpy).
    Returns (K, 3) float32; rows without depth are zeros."""
    uv = np.asarray(feats.uv)
    z = np.asarray(feats.depth)
    cam = cfg.camera
    x = (uv[:, 0] - cam.cx) / cam.fx * z
    y = (uv[:, 1] - cam.cy) / cam.fy * z
    pc = np.stack([x, y, z], axis=-1)
    pw = pc @ T_wc[:3, :3].T + T_wc[:3, 3]
    return np.where((z > 0)[:, None], pw, 0.0).astype(np.float32)
