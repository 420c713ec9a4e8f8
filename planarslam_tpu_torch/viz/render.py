"""Offline visualization: frame overlays and map renders to PNG.

Replaces the reference's interactive Pangolin/OpenCV/PCL windows
(`src/Viewer.cc:37-165`, `src/FrameDrawer.cc:21-120`,
`src/MapDrawer.cc:29-233`) with headless renders — the equivalents of the
reference's screenshot/video dumps (`src/Viewer.cc:125-149`):

  - `draw_frame`: 2D overlay of tracked keypoints, line segments, plane
    segmentation masks, and per-axis-colored surface normals (the
    FrameDrawer's Manhattan-colored normal display) + a status bar;
  - `draw_map_topdown`: orthographic projection of map points / lines /
    plane clouds / keyframe frusta + covisibility graph.

Pure numpy rasterization + a minimal zlib PNG encoder — no GUI deps.
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional, Tuple

import numpy as np

_AXIS_COLORS = np.array([[255, 80, 80], [80, 255, 80], [80, 120, 255]],
                        np.uint8)
_PLANE_COLORS = np.array([
    [230, 25, 75], [60, 180, 75], [255, 225, 25], [0, 130, 200],
    [245, 130, 48], [145, 30, 180], [70, 240, 240], [240, 50, 230],
], np.uint8)


def write_png(path: str, img: np.ndarray) -> None:
    """Write (H, W, 3) uint8 as PNG."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w, _ = img.shape
    raw = b"".join(b"\x00" + img[i].tobytes() for i in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", header))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


def _put_disk(img, v, u, color, r=2):
    h, w, _ = img.shape
    v0, v1 = max(0, v - r), min(h, v + r + 1)
    u0, u1 = max(0, u - r), min(w, u + r + 1)
    img[v0:v1, u0:u1] = color


def _draw_segment(img, p0, p1, color, thick=1):
    n = int(max(abs(p1[0] - p0[0]), abs(p1[1] - p0[1]))) + 1
    ts = np.linspace(0.0, 1.0, max(n, 2))
    xs = np.clip(np.round(p0[0] + ts * (p1[0] - p0[0])).astype(int), 0,
                 img.shape[1] - 1)
    ys = np.clip(np.round(p0[1] + ts * (p1[1] - p0[1])).astype(int), 0,
                 img.shape[0] - 1)
    for t in range(-thick + 1, thick):
        yy = np.clip(ys + t, 0, img.shape[0] - 1)
        img[yy, xs] = color


def draw_frame(gray: np.ndarray, feats=None, tracked_mask=None,
               state_text: str = "", plane_alpha: float = 0.35,
               R_cm: Optional[np.ndarray] = None,
               normals: Optional[np.ndarray] = None) -> np.ndarray:
    """FrameDrawer equivalent: returns (H, W, 3) uint8 overlay."""
    img = np.repeat(np.clip(gray, 0, 255).astype(np.uint8)[..., None], 3,
                    axis=-1)
    h, w, _ = img.shape
    if feats is not None:
        # plane segmentation tint
        lbl = np.asarray(feats.planes.pixel_label)
        for i in range(int(np.asarray(feats.planes.valid).sum())):
            mask = lbl == i
            if mask.any():
                c = _PLANE_COLORS[i % len(_PLANE_COLORS)].astype(np.float32)
                img[mask] = ((1 - plane_alpha) * img[mask]
                             + plane_alpha * c).astype(np.uint8)
        # line segments
        uv_s = np.asarray(feats.lines.uv_s)
        uv_e = np.asarray(feats.lines.uv_e)
        for i in np.flatnonzero(np.asarray(feats.lines.valid)):
            _draw_segment(img, uv_s[i], uv_e[i], np.array([255, 200, 0],
                                                          np.uint8))
        # keypoints: green = tracked (matched to the map), cyan = detected
        uv = np.asarray(feats.points.uv)
        valid = np.asarray(feats.points.valid)
        for i in np.flatnonzero(valid):
            tracked = tracked_mask is not None and bool(tracked_mask[i])
            color = (np.array([0, 255, 0], np.uint8) if tracked
                     else np.array([0, 200, 200], np.uint8))
            _put_disk(img, int(uv[i, 1]), int(uv[i, 0]), color,
                      r=2 if tracked else 1)
    # Manhattan-axis-colored normal pixels (FrameDrawer `:95-120`)
    if R_cm is not None and normals is not None and feats is not None:
        n_m = np.asarray(normals) @ np.asarray(R_cm)
        axis = np.argmax(np.abs(n_m), axis=-1)
        sub = np.linspace(0, len(axis) - 1, min(len(axis), 256)).astype(int)
        for j, i in enumerate(sub):
            vv = (j * 7) % h
            img[vv, 0:4] = _AXIS_COLORS[axis[i]]
    # status bar
    bar = np.zeros((12, w, 3), np.uint8)
    n_chars = min(len(state_text), w // 4)
    for i in range(n_chars):  # crude tick marks per char (no font)
        bar[2:10, 4 * i + 1:4 * i + 3] = 180
    return np.concatenate([img, bar], axis=0)


def draw_map_topdown(slam_map, size: int = 800,
                     extent: Optional[float] = None) -> np.ndarray:
    """MapDrawer equivalent: orthographic x-z render of the map."""
    img = np.full((size, size, 3), 15, np.uint8)
    m = slam_map
    pts = m.pt_xyz[m.pt_valid]
    kfs = m.valid_kf_ids()
    centers = []
    for k in kfs:
        T = m.kf_pose[k]
        centers.append(-T[:3, :3].T @ T[:3, 3])
    centers = np.asarray(centers) if centers else np.zeros((0, 3))
    allp = np.concatenate([pts, centers]) if len(pts) else centers
    if len(allp) == 0:
        return img
    if extent is None:
        extent = float(np.abs(allp[:, [0, 2]]).max()) * 1.2 + 1e-3

    def to_px(xz):
        u = ((xz[..., 0] / extent) * 0.5 + 0.5) * (size - 1)
        v = ((xz[..., 1] / extent) * 0.5 + 0.5) * (size - 1)
        return np.clip(u, 0, size - 1).astype(int), \
            np.clip(v, 0, size - 1).astype(int)

    if len(pts):
        u, v = to_px(pts[:, [0, 2]])
        img[v, u] = [200, 200, 200]
    # plane clouds in per-plane colors
    for i in np.flatnonzero(m.pl_valid):
        n = int(m.pl_cloud_n[i])
        if n:
            u, v = to_px(m.pl_cloud[i, :n][:, [0, 2]])
            img[v, u] = _PLANE_COLORS[i % len(_PLANE_COLORS)]
    # map lines
    for i in np.flatnonzero(m.ln_valid):
        u0, v0 = to_px(m.ln_sw[i][[0, 2]][None])
        u1, v1 = to_px(m.ln_ew[i][[0, 2]][None])
        _draw_segment(img, (u0[0], v0[0]), (u1[0], v1[0]),
                      np.array([255, 200, 0], np.uint8))
    # keyframes + covisibility graph
    for idx, k in enumerate(kfs):
        u, v = to_px(centers[idx][[0, 2]][None])
        _put_disk(img, v[0], u[0], np.array([0, 120, 255], np.uint8), r=3)
        for j, k2 in enumerate(kfs):
            if j <= idx:
                continue
            if m.covis[k, k2] >= m.cfg.map.covis_min_weight:
                u2, v2 = to_px(centers[j][[0, 2]][None])
                _draw_segment(img, (u[0], v[0]), (u2[0], v2[0]),
                              np.array([60, 80, 60], np.uint8))
    return img


def save_frame_png(path: str, gray, feats=None, **kw) -> None:
    write_png(path, draw_frame(np.asarray(gray), feats, **kw))


def save_map_png(path: str, slam_map, **kw) -> None:
    write_png(path, draw_map_topdown(slam_map, **kw))
