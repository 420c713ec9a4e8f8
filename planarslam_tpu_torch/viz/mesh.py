"""Planar mesh reconstruction and PLY export.

Rebuild of the reference's MeshViewer/Mesh stack (`src/MeshViewer.cc:35-91`,
`include/Mesh.h:70-72`): per map plane, the voxelized supporting cloud is
projected exactly onto the plane, outliers are rejected by point-to-plane
distance (`src/MeshViewer.cc:143`), the in-plane 2D points are Delaunay-
triangulated (scipy.spatial replaces the vendored Thirdparty/triangle), long
sliver triangles are dropped, and everything is written as one colored PLY.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

_PALETTE = np.array([
    [230, 25, 75], [60, 180, 75], [255, 225, 25], [0, 130, 200],
    [245, 130, 48], [145, 30, 180], [70, 240, 240], [240, 50, 230],
    [210, 245, 60], [250, 190, 190], [0, 128, 128], [170, 110, 40],
], np.uint8)


def triangulate_plane(points_w: np.ndarray, coeffs: np.ndarray,
                      max_edge: float = 0.35, max_dist: float = 0.05
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Project points onto the plane and Delaunay-triangulate in-plane.

    Returns (vertices (V, 3), faces (F, 3) int). Faces with any edge longer
    than max_edge are removed (keeps the mesh from spanning holes).
    """
    from scipy.spatial import Delaunay

    n = coeffs[:3] / max(np.linalg.norm(coeffs[:3]), 1e-9)
    d = coeffs[3] / max(np.linalg.norm(coeffs[:3]), 1e-9)
    dist = points_w @ n + d
    keep = np.abs(dist) < max_dist
    pts = points_w[keep]
    if len(pts) < 3:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    pts_proj = pts - dist[keep, None] * n
    # in-plane basis
    seed = np.array([1.0, 0, 0]) if abs(n[0]) < 0.9 else np.array([0, 1.0, 0])
    b1 = np.cross(n, seed)
    b1 /= np.linalg.norm(b1)
    b2 = np.cross(n, b1)
    uv = np.stack([pts_proj @ b1, pts_proj @ b2], axis=-1)
    try:
        tri = Delaunay(uv)
    except Exception:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    faces = tri.simplices
    # cull sliver / hole-spanning triangles
    a = uv[faces[:, 0]]
    b = uv[faces[:, 1]]
    c = uv[faces[:, 2]]
    e = np.maximum(np.maximum(np.linalg.norm(a - b, axis=1),
                              np.linalg.norm(b - c, axis=1)),
                   np.linalg.norm(c - a, axis=1))
    faces = faces[e < max_edge]
    return pts_proj.astype(np.float32), faces.astype(np.int32)


def save_planar_mesh(path: str, slam_map, max_edge: float = 0.35) -> None:
    """Triangulate every valid map plane and write a colored PLY
    (`MeshViewer::SaveMeshModel` role)."""
    verts: List[np.ndarray] = []
    faces: List[np.ndarray] = []
    colors: List[np.ndarray] = []
    offset = 0
    for i in np.flatnonzero(slam_map.pl_valid):
        n = int(slam_map.pl_cloud_n[i])
        if n < 3:
            continue
        v, f = triangulate_plane(slam_map.pl_cloud[i, :n],
                                 slam_map.pl_coeffs[i], max_edge=max_edge,
                                 max_dist=slam_map.cfg.planes.distance_threshold)
        if len(v) == 0:
            continue
        verts.append(v)
        faces.append(f + offset)
        colors.append(np.tile(_PALETTE[i % len(_PALETTE)], (len(v), 1)))
        offset += len(v)
    if not verts:
        V = np.zeros((0, 3), np.float32)
        F = np.zeros((0, 3), np.int32)
        C = np.zeros((0, 3), np.uint8)
    else:
        V = np.concatenate(verts)
        F = np.concatenate(faces)
        C = np.concatenate(colors)
    write_ply(path, V, F, C)


def write_ply(path: str, vertices: np.ndarray, faces: np.ndarray,
              colors: Optional[np.ndarray] = None) -> None:
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(vertices)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\n"
                    "property uchar blue\n")
        f.write(f"element face {len(faces)}\n")
        f.write("property list uchar int vertex_indices\nend_header\n")
        for i, v in enumerate(vertices):
            line = f"{v[0]:.5f} {v[1]:.5f} {v[2]:.5f}"
            if colors is not None:
                c = colors[i]
                line += f" {int(c[0])} {int(c[1])} {int(c[2])}"
            f.write(line + "\n")
        for face in faces:
            f.write(f"3 {face[0]} {face[1]} {face[2]}\n")


def read_ply_counts(path: str) -> Tuple[int, int]:
    """Tiny helper for tests: (n_vertices, n_faces)."""
    nv = nf = 0
    with open(path) as f:
        for line in f:
            if line.startswith("element vertex"):
                nv = int(line.split()[-1])
            elif line.startswith("element face"):
                nf = int(line.split()[-1])
            elif line.startswith("end_header"):
                break
    return nv, nf
