"""Manhattan-frame rotation tracking.

Port of ``planarslam_tpu/ops/manhattan.py``: surface normals are rotated
into the current Manhattan-frame estimate, classified into cones around the
three axes, each axis is refined by mean-shift on its tangent plane with the
kernel exp(-k ||x||^2), a single missing axis is completed by a cross
product, and the result is re-orthonormalized. Fixed shapes, no
data-dependent branching, no host sync.

``track_manhattan_frame`` is the wrapper of kernel K15
(``csrc/manhattan.cu``, all rounds in one launch); its plain PyTorch
version ``track_manhattan_frame_plain`` runs for CPU tensors only.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
from torch.profiler import record_function

from planarslam_tpu_torch import kernels
from planarslam_tpu_torch.geometry import se3


class ManhattanResult(NamedTuple):
    R_cm: torch.Tensor          # (3, 3) camera-from-Manhattan rotation
    axis_support: torch.Tensor  # (3,) int64 normals voting per axis
    n_axes: torch.Tensor        # () int64 number of well-supported axes
    success: torch.Tensor       # () bool — at least 2 axes found


def track_manhattan_frame_plain(R_cm_init: torch.Tensor,
                                normals: torch.Tensor, valid: torch.Tensor,
                                cone_sin: float = 0.2018,
                                kernel: float = 20.0, min_support: int = 20,
                                iters: int = 3, ms_iters: int = 4
                                ) -> ManhattanResult:
    """Plain version of K15: ``iters`` rounds of cone membership, per-axis
    mean shift, completion of one missing axis and re-orthonormalization.
    A round that finds fewer than two axes keeps the rotation it had."""
    cos_half = math.sqrt(1.0 - cone_sin * cone_sin)
    R_cm = R_cm_init
    supp = n_found = ok = None
    for _ in range(iters):
        n_m = normals @ R_cm  # n_m[:, k] = <n_c, axis_k>
        sign = torch.where(n_m >= 0, 1.0, -1.0)
        absdot = torch.abs(n_m)
        best_axis = torch.argmax(absdot, dim=-1)
        best_val = torch.amax(absdot, dim=-1)
        member = (best_val > cos_half) & valid

        axes_new = []
        support = []
        for k in range(3):
            i, j = (k + 1) % 3, (k + 2) % 3
            mk = member & (best_axis == k)
            s = sign[:, k]
            denom = torch.clamp(absdot[:, k], min=1e-6)
            u = s * n_m[:, i] / denom
            v = s * n_m[:, j] / denom
            uv = torch.stack([u, v], dim=-1)
            w_mask = mk.to(torch.float32)
            center = torch.zeros((2,), dtype=normals.dtype,
                                 device=normals.device)
            for _ in range(ms_iters):
                d2 = torch.sum((uv - center) ** 2, dim=-1)
                wgt = torch.exp(-kernel * d2) * w_mask
                wsum = torch.clamp(torch.sum(wgt), min=1e-9)
                center = torch.sum(wgt[:, None] * uv, dim=0) / wsum
            comps = [None, None, None]
            comps[i] = center[0]
            comps[j] = center[1]
            comps[k] = torch.ones_like(center[0])
            dir_m = torch.stack(comps)
            dir_m = dir_m / torch.linalg.norm(dir_m)
            axes_new.append(R_cm @ dir_m)
            support.append(torch.sum(mk.to(torch.int32)))

        axes_c = torch.stack(axes_new, dim=-1)
        supp = torch.stack(support)
        found = supp >= min_support
        n_found = torch.sum(found.to(torch.int32))

        prev = R_cm
        cols = torch.where(found[None, :], axes_c, prev)
        cross = torch.linalg.cross
        crosses = torch.stack([cross(cols[:, 1], cols[:, 2]),
                               cross(cols[:, 2], cols[:, 0]),
                               cross(cols[:, 0], cols[:, 1])], dim=-1)
        sgn = torch.where(torch.sum(crosses * prev, dim=0) >= 0, 1.0, -1.0)
        crosses = crosses * sgn[None, :]
        use_cross = (~found) & (n_found == 2)
        cols = torch.where(use_cross[None, :], crosses, cols)

        R_new = se3.orthonormalize(cols)
        ok = n_found >= 2
        R_cm = torch.where(ok, R_new, R_cm)
    return ManhattanResult(R_cm=R_cm, axis_support=supp, n_axes=n_found,
                           success=ok)


@record_function("manhattan.track_manhattan_frame")
def track_manhattan_frame(R_cm_init: torch.Tensor, normals: torch.Tensor,
                          valid: torch.Tensor, cone_sin: float = 0.2018,
                          kernel: float = 20.0, min_support: int = 20,
                          iters: int = 3, ms_iters: int = 4
                          ) -> ManhattanResult:
    """Refine the Manhattan rotation from one frame's surface normals. K15
    wrapper. R_cm_init: (3, 3) float32; normals: (N, 3) float32 unit
    vectors (zeros where padded); valid: (N,) bool. Returns R_cm (3, 3)
    float32, axis_support (3,) and n_axes () int64, success () bool."""
    if kernels.on_cpu(R_cm_init, normals, valid):
        return track_manhattan_frame_plain(R_cm_init, normals, valid,
                                           cone_sin, kernel, min_support,
                                           iters, ms_iters)
    kernels.check(R_cm_init, "R_cm_init", torch.float32, (3, 3))
    if normals.dim() != 2:
        raise ValueError(f"normals: expected (N, 3), got "
                         f"{tuple(normals.shape)}")
    n = normals.shape[0]
    kernels.check(normals, "normals", torch.float32, (n, 3))
    kernels.check(valid, "valid", torch.bool, (n,))
    if iters < 1 or ms_iters < 0:
        raise ValueError(f"iters >= 1 and ms_iters >= 0, got {iters}, "
                         f"{ms_iters}")
    dev = normals.device
    R_cm = torch.empty((3, 3), dtype=torch.float32, device=dev)
    support = torch.empty((3,), dtype=torch.int64, device=dev)
    n_axes = torch.empty((), dtype=torch.int64, device=dev)
    success = torch.empty((), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        kernels.launch(
            "psl_manhattan_mean_shift", kernels.ptr(R_cm_init),
            kernels.ptr(normals), kernels.ptr(valid), n,
            math.sqrt(1.0 - cone_sin * cone_sin), float(kernel),
            int(min_support), int(iters), int(ms_iters), kernels.ptr(R_cm),
            kernels.ptr(support), kernels.ptr(n_axes), kernels.ptr(success))
    kernels.LAUNCHES["manhattan_mean_shift"] += 1
    return ManhattanResult(R_cm=R_cm, axis_support=support, n_axes=n_axes,
                           success=success)


def seed_from_plane_normals(normals: torch.Tensor, counts: torch.Tensor,
                            valid: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Initial Manhattan frame from detected plane (and line) directions:
    the best-supported direction is axis 1, the most-perpendicular
    well-supported one axis 2, their cross product axis 3.
    Returns (R_cm (3,3), ok ())."""
    w = torch.where(valid, counts.to(torch.float32), 0.0)
    i0 = torch.argmax(w)
    a0 = normals[i0]
    perp = torch.abs(normals @ a0)
    score = torch.where(valid & (perp < 0.2), w, -1.0)
    i1 = torch.argmax(score)
    ok = score[i1] > 0
    a1 = normals[i1]
    a1 = a1 - torch.sum(a1 * a0) * a0
    a1 = a1 / torch.clamp(torch.linalg.norm(a1), min=1e-9)
    a2 = torch.linalg.cross(a0, a1)
    R = torch.stack([a0, a1, a2], dim=-1)
    return se3.orthonormalize(R), ok
