"""Manhattan-frame rotation tracking.

Port of ``planarslam_tpu/ops/manhattan.py``: surface normals are rotated
into the current Manhattan-frame estimate, classified into cones around the
three axes, each axis is refined by mean-shift on its tangent plane with the
kernel exp(-k ||x||^2), a single missing axis is completed by a cross
product, and the result is re-orthonormalized. Fixed shapes, no
data-dependent branching, no host sync.

``track_manhattan_frame`` is the wrapper of kernel K15
(``csrc/manhattan.cu``, all rounds in one launch, one thread block per
frame of a leading batch); its plain PyTorch version
``track_manhattan_frame_plain`` runs for CPU tensors only. With
``init=InitSelect(...)`` the kernel's epilogue also forms the tracking
step's initial pose (``init_select_plain`` is its plain version).
``seed_manhattan`` is the wrapper of K39 (the same source): the
initializer's seed rotation from plane normals and line directions
(``seed_from_plane_normals``), with the direction set of the mean shift
after it; ``seed_manhattan_plain`` is its plain version.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
from torch.profiler import record_function

from planarslam_tpu_torch import kernels
from planarslam_tpu_torch.geometry import se3


class ManhattanResult(NamedTuple):
    R_cm: torch.Tensor          # (3, 3) camera-from-Manhattan rotation
    axis_support: torch.Tensor  # (3,) int64 normals voting per axis
    n_axes: torch.Tensor        # () int64 number of well-supported axes
    success: torch.Tensor       # () bool — at least 2 axes found


class ManhattanInit(NamedTuple):
    """ManhattanResult and the tracking step's initial pose (K15 with its
    epilogue)."""

    R_cm: torch.Tensor
    axis_support: torch.Tensor
    n_axes: torch.Tensor
    success: torch.Tensor
    T_init: torch.Tensor        # (4, 4) float32
    use_manh: torch.Tensor      # () bool


class InitSelect(NamedTuple):
    """What K15's epilogue reads to form the tracking step's initial pose
    (every field with the frames' leading B)."""

    T_pred: torch.Tensor   # (4, 4) float32 the predicted pose
    R_wm: torch.Tensor     # (3, 3) float32 world-from-Manhattan
    enabled: torch.Tensor  # () bool the Manhattan switch


def init_select_plain(R_cm: torch.Tensor, success: torch.Tensor,
                      init: InitSelect
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K15's epilogue for one frame: use_manh = enabled &
    success, and T_init = T_pred with its rotation replaced by R_cm R_wm^T
    where use_manh holds (each entry ((a0 b0 + a1 b1) + a2 b2))."""
    use_manh = init.enabled & success
    R_manh = torch.stack([torch.stack([
        R_cm[i, 0] * init.R_wm[j, 0] + R_cm[i, 1] * init.R_wm[j, 1]
        + R_cm[i, 2] * init.R_wm[j, 2] for j in range(3)])
        for i in range(3)])
    T_rot = init.T_pred.clone()
    T_rot[:3, :3] = R_manh
    return torch.where(use_manh, T_rot, init.T_pred), use_manh


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
                          iters: int = 3, ms_iters: int = 4,
                          init: Optional[InitSelect] = None
                          ) -> ManhattanResult:
    """Refine the Manhattan rotation from one frame's surface normals. K15
    wrapper. R_cm_init: (3, 3) float32; normals: (N, 3) float32 unit
    vectors (zeros where padded); valid: (N,) bool; or B frames, every
    tensor (and init's) with a leading B, in one launch. Returns R_cm (3,
    3) float32, axis_support (3,) and n_axes () int64, success () bool;
    with `init` a ManhattanInit, which adds the step's T_init (4, 4) and
    use_manh () bool (all with the leading B)."""
    if kernels.on_cpu(R_cm_init, normals, valid,
                      *(() if init is None else init)):
        if R_cm_init.dim() == 2:
            res = track_manhattan_frame_plain(R_cm_init, normals, valid,
                                              cone_sin, kernel, min_support,
                                              iters, ms_iters)
            if init is None:
                return res
            return ManhattanInit(*res, *init_select_plain(
                res.R_cm, res.success, init))
        outs = []
        for b in range(R_cm_init.shape[0]):
            res = track_manhattan_frame_plain(R_cm_init[b], normals[b],
                                              valid[b], cone_sin, kernel,
                                              min_support, iters, ms_iters)
            if init is not None:
                res = ManhattanInit(*res, *init_select_plain(
                    res.R_cm, res.success, InitSelect(*[t[b] for t in init])))
            outs.append(res)
        return type(outs[0])(*[torch.stack(f) for f in zip(*outs)])
    lead = tuple(R_cm_init.shape[:-2])
    kernels.check(R_cm_init, "R_cm_init", torch.float32, (*lead, 3, 3))
    if normals.dim() != len(lead) + 2 or len(lead) > 1:
        raise ValueError(f"normals: expected {lead} + (N, 3), got "
                         f"{tuple(normals.shape)}")
    b, n = (lead[0] if lead else 1), normals.shape[-2]
    kernels.check(normals, "normals", torch.float32, (*lead, n, 3))
    kernels.check(valid, "valid", torch.bool, (*lead, n))
    if iters < 1 or ms_iters < 0:
        raise ValueError(f"iters >= 1 and ms_iters >= 0, got {iters}, "
                         f"{ms_iters}")
    dev = normals.device
    R_cm = torch.empty((*lead, 3, 3), dtype=torch.float32, device=dev)
    support = torch.empty((*lead, 3), dtype=torch.int64, device=dev)
    n_axes = torch.empty(lead, dtype=torch.int64, device=dev)
    success = torch.empty(lead, dtype=torch.bool, device=dev)
    T_init = use_manh = None
    sel = [None] * 5
    if init is not None:
        kernels.check(init.T_pred, "T_pred", torch.float32, (*lead, 4, 4))
        kernels.check(init.R_wm, "R_wm", torch.float32, (*lead, 3, 3))
        kernels.check(init.enabled, "enabled", torch.bool, lead)
        T_init = torch.empty((*lead, 4, 4), dtype=torch.float32, device=dev)
        use_manh = torch.empty(lead, dtype=torch.bool, device=dev)
        sel = [kernels.ptr(t) for t in (*init, T_init, use_manh)]
    with torch.cuda.device(dev):
        kernels.launch(
            "psl_manhattan_mean_shift", kernels.ptr(R_cm_init),
            kernels.ptr(normals), kernels.ptr(valid), n, b,
            math.sqrt(1.0 - cone_sin * cone_sin), float(kernel),
            int(min_support), int(iters), int(ms_iters), kernels.ptr(R_cm),
            kernels.ptr(support), kernels.ptr(n_axes), kernels.ptr(success),
            *sel)
    kernels.LAUNCHES["manhattan_mean_shift"] += 1
    res = ManhattanResult(R_cm=R_cm, axis_support=support, n_axes=n_axes,
                          success=success)
    return res if init is None else ManhattanInit(*res, T_init, use_manh)


def _seed(normals: torch.Tensor, counts: torch.Tensor, valid: torch.Tensor):
    """seed_from_plane_normals with its two picks: (R_cm, ok, i0, i1)."""
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
    return se3.orthonormalize(R), ok, i0, i1


def seed_from_plane_normals(normals: torch.Tensor, counts: torch.Tensor,
                            valid: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Initial Manhattan frame from detected plane (and line) directions:
    the best-supported direction is axis 1, the most-perpendicular
    well-supported one axis 2, their cross product axis 3.
    Returns (R_cm (3,3), ok ())."""
    return _seed(normals, counts, valid)[:2]


def _empty(shape, dtype, dev) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=dev)


class ManhattanSeed(NamedTuple):
    """K39's outputs (every field with the frames' leading B)."""

    R_seed: torch.Tensor      # (3, 3) float32 the seed rotation
    ok: torch.Tensor          # () bool a perpendicular axis was found
    picks: torch.Tensor       # (2,) int32 the two arg-maxes (i0, i1)
    dirs: torch.Tensor        # (Nn + L, 3) normals, then line directions
    dirs_valid: torch.Tensor  # (Nn + L,) bool


def seed_manhattan_plain(coeffs, count, pl_valid, p3d_s, p3d_e, has_3d,
                         ln_valid, response, normals, normals_valid
                         ) -> ManhattanSeed:
    """Plain version of K39 for one frame: the line directions (valid when
    lifted, valid and longer than 0.1 m; |v| = sqrt((v0^2 + v2^2) + v1^2),
    the card's vector norm, as K36), seed_from_plane_normals over the plane
    normals (weights: pixel counts) and the line directions (weights: the
    responses truncated to int), and the direction set of the mean shift
    that follows (the normals, then the line directions)."""
    v = (p3d_e - p3d_s).unbind(-1)
    ln_len = torch.sqrt((v[0] * v[0] + v[2] * v[2]) + v[1] * v[1])
    den = torch.clamp(ln_len, min=1e-9)
    ln_dir = torch.stack([c / den for c in v], dim=-1)
    ln_ok = has_3d & ln_valid & (ln_len > 0.1)
    R, ok, i0, i1 = _seed(torch.cat([coeffs[:, :3], ln_dir]),
                          torch.cat([count, response.to(torch.int32)]),
                          torch.cat([pl_valid, ln_ok]))
    return ManhattanSeed(R, ok, torch.stack([i0, i1]).to(torch.int32),
                         torch.cat([normals, ln_dir]),
                         torch.cat([normals_valid, ln_ok]))


@record_function("manhattan.seed_manhattan")
def seed_manhattan(coeffs, count, pl_valid, p3d_s, p3d_e, has_3d, ln_valid,
                   response, normals, normals_valid) -> ManhattanSeed:
    """K39 wrapper: B frames' planes, coeffs (B, P, 4) float32, count (B,
    P) int32, pl_valid (B, P) bool; lines, p3d_s, p3d_e (B, L, 3) float32,
    has_3d, ln_valid (B, L) bool, response (B, L) float32; surface normals
    (B, Nn, 3) float32 and normals_valid (B, Nn) bool. Returns
    ManhattanSeed with the leading B; one launch."""
    tensors = [coeffs, count, pl_valid, p3d_s, p3d_e, has_3d, ln_valid,
               response, normals, normals_valid]
    if kernels.on_cpu(*tensors):
        return kernels.per_problem(seed_manhattan_plain, tensors)
    tensors = [t.contiguous() for t in tensors]
    b, p = pl_valid.shape
    n_l, nn = ln_valid.shape[1], normals_valid.shape[1]
    for t, name, dtype, shape in zip(
            tensors, ("coeffs", "count", "pl_valid", "p3d_s", "p3d_e",
                      "has_3d", "ln_valid", "response", "normals",
                      "normals_valid"),
            (torch.float32, torch.int32, torch.bool, torch.float32,
             torch.float32, torch.bool, torch.bool, torch.float32,
             torch.float32, torch.bool),
            ((p, 4), (p,), (p,), (n_l, 3), (n_l, 3), (n_l,), (n_l,),
             (n_l,), (nn, 3), (nn,))):
        kernels.check(t, name, dtype, (b, *shape))
    if p + n_l < 1:
        raise ValueError("seed_manhattan: no candidate direction")
    dev = coeffs.device
    out = ManhattanSeed(R_seed=_empty((b, 3, 3), torch.float32, dev),
                        ok=_empty((b,), torch.bool, dev),
                        picks=_empty((b, 2), torch.int32, dev),
                        dirs=_empty((b, nn + n_l, 3), torch.float32, dev),
                        dirs_valid=_empty((b, nn + n_l), torch.bool, dev))
    ptrs = [kernels.ptr(t) for t in tensors]
    with torch.cuda.device(dev):
        kernels.launch("psl_seed_manhattan", *ptrs[:3], p, *ptrs[3:8], n_l,
                       *ptrs[8:], nn, b, *[kernels.ptr(t) for t in out])
    kernels.LAUNCHES["seed_manhattan"] += 1
    return out
