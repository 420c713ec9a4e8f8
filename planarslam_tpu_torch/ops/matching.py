"""Batched descriptor matching: gated Hamming search, ratio and mutual
checks, rotation-histogram consistency and duplicate resolution, and the
tracking step's observations built from the matches.

Port of ``planarslam_tpu/ops/matching.py``. Every association is one dense
gated (M, N) problem. Its core, the gates, the Hamming distance and the
per-row best / second-best / argmin, is kernel K3 ``gated_hamming_top2``
(``csrc/hamming_top2.cu``); ``gated_hamming_top2_plain`` is its plain
PyTorch version (the JAX package's +-1 matmul Hamming distance, masked,
then two min-reductions); ``mutual_hamming_top2`` is K3 on both
directions of a mutual match in one launch. Around it
(``csrc/matching.cu``): K24
``project_landmarks``, the projection search's gates before K3; K25
``match_select``, the ratio and mutual checks and the duplicate resolution
after it; K26 ``frame_match_select``, the tracking step's frame-to-frame
selection with the rotation histogram (``rotation_histogram_filter`` is
its filter-only mode); K27 ``assemble_observations``, the pose solver's
point and line observations from the window matches
(``assemble_point_obs``, ``assemble_line_obs``). Each ``*_plain`` function
is its kernel's plain version; the wrappers of K3 and K24-K27, and the
searches built from them, take a leading batch dimension (K3's also one
problem alone). -1 sentinels mark missing matches.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from planarslam_tpu_torch import kernels
from planarslam_tpu_torch.geometry import se3
from planarslam_tpu_torch.ops.consts import computed, literal
from planarslam_tpu_torch.ops.lax_compat import mod, top_k
from planarslam_tpu_torch.ops.orb import hamming_distance

INF_DIST = 10_000
# K26 holds these two as constants (kHisto, kMinProj in csrc/matching.cu)
HISTO_LENGTH = 30     # rotation histogram bins (the reference's HISTO_LENGTH)
MIN_PROJ_MATCHES = 20  # fewer projection matches: the brute-force fallback
# JAX's jitted rot * HISTO_LENGTH / two_pi is one product with this
# constant, float32(30) / float32(2 pi) (XLA folds the two constants);
# K26 takes the same product
BIN_SCALE = float(np.float32(HISTO_LENGTH) / np.float32(2.0 * math.pi))
FLT_MIN = float(np.finfo(np.float32).tiny)  # the least normal float32
# K27 keeps two int32 slots per target in shared memory and K25 one key of
# at most 64 bits, within the 48 KB a block has without opting in: 6x the
# largest N of any caller (the frame's or a keyframe's max_keypoints, 1024
# by default)
MAX_TARGETS = 6143


class MatchResult(NamedTuple):
    idx: torch.Tensor    # (M,) int32 index into the target feature set, -1 = none
    dist: torch.Tensor   # (M,) int32 Hamming distance (INF_DIST if none)

    @property
    def valid(self):
        return self.idx >= 0


class ProjGate(NamedTuple):
    """Geometric gates of the projection search, per row (landmark, a) and
    per column (feature, b): |u_a - u_b| <= r_a and |v_a - v_b| <= r_a,
    |level_b - level_a| <= level_window, and, where the feature has a
    pseudo-stereo u_right (>= 0), |ur_pred_a - u_right_b| <= r_a."""

    a_uv: torch.Tensor       # (M, 2) float32 projected landmark pixels
    a_r: torch.Tensor        # (M,) float32 window radius
    a_level: torch.Tensor    # (M,) int32 predicted pyramid level
    a_ur_pred: torch.Tensor  # (M,) float32 predicted pseudo-stereo u
    b_uv: torch.Tensor       # (N, 2) float32 feature pixels
    b_level: torch.Tensor    # (N,) int32 feature level
    b_ur: torch.Tensor       # (N,) float32 feature u_right (-1 = mono)
    level_window: int


def _top2_min(d: torch.Tensor):
    """Per-row (best, second_best, best_idx); ties to the lowest index, and
    a tie with the best gives second == best."""
    best_idx = torch.argmin(d, dim=1)
    best = torch.gather(d, 1, best_idx[:, None])[:, 0]
    cols = torch.arange(d.shape[1], device=d.device)[None, :]
    second = torch.where(cols == best_idx[:, None], INF_DIST, d).amin(dim=1)
    return best, second, best_idx


def _gate_matrix(gate: ProjGate) -> torch.Tensor:
    r = gate.a_r[:, None]
    du = torch.abs(gate.a_uv[:, 0:1] - gate.b_uv[None, :, 0])
    dv = torch.abs(gate.a_uv[:, 1:2] - gate.b_uv[None, :, 1])
    window = (du <= r) & (dv <= r)
    lvl_ok = (torch.abs(gate.b_level[None, :] - gate.a_level[:, None])
              <= gate.level_window)
    ur_ok = ((gate.b_ur[None, :] < 0)
             | (torch.abs(gate.a_ur_pred[:, None] - gate.b_ur[None, :]) <= r))
    return window & lvl_ok & ur_ok


def gated_hamming_top2_plain(a_desc, b_desc, a_ok, b_ok,
                             gate: Optional[ProjGate] = None):
    """Plain version of K3: (best, second, best_idx), each (M,) int32."""
    d = hamming_distance(a_desc, b_desc)
    g = a_ok[:, None] & b_ok[None, :]
    if gate is not None:
        g = g & _gate_matrix(gate)
    d = torch.where(g, d, INF_DIST)
    best, second, best_idx = _top2_min(d)
    return best, second.to(torch.int32), best_idx.to(torch.int32)


def gated_hamming_top2(a_desc: torch.Tensor, b_desc: torch.Tensor,
                       a_ok: torch.Tensor, b_ok: torch.Tensor,
                       gate: Optional[ProjGate] = None):
    """K3 wrapper. a_desc (M, 8) / b_desc (N, 8) int32 bit patterns, a_ok
    (M,) / b_ok (N,) bool, optional projection gates; or B problems, every
    tensor with a leading B, in one launch. Masked pairs count as INF_DIST.
    Returns (best, second, best_idx), each (M,) int32 (with the leading
    B)."""
    tensors = [a_desc, b_desc, a_ok, b_ok]
    if gate is not None:
        tensors += list(gate[:-1])
    lead = tuple(a_desc.shape[:-2])
    if kernels.on_cpu(*tensors):
        if not lead:
            return gated_hamming_top2_plain(a_desc, b_desc, a_ok, b_ok, gate)

        def one(a, b, ao, bo, *g):
            return gated_hamming_top2_plain(
                a, b, ao, bo, ProjGate(*g, gate.level_window) if g else None)
        return kernels.per_problem(one, tensors)
    if len(lead) > 1:
        raise ValueError(f"a_desc: expected (M, 8) or (B, M, 8), got "
                         f"{tuple(a_desc.shape)}")
    bsz = lead[0] if lead else 1
    m, n = a_desc.shape[-2], b_desc.shape[-2]
    kernels.check(a_desc, "a_desc", torch.int32, (*lead, m, 8))
    kernels.check(b_desc, "b_desc", torch.int32, (*lead, n, 8))
    kernels.check(a_ok, "a_ok", torch.bool, (*lead, m))
    kernels.check(b_ok, "b_ok", torch.bool, (*lead, n))
    gate_ptrs = [0] * 7
    level_window = 0
    if gate is not None:
        kernels.check(gate.a_uv, "a_uv", torch.float32, (*lead, m, 2))
        kernels.check(gate.a_r, "a_r", torch.float32, (*lead, m))
        kernels.check(gate.a_level, "a_level", torch.int32, (*lead, m))
        kernels.check(gate.a_ur_pred, "a_ur_pred", torch.float32, (*lead, m))
        kernels.check(gate.b_uv, "b_uv", torch.float32, (*lead, n, 2))
        kernels.check(gate.b_level, "b_level", torch.int32, (*lead, n))
        kernels.check(gate.b_ur, "b_ur", torch.float32, (*lead, n))
        gate_ptrs = [kernels.ptr(t) for t in gate[:-1]]
        level_window = int(gate.level_window)
    best = torch.empty((*lead, m), dtype=torch.int32, device=a_desc.device)
    second = torch.empty_like(best)
    best_idx = torch.empty_like(best)
    with torch.cuda.device(a_desc.device):
        kernels.launch("psl_gated_hamming_top2", kernels.ptr(a_desc),
                       kernels.ptr(b_desc), m, n, bsz, kernels.ptr(a_ok),
                       kernels.ptr(b_ok), int(gate is not None), *gate_ptrs,
                       level_window, kernels.ptr(best), kernels.ptr(second),
                       kernels.ptr(best_idx))
    kernels.LAUNCHES["gated_hamming_top2"] += 1
    return best, second, best_idx


def mutual_hamming_top2(desc_a: torch.Tensor, desc_b: torch.Tensor,
                        valid_a: torch.Tensor, valid_b: torch.Tensor):
    """K3 on both directions of a mutual match in one launch: the ungated
    rows of A against B and of B against A. desc_a (B, M, 8), desc_b (B,
    N, 8) int32, valid_a (B, M), valid_b (B, N) bool. Returns (best,
    second, best_idx) of the rows of A, each (B, M) int32, and the
    best_idx of the rows of B, (B, N) int32."""
    tensors = [desc_a, desc_b, valid_a, valid_b]
    if kernels.on_cpu(*tensors):
        best, second, best_idx = gated_hamming_top2(*tensors)
        back = gated_hamming_top2(desc_b, desc_a, valid_b, valid_a)[2]
        return best, second, best_idx, back
    (b, m), n = valid_a.shape, valid_b.shape[-1]
    kernels.check(desc_a, "desc_a", torch.int32, (b, m, 8))
    kernels.check(desc_b, "desc_b", torch.int32, (b, n, 8))
    kernels.check(valid_a, "valid_a", torch.bool, (b, m))
    kernels.check(valid_b, "valid_b", torch.bool, (b, n))
    dev = desc_a.device
    best, second, best_idx = (_out((b, m), torch.int32, dev)
                              for _ in range(3))
    back = _out((b, n), torch.int32, dev)
    with torch.cuda.device(dev):
        kernels.launch("psl_mutual_hamming_top2", kernels.ptr(desc_a),
                       kernels.ptr(desc_b), m, n, b, kernels.ptr(valid_a),
                       kernels.ptr(valid_b), kernels.ptr(best),
                       kernels.ptr(second), kernels.ptr(best_idx),
                       kernels.ptr(back))
    kernels.LAUNCHES["gated_hamming_top2"] += 1
    return best, second, best_idx, back


def _out(shape, dtype, dev) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=dev)


def _opt_ptr(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else kernels.ptr(t)


# ---------------------------------------------------------------------------
# K24: the projection search's gates before K3


class Projection(NamedTuple):
    """K24's outputs: the row fields of ProjGate and the row gate."""

    a_uv: torch.Tensor       # (..., M, 2) float32 projected pixels
    a_r: torch.Tensor        # (..., M) float32 window radius
    a_level: torch.Tensor    # (..., M) int32 predicted pyramid level
    a_ur_pred: torch.Tensor  # (..., M) float32 predicted pseudo-stereo u
    gate_pt: torch.Tensor    # (..., M) bool: valid, in front, in the image
                             # and through the optional gates


def _dot3(a, b):
    """((a0 b0 + a1 b1) + a2 b2): the order K24 repeats (a matrix product
    or a sum over the last dimension leaves its order to the library)."""
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def project_landmarks_plain(
        pts_w: torch.Tensor, valid_pts: torch.Tensor, T_cw: torch.Tensor,
        K: Tuple[float, float, float, float], image_wh: Tuple[float, float],
        bf: float, scale_factor: float, radius: float,
        view_normals: Optional[torch.Tensor] = None,
        dist_range: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        ) -> Projection:
    """Plain version of K24 for one problem: pts_w (M, 3), valid_pts (M,),
    T_cw (4, 4). The transform, the camera centre, the distance and the
    viewing cosine are products and sums in a fixed order."""
    w_img, h_img = image_wh
    p = pts_w.unbind(-1)
    R, t = T_cw[:3, :3], T_cw[:3, 3]
    pc = torch.stack([_dot3(R[i], p) + t[i] for i in range(3)], dim=-1)
    z = pc[:, 2]
    uv = se3.project(K, pc)
    in_front = z > 0.05
    in_img = ((uv[:, 0] >= 0) & (uv[:, 0] < w_img)
              & (uv[:, 1] >= 0) & (uv[:, 1] < h_img))
    gate_pt = valid_pts & in_front & in_img

    cam_center = [-_dot3(R[:, j], t) for j in range(3)]  # -R^T t
    vec = [p[j] - cam_center[j] for j in range(3)]
    dist = torch.clamp(torch.sqrt(_dot3(vec, vec)), min=1e-6)
    if dist_range is not None:
        dmin, dmax = dist_range
        gate_pt = gate_pt & (dist >= 0.8 * dmin) & (dist <= 1.2 * dmax)
        log_sf = torch.log(literal(scale_factor, torch.float32, pts_w.device))
        pred_level = torch.ceil(
            torch.log(torch.clamp(dmax / dist, min=1.0)) / log_sf
        ).to(torch.int32)
    else:
        pred_level = torch.zeros_like(z, dtype=torch.int32)
    if view_normals is not None:
        cosv = _dot3(vec, view_normals.unbind(-1)) / dist
        gate_pt = gate_pt & (cosv > 0.5)

    r = radius * scale_factor ** pred_level.to(torch.float32)
    ur_pred = uv[:, 0] - bf / torch.clamp(z, min=1e-6)
    return Projection(a_uv=uv, a_r=r, a_level=pred_level, a_ur_pred=ur_pred,
                      gate_pt=gate_pt)


def project_landmarks(
        pts_w: torch.Tensor, valid_pts: torch.Tensor, T_cw: torch.Tensor,
        K: Tuple[float, float, float, float], image_wh: Tuple[float, float],
        bf: float, scale_factor: float, radius: float,
        view_normals: Optional[torch.Tensor] = None,
        dist_range: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        ) -> Projection:
    """K24 wrapper: B problems, pts_w (B, M, 3) float32, valid_pts (B, M)
    bool, T_cw (B, 4, 4) float32 read on the device, optional view_normals
    (B, M, 3) and dist_range ((B, M), (B, M)). Returns Projection with a
    leading B."""
    dmin, dmax = dist_range if dist_range is not None else (None, None)
    tensors = [pts_w, valid_pts, T_cw, view_normals, dmin, dmax]
    kw = dict(K=K, image_wh=image_wh, bf=bf, scale_factor=scale_factor,
              radius=radius)
    if kernels.on_cpu(*[t for t in tensors if t is not None]):
        def one(p, v, T, n, lo, hi):
            return project_landmarks_plain(
                p, v, T, view_normals=n,
                dist_range=None if hi is None else (lo, hi), **kw)
        return kernels.per_problem(one, tensors)
    pts_w, valid_pts, T_cw, view_normals, dmin, dmax = [
        None if t is None else t.contiguous() for t in tensors]
    b, m = valid_pts.shape
    kernels.check(pts_w, "pts_w", torch.float32, (b, m, 3))
    kernels.check(valid_pts, "valid_pts", torch.bool, (b, m))
    kernels.check(T_cw, "T_cw", torch.float32, (b, 4, 4))
    if view_normals is not None:
        kernels.check(view_normals, "view_normals", torch.float32, (b, m, 3))
    if dist_range is not None:
        kernels.check(dmin, "dmin", torch.float32, (b, m))
        kernels.check(dmax, "dmax", torch.float32, (b, m))
    dev = pts_w.device
    out = Projection(a_uv=_out((b, m, 2), torch.float32, dev),
                     a_r=_out((b, m), torch.float32, dev),
                     a_level=_out((b, m), torch.int32, dev),
                     a_ur_pred=_out((b, m), torch.float32, dev),
                     gate_pt=_out((b, m), torch.bool, dev))
    fx, fy, cx, cy = K
    with torch.cuda.device(dev):
        kernels.launch("psl_project_landmarks", kernels.ptr(pts_w),
                       kernels.ptr(valid_pts), kernels.ptr(T_cw),
                       _opt_ptr(view_normals), _opt_ptr(dmin),
                       _opt_ptr(dmax), m, b, fx, fy, cx, cy, *image_wh, bf,
                       scale_factor, radius, *[kernels.ptr(t) for t in out])
    kernels.LAUNCHES["project_landmarks"] += 1
    return out


# ---------------------------------------------------------------------------
# K25: the ratio and mutual checks and the duplicate resolution after K3


def _resolve_duplicates(idx: torch.Tensor, dist: torch.Tensor, n_targets: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Keep only the best source per target feature; exact-distance ties go
    to the first source."""
    m = idx.shape[0]
    tgt = torch.where(idx >= 0, idx, n_targets).to(torch.int64)
    best = torch.full((n_targets + 1,), INF_DIST, dtype=dist.dtype,
                      device=dist.device)
    best = best.scatter_reduce(0, tgt, dist, reduce="amin")
    keep = (idx >= 0) & (dist <= best[tgt])
    src_ids = torch.arange(m, dtype=torch.int32, device=idx.device)
    first = torch.full((n_targets + 1,), m, dtype=torch.int32,
                       device=idx.device)
    first = first.scatter_reduce(0, tgt, torch.where(keep, src_ids, m),
                                 reduce="amin")
    keep = keep & (first[tgt] == src_ids)
    return (torch.where(keep, idx, -1).to(torch.int32),
            torch.where(keep, dist, INF_DIST).to(torch.int32))


def match_select_plain(best: torch.Tensor, second: torch.Tensor,
                       best_idx: torch.Tensor, max_dist: int,
                       ratio: Optional[float] = None,
                       back: Optional[torch.Tensor] = None,
                       n_targets: Optional[int] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K25 for one problem: K3's (best, second, best_idx)
    (M,) to (idx, dist) (M,) int32. best <= max_dist; with `ratio` the
    ratio test; with `back` (N,) (the transposed problem's best_idx) the
    mutual check; with `n_targets` the duplicate resolution."""
    ok = best <= max_dist
    if ratio is not None:
        ok = ok & (best.to(torch.float32) < ratio * second.to(torch.float32))
    if back is not None:
        # a best_idx outside [0, N) has no transposed match (K3 gives none)
        rows = torch.arange(best.shape[0], dtype=torch.int32,
                            device=best.device)
        inside = (best_idx >= 0) & (best_idx < back.shape[0])
        at = torch.where(inside, best_idx, 0).to(torch.int64)
        ok = ok & inside & (back[at] == rows)
    idx = torch.where(ok, best_idx, -1).to(torch.int32)
    dist = torch.where(ok, best, INF_DIST).to(torch.int32)
    if n_targets is not None:
        idx, dist = _resolve_duplicates(idx, dist, n_targets)
    return idx, dist


def match_select(best: torch.Tensor, second: torch.Tensor,
                 best_idx: torch.Tensor, max_dist: int,
                 ratio: Optional[float] = None,
                 back: Optional[torch.Tensor] = None,
                 n_targets: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K25 wrapper: B problems, best, second, best_idx (B, M) int32 and
    back (B, N) int32. Returns (idx, dist) (B, M) int32."""
    tensors = [best, second, best_idx, back]
    if kernels.on_cpu(*[t for t in tensors if t is not None]):
        def one(best, second, best_idx, back):
            return match_select_plain(best, second, best_idx, max_dist,
                                      ratio, back, n_targets)
        return kernels.per_problem(one, tensors)
    b, m = best.shape
    n = n_targets if n_targets is not None else (
        back.shape[1] if back is not None else 0)
    for t, name in ((best, "best"), (second, "second"),
                    (best_idx, "best_idx")):
        kernels.check(t, name, torch.int32, (b, m))
    if back is not None:
        kernels.check(back, "back", torch.int32, (b, n))
    if n_targets is not None and not 0 < n_targets <= MAX_TARGETS:
        raise ValueError(f"match_select: {n_targets} targets, the kernel "
                         f"resolves duplicates over 1 to {MAX_TARGETS}")
    idx = _out((b, m), torch.int32, best.device)
    dist = torch.empty_like(idx)
    with torch.cuda.device(best.device):
        kernels.launch("psl_match_select", kernels.ptr(best),
                       kernels.ptr(second), kernels.ptr(best_idx),
                       _opt_ptr(back), m, n, b, int(max_dist),
                       int(ratio is not None),
                       1.0 if ratio is None else ratio,
                       int(n_targets is not None), kernels.ptr(idx),
                       kernels.ptr(dist))
    kernels.LAUNCHES["match_select"] += 1
    return idx, dist


# ---------------------------------------------------------------------------
# K26: the frame-to-frame selection with the rotation histogram


def level_inv_sigma2(scale_factor: float, n_levels: int, device
                     ) -> torch.Tensor:
    """(n_levels,) float32 1 / sigma^2 per pyramid level, scale_factor^-2l
    (the reference's mvInvLevelSigma2), computed once by torch on
    `device`."""
    def table(dev):
        sf = literal(scale_factor, torch.float32, dev)
        return torch.pow(sf, -2.0 * torch.arange(n_levels, device=dev).to(
            torch.float32))
    return computed(("matching.inv_sigma2", scale_factor, n_levels), table,
                    device)


def _per_level(table: torch.Tensor, level: torch.Tensor) -> torch.Tensor:
    return table[torch.clamp(level, 0, table.shape[0] - 1).to(torch.int64)]


def rotation_bins(angle_src: torch.Tensor, angle_tgt: torch.Tensor
                  ) -> torch.Tensor:
    """The rotation-histogram bin (int64) of each angle difference, as JAX's
    jitted rotation_histogram_filter gives it: jnp.mod into [0, 2 pi), then
    one product with BIN_SCALE, truncated and clamped. A denormal
    difference counts as 0 (bin 0): JAX on the CPU flushes it."""
    d = angle_src - angle_tgt
    d = torch.where(torch.abs(d) < FLT_MIN, 0.0, d)
    rot = mod(d, 2.0 * math.pi)
    return torch.clamp((rot * BIN_SCALE).to(torch.int64), 0,
                       HISTO_LENGTH - 1)


def rotation_histogram_filter_plain(angle_src: torch.Tensor,
                                    angle_tgt_matched: torch.Tensor,
                                    valid: torch.Tensor) -> torch.Tensor:
    """Plain version of K26's filter: keep matches whose angle difference
    falls in the 3 most common bins; bins 2 and 3 only when they hold >= 10%
    of the best bin's count."""
    bins = rotation_bins(angle_src, angle_tgt_matched)
    counts = torch.zeros(HISTO_LENGTH, dtype=torch.int32,
                         device=valid.device)
    counts = counts.index_add(0, bins, valid.to(torch.int32))
    top3_val, top3_idx = top_k(counts, 3)
    keep2 = top3_val[1].to(torch.float32) >= 0.1 * top3_val[0]
    keep3 = top3_val[2].to(torch.float32) >= 0.1 * top3_val[0]
    keep_bin = torch.zeros(HISTO_LENGTH, dtype=torch.bool,
                           device=valid.device)
    keep_bin = keep_bin.index_put((top3_idx[:1],), torch.ones_like(keep2)[None])
    keep_bin = keep_bin.index_put((top3_idx[1:2],), keep2[None])
    keep_bin = keep_bin.index_put((top3_idx[2:3],), keep3[None])
    return valid & keep_bin[bins]


def _frame_match_launch(m, n, b, angle_src, angle_tgt, proj_idx=None,
                        bf_idx=None, valid=None, feats=(None,) * 3,
                        table=None, outs=(None,) * 6) -> None:
    """One K26 launch: frame mode with proj_idx, bf_idx, feats, table and
    the five FrameMatches outputs; filter mode with valid and the kept
    mask (the last output)."""
    kernels.launch("psl_frame_match_select", _opt_ptr(proj_idx),
                   _opt_ptr(bf_idx), _opt_ptr(valid), kernels.ptr(angle_src),
                   kernels.ptr(angle_tgt), m, n, b,
                   *[_opt_ptr(t) for t in feats], _opt_ptr(table),
                   0 if table is None else table.shape[0], 2.0 * math.pi,
                   *[_opt_ptr(t) for t in outs])
    kernels.LAUNCHES["frame_match_select"] += 1


def rotation_histogram_filter(angle_src: torch.Tensor,
                              angle_tgt_matched: torch.Tensor,
                              valid: torch.Tensor) -> torch.Tensor:
    """Rotation-histogram consistency of M matches: angle_src and the
    matched targets' angles (M,) float32, valid (M,) bool; returns the kept
    (M,) bool. Or B problems, each tensor with a leading B, in one launch.
    K26 in filter mode on the card, the plain version on the CPU."""
    tensors = [angle_src, angle_tgt_matched, valid]
    if kernels.on_cpu(*tensors):
        if valid.dim() == 1:
            return rotation_histogram_filter_plain(*tensors)
        return kernels.per_problem(
            lambda *t: (rotation_histogram_filter_plain(*t),), tensors)[0]
    angle_src, angle_tgt_matched, valid = [t.contiguous() for t in tensors]
    lead = tuple(valid.shape[:-1])
    if len(lead) > 1:
        raise ValueError(f"valid: expected (M,) or (B, M), got "
                         f"{tuple(valid.shape)}")
    b, m = (lead[0] if lead else 1), valid.shape[-1]
    kernels.check(angle_src, "angle_src", torch.float32, (*lead, m))
    kernels.check(angle_tgt_matched, "angle_tgt_matched", torch.float32,
                  (*lead, m))
    kernels.check(valid, "valid", torch.bool, (*lead, m))
    keep = _out((*lead, m), torch.bool, valid.device)
    with torch.cuda.device(valid.device):
        _frame_match_launch(m, m, b, angle_src, angle_tgt_matched,
                            valid=valid, outs=(None,) * 5 + (keep,))
    return keep


class FrameMatches(NamedTuple):
    """K26's outputs: the frame-to-frame matches and the first pose solve's
    point observations of the M previous-frame landmarks."""

    ff_idx: torch.Tensor      # (..., M) int32 current feature or -1
    uv: torch.Tensor          # (..., M, 2) float32 the matched feature's uv
    u_right: torch.Tensor     # (..., M) float32, -1 where unmatched
    inv_sigma2: torch.Tensor  # (..., M) float32 the feature level's 1/s^2
    valid: torch.Tensor       # (..., M) bool matched


def frame_match_select_plain(proj_idx: torch.Tensor, bf_idx: torch.Tensor,
                             angle_src: torch.Tensor, angle_tgt: torch.Tensor,
                             uv_tgt: torch.Tensor, ur_tgt: torch.Tensor,
                             level_tgt: torch.Tensor, table: torch.Tensor
                             ) -> FrameMatches:
    """Plain version of K26 for one problem: the projection matches
    proj_idx (M,), or the brute-force ones bf_idx (M,) where fewer than
    MIN_PROJ_MATCHES projected, through the rotation histogram of the
    source angles (M,) against the matched targets' (N,), then the
    matched targets' uv (N, 2), u_right (N,) and level (N,) through the
    per-level table (level_inv_sigma2)."""
    n = angle_tgt.shape[0]
    use_bf = torch.sum(proj_idx >= 0) < MIN_PROJ_MATCHES
    ff_idx = torch.where(use_bf, bf_idx, proj_idx)
    ang_tgt = angle_tgt[torch.clamp(ff_idx, 0, n - 1).to(torch.int64)]
    rot_ok = rotation_histogram_filter_plain(angle_src, ang_tgt, ff_idx >= 0)
    ff_idx = torch.where(rot_ok, ff_idx, -1).to(torch.int32)
    matched = ff_idx >= 0
    fi = torch.clamp(ff_idx, 0, n - 1).to(torch.int64)
    return FrameMatches(
        ff_idx=ff_idx, uv=uv_tgt[fi],
        u_right=torch.where(matched, ur_tgt[fi], -1.0),
        inv_sigma2=_per_level(table, level_tgt[fi]), valid=matched)


def frame_match_select(proj_idx: torch.Tensor, bf_idx: torch.Tensor,
                       angle_src: torch.Tensor, angle_tgt: torch.Tensor,
                       uv_tgt: torch.Tensor, ur_tgt: torch.Tensor,
                       level_tgt: torch.Tensor, table: torch.Tensor
                       ) -> FrameMatches:
    """K26 wrapper: B problems, proj_idx, bf_idx (B, M) int32, angle_src
    (B, M) float32, the current features' angle_tgt (B, N), uv_tgt (B, N,
    2), ur_tgt (B, N) float32 and level_tgt (B, N) int32, the per-level
    table (n_levels,). Returns FrameMatches with a leading B; the
    brute-force fallback is decided on the device."""
    tensors = [proj_idx, bf_idx, angle_src, angle_tgt, uv_tgt, ur_tgt,
               level_tgt]
    if kernels.on_cpu(*tensors, table):
        return kernels.per_problem(frame_match_select_plain, tensors, table)
    (proj_idx, bf_idx, angle_src, angle_tgt, uv_tgt, ur_tgt,
     level_tgt) = [t.contiguous() for t in tensors]
    b, m = proj_idx.shape
    n = angle_tgt.shape[1]
    kernels.check(proj_idx, "proj_idx", torch.int32, (b, m))
    kernels.check(bf_idx, "bf_idx", torch.int32, (b, m))
    kernels.check(angle_src, "angle_src", torch.float32, (b, m))
    kernels.check(angle_tgt, "angle_tgt", torch.float32, (b, n))
    kernels.check(uv_tgt, "uv_tgt", torch.float32, (b, n, 2))
    kernels.check(ur_tgt, "ur_tgt", torch.float32, (b, n))
    kernels.check(level_tgt, "level_tgt", torch.int32, (b, n))
    kernels.check(table, "table", torch.float32)
    dev = proj_idx.device
    out = FrameMatches(ff_idx=_out((b, m), torch.int32, dev),
                       uv=_out((b, m, 2), torch.float32, dev),
                       u_right=_out((b, m), torch.float32, dev),
                       inv_sigma2=_out((b, m), torch.float32, dev),
                       valid=_out((b, m), torch.bool, dev))
    with torch.cuda.device(dev):
        _frame_match_launch(m, n, b, angle_src, angle_tgt, proj_idx,
                            bf_idx, feats=(uv_tgt, ur_tgt, level_tgt),
                            table=table, outs=tuple(out) + (None,))
    return out


# ---------------------------------------------------------------------------
# K27: the pose solver's observations from the window matches


class PointAssembly(NamedTuple):
    """K27's point outputs, per current feature: its window slot and the
    second pose solve's observation."""

    feat_slot: torch.Tensor   # (..., N) int32 window point slot or -1
    xw: torch.Tensor          # (..., N, 3) the window point, else the
                              # temporal landmark, else 0
    u_right: torch.Tensor     # (..., N) float32, -1 where not valid
    inv_sigma2: torch.Tensor  # (..., N) float32 the level's 1/s^2
    valid: torch.Tensor       # (..., N) bool


class LineAssembly(NamedTuple):
    """K27's line outputs, per frame line: its window slot and the pose
    solver's line observation."""

    ln_slot: torch.Tensor     # (..., L) int32 window line slot or -1
    xw_s: torch.Tensor        # (..., L, 3) the window line's endpoints
    xw_e: torch.Tensor
    inv_sigma2: torch.Tensor  # (..., L) float32 ones
    valid: torch.Tensor       # (..., L) bool


def _invert(idx: torch.Tensor, n: int) -> torch.Tensor:
    """(n,) int32: per target the largest row matched to it, else -1
    (.at[clip(idx, 0, n - 1)].max(where(idx >= 0, row, -1)))."""
    rows = torch.arange(idx.shape[0], dtype=torch.int32, device=idx.device)
    out = torch.full((n,), -1, dtype=torch.int32, device=idx.device)
    return out.scatter_reduce(0, torch.clamp(idx, 0, n - 1).to(torch.int64),
                              torch.where(idx >= 0, rows, -1), reduce="amax")


def assemble_point_obs_plain(win_idx: torch.Tensor, ff_idx: torch.Tensor,
                             src_xw: torch.Tensor, win_xyz: torch.Tensor,
                             feat_valid: torch.Tensor, feat_ur: torch.Tensor,
                             feat_level: torch.Tensor, table: torch.Tensor
                             ) -> PointAssembly:
    """Plain version of K27's point mode for one problem: the window
    search's idx (W,) inverted onto the N features, the frame-to-frame
    matches ff_idx (M,) carrying their landmarks src_xw (M, 3) onto theirs
    (a clash keeps the largest source; a target outside [0, N) is dropped,
    as JAX's mode="drop"), the window points win_xyz (W, 3) first."""
    n = feat_valid.shape[0]
    feat_slot = _invert(win_idx, n)
    has_slot = feat_slot >= 0
    slot = torch.clamp(feat_slot, 0, win_xyz.shape[0] - 1).to(torch.int64)
    src = _invert(torch.where(ff_idx < n, ff_idx, -1), n)
    ff_valid = src >= 0
    ff_xw = torch.where(ff_valid[:, None], src_xw[
        torch.clamp(src, 0, src_xw.shape[0] - 1).to(torch.int64)], 0.0)
    valid = (has_slot | ff_valid) & feat_valid
    return PointAssembly(
        feat_slot=feat_slot,
        xw=torch.where(has_slot[:, None], win_xyz[slot], ff_xw),
        u_right=torch.where(valid, feat_ur, -1.0),
        inv_sigma2=_per_level(table, feat_level), valid=valid)


def assemble_line_obs_plain(lm_idx: torch.Tensor, win_sw: torch.Tensor,
                            win_ew: torch.Tensor, line_valid: torch.Tensor
                            ) -> LineAssembly:
    """Plain version of K27's line mode for one problem: the line search's
    idx (W,) inverted onto the L frame lines, the window endpoints (W, 3)
    gathered."""
    n = line_valid.shape[0]
    ln_slot = _invert(lm_idx, n)
    s = torch.clamp(ln_slot, 0, win_sw.shape[0] - 1).to(torch.int64)
    return LineAssembly(
        ln_slot=ln_slot, xw_s=win_sw[s], xw_e=win_ew[s],
        inv_sigma2=torch.ones((n,), dtype=torch.float32,
                              device=line_valid.device),
        valid=(ln_slot >= 0) & line_valid)


def _check_targets(n: int, b: int, fields) -> None:
    if not 0 < n <= MAX_TARGETS:
        raise ValueError(f"assemble_observations: {n} targets, the kernel "
                         f"takes 1 to {MAX_TARGETS}")
    for t, name, dtype, shape in fields:
        kernels.check(t, name, dtype, (b,) + shape)


def assemble_point_obs(win_idx: torch.Tensor, ff_idx: torch.Tensor,
                       src_xw: torch.Tensor, win_xyz: torch.Tensor,
                       feat_valid: torch.Tensor, feat_ur: torch.Tensor,
                       feat_level: torch.Tensor, table: torch.Tensor
                       ) -> PointAssembly:
    """K27 wrapper, point mode: B problems, win_idx (B, W), ff_idx (B, M)
    int32, src_xw (B, M, 3), win_xyz (B, W, 3), feat_valid (B, N) bool,
    feat_ur (B, N) float32, feat_level (B, N) int32, the per-level table.
    Returns PointAssembly with a leading B."""
    tensors = [win_idx, ff_idx, src_xw, win_xyz, feat_valid, feat_ur,
               feat_level]
    if kernels.on_cpu(*tensors, table):
        return kernels.per_problem(assemble_point_obs_plain, tensors, table)
    (win_idx, ff_idx, src_xw, win_xyz, feat_valid, feat_ur,
     feat_level) = [t.contiguous() for t in tensors]
    (b, w), m, n = win_idx.shape, ff_idx.shape[1], feat_valid.shape[1]
    _check_targets(n, b, (
        (win_idx, "win_idx", torch.int32, (w,)),
        (ff_idx, "ff_idx", torch.int32, (m,)),
        (src_xw, "src_xw", torch.float32, (m, 3)),
        (win_xyz, "win_xyz", torch.float32, (w, 3)),
        (feat_valid, "feat_valid", torch.bool, (n,)),
        (feat_ur, "feat_ur", torch.float32, (n,)),
        (feat_level, "feat_level", torch.int32, (n,))))
    kernels.check(table, "table", torch.float32)
    dev = win_idx.device
    out = PointAssembly(feat_slot=_out((b, n), torch.int32, dev),
                        xw=_out((b, n, 3), torch.float32, dev),
                        u_right=_out((b, n), torch.float32, dev),
                        inv_sigma2=_out((b, n), torch.float32, dev),
                        valid=_out((b, n), torch.bool, dev))
    with torch.cuda.device(dev):
        kernels.launch("psl_assemble_observations", kernels.ptr(win_idx), w,
                       kernels.ptr(win_xyz), 0, kernels.ptr(ff_idx), m,
                       kernels.ptr(src_xw), kernels.ptr(feat_valid),
                       kernels.ptr(feat_ur), kernels.ptr(feat_level),
                       kernels.ptr(table), table.shape[0], n, b,
                       kernels.ptr(out.feat_slot), kernels.ptr(out.xw), 0,
                       kernels.ptr(out.u_right), kernels.ptr(out.inv_sigma2),
                       kernels.ptr(out.valid))
    kernels.LAUNCHES["assemble_observations"] += 1
    return out


def assemble_line_obs(lm_idx: torch.Tensor, win_sw: torch.Tensor,
                      win_ew: torch.Tensor, line_valid: torch.Tensor
                      ) -> LineAssembly:
    """K27 wrapper, line mode: B problems, lm_idx (B, W) int32, win_sw,
    win_ew (B, W, 3) float32, line_valid (B, L) bool. Returns LineAssembly
    with a leading B."""
    tensors = [lm_idx, win_sw, win_ew, line_valid]
    if kernels.on_cpu(*tensors):
        return kernels.per_problem(assemble_line_obs_plain, tensors)
    lm_idx, win_sw, win_ew, line_valid = [t.contiguous() for t in tensors]
    (b, w), n = lm_idx.shape, line_valid.shape[1]
    _check_targets(n, b, (
        (lm_idx, "lm_idx", torch.int32, (w,)),
        (win_sw, "win_sw", torch.float32, (w, 3)),
        (win_ew, "win_ew", torch.float32, (w, 3)),
        (line_valid, "line_valid", torch.bool, (n,))))
    dev = lm_idx.device
    out = LineAssembly(ln_slot=_out((b, n), torch.int32, dev),
                       xw_s=_out((b, n, 3), torch.float32, dev),
                       xw_e=_out((b, n, 3), torch.float32, dev),
                       inv_sigma2=_out((b, n), torch.float32, dev),
                       valid=_out((b, n), torch.bool, dev))
    with torch.cuda.device(dev):
        kernels.launch("psl_assemble_observations", kernels.ptr(lm_idx), w,
                       kernels.ptr(win_sw), kernels.ptr(win_ew), 0, 0, 0,
                       kernels.ptr(line_valid), 0, 0, 0, 0, n, b,
                       kernels.ptr(out.ln_slot), kernels.ptr(out.xw_s),
                       kernels.ptr(out.xw_e), 0,
                       kernels.ptr(out.inv_sigma2), kernels.ptr(out.valid))
    kernels.LAUNCHES["assemble_observations"] += 1
    return out


# ---------------------------------------------------------------------------
# the searches


@record_function("matching.match_descriptors")
def match_descriptors(desc_a: torch.Tensor, desc_b: torch.Tensor,
                      valid_a: torch.Tensor, valid_b: torch.Tensor,
                      max_dist: int = 50, ratio: float = 0.9,
                      mutual: bool = True) -> MatchResult:
    """Brute-force descriptor matching a->b with Lowe ratio and an optional
    mutual check: K3 on the rows (with the mutual check, on the transposed
    problem too, in the same launch), then K25. desc_a (M, 8), desc_b (N,
    8), valid_a (M,), valid_b (N,), or B problems with a leading B (the
    result then has it too)."""
    one = desc_a.dim() == 2
    if one:
        desc_a, desc_b, valid_a, valid_b = (
            t[None] for t in (desc_a, desc_b, valid_a, valid_b))
    back = None
    if mutual:
        best, second, best_idx, back = mutual_hamming_top2(
            desc_a, desc_b, valid_a, valid_b)
    else:
        best, second, best_idx = gated_hamming_top2(desc_a, desc_b, valid_a,
                                                    valid_b)
    idx, dist = match_select(best, second, best_idx, max_dist, ratio=ratio,
                             back=back)
    return MatchResult(idx[0], dist[0]) if one else MatchResult(idx, dist)


@record_function("matching.search_by_projection")
def search_by_projection(
    pts_w: torch.Tensor, descs: torch.Tensor, valid_pts: torch.Tensor,
    T_cw: torch.Tensor, feat_uv: torch.Tensor, feat_desc: torch.Tensor,
    feat_level: torch.Tensor, feat_valid: torch.Tensor,
    feat_ur: torch.Tensor, K: Tuple[float, float, float, float],
    image_wh: Tuple[float, float], bf: float, scale_factor: float,
    radius: float = 5.7, max_dist: int = 100,
    view_normals: Optional[torch.Tensor] = None,
    dist_range: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    ratio: float = 1.0, level_window: int = 1,
) -> MatchResult:
    """Project landmarks into the frame and match within a scale-aware
    window: K24, K3 on the gated (M, N) problem, K25 with the duplicate
    resolution. Every tensor may carry a leading B (B problems, one launch
    of each kernel; the result then has it too)."""
    one = pts_w.dim() == 2
    if one:
        (pts_w, descs, valid_pts, T_cw, feat_uv, feat_desc, feat_level,
         feat_valid, feat_ur) = (t[None] for t in (
             pts_w, descs, valid_pts, T_cw, feat_uv, feat_desc, feat_level,
             feat_valid, feat_ur))
        if view_normals is not None:
            view_normals = view_normals[None]
        if dist_range is not None:
            dist_range = (dist_range[0][None], dist_range[1][None])
    proj = project_landmarks(
        pts_w, valid_pts, T_cw, K, image_wh, bf, scale_factor, radius,
        view_normals=view_normals, dist_range=dist_range)
    gate = ProjGate(a_uv=proj.a_uv, a_r=proj.a_r, a_level=proj.a_level,
                    a_ur_pred=proj.a_ur_pred, b_uv=feat_uv.contiguous(),
                    b_level=feat_level.to(torch.int32).contiguous(),
                    b_ur=feat_ur.contiguous(), level_window=level_window)
    best, second, best_idx = gated_hamming_top2(
        descs.contiguous(), feat_desc.contiguous(), proj.gate_pt,
        feat_valid.contiguous(), gate)
    idx, dist = match_select(best, second, best_idx, max_dist,
                             ratio=ratio if ratio < 1.0 else None,
                             n_targets=feat_desc.shape[-2])
    return MatchResult(idx[0], dist[0]) if one else MatchResult(idx, dist)
