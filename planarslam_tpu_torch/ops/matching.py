"""Batched descriptor matching: gated Hamming search, ratio and mutual
checks, rotation-histogram consistency and duplicate resolution.

Port of ``planarslam_tpu/ops/matching.py``. Every association is one dense
gated (M, N) problem. Its core, the gates, the Hamming distance and the
per-row best / second-best / argmin, is kernel K3 ``gated_hamming_top2``
(``csrc/hamming_top2.cu``); ``gated_hamming_top2_plain`` is its plain
PyTorch version (the JAX package's +-1 matmul Hamming distance, masked,
then two min-reductions). -1 sentinels mark missing matches.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
from torch.profiler import record_function

from planarslam_tpu_torch import kernels
from planarslam_tpu_torch.geometry import se3
from planarslam_tpu_torch.ops.consts import literal
from planarslam_tpu_torch.ops.lax_compat import mod, top_k
from planarslam_tpu_torch.ops.orb import hamming_distance

INF_DIST = 10_000


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
    (M,) / b_ok (N,) bool, optional projection gates. Masked pairs count as
    INF_DIST. Returns (best, second, best_idx), each (M,) int32."""
    tensors = [a_desc, b_desc, a_ok, b_ok]
    if gate is not None:
        tensors += list(gate[:-1])
    if kernels.on_cpu(*tensors):
        return gated_hamming_top2_plain(a_desc, b_desc, a_ok, b_ok, gate)
    m, n = a_desc.shape[0], b_desc.shape[0]
    kernels.check(a_desc, "a_desc", torch.int32, (m, 8))
    kernels.check(b_desc, "b_desc", torch.int32, (n, 8))
    kernels.check(a_ok, "a_ok", torch.bool, (m,))
    kernels.check(b_ok, "b_ok", torch.bool, (n,))
    gate_ptrs = [0] * 7
    level_window = 0
    if gate is not None:
        kernels.check(gate.a_uv, "a_uv", torch.float32, (m, 2))
        kernels.check(gate.a_r, "a_r", torch.float32, (m,))
        kernels.check(gate.a_level, "a_level", torch.int32, (m,))
        kernels.check(gate.a_ur_pred, "a_ur_pred", torch.float32, (m,))
        kernels.check(gate.b_uv, "b_uv", torch.float32, (n, 2))
        kernels.check(gate.b_level, "b_level", torch.int32, (n,))
        kernels.check(gate.b_ur, "b_ur", torch.float32, (n,))
        gate_ptrs = [kernels.ptr(t) for t in gate[:-1]]
        level_window = int(gate.level_window)
    best = torch.empty(m, dtype=torch.int32, device=a_desc.device)
    second = torch.empty_like(best)
    best_idx = torch.empty_like(best)
    with torch.cuda.device(a_desc.device):
        kernels.launch("psl_gated_hamming_top2", kernels.ptr(a_desc),
                       kernels.ptr(b_desc), m, n, kernels.ptr(a_ok),
                       kernels.ptr(b_ok), int(gate is not None), *gate_ptrs,
                       level_window, kernels.ptr(best), kernels.ptr(second),
                       kernels.ptr(best_idx))
    kernels.LAUNCHES["gated_hamming_top2"] += 1
    return best, second, best_idx


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


def rotation_histogram_filter(angle_src: torch.Tensor,
                              angle_tgt_matched: torch.Tensor,
                              valid: torch.Tensor, histo_length: int = 30
                              ) -> torch.Tensor:
    """Keep matches whose angle difference falls in the 3 most common bins;
    bins 2 and 3 only when they hold >= 10% of the best bin's count."""
    two_pi = 2.0 * math.pi
    rot = mod(angle_src - angle_tgt_matched, two_pi)
    bins = torch.clamp((rot * histo_length / two_pi).to(torch.int64), 0,
                       histo_length - 1)
    counts = torch.zeros(histo_length, dtype=torch.int32,
                         device=valid.device)
    counts = counts.index_add(0, bins, valid.to(torch.int32))
    top3_val, top3_idx = top_k(counts, 3)
    keep2 = top3_val[1].to(torch.float32) >= 0.1 * top3_val[0]
    keep3 = top3_val[2].to(torch.float32) >= 0.1 * top3_val[0]
    keep_bin = torch.zeros(histo_length, dtype=torch.bool,
                           device=valid.device)
    keep_bin = keep_bin.index_put((top3_idx[:1],), torch.ones_like(keep2)[None])
    keep_bin = keep_bin.index_put((top3_idx[1:2],), keep2[None])
    keep_bin = keep_bin.index_put((top3_idx[2:3],), keep3[None])
    return valid & keep_bin[bins]


@record_function("matching.match_descriptors")
def match_descriptors(desc_a: torch.Tensor, desc_b: torch.Tensor,
                      valid_a: torch.Tensor, valid_b: torch.Tensor,
                      max_dist: int = 50, ratio: float = 0.9,
                      mutual: bool = True) -> MatchResult:
    """Brute-force descriptor matching a->b with Lowe ratio and an optional
    mutual check (two K3 launches: rows, then the transposed problem)."""
    best, second, best_idx = gated_hamming_top2(desc_a, desc_b, valid_a,
                                                valid_b)
    ok = (best <= max_dist) & (best.to(torch.float32)
                               < ratio * second.to(torch.float32))
    if mutual:
        _, _, back = gated_hamming_top2(desc_b, desc_a, valid_b, valid_a)
        rows = torch.arange(desc_a.shape[0], dtype=torch.int32,
                            device=desc_a.device)
        ok = ok & (back[best_idx.to(torch.int64)] == rows)
    idx = torch.where(ok, best_idx, -1).to(torch.int32)
    dist = torch.where(ok, best, INF_DIST).to(torch.int32)
    return MatchResult(idx, dist)


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
    window (one K3 launch for the gated (M, N) problem)."""
    w_img, h_img = image_wh
    dev = pts_w.device
    pc = se3.transform_points(T_cw, pts_w)
    z = pc[:, 2]
    uv = se3.project(K, pc)
    in_front = z > 0.05
    in_img = ((uv[:, 0] >= 0) & (uv[:, 0] < w_img)
              & (uv[:, 1] >= 0) & (uv[:, 1] < h_img))
    gate_pt = valid_pts & in_front & in_img

    cam_center = -T_cw[:3, :3].T @ T_cw[:3, 3]
    vec = pts_w - cam_center[None, :]
    dist = torch.clamp(torch.linalg.norm(vec, dim=-1), min=1e-6)
    if dist_range is not None:
        dmin, dmax = dist_range
        gate_pt = gate_pt & (dist >= 0.8 * dmin) & (dist <= 1.2 * dmax)
        log_sf = torch.log(literal(scale_factor, torch.float32, dev))
        pred_level = torch.ceil(
            torch.log(torch.clamp(dmax / dist, min=1.0)) / log_sf
        ).to(torch.int32)
    else:
        pred_level = torch.zeros_like(z, dtype=torch.int32)
    if view_normals is not None:
        cosv = torch.sum(vec * view_normals, dim=-1) / dist
        gate_pt = gate_pt & (cosv > 0.5)

    r = radius * scale_factor ** pred_level.to(torch.float32)
    ur_pred = uv[:, 0] - bf / torch.clamp(z, min=1e-6)
    gate = ProjGate(a_uv=uv.contiguous(), a_r=r.contiguous(),
                    a_level=pred_level, a_ur_pred=ur_pred.contiguous(),
                    b_uv=feat_uv.contiguous(),
                    b_level=feat_level.to(torch.int32).contiguous(),
                    b_ur=feat_ur.contiguous(), level_window=level_window)
    best, second, best_idx = gated_hamming_top2(
        descs.contiguous(), feat_desc.contiguous(), gate_pt.contiguous(),
        feat_valid.contiguous(), gate)
    ok = best <= max_dist
    if ratio < 1.0:
        ok = ok & (best.to(torch.float32) < ratio * second.to(torch.float32))
    idx = torch.where(ok, best_idx, -1).to(torch.int32)
    dist_out = torch.where(ok, best, INF_DIST).to(torch.int32)
    return MatchResult(*_resolve_duplicates(idx, dist_out,
                                            feat_desc.shape[0]))
