"""Depth-based plane segmentation and surface normals.

Port of ``planarslam_tpu/ops/planes.py``: per-block moments -> closed-form
3x3 eigen plane fits -> connected components over the coplanar-neighbour
block graph (min-label propagation with pointer jumping, fixed rounds) ->
per-component refit, top-P by support -> pixel-level refinement rounds.

``plane_block_moments`` is kernel K4 (Triton, ``csrc/plane_moments_triton.py``):
back-projection, the depth-range and depth-jump gate and the per-block
moment sums in one pass. The rest of ``extract_planes`` is three CUDA
kernels (``csrc/plane_segment.cu``): ``plane_components`` (K12: block fits,
connected components, top-P candidates), ``plane_assign_refit`` (K13: one
assign-and-refit round over the subsampled pixels, launched once per
round) and ``plane_label_pixels`` (K14: the final gate and the
full-resolution labels). Each wrapper has its plain PyTorch version beside
it (``*_plain``), taken only for CPU tensors; ``extract_planes`` composes
the wrappers. The noise scale before them is K28 ``_noise_alpha`` (its
plain version ``noise_alpha_plain``), and the frame's surface normals,
``box_smooth_depth``, ``backproject_depth`` and the strided
``surface_normals`` padded to the normal budget, are K29 ``frame_normals``
(its plain version ``frame_normals_plain``), both in
``csrc/depth_normals.cu``. The plain normal chain spells every cross
product, dot and norm in a fixed order (``dot3``, ``cross3``), which the
kernel repeats.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function
import torch.nn.functional as F

from planarslam_tpu_torch import kernels
from planarslam_tpu_torch.config import CameraConfig, PlaneConfig
from planarslam_tpu_torch.geometry import plane as plane_geo
from planarslam_tpu_torch.ops.consts import literal
from planarslam_tpu_torch.ops.eig3 import eigh_sym3x3
from planarslam_tpu_torch.ops.lax_compat import nanmedian, segment_sum, top_k


# float32 constants rounded as the JAX module's f32 expressions round them
_THREE_SQRT2 = float(np.float32(3.0) * np.sqrt(np.float32(2.0)))
_MAD_TO_SIGMA = float(np.float32(0.674) * np.sqrt(np.float32(6.0)))


class PlaneFeatures(NamedTuple):
    coeffs: torch.Tensor      # (P, 4) camera-frame plane coeffs (unit n, d >= 0)
    centroid: torch.Tensor    # (P, 3) camera-frame centroid of supporting pixels
    count: torch.Tensor       # (P,) int32 supporting pixel count
    valid: torch.Tensor       # (P,) bool
    pixel_label: torch.Tensor  # (H, W) int32 plane id in [0, P) or -1


@record_function("planes.backproject_depth")
def backproject_depth(depth: torch.Tensor, cam: CameraConfig) -> torch.Tensor:
    """(H, W) metres -> (H, W, 3) camera-frame points (z=0 where invalid)."""
    h, w = depth.shape
    vv = torch.arange(h, dtype=depth.dtype, device=depth.device)[:, None]
    uu = torch.arange(w, dtype=depth.dtype, device=depth.device)[None, :]
    x = (uu - cam.cx) / cam.fx * depth
    y = (vv - cam.cy) / cam.fy * depth
    return torch.stack([x, y, depth], dim=-1)


def _box_sum(x: torch.Tensor, k: int) -> torch.Tensor:
    """k x k window sum, zero outside the image ('SAME' reduce_window)."""
    lo = (k - 1) // 2
    hi = k - 1 - lo
    xp = F.pad(x, (lo, hi, lo, hi))
    h, w = x.shape
    acc = torch.zeros_like(x)
    for dy in range(k):
        for dx in range(k):
            acc = acc + xp[dy:dy + h, dx:dx + w]
    return acc


@record_function("planes.box_smooth_depth")
def box_smooth_depth(depth: torch.Tensor, k: int = 5) -> torch.Tensor:
    """Edge-preserving box smoothing of valid depths (see the JAX module)."""
    if k <= 1:
        return depth
    valid = (depth > 1e-6).to(depth.dtype)
    sums = _box_sum(depth * valid, k)
    cnts = _box_sum(valid, k)
    mu = sums / torch.clamp(cnts, min=1.0)
    keep = torch.abs(depth - mu) < 0.03 * torch.clamp(depth, min=1.0)
    return torch.where((valid > 0) & keep & (cnts > 0), mu, depth)


def _max_window(x: torch.Tensor, k: int) -> torch.Tensor:
    """k x k max filter, -inf outside the image ('SAME' reduce_window)."""
    lo = (k - 1) // 2
    hi = k - 1 - lo
    xp = F.pad(x[None, None], (lo, hi, lo, hi), value=-math.inf)
    return F.max_pool2d(xp, k, stride=1)[0, 0]


def dot3(a, b):
    """((a0 b0 + a1 b1) + a2 b2) of two 3-sequences of tensors: the order the
    kernels repeat (a matrix product, ``linalg.cross`` or a sum over a last
    dimension of 3 leaves its order, or a fused multiply-add, to the
    library)."""
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def cross3(a, b):
    """a x b of two 3-sequences of tensors, each component a difference of
    two rounded products."""
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def _oriented_normal(xp, xm, yp, ym, p):
    """The unit normal of the central differences 0.5 (xp - xm) and
    0.5 (yp - ym), turned toward the camera, and its norm before."""
    dx = [0.5 * (a - b) for a, b in zip(xp, xm)]
    dy = [0.5 * (a - b) for a, b in zip(yp, ym)]
    n = cross3(dx, dy)
    norm = torch.sqrt(dot3(n, n) + 1e-18)
    n = [c / norm for c in n]
    flip = dot3(n, p) > 0
    return [torch.where(flip, -c, c) for c in n], norm


@record_function("planes.surface_normals")
def surface_normals(points: torch.Tensor, stride: int = 1
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Normals from the point map via central differences, oriented toward
    the camera. Returns (normals (H', W', 3), valid (H', W'))."""
    roll = torch.roll

    def shifted(comps, s, dim):
        return [roll(c, s, dim) for c in comps]

    if stride <= 1:
        p = points.unbind(-1)
        z = p[2]
        xp, xm = shifted(p, -1, 1), shifted(p, 1, 1)
        yp, ym = shifted(p, -1, 0), shifted(p, 1, 0)
        n, norm = _oriented_normal(xp, xm, yp, ym, p)
        zn = xp[2] * xm[2] * yp[2] * ym[2]
        jump = torch.maximum(torch.abs(xp[2] - xm[2]),
                             torch.abs(yp[2] - ym[2]))
        valid = ((z > 1e-6) & (zn > 1e-12) & (norm > 1e-9)
                 & (jump < 0.05 * torch.clamp(z, min=1.0)))
        return torch.stack(n, dim=-1), valid

    b = min(stride, 3)
    z_full = points[..., 2]
    jump1 = torch.maximum(torch.abs(z_full - roll(z_full, -1, 1)),
                          torch.abs(z_full - roll(z_full, -1, 0)))
    jmax = _max_window(jump1, 2 * b + 1)
    off = stride // 2

    def sub(comps):
        return [c[off::stride, off::stride] for c in comps]

    full = points.unbind(-1)
    p = sub(full)
    pxp, pxm = sub(shifted(full, -b, 1)), sub(shifted(full, b, 1))
    pyp, pym = sub(shifted(full, -b, 0)), sub(shifted(full, b, 0))
    disc_free = (jmax[off::stride, off::stride]
                 < 0.05 * torch.clamp(p[2], min=1.0))
    n, norm = _oriented_normal(pxp, pxm, pyp, pym, p)
    # crease guard: the one-sided normals agree within 45 degrees
    n_f = cross3([a - c for a, c in zip(pxp, p)],
                 [a - c for a, c in zip(pyp, p)])
    n_b = cross3([c - a for c, a in zip(p, pxm)],
                 [c - a for c, a in zip(p, pym)])
    nf_n = torch.sqrt(dot3(n_f, n_f) + 1e-18)
    nb_n = torch.sqrt(dot3(n_b, n_b) + 1e-18)
    agree = dot3(n_f, n_b) / (nf_n * nb_n) > 0.7071
    zn = pxp[2] * pxm[2] * pyp[2] * pym[2]
    valid = ((p[2] > 1e-6) & (zn > 1e-12) & (norm > 1e-9)
             & disc_free & agree)
    border = torch.zeros_like(valid)
    border[1:-1, 1:-1] = True
    return torch.stack(n, dim=-1), valid & border


def frame_normals_plain(depth: torch.Tensor, cam: CameraConfig,
                        smooth_window: int, stride: int, budget: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K29 for one frame: the edge-preserving smoothed
    depth, its point map, the normals of the sampling stride, flattened
    row-major and padded with zero / False (or cut) to `budget` rows."""
    depth_s = box_smooth_depth(depth, smooth_window)
    n, v = surface_normals(backproject_depth(depth_s, cam), stride=stride)
    n = n.reshape(-1, 3)
    v = v.reshape(-1)
    if n.shape[0] < budget:
        n = F.pad(n, (0, 0, 0, budget - n.shape[0]))
        v = F.pad(v.to(torch.uint8), (0, budget - v.shape[0])).to(torch.bool)
    return n[:budget], v[:budget]


@record_function("planes.frame_normals")
def frame_normals(depth: torch.Tensor, cam: CameraConfig,
                  smooth_window: int, stride: int, budget: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K29 wrapper. depth: (H, W) or (B, H, W) float32 metres. Returns the
    normals (budget, 3) float32 and their flags (budget,) bool, with a
    leading B for a batch."""
    if depth.dim() not in (2, 3):
        raise ValueError(f"depth: expected (H, W) or (B, H, W), got "
                         f"{tuple(depth.shape)}")
    frames = depth[None] if depth.dim() == 2 else depth
    if kernels.on_cpu(depth):
        normals, valid = kernels.per_problem(
            frame_normals_plain, [frames], cam, smooth_window, stride, budget)
    else:
        kernels.check(depth, "depth", torch.float32)
        b, h, w = frames.shape
        dev = depth.device
        normals = torch.empty((b, budget, 3), dtype=torch.float32,
                              device=dev)
        valid = torch.empty((b, budget), dtype=torch.bool, device=dev)
        with torch.cuda.device(dev):
            kernels.launch("psl_frame_normals", kernels.ptr(frames), h, w, b,
                           int(stride), int(budget), int(smooth_window),
                           kernels.scalar_reciprocal(cam.fx),
                           kernels.scalar_reciprocal(cam.fy), float(cam.cx),
                           float(cam.cy), kernels.ptr(normals),
                           kernels.ptr(valid))
        kernels.LAUNCHES["frame_normals"] += 1
    if depth.dim() == 2:
        return normals[0], valid[0]
    return normals, valid


class _BlockStats(NamedTuple):
    s1: torch.Tensor     # (B, 3)  sum of points
    s2: torch.Tensor     # (B, 3, 3) sum of outer products
    n: torch.Tensor      # (B,) count of valid pixels


def _plane_from_moments(s1, s2, n):
    """Least-squares plane from moments: smallest eigenvector of the scatter
    matrix. Returns (normal (...,3), d (...), mse (...), centroid (...,3))."""
    n_safe = torch.clamp(n, min=1.0)
    mean = s1 / n_safe[..., None]
    cov = s2 / n_safe[..., None, None] - mean[..., :, None] * mean[..., None, :]
    cov = cov + 1e-12 * torch.eye(3, dtype=cov.dtype, device=cov.device)
    evals, evecs = eigh_sym3x3(cov)
    normal = evecs[..., :, 0]
    mse = evals[..., 0]
    flip = torch.sum(normal * mean, dim=-1) > 0
    normal = torch.where(flip[..., None], -normal, normal)
    d = -torch.sum(normal * mean, dim=-1)
    return normal, d, mse, mean


def _block_moments(points: torch.Tensor, valid: torch.Tensor, block: int
                   ) -> _BlockStats:
    h, w, _ = points.shape
    hb, wb = h // block, w // block
    p = points[:hb * block, :wb * block].reshape(hb, block, wb, block, 3)
    v = valid[:hb * block, :wb * block].reshape(hb, block, wb, block)
    pv = p * v[..., None]
    s1 = pv.sum(dim=(1, 3)).reshape(-1, 3)
    s2 = torch.einsum("abcdi,abcdj->acij", pv, pv).reshape(-1, 3, 3)
    n = v.sum(dim=(1, 3)).reshape(-1).to(torch.float32)
    return _BlockStats(s1, s2, n)


def _jump_tolerance(depth: torch.Tensor, alpha: torch.Tensor,
                    geo_tol: float) -> torch.Tensor:
    z2 = torch.clamp(depth, min=1.0) ** 2
    return torch.maximum(geo_tol * torch.clamp(depth, min=1.0),
                         _THREE_SQRT2 * alpha * z2)


def _valid_depth(depth: torch.Tensor, alpha: torch.Tensor, geo_tol: float,
                 max_distance: float) -> torch.Tensor:
    """Depth-range gate and depth-jump gate (right and lower neighbour)."""
    tol = _jump_tolerance(depth, alpha, geo_tol)
    jump_r = torch.abs(depth - torch.roll(depth, -1, 1))
    jump_d = torch.abs(depth - torch.roll(depth, -1, 0))
    jump_r[:, -1] = 0.0
    jump_d[-1, :] = 0.0
    return ((depth > 1e-6) & (depth < max_distance)
            & (jump_r < tol) & (jump_d < tol))


def _frames(lead: tuple) -> int:
    """The frame count of a leading batch shape, () for one frame."""
    f = int(np.prod(lead)) if lead else 1
    if len(lead) > 1 or not 0 < f <= 65535:
        raise ValueError(f"one leading dimension of 1 to 65535 frames, got "
                         f"{lead}")
    return f


def plane_block_moments_plain(depth: torch.Tensor, alpha: torch.Tensor,
                              cam: CameraConfig, geo_tol: float,
                              max_distance: float, block: int) -> _BlockStats:
    """Plain version of K4: back-projection + gate + per-block moments."""
    ok = _valid_depth(depth, alpha, geo_tol, max_distance)
    return _block_moments(backproject_depth(depth, cam), ok, block)


def plane_block_moments(depth: torch.Tensor, alpha: torch.Tensor,
                        cam: CameraConfig, geo_tol: float,
                        max_distance: float, block: int) -> _BlockStats:
    """K4 wrapper. depth: (H, W) float32 metres; alpha: () float32 noise
    scale. Returns per-block (s1 (nb, 3), s2 (nb, 3, 3), n (nb,)) float32
    with nb = (H // block) * (W // block), blocks in row-major order. A
    batch, depth (F, H, W) and alpha (F,), is one launch and gives each
    output a leading F."""
    if kernels.on_cpu(depth, alpha):
        if depth.dim() == 2:
            return plane_block_moments_plain(depth, alpha, cam, geo_tol,
                                             max_distance, block)
        return kernels.per_problem(plane_block_moments_plain, [depth, alpha],
                                   cam, geo_tol, max_distance, block)
    kernels.check(depth, "depth", torch.float32)
    if depth.dim() not in (2, 3):
        raise ValueError(f"depth: expected (H, W) or (F, H, W), got "
                         f"{tuple(depth.shape)}")
    if block & (block - 1):
        raise ValueError(f"block must be a power of two, got {block}")
    lead = tuple(depth.shape[:-2])
    f = _frames(lead)
    h, w = depth.shape[-2:]
    kernels.check(alpha, "alpha", torch.float32, lead)
    nb = (h // block) * (w // block)
    coef = (_THREE_SQRT2 * alpha).to(torch.float32)
    s1 = torch.empty((*lead, nb, 3), dtype=torch.float32, device=depth.device)
    s2 = torch.empty((*lead, nb, 3, 3), dtype=torch.float32,
                     device=depth.device)
    n = torch.empty((*lead, nb), dtype=torch.float32, device=depth.device)
    with torch.cuda.device(depth.device):
        kernels.triton_module().launch(
            depth, coef, s1, s2, n, f, h, w, float(cam.fx), float(cam.fy),
            float(cam.cx), float(cam.cy), float(max_distance),
            float(geo_tol), block)
    kernels.LAUNCHES["plane_block_moments"] += 1
    return _BlockStats(s1, s2, n)


def noise_alpha_plain(depth: torch.Tensor, max_distance: float
                      ) -> torch.Tensor:
    """Plain version of K28 for one frame: the per-frame depth-noise scale
    alpha (sigma(z) = alpha z^2) from the median absolute second difference
    on a 4x4-strided subsample; () float32, 0 without a valid sample."""
    z2 = torch.clamp(depth, min=1.0) ** 2
    depth_ok = (depth > 1e-6) & (depth < max_distance)
    d2_r = torch.abs(depth - 2 * torch.roll(depth, -1, 1)
                     + torch.roll(depth, -2, 1))
    interior = (depth_ok & torch.roll(depth_ok, -1, 1)
                & torch.roll(depth_ok, -2, 1))
    sub_r = torch.where(interior, d2_r / z2, math.nan)[::4, ::4]
    alpha = nanmedian(sub_r) / _MAD_TO_SIGMA
    return torch.nan_to_num(alpha, nan=0.0)


def _noise_alpha(depth: torch.Tensor, max_distance: float) -> torch.Tensor:
    """K28 wrapper. depth: (H, W) float32 metres -> () float32, or
    (B, H, W) -> (B,). A frame may hold at most 421888 strided samples
    (ceil(H / 4) x ceil(W / 4), e.g. 2560x2560): the kernel raises past
    that."""
    if depth.dim() not in (2, 3):
        raise ValueError(f"depth: expected (H, W) or (B, H, W), got "
                         f"{tuple(depth.shape)}")
    frames = depth[None] if depth.dim() == 2 else depth
    if kernels.on_cpu(depth):
        alpha, = kernels.per_problem(
            lambda d: (noise_alpha_plain(d, max_distance),), [frames])
        return alpha[0] if depth.dim() == 2 else alpha
    kernels.check(depth, "depth", torch.float32)
    b, h, w = frames.shape
    alpha = torch.empty((b,), dtype=torch.float32, device=depth.device)
    with torch.cuda.device(depth.device):
        kernels.launch("psl_noise_alpha", kernels.ptr(frames), h, w, b,
                       float(max_distance),
                       kernels.scalar_reciprocal(_MAD_TO_SIGMA),
                       kernels.ptr(alpha))
    kernels.LAUNCHES["noise_alpha"] += 1
    return alpha[0] if depth.dim() == 2 else alpha


class PlaneCandidates(NamedTuple):
    normal: torch.Tensor       # (P, 3) candidate plane normals
    d: torch.Tensor            # (P,) candidate plane offsets
    valid: torch.Tensor        # (P,) bool, after the support gate and dedup
    labels: torch.Tensor       # (B,) int32 component root of every block
    block_valid: torch.Tensor  # (B,) bool


class PlaneRefit(NamedTuple):
    label_sub: torch.Tensor  # (S,) int32 plane of each subsampled pixel or P
    normal: torch.Tensor     # (P, 3) refitted planes
    d: torch.Tensor          # (P,)
    mse: torch.Tensor        # (P,)
    mean: torch.Tensor       # (P, 3) centroids
    n: torch.Tensor          # (P,) support in full-resolution pixels
    alive: torch.Tensor      # (P,) bool: the planes this round assigned to


# most blocks K12's chain block holds in shared memory (two int32 label
# buffers, two byte edge maps and a validity byte per block) and most planes K12-K14
# keep per thread block
MAX_BLOCKS = 16384
MAX_PLANES = 32
# subsampled pixels per logical thread block of K13: one row of its
# partial-sum scratch per block
ASSIGN_PIXELS_PER_BLOCK = 512


def _geo_tol(width: int) -> float:
    """Geometric depth-jump tolerance per metre, scaled with resolution."""
    return 0.02 * (640.0 / width)


def plane_components_plain(stats: _BlockStats, hb: int, wb: int,
                           cfg: PlaneConfig) -> PlaneCandidates:
    """Plain version of K12: per-block plane fits and validity, connected
    components over coplanar neighbours (synchronous min-label pull with
    pointer jumping, ``merge_rounds`` rounds), per-component refit of the
    top-P components by support, dedup of near-identical candidates."""
    dev = stats.n.device
    block = cfg.block
    n_blocks = hb * wb
    normal_b, d_b, mse_b, mean_b = _plane_from_moments(stats.s1, stats.s2,
                                                       stats.n)

    z_blk = mean_b[:, 2]
    full = stats.n >= (block * block - 4)
    mse_thresh = (cfg.block_mse_sigma * z_blk * z_blk + cfg.block_mse_tol) ** 2
    block_valid = full & (mse_b < mse_thresh) & (z_blk > 1e-6)

    # --- connected components over "coplanar neighbors" ----------------------
    angle_cos = math.cos(math.radians(cfg.angle_threshold_deg * 2.0))

    def similar(i_flat, j_flat):
        ni, nj = normal_b[i_flat], normal_b[j_flat]
        cos = torch.sum(ni * nj, dim=-1)
        dist = torch.abs(torch.sum(nj * mean_b[i_flat], dim=-1) + d_b[j_flat])
        return ((cos > angle_cos) & (dist < cfg.distance_threshold)
                & block_valid[i_flat] & block_valid[j_flat])

    ids = torch.arange(n_blocks, device=dev)
    iy, ix = ids // wb, ids % wb
    nbr_right = torch.where(ix + 1 < wb, ids + 1, ids)
    nbr_down = torch.where(iy + 1 < hb, ids + wb, ids)
    edge_r = (similar(ids, nbr_right) & (nbr_right != ids)).reshape(hb, wb)
    edge_d = (similar(ids, nbr_down) & (nbr_down != ids)).reshape(hb, wb)
    edge_l = torch.roll(edge_r, 1, 1)
    edge_u = torch.roll(edge_d, 1, 0)
    big = literal(n_blocks, torch.int64, dev)

    labels = ids
    for _ in range(cfg.merge_rounds):
        lab2 = labels.reshape(hb, wb)
        new = torch.minimum(
            torch.minimum(torch.where(edge_r, torch.roll(lab2, -1, 1), big),
                          torch.where(edge_l, torch.roll(lab2, 1, 1), big)),
            torch.minimum(torch.where(edge_d, torch.roll(lab2, -1, 0), big),
                          torch.where(edge_u, torch.roll(lab2, 1, 0), big)))
        new = torch.minimum(lab2, new).reshape(-1)
        labels = new[new]  # pointer jumping

    # --- per-component refit --------------------------------------------------
    bvf = block_valid.to(stats.n.dtype)
    seg = torch.where(block_valid, labels, n_blocks)
    s1_seg = segment_sum(stats.s1 * bvf[:, None], seg, n_blocks + 1)
    s2_seg = segment_sum(stats.s2 * bvf[:, None, None], seg, n_blocks + 1)
    n_seg = segment_sum(stats.n * bvf, seg, n_blocks + 1)

    top_n, top_idx = top_k(n_seg[:n_blocks], cfg.max_planes)
    cand_valid = top_n >= float(min(cfg.min_size, 3 * block * block))
    normal_c, d_c, _, _ = _plane_from_moments(
        s1_seg[top_idx], s2_seg[top_idx], top_n)

    cos_ij = normal_c @ normal_c.T
    d_ij = torch.abs(d_c[:, None] - d_c[None, :])
    dup = ((cos_ij > cfg.assoc_angle) & (d_ij < 2 * cfg.assoc_dist)
           & cand_valid[:, None] & cand_valid[None, :])
    shadowed = torch.tril(dup, -1).any(dim=1)
    cand_valid = cand_valid & ~shadowed
    return PlaneCandidates(normal_c, d_c, cand_valid,
                           labels.to(torch.int32), block_valid)


def plane_components(stats: _BlockStats, hb: int, wb: int,
                     cfg: PlaneConfig) -> PlaneCandidates:
    """K12 wrapper. stats: K4's (s1 (B, 3), s2 (B, 3, 3), n (B,)) float32
    over the hb x wb block grid, B = hb * wb in row-major order. Returns
    the P = cfg.max_planes candidate planes with their validity, and every
    block's component label and validity. Stats of F frames, each field
    with a leading F, are one C call for all frames (two launches: the
    block fits over the card, then one thread block per frame for the rest
    of the chain), and every output then has the leading F."""
    lead = tuple(stats.n.shape[:-1])
    if kernels.on_cpu(*stats):
        if not lead:
            return plane_components_plain(stats, hb, wb, cfg)
        return kernels.per_problem(
            lambda *t: plane_components_plain(_BlockStats(*t), hb, wb, cfg),
            list(stats))
    nb, p_cap = hb * wb, cfg.max_planes
    f = _frames(lead)
    kernels.check(stats.s1, "s1", torch.float32, (*lead, nb, 3))
    kernels.check(stats.s2, "s2", torch.float32, (*lead, nb, 3, 3))
    kernels.check(stats.n, "n", torch.float32, (*lead, nb))
    if not 0 < p_cap <= min(MAX_PLANES, nb):
        raise ValueError(f"max_planes must lie in [1, min({MAX_PLANES}, "
                         f"{nb} blocks)], got {p_cap}")
    if nb > MAX_BLOCKS:
        raise ValueError(f"{nb} blocks exceed the {MAX_BLOCKS} one thread "
                         f"block holds")
    dev = stats.n.device
    fit_b = torch.empty((f, nb, 7), dtype=torch.float32, device=dev)
    normal_c = torch.empty((*lead, p_cap, 3), dtype=torch.float32,
                           device=dev)
    d_c = torch.empty((*lead, p_cap), dtype=torch.float32, device=dev)
    cand_valid = torch.empty((*lead, p_cap), dtype=torch.bool, device=dev)
    labels = torch.empty((*lead, nb), dtype=torch.int32, device=dev)
    block_valid = torch.empty((*lead, nb), dtype=torch.bool, device=dev)
    block = cfg.block
    with torch.cuda.device(dev):
        kernels.launch(
            "psl_plane_components", kernels.ptr(stats.s1),
            kernels.ptr(stats.s2), kernels.ptr(stats.n), hb, wb, p_cap,
            int(cfg.merge_rounds), float(block * block - 4),
            float(cfg.block_mse_sigma), float(cfg.block_mse_tol),
            math.cos(math.radians(cfg.angle_threshold_deg * 2.0)),
            float(cfg.distance_threshold),
            float(min(cfg.min_size, 3 * block * block)),
            float(cfg.assoc_angle), 2.0 * cfg.assoc_dist, f,
            kernels.ptr(fit_b), kernels.ptr(normal_c), kernels.ptr(d_c),
            kernels.ptr(cand_valid), kernels.ptr(labels),
            kernels.ptr(block_valid))
    kernels.LAUNCHES["plane_components"] += 1
    return PlaneCandidates(normal_c, d_c, cand_valid, labels, block_valid)


def _pixel_inputs(depth: torch.Tensor, alpha: torch.Tensor,
                  cam: CameraConfig, cfg: PlaneConfig, stride: int):
    """Per pixel of the stride-subsampled grid: the back-projected point
    (S, 3), the noise-scaled distance band (S,) and the depth gate (S,)."""
    points = backproject_depth(depth, cam)
    z2 = torch.clamp(depth, min=1.0) ** 2
    depth_ok = _valid_depth(depth, alpha, _geo_tol(depth.shape[1]),
                            cfg.max_distance)
    pts = points[::stride, ::stride].reshape(-1, 3)
    band = torch.clamp(3.0 * alpha * z2[::stride, ::stride],
                       min=cfg.distance_threshold).reshape(-1)
    return pts, band, depth_ok[::stride, ::stride].reshape(-1)


def _tau(mse: torch.Tensor) -> torch.Tensor:
    """A plane's own inlier gate: 2.5 fitted sigma, at least 1 mm."""
    return torch.clamp(2.5 * torch.sqrt(torch.clamp(mse, min=0.0)), min=1e-3)


def plane_assign_refit_plain(depth: torch.Tensor, alpha: torch.Tensor,
                             cam: CameraConfig, cfg: PlaneConfig,
                             normal: torch.Tensor, d: torch.Tensor,
                             valid: torch.Tensor,
                             fit: Optional[Tuple[torch.Tensor, torch.Tensor,
                                                 torch.Tensor]] = None
                             ) -> PlaneRefit:
    """Plain version of K13: one assign-and-refit round over the
    ``refine_stride``-subsampled pixels. Round 1 (``fit`` None) assigns each
    gated pixel to the nearest valid plane within its band. A refine round
    gets the ``(mse, mean, n)`` of the fit the planes came from: it first
    drops ghost planes (a plane whose centroid lies in a bigger, nearly
    parallel plane's band), then also gates each pixel at its plane's own
    tau. Either way the planes are refitted from the moments of their
    pixels, weighted by the stride's area."""
    p_cap = normal.shape[0]
    rs = max(1, int(cfg.refine_stride))
    pts, band, ok = _pixel_inputs(depth, alpha, cam, cfg, rs)
    if fit is None:
        alive = valid
    else:
        mse, mean, n_p = fit
        alive = valid & (n_p > 3)
        cosm = normal @ normal.T
        cen_d = torch.abs(mean @ normal.T + d[None, :])
        band_j = torch.clamp(
            3.0 * alpha * torch.clamp(mean[:, 2], min=1.0) ** 2,
            min=cfg.distance_threshold)
        bigger = n_p[None, :] > n_p[:, None]
        shadow = (alive[None, :] & alive[:, None] & bigger
                  & (cosm > 0.9063) & (cen_d < band_j[:, None]))
        alive = alive & ~shadow.any(dim=1)

    dist = torch.abs(pts @ normal.T + d[None, :])
    dist = torch.where(alive[None, :], dist, math.inf)
    best_d = torch.amin(dist, dim=-1)
    best = torch.argmin(dist, dim=-1)
    if fit is None:
        keep = (best_d < band) & ok
    else:
        keep = (best_d < torch.minimum(_tau(mse)[best], band)) & ok
    label = torch.where(keep, best, p_cap)

    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    feats = torch.stack([x, y, z, x * x, x * y, x * z, y * y, y * z, z * z,
                         torch.ones_like(x)], dim=-1)
    one_hot = F.one_hot(label, p_cap + 1).to(feats.dtype)
    a = (one_hot.T @ feats * float(rs * rs))[:p_cap]
    s2_p = torch.stack([
        torch.stack([a[:, 3], a[:, 4], a[:, 5]], -1),
        torch.stack([a[:, 4], a[:, 6], a[:, 7]], -1),
        torch.stack([a[:, 5], a[:, 7], a[:, 8]], -1),
    ], dim=-2)
    n_new = a[:, 9]
    normal_f, d_f, mse_f, mean_f = _plane_from_moments(a[:, :3], s2_p, n_new)
    return PlaneRefit(label.to(torch.int32), normal_f, d_f, mse_f, mean_f,
                      n_new, alive)


def _check_pixel_args(depth, alpha, normal, d, valid, fit) -> int:
    """Validate what K13 and K14 share (one frame, or F frames with every
    tensor led by F); returns P."""
    kernels.check(depth, "depth", torch.float32)
    if depth.dim() not in (2, 3):
        raise ValueError(f"depth: expected (H, W) or (F, H, W), got "
                         f"{tuple(depth.shape)}")
    lead = tuple(depth.shape[:-2])
    _frames(lead)
    kernels.check(alpha, "alpha", torch.float32, lead)
    if normal.dim() != len(lead) + 2:
        raise ValueError(f"normal: expected {lead} + (P, 3), got "
                         f"{tuple(normal.shape)}")
    p_cap = normal.shape[-2]
    if not 0 < p_cap <= MAX_PLANES:
        raise ValueError(f"1 to {MAX_PLANES} planes, got {p_cap}")
    kernels.check(normal, "normal", torch.float32, (*lead, p_cap, 3))
    kernels.check(d, "d", torch.float32, (*lead, p_cap))
    kernels.check(valid, "valid", torch.bool, (*lead, p_cap))
    if fit is not None:
        kernels.check(fit[0], "mse", torch.float32, (*lead, p_cap))
        kernels.check(fit[1], "mean", torch.float32, (*lead, p_cap, 3))
        kernels.check(fit[2], "n", torch.float32, (*lead, p_cap))
    return p_cap


# K13's flag words by (device, stream): psl_plane_assign_flag_words of
# them (one per logical block and a ticket, for each frame a launch
# takes), zeroed when made; each launch's last collector of a frame
# clears the frame's words, so the launches of one stream share them and
# no call zeroes them. A stream's words are made at its first call, which
# may not lie inside a CUDA graph capture: the zeroing would run only at
# replay, and eager launches would find the words unset.
_FLAGS: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def _assign_flags(dev: torch.device, stream: int, words: int,
                  capturing: bool) -> torch.Tensor:
    """K13's flag words of ``stream`` on ``dev``: ``words`` int32 words,
    allocated zeroed at the stream's first request and the same tensor
    afterwards. Raises when the first request comes during a capture."""
    t = _FLAGS.get((dev, stream))
    if t is None:
        if capturing:
            raise RuntimeError(
                "plane_assign_refit: this stream has no flag words yet; "
                "call it once on the capturing stream before the capture "
                "(torch.cuda.graph(..., stream=s) after a warm-up on s)")
        t = torch.zeros(words, dtype=torch.int32, device=dev)
        _FLAGS[(dev, stream)] = t
    return t


def _pixel_scalars(depth, cam: CameraConfig, cfg: PlaneConfig):
    """The float arguments K13 and K14 share, after the image size."""
    return (float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy),
            _geo_tol(depth.shape[-1]), float(cfg.max_distance),
            float(cfg.distance_threshold), _THREE_SQRT2)


def plane_assign_refit(depth: torch.Tensor, alpha: torch.Tensor,
                       cam: CameraConfig, cfg: PlaneConfig,
                       normal: torch.Tensor, d: torch.Tensor,
                       valid: torch.Tensor,
                       fit: Optional[Tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]] = None,
                       partial: Optional[torch.Tensor] = None
                       ) -> PlaneRefit:
    """K13 wrapper. depth: (H, W) float32 metres; alpha: () float32 noise
    scale; normal (P, 3), d (P,), valid (P,) bool: the planes to assign to;
    fit: None in round 1, else the ``(mse (P,), mean (P, 3), n (P,))`` of
    the refit the planes came from (a refine round). Everything stays on
    the device: a round's result feeds the next without a host sync. F
    frames, every tensor with a leading F, take the launches the C entry
    chooses (one for up to its kCollectFrames) and reports, and every
    output then has the leading F. Launches of one stream share its flag words
    (_assign_flags). partial: None, or the float64 (F, n_part, P, 10)
    tensor the logical blocks write their sums to (made per call when
    None); a check may fill it with NaN first, since every term a
    collector adds is one a block wrote in the same launch."""
    tensors = [depth, alpha, normal, d, valid] + list(fit or ())
    if kernels.on_cpu(*tensors):
        if depth.dim() == 2:
            return plane_assign_refit_plain(depth, alpha, cam, cfg, normal,
                                            d, valid, fit)
        return kernels.per_problem(
            lambda dp, a, nm, dd, v, *ft: plane_assign_refit_plain(
                dp, a, cam, cfg, nm, dd, v, ft or None), tensors)
    p_cap = _check_pixel_args(depth, alpha, normal, d, valid, fit)
    rs = max(1, int(cfg.refine_stride))
    lead = tuple(depth.shape[:-2])
    f = _frames(lead)
    h, w = depth.shape[-2:]
    n_sub = -(-h // rs) * -(-w // rs)
    dev = depth.device

    def empty(shape, dtype=torch.float32):
        return torch.empty((*lead, *shape), dtype=dtype, device=dev)

    n_part = -(-n_sub // ASSIGN_PIXELS_PER_BLOCK)
    if partial is None:
        partial = torch.empty((f, n_part, p_cap, 10), dtype=torch.float64,
                              device=dev)
    kernels.check(partial, "partial", torch.float64, (f, n_part, p_cap, 10))
    if partial.device != dev:
        raise ValueError(f"partial: expected {dev}, got {partial.device}")
    out = PlaneRefit(empty((n_sub,), torch.int32), empty((p_cap, 3)),
                     empty((p_cap,)), empty((p_cap,)), empty((p_cap, 3)),
                     empty((p_cap,)), empty((p_cap,), torch.bool))
    fit_ptrs = [kernels.ptr(t) for t in fit] if fit is not None else [None] * 3
    launches = ctypes.c_int(0)
    with torch.cuda.device(dev):
        flags = _assign_flags(
            dev, torch.cuda.current_stream().cuda_stream,
            kernels.cuda_lib().psl_plane_assign_flag_words(),
            torch.cuda.is_current_stream_capturing())
        try:
            kernels.launch(
                "psl_plane_assign_refit", kernels.ptr(depth),
                kernels.ptr(alpha), h, w, rs,
                *_pixel_scalars(depth, cam, cfg), p_cap,
                kernels.ptr(normal), kernels.ptr(d), kernels.ptr(valid),
                *fit_ptrs, ASSIGN_PIXELS_PER_BLOCK, f, kernels.ptr(partial),
                kernels.ptr(flags), *[kernels.ptr(t) for t in out],
                ctypes.addressof(launches))
        finally:
            kernels.LAUNCHES["plane_assign_refit"] += launches.value
    return out


def _normalize_in_order(coeffs: torch.Tensor) -> torch.Tensor:
    """plane.normalize of (P, 4) coefficients with the norm's squares
    summed as K14 sums them, ((a^2 + b^2) + c^2) + eps: PyTorch's sum over
    the last axis takes another order on the card."""
    a, b, c = coeffs[:, 0], coeffs[:, 1], coeffs[:, 2]
    e = coeffs / torch.sqrt(a * a + b * b + c * c + plane_geo._EPS)[:, None]
    return e * torch.where(e[:, 3:4] < 0, -1.0, 1.0)


def plane_label_pixels_plain(depth: torch.Tensor, alpha: torch.Tensor,
                             cam: CameraConfig, cfg: PlaneConfig,
                             fit: PlaneRefit) -> PlaneFeatures:
    """Plain version of K14: the final gate over the last refit, then every
    full-resolution pixel labeled against the planes that pass (nearest
    plane, within its tau and the pixel's band, depth gate), -1 elsewhere.
    With ``refine_stride`` 1 the last round's labels are already at full
    resolution and are only gated by the planes' validity."""
    h, w = depth.shape
    p_cap = fit.normal.shape[0]
    count = fit.n.to(torch.int32)
    mse_gate = torch.clamp(2.0 * alpha * fit.mean[:, 2] ** 2,
                           min=cfg.distance_threshold) ** 2
    valid = fit.alive & (count >= cfg.min_size) & (fit.mse < mse_gate)
    coeffs = _normalize_in_order(torch.cat([fit.normal, fit.d[:, None]],
                                           dim=-1))
    coeffs = torch.where(valid[:, None], coeffs, 0.0)
    if max(1, int(cfg.refine_stride)) == 1:
        label_pix = fit.label_sub.to(torch.int64)
    else:
        pts, band, ok = _pixel_inputs(depth, alpha, cam, cfg, 1)
        dist = torch.abs(pts @ fit.normal.T + fit.d[None, :])
        dist = torch.where(valid[None, :], dist, math.inf)
        best_d = torch.amin(dist, dim=-1)
        best = torch.argmin(dist, dim=-1)
        keep = (best_d < torch.minimum(_tau(fit.mse)[best], band)) & ok
        label_pix = torch.where(keep, best, p_cap)

    lbl_ok = (label_pix < p_cap) & valid[torch.clamp(label_pix, 0, p_cap - 1)]
    pixel_label = torch.where(lbl_ok, label_pix, -1).to(torch.int32)
    return PlaneFeatures(coeffs=coeffs, centroid=fit.mean, count=count,
                         valid=valid, pixel_label=pixel_label.reshape(h, w))


def _out(shape, dtype, dev) -> torch.Tensor:
    """K14's output allocator (a check may hand out filled buffers)."""
    return torch.empty(shape, dtype=dtype, device=dev)


def plane_label_pixels(depth: torch.Tensor, alpha: torch.Tensor,
                       cam: CameraConfig, cfg: PlaneConfig,
                       fit: PlaneRefit) -> PlaneFeatures:
    """K14 wrapper. depth: (H, W) float32; alpha: () float32; fit: the last
    round's PlaneRefit (its label_sub is read only with refine_stride 1,
    where it must hold H * W labels). F frames, every tensor with a leading
    F, are one launch, and every output then has the leading F."""
    if kernels.on_cpu(depth, alpha, *fit):
        if depth.dim() == 2:
            return plane_label_pixels_plain(depth, alpha, cam, cfg, fit)
        return kernels.per_problem(
            lambda dp, a, *ft: plane_label_pixels_plain(
                dp, a, cam, cfg, PlaneRefit(*ft)), [depth, alpha, *fit])
    p_cap = _check_pixel_args(depth, alpha, fit.normal, fit.d, fit.alive,
                              (fit.mse, fit.mean, fit.n))
    lead = tuple(depth.shape[:-2])
    f = _frames(lead)
    h, w = depth.shape[-2:]
    dev = depth.device
    label_in = None
    if max(1, int(cfg.refine_stride)) == 1:
        kernels.check(fit.label_sub, "label_sub", torch.int32,
                      (*lead, h * w))
        label_in = kernels.ptr(fit.label_sub)
    coeffs = _out((*lead, p_cap, 4), torch.float32, dev)
    valid = _out((*lead, p_cap), torch.bool, dev)
    count = _out((*lead, p_cap), torch.int32, dev)
    pixel_label = _out((*lead, h, w), torch.int32, dev)
    with torch.cuda.device(dev):
        kernels.launch(
            "psl_plane_label_pixels", kernels.ptr(depth), kernels.ptr(alpha),
            h, w, *_pixel_scalars(depth, cam, cfg), p_cap,
            kernels.ptr(fit.normal), kernels.ptr(fit.d),
            kernels.ptr(fit.alive), kernels.ptr(fit.mse),
            kernels.ptr(fit.mean), kernels.ptr(fit.n), int(cfg.min_size), f,
            label_in, kernels.ptr(coeffs), kernels.ptr(valid),
            kernels.ptr(count), kernels.ptr(pixel_label))
    kernels.LAUNCHES["plane_label_pixels"] += 1
    return PlaneFeatures(coeffs=coeffs, centroid=fit.mean, count=count,
                         valid=valid, pixel_label=pixel_label)


@record_function("planes.extract_planes")
def extract_planes(depth: torch.Tensor, cam: CameraConfig,
                   cfg: PlaneConfig) -> PlaneFeatures:
    """Full plane segmentation for one frame (PEAC-equivalent): the noise
    scale, K4's block moments, K12's candidates, 1 + refine_rounds K13
    rounds and K14's labels, with no host sync between them. depth (H, W),
    or F frames (F, H, W) with one launch of each kernel for all of them
    (every output then has the leading F)."""
    h, w = depth.shape[-2:]
    alpha = _noise_alpha(depth, cfg.max_distance)
    stats = plane_block_moments(depth, alpha, cam, _geo_tol(w),
                                cfg.max_distance, cfg.block)
    cand = plane_components(stats, h // cfg.block, w // cfg.block, cfg)
    fit = plane_assign_refit(depth, alpha, cam, cfg, cand.normal, cand.d,
                             cand.valid)
    for _ in range(cfg.refine_rounds):
        fit = plane_assign_refit(depth, alpha, cam, cfg, fit.normal, fit.d,
                                 fit.alive, (fit.mse, fit.mean, fit.n))
    return plane_label_pixels(depth, alpha, cam, cfg, fit)
