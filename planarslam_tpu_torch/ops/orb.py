"""Oriented BRIEF descriptors: intensity-centroid orientation + steered BRIEF.

Port of ``planarslam_tpu/ops/orb.py``. ``orb_describe_levels`` is kernel
K2 (``csrc/orb_describe.cu``): orientation and descriptor of the keypoints
of every level of a frame in one launch, and ``orb_describe`` the same
kernel on one level, as a one-level table; ``orb_describe_plain`` is their
plain PyTorch version (``orientations`` then ``descriptors``). Descriptors are (N, 8) int32 bit
patterns (torch's uint32 lacks bitwise ops); they become uint32 only at the
numpy boundary, with ``.view(np.uint32)``. The comparison pattern is the
JAX package's, rebuilt from the same numpy seed.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from planarslam_tpu_torch import kernels
from planarslam_tpu_torch.ops.consts import const as _const
from planarslam_tpu_torch.ops.levels import FIELDS, LevelTable

HALF_PATCH = 15  # orientation patch radius (reference HALF_PATCH_SIZE)
N_BITS = 256
PATTERN_RADIUS = 12  # pattern coords clipped so rotated samples stay in-patch


def _circular_mask_and_coords() -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    r = HALF_PATCH
    dy, dx = np.mgrid[-r:r + 1, -r:r + 1]
    mask = (dx ** 2 + dy ** 2 <= r * r).astype(np.float32)
    return mask, dx.astype(np.float32), dy.astype(np.float32)


_MASK, _DX, _DY = _circular_mask_and_coords()


def make_brief_pattern(seed: int = 1234) -> np.ndarray:
    """(256, 4) int32 pattern (ax, ay, bx, by), Gaussian sigma = patch/5."""
    rng = np.random.default_rng(seed)
    sigma = 31 / 5.0
    pts = rng.normal(0.0, sigma, (N_BITS, 4))
    pts = np.clip(np.round(pts), -PATTERN_RADIUS, PATTERN_RADIUS)
    for i in range(N_BITS):
        while np.all(pts[i, :2] == pts[i, 2:]):
            pts[i, 2:] = np.clip(np.round(rng.normal(0, sigma, 2)),
                                 -PATTERN_RADIUS, PATTERN_RADIUS)
    return pts.astype(np.int32)


_PATTERN = make_brief_pattern()
_PATTERN_F = _PATTERN.astype(np.float32)


def orientations(img: torch.Tensor, uv: torch.Tensor, valid: torch.Tensor
                 ) -> torch.Tensor:
    """Intensity-centroid angle (radians) per keypoint; invalid -> 0."""
    h, w = img.shape
    size = 2 * HALF_PATCH + 1
    dev = img.device
    y0 = torch.clamp(torch.round(uv[:, 1]).to(torch.int64) - HALF_PATCH, 0,
                     h - size)
    x0 = torch.clamp(torch.round(uv[:, 0]).to(torch.int64) - HALF_PATCH, 0,
                     w - size)
    ar = torch.arange(size, device=dev)
    rows = y0[:, None, None] + ar[None, :, None]
    cols = x0[:, None, None] + ar[None, None, :]
    patch = img.reshape(-1)[rows * w + cols]  # (N, 31, 31)
    dx = _const("orb.dx", _DX, dev)
    dy = _const("orb.dy", _DY, dev)
    mask = _const("orb.mask", _MASK, dev)
    m10 = torch.sum(patch * dx * mask, dim=(1, 2))
    m01 = torch.sum(patch * dy * mask, dim=(1, 2))
    ang = torch.atan2(m01, m10)
    return torch.where(valid, ang, 0.0)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(N, 256) bool -> (N, 8) int32, bit j of word k = bits[:, 32k + j]."""
    n = bits.shape[0]
    b = bits.reshape(n, 8, 32).to(torch.int64)
    weights = torch.bitwise_left_shift(
        torch.ones(32, dtype=torch.int64, device=bits.device),
        torch.arange(32, dtype=torch.int64, device=bits.device))
    words = torch.sum(b * weights, dim=-1)
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    return words.to(torch.int32)


def descriptors(img_blur: torch.Tensor, uv: torch.Tensor, angle: torch.Tensor,
                valid: torch.Tensor) -> torch.Tensor:
    """Steered-BRIEF descriptors, (N, 8) int32 bit patterns."""
    h, w = img_blur.shape
    pat = _const("orb.pattern_f", _PATTERN_F, img_blur.device)
    ca, sa = torch.cos(angle), torch.sin(angle)
    flat = img_blur.reshape(-1)

    def sample(ox, oy):
        rx = ca[:, None] * ox[None] - sa[:, None] * oy[None]
        ry = sa[:, None] * ox[None] + ca[:, None] * oy[None]
        u = torch.clamp(torch.round(uv[:, 0:1] + rx).to(torch.int64), 0, w - 1)
        v = torch.clamp(torch.round(uv[:, 1:2] + ry).to(torch.int64), 0, h - 1)
        return flat[v * w + u]

    ia = sample(pat[:, 0], pat[:, 1])
    ib = sample(pat[:, 2], pat[:, 3])
    return pack_bits(ia < ib) * valid[:, None].to(torch.int32)


def orb_describe_plain(img: torch.Tensor, img_blur: torch.Tensor,
                       uv: torch.Tensor, valid: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K2: (angle (N,) f32, desc (N, 8) int32)."""
    angle = orientations(img, uv, valid)
    return angle, descriptors(img_blur, uv, angle, valid)


def _out(shape, dtype, dev) -> torch.Tensor:
    """K2's output allocator (a check may hand out filled buffers)."""
    return torch.empty(shape, dtype=dtype, device=dev)


def orb_describe(img: torch.Tensor, img_blur: torch.Tensor, uv: torch.Tensor,
                 valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2 wrapper: orientation + steered BRIEF for one pyramid level.

    img, img_blur: (H, W) float32; uv: (N, 2) float32 level coords;
    valid: (N,) bool. Returns (angle (N,) float32, desc (N, 8) int32)."""
    if kernels.on_cpu(img, img_blur, uv, valid):
        return orb_describe_plain(img, img_blur, uv, valid)
    h, w = img.shape
    n = uv.shape[0]
    kernels.check(img, "img", torch.float32)
    kernels.check(img_blur, "img_blur", torch.float32, (h, w))
    kernels.check(uv, "uv", torch.float32, (n, 2))
    kernels.check(valid, "valid", torch.bool, (n,))
    if h < 2 * HALF_PATCH + 1 or w < 2 * HALF_PATCH + 1:
        raise ValueError(f"level {h}x{w} is smaller than the ORB patch")
    angle, desc = orb_describe_levels(
        img.reshape(1, -1), img_blur.reshape(1, -1), uv[None], valid[None],
        _one_level(h, w, n), n)
    return angle[0], desc[0]


@lru_cache(maxsize=64)
def _one_level(h: int, w: int, n: int) -> LevelTable:
    """The table of a lone (h, w) level holding n keypoint slots (only its
    shape and quota matter to K2)."""
    rows = np.zeros((1, len(FIELDS)), np.int32)
    rows[0, [FIELDS.index("h"), FIELDS.index("w"),
             FIELDS.index("quota")]] = h, w, n
    rows.setflags(write=False)
    return LevelTable(ints=rows, scale=np.ones(1, np.float32),
                      shapes=((h, w),), n_pixels=h * w, n_slots=n,
                      n_tiles=0, n_candidates=0, max_tile=0)


def orb_describe_levels_plain(buf: torch.Tensor, blur: torch.Tensor,
                              uv: torch.Tensor, valid: torch.Tensor,
                              table: LevelTable, capacity: int
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the all-levels K2: orb_describe_plain per level,
    concatenated and zero-padded to `capacity` slots."""
    quotas = table.column("quota")
    b = buf.shape[0]
    angle = torch.zeros((b, capacity), dtype=torch.float32, device=buf.device)
    desc = torch.zeros((b, capacity, 8), dtype=torch.int32, device=buf.device)
    for i in range(b):
        s0 = 0
        for l, (h, w) in enumerate(table.shapes):
            q = int(quotas[l])
            if q == 0:
                continue
            sl = table.level_slice(l)
            a, d = orb_describe_plain(
                buf[i, sl].reshape(h, w), blur[i, sl].reshape(h, w),
                uv[i, s0:s0 + q], valid[i, s0:s0 + q])
            angle[i, s0:s0 + q] = a
            desc[i, s0:s0 + q] = d
            s0 += q
    return angle, desc


def orb_describe_levels(buf: torch.Tensor, blur: torch.Tensor,
                        uv: torch.Tensor, valid: torch.Tensor,
                        table: LevelTable, capacity: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2 on the keypoints of every level of a frame in one launch.

    buf, blur: (B, n_pixels) float32 level buffers; uv (B, n_slots, 2)
    float32 level coordinates and valid (B, n_slots) bool, as
    select_keypoints_levels returns them. Returns (angle (B, capacity)
    float32, desc (B, capacity, 8) int32) with the slots past n_slots
    zero."""
    if kernels.on_cpu(buf, blur, uv, valid):
        return orb_describe_levels_plain(buf, blur, uv, valid, table,
                                         capacity)
    b = buf.shape[0]
    kernels.check(buf, "buf", torch.float32, (b, table.n_pixels))
    kernels.check(blur, "blur", torch.float32, (b, table.n_pixels))
    kernels.check(uv, "uv", torch.float32, (b, table.n_slots, 2))
    kernels.check(valid, "valid", torch.bool, (b, table.n_slots))
    if capacity < table.n_slots:
        raise ValueError(f"capacity {capacity} is below the levels' "
                         f"{table.n_slots} slots")
    size = 2 * HALF_PATCH + 1
    for (h, w), q in zip(table.shapes, table.column("quota")):
        if q > 0 and (h < size or w < size):
            raise ValueError(f"level {h}x{w} is smaller than the ORB patch")
    pattern = _const("orb.pattern_i", _PATTERN, buf.device)
    angle = _out((b, capacity), torch.float32, buf.device)
    desc = _out((b, capacity, 8), torch.int32, buf.device)
    with torch.cuda.device(buf.device):
        kernels.launch("psl_orb_describe_levels", kernels.ptr(buf),
                       kernels.ptr(blur), kernels.host_ptr(table.ints),
                       table.n_levels, b, kernels.ptr(uv),
                       kernels.ptr(valid), capacity, kernels.ptr(pattern),
                       kernels.ptr(angle), kernels.ptr(desc))
    kernels.LAUNCHES["orb_describe"] += 1
    return angle, desc


def _unpack_pm1(desc: torch.Tensor) -> torch.Tensor:
    """(N, 8) int32 packed descriptor -> (N, 256) float32 of ±1."""
    shifts = torch.arange(32, dtype=torch.int32, device=desc.device)
    bits = torch.bitwise_and(
        torch.bitwise_right_shift(desc[:, :, None], shifts), 1)
    return bits.reshape(desc.shape[0], N_BITS).to(torch.float32) * 2 - 1


def hamming_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise Hamming distance (M, N) int32 between packed descriptors,
    as the JAX package computes it: dot products of ±1 vectors, exact in
    float32 (|dot| <= 256) with TF32 off."""
    dot = _unpack_pm1(a) @ _unpack_pm1(b).T
    return ((N_BITS - dot) * 0.5).to(torch.int32)
