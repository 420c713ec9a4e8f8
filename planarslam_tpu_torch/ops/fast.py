"""FAST-9/16 corner scores and spatially-uniform keypoint selection.

Port of ``planarslam_tpu/ops/fast.py``. ``fast_score`` is kernel K1
(``csrc/fast_score.cu``) on one level and ``fast_score_levels`` the same
kernel on every level of a frame in one launch; ``fast_score_plain`` is
their plain PyTorch version. ``select_keypoints_levels`` is kernel K18
(``csrc/select_keypoints.cu``): NMS, per-tile top-k and a per-level top-k
for every level in select_launches(table) launches, with ties ordered
lower-index-first as ``lax.top_k`` orders them; ``select_keypoints`` is its
plain version, one level at a time.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from planarslam_tpu_torch import kernels
from planarslam_tpu_torch.ops.image import per_level
from planarslam_tpu_torch.ops.lax_compat import top_k
from planarslam_tpu_torch.ops.levels import LevelTable, tile_budget

# 16-point Bresenham circle of radius 3, in ring order, as (dy, dx).
CIRCLE_OFFSETS = np.array([
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
], dtype=np.int32)

ARC_LEN = 9  # FAST-9


def _shifted(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """img shifted so out[y, x] = img[y + dy, x + dx] (edge-replicated)."""
    h, w = img.shape
    ys = torch.clamp(torch.arange(h, device=img.device) + dy, 0, h - 1)
    xs = torch.clamp(torch.arange(w, device=img.device) + dx, 0, w - 1)
    return img[ys][:, xs]


def fast_score_plain(img: torch.Tensor) -> torch.Tensor:
    """Dense FAST-9/16 corner score map: max over the 16 arc starts of the
    min over the 9 arc members of (ring - centre), for bright and dark."""
    ring = torch.stack([_shifted(img, int(dy), int(dx))
                        for dy, dx in CIRCLE_OFFSETS])
    d = ring - img[None]  # (16, H, W)
    d2 = torch.cat([d, d[:ARC_LEN - 1]], dim=0)

    def arc_reduce(x):
        # running min over windows of ARC_LEN by log2 doubling (exact)
        y = x
        n = 1
        while n * 2 <= ARC_LEN:
            y = torch.minimum(y, torch.roll(y, -n, dims=0))
            n *= 2
        rem = ARC_LEN - n
        if rem > 0:
            y = torch.minimum(y, torch.roll(y, -rem, dims=0))
        return y[:16]

    bright = arc_reduce(d2)
    dark = arc_reduce(-d2)
    score = torch.maximum(bright.amax(dim=0), dark.amax(dim=0))
    return torch.clamp(score, min=0.0)


def fast_score(img: torch.Tensor) -> torch.Tensor:
    """K1 wrapper: (H, W) float32 level -> (H, W) float32 FAST score."""
    if kernels.on_cpu(img):
        return fast_score_plain(img)
    kernels.check(img, "img", torch.float32)
    if img.dim() != 2:
        raise ValueError(f"img: expected (H, W), got {tuple(img.shape)}")
    h, w = img.shape
    out = torch.empty_like(img)
    with torch.cuda.device(img.device):
        kernels.launch("psl_fast_score", kernels.ptr(img), kernels.ptr(out),
                       h, w)
    kernels.LAUNCHES["fast_score"] += 1
    return out


# launches issued by one call of csrc/select_keypoints.cu::
# psl_select_keypoints on a table with tiles: the tiles, then the ranking
SELECT_LAUNCHES = 2
# the shared memory a block of K18's tile stage may opt in to on an H100
SELECT_SMEM_LIMIT = 232448


def select_launches(table: LevelTable) -> int:
    """K18's launches for one call on `table` (its C entry reports what it
    made; this is what a caller expects)."""
    return SELECT_LAUNCHES if table.n_tiles else 0


def _check_buffer(buf: torch.Tensor, name: str, table: LevelTable) -> None:
    kernels.check(buf, name, torch.float32)
    if buf.dim() != 2 or buf.shape[1] != table.n_pixels:
        raise ValueError(f"{name}: expected (B, {table.n_pixels}), got "
                         f"{tuple(buf.shape)}")


def fast_score_levels_plain(buf: torch.Tensor, table: LevelTable
                            ) -> torch.Tensor:
    """Plain version of the all-levels K1: fast_score_plain level by level."""
    return per_level(fast_score_plain, buf, table)


def fast_score_levels(buf: torch.Tensor, table: LevelTable) -> torch.Tensor:
    """K1 on every level of a (B, n_pixels) float32 buffer in one launch:
    the (B, n_pixels) FAST scores, level by level as the buffer is laid
    out."""
    if kernels.on_cpu(buf):
        return fast_score_levels_plain(buf, table)
    _check_buffer(buf, "buf", table)
    out = torch.empty_like(buf)
    with torch.cuda.device(buf.device):
        kernels.launch("psl_fast_score_levels", kernels.ptr(buf),
                       kernels.ptr(out), kernels.host_ptr(table.ints),
                       table.n_levels, buf.shape[0])
    kernels.LAUNCHES["fast_score"] += 1
    return out


def select_keypoints_levels_plain(scores: torch.Tensor, table: LevelTable,
                                  min_score: float, border: int
                                  ) -> Tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """Plain version of K18: select_keypoints on every level with a quota,
    the levels' keypoints one after the other."""
    tiles, quotas = table.column("tile"), table.column("quota")
    uvs, resps, valids = [], [], []
    for b in range(scores.shape[0]):
        per = [select_keypoints(
            scores[b, table.level_slice(l)].reshape(h, w), int(tiles[l]),
            int(quotas[l]), min_score, border)
            for l, (h, w) in enumerate(table.shapes) if quotas[l] > 0]
        uvs.append(torch.cat([p[0] for p in per]))
        resps.append(torch.cat([p[1] for p in per]))
        valids.append(torch.cat([p[2] for p in per]))
    return torch.stack(uvs), torch.stack(resps), torch.stack(valids)


def select_keypoints_levels(scores: torch.Tensor, table: LevelTable,
                            min_score: float, border: int
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """K18 wrapper: the keypoints of every level of (B, n_pixels) FAST
    scores. Returns (uv (B, n_slots, 2) float32 in level coordinates,
    response (B, n_slots) float32, valid (B, n_slots) bool); level l owns
    the slots from the sum of the lower levels' quotas on. Equal to the
    plain version in every slot, the invalid ones too."""
    if kernels.on_cpu(scores):
        return select_keypoints_levels_plain(scores, table, min_score, border)
    _check_buffer(scores, "scores", table)
    t = table.max_tile
    if 4 * ((t + 2) ** 2 + t ** 2) > SELECT_SMEM_LIMIT:
        raise ValueError(f"tile {t} exceeds the shared memory of the "
                         f"kernel's block")
    b, dev = scores.shape[0], scores.device
    cand_val = torch.empty((b, table.n_candidates), dtype=torch.float32,
                           device=dev)
    cand_xy = torch.empty((b, table.n_candidates, 2), dtype=torch.int32,
                          device=dev)
    uv = torch.empty((b, table.n_slots, 2), dtype=torch.float32, device=dev)
    resp = torch.empty((b, table.n_slots), dtype=torch.float32, device=dev)
    valid = torch.empty((b, table.n_slots), dtype=torch.bool, device=dev)
    launches = ctypes.c_int(0)
    with torch.cuda.device(dev):
        kernels.launch("psl_select_keypoints", kernels.ptr(scores),
                       kernels.host_ptr(table.ints), table.n_levels, b,
                       float(min_score), int(border), kernels.ptr(cand_val),
                       kernels.ptr(cand_xy), kernels.ptr(uv),
                       kernels.ptr(resp), kernels.ptr(valid),
                       ctypes.addressof(launches))
    kernels.LAUNCHES["select_keypoints"] += launches.value
    return uv, resp, valid


def select_keypoints(score: torch.Tensor, tile: int, k_total: int,
                     min_score: float, border: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """NMS + per-tile top-k + global top-k. Returns (uv (K,2) f32, response
    (K,), valid (K,) bool) with K = k_total, padded with invalid entries."""
    from planarslam_tpu_torch.ops.image import maxpool_3x3

    h, w = score.shape
    dev = score.device
    yy = torch.arange(h, device=dev)[:, None]
    xx = torch.arange(w, device=dev)[None, :]
    in_border = ((yy >= border) & (yy < h - border)
                 & (xx >= border) & (xx < w - border))
    is_max = score >= maxpool_3x3(score)
    s = torch.where(in_border & is_max & (score > min_score), score, -1.0)

    nth = -(-h // tile)
    ntw = -(-w // tile)
    sp = torch.nn.functional.pad(s, (0, ntw * tile - w, 0, nth * tile - h),
                                 value=-1.0)
    tiles = sp.reshape(nth, tile, ntw, tile).permute(0, 2, 1, 3)
    tiles = tiles.reshape(nth * ntw, tile * tile)

    _, n_tiles, k_tile = tile_budget(h, w, tile, k_total)
    if k_tile <= 4:
        cols = torch.arange(tile * tile, device=dev)[None, :]
        vs, is_ = [], []
        t_cur = tiles
        for _ in range(k_tile):
            i_b = torch.argmax(t_cur, dim=1)
            vs.append(torch.gather(t_cur, 1, i_b[:, None])[:, 0])
            is_.append(i_b)
            t_cur = torch.where(cols == i_b[:, None], -1.0, t_cur)
        vals = torch.stack(vs, dim=1)
        idx = torch.stack(is_, dim=1)
    else:
        vals, idx = top_k(tiles, k_tile)

    tid = torch.arange(n_tiles, device=dev)[:, None]
    py = (tid // ntw) * tile + idx // tile
    px = (tid % ntw) * tile + idx % tile

    top_vals, top_i = top_k(vals.reshape(-1), k_total)
    uv = torch.stack([px.reshape(-1)[top_i].to(torch.float32),
                      py.reshape(-1)[top_i].to(torch.float32)], dim=-1)
    valid = top_vals > 0.0
    return uv, torch.clamp(top_vals, min=0.0), valid
