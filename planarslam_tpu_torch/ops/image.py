"""Dense image ops: pyramid, separable Gaussian blur, resize, gradients.

Port of ``planarslam_tpu/ops/image.py``. Images are float32 (H, W) in
[0, 255]. The filters are shift-and-add loops in the JAX module's order, so
the float sums round identically.

``build_pyramid_levels`` is kernel K16 (``csrc/pyramid.cu``,
``pyramid_resize``) and ``gaussian_blur_levels`` kernel K17
(``gaussian_blur``): both work on the (B, n_pixels) buffer that holds all
levels of a frame (``ops/levels.py``); ``build_pyramid`` and ``blur`` are
their plain versions, one level at a time.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import List, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from planarslam_tpu_torch import kernels
from planarslam_tpu_torch.ops.consts import const
from planarslam_tpu_torch.ops.levels import (LevelTable, pyramid_shapes,
                                             single_level)

MAX_BLUR_TAPS = 7  # csrc/pyramid.cu::kBlurMaxTaps


def gaussian_kernel_1d(ksize: int, sigma: float) -> np.ndarray:
    r = (ksize - 1) / 2.0
    x = np.arange(ksize) - r
    k = np.exp(-(x ** 2) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def _pad_edge(x: torch.Tensor, pad: int, dim: int) -> torch.Tensor:
    n = x.shape[dim]
    first = x.narrow(dim, 0, 1)
    last = x.narrow(dim, n - 1, 1)
    reps = [1, 1]
    reps[dim] = pad
    return torch.cat([first.repeat(*reps), x, last.repeat(*reps)], dim=dim)


def blur(img: torch.Tensor, ksize: int = 7, sigma: float = 2.0) -> torch.Tensor:
    """Separable Gaussian blur with replicate borders."""
    k = gaussian_kernel_1d(ksize, sigma)
    pad = ksize // 2
    h, w = img.shape
    x = _pad_edge(img, pad, 0)
    acc = torch.zeros_like(img)
    for i in range(ksize):
        acc = acc + float(k[i]) * x[i:i + h]
    x = _pad_edge(acc, pad, 1)
    acc = torch.zeros_like(img)
    for i in range(ksize):
        acc = acc + float(k[i]) * x[:, i:i + w]
    return acc


@lru_cache(maxsize=64)
def _resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """(in, out) antialiased triangle-filter weights, computed in float32
    exactly as ``jax.image.resize(..., "bilinear")`` builds them
    (scale-and-translate with the kernel widened by 1/scale when
    downsampling, column-normalized, out-of-range samples zeroed)."""
    f32 = np.float32
    scale = out_size / in_size
    inv_scale = 1.0 / scale
    kernel_scale = f32(max(inv_scale, 1.0))
    sample_f = ((np.arange(out_size, dtype=f32) + f32(0.5)) * f32(inv_scale)
                - f32(0.0) - f32(0.5)).astype(f32)
    x = (np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None])
         / kernel_scale).astype(f32)
    weights = np.maximum(f32(0.0), f32(1.0) - np.abs(x)).astype(f32)
    total = np.sum(weights, axis=0, keepdims=True, dtype=f32)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    weights = np.where(np.abs(total) > eps,
                       weights / np.where(total != 0, total, f32(1.0)),
                       f32(0.0)).astype(f32)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], weights, f32(0.0)).astype(f32)


def resize_bilinear(img: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Antialiased bilinear resize matching ``jax.image.resize``: the same
    per-axis weight matrices applied as two float32 products (rows first,
    as JAX's einsum contracts the shorter axis first)."""
    h, w = img.shape
    oh, ow = out_hw
    out = img
    if oh != h:
        wh = const(("resize_weights", h, oh),
                   lambda: _resize_weights(h, oh), img.device)
        out = wh.T @ out
    if ow != w:
        ww = const(("resize_weights", w, ow),
                   lambda: _resize_weights(w, ow), img.device)
        out = out @ ww
    return out


MAX_RESIZE_TAPS = 3  # csrc/pyramid.cu::kMaxTaps


@lru_cache(maxsize=64)
def resize_taps(in_size: int, out_size: int) -> np.ndarray:
    """The non-zero taps of ``_resize_weights(in_size, out_size)`` as K16
    reads them: (out_size, 5) int32 rows [first input index, tap count, and
    the bits of 3 float32 weights], the taps of an output contiguous from
    its first input. Scattered back they give the dense matrix exactly."""
    wts = _resize_weights(in_size, out_size)
    taps = np.zeros((out_size, 2 + MAX_RESIZE_TAPS), np.int32)
    for o in range(out_size):
        nz = np.flatnonzero(wts[:, o])
        if len(nz) == 0:
            continue
        first, count = int(nz[0]), int(nz[-1] - nz[0] + 1)
        if count > MAX_RESIZE_TAPS:
            raise ValueError(f"resize {in_size} -> {out_size}: output {o} has "
                             f"{count} taps, the kernel takes "
                             f"{MAX_RESIZE_TAPS}")
        taps[o, 0], taps[o, 1] = first, count
        taps[o, 2:2 + count] = wts[first:first + count, o].view(np.int32)
    return taps


def taps_to_dense(taps: np.ndarray, in_size: int) -> np.ndarray:
    """The (in_size, out) float32 weight matrix a tap table stands for."""
    out = np.zeros((in_size, taps.shape[0]), np.float32)
    wts = np.ascontiguousarray(taps[:, 2:]).view(np.float32)
    for o, (first, count) in enumerate(taps[:, :2]):
        out[first:first + count, o] = wts[o, :count]
    return out


def build_pyramid(img: torch.Tensor, n_levels: int,
                  scale_factor: float) -> List[torch.Tensor]:
    """Scale pyramid; level 0 is the input; each level resized from the
    previous one."""
    h, w = img.shape
    shapes = pyramid_shapes(h, w, n_levels, scale_factor)
    levels = [img]
    for l in range(1, n_levels):
        levels.append(resize_bilinear(levels[-1], shapes[l]))
    return levels


def build_pyramid_levels_plain(gray: torch.Tensor, table: LevelTable,
                               scale_factor: float) -> torch.Tensor:
    """Plain version of K16: (B, H, W) frames -> the (B, n_pixels) buffer of
    all levels, each frame through build_pyramid."""
    return torch.stack([
        torch.cat([lv.reshape(-1) for lv in
                   build_pyramid(g, table.n_levels, scale_factor)])
        for g in gray])


PYRAMID_CONE = 16  # csrc/pyramid.cu's cones: a 16 x 16 tile of the last level


def _cone_ranges(shapes, axis: int) -> np.ndarray:
    """(n, nt, 4) int32 per level and top tile index along one axis (0:
    rows, 1: columns): the cone's range [lo, hi) of that level, the inputs
    its outputs above depend on and the part it owns, and the owned range
    [own_lo, own_hi), the level's share of that top tile (the top tiles
    scaled down, a partition of the level)."""
    n = len(shapes)
    top = shapes[-1][axis]
    nt = -(-top // PYRAMID_CONE)
    out = np.zeros((n, nt, 4), np.int32)
    for k in range(nt):
        a, b = k * PYRAMID_CONE, min((k + 1) * PYRAMID_CONE, top)
        out[n - 1, k] = a, b, a, b
        for l in range(n - 2, -1, -1):
            size = shapes[l][axis]
            own = [0 if k == 0 else min(size, round(k * PYRAMID_CONE * size
                                                    / top)),
                   size if k + 1 == nt else min(
                       size, round((k + 1) * PYRAMID_CONE * size / top))]
            lo, hi = own
            taps = resize_taps(size, shapes[l + 1][axis])[a:b]
            taps = taps[taps[:, 1] > 0]
            if len(taps):
                lo = min(lo, int(taps[:, 0].min()))
                hi = max(hi, int((taps[:, 0] + taps[:, 1]).max()))
            out[l, k] = lo, hi, own[0], own[1]
            a, b = lo, hi
    return out


CONE_MAX = 64  # csrc/pyramid.cu::kConeMax: cones along a side of the top
CONE_LEVEL_WORDS = 10  # a level's header in a cone's chunk


class PyramidCones(NamedTuple):
    """What K16's launch reads of a pyramid's cones (pyramid_cones)."""

    ranges: np.ndarray   # (2, n, nt, 4) int32: _cone_ranges, rows then cols
    chunks: np.ndarray   # (cones, words) int32: each cone's chunk
    header_words: int    # the levels' headers at the front of a chunk
    rows: int            # cones along the top level's rows, and columns
    cols: int
    level0: np.ndarray   # (4, CONE_MAX) int32: level 0's row ranges by cone
                         # row, then its column ranges by cone column
    buf_floats: int      # the most floats of a cone's level
    mid_floats: int      # the most floats of its row taps' sums


@lru_cache(maxsize=16)
def pyramid_cones(shapes: Tuple[Tuple[int, int], ...]) -> PyramidCones:
    """K16's cones over a pyramid. A cone's chunk holds, per level, its
    row range, owned rows, column range, owned columns, the level's offset
    in the buffer and its width (CONE_LEVEL_WORDS words), then for levels
    1.. the row taps of its rows and the column taps of its columns
    (resize_taps' rows), padded to a multiple of 4 words. Level 0's columns
    are counted widened to multiples of 4 in buf_floats and mid_floats, as
    the kernel stages them when the frame's rows allow 16-byte copies."""
    n = len(shapes)
    ry, rx = _cone_ranges(shapes, 0), _cone_ranges(shapes, 1)
    nt = max(ry.shape[1], rx.shape[1])
    ranges = np.zeros((2, n, nt, 4), np.int32)
    ranges[0, :, :ry.shape[1]] = ry
    ranges[1, :, :rx.shape[1]] = rx
    offsets = np.cumsum([0] + [h * w for h, w in shapes[:-1]])
    header = -(-n * CONE_LEVEL_WORDS // 4) * 4
    taps = [(resize_taps(shapes[l - 1][0], shapes[l][0]),
             resize_taps(shapes[l - 1][1], shapes[l][1])) for l in range(1, n)]
    chunks = []
    for ty in range(ry.shape[1]):
        for tx in range(rx.shape[1]):
            head = np.zeros(header, np.int32)
            body = []
            for l in range(n):
                head[CONE_LEVEL_WORDS * l:CONE_LEVEL_WORDS * (l + 1)] = (
                    *ry[l, ty], *rx[l, tx], offsets[l], shapes[l][1])
                if l:
                    body += [taps[l - 1][0][ry[l, ty, 0]:ry[l, ty, 1]],
                             taps[l - 1][1][rx[l, tx, 0]:rx[l, tx, 1]]]
            chunks.append(np.concatenate([head] + [t.reshape(-1)
                                                   for t in body]))
    words = -(-max(len(c) for c in chunks) // 4) * 4
    level0 = np.zeros((4, CONE_MAX), np.int32)
    if max(ry.shape[1], rx.shape[1]) <= CONE_MAX:
        level0[0:2, :ry.shape[1]] = ry[0, :, :2].T
        level0[2:4, :rx.shape[1]] = rx[0, :, :2].T
    hy = ry[:, :, 1] - ry[:, :, 0]
    hx = rx[:, :, 1] - rx[:, :, 0]
    hx[0] = -(-rx[0, :, 1] // 4) * 4 - rx[0, :, 0] // 4 * 4
    return PyramidCones(
        ranges, np.stack([np.pad(c, (0, words - len(c))) for c in chunks]),
        header, ry.shape[1], rx.shape[1], level0,
        int((hy[:, :, None] * hx[:, None, :]).max()),
        int((hy[1:, :, None] * hx[:-1, None, :]).max()) if n > 1 else 0)


# K16's launches for one call, as its C entry reports them (what a caller
# expects; the wrapper counts what the entry reports)
PYRAMID_LAUNCHES = 1


def build_pyramid_levels(gray: torch.Tensor, table: LevelTable,
                         scale_factor: float) -> torch.Tensor:
    """K16 wrapper: (B, H, W) float32 frames -> the (B, n_pixels) float32
    buffer holding every pyramid level of each frame. One launch: a block
    per cone (a 16 x 16 tile of the last level and what it depends on
    below, pyramid_cones) builds every level of it in shared memory and
    writes the outputs it owns, level 0 (the frame) included."""
    if kernels.on_cpu(gray):
        return build_pyramid_levels_plain(gray, table, scale_factor)
    kernels.check(gray, "gray", torch.float32)
    if gray.dim() != 3 or tuple(gray.shape[1:]) != table.shapes[0]:
        raise ValueError(f"gray: expected (B, {table.shapes[0][0]}, "
                         f"{table.shapes[0][1]}), got {tuple(gray.shape)}")
    if table.shapes != tuple(pyramid_shapes(*table.shapes[0], table.n_levels,
                                            scale_factor)):
        raise ValueError("the level table was built for another scale factor")
    b = gray.shape[0]
    buf = torch.empty((b, table.n_pixels), dtype=torch.float32,
                      device=gray.device)
    cones = pyramid_cones(table.shapes)
    if max(cones.rows, cones.cols) > CONE_MAX:
        raise ValueError(f"pyramid_resize: {cones.rows} x {cones.cols} "
                         f"cones, the kernel takes {CONE_MAX} a side")
    chunks = const(("pyramid_cones", table.shapes), lambda: cones.chunks,
                   gray.device)
    launches = ctypes.c_int(0)
    with torch.cuda.device(gray.device):
        try:
            kernels.launch("psl_pyramid_build", kernels.ptr(gray),
                           gray.stride(0), kernels.ptr(buf),
                           kernels.host_ptr(table.ints), table.n_levels, b,
                           kernels.ptr(chunks), cones.chunks.shape[1],
                           cones.header_words, cones.rows, cones.cols,
                           kernels.host_ptr(cones.level0), cones.buf_floats,
                           cones.mid_floats, ctypes.addressof(launches))
        finally:
            kernels.LAUNCHES["pyramid_resize"] += launches.value
    return buf


def per_level(fn, buf: torch.Tensor, table: LevelTable) -> torch.Tensor:
    """fn on every level of every frame of a (B, n_pixels) buffer: how the
    plain versions of the all-levels kernels run."""
    out = torch.empty_like(buf)
    for l, (h, w) in enumerate(table.shapes):
        sl = table.level_slice(l)
        for b in range(buf.shape[0]):
            out[b, sl] = fn(buf[b, sl].reshape(h, w)).reshape(-1)
    return out


def gaussian_blur_levels_plain(buf: torch.Tensor, table: LevelTable,
                               ksize: int = 7, sigma: float = 2.0
                               ) -> torch.Tensor:
    """Plain version of K17: blur of every level of a (B, n_pixels) buffer."""
    return per_level(lambda img: blur(img, ksize, sigma), buf, table)


def gaussian_blur_levels(buf: torch.Tensor, table: LevelTable, ksize: int = 7,
                         sigma: float = 2.0) -> torch.Tensor:
    """K17 wrapper: separable Gaussian blur (replicate borders) of every
    level of a (B, n_pixels) float32 buffer in one launch, with the bits of
    the plain version."""
    if kernels.on_cpu(buf):
        return gaussian_blur_levels_plain(buf, table, ksize, sigma)
    kernels.check(buf, "buf", torch.float32)
    if buf.dim() != 2 or buf.shape[1] != table.n_pixels:
        raise ValueError(f"buf: expected (B, {table.n_pixels}), got "
                         f"{tuple(buf.shape)}")
    if ksize % 2 != 1 or not 1 <= ksize <= MAX_BLUR_TAPS:
        raise ValueError(f"ksize {ksize}: the kernel takes an odd number of "
                         f"taps up to {MAX_BLUR_TAPS}")
    taps = [float(k) for k in gaussian_kernel_1d(ksize, sigma)]
    taps += [0.0] * (MAX_BLUR_TAPS - ksize)
    out = torch.empty_like(buf)
    with torch.cuda.device(buf.device):
        kernels.launch("psl_gaussian_blur", kernels.ptr(buf),
                       kernels.ptr(out), kernels.host_ptr(table.ints),
                       table.n_levels, buf.shape[0], ksize, *taps)
    kernels.LAUNCHES["gaussian_blur"] += 1
    return out


def gaussian_blur(img: torch.Tensor, ksize: int = 7, sigma: float = 2.0
                  ) -> torch.Tensor:
    """K17 on one (H, W) image, or on B images (B, H, W) in one launch (a
    one-level buffer each); `blur` on the CPU."""
    if kernels.on_cpu(img):
        if img.dim() == 3:
            return torch.stack([blur(x, ksize, sigma) for x in img])
        return blur(img, ksize, sigma)
    h, w = img.shape[-2:]
    frames = img.reshape(-1, h * w)
    return gaussian_blur_levels(frames, single_level(h, w), ksize,
                                sigma).reshape(img.shape)


def sobel_gradients(img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """3x3 Sobel dx, dy with replicate borders (separable shift-and-add)."""

    def axis_filter(x, taps, dim):
        xp = _pad_edge(x, 1, dim)
        n = x.shape[dim]
        acc = torch.zeros_like(x)
        for i, t in enumerate(taps):
            if t != 0.0:
                acc = acc + t * xp.narrow(dim, i, n)
        return acc

    smooth_y = axis_filter(img, (1.0, 2.0, 1.0), 0)
    gx = axis_filter(smooth_y, (-1.0, 0.0, 1.0), 1)
    smooth_x = axis_filter(img, (1.0, 2.0, 1.0), 1)
    gy = axis_filter(smooth_x, (-1.0, 0.0, 1.0), 0)
    return gx, gy


def maxpool_3x3(x: torch.Tensor) -> torch.Tensor:
    """3x3 max filter (same shape), -inf outside the image."""
    return F.max_pool2d(x[None, None], 3, stride=1, padding=1)[0, 0]


def bilinear_sample(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Sample (H, W) image at float (..., 2) = (u=x, v=y) with clamping."""
    h, w = img.shape
    u = torch.clamp(uv[..., 0], 0.0, w - 1.001)
    v = torch.clamp(uv[..., 1], 0.0, h - 1.001)
    u0 = torch.floor(u).to(torch.int64)
    v0 = torch.floor(v).to(torch.int64)
    au = u - u0
    av = v - v0
    flat = img.reshape(-1)

    def at(vv, uu):
        return flat[vv * w + uu]

    return ((1 - au) * (1 - av) * at(v0, u0) + au * (1 - av) * at(v0, u0 + 1)
            + (1 - au) * av * at(v0 + 1, u0) + au * av * at(v0 + 1, u0 + 1))


def nearest_sample(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    h, w = img.shape
    u = torch.clamp(torch.round(uv[..., 0]).to(torch.int64), 0, w - 1)
    v = torch.clamp(torch.round(uv[..., 1]).to(torch.int64), 0, h - 1)
    return img.reshape(-1)[v * w + u]
