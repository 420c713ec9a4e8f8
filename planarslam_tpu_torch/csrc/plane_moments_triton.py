"""K4 plane_block_moments — Triton kernel (loaded from this file at launch).

Replaces planarslam_tpu/ops/planes.py::extract_planes:223-264 up to the
block fit: ``backproject_depth`` (:45), the depth-range and depth-jump gate
(:224, :243-262; the noise scale ``alpha`` comes from a plain-torch
nanmedian beforehand and arrives here as a one-element device tensor, so
no host sync is needed) and ``_block_moments`` (:196-207): per 8x8 block,
the sum of valid back-projected points (s1), of their outer products (s2)
and the valid count (n).

One program owns a strip of NB consecutive blocks of one block row of one
frame (grid axis 2 is the frame of a batch of B depth maps, every array
with a leading B: one launch serves them all). Its
tile is (block*block, NB): axis 0 walks the pixels of a block, axis 1 the
blocks, so ``tl.sum(axis=0)`` yields the strip's per-block moments
directly. Each pixel loads its right and lower neighbour (roll semantics:
the last column/row compares against nothing) for the jump gate.

What bounds it on an H100: device memory. It reads the depth map ~3 times
(the two neighbour loads mostly hit L1/L2) and writes 13 floats per block:
~1.3 MB for a 640x480 frame, about a microsecond of HBM time, so launch
latency dominates at this size. Nothing is reused across blocks, which is
why a fused elementwise-plus-reduction Triton program expresses it fully.
"""

import triton
import triton.language as tl


@triton.jit
def _plane_block_moments_kernel(depth_ptr, coef_ptr, s1_ptr, s2_ptr, n_ptr,
                                H, W, WB, fx, fy, cx, cy, max_dist, geo_tol,
                                BLOCK: tl.constexpr, NB: tl.constexpr):
    by = tl.program_id(0)
    bc = tl.program_id(1)
    f = tl.program_id(2).to(tl.int64)               # frame of the batch
    HB = H // BLOCK
    depth_ptr += f * H * W
    coef_ptr += f
    s1_ptr += f * HB * WB * 3
    s2_ptr += f * HB * WB * 9
    n_ptr += f * HB * WB
    p = tl.arange(0, BLOCK * BLOCK)[:, None]      # pixel within a block
    b = bc * NB + tl.arange(0, NB)[None, :]        # block column
    yy = by * BLOCK + p // BLOCK
    xx = b * BLOCK + p % BLOCK
    inb = (b < WB) & (yy < H)
    d = tl.load(depth_ptr + yy * W + xx, mask=inb, other=0.0)
    xr = tl.where(xx + 1 < W, xx + 1, 0)
    yd = tl.where(yy + 1 < H, yy + 1, 0)
    d_r = tl.load(depth_ptr + yy * W + xr, mask=inb, other=0.0)
    d_d = tl.load(depth_ptr + yd * W + xx, mask=inb, other=0.0)
    jump_r = tl.where(xx == W - 1, 0.0, tl.abs(d - d_r))
    jump_d = tl.where(yy == H - 1, 0.0, tl.abs(d - d_d))
    coef = tl.load(coef_ptr)                        # 3 sqrt(2) alpha
    dm = tl.maximum(d, 1.0)
    z2 = dm * dm
    tol = tl.maximum(geo_tol * dm, coef * z2)
    ok = (inb & (d > 1e-6) & (d < max_dist) & (jump_r < tol)
          & (jump_d < tol))
    v = tl.where(ok, 1.0, 0.0)
    px = (xx.to(tl.float32) - cx) / fx * d * v
    py = (yy.to(tl.float32) - cy) / fy * d * v
    pz = d * v
    blk = by * WB + b
    out = b < WB
    bflat = tl.reshape(blk, (NB,))
    oflat = tl.reshape(out, (NB,))
    tl.store(s1_ptr + bflat * 3 + 0, tl.reshape(tl.sum(px, axis=0), (NB,)), mask=oflat)
    tl.store(s1_ptr + bflat * 3 + 1, tl.reshape(tl.sum(py, axis=0), (NB,)), mask=oflat)
    tl.store(s1_ptr + bflat * 3 + 2, tl.reshape(tl.sum(pz, axis=0), (NB,)), mask=oflat)
    sxx = tl.reshape(tl.sum(px * px, axis=0), (NB,))
    sxy = tl.reshape(tl.sum(px * py, axis=0), (NB,))
    sxz = tl.reshape(tl.sum(px * pz, axis=0), (NB,))
    syy = tl.reshape(tl.sum(py * py, axis=0), (NB,))
    syz = tl.reshape(tl.sum(py * pz, axis=0), (NB,))
    szz = tl.reshape(tl.sum(pz * pz, axis=0), (NB,))
    base = s2_ptr + bflat * 9
    tl.store(base + 0, sxx, mask=oflat)
    tl.store(base + 1, sxy, mask=oflat)
    tl.store(base + 2, sxz, mask=oflat)
    tl.store(base + 3, sxy, mask=oflat)
    tl.store(base + 4, syy, mask=oflat)
    tl.store(base + 5, syz, mask=oflat)
    tl.store(base + 6, sxz, mask=oflat)
    tl.store(base + 7, syz, mask=oflat)
    tl.store(base + 8, szz, mask=oflat)
    tl.store(n_ptr + bflat, tl.reshape(tl.sum(v, axis=0), (NB,)), mask=oflat)


def launch(depth, coef, s1, s2, n, frames, h, w, fx, fy, cx, cy, max_dist,
           geo_tol, block):
    """Launch on the current stream: `frames` depth maps (H, W) one after
    another, coef (frames,), outputs preallocated (frames, nb, 3) /
    (frames, nb, 3, 3) / (frames, nb) for nb blocks."""
    hb, wb = h // block, w // block
    nb = 16
    grid = (hb, triton.cdiv(wb, nb), frames)
    _plane_block_moments_kernel[grid](
        depth, coef, s1, s2, n, h, w, wb, fx, fy, cx, cy, max_dist, geo_tol,
        BLOCK=block, NB=nb, num_warps=4)
