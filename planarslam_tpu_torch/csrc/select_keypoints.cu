// K18 select_keypoints and K19 point_epilogue — from FAST scores to the
// frame's fixed-capacity keypoint block, all pyramid levels per launch.
//
// K18 replaces planarslam_tpu/ops/fast.py::select_keypoints: 3x3 non-maximum
// suppression, the border and threshold gate, the k_tile best of every
// tile, and the `quota` best of a level's candidates. The JAX version pads
// and reshapes the gated map into tiles, takes k_tile arg-max passes (or a
// per-tile sort above 4) and one sort per level. Two launches:
//   tiles: one warp per tile, kTileWarps tiles of one level a block (fewer
//     where a tile's shared memory is large), the grid from the host's
//     level table. A warp stages its tile and a 1-pixel halo by
//     asynchronous 4-byte copies (level offsets are not 16-byte aligned;
//     -inf outside the level, which no comparison admits; the bounds are
//     tested only in tiles at the level's edge), then a lane walks down a
//     column with the 3x3 window's row maxima in registers, three shared
//     loads a cell (outside the image or the border: -1, as the padding
//     is). It takes k_tile maxima by warp arg-max over shuffles, ties to
//     the lower in-tile index, with no block barrier; the passes after
//     the first rescan the gated cells, kept in shared memory where
//     k_tile > 1. A maximum taken becomes -1 where the JAX version masks
//     it so (k_tile <= 4, so a tile that runs dry yields its cell 0
//     again), and leaves the ranking where the JAX version sorts
//     (k_tile > 4, a dry tile then yields its -1 cells in index order):
//     the candidates of invalid slots come out as the JAX version's do.
//   rank: a block takes 32 candidates of a level, one a lane, and stages
//     the level's candidates in shared memory; each of its kRankSlices
//     warps counts over one slice of them, every lane reading the same
//     word at each step (a broadcast), so that no thread runs a chain of
//     n steps. The rank of a candidate is the number of candidates with a
//     greater value, or an equal value and a lower index in the (tile,
//     pass) order; a rank below the quota is the slot. That is the stable
//     descending sort, without a sort and without atomics, so two launches
//     give the same bits.
// Bound: bytes (the score maps read once, 3.8 MB for the eight levels of
// 640x480); the gate, the arg-max passes and the n^2 rank comparisons
// (n <= 600 at the default configuration) are latency at these sizes; the
// staging of all tiles at once is bound by the L2's rate. The rank stays a
// launch of its own: a level's tiles are 300-336 warps, more than one
// block or cluster holds, and a last-block ticket would rank 600
// candidates in one block.
//
// K19 replaces the tail of planarslam_tpu/ops/frontend.py::
// extract_point_features: level coordinates times float32(scale ^ level),
// responses zeroed where invalid, the level index, zero padding up to the
// capacity, undistortion (5 fixed-point steps of the radial-tangential
// model), the nearest depth at the detected coordinates (round half to
// even), and the pseudo-stereo right coordinate. One thread per slot.
// Bound: latency (1024 slots, ~200 operations and one gather each).
#include <cuda_pipeline.h>

#include <algorithm>

#include "common.cuh"
#include "levels.cuh"

namespace {

constexpr int kTileWarps = 4;      // most tiles a block takes
constexpr int kRankSlices = 16;    // warps of a rank block
constexpr int kRankThreads = 32 * kRankSlices;
constexpr int kRankChunk = 4096;   // candidates of a level staged at once
constexpr int kSmemDefault = 48 * 1024;

struct Best {
  float v;
  int i;
};

// The greater value, ties to the lower index.
__device__ __forceinline__ Best better(Best a, Best b) {
  return (b.v > a.v || (b.v == a.v && b.i < a.i)) ? b : a;
}

// Shared floats of one warp's tile: the staged tile with its halo, then
// the gated cells.
__host__ __device__ __forceinline__ int tile_floats(int tile) {
  return (tile + 2) * (tile + 2) + tile * tile;
}

__global__ void __launch_bounds__(32 * kTileWarps)
    select_tiles_kernel(const float* __restrict__ score, const PslLevels lv,
                        float min_score, int border, int tiles_per_block,
                        float* __restrict__ cand_val,
                        int* __restrict__ cand_xy) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int l = psl_level_of(lv.blk_off, lv.n, blockIdx.x);
  const int t = (blockIdx.x - lv.blk_off[l]) * tiles_per_block + warp;
  if (t >= lv.tile_off[l + 1] - lv.tile_off[l]) return;  // no block barrier
  const int tile = lv.tile[l];
  const int h = lv.h[l], w = lv.w[l], k_tile = lv.k_tile[l];
  const int sw = tile + 2;  // staged side
  const int n_cells = tile * tile;
  float* st = smem + warp * tile_floats(tile);
  float* cell = st + sw * sw;
  const int y0 = (t / lv.ntw[l]) * tile;
  const int x0 = (t % lv.ntw[l]) * tile;
  const float* s = score + static_cast<size_t>(blockIdx.y) * lv.n_pixels +
                   lv.off[l];
  // staging: the tile and its 1-pixel halo in row-major order, the lanes
  // on consecutive cells; -inf outside the level, whose tests only the
  // tiles at its edges need
  {
    int r = lane / sw, c = lane % sw;
    if (y0 >= 1 && y0 + tile < h && x0 >= 1 && x0 + tile < w) {
      const float* src = s + (y0 - 1 + r) * w + (x0 - 1 + c);
      for (int i = lane; i < sw * sw; i += 32) {
        __pipeline_memcpy_async(st + i, src, sizeof(float));
        src += 32;
        for (c += 32; c >= sw; c -= sw) src += w - sw;
      }
    } else {
      for (int i = lane; i < sw * sw; i += 32) {
        const int y = y0 - 1 + r, x = x0 - 1 + c;
        if (y >= 0 && y < h && x >= 0 && x < w) {
          __pipeline_memcpy_async(st + i, s + y * w + x, sizeof(float));
        } else {
          st[i] = -INFINITY;
        }
        for (c += 32; c >= sw; c -= sw) ++r;
      }
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncwarp();
  }
  // NMS and gate: a lane walks down a column of the tile with the 3x3
  // window's row maxima in registers; a cell keeps its score inside the
  // border when it exceeds min_score and no cell of the window (its own
  // included, -inf outside the level) exceeds it, else -1; the best gated
  // cell of this lane is pass 0's (down a column the index grows: a
  // strictly greater value takes the lead)
  Best b = {-INFINITY, INT_MAX};
  const int ty_lo = max(0, border - y0);      // rows inside the border
  const int ty_hi = min(tile, h - border - y0);
  for (int tx = lane; tx < tile; tx += 32) {
    const float* col = st + tx;  // staged columns tx, tx + 1 (the cell's), tx + 2
    const bool col_in = x0 + tx >= border && x0 + tx < w - border;
    float up = fmaxf(fmaxf(col[0], col[1]), col[2]);
    float mid = fmaxf(fmaxf(col[sw], col[sw + 1]), col[sw + 2]);
    float sc = col[sw + 1];
    Best bc = {-INFINITY, INT_MAX};
#pragma unroll 4
    for (int ty = 0; ty < tile; ++ty) {
      const float* q = col + (ty + 2) * sw;
      const float down_sc = q[1];
      const float down = fmaxf(fmaxf(q[0], down_sc), q[2]);
      const bool keep = col_in && ty >= ty_lo && ty < ty_hi &&
                        sc > min_score && !(fmaxf(fmaxf(up, mid), down) > sc);
      const float v = keep ? sc : -1.0f;
      const int i = ty * tile + tx;
      if (k_tile > 1) cell[i] = v;  // the later passes' cells
      if (v > bc.v) bc = Best{v, i};
      up = mid;
      mid = down;
      sc = down_sc;
    }
    b = better(b, bc);
  }
  // passes: the tile's best by shuffles, ties to the lower index; the
  // JAX version masks a taken maximum with -1 (arg-max passes) or leaves
  // it behind in a sort: below every -1 here
  const float taken = k_tile <= 4 ? -1.0f : -2.0f;
  const size_t out0 = static_cast<size_t>(blockIdx.y) * lv.cand_off[lv.n] +
                      lv.cand_off[l] + static_cast<size_t>(t) * k_tile;
  for (int pass = 0; pass < k_tile; ++pass) {
    if (pass > 0) {
      b = Best{-INFINITY, INT_MAX};
      for (int tx = lane; tx < tile; tx += 32) {
        Best bc = {-INFINITY, INT_MAX};
#pragma unroll 4
        for (int i = tx; i < n_cells; i += tile) {
          const float v = cell[i];
          if (v > bc.v) bc = Best{v, i};
        }
        b = better(b, bc);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      Best o;
      o.v = __shfl_xor_sync(0xffffffffu, b.v, off);
      o.i = __shfl_xor_sync(0xffffffffu, b.i, off);
      b = better(b, o);
    }
    if (lane == 0) {
      cand_val[out0 + pass] = b.v;
      cand_xy[2 * (out0 + pass)] = x0 + b.i % tile;
      cand_xy[2 * (out0 + pass) + 1] = y0 + b.i / tile;
    }
    if (pass + 1 == k_tile) break;
    if (lane == 0) cell[b.i] = taken;
    __syncwarp();
  }
}

__global__ void __launch_bounds__(kRankThreads)
    select_rank_kernel(const float* __restrict__ cand_val,
                       const int* __restrict__ cand_xy, const PslLevels lv,
                       float* __restrict__ uv, float* __restrict__ response,
                       unsigned char* __restrict__ valid) {
  __shared__ float vals[kRankChunk];
  __shared__ int part[kRankSlices][32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int l = psl_level_of(lv.blk_off, lv.n, blockIdx.x);
  const int n = lv.cand_off[l + 1] - lv.cand_off[l];
  const int quota = lv.slot_off[l + 1] - lv.slot_off[l];
  const size_t c0 = static_cast<size_t>(blockIdx.y) * lv.cand_off[lv.n] +
                    lv.cand_off[l];
  const size_t s0 = static_cast<size_t>(blockIdx.y) * lv.slot_off[lv.n] +
                    lv.slot_off[l];
  const float* v = cand_val + c0;
  // rank stage: this lane's candidate i against the level's, staged a
  // chunk at a time; warp `warp` counts slice [lo, hi) of the chunk
  const int i = (blockIdx.x - lv.blk_off[l]) * 32 + lane;
  const float vi = i < n ? v[i] : 0.0f;
  int rank = 0;
  for (int base = 0; base < n; base += kRankChunk) {
    const int m = min(kRankChunk, n - base);
    __syncthreads();  // the previous chunk's readers are done
    for (int j = threadIdx.x; j < m; j += kRankThreads) {
      __pipeline_memcpy_async(vals + j, v + base + j, sizeof(float));
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    const int per = (m + kRankSlices - 1) / kRankSlices;
    const int lo = min(m, warp * per), hi = min(m, lo + per);
#pragma unroll 8
    for (int j = lo; j < hi; ++j) {
      const float vj = vals[j];
      rank += (vj > vi || (vj == vi && base + j < i)) ? 1 : 0;
    }
  }
  part[warp][lane] = rank;
  __syncthreads();
  // the slot: the slices' counts summed
  if (warp == 0 && i < n) {
    rank = 0;
#pragma unroll
    for (int k = 0; k < kRankSlices; ++k) rank += part[k][lane];
    if (rank < quota) {
      const size_t slot = s0 + rank;
      uv[2 * slot] = static_cast<float>(cand_xy[2 * (c0 + i)]);
      uv[2 * slot + 1] = static_cast<float>(cand_xy[2 * (c0 + i) + 1]);
      response[slot] = fmaxf(vi, 0.0f);
      valid[slot] = vi > 0.0f ? 1 : 0;
    }
  }
}

struct Camera {
  float fx, fy, cx, cy, bf;
  float k1, k2, p1, p2, k3;
  int has_distortion;
};

__global__ void point_epilogue_kernel(
    const float* __restrict__ uv_level, const float* __restrict__ resp_in,
    const unsigned char* __restrict__ valid_in,
    const float* __restrict__ depth, int h, int w, const PslLevels lv,
    const Camera cam, int capacity, float* __restrict__ uv,
    float* __restrict__ uv_raw, float* __restrict__ response,
    int* __restrict__ level, float* __restrict__ depth_out,
    float* __restrict__ u_right, unsigned char* __restrict__ valid) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= capacity) return;
  const int n_slots = lv.slot_off[lv.n];
  const size_t out = static_cast<size_t>(blockIdx.y) * capacity + k;
  float u = 0.0f;
  float v = 0.0f;
  float resp = 0.0f;
  int l = 0;
  if (k < n_slots) {
    const size_t in = static_cast<size_t>(blockIdx.y) * n_slots + k;
    l = psl_level_of(lv.slot_off, lv.n, k);
    u = __fmul_rn(uv_level[2 * in], lv.scale[l]);
    v = __fmul_rn(uv_level[2 * in + 1], lv.scale[l]);
    resp = valid_in[in] != 0 ? resp_in[in] : 0.0f;
  }
  const bool ok = resp > 0.0f;
  float uu = u;
  float vu = v;
  if (cam.has_distortion != 0) {
    const float xd = (u - cam.cx) / cam.fx;
    const float yd = (v - cam.cy) / cam.fy;
    float xu = xd;
    float yu = yd;
    const float two_p1 = 2.0f * cam.p1;
    const float two_p2 = 2.0f * cam.p2;
    for (int it = 0; it < 5; ++it) {
      const float r2 = xu * xu + yu * yu;
      const float radial =
          1.0f + r2 * (cam.k1 + r2 * (cam.k2 + r2 * cam.k3));
      const float dx = two_p1 * xu * yu + cam.p2 * (r2 + 2.0f * xu * xu);
      const float dy = cam.p1 * (r2 + 2.0f * yu * yu) + two_p2 * xu * yu;
      xu = (xd - dx) / radial;
      yu = (yd - dy) / radial;
    }
    uu = xu * cam.fx + cam.cx;
    vu = yu * cam.fy + cam.cy;
  }
  // nearest depth at the detected (distorted) coordinates, half to even
  const int px = psl_clamp(static_cast<int>(rintf(u)), 0, w - 1);
  const int py = psl_clamp(static_cast<int>(rintf(v)), 0, h - 1);
  const float d = depth[static_cast<size_t>(blockIdx.y) * h * w + py * w + px];
  const bool has_d = d > 1e-6f && ok;
  uv[2 * out] = uu;
  uv[2 * out + 1] = vu;
  uv_raw[2 * out] = u;
  uv_raw[2 * out + 1] = v;
  response[out] = resp;
  level[out] = l;
  depth_out[out] = has_d ? d : -1.0f;
  u_right[out] = has_d ? uu - cam.bf / fmaxf(d, 1e-6f) : -1.0f;
  valid[out] = ok ? 1 : 0;
}

}  // namespace

// K18 for every level of `batch` frames: score (batch, n_pixels); scratch
// cand_val (batch, n_candidates), cand_xy (batch, n_candidates, 2); outputs
// uv (batch, n_slots, 2) in level coordinates, response and valid
// (batch, n_slots). Two launches, tiles then the ranking of every level;
// *launches is set to the launches made.
PSL_API int psl_select_keypoints(const float* score, const int* rows,
                                 int n_levels, int batch, float min_score,
                                 int border, float* cand_val, int* cand_xy,
                                 float* uv, float* response,
                                 unsigned char* valid, int* launches,
                                 cudaStream_t stream) {
  *launches = 0;
  PslLevels lv;
  if (!psl_levels_from_host(rows, nullptr, n_levels, &lv) || batch < 1 ||
      batch > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (lv.tile_off[lv.n] == 0) return 0;
  // a block's tiles: as many as kSmemDefault holds (at least one, at most
  // kTileWarps), of the largest tile of the table
  int max_tile = 0;
  for (int l = 0; l < lv.n; ++l) {
    if (lv.tile_off[l + 1] > lv.tile_off[l]) {
      max_tile = std::max(max_tile, lv.tile[l]);
    }
  }
  const int per_tile = static_cast<int>(sizeof(float)) * tile_floats(max_tile);
  const int per_block =
      std::min(kTileWarps, std::max(1, kSmemDefault / per_tile));
  const int smem = per_block * per_tile;
  if (smem > kSmemDefault) {
    const int rc = psl_opt_in_smem(
        reinterpret_cast<const void*>(select_tiles_kernel), smem);
    if (rc != 0) return rc;
  }
  PslLevels tiles = lv;
  for (int l = 0; l < lv.n; ++l) {
    const int n = lv.tile_off[l + 1] - lv.tile_off[l];
    tiles.blk_off[l + 1] = tiles.blk_off[l] + (n + per_block - 1) / per_block;
  }
  select_tiles_kernel<<<dim3(tiles.blk_off[lv.n], batch), 32 * per_block,
                        smem, stream>>>(score, tiles, min_score, border,
                                        per_block, cand_val, cand_xy);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  ++*launches;
  // the rank blocks: 32 candidates each
  PslLevels rank = lv;
  for (int l = 0; l < lv.n; ++l) {
    const int n = lv.cand_off[l + 1] - lv.cand_off[l];
    rank.blk_off[l + 1] = rank.blk_off[l] + (n + 31) / 32;
  }
  select_rank_kernel<<<dim3(rank.blk_off[lv.n], batch), kRankThreads, 0,
                       stream>>>(cand_val, cand_xy, rank, uv, response,
                                 valid);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  ++*launches;
  return 0;
}

// K19 for `batch` frames: uv_level (batch, n_slots, 2), resp, valid
// (batch, n_slots) as K18 leaves them; depth (batch, h, w); scale the
// table's float32 level scales; outputs (batch, capacity[, 2]).
PSL_API int psl_point_epilogue(const float* uv_level, const float* resp,
                               const unsigned char* valid_in,
                               const float* depth, int h, int w,
                               const int* rows, const float* scale,
                               int n_levels, int batch, int capacity, float fx,
                               float fy, float cx, float cy, float bf,
                               float k1, float k2, float p1, float p2,
                               float k3, int has_distortion, float* uv,
                               float* uv_raw, float* response, int* level,
                               float* depth_out, float* u_right,
                               unsigned char* valid, cudaStream_t stream) {
  PslLevels lv;
  if (!psl_levels_from_host(rows, scale, n_levels, &lv) || batch < 1 ||
      capacity < lv.slot_off[lv.n]) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (capacity == 0) return 0;
  const Camera cam = {fx, fy, cx, cy, bf, k1, k2, p1, p2, k3, has_distortion};
  point_epilogue_kernel<<<dim3((capacity + 127) / 128, batch), 128, 0,
                          stream>>>(uv_level, resp, valid_in, depth, h, w, lv,
                                    cam, capacity, uv, uv_raw, response,
                                    level, depth_out, u_right, valid);
  return static_cast<int>(cudaGetLastError());
}
