// K18 select_keypoints and K19 point_epilogue — from FAST scores to the
// frame's fixed-capacity keypoint block, all pyramid levels per launch.
//
// K18 replaces planarslam_tpu/ops/fast.py::select_keypoints: 3x3 non-maximum
// suppression, the border and threshold gate, the k_tile best of every
// tile, and the `quota` best of a level's candidates. The JAX version pads
// and reshapes the gated map into tiles, takes k_tile arg-max passes (or a
// per-tile sort above 4) and one sort per level. Here:
//   tiles: one block per tile of any level. The block gates its tile's
//     pixels into shared memory (outside the image: -1, as the padding is)
//     and takes k_tile maxima by a block-wide arg-max with ties to the lower
//     in-tile index. A maximum taken becomes -1 where the JAX version masks
//     it so (k_tile <= 4, so a tile that runs dry yields its cell 0 again),
//     and leaves the ranking where the JAX version sorts (k_tile > 4, a dry
//     tile then yields its -1 cells in index order): the candidates of
//     invalid slots come out as the JAX version's do.
//   selection: a few blocks per level rank the level's n_tiles * k_tile
//     candidates by counting, one candidate per thread: the rank of a candidate is the number of
//     candidates with a greater value, or an equal value and a lower index
//     in the (tile, pass) order. A rank below the quota is the slot. That
//     is the stable descending sort, without a sort and without atomics, so
//     two launches give the same bits.
// Bound: bytes (the score maps read once, 3.8 MB for the eight levels of
// 640x480); the arg-max passes and the n^2 / 2 rank comparisons (n <= 672)
// are latency at these sizes.
//
// K19 replaces the tail of planarslam_tpu/ops/frontend.py::
// extract_point_features: level coordinates times float32(scale ^ level),
// responses zeroed where invalid, the level index, zero padding up to the
// capacity, undistortion (5 fixed-point steps of the radial-tangential
// model), the nearest depth at the detected coordinates (round half to
// even), and the pseudo-stereo right coordinate. One thread per slot.
// Bound: latency (1024 slots, ~200 operations and one gather each).
#include <algorithm>

#include "common.cuh"
#include "levels.cuh"

namespace {

constexpr int kTileThreads = 256;
constexpr int kRankThreads = 128;

struct Best {
  float v;
  int i;
};

// The greater value, ties to the lower index.
__device__ __forceinline__ Best better(Best a, Best b) {
  return (b.v > a.v || (b.v == a.v && b.i < a.i)) ? b : a;
}

__global__ void select_tiles_kernel(const float* __restrict__ score,
                                    const PslLevels lv, float min_score,
                                    int border, float* __restrict__ cand_val,
                                    int* __restrict__ cand_xy) {
  extern __shared__ float cell[];  // tile * tile gated scores
  __shared__ Best warp_best[kTileThreads / 32];
  const int tid = threadIdx.x;
  const int l = psl_level_of(lv.tile_off, lv.n, blockIdx.x);
  const int t = blockIdx.x - lv.tile_off[l];
  const int tile = lv.tile[l];
  const int h = lv.h[l];
  const int w = lv.w[l];
  const int k_tile = lv.k_tile[l];
  const int y0 = (t / lv.ntw[l]) * tile;
  const int x0 = (t % lv.ntw[l]) * tile;
  const float* s = score + static_cast<size_t>(blockIdx.y) * lv.n_pixels +
                   lv.off[l];
  const int n_cells = tile * tile;

  for (int c = tid; c < n_cells; c += kTileThreads) {
    const int y = y0 + c / tile;
    const int x = x0 + c % tile;
    float v = -1.0f;
    if (y >= border && y < h - border && x >= border && x < w - border) {
      const float sc = s[y * w + x];
      bool keep = sc > min_score;
      for (int dy = -1; dy <= 1 && keep; ++dy) {
        for (int dx = -1; dx <= 1; ++dx) {
          const int yy = y + dy;
          const int xx = x + dx;
          if (yy >= 0 && yy < h && xx >= 0 && xx < w && s[yy * w + xx] > sc) {
            keep = false;
          }
        }
      }
      if (keep) v = sc;
    }
    cell[c] = v;
  }
  __syncthreads();

  // the JAX version masks a taken maximum with -1 (arg-max passes) or
  // leaves it behind in a sort: below every -1 here
  const float taken = k_tile <= 4 ? -1.0f : -2.0f;
  const size_t out0 = static_cast<size_t>(blockIdx.y) * lv.cand_off[lv.n] +
                      lv.cand_off[l] + static_cast<size_t>(t) * k_tile;
  for (int pass = 0; pass < k_tile; ++pass) {
    Best b = {-INFINITY, INT_MAX};
    for (int c = tid; c < n_cells; c += kTileThreads) {
      b = better(b, Best{cell[c], c});
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      Best o;
      o.v = __shfl_xor_sync(0xffffffffu, b.v, off);
      o.i = __shfl_xor_sync(0xffffffffu, b.i, off);
      b = better(b, o);
    }
    if ((tid & 31) == 0) warp_best[tid >> 5] = b;
    __syncthreads();
    if (tid == 0) {
      for (int i = 1; i < kTileThreads / 32; ++i) b = better(b, warp_best[i]);
      cand_val[out0 + pass] = b.v;
      cand_xy[2 * (out0 + pass)] = x0 + b.i % tile;
      cand_xy[2 * (out0 + pass) + 1] = y0 + b.i / tile;
      cell[b.i] = taken;
    }
    __syncthreads();
  }
}

__global__ void select_rank_kernel(const float* __restrict__ cand_val,
                                   const int* __restrict__ cand_xy,
                                   const PslLevels lv, float* __restrict__ uv,
                                   float* __restrict__ response,
                                   unsigned char* __restrict__ valid) {
  const int l = blockIdx.x;
  const int n = lv.cand_off[l + 1] - lv.cand_off[l];
  const int quota = lv.slot_off[l + 1] - lv.slot_off[l];
  const size_t c0 = static_cast<size_t>(blockIdx.y) * lv.cand_off[lv.n] +
                    lv.cand_off[l];
  const size_t s0 = static_cast<size_t>(blockIdx.y) * lv.slot_off[lv.n] +
                    lv.slot_off[l];
  const float* v = cand_val + c0;
  // the blocks of a level (gridDim.z of them) share its candidates out
  for (int i = blockIdx.z * blockDim.x + threadIdx.x; i < n;
       i += gridDim.z * blockDim.x) {
    const float vi = v[i];
    int rank = 0;
    for (int j = 0; j < n; ++j) {
      const float vj = v[j];
      rank += (vj > vi || (vj == vi && j < i)) ? 1 : 0;
    }
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
// (batch, n_slots). Two launches: tiles, then the ranking of every level.
PSL_API int psl_select_keypoints(const float* score, const int* rows,
                                 int n_levels, int batch, float min_score,
                                 int border, float* cand_val, int* cand_xy,
                                 float* uv, float* response,
                                 unsigned char* valid, cudaStream_t stream) {
  PslLevels lv;
  if (!psl_levels_from_host(rows, nullptr, n_levels, &lv) || batch < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int max_tile = 0;
  for (int l = 0; l < lv.n; ++l) {
    if (lv.tile_off[l + 1] > lv.tile_off[l] && lv.tile[l] > max_tile) {
      max_tile = lv.tile[l];
    }
  }
  const size_t shmem = sizeof(float) * max_tile * max_tile;
  if (shmem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (lv.tile_off[lv.n] == 0) return 0;
  select_tiles_kernel<<<dim3(lv.tile_off[lv.n], batch), kTileThreads, shmem,
                        stream>>>(score, lv, min_score, border, cand_val,
                                  cand_xy);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  int max_cand = 0;
  for (int l = 0; l < lv.n; ++l) {
    max_cand = std::max(max_cand, lv.cand_off[l + 1] - lv.cand_off[l]);
  }
  const int rank_blocks =
      std::min(64, (max_cand + kRankThreads - 1) / kRankThreads);
  select_rank_kernel<<<dim3(lv.n, batch, rank_blocks), kRankThreads, 0,
                       stream>>>(cand_val, cand_xy, lv, uv, response, valid);
  return static_cast<int>(cudaGetLastError());
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
