// K1 fast_score — dense FAST-9/16 "V" corner score.
//
// Replaces planarslam_tpu/ops/fast.py::fast_score (the JAX version builds
// 16 edge-replicated shifted copies of the level and reduces 9-arcs with a
// log-doubling min over a (16+8, H, W) stack). The score of a pixel is the
// larger of bright = max over the 16 arc starts of the min over the 9 arc
// members of (ring - centre), and dark = max over the starts of -(the max
// over the members), and 0.
//
// What bounds it on an H100: instructions. A pixel reads 4 bytes and
// writes 4 (2.5 MB each way for all 8 levels of a 640x480 pyramid, under a
// microsecond of HBM time), and needs ~160 min, max and subtract
// instructions, which the card issues at about the same rate per pixel. So
// the design spends as few instructions a pixel as it can:
// - 2-D tiles of kTileW x kTileH pixels, each inside one level: the grid
//   is the levels' tiles one after the other (the host's level table, by
//   value), the frames its second dimension, so a block finds its level
//   and tile once and no thread divides per pixel;
// - the block stages its tile with a 3-pixel halo in shared memory by
//   asynchronous copies, all of a thread's in flight together, the edge
//   replication (clamped coordinates) done there, once;
// - a thread scores kPix adjacent pixels of a row: it reads the 7 rows x
//   10 columns of their footprint as float4 and float2 loads, and takes
//   each pixel's 16 ring values from those registers;
// - the arcs reduce by doubling, as the JAX function does: the mins of 2,
//   of 4 and of 8 consecutive ring values, then the ninth member, 64 min a
//   polarity instead of 144, then the best over the 16 starts; the centre
//   is subtracted once, after.
//
// Why the bits are the first per-pixel kernel's (and the plain version's):
// round-to-nearest subtraction is non-decreasing in its first operand, so
// min_j fl(r_j - c) = fl(min_j r_j - c) and the same for max: the min of
// 9 differences is the difference of the min, and the best over the starts
// likewise. min and max return one of their operands, so on finite inputs
// without -0.0 (a pyramid of grey levels) the order in which they are
// taken cannot change a bit. Zero keeps its sign too: x - x = +0, so a zero
// bright is +0 and a zero dark (-fl(...)) is -0 in both forms.
//
// fast_score_levels_kernel scores every level of a frame's pyramid, and
// every frame of a batch, in one launch; a single level is the one-level
// table. Blocks that stay resident and stage the next tile while they
// score one were slower (96 registers, 2 blocks an SM against 3).
#include <cuda_pipeline.h>

#include "common.cuh"
#include "levels.cuh"

namespace {

constexpr int kTileW = 64;  // pixels of a tile's row
constexpr int kTileH = 16;  // rows of a tile
constexpr int kPix = 4;     // adjacent pixels a thread scores
constexpr int kHalo = 3;    // the ring's radius
constexpr int kStageH = kTileH + 2 * kHalo;
constexpr int kStageW = kTileW + 2 * kHalo;
// the staged row's stride: a multiple of 4 floats (float4 reads)
constexpr int kStageStride = (kStageW + 3) / 4 * 4;
static_assert(kTileW == 16 * kPix, "16 threads a tile row");

// The best arc of a polarity: max over the 16 starts s of op over the 9
// ring values from s (kMin: op = min; else op = max and the best is the
// min over the starts). Doubling: op of 2, of 4, of 8, then the ninth.
template <bool kMin>
__device__ __forceinline__ float op(float a, float b) {
  return kMin ? fminf(a, b) : fmaxf(a, b);
}

template <bool kMin>
__device__ __forceinline__ float best_arc(const float (&r)[16]) {
  float m2[16], m4[16], m8[16];
#pragma unroll
  for (int s = 0; s < 16; ++s) m2[s] = op<kMin>(r[s], r[(s + 1) & 15]);
#pragma unroll
  for (int s = 0; s < 16; ++s) m4[s] = op<kMin>(m2[s], m2[(s + 2) & 15]);
#pragma unroll
  for (int s = 0; s < 16; ++s) m8[s] = op<kMin>(m4[s], m4[(s + 4) & 15]);
  float best = op<kMin>(m8[0], r[8]);
#pragma unroll
  for (int s = 1; s < 16; ++s) {
    const float arc = op<kMin>(m8[s], r[(s + 8) & 15]);
    best = kMin ? fmaxf(best, arc) : fminf(best, arc);
  }
  return best;
}

// The score of pixel p (0..kPix-1) of a thread from its footprint's rows
// v[dy + 3][k], k the staged column less the thread's first (p + 3 + dx).
__device__ __forceinline__ float score_of(const float (&v)[7][10], int p) {
  // the ring in order: (dy, dx) = (-3, 0), (-3, 1), (-2, 2), (-1, 3),
  // (0, 3), (1, 3), (2, 2), (3, 1), (3, 0), (3, -1), (2, -2), (1, -3),
  // (0, -3), (-1, -3), (-2, -2), (-3, -1)
  const float r[16] = {v[0][p + 3], v[0][p + 4], v[1][p + 5], v[2][p + 6],
                       v[3][p + 6], v[4][p + 6], v[5][p + 5], v[6][p + 4],
                       v[6][p + 3], v[6][p + 2], v[5][p + 1], v[4][p],
                       v[3][p],     v[2][p],     v[1][p + 1], v[0][p + 2]};
  const float c = v[3][p + 3];
  const float bright = __fsub_rn(best_arc<true>(r), c);
  const float dark = -__fsub_rn(best_arc<false>(r), c);
  return fmaxf(fmaxf(bright, dark), 0.0f);
}

constexpr int kThreads = 16 * kTileH;

__global__ void __launch_bounds__(kThreads)
    fast_score_levels_kernel(const float* __restrict__ buf,
                             float* __restrict__ out, const PslLevels lv) {
  __shared__ __align__(16) float tile[kStageH][kStageStride];
  const int l = psl_level_of(lv.blk_off, lv.n, blockIdx.x);
  const int h = lv.h[l], w = lv.w[l];
  const int tiles_x = (w + kTileW - 1) / kTileW;
  const int blk = blockIdx.x - lv.blk_off[l];
  const int x0 = (blk % tiles_x) * kTileW, y0 = (blk / tiles_x) * kTileH;
  const size_t base =
      static_cast<size_t>(blockIdx.y) * lv.n_pixels + lv.off[l];
  const float* img = buf + base;
  // staging: the tile and its halo, coordinates clamped into the level,
  // every copy of a thread in flight at once (asynchronous copies)
  for (int i = threadIdx.y * 16 + threadIdx.x; i < kStageH * kStageW;
       i += kThreads) {
    const int sy = i / kStageW, sx = i - sy * kStageW;
    const int yy = psl_clamp(y0 - kHalo + sy, 0, h - 1);
    const int xx = psl_clamp(x0 - kHalo + sx, 0, w - 1);
    __pipeline_memcpy_async(&tile[sy][sx], img + yy * w + xx, sizeof(float));
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  // scoring: the footprint's 7 rows of 10 columns, then kPix pixels
  const int tx = kPix * threadIdx.x, y = y0 + threadIdx.y;
  float v[7][10];
#pragma unroll
  for (int dy = 0; dy < 7; ++dy) {
    const float* row = &tile[threadIdx.y + dy][tx];
    const float4 a = *reinterpret_cast<const float4*>(row);
    const float4 b = *reinterpret_cast<const float4*>(row + 4);
    const float2 c = *reinterpret_cast<const float2*>(row + 8);
    v[dy][0] = a.x;
    v[dy][1] = a.y;
    v[dy][2] = a.z;
    v[dy][3] = a.w;
    v[dy][4] = b.x;
    v[dy][5] = b.y;
    v[dy][6] = b.z;
    v[dy][7] = b.w;
    v[dy][8] = c.x;
    v[dy][9] = c.y;
  }
  if (y >= h) return;
  float* o = out + base + static_cast<size_t>(y) * w;
#pragma unroll
  for (int p = 0; p < kPix; ++p) {
    const int x = x0 + tx + p;
    if (x < w) o[x] = score_of(v, p);
  }
}

// Launch K1 over the levels of lv (its blk_off set here) for `batch`
// frames: a block per tile, the batch the grid's second dimension.
int launch_levels(const float* buf, float* out, PslLevels lv, int batch,
                  cudaStream_t stream) {
  if (batch < 1 || batch > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int l = 0; l < lv.n; ++l) {
    lv.blk_off[l + 1] = lv.blk_off[l] +
                        ((lv.w[l] + kTileW - 1) / kTileW) *
                            ((lv.h[l] + kTileH - 1) / kTileH);
  }
  if (lv.blk_off[lv.n] == 0) return 0;
  fast_score_levels_kernel<<<dim3(lv.blk_off[lv.n], batch),
                             dim3(16, kTileH), 0, stream>>>(buf, out, lv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

PSL_API const char* psl_error_string(int code) {
  if (code == kPslErrAlphaSamples) {
    return "noise_alpha: a frame has more than 421888 strided samples "
           "(ceil(H / 4) x ceil(W / 4)), the most its cluster's shared "
           "memory holds";
  }
  if (code == kPslErrAssignParts) {
    return "plane_assign_refit: a frame has more than 16384 logical blocks "
           "(ceil(ceil(H / rs) x ceil(W / rs) / pix_per_block)), the most "
           "its flag words hold";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// One (h, w) level: the one-level table.
PSL_API int psl_fast_score(const float* img, float* out, int h, int w,
                           cudaStream_t stream) {
  if (h < 0 || w < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int row[kPslLevelFields] = {0, h, w, 8, 0, 0, 0, 0};
  PslLevels lv;
  psl_levels_from_host(row, nullptr, 1, &lv);
  return launch_levels(img, out, lv, 1, stream);
}

// All levels of `batch` frames: buf, out (batch, n_pixels); rows is the
// host's level table.
PSL_API int psl_fast_score_levels(const float* buf, float* out,
                                  const int* rows, int n_levels, int batch,
                                  cudaStream_t stream) {
  PslLevels lv;
  if (!psl_levels_from_host(rows, nullptr, n_levels, &lv)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_levels(buf, out, lv, batch, stream);
}
