// K1 fast_score — dense FAST-9/16 "V" corner score.
//
// Replaces planarslam_tpu/ops/fast.py::fast_score (the JAX version builds
// 16 edge-replicated shifted copies of the level and reduces 9-arcs with a
// log-doubling min over a (16+8, H, W) stack). Here one thread owns one
// pixel: it reads the centre and its 16 Bresenham-ring neighbours (clamped
// coordinates = edge replication), forms the 16 differences once, and takes
// max over the 16 arc starts of the min over 9 arc members, for the bright
// and the dark polarity.
//
// What bounds it on an H100: memory. Per pixel it writes 4 bytes and reads a
// 7x7 footprint that neighbouring threads share through L1, so DRAM traffic
// is ~8 bytes/pixel (2.5 MB for all 8 levels of a 640x480 pyramid, under a
// microsecond of HBM time); the ~290 min/max instructions per pixel are the
// larger cost at these sizes, and launch latency dominates below ~100k
// pixels. min/max/subtract are exact, so the result is bit-identical to the
// plain version.
//
// fast_score_levels_kernel scores every level of a frame's pyramid (and
// every frame of a batch) in one launch: a thread owns one pixel of the
// all-levels buffer and finds its level in the by-value table
// (levels.cuh), so a frame costs one launch instead of one per level.
#include "common.cuh"
#include "levels.cuh"

namespace {

__constant__ int kRingDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3,
                                3, 3, 2, 1, 0, -1, -2, -3};
__constant__ int kRingDx[16] = {0, 1, 2, 3, 3, 3, 2, 1,
                                0, -1, -2, -3, -3, -3, -2, -1};
constexpr int kArc = 9;

__device__ __forceinline__ float fast_score_at(const float* __restrict__ img,
                                               int h, int w, int x, int y) {
  const float c = img[y * w + x];
  float d[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const int yy = psl_clamp(y + kRingDy[k], 0, h - 1);
    const int xx = psl_clamp(x + kRingDx[k], 0, w - 1);
    d[k] = __fsub_rn(img[yy * w + xx], c);
  }
  float bright = -INFINITY;
  float dark = -INFINITY;
#pragma unroll
  for (int s = 0; s < 16; ++s) {
    float mn = INFINITY;
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < kArc; ++j) {
      const float v = d[(s + j) & 15];
      mn = fminf(mn, v);
      mx = fmaxf(mx, v);
    }
    bright = fmaxf(bright, mn);
    dark = fmaxf(dark, -mx);
  }
  return fmaxf(fmaxf(bright, dark), 0.0f);
}

__global__ void fast_score_kernel(const float* __restrict__ img,
                                  float* __restrict__ out, int h, int w) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;
  out[y * w + x] = fast_score_at(img, h, w, x, y);
}

__global__ void fast_score_levels_kernel(const float* __restrict__ buf,
                                         float* __restrict__ out,
                                         const PslLevels lv) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= lv.n_pixels) return;
  const size_t frame = static_cast<size_t>(blockIdx.y) * lv.n_pixels;
  const int l = psl_level_of(lv.off, lv.n, p);
  const int q = p - lv.off[l];
  const int w = lv.w[l];
  out[frame + p] = fast_score_at(buf + frame + lv.off[l], lv.h[l], w, q % w,
                                 q / w);
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

PSL_API int psl_fast_score(const float* img, float* out, int h, int w,
                           cudaStream_t stream) {
  const dim3 block(32, 8);
  const dim3 grid((w + block.x - 1) / block.x, (h + block.y - 1) / block.y);
  fast_score_kernel<<<grid, block, 0, stream>>>(img, out, h, w);
  return static_cast<int>(cudaGetLastError());
}

// All levels of `batch` frames: buf, out (batch, n_pixels); rows is the
// host's level table.
PSL_API int psl_fast_score_levels(const float* buf, float* out,
                                  const int* rows, int n_levels, int batch,
                                  cudaStream_t stream) {
  PslLevels lv;
  if (!psl_levels_from_host(rows, nullptr, n_levels, &lv) || batch < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((lv.n_pixels + 255) / 256, batch);
  fast_score_levels_kernel<<<grid, 256, 0, stream>>>(buf, out, lv);
  return static_cast<int>(cudaGetLastError());
}
