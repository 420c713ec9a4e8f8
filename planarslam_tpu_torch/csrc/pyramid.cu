// K16 pyramid_resize and K17 gaussian_blur — the dense image stages of the
// point front end, on the one buffer that holds all levels of a frame.
//
// K16 replaces planarslam_tpu/ops/image.py::resize_bilinear as build_pyramid
// calls it (jax.image.resize, the antialiased triangle filter): the JAX
// version applies two dense (in, out) weight matrices per level whose
// columns hold 2-3 non-zero taps. Here a thread owns one output pixel and
// gathers those taps from a compact table (first input index, tap count, 3
// weights per output row and per output column), which the host derives
// once from the same float32 weights and keeps on the device. Rows are
// applied first and each row sum is rounded to float32 before the column
// taps use it, as the two products do; the taps are added in ascending
// order. A level is resized from the previous one, so a pyramid is
// n_levels - 1 dependent launches, issued by one call of the C entry point;
// the first of them also copies the frame into the buffer as level 0.
// Bound: bytes. A level is read once and written once (3.8 MB for the eight
// levels of 640x480); per output pixel at most 9 loads that neighbours share
// through L1 and 12 multiply-adds. At these sizes a launch is latency.
//
// K17 replaces planarslam_tpu/ops/image.py::blur (separable Gaussian, up to
// 7 taps, replicate borders), which is 14 scaled adds and 4 concatenations
// per level in the JAX version. One launch blurs every level of the buffer
// (the 5-tap blur of the line stage is the same kernel on a one-level
// table). Each pass accumulates 0 + k0 x0 + k1 x1 + ... in that order with
// a separate multiply and add, and the vertical result is rounded to
// float32 before the horizontal pass reads it, as the JAX version's
// intermediate image is: the output has the bits of the plain version, and
// descriptor bits are comparisons of blurred values.
// Bound: bytes (each pixel read once and written once, 7.6 MB for the eight
// levels of a 640x480 frame and 2.5 MB for the frame); 2 x ksize multiplies
// and adds per pixel. At one frame the launch is latency: few bytes, many
// small blocks. The design:
// - a block owns a strip of kBlurCols staged columns of one level (the
//   strip's 64 - 2r output columns and an r-column halo each side, the
//   coordinates clamped into the level: replicate borders) and walks down
//   `seg_bands` bands of kBlurBand rows; the host picks seg_bands so that
//   the grid is about one wave of resident blocks (one band a block at one
//   frame, three at four), taking each block's level from its table;
// - a band's rows, with their r-row halo, are staged by asynchronous
//   4-byte copies (level offsets such as 842491 are not 16-byte aligned),
//   double-buffered: band k + 1 loads while band k is filtered;
// - the vertical pass: a thread takes 8 rows of one column, its
//   8 + 2r-row window read once into registers;
// - the horizontal pass: a warp takes a row of the intermediate, a lane
//   two outputs, so the stores of a warp are 32 consecutive floats.
// The tap count is a template argument: the loops unroll.
#include <cuda_pipeline.h>

#include <algorithm>

#include "common.cuh"
#include "levels.cuh"

namespace {

constexpr int kMaxTaps = 3;  // non-zero taps of one resize output

struct ResizeTap {  // 20 bytes, matches ops/image.py::resize_taps
  int first;
  int count;
  float w[kMaxTaps];
};

__global__ void pyramid_resize_kernel(
    const float* __restrict__ src, int h_in, int w_in, size_t src_stride,
    float* __restrict__ dst, int h_out, int w_out, size_t dst_stride,
    const ResizeTap* __restrict__ row_taps,
    const ResizeTap* __restrict__ col_taps, float* __restrict__ copy_to,
    size_t copy_stride) {
  const int b = blockIdx.z;
  const float* s = src + b * src_stride;
  const int ox = blockIdx.x * blockDim.x + threadIdx.x;
  const int oy = blockIdx.y * blockDim.y + threadIdx.y;
  if (copy_to != nullptr) {
    // level 0: the frame itself, copied by the threads of this launch
    const int n_threads = gridDim.x * gridDim.y * blockDim.x * blockDim.y;
    const int tid = (blockIdx.y * gridDim.x + blockIdx.x) *
                        (blockDim.x * blockDim.y) +
                    threadIdx.y * blockDim.x + threadIdx.x;
    float* c = copy_to + b * copy_stride;
    for (int i = tid; i < h_in * w_in; i += n_threads) c[i] = s[i];
  }
  if (ox >= w_out || oy >= h_out) return;
  const ResizeTap rt = row_taps[oy];
  const ResizeTap ct = col_taps[ox];
  float acc = 0.0f;
  for (int j = 0; j < ct.count; ++j) {
    const int ix = ct.first + j;
    float rows = 0.0f;  // the row product's value at (oy, ix)
    for (int i = 0; i < rt.count; ++i) {
      rows = fmaf(rt.w[i], s[(rt.first + i) * w_in + ix], rows);
    }
    acc = fmaf(rows, ct.w[j], acc);
  }
  dst[b * dst_stride + oy * w_out + ox] = acc;
}

constexpr int kBlurMaxTaps = 7;
constexpr int kBlurCols = 64;     // staged columns of a strip
constexpr int kBlurBand = 16;     // rows of a band
constexpr int kBlurThreads = 128;  // vertical pass: 2 x 8 rows x 64 columns
static_assert(kBlurThreads == 2 * kBlurCols, "two row halves a column");
static_assert(kBlurBand == 16 && kBlurThreads == 4 * 32,
              "a warp takes rows w, w + 4, w + 8, w + 12 of a band");

struct BlurTaps {
  float k[kBlurMaxTaps];
};

template <int KSIZE>
__global__ void __launch_bounds__(kBlurThreads)
    gaussian_blur_kernel(const float* __restrict__ src,
                         float* __restrict__ dst, const PslLevels lv,
                         const BlurTaps taps, int seg_bands) {
  constexpr int R = KSIZE / 2;
  constexpr int kStrip = kBlurCols - 2 * R;  // output columns of a strip
  constexpr int kRows = kBlurBand + 2 * R;   // staged rows of a band
  constexpr int kWin = kBlurBand / 2 + 2 * R;  // a thread's vertical window
  __shared__ float stage[2][kRows][kBlurCols];
  __shared__ float mid[kBlurBand][kBlurCols];
  const int l = psl_level_of(lv.blk_off, lv.n, blockIdx.x);
  const int h = lv.h[l], w = lv.w[l];
  const int strips = (w + kStrip - 1) / kStrip;
  const int blk = blockIdx.x - lv.blk_off[l];
  const int x0 = (blk % strips) * kStrip;
  const int y_seg = (blk / strips) * seg_bands * kBlurBand;
  const int n_bands =
      min(seg_bands, (h - y_seg + kBlurBand - 1) / kBlurBand);
  const size_t base = static_cast<size_t>(blockIdx.y) * lv.n_pixels + lv.off[l];
  const int tid = threadIdx.x;
  const int c = tid % kBlurCols;   // this thread's staged column
  const int half = tid / kBlurCols;  // and row half (vertical pass)
  const int warp = tid / 32, lane = tid % 32;
  // a thread stages one column of every other row of a band
  const float* col = src + base + psl_clamp(x0 - R + c, 0, w - 1);
  auto stage_band = [&](int k) {
    const int y_top = y_seg + k * kBlurBand - R;
    for (int r = half; r < kRows; r += 2) {
      __pipeline_memcpy_async(&stage[k & 1][r][c],
                              col + psl_clamp(y_top + r, 0, h - 1) * w,
                              sizeof(float));
    }
    __pipeline_commit();
  };
  stage_band(0);
  for (int k = 0; k < n_bands; ++k) {
    // staging: band k + 1's copies issued, band k's awaited
    if (k + 1 < n_bands) {
      stage_band(k + 1);
    } else {
      __pipeline_commit();
    }
    __pipeline_wait_prior(1);
    __syncthreads();
    // vertical pass: rows 8 half .. 8 half + 7 of column c
    {
      float win[kWin];
#pragma unroll
      for (int i = 0; i < kWin; ++i) {
        win[i] = stage[k & 1][half * (kBlurBand / 2) + i][c];
      }
#pragma unroll
      for (int o = 0; o < kBlurBand / 2; ++o) {
        float acc = 0.0f;
#pragma unroll
        for (int t = 0; t < KSIZE; ++t) {
          acc = __fadd_rn(acc, __fmul_rn(taps.k[t], win[o + t]));
        }
        mid[half * (kBlurBand / 2) + o][c] = acc;
      }
    }
    __syncthreads();
    // horizontal pass: warp w rows w, w + 4, ..., lane the columns lane
    // and lane + 32 of the strip
    const int y_band = y_seg + k * kBlurBand;
#pragma unroll
    for (int i = 0; i < kBlurBand / 4; ++i) {
      const int r = warp + 4 * i;
      if (y_band + r >= h) break;
      float* out = dst + base + static_cast<size_t>(y_band + r) * w + x0;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int j = lane + 32 * q;
        if (j < kStrip && x0 + j < w) {
          float acc = 0.0f;
#pragma unroll
          for (int t = 0; t < KSIZE; ++t) {
            acc = __fadd_rn(acc, __fmul_rn(taps.k[t], mid[r][j + t]));
          }
          out[j] = acc;
        }
      }
    }
  }  // the walk down the strip
}

// Blocks of gaussian_blur_kernel<KSIZE> resident on the current card at
// once (its SMs times the blocks an SM holds) into *wave, cached per card;
// returns a CUDA error code.
template <int KSIZE>
int blur_wave(int* wave) {
  static int cache[kPslDevices] = {};
  int* slot = psl_device_slot(cache);
  if (slot != nullptr && *slot > 0) {
    *wave = *slot;
    return 0;
  }
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, gaussian_blur_kernel<KSIZE>, kBlurThreads, 0);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (sms * per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  *wave = sms * per_sm;
  if (slot != nullptr) *slot = *wave;
  return 0;
}

// K17 over the levels of lv (its blk_off set here) for `batch` frames:
// bands of all strips over about one wave of blocks.
template <int KSIZE>
int launch_blur(const float* src, float* dst, PslLevels lv, int batch,
                const BlurTaps& taps, cudaStream_t stream) {
  constexpr int kStrip = kBlurCols - 2 * (KSIZE / 2);
  long long bands = 0;
  for (int l = 0; l < lv.n; ++l) {
    bands += static_cast<long long>((lv.w[l] + kStrip - 1) / kStrip) *
             ((lv.h[l] + kBlurBand - 1) / kBlurBand);
  }
  if (bands == 0) return 0;
  int wave = 0;
  const int rc = blur_wave<KSIZE>(&wave);
  if (rc != 0) return rc;
  const int seg = static_cast<int>(
      std::max(1LL, (bands * batch + wave - 1) / wave));
  for (int l = 0; l < lv.n; ++l) {
    const int segs = ((lv.h[l] + kBlurBand - 1) / kBlurBand + seg - 1) / seg;
    lv.blk_off[l + 1] =
        lv.blk_off[l] + ((lv.w[l] + kStrip - 1) / kStrip) * segs;
  }
  gaussian_blur_kernel<KSIZE><<<dim3(lv.blk_off[lv.n], batch), kBlurThreads,
                                0, stream>>>(src, dst, lv, taps, seg);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The pyramid of `batch` frames: gray (batch, h, w) with frames gray_stride
// floats apart -> buf (batch, n_pixels), level 0 a copy of the frame and
// level l resized from level l - 1. rows is the host's level table;
// row_taps[l] (h[l] entries) and col_taps[l] (w[l] entries) are the device
// tap tables of level l >= 1 (host arrays of device pointers, entry 0
// unused). One launch per level above 0, issued here one after the other;
// a one-level table is the copy alone.
PSL_API int psl_pyramid_build(const float* gray, long long gray_stride,
                              float* buf, const int* rows, int n_levels,
                              int batch, const void* const* row_taps,
                              const void* const* col_taps,
                              cudaStream_t stream) {
  PslLevels lv;
  if (!psl_levels_from_host(rows, nullptr, n_levels, &lv) || batch < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 block(32, 8);
  const size_t stride = static_cast<size_t>(lv.n_pixels);
  if (lv.n == 1) {
    const dim3 grid((lv.w[0] + block.x - 1) / block.x,
                    (lv.h[0] + block.y - 1) / block.y, batch);
    pyramid_resize_kernel<<<grid, block, 0, stream>>>(
        gray, lv.h[0], lv.w[0], static_cast<size_t>(gray_stride), nullptr, 0,
        0, 0, nullptr, nullptr, buf, stride);
    return static_cast<int>(cudaGetLastError());
  }
  for (int l = 1; l < lv.n; ++l) {
    const dim3 grid((lv.w[l] + block.x - 1) / block.x,
                    (lv.h[l] + block.y - 1) / block.y, batch);
    const bool first = l == 1;
    pyramid_resize_kernel<<<grid, block, 0, stream>>>(
        first ? gray : buf + lv.off[l - 1], lv.h[l - 1], lv.w[l - 1],
        first ? static_cast<size_t>(gray_stride) : stride, buf + lv.off[l],
        lv.h[l], lv.w[l], stride, static_cast<const ResizeTap*>(row_taps[l]),
        static_cast<const ResizeTap*>(col_taps[l]), first ? buf : nullptr,
        stride);
    const int rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
  }
  return 0;
}

// Every level of `batch` frames: src, dst (batch, n_pixels); rows is the
// host's level table; k0..k6 the taps (the first ksize are read), ksize 1,
// 3, 5 or 7.
PSL_API int psl_gaussian_blur(const float* src, float* dst, const int* rows,
                              int n_levels, int batch, int ksize, float k0,
                              float k1, float k2, float k3, float k4, float k5,
                              float k6, cudaStream_t stream) {
  PslLevels lv;
  if (!psl_levels_from_host(rows, nullptr, n_levels, &lv) || batch < 1 ||
      batch > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const BlurTaps taps = {{k0, k1, k2, k3, k4, k5, k6}};
  switch (ksize) {
    case 1:
      return launch_blur<1>(src, dst, lv, batch, taps, stream);
    case 3:
      return launch_blur<3>(src, dst, lv, batch, taps, stream);
    case 5:
      return launch_blur<5>(src, dst, lv, batch, taps, stream);
    case 7:
      return launch_blur<7>(src, dst, lv, batch, taps, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
