// K16 pyramid_resize and K17 gaussian_blur — the dense image stages of the
// point front end, on the one buffer that holds all levels of a frame.
//
// K16 replaces planarslam_tpu/ops/image.py::resize_bilinear as build_pyramid
// calls it (jax.image.resize, the antialiased triangle filter): the JAX
// version applies two dense (in, out) weight matrices per level whose
// columns hold 2-3 non-zero taps. Here the taps come from a compact table
// (first input index, tap count, 3 weights per output row and per output
// column), which the host derives once from the same float32 weights and
// keeps on the device. Rows are applied first and each row sum is rounded
// to float32 before the column taps use it, as the two products do; the
// taps are added in ascending order by fmaf. A level is resized from the
// previous one.
// Bound: bytes (each level read once and written once, 3.8 MB for the
// eight levels of 640x480); per output at most 12 multiply-adds. A pyramid
// is a chain of seven dependent levels, and each level's hop through
// device memory (its stores seen by the next level's readers: a launch,
// or a flag between blocks) costs microseconds while its work costs less.
// The design: one launch, and no block waits for another.
// - A block takes a cone: a 16 x 16 tile of the last level and, at every
//   level below, the range of rows and columns the tile's outputs depend
//   on, widened to hold the part of that level the cone owns (the top
//   tiles scaled down: a partition of every level). The host derives the
//   ranges from the tap tables once per pyramid shape (ops/image.py::
//   pyramid_cones, a device constant). Neighbouring cones overlap, and
//   their overlap computes the same outputs with the same bits, about 1.4
//   times the pyramid's outputs in all.
// - The frame's window (level 0 of the cone) and every level's taps are
//   staged into shared memory once, by asynchronous copies (16-byte where
//   the frame's rows allow, 4-byte else).
// - Each level: a warp a row applies the row taps to the level below's
//   columns into an intermediate, then a lane a column applies the column
//   taps into the level's buffer, which the next level reads; outputs the
//   cone owns are stored to the pyramid (level 0: the frame's, copied).
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
#include <cstdint>

#include "common.cuh"
#include "levels.cuh"

namespace {

constexpr int kMaxTaps = 3;  // non-zero taps of one resize output

struct ResizeTap {  // 20 bytes, matches ops/image.py::resize_taps
  int first;
  int count;
  float w[kMaxTaps];
};

constexpr int kConeThreads = 512;
constexpr int kConeWarps = kConeThreads / 32;
constexpr int kConeBlocksPerSm = 4;  // so four frames' cones fit in one wave
constexpr int kConeMax = 64;         // cones along a side of the top level
constexpr int kLevelWords = 10;      // ops/image.py::CONE_LEVEL_WORDS

struct ConeArgs {
  const float* gray;  // (batch, h0, w0), frames gray_stride floats apart
  long long gray_stride;
  float* buf;         // (batch, n_pixels)
  // (cones, chunk_words): per cone and level [row lo, hi, owned lo, hi,
  // column lo, hi, owned lo, hi, offset, width] (header_words in all), then
  // the taps of levels 1..: its rows' and its columns'
  const int* chunks;
  int n, n_pixels, w0, chunk_words, header_words, cone_cols;
  int buf_floats, mid_floats;
  int aligned;  // the frame's rows are 16-byte aligned: stage by 16 bytes
  int range0[4][kConeMax];  // level 0's rows by cone row, columns by column
};

__global__ void __launch_bounds__(kConeThreads, kConeBlocksPerSm)
    pyramid_cone_kernel(const __grid_constant__ ConeArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y, cone = blockIdx.x;
  const int ty = cone / a.cone_cols, tx = cone % a.cone_cols;
  int* const chunk = reinterpret_cast<int*>(smem);  // the cone's chunk
  float* const level = smem + a.chunk_words;        // a level of the cone
  float* const mid = level + a.buf_floats;          // its row taps' sums
  // staging: the cone's chunk (its levels' ranges and taps) and the
  // frame's window (level 0 of the cone; by 16 bytes its columns widened
  // to multiples of 4), by asynchronous copies, all in flight at once
  const int y0 = a.range0[0][ty], ny0 = a.range0[1][ty] - y0;
  int ax0 = a.range0[2][tx], an = a.range0[3][tx] - ax0;  // the level below
  if (a.aligned) {
    an = ((ax0 + an + 3) & ~3) - (ax0 & ~3);
    ax0 &= ~3;
  }
  {
    const int* src = a.chunks + static_cast<size_t>(cone) * a.chunk_words;
    for (int i = 4 * tid; i < a.chunk_words; i += 4 * kConeThreads) {
      __pipeline_memcpy_async(chunk + i, src + i, 4 * sizeof(int));
    }
    const float* frame = a.gray + b * a.gray_stride;
    const int step = a.aligned ? 4 : 1;
    for (int r = warp; r < ny0; r += kConeWarps) {
      const float* row = frame + static_cast<size_t>(y0 + r) * a.w0 + ax0;
      for (int c = lane * step; c < an; c += 32 * step) {
        if (a.aligned) {
          __pipeline_memcpy_async(&level[r * an + c], row + c,
                                  4 * sizeof(float));
        } else {
          __pipeline_memcpy_async(&level[r * an + c], row + c,
                                  sizeof(float));
        }
      }
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
  }
  __syncthreads();
  float* const out = a.buf + static_cast<size_t>(b) * a.n_pixels;
  // level 0: the part of the frame the cone owns, copied into the pyramid
  {
    const int* h = chunk;
    for (int y = h[2] + warp; y < h[3]; y += kConeWarps) {
      for (int x = h[6] + lane; x < h[7]; x += 32) {
        out[h[8] + y * h[9] + x] = level[(y - y0) * an + x - ax0];
      }
    }
  }
  // the levels above, each from the one below in shared memory
  const ResizeTap* lt = reinterpret_cast<const ResizeTap*>(chunk +
                                                           a.header_words);
  int ay0 = y0;
  for (int l = 1; l < a.n; ++l) {
    const int* h = chunk + kLevelWords * l;
    const int ly0 = h[0], ny = h[1] - ly0;
    const int lx0 = h[4], nx = h[5] - lx0;
    const ResizeTap* rt_l = lt;
    const ResizeTap* ct_l = lt + ny;
    lt += ny + nx;
    // row taps: a warp a row of the cone, a lane a column of the level
    // below, each sum rounded to float32
    for (int r = warp; r < ny; r += kConeWarps) {
      const ResizeTap rt = rt_l[r];
      const float* in = level + (rt.first - ay0) * an;
#pragma unroll 2
      for (int c = lane; c < an; c += 32) {
        float acc = 0.0f;
#pragma unroll
        for (int t = 0; t < kMaxTaps; ++t) {
          if (t < rt.count) acc = fmaf(rt.w[t], in[t * an + c], acc);
        }
        mid[r * an + c] = acc;
      }
    }
    __syncthreads();
    // column taps: a lane a column of the cone, a warp its rows; the
    // outputs the cone owns go to the pyramid
    const int oy0 = h[2], oy1 = h[3], ox0 = h[6], ox1 = h[7];
    float* const dst = out + h[8];
    const int width = h[9];
    for (int c = lane; c < nx; c += 32) {
      const ResizeTap ct = ct_l[c];
      const int x = lx0 + c;
      const bool own_x = x >= ox0 && x < ox1;
#pragma unroll 2
      for (int r = warp; r < ny; r += kConeWarps) {
        const float* in = mid + r * an + ct.first - ax0;
        float acc = 0.0f;
#pragma unroll
        for (int t = 0; t < kMaxTaps; ++t) {
          if (t < ct.count) acc = fmaf(in[t], ct.w[t], acc);
        }
        level[r * nx + c] = acc;
        const int y = ly0 + r;
        if (own_x && y >= oy0 && y < oy1) dst[y * width + x] = acc;
      }
    }
    __syncthreads();
    ay0 = ly0;
    ax0 = lx0;
    an = nx;
  }
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
// level l resized from level l - 1. rows is the host's level table; chunks
// (cone_rows x cone_cols, chunk_words) the device table of the cones'
// chunks (header_words of levels' ranges, then taps); level0 the host's
// (4, kConeMax) level-0 ranges; buf_floats and mid_floats the most floats
// of a cone's level and of its row sums (ops/image.py::pyramid_cones). One
// launch (*launches).
PSL_API int psl_pyramid_build(const float* gray, long long gray_stride,
                              float* buf, const int* rows, int n_levels,
                              int batch, const int* chunks, int chunk_words,
                              int header_words, int cone_rows, int cone_cols,
                              const int* level0, int buf_floats,
                              int mid_floats, int* launches,
                              cudaStream_t stream) {
  *launches = 0;
  PslLevels lv;
  if (!psl_levels_from_host(rows, nullptr, n_levels, &lv) || batch < 1 ||
      batch > 65535 || cone_rows < 1 || cone_rows > kConeMax ||
      cone_cols < 1 || cone_cols > kConeMax || chunk_words % 4 != 0 ||
      header_words < kLevelWords * lv.n || chunk_words < header_words ||
      buf_floats < 1 || mid_floats < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ConeArgs a;
  a.gray = gray;
  a.gray_stride = gray_stride;
  a.buf = buf;
  a.chunks = chunks;
  a.n = lv.n;
  a.n_pixels = lv.n_pixels;
  a.w0 = lv.w[0];
  a.chunk_words = chunk_words;
  a.header_words = header_words;
  a.cone_cols = cone_cols;
  a.buf_floats = buf_floats;
  a.mid_floats = mid_floats;
  a.aligned = lv.w[0] % 4 == 0 && gray_stride % 4 == 0 &&
              reinterpret_cast<uintptr_t>(gray) % 16 == 0;
  for (int q = 0; q < 4; ++q) {
    for (int k = 0; k < kConeMax; ++k) {
      a.range0[q][k] = level0[q * kConeMax + k];
    }
  }
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(chunk_words) + buf_floats +
                       mid_floats);
  if (smem > 48 * 1024) {
    const int err = psl_opt_in_smem(
        reinterpret_cast<const void*>(pyramid_cone_kernel), smem);
    if (err != 0) return err;
  }
  pyramid_cone_kernel<<<dim3(cone_rows * cone_cols, batch), kConeThreads,
                        smem, stream>>>(a);
  const int rc = static_cast<int>(cudaGetLastError());
  if (rc == 0) *launches = 1;
  return rc;
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
