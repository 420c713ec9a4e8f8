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
// per level in the JAX version. Here one launch blurs every level of the
// buffer: a block loads a 32 x 16 tile with its halo into shared memory
// (clamped coordinates = replicate borders), runs the vertical pass into a
// second shared tile (rounded to float32, as the JAX version's intermediate
// image is) and the horizontal pass from there. Each pass accumulates
// 0 + k0 x0 + k1 x1 + ... in that order with a separate multiply and add, so
// the result has the bits of the plain version: descriptor bits are
// comparisons of blurred values. The 5-tap blur of the line stage is the
// same kernel on a one-level table.
// Bound: bytes (each pixel read once and written once); 2 x ksize
// multiplies and adds per pixel.
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

constexpr int kBlurTileW = 32;
constexpr int kBlurTileH = 16;
constexpr int kBlurMaxTaps = 7;
constexpr int kBlurMaxR = kBlurMaxTaps / 2;

struct BlurTaps {
  float k[kBlurMaxTaps];
};

__global__ void gaussian_blur_kernel(const float* __restrict__ src,
                                     float* __restrict__ dst,
                                     const PslLevels lv, const BlurTaps taps,
                                     int ksize) {
  __shared__ float in[kBlurTileH + 2 * kBlurMaxR][kBlurTileW + 2 * kBlurMaxR];
  __shared__ float mid[kBlurTileH][kBlurTileW + 2 * kBlurMaxR];
  const int r = ksize / 2;
  const int l = psl_level_of(lv.blk_off, lv.n, blockIdx.x);
  const int h = lv.h[l];
  const int w = lv.w[l];
  const int blocks_x = (w + kBlurTileW - 1) / kBlurTileW;
  const int blk = blockIdx.x - lv.blk_off[l];
  const int x0 = (blk % blocks_x) * kBlurTileW;
  const int y0 = (blk / blocks_x) * kBlurTileH;
  const size_t base = static_cast<size_t>(blockIdx.y) * lv.n_pixels + lv.off[l];
  const float* s = src + base;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int n_threads = blockDim.x * blockDim.y;
  const int in_w = kBlurTileW + 2 * r;
  const int in_h = kBlurTileH + 2 * r;

  for (int i = tid; i < in_w * in_h; i += n_threads) {
    const int ty = i / in_w;
    const int tx = i % in_w;
    const int yy = psl_clamp(y0 + ty - r, 0, h - 1);
    const int xx = psl_clamp(x0 + tx - r, 0, w - 1);
    in[ty][tx] = s[yy * w + xx];
  }
  __syncthreads();
  // vertical pass at every column of the tile and its halo
  for (int i = tid; i < in_w * kBlurTileH; i += n_threads) {
    const int ty = i / in_w;
    const int tx = i % in_w;
    float acc = 0.0f;
    for (int t = 0; t < ksize; ++t) {
      acc = __fadd_rn(acc, __fmul_rn(taps.k[t], in[ty + t][tx]));
    }
    mid[ty][tx] = acc;
  }
  __syncthreads();
  const int x = x0 + threadIdx.x;
  const int y = y0 + threadIdx.y;
  if (x >= w || y >= h) return;
  float acc = 0.0f;
  for (int t = 0; t < ksize; ++t) {
    acc = __fadd_rn(acc, __fmul_rn(taps.k[t], mid[threadIdx.y][threadIdx.x + t]));
  }
  dst[base + y * w + x] = acc;
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
// host's level table; k0..k6 the taps (the first ksize are read), ksize odd.
PSL_API int psl_gaussian_blur(const float* src, float* dst, const int* rows,
                              int n_levels, int batch, int ksize, float k0,
                              float k1, float k2, float k3, float k4, float k5,
                              float k6, cudaStream_t stream) {
  PslLevels lv;
  if (!psl_levels_from_host(rows, nullptr, n_levels, &lv) || batch < 1 ||
      ksize < 1 || ksize > kBlurMaxTaps || ksize % 2 == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int l = 0; l < lv.n; ++l) {
    lv.blk_off[l + 1] = lv.blk_off[l] +
                        ((lv.w[l] + kBlurTileW - 1) / kBlurTileW) *
                            ((lv.h[l] + kBlurTileH - 1) / kBlurTileH);
  }
  const BlurTaps taps = {{k0, k1, k2, k3, k4, k5, k6}};
  const dim3 grid(lv.blk_off[lv.n], batch);
  gaussian_blur_kernel<<<grid, dim3(kBlurTileW, kBlurTileH), 0, stream>>>(
      src, dst, lv, taps, ksize);
  return static_cast<int>(cudaGetLastError());
}
