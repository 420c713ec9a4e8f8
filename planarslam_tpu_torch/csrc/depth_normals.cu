// K28 noise_alpha and K29 frame_normals: the per-frame depth stages outside
// plane segmentation, `batch` frames per launch (B = 1 on the streaming
// path).
//
// K28 replaces the depth-noise scale of planarslam_tpu/ops/planes.py::
// extract_planes (:243-254; the port's plain version is ops/planes.py::
// noise_alpha_plain): the absolute second difference
// |d - 2 d(x+1) + d(x+2)| / max(d, 1)^2 (columns wrapped) on the 4 x
// 4-strided grid, NaN where one of the three pixels fails the depth gate,
// then the median of the samples as jnp.nanmedian takes it (the mean of
// the two middle values, s[low] * lw + s[high] * hw in float32), over
// 0.674 sqrt(6), 0 when no sample is valid. Bound: latency (230 KB of
// depth read per frame, ~100 operations per sample; what costs is the
// chain of dependent selection passes and their barriers).
//
// One thread-block cluster of kAlphaCluster blocks per frame (the batch
// on the grid's y). Block r computes its contiguous share of the strided
// samples (19200 at 640x480) into its own shared memory as their float
// bits, with the invalid ones at 0xffffffff, above every finite value's
// bits; the samples are >= +0, so their bits order as their values. Rank
// lo is an exact radix select (11, 11 and 10 bits): each block counts its
// samples' digits by warp-aggregated integer atomics in shared memory and
// sums them into 64 coarse counts; after the cluster's barrier, warp 0 of
// every block merges the cluster's coarse counts through distributed
// shared memory (integers: exact in any order), scans them, then merges
// and scans the 32 (16) digits of the coarse count that holds the rank,
// so every block takes the same digit from the same counts while reading
// 3 KB of its peers' memory a pass, not their 8 KB of counts each. The
// first pass's upper half of digits holds only the invalid samples (the
// sign bit), so it also gives n. Rank hi = lo + 1 (n even) is read off
// the last pass's counts when it shares lo's first 22 bits; otherwise it
// is the smallest sample above lo's value, one integer-min pass merged
// across the cluster. A frame's samples must
// fit in the cluster's shared memory: at most kPslAlphaMaxSamples (421888,
// e.g. 2560x2560); past that the entry returns kPslErrAlphaSamples.
//
// K29 replaces the normal chain of planarslam_tpu/slam/frame.py (:53-63):
// box_smooth_depth (ops/planes.py:55-76), backproject_depth (:45-52), the
// surface_normals of the sampling stride (:79-170) and the padding to
// max_normals. Only the normals and their flags leave the chain, so each
// output sample computes the smoothed depths it reads, each a k x k
// zero-padded box mean of the raw depth with the keep rule: at a stride
// >= 2, those of the (2b + 2)^2 pixels around the sample (b = min(stride,
// 3), the wrapped rows and columns of the +-b taps and the right and lower
// neighbours of the (2b + 1)^2 jump window), at stride 1 the sample and its
// four neighbours. From them: the back-projection, the central-difference
// normal, its orientation, the crease and discontinuity guards and the
// subgrid border. Bound: latency (at 640x480, 1813 samples of 64 smoothed
// depths, 25 taps each, over 1.04 MB of distinct pixels).
//
// At a stride >= 2 one warp owns a sample, eight samples to a 256-thread
// block (256 blocks at 640x480): the warp stages the sample's (2b + 1 +
// k)^2 raw depths in shared memory once (two rows a step, zero outside
// the image), each lane sums the boxes of two of the (2b + 2)^2 smoothed
// depths from there (the taps unrolled for the configuration's k = 5),
// takes the 1-pixel jumps of one or two window pixels, a shuffle tree
// takes their max, and lane 0 finishes the sample. A sample whose window
// reaches past an image edge wraps its rows or columns (strides 2-5 put
// the first row and column there: off = stride / 2 < b), so its lanes read
// their boxes around the wrapped pixels from device memory instead, as
// every sample does when smooth_window is not the staged k = 5. Only
// the warp touches its sample's shared memory, so __syncwarp orders the
// phases. Stride 1 keeps one thread per pixel.
//
// The plain versions spell every product, cross product, dot and norm in
// a fixed order and this file is built with -fmad=false, so that every
// float is rounded where the plain version's separate PyTorch operations
// round it: a division by a Python number is PyTorch's product with the
// number's reciprocal taken in double and rounded to float32 (the wrapper
// passes it), the rest is IEEE (__fdiv_rn, __fsqrt_rn). The outputs equal
// the plain version's bit for bit; no atomics touch a float.
#include <math.h>

#include <cooperative_groups.h>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kAlphaCluster = 8;  // K28's blocks per frame
constexpr int kAlphaThreads = 512;
constexpr int kAlphaWarps = kAlphaThreads / 32;
constexpr int kAlphaLoads = 5;  // samples a thread loads before it stores
// a block's counts of the three passes, 2048 + 2048 + 1024 ints, ahead of
// its samples in dynamic shared memory
constexpr int kAlphaCounts = 5120;
// the dynamic shared memory a block may opt into, less 1 KB for the
// static arrays: at most kAlphaPerBlock samples a block
constexpr int kAlphaPerBlock = (232448 - 1024) / 4 - kAlphaCounts;
static_assert(kAlphaCluster * kAlphaPerBlock == kPslAlphaMaxSamples,
              "common.cuh's K28 limit");
constexpr int kNormalThreads = 128;   // stride 1: one thread per pixel
constexpr int kSamplesPerBlock = 8;   // stride >= 2: one warp per sample
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNoSample = 0xffffffffu;
constexpr unsigned kNoDigit = 0xffffffffu;
constexpr int kMaxSpan = 8;  // 2 b + 2 with b = min(stride, 3)
// the row of a staged patch, 2 b + 1 + kBox <= 12 wide, that a half-warp
// stages in one step
constexpr int kMaxPatch = 16;
// the box side a staged patch is summed for (the configuration's
// smooth_window); the samples of any other box read device memory
constexpr int kBox = 5;

// torch.clamp(x, min=lo): NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}

// torch.maximum / max_pool2d: NaN wins
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || isnan(a)) ? a : b;
}

// ((a0 b0 + a1 b1) + a2 b2), each product and sum rounded
__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a[0], b[0]), __fmul_rn(a[1], b[1])),
                   __fmul_rn(a[2], b[2]));
}

// (a1 b2 - a2 b1, a2 b0 - a0 b2, a0 b1 - a1 b0)
__device__ __forceinline__ void cross3(const float* a, const float* b,
                                       float* out) {
  out[0] = __fsub_rn(__fmul_rn(a[1], b[2]), __fmul_rn(a[2], b[1]));
  out[1] = __fsub_rn(__fmul_rn(a[2], b[0]), __fmul_rn(a[0], b[2]));
  out[2] = __fsub_rn(__fmul_rn(a[0], b[1]), __fmul_rn(a[1], b[0]));
}

__device__ __forceinline__ int wrap(int v, int n) {
  const int r = v % n;
  return r < 0 ? r + n : r;
}

// ---------------------------------------------------------------- K28 ---

// One strided sample's bits: |d0 - 2 d1 + d2| / max(d0, 1)^2 as the plain
// version rounds it, kNoSample where a pixel fails the depth gate.
__device__ __forceinline__ unsigned alpha_sample(float d0, float d1,
                                                 float d2,
                                                 float max_distance) {
  const bool ok = d0 > 1e-6f && d0 < max_distance && d1 > 1e-6f &&
                  d1 < max_distance && d2 > 1e-6f && d2 < max_distance;
  if (!ok) return kNoSample;
  const float z = clamp_min(d0, 1.0f);
  const float d2r = fabsf(__fadd_rn(__fsub_rn(d0, __fmul_rn(2.0f, d1)), d2));
  return __float_as_uint(__fdiv_rn(d2r, __fmul_rn(z, z)));
}

// This block's counts of the digit (u >> shift) & dmask of its samples
// whose bits under `mask` equal `pre`, into hist. Whole warps step
// together, so __match_any_sync sees every lane; one atomic per digit a
// warp holds.
__device__ __forceinline__ void count_digits(const unsigned* s, int m,
                                             unsigned pre, unsigned mask,
                                             int shift, unsigned dmask,
                                             int* hist) {
  const int lane = threadIdx.x & 31;
  for (int base = threadIdx.x - lane; base < m; base += kAlphaThreads) {
    const int i = base + lane;
    const unsigned u = i < m ? s[i] : 0u;
    const bool in = i < m && (u & mask) == pre;
    const unsigned digit = in ? (u >> shift) & dmask : kNoDigit;
    const unsigned peers = __match_any_sync(kFull, digit);
    if (in && lane == __ffs(peers) - 1) atomicAdd(&hist[digit], __popc(peers));
  }
}

// The coarse counts of one pass: thread t sums its kPer digits [kPer t,
// kPer t + kPer) of this block's counts, and eight lanes' sums make coarse
// count t / 8 (32 digits, 16 in the 10-bit pass). Run by the whole block
// after its counts are in.
template <int kPer>
__device__ __forceinline__ void coarse_counts(const int* hist, int* coarse) {
  int sum;
  if constexpr (kPer == 4) {
    const int4 v = reinterpret_cast<const int4*>(hist)[threadIdx.x];
    sum = v.x + v.y + v.z + v.w;
  } else {
    const int2 v = reinterpret_cast<const int2*>(hist)[threadIdx.x];
    sum = v.x + v.y;
  }
#pragma unroll
  for (int off = 1; off < 8; off <<= 1) {
    sum += __shfl_xor_sync(kFull, sum, off);
  }
  if ((threadIdx.x & 7) == 0) coarse[threadIdx.x >> 3] = sum;
}

// Warp-wide inclusive scan of v over the lanes.
__device__ __forceinline__ int warp_scan(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v += o;
  }
  return v;
}

// Lane l's coarse counts 2l and 2l + 1 of a pass, merged over the
// cluster (integers: exact in any order). Run by a whole warp after the
// cluster barrier of the pass.
__device__ __forceinline__ int2 merged_coarse(cg::cluster_group& cl,
                                              int* coarse) {
  const int lane = threadIdx.x & 31;
  int2 c = make_int2(0, 0);
#pragma unroll
  for (int r = 0; r < kAlphaCluster; ++r) {
    const int2 v =
        reinterpret_cast<const int2*>(cl.map_shared_rank(coarse, r))[lane];
    c.x += v.x;
    c.y += v.y;
  }
  return c;
}

// The digit of a pass that holds rank `want` (< the pass's total) and
// want's rank among its samples, from the merged coarse counts c (lane l:
// coarse counts 2l and 2l + 1) and the cluster's counts of the kFine
// digits of the coarse count that holds it. Run by a whole warp; every
// lane returns the same.
template <int kFine>
__device__ __forceinline__ void locate(cg::cluster_group& cl, int2 c,
                                       int* hist, int want, int* digit,
                                       int* rank) {
  const int lane = threadIdx.x & 31;
  const int incl = warp_scan(c.x + c.y), excl = incl - c.x - c.y;
  const int src = __ffs(__ballot_sync(kFull, want >= excl && want < incl)) - 1;
  const bool first = want < excl + c.x;
  const int cs = __shfl_sync(kFull, first ? 2 * lane : 2 * lane + 1, src);
  const int rem = __shfl_sync(
      kFull, first ? want - excl : want - excl - c.x, src);
  int f = 0;
  if (lane < kFine) {
#pragma unroll
    for (int r = 0; r < kAlphaCluster; ++r) {
      f += cl.map_shared_rank(hist, r)[cs * kFine + lane];
    }
  }
  const int fi = warp_scan(f), fe = fi - f;
  const int d = __ffs(__ballot_sync(kFull, rem >= fe && rem < fi)) - 1;
  *digit = cs * kFine + d;
  *rank = rem - __shfl_sync(kFull, fe, d);
}

struct AlphaShared {
  int coarse[3][64];   // each pass's coarse counts
  unsigned warp_min[kAlphaWarps];
  unsigned prefix;     // lo's digits chosen so far
  unsigned hi;         // s_hi when the last pass's counts hold it
  unsigned block_min;  // this block's smallest sample above s_lo
  int k;               // lo's rank among the samples under prefix
  int n;               // the frame's valid samples
  int lo, hi_rank;     // the ranks of the two middle samples
  float lw, hw;        // their weights
};

__global__ void __cluster_dims__(kAlphaCluster, 1, 1)
    __launch_bounds__(kAlphaThreads)
    noise_alpha_kernel(const float* __restrict__ depth, int h, int w,
                       float max_distance, float inv_mad,
                       float* __restrict__ alpha) {
  cg::cluster_group cl = cg::this_cluster();
  extern __shared__ __align__(16) int alpha_smem[];
  int* hist = alpha_smem;  // pass 0 [0, 2048), 1 [2048, 4096), 2 [4096, 5120)
  unsigned* s = reinterpret_cast<unsigned*>(alpha_smem + kAlphaCounts);
  __shared__ __align__(16) AlphaShared sh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q = static_cast<int>(cl.block_rank());
  const int hs = (h + 3) / 4, ws = (w + 3) / 4, n_s = hs * ws;
  const int per = (n_s + kAlphaCluster - 1) / kAlphaCluster;
  const int first = q * per, m = max(0, min(per, n_s - first));
  const float* d = depth + static_cast<size_t>(blockIdx.y) * h * w;
  for (int i = tid; i < kAlphaCounts; i += kAlphaThreads) hist[i] = 0;
  if (tid == 0) sh.hi = kNoSample;
  // sampling: this block's samples into shared memory, kAlphaLoads a
  // thread in flight before they are stored
  for (int j0 = tid; j0 < m; j0 += kAlphaLoads * kAlphaThreads) {
    float v[kAlphaLoads][3];
#pragma unroll
    for (int t = 0; t < kAlphaLoads; ++t) {
      const int j = j0 + t * kAlphaThreads;
      if (j < m) {
        const int i = first + j, r = i / ws;
        const float* row = d + static_cast<size_t>(r) * 4 * w;
        const int x = (i - r * ws) * 4;  // < w
        int x1 = x + 1, x2 = x + 2;      // the columns wrapped
        if (x1 >= w) x1 -= w;
        if (x2 >= w) x2 -= w;
        if (x2 >= w) x2 -= w;
        v[t][0] = row[x];
        v[t][1] = row[x1];
        v[t][2] = row[x2];
      }
    }
#pragma unroll
    for (int t = 0; t < kAlphaLoads; ++t) {
      const int j = j0 + t * kAlphaThreads;
      if (j < m) s[j] = alpha_sample(v[t][0], v[t][1], v[t][2], max_distance);
    }
  }
  __syncthreads();  // the counts zeroed, the samples stored
  // pass 0's counts: the top 11 bits, the invalid samples in digit 2047
  count_digits(s, m, 0u, 0u, 21, 2047u, hist);
  __syncthreads();
  coarse_counts<4>(hist, sh.coarse[0]);
  cl.sync();  // every block's counts of the pass
  // merge and pick: warp 0 merges the cluster's coarse counts, then those
  // of the 32 digits that hold rank lo; n from the last coarse count,
  // which holds only the invalid samples (digits >= 1024 have the sign)
  if (warp == 0) {
    const int2 c = merged_coarse(cl, sh.coarse[0]);
    const int n = n_s - __shfl_sync(kFull, c.y, 31);
    if (n > 0) {
      // lax_compat.nanmedian's ranks and weights, in float32
      const float nf = static_cast<float>(n);
      const float qf = __fmul_rn(0.5f, __fsub_rn(nf, 1.0f));
      const float lo_f = floorf(qf), hi_f = ceilf(qf);
      const float hw = __fsub_rn(qf, lo_f);
      const float last = __fsub_rn(nf, 1.0f);
      const int lo = static_cast<int>(clamp_min(fminf(lo_f, last), 0.0f));
      int digit, rank;
      locate<32>(cl, c, hist, lo, &digit, &rank);
      if (lane == 0) {
        sh.lo = lo;
        sh.hi_rank = static_cast<int>(clamp_min(fminf(hi_f, last), 0.0f));
        sh.hw = hw;
        sh.lw = __fsub_rn(1.0f, hw);
        sh.prefix = static_cast<unsigned>(digit) << 21;
        sh.k = rank;
      }
    }
    if (lane == 0) sh.n = n;
  }
  __syncthreads();
  if (sh.n == 0) {  // nanmedian of no sample is NaN, nan_to_num makes it 0
    if (q == 0 && tid == 0) alpha[blockIdx.y] = 0.0f;
    cl.sync();  // no block leaves while another reads its counts
    return;
  }
  // passes 1 and 2: the next 11 bits, then the last 10, of the samples
  // under lo's prefix
  unsigned pre = sh.prefix;
  count_digits(s, m, pre, 0xffe00000u, 10, 2047u, hist + 2048);
  __syncthreads();
  coarse_counts<4>(hist + 2048, sh.coarse[1]);
  cl.sync();
  if (warp == 0) {
    int digit, rank;
    locate<32>(cl, merged_coarse(cl, sh.coarse[1]), hist + 2048, sh.k,
               &digit, &rank);
    if (lane == 0) {
      sh.prefix = pre | (static_cast<unsigned>(digit) << 10);
      sh.k = rank;
    }
  }
  __syncthreads();
  pre = sh.prefix;
  count_digits(s, m, pre, 0xfffffc00u, 0, 1023u, hist + 4096);
  __syncthreads();
  coarse_counts<2>(hist + 4096, sh.coarse[2]);
  cl.sync();
  if (warp == 0) {
    const int2 c = merged_coarse(cl, sh.coarse[2]);
    const int want = sh.k;
    int digit, rank;
    locate<16>(cl, c, hist + 4096, want, &digit, &rank);
    const int total = __shfl_sync(kFull, warp_scan(c.x + c.y), 31);
    // rank hi among the samples under lo's first 22 bits, when they hold it
    unsigned s_hi = kNoSample;
    if (sh.hi_rank != sh.lo && want + 1 < total) {
      int digit2;
      locate<16>(cl, c, hist + 4096, want + 1, &digit2, &rank);
      s_hi = pre | static_cast<unsigned>(digit2);
    }
    if (lane == 0) {
      sh.prefix = pre | static_cast<unsigned>(digit);
      sh.hi = s_hi;
    }
  }
  __syncthreads();
  const unsigned s_lo = sh.prefix;
  unsigned s_hi = sh.hi_rank == sh.lo ? s_lo : sh.hi;
  // the neighbour step: rank hi lies above lo's first 22 bits, so its
  // value is the smallest sample above s_lo (a valid one: hi < n)
  if (s_hi == kNoSample) {
    unsigned mn = kNoSample;
    for (int j = tid; j < m; j += kAlphaThreads) {
      const unsigned u = s[j];
      if (u > s_lo && u < mn) mn = u;
    }
    mn = __reduce_min_sync(kFull, mn);
    if (lane == 0) sh.warp_min[warp] = mn;
    __syncthreads();
    if (tid == 0) {
      unsigned b = kNoSample;
      for (int x = 0; x < kAlphaWarps; ++x) b = min(b, sh.warp_min[x]);
      sh.block_min = b;
    }
    cl.sync();  // every block's minimum
    if (q == 0 && tid == 0) {
      for (int r = 0; r < kAlphaCluster; ++r) {
        s_hi = min(s_hi, *cl.map_shared_rank(&sh.block_min, r));
      }
    }
  }
  if (q == 0 && tid == 0) {
    const float med = __fadd_rn(__fmul_rn(__uint_as_float(s_lo), sh.lw),
                                __fmul_rn(__uint_as_float(s_hi), sh.hw));
    alpha[blockIdx.y] = __fmul_rn(med, inv_mad);
  }
  cl.sync();  // no block leaves while another reads its shared memory
}

// ---------------------------------------------------------------- K29 ---

struct NormalConsts {
  int h, w, stride, off, b, hs, ws, budget, k, k_lo, patch;
  float inv_fx, inv_fy, cx, cy;
};

// box_smooth_depth at one pixel: the k x k zero-padded box mean of the
// valid depths, kept where it stays within 3% of the raw depth
__device__ float smoothed(const float* __restrict__ d,
                          const NormalConsts& c, int y, int x) {
  const float z = d[static_cast<size_t>(y) * c.w + x];
  if (c.k <= 1) return z;
  float acc = 0.0f, cnt = 0.0f;
  for (int dy = 0; dy < c.k; ++dy) {
    const int py = y + dy - c.k_lo;
    for (int dx = 0; dx < c.k; ++dx) {
      const int px = x + dx - c.k_lo;
      float term = 0.0f, v = 0.0f;
      if (py >= 0 && py < c.h && px >= 0 && px < c.w) {
        const float e = d[static_cast<size_t>(py) * c.w + px];
        v = e > 1e-6f ? 1.0f : 0.0f;
        term = __fmul_rn(e, v);
      }
      acc = __fadd_rn(acc, term);
      cnt = __fadd_rn(cnt, v);
    }
  }
  const float mu = __fdiv_rn(acc, clamp_min(cnt, 1.0f));
  const bool keep =
      fabsf(__fsub_rn(z, mu)) < __fmul_rn(0.03f, clamp_min(z, 1.0f));
  return (z > 1e-6f && keep && cnt > 0.0f) ? mu : z;
}

// backproject_depth of a smoothed depth zs at pixel (y, x)
__device__ __forceinline__ void point_at(const NormalConsts& c, int y, int x,
                                         float zs, float* p) {
  p[0] = __fmul_rn(__fmul_rn(__fsub_rn(static_cast<float>(x), c.cx),
                             c.inv_fx),
                   zs);
  p[1] = __fmul_rn(__fmul_rn(__fsub_rn(static_cast<float>(y), c.cy),
                             c.inv_fy),
                   zs);
  p[2] = zs;
}

// the normal of the central differences dx = 0.5 (xp - xm), dy =
// 0.5 (yp - ym), unit and turned toward the camera; returns its norm
__device__ float oriented_normal(const float* xp, const float* xm,
                                 const float* yp, const float* ym,
                                 const float* p, float* n) {
  float dx[3], dy[3];
  for (int j = 0; j < 3; ++j) {
    dx[j] = __fmul_rn(0.5f, __fsub_rn(xp[j], xm[j]));
    dy[j] = __fmul_rn(0.5f, __fsub_rn(yp[j], ym[j]));
  }
  cross3(dx, dy, n);
  const float norm = __fsqrt_rn(__fadd_rn(dot3(n, n), 1e-18f));
  for (int j = 0; j < 3; ++j) n[j] = __fdiv_rn(n[j], norm);
  if (dot3(n, p) > 0.0f) {
    for (int j = 0; j < 3; ++j) n[j] = -n[j];
  }
  return norm;
}

// surface_normals at stride 1: every pixel, 1-pixel central differences
__device__ bool normal_full(const float* __restrict__ d,
                            const NormalConsts& c, int y, int x, float* n) {
  const int xr = wrap(x + 1, c.w), xl = wrap(x - 1, c.w);
  const int yd = wrap(y + 1, c.h), yu = wrap(y - 1, c.h);
  const float z = smoothed(d, c, y, x);
  const float zxp = smoothed(d, c, y, xr), zxm = smoothed(d, c, y, xl);
  const float zyp = smoothed(d, c, yd, x), zym = smoothed(d, c, yu, x);
  float p[3], xp[3], xm[3], yp[3], ym[3];
  point_at(c, y, x, z, p);
  point_at(c, y, xr, zxp, xp);
  point_at(c, y, xl, zxm, xm);
  point_at(c, yd, x, zyp, yp);
  point_at(c, yu, x, zym, ym);
  const float norm = oriented_normal(xp, xm, yp, ym, p, n);
  const float zn = __fmul_rn(__fmul_rn(__fmul_rn(zxp, zxm), zyp), zym);
  const float jump = max_nan(fabsf(__fsub_rn(zxp, zxm)),
                             fabsf(__fsub_rn(zyp, zym)));
  return z > 1e-6f && zn > 1e-12f && norm > 1e-9f &&
         jump < __fmul_rn(0.05f, clamp_min(z, 1.0f));
}

// smoothed() at pixel (r, q) of a staged sample's window: the patch holds
// the raw depths from row y - b - k_lo and column x - b - k_lo on, P to a
// row, 0 outside the image (which adds what smoothed() adds there: 0 * 0),
// for a box of kBox (the taps unrolled)
__device__ __forceinline__ float smoothed_staged(const float* patch, int P,
                                                 int r, int q) {
  constexpr int k_lo = (kBox - 1) / 2;
  const float z = patch[(r + k_lo) * P + q + k_lo];
  float acc = 0.0f, cnt = 0.0f;
#pragma unroll
  for (int dy = 0; dy < kBox; ++dy) {
    const float* row = patch + (r + dy) * P + q;
#pragma unroll
    for (int dx = 0; dx < kBox; ++dx) {
      const float e = row[dx];
      const float v = e > 1e-6f ? 1.0f : 0.0f;
      acc = __fadd_rn(acc, __fmul_rn(e, v));
      cnt = __fadd_rn(cnt, v);
    }
  }
  const float mu = __fdiv_rn(acc, clamp_min(cnt, 1.0f));
  const bool keep =
      fabsf(__fsub_rn(z, mu)) < __fmul_rn(0.03f, clamp_min(z, 1.0f));
  return (z > 1e-6f && keep && cnt > 0.0f) ? mu : z;
}

// surface_normals at a stride >= 2 after the jump scan, at subgrid sample
// (sy, sx): the +-b taps, the normal, the crease guard, the border rule;
// zs holds the smoothed depths of rows y-b..y+b+1 and columns x-b..x+b+1
// (wrapped), 2 b + 2 to a row, jmax the max of the window's jumps
__device__ bool strided_tail(const NormalConsts& c, int sy, int sx,
                             const float* zs, float jmax, float* n) {
  const int b = c.b, span = 2 * b + 2;
  const int y = c.off + sy * c.stride, x = c.off + sx * c.stride;
  float p[3], xp[3], xm[3], yp[3], ym[3];
  point_at(c, y, x, zs[b * span + b], p);
  point_at(c, y, wrap(x + b, c.w), zs[b * span + 2 * b], xp);
  point_at(c, y, wrap(x - b, c.w), zs[b * span], xm);
  point_at(c, wrap(y + b, c.h), x, zs[2 * b * span + b], yp);
  point_at(c, wrap(y - b, c.h), x, zs[b], ym);
  const bool disc_free = jmax < __fmul_rn(0.05f, clamp_min(p[2], 1.0f));
  const float norm = oriented_normal(xp, xm, yp, ym, p, n);
  // crease guard: the one-sided normals agree within 45 degrees
  float a[3], e[3], f[3], g[3], nf[3], nb[3];
  for (int j = 0; j < 3; ++j) {
    a[j] = __fsub_rn(xp[j], p[j]);
    e[j] = __fsub_rn(yp[j], p[j]);
    f[j] = __fsub_rn(p[j], xm[j]);
    g[j] = __fsub_rn(p[j], ym[j]);
  }
  cross3(a, e, nf);
  cross3(f, g, nb);
  const float nf_n = __fsqrt_rn(__fadd_rn(dot3(nf, nf), 1e-18f));
  const float nb_n = __fsqrt_rn(__fadd_rn(dot3(nb, nb), 1e-18f));
  const bool agree = __fdiv_rn(dot3(nf, nb), __fmul_rn(nf_n, nb_n)) > 0.7071f;
  const float zn =
      __fmul_rn(__fmul_rn(__fmul_rn(xp[2], xm[2]), yp[2]), ym[2]);
  const bool border = sy > 0 && sy < c.hs - 1 && sx > 0 && sx < c.ws - 1;
  return p[2] > 1e-6f && zn > 1e-12f && norm > 1e-9f && disc_free &&
         agree && border;
}

// stride 1: one thread per output row
__global__ void frame_normals_full_kernel(const float* __restrict__ depth,
                                          NormalConsts c,
                                          float* __restrict__ normals,
                                          unsigned char* __restrict__ valid) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= c.budget) return;
  const float* d = depth + static_cast<size_t>(blockIdx.y) * c.h * c.w;
  const size_t o = static_cast<size_t>(blockIdx.y) * c.budget + i;
  float n[3] = {0.0f, 0.0f, 0.0f};
  bool ok = false;
  if (i < c.hs * c.ws) {  // rows past the grid stay zero and False
    ok = normal_full(d, c, i / c.ws, i % c.ws, n);
  }
  normals[3 * o] = n[0];
  normals[3 * o + 1] = n[1];
  normals[3 * o + 2] = n[2];
  valid[o] = ok ? 1 : 0;
}

// stride >= 2: one warp per output row
__global__ void __launch_bounds__(kSamplesPerBlock * 32)
    frame_normals_strided_kernel(const float* __restrict__ depth,
                                 NormalConsts c,
                                 float* __restrict__ normals,
                                 unsigned char* __restrict__ valid) {
  __shared__ float s_patch[kSamplesPerBlock][kMaxPatch * kMaxPatch];
  __shared__ float s_zs[kSamplesPerBlock][kMaxSpan * kMaxSpan];
  const int g = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * kSamplesPerBlock + g;
  if (i >= c.budget) return;  // the whole warp
  const size_t o = static_cast<size_t>(blockIdx.y) * c.budget + i;
  if (i >= c.hs * c.ws) {  // rows past the grid stay zero and False
    if (lane < 3) normals[3 * o + lane] = 0.0f;
    if (lane == 0) valid[o] = 0;
    return;
  }
  const float* d = depth + static_cast<size_t>(blockIdx.y) * c.h * c.w;
  const int b = c.b, span = 2 * b + 2, win = 2 * b + 1, P = c.patch;
  const int sy = i / c.ws, sx = i % c.ws;
  const int y = c.off + sy * c.stride, x = c.off + sx * c.stride;
  float* patch = s_patch[g];
  float* zs = s_zs[g];
  const bool staged =
      P > 0 && y >= b && y + b + 1 < c.h && x >= b && x + b + 1 < c.w;
  // staging: the raw patch of a window inside the image, read once
  if (staged) {
    // half-warp h stages rows h, h + 2, ...: lane l column l & 15 (all the
    // loads in flight at once, no division)
    const int y0 = y - b - c.k_lo, px = x - b - c.k_lo + (lane & 15);
    const bool col_in = (lane & 15) < P && px >= 0 && px < c.w;
    float v[kMaxPatch / 2];
#pragma unroll
    for (int step = 0; step < kMaxPatch / 2; ++step) {
      const int r = 2 * step + (lane >> 4), py = y0 + r;
      v[step] = (r < P && col_in && py >= 0 && py < c.h)
                    ? d[static_cast<size_t>(py) * c.w + px]
                    : 0.0f;
    }
#pragma unroll
    for (int step = 0; step < kMaxPatch / 2; ++step) {
      const int r = 2 * step + (lane >> 4);
      if (r < P && (lane & 15) < P) patch[r * P + (lane & 15)] = v[step];
    }
  }
  __syncwarp();
  // box sums: lane l the smoothed depths of window pixels l and l + 32
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int t = lane + 32 * half;
    if (t < span * span) {
      const int r = t / span, q = t % span;
      zs[t] = staged ? smoothed_staged(patch, P, r, q)
                     : smoothed(d, c, wrap(y - b + r, c.h),
                                wrap(x - b + q, c.w));
    }
  }
  __syncwarp();
  // jump scan: the 1-pixel jumps (right and lower neighbour, wrapped) of
  // the window's pixels inside the image, their max (NaN wins, -inf where
  // none) by a shuffle tree: max_nan gives the same NaN-or-max in any order
  float jmax = -INFINITY;
  for (int t = lane; t < win * win; t += 32) {
    const int r = t / win, q = t % win;
    const int yy = y - b + r, xx = x - b + q;
    if (yy >= 0 && yy < c.h && xx >= 0 && xx < c.w) {
      const float z0 = zs[r * span + q];
      jmax = max_nan(jmax,
                     max_nan(fabsf(__fsub_rn(z0, zs[r * span + q + 1])),
                             fabsf(__fsub_rn(z0, zs[(r + 1) * span + q]))));
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    jmax = max_nan(jmax, __shfl_xor_sync(kFull, jmax, off));
  }
  // the sample's tail, by lane 0
  if (lane == 0) {
    float n[3];
    const bool ok = strided_tail(c, sy, sx, zs, jmax, n);
    normals[3 * o] = n[0];
    normals[3 * o + 1] = n[1];
    normals[3 * o + 2] = n[2];
    valid[o] = ok ? 1 : 0;
  }
}

}  // namespace

PSL_API int psl_noise_alpha(const float* depth, int h, int w, int batch,
                            float max_distance, float inv_mad, float* alpha,
                            cudaStream_t stream) {
  if (batch < 0 || batch > 65535 || h < 0 || w < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0 || h == 0 || w == 0) return 0;
  const long long n_s = static_cast<long long>((h + 3) / 4) * ((w + 3) / 4);
  if (n_s > kPslAlphaMaxSamples) return kPslErrAlphaSamples;
  const int per = static_cast<int>((n_s + kAlphaCluster - 1) / kAlphaCluster);
  const int smem = 4 * (kAlphaCounts + per);
  const int rc = psl_opt_in_smem(
      reinterpret_cast<const void*>(noise_alpha_kernel), smem);
  if (rc != 0) return rc;
  noise_alpha_kernel<<<dim3(kAlphaCluster, batch), kAlphaThreads, smem,
                       stream>>>(depth, h, w, max_distance, inv_mad, alpha);
  return static_cast<int>(cudaGetLastError());
}

PSL_API int psl_frame_normals(const float* depth, int h, int w, int batch,
                              int stride, int budget, int smooth_window,
                              float inv_fx, float inv_fy, float cx, float cy,
                              float* normals, unsigned char* valid,
                              cudaStream_t stream) {
  if (batch > 0 && budget > 0) {
    NormalConsts c;
    c.h = h;
    c.w = w;
    c.stride = stride;
    c.b = stride < 3 ? stride : 3;
    if (stride <= 1) {
      c.off = 0;
      c.hs = h;
      c.ws = w;
    } else {
      c.off = stride / 2;
      c.hs = c.off < h ? (h - c.off + stride - 1) / stride : 0;
      c.ws = c.off < w ? (w - c.off + stride - 1) / stride : 0;
    }
    c.budget = budget;
    c.k = smooth_window;
    c.k_lo = (smooth_window - 1) / 2;
    c.inv_fx = inv_fx;
    c.inv_fy = inv_fy;
    c.cx = cx;
    c.cy = cy;
    if (stride <= 1) {
      c.patch = 0;
      const dim3 grid((budget + kNormalThreads - 1) / kNormalThreads, batch);
      frame_normals_full_kernel<<<grid, kNormalThreads, 0, stream>>>(
          depth, c, normals, valid);
    } else {
      c.patch = smooth_window == kBox ? 2 * c.b + 1 + kBox : 0;
      const dim3 grid((budget + kSamplesPerBlock - 1) / kSamplesPerBlock,
                      batch);
      frame_normals_strided_kernel<<<grid, kSamplesPerBlock * 32, 0,
                                     stream>>>(depth, c, normals, valid);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
