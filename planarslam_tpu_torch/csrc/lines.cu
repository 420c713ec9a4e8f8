// K20 detect_lines and K21 line_descriptors: the line front end of a frame
// after its 5-tap blur (K17), `batch` frames per call.
//
// K20 replaces planarslam_tpu/ops/lines.py::detect_lines, the jitted
// program from the Sobel gradients to the ranked segments (the port's plain
// version is ops/lines.py::detect_lines_plain). One C call issues nine
// launches:
//   1. gradients: Sobel with replicate borders and the magnitude;
//   2. edges: the direction quantized to 4, non-maximum suppression along
//      it against neighbours that wrap around the image (torch.roll), the
//      threshold; the edge score is the magnitude or 0;
//   3. top-E, one block per frame: a radix select on the float bits (the
//      scores are >= 0, so their bits order as their values) finds the E-th
//      largest score T; the pixels above T and the first pixels equal to T
//      are compacted in pixel order;
//   4. slots: a selected pixel's slot is its rank, value descending and ties
//      to the lower pixel (lax_compat.top_k's order), counted without a sort
//      or an atomic; each slot gets its orientation bin, rho and Hough bin;
//   5. Hough order: the slots ranked by (bin, slot), by counting;
//   6. Hough votes: each bin sums its slots in slot order (segment_sum's
//      order on the CPU);
//   7. peaks, one block per frame: the 3 x 3 maximum with theta wrapped and
//      -inf beyond the rho range, the top L peak scores by counting (ties to
//      the lower bin) and, with fewer than L nonzero peaks, the first
//      zero-valued bins in bin order, as the stable sort leaves them;
//   8. lines, one block per line: the support test over the E slots, the
//      96-bin position histogram (each bin in slot order), the gap fill
//      (wrapping), the longest run (first maximum), extent and response
//      (one warp: each lane's slots in slot order, the lanes folded by a
//      shuffle tree);
//   9. the top L by response (-1 for invalid lines, ties to the lower line),
//      the keep_top mask, angle mod pi and the normalized line equation.
// Every other float operation is the plain version's PyTorch operation on
// the card, in its order: a division by a Python number is a multiplication
// by its float32 reciprocal (PyTorch's CUDA division by a CPU scalar), the
// cross product forms its third term with one fused multiply-add as
// torch.linalg.cross does, accurate atan2f / sinf / cosf / sqrtf, and the
// source builds with -fmad=false. So the gradients, the edge slots and every
// quantity that does not pass through a sum are the plain version's bits.
// The three sums (Hough votes, histogram, response) are fixed orders of
// their own: PyTorch's accumulating index_put_ and row sum on the card
// reduce in orders of their own, so these agree with the plain version to
// float rounding, and a decision taken on a sum (a peak, an occupied bin,
// the order by response) can differ only where the plain values lie within
// that rounding of each other or of the threshold.
// Bound: bytes (the blurred frame read, the gradients and the scratch
// score written and read, ~6 MB for 640x480). The ranking passes (E^2 / 2
// comparisons for E = 6144) and the one-block select are latency.
//
// K21 replaces planarslam_tpu/ops/lines.py::line_descriptors: one block per
// line samples K20's gradients bilinearly (bilinear_sample's clamping) at 9
// bands x 24 points, splits the parallel and perpendicular parts into their
// positive and negative halves, and takes each half's mean and population
// deviation per band: 72 numbers, L2-normalized, times validity. The sums
// run in index order (the plain version's torch.mean / std reduce in
// PyTorch's own order: the two agree to float rounding).
// Bound: latency (64 lines x 216 samples of two gathers).
#include "common.cuh"

namespace {

constexpr int kNTheta = 36;
constexpr int kSBins = 96;
constexpr int kThreads = 256;
constexpr int kSelectThreads = 1024;
constexpr int kPeakThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

// Float32 constants of the plain version, each as PyTorch forms it on the
// card from a Python number.
struct DetectConsts {
  float pi;              // float(pi)
  float half_pi;         // float(pi / 2)
  float inv_quarter_pi;  // x / (pi / 4) is x * (1 / float(pi / 4))
  float inv_pi;          // x / pi
  float inv_n_theta;     // x / 36
  float inv_two_diag;    // x / (2 diag)
  float diag;            // float(hypot(h, w))
  float grad_threshold;
  float min_length;
};

struct Scratch {
  float* mag;          // (B, HW)
  float* score;        // (B, HW)
  int* sel_pix;        // (B, E) the selected pixels in pixel order
  float* sel_val;      // (B, E)
  int* slot_pix;       // (B, E) by slot (rank)
  float* slot_mag;     // (B, E)
  int* slot_t;         // (B, E)
  float* slot_rho;     // (B, E)
  int* slot_bin;       // (B, E)
  int* hough_order;    // (B, E) slots sorted by (bin, slot)
  float* hough;        // (B, 36 n_rho)
  float* top_val;      // (B, L)
  int* top_idx;        // (B, L)
  float* line_f;       // (B, L, 6): uv_s, uv_e, response, theta
  int* line_valid;     // (B, L)
};

Scratch carve(void* base, int hw, int batch, int E, int L, int n_bins) {
  Scratch s;
  float* p = static_cast<float*>(base);
  auto take = [&](size_t words) {
    float* q = p;
    p += words;
    return q;
  };
  const size_t b = static_cast<size_t>(batch);
  s.mag = take(b * hw);
  s.score = take(b * hw);
  s.sel_pix = reinterpret_cast<int*>(take(b * E));
  s.sel_val = take(b * E);
  s.slot_pix = reinterpret_cast<int*>(take(b * E));
  s.slot_mag = take(b * E);
  s.slot_t = reinterpret_cast<int*>(take(b * E));
  s.slot_rho = take(b * E);
  s.slot_bin = reinterpret_cast<int*>(take(b * E));
  s.hough_order = reinterpret_cast<int*>(take(b * E));
  s.hough = take(b * n_bins);
  s.top_val = take(b * L);
  s.top_idx = reinterpret_cast<int*>(take(b * L));
  s.line_f = take(b * L * 6);
  s.line_valid = reinterpret_cast<int*>(take(b * L));
  return s;
}

size_t scratch_words(int hw, int batch, int E, int L, int n_bins) {
  return static_cast<size_t>(batch) *
         (2 * static_cast<size_t>(hw) + 9 * static_cast<size_t>(E) +
          n_bins + 9 * static_cast<size_t>(L));
}

// lax_compat.mod: fmod, then shifted into the divisor's sign
__device__ __forceinline__ float mod_pos(float x, float y) {
  const float r = fmodf(x, y);
  return (r != 0.0f && r < 0.0f) ? __fadd_rn(r, y) : r;
}

// torch.clamp of a float: NaN passes through
__device__ __forceinline__ float clamp_nan(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}

// image.sobel_gradients at (y, x): separable shift-and-add from a zero
// accumulator, replicate borders
__device__ __forceinline__ void sobel_at(const float* img, int h, int w,
                                         int y, int x, float* gx,
                                         float* gy) {
  const int ym = max(y - 1, 0), yp = min(y + 1, h - 1);
  const int xm = max(x - 1, 0), xp = min(x + 1, w - 1);
  auto smooth_y = [&](int c) {
    float a = __fadd_rn(0.0f, img[ym * w + c]);
    a = __fadd_rn(a, __fmul_rn(2.0f, img[y * w + c]));
    return __fadd_rn(a, img[yp * w + c]);
  };
  auto smooth_x = [&](int r) {
    float a = __fadd_rn(0.0f, img[r * w + xm]);
    a = __fadd_rn(a, __fmul_rn(2.0f, img[r * w + x]));
    return __fadd_rn(a, img[r * w + xp]);
  };
  *gx = __fadd_rn(__fadd_rn(0.0f, -smooth_y(xm)), smooth_y(xp));
  *gy = __fadd_rn(__fadd_rn(0.0f, -smooth_x(ym)), smooth_x(yp));
}

__global__ void lines_gradient_kernel(
    const float* __restrict__ blur, int h, int w, float* __restrict__ gx_out,
    float* __restrict__ gy_out, float* __restrict__ mag_out) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;
  const size_t plane = static_cast<size_t>(blockIdx.z) * h * w;
  float gx, gy;
  sobel_at(blur + plane, h, w, y, x, &gx, &gy);
  const size_t i = plane + static_cast<size_t>(y) * w + x;
  gx_out[i] = gx;
  gy_out[i] = gy;
  mag_out[i] = sqrtf(__fadd_rn(__fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy)),
                               1e-12f));
}

__global__ void lines_edge_kernel(
    const float* __restrict__ gx_in, const float* __restrict__ gy_in,
    const float* __restrict__ mag, int h, int w, DetectConsts k,
    float* __restrict__ score) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;
  const size_t plane = static_cast<size_t>(blockIdx.z) * h * w;
  const size_t i = plane + static_cast<size_t>(y) * w + x;
  const float m = mag[i];
  const float ang = atan2f(gy_in[i], gx_in[i]);
  int q = static_cast<int>(rintf(__fmul_rn(ang, k.inv_quarter_pi))) % 4;
  if (q < 0) q += 4;
  // (dy, dx) per quantized direction; roll(a, -d)[i] = a[i + d] wrapped
  const int dys[4] = {0, 1, 1, 1};
  const int dxs[4] = {1, 1, 0, -1};
  const int dy = dys[q], dx = dxs[q];
  const float fwd = mag[plane + static_cast<size_t>((y + dy + h) % h) * w +
                        (x + dx + w) % w];
  const float bwd = mag[plane + static_cast<size_t>((y - dy + h) % h) * w +
                        (x - dx + w) % w];
  const bool edge = m >= fwd && m >= bwd && m > k.grad_threshold;
  score[i] = edge ? m : 0.0f;
}

// The k-th largest (1-based) of the scores whose bits match prefix on
// prefix_mask, one radix digit at a time; run by the whole block.
__device__ void radix_digit(const unsigned* bits, int n, int shift,
                            int n_digits, unsigned* prefix,
                            unsigned* prefix_mask, int* k, int* hist) {
  const unsigned digit_mask = static_cast<unsigned>(n_digits - 1);
  for (int d = threadIdx.x; d < n_digits; d += blockDim.x) hist[d] = 0;
  __syncthreads();
  const unsigned pre = *prefix, pm = *prefix_mask;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const unsigned u = bits[i];
    if ((u & pm) == pre) atomicAdd(&hist[(u >> shift) & digit_mask], 1);
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    // lane l sums the l-th group of digits from the top
    const int lane = threadIdx.x;
    const int per = n_digits / 32;
    const int top = n_digits - lane * per;
    int sum = 0;
    for (int d = top - 1; d >= top - per; --d) sum += hist[d];
    int incl = sum;
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += o;
    }
    const int want = *k;
    const unsigned hit = __ballot_sync(kFull, incl >= want);
    if (lane == __ffs(hit) - 1) {
      int cum = incl - sum;
      for (int d = top - 1; d >= top - per; --d) {
        if (cum + hist[d] >= want) {
          *k = want - cum;
          *prefix = pre | (static_cast<unsigned>(d) << shift);
          *prefix_mask = pm | (digit_mask << shift);
          break;
        }
        cum += hist[d];
      }
    }
  }
  __syncthreads();
}

// One block per frame: the E best scores' pixels in pixel order.
__global__ void lines_select_kernel(
    const float* __restrict__ score, int n, int E, int* __restrict__ sel_pix,
    float* __restrict__ sel_val) {
  __shared__ int hist[2048];
  __shared__ unsigned prefix, prefix_mask;
  __shared__ int k;
  __shared__ int warp_gt[32], warp_eq[32], eq_before[32], sel_before[32];
  const unsigned* bits = reinterpret_cast<const unsigned*>(
      score + static_cast<size_t>(blockIdx.x) * n);
  if (threadIdx.x == 0) {
    prefix = 0;
    prefix_mask = 0;
    k = E;
  }
  __syncthreads();
  radix_digit(bits, n, 21, 2048, &prefix, &prefix_mask, &k, hist);
  radix_digit(bits, n, 10, 2048, &prefix, &prefix_mask, &k, hist);
  radix_digit(bits, n, 0, 1024, &prefix, &prefix_mask, &k, hist);
  const unsigned t = prefix;  // the E-th largest score's bits
  const int take_eq = k;      // how many scores equal to it are taken
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  const int seg = (n + n_warps - 1) / n_warps;
  const int lo = min(n, warp * seg), hi = min(n, lo + seg);
  const unsigned lt = (1u << lane) - 1;
  int gt = 0, eq = 0;
  for (int base = lo; base < hi; base += 32) {
    const int i = base + lane;
    const unsigned u = i < hi ? bits[i] : 0u;
    gt += __popc(__ballot_sync(kFull, i < hi && u > t));
    eq += __popc(__ballot_sync(kFull, i < hi && u == t));
  }
  if (lane == 0) {
    warp_gt[warp] = gt;
    warp_eq[warp] = eq;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int eb = 0, sb = 0;
    for (int w = 0; w < n_warps; ++w) {
      eq_before[w] = eb;
      sel_before[w] = sb;
      sb += warp_gt[w] + max(0, min(take_eq - eb, warp_eq[w]));
      eb += warp_eq[w];
    }
  }
  __syncthreads();
  int eq_run = eq_before[warp], sel_run = sel_before[warp];
  const size_t out0 = static_cast<size_t>(blockIdx.x) * E;
  for (int base = lo; base < hi; base += 32) {
    const int i = base + lane;
    const unsigned u = i < hi ? bits[i] : 0u;
    const bool is_eq = i < hi && u == t;
    const unsigned eq_mask = __ballot_sync(kFull, is_eq);
    const bool take = (i < hi && u > t) ||
                      (is_eq && eq_run + __popc(eq_mask & lt) < take_eq);
    const unsigned take_mask = __ballot_sync(kFull, take);
    if (take) {
      const size_t o = out0 + sel_run + __popc(take_mask & lt);
      sel_pix[o] = i;
      sel_val[o] = __uint_as_float(u);
    }
    eq_run += __popc(eq_mask);
    sel_run += __popc(take_mask);
  }
}

// Slot = rank among the selected scores (value descending, ties to the
// lower pixel: the list is in pixel order); the slot's geometry. Also zeros
// the Hough accumulator.
__global__ void lines_slot_kernel(
    const int* __restrict__ sel_pix, const float* __restrict__ sel_val,
    const float* __restrict__ gx_in, const float* __restrict__ gy_in, int h,
    int w, int E, int n_rho, DetectConsts k, int* __restrict__ slot_pix,
    float* __restrict__ slot_mag, int* __restrict__ slot_t,
    float* __restrict__ slot_rho, int* __restrict__ slot_bin,
    float* __restrict__ hough) {
  extern __shared__ float vals[];
  const int b = blockIdx.y;
  const size_t e0 = static_cast<size_t>(b) * E;
  for (int j = threadIdx.x; j < E; j += blockDim.x) vals[j] = sel_val[e0 + j];
  const int n_bins = kNTheta * n_rho;
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < n_bins;
       j += gridDim.x * blockDim.x) {
    hough[static_cast<size_t>(b) * n_bins + j] = 0.0f;
  }
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= E) return;
  const float v = vals[i];
  int rank = 0;
  for (int j = 0; j < E; ++j) {
    const float o = vals[j];
    rank += (o > v || (o == v && j < i)) ? 1 : 0;
  }
  const int pix = sel_pix[e0 + i];
  const size_t g = static_cast<size_t>(b) * h * w + pix;
  const float ang = atan2f(gy_in[g], gx_in[g]);
  const float theta = mod_pos(__fadd_rn(ang, k.half_pi), k.pi);
  const int t_bin = psl_clamp(
      static_cast<int>(__fmul_rn(__fmul_rn(theta, 36.0f), k.inv_pi)), 0,
      kNTheta - 1);
  const float n_ang = __fadd_rn(theta, k.half_pi);
  const float uu = static_cast<float>(pix % w);
  const float vv = static_cast<float>(pix / w);
  const float rho = __fadd_rn(__fmul_rn(uu, cosf(n_ang)),
                              __fmul_rn(vv, sinf(n_ang)));
  const int r_bin = psl_clamp(
      static_cast<int>(__fmul_rn(__fadd_rn(rho, k.diag), 0.5f)), 0,
      n_rho - 1);
  const size_t s = e0 + rank;
  slot_pix[s] = pix;
  slot_mag[s] = v;
  slot_t[s] = t_bin;
  slot_rho[s] = rho;
  slot_bin[s] = t_bin * n_rho + r_bin;
}

// The slots ranked by (Hough bin, slot), by counting: each bin's slots
// then lie together in slot order.
__global__ void lines_hough_order_kernel(
    const int* __restrict__ slot_bin, int E, int* __restrict__ order) {
  extern __shared__ int keys[];
  const size_t e0 = static_cast<size_t>(blockIdx.y) * E;
  for (int j = threadIdx.x; j < E; j += blockDim.x) {
    keys[j] = slot_bin[e0 + j] * 8192 + j;
  }
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= E) return;
  const int key = keys[i];
  int rank = 0;
  for (int j = 0; j < E; ++j) rank += keys[j] < key ? 1 : 0;
  order[e0 + rank] = i;
}

// One thread per run of equal bins in the order: the bin's vote, its slots
// added in slot order.
__global__ void lines_hough_sum_kernel(
    const int* __restrict__ order, const int* __restrict__ slot_bin,
    const float* __restrict__ slot_mag, int E, int n_bins,
    float* __restrict__ hough) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= E) return;
  const size_t e0 = static_cast<size_t>(blockIdx.y) * E;
  const int* o = order + e0;
  const int bin = slot_bin[e0 + o[r]];
  if (r > 0 && slot_bin[e0 + o[r - 1]] == bin) return;
  int n = 1;
  while (r + n < E && slot_bin[e0 + o[r + n]] == bin) ++n;
  // the value of a slot that is not an edge is its score, 0
  float sum = 0.0f;
  for (int i = 0; i < n; ++i) sum = __fadd_rn(sum, slot_mag[e0 + o[r + i]]);
  hough[static_cast<size_t>(blockIdx.y) * n_bins + bin] = sum;
}

// where(hough >= its 3 x 3 maximum, hough, 0) with theta wrapped and rho
// padded with -inf (max_pool2d's padding)
__device__ float peak_score(const float* hough, int n_rho, int bin) {
  const int t = bin / n_rho, r = bin % n_rho;
  const float hv = hough[bin];
  float m = -INFINITY;
  for (int dt = -1; dt <= 1; ++dt) {
    const int tt = (t + dt + kNTheta) % kNTheta;
    for (int dr = -1; dr <= 1; ++dr) {
      const int rr = r + dr;
      if (rr >= 0 && rr < n_rho) m = fmaxf(m, hough[tt * n_rho + rr]);
    }
  }
  return hv >= m ? hv : 0.0f;
}

__global__ void lines_peaks_kernel(
    const float* __restrict__ hough_all, int n_rho, int L, int E,
    float* __restrict__ top_val, int* __restrict__ top_idx) {
  extern __shared__ float peak_v[];
  int* peak_i = reinterpret_cast<int*>(peak_v + E);
  __shared__ int count, filled;
  __shared__ int warp_n[kPeakThreads / 32], warp_before[kPeakThreads / 32];
  const int n_bins = kNTheta * n_rho;
  const float* hough = hough_all + static_cast<size_t>(blockIdx.x) * n_bins;
  float* tv = top_val + static_cast<size_t>(blockIdx.x) * L;
  int* ti = top_idx + static_cast<size_t>(blockIdx.x) * L;
  if (threadIdx.x == 0) {
    count = 0;
    filled = 0;
  }
  __syncthreads();
  // a nonzero peak's bin has a vote: at most E of them
  for (int bin = threadIdx.x; bin < n_bins; bin += blockDim.x) {
    const float ps = peak_score(hough, n_rho, bin);
    if (ps > 0.0f) {
      const int j = atomicAdd(&count, 1);
      peak_v[j] = ps;
      peak_i[j] = bin;
    }
  }
  __syncthreads();
  const int n = count;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float v = peak_v[i];
    const int bi = peak_i[i];
    int rank = 0;
    for (int j = 0; j < n && rank < L; ++j) {
      const float o = peak_v[j];
      rank += (o > v || (o == v && peak_i[j] < bi)) ? 1 : 0;
    }
    if (rank < L) {
      tv[rank] = v;
      ti[rank] = bi;
    }
  }
  if (n >= L) return;
  // the rest of the L picks: the zero-valued bins in bin order
  const int need = L - n;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  for (int base = 0; base < n_bins; base += blockDim.x) {
    const int bin = base + threadIdx.x;
    const bool zero = bin < n_bins && !(peak_score(hough, n_rho, bin) > 0.0f);
    const unsigned mask = __ballot_sync(kFull, zero);
    if (lane == 0) warp_n[warp] = __popc(mask);
    __syncthreads();
    if (threadIdx.x == 0) {
      int s = 0;
      for (int w = 0; w < n_warps; ++w) {
        warp_before[w] = s;
        s += warp_n[w];
      }
    }
    __syncthreads();
    const int j =
        filled + warp_before[warp] + __popc(mask & ((1u << lane) - 1));
    if (zero && j < need) {
      tv[n + j] = 0.0f;
      ti[n + j] = bin;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      filled += warp_before[n_warps - 1] + warp_n[n_warps - 1];
    }
    __syncthreads();
    if (filled >= need) break;
  }
}

// One block per line: support, histogram, run, extent and response.
__global__ void lines_segment_kernel(
    const int* __restrict__ slot_pix, const float* __restrict__ slot_mag,
    const int* __restrict__ slot_t, const float* __restrict__ slot_rho,
    const float* __restrict__ top_val, const int* __restrict__ top_idx, int w,
    int E, int L, int n_rho, DetectConsts k, float* __restrict__ line_f,
    int* __restrict__ line_valid) {
  extern __shared__ float s_coord[];
  float* list = s_coord + E;
  unsigned short* pos = reinterpret_cast<unsigned short*>(list + E);
  unsigned char* s_bin = reinterpret_cast<unsigned char*>(pos + E);
  unsigned char* supp = s_bin + E;
  __shared__ int cnt[kSBins], off[kSBins];
  __shared__ float hist[kSBins];
  __shared__ int run_start, run_end;
  const int l = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t e0 = static_cast<size_t>(b) * E;
  const int pk = top_idx[static_cast<size_t>(b) * L + l];
  const int pk_t = pk / n_rho, pk_r = pk % n_rho;
  const float theta_l = __fmul_rn(
      __fmul_rn(__fadd_rn(static_cast<float>(pk_t), 0.5f), k.pi),
      k.inv_n_theta);
  const float rho_l =
      __fsub_rn(__fmul_rn(__fadd_rn(static_cast<float>(pk_r), 0.5f), 2.0f),
                k.diag);
  const float a = __fadd_rn(theta_l, k.half_pi);
  const float dirx = -sinf(a), diry = cosf(a);
  const float nx = cosf(a), ny = sinf(a);
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    const int t = slot_t[e0 + e];
    int dt = abs(t - pk_t);
    dt = min(dt, kNTheta - dt);
    const bool sup = slot_mag[e0 + e] > 0.0f && dt <= 1 &&
                     fabsf(__fsub_rn(slot_rho[e0 + e], rho_l)) < 3.0f;
    const int pix = slot_pix[e0 + e];
    const float sc = __fadd_rn(__fmul_rn(static_cast<float>(pix % w), dirx),
                               __fmul_rn(static_cast<float>(pix / w), diry));
    const float sn = __fmul_rn(__fadd_rn(sc, k.diag), k.inv_two_diag);
    s_coord[e] = sc;
    s_bin[e] = static_cast<unsigned char>(
        psl_clamp(static_cast<int>(__fmul_rn(sn, 96.0f)), 0, kSBins - 1));
    supp[e] = sup ? 1 : 0;
  }
  __syncthreads();
  // each slot's position among its bin's slots, in slot order (one warp)
  if (warp == 0) {
    for (int i = lane; i < kSBins; i += 32) cnt[i] = 0;
    __syncwarp();
    for (int base = 0; base < E; base += 32) {
      const int e = base + lane;
      const int bin = e < E ? s_bin[e] : -1;
      const unsigned peers = __match_any_sync(kFull, bin);
      const int before = __popc(peers & ((1u << lane) - 1));
      const int c = bin >= 0 ? cnt[bin] : 0;
      __syncwarp();
      if (bin >= 0) {
        pos[e] = static_cast<unsigned short>(c + before);
        if (before == __popc(peers) - 1) cnt[bin] = c + __popc(peers);
      }
      __syncwarp();
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int o = 0;
    for (int i = 0; i < kSBins; ++i) {
      off[i] = o;
      o += cnt[i];
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    list[off[s_bin[e]] + pos[e]] = supp[e] ? slot_mag[e0 + e] : 0.0f;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kSBins; i += blockDim.x) {
    float sum = 0.0f;
    for (int j = 0; j < cnt[i]; ++j) sum = __fadd_rn(sum, list[off[i] + j]);
    hist[i] = sum;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    bool occ[kSBins], occ2[kSBins];
    for (int i = 0; i < kSBins; ++i) occ[i] = hist[i] > k.grad_threshold;
    for (int i = 0; i < kSBins; ++i) {
      const bool left = occ[(i + kSBins - 1) % kSBins] ||
                        occ[(i + kSBins - 2) % kSBins];
      const bool right = occ[(i + 1) % kSBins] || occ[(i + 2) % kSBins];
      occ2[i] = occ[i] || (left && right);
    }
    int last_zero = -1, best_len = 0, best_end = 0;
    for (int i = 0; i < kSBins; ++i) {
      last_zero = max(last_zero, occ2[i] ? -1 : i);
      const int len = occ2[i] ? i - last_zero : 0;
      if (len > best_len) {
        best_len = len;
        best_end = i;
      }
    }
    run_end = best_end;
    run_start = best_end - best_len + 1;
  }
  __syncthreads();
  if (warp != 0) return;
  // extent and response
  float lo = INFINITY, hi = -INFINITY, resp = 0.0f;
  for (int e = lane; e < E; e += 32) {
    const bool in = supp[e] && s_bin[e] >= run_start && s_bin[e] <= run_end;
    if (in) {
      lo = fminf(lo, s_coord[e]);
      hi = fmaxf(hi, s_coord[e]);
      resp = __fadd_rn(resp, slot_mag[e0 + e]);
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    resp = __fadd_rn(resp, __shfl_down_sync(kFull, resp, o));
    lo = fminf(lo, __shfl_xor_sync(kFull, lo, o));
    hi = fmaxf(hi, __shfl_xor_sync(kFull, hi, o));
  }
  if (lane != 0) return;
  const float fx = __fmul_rn(rho_l, nx), fy = __fmul_rn(rho_l, ny);
  float* f = line_f + (static_cast<size_t>(b) * L + l) * 6;
  f[0] = __fadd_rn(fx, __fmul_rn(lo, dirx));
  f[1] = __fadd_rn(fy, __fmul_rn(lo, diry));
  f[2] = __fadd_rn(fx, __fmul_rn(hi, dirx));
  f[3] = __fadd_rn(fy, __fmul_rn(hi, diry));
  f[4] = resp;
  f[5] = theta_l;
  line_valid[static_cast<size_t>(b) * L + l] =
      top_val[static_cast<size_t>(b) * L + l] > 0.0f &&
      __fsub_rn(hi, lo) >= k.min_length && isfinite(lo) && isfinite(hi);
}

// One block per frame, one thread per line: the final order and outputs.
__global__ void lines_rank_kernel(
    const float* __restrict__ line_f, const int* __restrict__ line_valid, int L,
    int keep_top, DetectConsts k, float* __restrict__ uv_s,
    float* __restrict__ uv_e, float* __restrict__ line2d,
    float* __restrict__ angle, float* __restrict__ response,
    unsigned char* __restrict__ valid) {
  extern __shared__ float order_score[];
  const int b = blockIdx.x, i = threadIdx.x;
  const size_t l0 = static_cast<size_t>(b) * L;
  const float* f = line_f + (l0 + i) * 6;
  if (i < L) order_score[i] = line_valid[l0 + i] ? f[4] : -1.0f;
  __syncthreads();
  if (i >= L) return;
  const float v = order_score[i];
  int rank = 0;
  for (int j = 0; j < L; ++j) {
    const float o = order_score[j];
    rank += (o > v || (o == v && j < i)) ? 1 : 0;
  }
  const size_t s = l0 + rank;
  const float p1x = f[0], p1y = f[1], p2x = f[2], p2y = f[3];
  uv_s[2 * s] = p1x;
  uv_s[2 * s + 1] = p1y;
  uv_e[2 * s] = p2x;
  uv_e[2 * s + 1] = p2y;
  response[s] = f[4];
  angle[s] = mod_pos(f[5], k.pi);
  valid[s] = (v > 0.0f && rank < keep_top) ? 1 : 0;
  // cross((p1x, p1y, 1), (p2x, p2y, 1)) as torch.linalg.cross forms it
  const float c0 = __fmaf_rn(p1y, 1.0f, -__fmul_rn(1.0f, p2y));
  const float c1 = __fmaf_rn(1.0f, p2x, -__fmul_rn(p1x, 1.0f));
  const float c2 = __fmaf_rn(p1x, p2y, -__fmul_rn(p1y, p2x));
  const float nrm = sqrtf(
      __fadd_rn(__fadd_rn(__fmul_rn(c0, c0), __fmul_rn(c1, c1)), 1e-12f));
  line2d[3 * s] = __fdiv_rn(c0, nrm);
  line2d[3 * s + 1] = __fdiv_rn(c1, nrm);
  line2d[3 * s + 2] = __fdiv_rn(c2, nrm);
}

// K21: one block per line.
constexpr int kBands = 9;
constexpr int kMaxSamples = 32;

__global__ void lines_descriptor_kernel(
    const float* __restrict__ gx, const float* __restrict__ gy, int h, int w,
    float u_max, float v_max, const float* __restrict__ uv_s,
    const float* __restrict__ uv_e, const unsigned char* __restrict__ valid,
    int L, const float* __restrict__ alphas, int n_samples, float band_width,
    float* __restrict__ desc) {
  // the four halves (par+, par-, per+, per-) of every band and sample
  __shared__ float comp[4][kBands][kMaxSamples];
  __shared__ float feat[8 * kBands];
  __shared__ float norm;
  const int l = blockIdx.x, b = blockIdx.y;
  const size_t li = static_cast<size_t>(b) * L + l;
  const float sx = uv_s[2 * li], sy = uv_s[2 * li + 1];
  const float dx = __fsub_rn(uv_e[2 * li], sx);
  const float dy = __fsub_rn(uv_e[2 * li + 1], sy);
  const float len = sqrtf(
      __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), 1e-9f));
  const float tx = __fdiv_rn(dx, len), ty = __fdiv_rn(dy, len);
  const float nx = -ty, ny = tx;
  const size_t plane = static_cast<size_t>(b) * h * w;
  for (int j = threadIdx.x; j < kBands * n_samples; j += blockDim.x) {
    const int band = j / n_samples, s = j % n_samples;
    const float off = __fmul_rn(static_cast<float>(band) -
                                    static_cast<float>(kBands - 1) * 0.5f,
                                band_width);
    const float cu = __fadd_rn(__fadd_rn(sx, __fmul_rn(alphas[s], dx)),
                               __fmul_rn(off, nx));
    const float cv = __fadd_rn(__fadd_rn(sy, __fmul_rn(alphas[s], dy)),
                               __fmul_rn(off, ny));
    // image.bilinear_sample; a non-finite coordinate casts to index 0 as
    // the plain version's cast does, and the indices stay in the image
    const float u = clamp_nan(cu, 0.0f, u_max);
    const float v = clamp_nan(cv, 0.0f, v_max);
    const long long u0l = static_cast<long long>(floorf(u));
    const long long v0l = static_cast<long long>(floorf(v));
    const int u0 = static_cast<int>(max(0LL, min(u0l, (long long)w - 2)));
    const int v0 = static_cast<int>(max(0LL, min(v0l, (long long)h - 2)));
    const float au = __fsub_rn(u, static_cast<float>(u0l));
    const float av = __fsub_rn(v, static_cast<float>(v0l));
    const float bu = __fsub_rn(1.0f, au), bv = __fsub_rn(1.0f, av);
    const float w00 = __fmul_rn(bu, bv), w01 = __fmul_rn(au, bv);
    const float w10 = __fmul_rn(bu, av), w11 = __fmul_rn(au, av);
    const size_t i00 = plane + static_cast<size_t>(v0) * w + u0;
    const size_t i10 = i00 + w;
    auto sample = [&](const float* img) {
      float r = __fmul_rn(w00, img[i00]);
      r = __fadd_rn(r, __fmul_rn(w01, img[i00 + 1]));
      r = __fadd_rn(r, __fmul_rn(w10, img[i10]));
      return __fadd_rn(r, __fmul_rn(w11, img[i10 + 1]));
    };
    const float gxs = sample(gx), gys = sample(gy);
    const float par = __fadd_rn(__fmul_rn(gxs, tx), __fmul_rn(gys, ty));
    const float per = __fadd_rn(__fmul_rn(gxs, nx), __fmul_rn(gys, ny));
    comp[0][band][s] = clamp_nan(par, 0.0f, INFINITY);
    comp[1][band][s] = clamp_nan(-par, 0.0f, INFINITY);
    comp[2][band][s] = clamp_nan(per, 0.0f, INFINITY);
    comp[3][band][s] = clamp_nan(-per, 0.0f, INFINITY);
  }
  __syncthreads();
  const float inv_n = __fdiv_rn(1.0f, static_cast<float>(n_samples));
  if (threadIdx.x < 4 * kBands) {
    const int c = threadIdx.x / kBands, band = threadIdx.x % kBands;
    const float* x = comp[c][band];
    float sum = 0.0f;
    for (int s = 0; s < n_samples; ++s) sum = __fadd_rn(sum, x[s]);
    const float mean = __fmul_rn(sum, inv_n);
    float ss = 0.0f;
    for (int s = 0; s < n_samples; ++s) {
      const float d = __fsub_rn(x[s], mean);
      ss = __fadd_rn(ss, __fmul_rn(d, d));
    }
    // feature order: for (par, per): for (+, -): mean, deviation
    feat[(2 * c) * kBands + band] = mean;
    feat[(2 * c + 1) * kBands + band] =
        sqrtf(__fdiv_rn(ss, static_cast<float>(n_samples)));
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float ss = 0.0f;
    for (int i = 0; i < 8 * kBands; ++i) {
      ss = __fadd_rn(ss, __fmul_rn(feat[i], feat[i]));
    }
    norm = sqrtf(__fadd_rn(ss, 1e-9f));
  }
  __syncthreads();
  if (threadIdx.x < 8 * kBands) {
    const float vf = valid[li] ? 1.0f : 0.0f;
    desc[li * (8 * kBands) + threadIdx.x] =
        __fmul_rn(__fdiv_rn(feat[threadIdx.x], norm), vf);
  }
}

// Dynamic shared memory above the default 48 KB (static included) needs the
// kernel's opt-in.
int set_smem(const void* fn, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

}  // namespace

// Words (4 bytes) of scratch psl_detect_lines needs.
PSL_API long long psl_detect_lines_scratch_words(int h, int w, int batch,
                                                 int E, int L, int n_rho) {
  return static_cast<long long>(
      scratch_words(h * w, batch, E, L, kNTheta * n_rho));
}

// K20 for `batch` frames: blur (batch, h, w), the 5-tap blurred frames;
// scratch of psl_detect_lines_scratch_words; outputs gx, gy (batch, h, w),
// uv_s, uv_e (batch, L, 2), line2d (batch, L, 3), angle, response, valid
// (batch, L). diag is hypot(h, w) and n_rho 2 int(diag / 2) + 3, as the
// plain version derives them; E <= min(8192, h w).
PSL_API int psl_detect_lines(const float* blur, int h, int w, int batch,
                             int E, int L, int n_rho, int keep_top,
                             float grad_threshold, float min_length,
                             double diag, void* scratch, float* gx, float* gy,
                             float* uv_s, float* uv_e, float* line2d,
                             float* angle, float* response,
                             unsigned char* valid, cudaStream_t stream) {
  if (batch < 1 || h < 2 || w < 2 || E < 1 || E > 8192 || E > h * w ||
      L < 1 || L > E || L > 1024 || n_rho < 1 || keep_top < 0 ||
      kNTheta * n_rho >= 262144) {  // (bin, slot) keys fit an int
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const double pi = 3.14159265358979323846;
  DetectConsts k;
  k.pi = static_cast<float>(pi);
  k.half_pi = static_cast<float>(pi / 2.0);
  k.inv_quarter_pi = 1.0f / static_cast<float>(pi / 4.0);
  k.inv_pi = 1.0f / static_cast<float>(pi);
  k.inv_n_theta = 1.0f / static_cast<float>(kNTheta);
  k.inv_two_diag = 1.0f / static_cast<float>(2.0 * diag);
  k.diag = static_cast<float>(diag);
  k.grad_threshold = grad_threshold;
  k.min_length = min_length;
  const int hw = h * w, n_bins = kNTheta * n_rho;
  Scratch s = carve(scratch, hw, batch, E, L, n_bins);
  const dim3 pb(32, 8);
  const dim3 pg((w + 31) / 32, (h + 7) / 8, batch);
  const int eb = (E + kThreads - 1) / kThreads;
  const size_t peak_smem = 8 * static_cast<size_t>(E);
  const size_t line_smem = 12 * static_cast<size_t>(E);
  int rc = set_smem(reinterpret_cast<const void*>(lines_peaks_kernel),
                    peak_smem);
  if (rc == 0) {
    rc = set_smem(reinterpret_cast<const void*>(lines_segment_kernel),
                  line_smem);
  }
  if (rc != 0) return rc;
  lines_gradient_kernel<<<pg, pb, 0, stream>>>(blur, h, w, gx, gy, s.mag);
  lines_edge_kernel<<<pg, pb, 0, stream>>>(gx, gy, s.mag, h, w, k, s.score);
  lines_select_kernel<<<batch, kSelectThreads, 0, stream>>>(s.score, hw, E,
                                                      s.sel_pix, s.sel_val);
  lines_slot_kernel<<<dim3(eb, batch), kThreads, 4 * E, stream>>>(
      s.sel_pix, s.sel_val, gx, gy, h, w, E, n_rho, k, s.slot_pix,
      s.slot_mag, s.slot_t, s.slot_rho, s.slot_bin, s.hough);
  lines_hough_order_kernel<<<dim3(eb, batch), kThreads, 4 * E, stream>>>(
      s.slot_bin, E, s.hough_order);
  lines_hough_sum_kernel<<<dim3(eb, batch), kThreads, 0, stream>>>(
      s.hough_order, s.slot_bin, s.slot_mag, E, n_bins, s.hough);
  lines_peaks_kernel<<<batch, kPeakThreads, peak_smem, stream>>>(
      s.hough, n_rho, L, E, s.top_val, s.top_idx);
  lines_segment_kernel<<<dim3(L, batch), kThreads, line_smem, stream>>>(
      s.slot_pix, s.slot_mag, s.slot_t, s.slot_rho, s.top_val, s.top_idx, w,
      E, L, n_rho, k, s.line_f, s.line_valid);
  lines_rank_kernel<<<batch, ((L + 31) / 32) * 32, 4 * L, stream>>>(
      s.line_f, s.line_valid, L, keep_top, k, uv_s, uv_e, line2d, angle,
      response, valid);
  return static_cast<int>(cudaGetLastError());
}

// K21 for `batch` frames: gx, gy (batch, h, w) as K20 writes them; uv_s,
// uv_e (batch, L, 2), valid (batch, L); alphas the n_samples float32 sample
// positions (lax_compat.linspace(0.05, 0.95, n)); u_max = float(w - 1.001),
// v_max = float(h - 1.001); desc (batch, L, 72).
PSL_API int psl_line_descriptors(const float* gx, const float* gy, int h,
                                 int w, float u_max, float v_max,
                                 const float* uv_s, const float* uv_e,
                                 const unsigned char* valid, int batch, int L,
                                 const float* alphas, int n_samples,
                                 float band_width, float* desc,
                                 cudaStream_t stream) {
  if (batch < 1 || L < 1 || h < 2 || w < 2 || n_samples < 1 ||
      n_samples > kMaxSamples) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  lines_descriptor_kernel<<<dim3(L, batch), kThreads, 0, stream>>>(
      gx, gy, h, w, u_max, v_max, uv_s, uv_e, valid, L, alphas, n_samples,
      band_width, desc);
  return static_cast<int>(cudaGetLastError());
}
