// K20 detect_lines and K21 line_descriptors: the line front end of a frame
// after its 5-tap blur (K17), `batch` frames per call.
//
// K20 replaces planarslam_tpu/ops/lines.py::detect_lines, the jitted
// program from the Sobel gradients to the ranked segments (the port's plain
// version is ops/lines.py::detect_lines_plain). One C call makes a memset
// (the top-digit counts) and eight launches:
//   1. stencil, one block per band of 4 rows: Sobel with replicate borders
//      and the magnitude of the band and its two neighbour rows into shared
//      memory, the direction quantized to 4, non-maximum suppression along
//      it against neighbours that wrap around the image (torch.roll), the
//      threshold; gx and gy go out, the magnitude never does; the band's
//      nonzero scores are compacted in pixel order (warp ballots and a
//      prefix over the warps) into the band's slice of a candidate list,
//      with their count and their top radix digits' counts (bits 21-31;
//      warp-aggregated in shared memory, then integer atomics into the
//      frame's counts). Most pixels are no edge, so the selection reads
//      about a tenth of the frame. It also zeroes the Hough accumulator.
//   2. select, one thread-block cluster of 8 blocks per frame, each block
//      owning every 8th band: the bands' offsets by a scan of their counts;
//      a radix select on the float bits (the scores are >= 0, so their bits
//      order as their values) finds the E-th largest score T, or T = 0
//      when fewer than E are nonzero: its top digit from the stencil's
//      counts, each lower digit from the blocks' warp-aggregated counts
//      over the candidates of the digits chosen so far, merged through
//      distributed shared memory; the candidates above T and the first
//      equal to T in pixel order (per-band counts, exchanged the same way,
//      and two scans) and, when T = 0, the first zero pixels in pixel order
//      (a binary search over the candidates) are the selection, as (value
//      descending, pixel) keys;
//   3. rank, across the card: each key's rank among the E by counting
//      (blocks of 256 keys against chunks of 256, integer atomics), which
//      is its slot in lax_compat.top_k's order (an in-block sort of the
//      keys took 3x as long on one SM);
//   4. slots, one thread per key: its slot's pixel, score, orientation bin,
//      rho, Hough bin and (bin, slot) key;
//   5. rank of the (bin, slot) keys, as 3;
//   6. peaks, one block per frame: each bin's slots laid together in slot
//      order by those ranks, one thread per occupied bin summing its votes
//      in slot order (segment_sum's order on the CPU); the peak test (the
//      3 x 3 maximum with theta wrapped and -inf beyond the rho range) at
//      the occupied bins only (any other bin scores 0), the nonzero peaks
//      compacted in bin order and sorted by (score descending, bin) in
//      registers and shared memory; the top L and, with fewer than L, the
//      first zero-valued bins in bin order, as the stable sort leaves them;
//   7. lines, one block per line: the support test over the E slots, the
//      supporters compacted in slot order, the 96-bin position histogram
//      over them (each bin in slot order), the gap fill (wrapping), the
//      longest run (first maximum), extent and response (one warp: each
//      lane's slots in slot order, the lanes folded by a shuffle tree);
//   8. the top L by response (-1 for invalid lines, ties to the lower line),
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
// that rounding of each other or of the threshold. Integer atomics only
// count; no sum depends on the order of threads, so two launches give the
// same bits.
// Bound: bytes (the blurred frame read, the gradients written, ~3.7 MB for
// 640x480). The select and peaks launches are chains of radix passes, scans
// and barriers (the select on 8 SMs per frame, the peaks on one with a
// sort): latency.
//
// K21 replaces planarslam_tpu/ops/lines.py::line_descriptors: one block per
// line samples K20's gradients bilinearly (bilinear_sample's clamping) at 9
// bands x 24 points, splits the parallel and perpendicular parts into their
// positive and negative halves, and takes each half's mean and population
// deviation per band: 72 numbers, L2-normalized, times validity. The sums
// run in index order (the plain version's torch.mean / std reduce in
// PyTorch's own order: the two agree to float rounding).
// Bound: latency (64 lines x 216 samples of two gathers).
#include <cooperative_groups.h>

#include <mutex>
#include <utility>

#include "common.cuh"

namespace {

constexpr int kNTheta = 36;
constexpr int kSBins = 96;
constexpr int kThreads = 256;
constexpr int kBandRows = 4;  // rows per stencil block: a band of the frame
constexpr int kSelectThreads = 1024;  // the peaks launch's block
constexpr int kCluster = 8;         // the select launch's blocks per frame
constexpr int kClusterThreads = 512;
constexpr int kDigits = 2048;  // the largest radix digit count
constexpr int kMaxE = 8192;    // slot indices fit 13 bits of a sort key
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

// The candidate list: each band of kBandRows rows owns the slice of the
// frame's list that starts at its first pixel and holds its nonzero scores
// in pixel order; band_n counts them, top_hist counts the frame's nonzero
// scores by their top radix digit (bits 21-31).
struct Candidates {
  int* pix;       // (B, HW)
  float* val;     // (B, HW)
  int* band_n;    // (B, n_bands)
  int* top_hist;  // (B, kDigits), zeroed before the candidates' launch
};

struct Scratch {
  Candidates cand;
  unsigned long long* sel_key;  // (B, E) the selection, in pixel order
  int* rank;           // (B, E) each selected key's slot
  int* slot_pix;       // (B, E) by slot (rank)
  float* slot_mag;     // (B, E)
  int* slot_t;         // (B, E)
  float* slot_rho;     // (B, E)
  unsigned* bin_key;   // (B, E) (Hough bin, slot) by slot
  int* bin_rank;       // (B, E) each slot's place in (bin, slot) order
  float* hough;        // (B, 36 n_rho)
  float* top_val;      // (B, L)
  int* top_idx;        // (B, L)
  float* line_f;       // (B, L, 6): uv_s, uv_e, response, theta
  int* line_valid;     // (B, L)
};

int bands_of(int h) { return (h + kBandRows - 1) / kBandRows; }

// the candidate list, rounded up to 8 bytes for the 64-bit keys after it
size_t candidate_words(int h, int w, int batch) {
  const size_t n = static_cast<size_t>(batch) *
                   (2 * static_cast<size_t>(h) * w + bands_of(h) + kDigits);
  return (n + 1) / 2 * 2;
}

Candidates carve_candidates(float*& p, int h, int w, int batch) {
  Candidates c;
  const size_t b = static_cast<size_t>(batch), hw = static_cast<size_t>(h) * w;
  c.pix = reinterpret_cast<int*>(p);
  c.val = p + b * hw;
  c.band_n = reinterpret_cast<int*>(p + 2 * b * hw);
  c.top_hist = c.band_n + b * bands_of(h);
  p += candidate_words(h, w, batch);
  return c;
}

// the candidates, the selected keys and their ranks: what the selection
// stage alone needs
size_t selection_words(int h, int w, int batch, int E) {
  return candidate_words(h, w, batch) +
         3 * static_cast<size_t>(batch) * E;
}

Scratch carve(void* base, int h, int w, int batch, int E, int L, int n_bins) {
  Scratch s;
  float* p = static_cast<float*>(base);
  s.cand = carve_candidates(p, h, w, batch);
  auto take = [&](size_t words) {
    float* q = p;
    p += words;
    return q;
  };
  const size_t b = static_cast<size_t>(batch);
  s.sel_key = reinterpret_cast<unsigned long long*>(take(2 * b * E));
  s.rank = reinterpret_cast<int*>(take(b * E));
  s.slot_pix = reinterpret_cast<int*>(take(b * E));
  s.slot_mag = take(b * E);
  s.slot_t = reinterpret_cast<int*>(take(b * E));
  s.slot_rho = take(b * E);
  s.bin_key = reinterpret_cast<unsigned*>(take(b * E));
  s.bin_rank = reinterpret_cast<int*>(take(b * E));
  s.hough = take(b * n_bins);
  s.top_val = take(b * L);
  s.top_idx = reinterpret_cast<int*>(take(b * L));
  s.line_f = take(b * L * 6);
  s.line_valid = reinterpret_cast<int*>(take(b * L));
  return s;
}

size_t scratch_words(int h, int w, int batch, int E, int L, int n_bins) {
  return selection_words(h, w, batch, E) +
         static_cast<size_t>(batch) *
             (6 * static_cast<size_t>(E) + n_bins + 9 * static_cast<size_t>(L));
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

// The n scores s[0..n) of a band (pixels pix0, pix0 + 1, ...) that are not
// zero, in pixel order, into out_pix / out_val; their count into *out_n;
// their top radix digits (bits 21-31) added to the frame's top_hist.
// Run by the whole block: each warp compacts a contiguous segment, placed
// after the earlier warps' by a prefix over the warps; lanes with the same
// digit add their count once, first to the block's histogram, whose
// nonzero counts then go to top_hist by integer atomics.
__device__ void compact_band(const float* s, int n, int pix0, int* out_pix,
                             float* out_val, int* out_n, int* top_hist) {
  __shared__ int warp_n[32], warp_before[32], top[kDigits];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int d = threadIdx.x; d < kDigits; d += blockDim.x) top[d] = 0;
  const int n_warps = blockDim.x >> 5;
  const int seg = ((n + n_warps - 1) / n_warps + 31) / 32 * 32;
  const int lo = min(n, warp * seg), hi = min(n, lo + seg);
  const unsigned lt = (1u << lane) - 1;
  int cnt = 0;
  for (int base = lo; base < hi; base += 32) {
    const int i = base + lane;
    cnt += __popc(__ballot_sync(kFull, i < hi && s[i] != 0.0f));
  }
  if (lane == 0) warp_n[warp] = cnt;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int q = 0; q < n_warps; ++q) {
      warp_before[q] = total;
      total += warp_n[q];
    }
    *out_n = total;
  }
  __syncthreads();
  int run = warp_before[warp];
  for (int base = lo; base < hi; base += 32) {
    const int i = base + lane;
    const float v = i < hi ? s[i] : 0.0f;
    const unsigned m = __ballot_sync(kFull, v != 0.0f);
    const int d = v != 0.0f ? static_cast<int>(__float_as_uint(v) >> 21) : -1;
    const unsigned peers = __match_any_sync(kFull, d);
    if (v != 0.0f) {
      const int o = run + __popc(m & lt);
      out_pix[o] = pix0 + i;
      out_val[o] = v;
      if (lane == __ffs(peers) - 1) atomicAdd(&top[d], __popc(peers));
    }
    run += __popc(m);
  }
  __syncthreads();
  for (int d = threadIdx.x; d < kDigits; d += blockDim.x) {
    if (top[d] != 0) atomicAdd(&top_hist[d], top[d]);
  }
}

// One block per band of kBandRows rows of a frame: gradients, edge scores
// and the band's candidates; it also zeroes a share of the frame's Hough
// accumulator.
__global__ void __launch_bounds__(kThreads)
    lines_stencil_kernel(const float* __restrict__ blur, int h, int w,
                         DetectConsts k, float* __restrict__ gx_out,
                         float* __restrict__ gy_out, Candidates cand,
                         float* __restrict__ hough, int n_bins) {
  extern __shared__ float band[];
  const int r = blockIdx.x, b = blockIdx.y;
  const int y0 = r * kBandRows, rows = min(kBandRows, h - y0);
  // the magnitude of rows y0 - 1 .. y0 + rows (wrapped), the band's scores
  // and quantized directions
  float* mag = band;
  float* score = mag + (kBandRows + 2) * w;
  unsigned char* dir = reinterpret_cast<unsigned char*>(score + kBandRows * w);
  const size_t plane = static_cast<size_t>(b) * h * w;
  const float* img = blur + plane;
  for (int j = r * blockDim.x + threadIdx.x; j < n_bins;
       j += gridDim.x * blockDim.x) {
    hough[static_cast<size_t>(b) * n_bins + j] = 0.0f;
  }
  for (int i = threadIdx.x; i < (rows + 2) * w; i += blockDim.x) {
    const int rr = i / w, x = i % w;
    const int y = (y0 - 1 + rr + h) % h;
    float gx, gy;
    sobel_at(img, h, w, y, x, &gx, &gy);
    mag[i] = sqrtf(__fadd_rn(__fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy)),
                             1e-12f));
    if (rr >= 1 && rr <= rows) {
      const size_t g = plane + static_cast<size_t>(y) * w + x;
      gx_out[g] = gx;
      gy_out[g] = gy;
      const float ang = atan2f(gy, gx);
      int q = static_cast<int>(rintf(__fmul_rn(ang, k.inv_quarter_pi))) % 4;
      if (q < 0) q += 4;
      dir[(rr - 1) * w + x] = static_cast<unsigned char>(q);
    }
  }
  __syncthreads();
  // (dy, dx) per quantized direction; roll(a, -d)[i] = a[i + d] wrapped
  const int dys[4] = {0, 1, 1, 1};
  const int dxs[4] = {1, 1, 0, -1};
  const int n = rows * w;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int rr = i / w + 1, x = i % w;
    const int q = dir[i], dy = dys[q], dx = dxs[q];
    const float m = mag[rr * w + x];
    const float fwd = mag[(rr + dy) * w + (x + dx + w) % w];
    const float bwd = mag[(rr - dy) * w + (x - dx + w) % w];
    const bool edge = m >= fwd && m >= bwd && m > k.grad_threshold;
    score[i] = edge ? m : 0.0f;
  }
  __syncthreads();
  const size_t slice = plane + static_cast<size_t>(y0) * w;
  compact_band(score, n, y0 * w, cand.pix + slice, cand.val + slice,
               cand.band_n + static_cast<size_t>(b) * gridDim.x + r,
               cand.top_hist + static_cast<size_t>(b) * kDigits);
}

// The candidates of a given score map (the selection alone): one block per
// band.
__global__ void __launch_bounds__(kThreads)
    lines_compact_kernel(const float* __restrict__ score_map, int h, int w,
                         Candidates cand) {
  extern __shared__ float band[];
  const int r = blockIdx.x, b = blockIdx.y;
  const int y0 = r * kBandRows, rows = min(kBandRows, h - y0);
  const size_t slice =
      static_cast<size_t>(b) * h * w + static_cast<size_t>(y0) * w;
  for (int i = threadIdx.x; i < rows * w; i += blockDim.x) {
    band[i] = score_map[slice + i];
  }
  __syncthreads();
  compact_band(band, rows * w, y0 * w, cand.pix + slice, cand.val + slice,
               cand.band_n + static_cast<size_t>(b) * gridDim.x + r,
               cand.top_hist + static_cast<size_t>(b) * kDigits);
}

// out[i] = in[0] + ... + in[i - 1] for i <= n (out[n] the total); run by
// warp 0, each lane over a contiguous chunk.
__device__ void warp_exclusive_scan(const int* in, int* out, int n) {
  const int lane = threadIdx.x & 31;
  const int per = (n + 31) / 32;
  const int lo = min(n, lane * per), hi = min(n, lo + per);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += in[i];
  int incl = sum;
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += o;
  }
  int run = incl - sum;
  for (int i = lo; i < hi; ++i) {
    const int v = in[i];
    out[i] = run;
    run += v;
  }
  if (lane == 31) out[n] = incl;
}

// The count of each radix digit (bits shift .. shift + log2(n_digits) - 1)
// of the candidates whose bits match pre on pm, over the bands that block q
// of the frame's cluster owns (band r to block r % kCluster, to its warp
// r / kCluster), into hist; run by the whole block. Lanes with the same
// digit add their count once.
__device__ void digit_histogram(const unsigned* bits, const int* band_off,
                                int n_bands, int band_cap, int q, int shift,
                                int n_digits, unsigned pre, unsigned pm,
                                int* hist) {
  const unsigned digit_mask = static_cast<unsigned>(n_digits - 1);
  for (int d = threadIdx.x; d < n_digits; d += blockDim.x) hist[d] = 0;
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  constexpr int kAhead = 4;  // loads in flight per lane
  for (int r = q + kCluster * warp; r < n_bands; r += kCluster * n_warps) {
    const unsigned* v = bits + static_cast<size_t>(r) * band_cap;
    const int cnt = band_off[r + 1] - band_off[r];
    for (int i0 = 0; i0 < cnt; i0 += 32 * kAhead) {
      unsigned u[kAhead];
#pragma unroll
      for (int k = 0; k < kAhead; ++k) {
        const int i = i0 + 32 * k + lane;
        u[k] = i < cnt ? v[i] : 0u;
      }
#pragma unroll
      for (int k = 0; k < kAhead; ++k) {
        const int i = i0 + 32 * k + lane;
        const bool in = i < cnt && (u[k] & pm) == pre;
        const int d = in ? static_cast<int>((u[k] >> shift) & digit_mask)
                         : -1;
        const unsigned peers = __match_any_sync(kFull, d);
        if (in && lane == __ffs(peers) - 1) {
          atomicAdd(&hist[d], __popc(peers));
        }
      }
    }
  }
  __syncthreads();
}

// The digit that holds the k-th largest (1-based) of the counted
// candidates, from the counts hist of the n_digits digits at shift: prefix
// and prefix_mask extended by it, *k made the rank within it; run by the
// whole block, a block-wide inclusive scan over the digits from the top
// (thread t owns the t-th group of n_digits / blockDim digits from the top).
__device__ void digit_pick(const int* hist, int shift, int n_digits,
                           unsigned* prefix, unsigned* prefix_mask, int* k) {
  __shared__ int scan_warp[32];
  const unsigned digit_mask = static_cast<unsigned>(n_digits - 1);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int per = n_digits / blockDim.x;
  const int top = n_digits - threadIdx.x * per;
  int sum = 0;
  for (int d = top - 1; d >= top - per; --d) sum += hist[d];
  int incl = sum;
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += o;
  }
  if (lane == 31) scan_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < (blockDim.x >> 5) ? scan_warp[lane] : 0;
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(kFull, w, off);
      if (lane >= off) w += o;
    }
    scan_warp[lane] = w - (lane < (blockDim.x >> 5) ? scan_warp[lane] : 0);
  }
  __syncthreads();
  incl += scan_warp[warp];
  const int want = *k;
  const unsigned pre = *prefix, pm = *prefix_mask;
  __syncthreads();
  // the one thread whose group holds the want-th largest
  if (incl >= want && incl - sum < want) {
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
  __syncthreads();
}

// Ascending bitonic sort of a[0..1024 R) in shared memory by the peaks
// kernel's 1024 threads, thread t holding elements t, t + 1024, ... in
// registers: the compare-exchanges of elements 1024 or more apart happen in
// registers, those of elements under 32 apart by warp shuffles, the rest
// (30 of the 91 stages at R = 8) through shared memory, where a warp reads
// and writes 32 consecutive keys (no bank conflicts).
template <int R, class Key>
__device__ void block_sort(Key* a) {
  const int t = threadIdx.x;
  constexpr int N = R * kSelectThreads;
  Key v[R];
#pragma unroll
  for (int r = 0; r < R; ++r) v[r] = a[r * kSelectThreads + t];
  for (int k = 2; k <= N; k <<= 1) {
    // partners in other registers of this thread: j = 1024 R / 2 .. 1024
    // (a level counter, so that the loop unrolls and v stays in registers)
    constexpr int kLevels = R == 8 ? 3 : (R == 4 ? 2 : (R == 2 ? 1 : 0));
#pragma unroll
    for (int level = 0; level < kLevels; ++level) {
      const int jr = R >> (level + 1);
      if (jr * kSelectThreads >= k) continue;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if ((r & jr) != 0) continue;
        const Key x = v[r], y = v[r | jr];
        if ((x > y) == (((r * kSelectThreads + t) & k) == 0)) {
          v[r] = y;
          v[r | jr] = x;
        }
      }
    }
    for (int j = min(k >> 1, kSelectThreads >> 1); j > 0; j >>= 1) {
      const bool across_warps = j >= 32;
      if (across_warps) {
#pragma unroll
        for (int r = 0; r < R; ++r) a[r * kSelectThreads + t] = v[r];
        __syncthreads();
      }
      const bool lower = (t & j) == 0;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = r * kSelectThreads + t;
        const Key o = across_warps ? a[i ^ j]
                                   : __shfl_xor_sync(kFull, v[r], j);
        // keep the smaller of the pair on the lower index of an ascending
        // block, the larger otherwise
        if ((o < v[r]) == (lower == ((i & k) == 0))) v[r] = o;
      }
      if (across_warps) __syncthreads();
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) a[r * kSelectThreads + t] = v[r];
  __syncthreads();
}

// The capacity of the peaks kernel's key array for E slots.
__host__ __device__ __forceinline__ int key_capacity(int E) {
  int n = kSelectThreads;
  while (n < E) n <<= 1;
  return n;
}

// Sort a[0..n) ascending (n <= kMaxE), padding it with `pad` (above every
// key) to the next of 1024, 2048, 4096 or 8192 elements.
template <class Key>
__device__ void sort_keys(Key* a, int n, Key pad) {
  const int cap = key_capacity(n);
  for (int i = n + threadIdx.x; i < cap; i += blockDim.x) a[i] = pad;
  __syncthreads();
  switch (cap / kSelectThreads) {
    case 1:
      block_sort<1>(a);
      break;
    case 2:
      block_sort<2>(a);
      break;
    case 4:
      block_sort<4>(a);
      break;
    default:
      block_sort<8>(a);
  }
}

// c = #{i < n : v[i] - i <= j} for a strictly increasing v: the j-th
// (0-based) integer missing from v is j + c.
template <class F>
__device__ __forceinline__ int missing_before(F v, int n, int j) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (v(mid) - mid <= j) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
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

__device__ __forceinline__ float key_value(unsigned long long key) {
  return __uint_as_float(~static_cast<unsigned>(key >> 32));
}

__device__ __forceinline__ unsigned long long desc_key(float v,
                                                       unsigned idx) {
  return (static_cast<unsigned long long>(~__float_as_uint(v)) << 32) | idx;
}

// One cluster of kCluster blocks per frame: the E best candidates, as
// (value descending, pixel) keys in pixel order, into sel_key (B, E); rank
// (B, E) zeroed for the rank launch. Block q owns every kCluster-th band
// from band q. The top digit of the E-th largest score comes from
// top_hist; each lower digit's counts are each block's over its bands,
// merged through distributed shared memory in block order; so are the
// bands' counts above and at the E-th score. Every block takes the same
// decisions from the same merged counts, and writes its bands' keys.
// Shared memory: select_smem_bytes.
__global__ void __cluster_dims__(kCluster, 1, 1)
    __launch_bounds__(kClusterThreads)
    lines_select_kernel(Candidates cand, int n_bands, int band_cap, int hw,
                        int E, unsigned long long* __restrict__ sel_key,
                        int* __restrict__ rank) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) int sel_smem[];
  int* band_off = sel_smem;               // n_bands + 1 each
  int* band_gt = band_off + n_bands + 1;  // of this block's bands
  int* band_eq = band_gt + n_bands + 1;   // of this block's bands
  int* band_a = band_eq + n_bands + 1;
  int* band_b = band_a + n_bands + 1;
  int* band_c = band_b + n_bands + 1;
  int* part = band_c + n_bands + 1;  // 2 kDigits: this block's counts
  int* hist = part + 2 * kDigits;    // kDigits: the cluster's counts
  __shared__ unsigned prefix, prefix_mask;
  __shared__ int want;
  const int q = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_warps = blockDim.x >> 5;
  const int stride = kCluster * blockDim.x;
  const unsigned lt = (1u << lane) - 1;
  const int b = blockIdx.y;
  const unsigned* bits =
      reinterpret_cast<const unsigned*>(cand.val + static_cast<size_t>(b) * hw);
  const int* pix = cand.pix + static_cast<size_t>(b) * hw;
  const size_t e0 = static_cast<size_t>(b) * E;
  for (int i = q * blockDim.x + tid; i < E; i += stride) rank[e0 + i] = 0;
  if (warp == 0) {
    warp_exclusive_scan(cand.band_n + static_cast<size_t>(b) * n_bands,
                        band_off, n_bands);
  }
  if (tid == 0) {
    prefix = 0;
    prefix_mask = 0;
    want = E;
  }
  __syncthreads();
  const int nnz = band_off[n_bands];
  // hist = the cluster's counts at part + off, summed in block order
  auto merge = [&](int off, int n_digits) {
    for (int d = tid; d < n_digits; d += blockDim.x) {
      int sum = 0;
      for (int r = 0; r < kCluster; ++r) {
        sum += cluster.map_shared_rank(part + off, r)[d];
      }
      hist[d] = sum;
    }
    __syncthreads();
  };
  // T, the E-th largest score (0 with fewer than E nonzero: every
  // candidate is taken and zeros fill the rest), and how many scores equal
  // to T are taken
  if (nnz >= E) {
    const int* top = cand.top_hist + static_cast<size_t>(b) * kDigits;
    for (int d = tid; d < kDigits; d += blockDim.x) hist[d] = top[d];
    __syncthreads();
    digit_pick(hist, 21, 2048, &prefix, &prefix_mask, &want);
    digit_histogram(bits, band_off, n_bands, band_cap, q, 10, 2048, prefix,
                    prefix_mask, part);
    cluster.sync();
    merge(0, 2048);
    digit_pick(hist, 10, 2048, &prefix, &prefix_mask, &want);
    digit_histogram(bits, band_off, n_bands, band_cap, q, 0, 1024, prefix,
                    prefix_mask, part + kDigits);
    cluster.sync();
    merge(kDigits, 1024);
    digit_pick(hist, 0, 1024, &prefix, &prefix_mask, &want);
  }
  const unsigned t = nnz >= E ? prefix : 0u;
  const int take_eq = nnz >= E ? want : 0;
  // per band of this block: candidates above T and equal to it
  for (int r = q + kCluster * warp; r < n_bands; r += kCluster * n_warps) {
    const unsigned* v = bits + static_cast<size_t>(r) * band_cap;
    const int cnt = band_off[r + 1] - band_off[r];
    int gt = 0, eq = 0;
    for (int i0 = 0; i0 < cnt; i0 += 32) {
      const int i = i0 + lane;
      const unsigned u = i < cnt ? v[i] : 0u;
      gt += __popc(__ballot_sync(kFull, i < cnt && u > t));
      eq += __popc(__ballot_sync(kFull, i < cnt && u == t));
    }
    if (lane == 0) {
      band_gt[r] = gt;
      band_eq[r] = eq;
    }
  }
  cluster.sync();
  // every band's counts, from the block that owns it
  for (int r = tid; r < n_bands; r += blockDim.x) {
    band_a[r] = cluster.map_shared_rank(band_gt, r % kCluster)[r];
    band_b[r] = cluster.map_shared_rank(band_eq, r % kCluster)[r];
  }
  __syncthreads();
  if (warp == 0) {
    // band_c: the equal scores before each band; band_a: the band's taken
    // count; band_b: the taken ones before each band
    warp_exclusive_scan(band_b, band_c, n_bands);
    __syncwarp();
    for (int r = lane; r < n_bands; r += 32) {
      band_a[r] += max(0, min(take_eq - band_c[r], band_b[r]));
    }
    __syncwarp();
    warp_exclusive_scan(band_a, band_b, n_bands);
  }
  __syncthreads();
  // this block's bands of the selection, in pixel order
  for (int r = q + kCluster * warp; r < n_bands; r += kCluster * n_warps) {
    const size_t base = static_cast<size_t>(r) * band_cap;
    const int cnt = band_off[r + 1] - band_off[r];
    int eq_run = band_c[r], sel_run = band_b[r];
    for (int i0 = 0; i0 < cnt; i0 += 32) {
      const int i = i0 + lane;
      const unsigned u = i < cnt ? bits[base + i] : 0u;
      const bool is_eq = i < cnt && u == t;
      const unsigned eq_mask = __ballot_sync(kFull, is_eq);
      const bool take = (i < cnt && u > t) ||
                        (is_eq && eq_run + __popc(eq_mask & lt) < take_eq);
      const unsigned take_mask = __ballot_sync(kFull, take);
      if (take) {
        sel_key[e0 + sel_run + __popc(take_mask & lt)] = desc_key(
            __uint_as_float(u), static_cast<unsigned>(pix[base + i]));
      }
      eq_run += __popc(eq_mask);
      sel_run += __popc(take_mask);
    }
  }
  // every block's keys written; no block's shared memory is read after this
  cluster.sync();
  if (nnz < E) {
    // the first E - nnz zero pixels: the integers missing from the
    // candidates' pixels (the keys just written, read past L1)
    auto cand_pix = [&](int i) {
      return static_cast<int>(__ldcg(sel_key + e0 + i) & 0xffffffffu);
    };
    for (int j = q * blockDim.x + tid; j < E - nnz; j += stride) {
      sel_key[e0 + nnz + j] = desc_key(
          0.0f, static_cast<unsigned>(j + missing_before(cand_pix, nnz, j)));
    }
  }
}

size_t select_smem_bytes(int n_bands) {
  return 4 * (6 * (static_cast<size_t>(n_bands) + 1) + 3 * kDigits);
}

// The rank of each of a frame's E distinct keys among them (its index in
// ascending order), counted across the card: block (x, y, b) adds, for
// keys x 256 .. x 256 + 255, how many of the chunk y of keys are smaller.
// Integer atomics: the sums do not depend on the order. rank starts at 0.
constexpr int kRankChunk = 256;

template <class Key>
__global__ void __launch_bounds__(kThreads)
    lines_count_rank_kernel(const Key* __restrict__ keys, int E,
                            int* __restrict__ rank) {
  __shared__ Key chunk[kRankChunk];
  const size_t e0 = static_cast<size_t>(blockIdx.z) * E;
  const int j0 = blockIdx.y * kRankChunk;
  const int n = min(kRankChunk, E - j0);
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    chunk[j] = keys[e0 + j0 + j];
  }
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= E) return;
  const Key k = keys[e0 + i];
  int r = 0;
#pragma unroll 8
  for (int j = 0; j < n; ++j) r += chunk[j] < k ? 1 : 0;
  if (r > 0) atomicAdd(&rank[e0 + i], r);
}

// What the slot launch does beyond the slots' pixels and scores (K20);
// gx == NULL: the selection alone.
struct SlotWork {
  const float* gx;
  const float* gy;
  int w, n_rho;
  DetectConsts k;
  int* slot_t;
  float* slot_rho;
  unsigned* bin_key;  // (B, E): (Hough bin, slot) keys
  int* bin_rank;      // (B, E): zeroed here for the second rank launch
};

// Each selected key to its slot (its rank): the slot's pixel and score
// and (K20) its orientation bin, rho and (Hough bin, slot) key.
__global__ void __launch_bounds__(kThreads)
    lines_slot_kernel(const unsigned long long* __restrict__ sel_key,
                      const int* __restrict__ rank, int E, int hw,
                      int* __restrict__ slot_pix,
                      float* __restrict__ slot_mag, SlotWork sw) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= E) return;
  const size_t e0 = static_cast<size_t>(blockIdx.y) * E;
  const unsigned long long key = sel_key[e0 + i];
  const int s = rank[e0 + i];
  const int p = static_cast<int>(key & 0xffffffffu);
  slot_pix[e0 + s] = p;
  slot_mag[e0 + s] = key_value(key);
  if (sw.gx == nullptr) return;
  const DetectConsts& k = sw.k;
  const size_t g = static_cast<size_t>(blockIdx.y) * hw + p;
  const float ang = atan2f(sw.gy[g], sw.gx[g]);
  const float theta = mod_pos(__fadd_rn(ang, k.half_pi), k.pi);
  const int t_bin = psl_clamp(
      static_cast<int>(__fmul_rn(__fmul_rn(theta, 36.0f), k.inv_pi)), 0,
      kNTheta - 1);
  const float n_ang = __fadd_rn(theta, k.half_pi);
  const float uu = static_cast<float>(p % sw.w);
  const float vv = static_cast<float>(p / sw.w);
  const float rho = __fadd_rn(__fmul_rn(uu, cosf(n_ang)),
                              __fmul_rn(vv, sinf(n_ang)));
  const int r_bin = psl_clamp(
      static_cast<int>(__fmul_rn(__fadd_rn(rho, k.diag), 0.5f)), 0,
      sw.n_rho - 1);
  sw.slot_t[e0 + s] = t_bin;
  sw.slot_rho[e0 + s] = rho;
  sw.bin_key[e0 + s] = (static_cast<unsigned>(t_bin * sw.n_rho + r_bin)
                        << 13) | static_cast<unsigned>(s);
  sw.bin_rank[e0 + i] = 0;
}

// One block per frame: the slots in (Hough bin, slot) order from their
// ranks, the Hough votes (each occupied bin sums its slots in slot order;
// a slot that is no edge adds its score, 0), the nonzero peaks, all at
// occupied bins, compacted in bin order and sorted by (score descending,
// bin), and the top L; with fewer than L nonzero peaks, the first
// zero-scored bins. Shared memory: peaks_smem_bytes.
__global__ void __launch_bounds__(kSelectThreads, 1)
    lines_peaks_kernel(const unsigned* __restrict__ bin_key,
                       const int* __restrict__ bin_rank,
                       const float* __restrict__ slot_mag, int E, int n_rho,
                       int L, float* hough_all, float* __restrict__ top_val,
                       int* __restrict__ top_idx) {
  extern __shared__ __align__(16) unsigned char pk_smem[];
  const int N = key_capacity(E);
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(pk_smem);
  unsigned* key2 = reinterpret_cast<unsigned*>(keys + N);  // E, sorted
  float* mag = reinterpret_cast<float*>(key2 + E);         // E, by slot
  int* pk_bins = reinterpret_cast<int*>(mag + E);          // E
  float* peak_of = reinterpret_cast<float*>(pk_bins + E);  // E
  __shared__ int n_pk;
  __shared__ int warp_n[32], warp_before[32];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_warps = blockDim.x >> 5;
  const unsigned lt = (1u << lane) - 1;
  const int b = blockIdx.x;
  const size_t e0 = static_cast<size_t>(b) * E;
  for (int s = tid; s < E; s += blockDim.x) {
    key2[bin_rank[e0 + s]] = bin_key[e0 + s];
    mag[s] = slot_mag[e0 + s];
  }
  __syncthreads();
  const int n_bins = kNTheta * n_rho;
  float* hough = hough_all + static_cast<size_t>(b) * n_bins;
  for (int p = tid; p < E; p += blockDim.x) {
    const unsigned bin = key2[p] >> 13;
    if (p > 0 && (key2[p - 1] >> 13) == bin) continue;
    float sum = 0.0f;
    for (int q = p; q < E && (key2[q] >> 13) == bin; ++q) {
      sum = __fadd_rn(sum, mag[key2[q] & 0x1fffu]);
    }
    hough[bin] = sum;
  }
  __syncthreads();
  // each run start's peak score, computed once
  for (int p = tid; p < E; p += blockDim.x) {
    const unsigned bin = key2[p] >> 13;
    peak_of[p] = p > 0 && (key2[p - 1] >> 13) == bin
                     ? 0.0f
                     : peak_score(hough, n_rho, static_cast<int>(bin));
  }
  __syncthreads();
  const int seg = ((E + n_warps - 1) / n_warps + 31) / 32 * 32;
  const int lo = min(E, warp * seg), hi = min(E, lo + seg);
  int cnt = 0;
  for (int base = lo; base < hi; base += 32) {
    const int p = base + lane;
    cnt += __popc(__ballot_sync(kFull, p < hi && peak_of[p] > 0.0f));
  }
  if (lane == 0) warp_n[warp] = cnt;
  __syncthreads();
  if (tid == 0) {
    int total = 0;
    for (int q = 0; q < n_warps; ++q) {
      warp_before[q] = total;
      total += warp_n[q];
    }
    n_pk = total;
  }
  __syncthreads();
  int run = warp_before[warp];
  for (int base = lo; base < hi; base += 32) {
    const int p = base + lane;
    const float ps = p < hi ? peak_of[p] : 0.0f;
    const unsigned m = __ballot_sync(kFull, ps > 0.0f);
    if (ps > 0.0f) {
      const int o = run + __popc(m & lt);
      const unsigned bin = key2[p] >> 13;
      keys[o] = desc_key(ps, bin);
      pk_bins[o] = static_cast<int>(bin);
    }
    run += __popc(m);
  }
  __syncthreads();
  const int npk = n_pk;
  sort_keys(keys, npk, ~0ull);
  auto peak_bin = [&](int i) { return pk_bins[i]; };
  float* tv = top_val + static_cast<size_t>(b) * L;
  int* ti = top_idx + static_cast<size_t>(b) * L;
  for (int i = tid; i < L; i += blockDim.x) {
    if (i < npk) {
      tv[i] = key_value(keys[i]);
      ti[i] = static_cast<int>(keys[i] & 0xffffffffu);
    } else {
      const int j = i - npk;
      tv[i] = 0.0f;
      ti[i] = j + missing_before(peak_bin, npk, j);
    }
  }
}

size_t peaks_smem_bytes(int E) {
  return 8 * static_cast<size_t>(key_capacity(E)) +
         16 * static_cast<size_t>(E);
}

// One block per line: support, histogram, run, extent and response. The
// supporters are compacted in slot order first; each one's place among its
// bin's and among its lane's (slot mod 32) supporters puts them in lists,
// so that each histogram bin and each lane of the response walks only its
// own supporters, in slot order.
__global__ void lines_segment_kernel(
    const int* __restrict__ slot_pix, const float* __restrict__ slot_mag,
    const int* __restrict__ slot_t, const float* __restrict__ slot_rho,
    const float* __restrict__ top_val, const int* __restrict__ top_idx, int w,
    int E, int L, int n_rho, DetectConsts k, float* __restrict__ line_f,
    int* __restrict__ line_valid) {
  // per supporter: position along the line, magnitude, slot, its places in
  // its bin's and its lane's lists; the two lists; per supporter its bin;
  // per slot whether it supports the line (segment_smem_bytes)
  extern __shared__ float s_coord[];
  float* s_mag = s_coord + E;
  int* s_slot = reinterpret_cast<int*>(s_mag + E);
  unsigned short* s_pos = reinterpret_cast<unsigned short*>(s_slot + E);
  unsigned short* s_lpos = s_pos + E;
  unsigned short* bin_list = s_lpos + E;
  unsigned short* lane_list = bin_list + E;
  unsigned char* s_bin = reinterpret_cast<unsigned char*>(lane_list + E);
  unsigned char* supp = s_bin + E;
  __shared__ float hist[kSBins];
  __shared__ int cnt[kSBins], off[kSBins], lane_cnt[32], lane_off[32];
  __shared__ int run_start, run_end, n_sup;
  __shared__ int warp_n[kThreads / 32], warp_before[kThreads / 32];
  const int l = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  const unsigned lt = (1u << lane) - 1;
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
    supp[e] = slot_mag[e0 + e] > 0.0f && dt <= 1 &&
              fabsf(__fsub_rn(slot_rho[e0 + e], rho_l)) < 3.0f;
  }
  __syncthreads();
  // the supporters in slot order: each warp a contiguous segment
  const int seg = ((E + n_warps - 1) / n_warps + 31) / 32 * 32;
  const int lo = min(E, warp * seg), hi = min(E, lo + seg);
  int n_seg = 0;
  for (int base = lo; base < hi; base += 32) {
    const int e = base + lane;
    n_seg += __popc(__ballot_sync(kFull, e < hi && supp[e]));
  }
  if (lane == 0) warp_n[warp] = n_seg;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int q = 0; q < n_warps; ++q) {
      warp_before[q] = total;
      total += warp_n[q];
    }
    n_sup = total;
  }
  __syncthreads();
  int run = warp_before[warp];
  for (int base = lo; base < hi; base += 32) {
    const int e = base + lane;
    const bool sup = e < hi && supp[e];
    const unsigned m = __ballot_sync(kFull, sup);
    if (sup) {
      const int o = run + __popc(m & lt);
      const int pix = slot_pix[e0 + e];
      const float sc = __fadd_rn(__fmul_rn(static_cast<float>(pix % w), dirx),
                                 __fmul_rn(static_cast<float>(pix / w), diry));
      const float sn = __fmul_rn(__fadd_rn(sc, k.diag), k.inv_two_diag);
      s_coord[o] = sc;
      s_mag[o] = slot_mag[e0 + e];
      s_slot[o] = e;
      s_bin[o] = static_cast<unsigned char>(
          psl_clamp(static_cast<int>(__fmul_rn(sn, 96.0f)), 0, kSBins - 1));
    }
    run += __popc(m);
  }
  __syncthreads();
  const int ns = n_sup;
  // each supporter's place among its bin's and its lane's supporters (warp
  // 0, lanes with the same bin or lane counted together)
  if (warp == 0) {
    for (int i = lane; i < kSBins; i += 32) cnt[i] = 0;
    lane_cnt[lane] = 0;
    __syncwarp();
    for (int base = 0; base < ns; base += 32) {
      const int q = base + lane;
      const bool in = q < ns;
      const int bin = in ? s_bin[q] : -1;
      const int ln = in ? (s_slot[q] & 31) : -1;
      const unsigned peers = __match_any_sync(kFull, bin);
      const unsigned lpeers = __match_any_sync(kFull, ln);
      const int before = __popc(peers & lt), lbefore = __popc(lpeers & lt);
      const int c = in ? cnt[bin] : 0, lc = in ? lane_cnt[ln] : 0;
      __syncwarp();
      if (in) {
        s_pos[q] = static_cast<unsigned short>(c + before);
        s_lpos[q] = static_cast<unsigned short>(lc + lbefore);
        if (before == __popc(peers) - 1) cnt[bin] = c + __popc(peers);
        if (lbefore == __popc(lpeers) - 1) lane_cnt[ln] = lc + __popc(lpeers);
      }
      __syncwarp();
    }
    if (lane == 0) {
      int o = 0;
      for (int i = 0; i < kSBins; ++i) {
        off[i] = o;
        o += cnt[i];
      }
      o = 0;
      for (int i = 0; i < 32; ++i) {
        lane_off[i] = o;
        o += lane_cnt[i];
      }
    }
  }
  __syncthreads();
  for (int q = threadIdx.x; q < ns; q += blockDim.x) {
    bin_list[off[s_bin[q]] + s_pos[q]] = static_cast<unsigned short>(q);
    lane_list[lane_off[s_slot[q] & 31] + s_lpos[q]] =
        static_cast<unsigned short>(q);
  }
  __syncthreads();
  // each histogram bin sums its supporters in slot order (a slot that does
  // not support the line would add 0)
  for (int i = threadIdx.x; i < kSBins; i += blockDim.x) {
    float sum = 0.0f;
    for (int j = off[i]; j < off[i] + cnt[i]; ++j) {
      sum = __fadd_rn(sum, s_mag[bin_list[j]]);
    }
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
  // extent and response: lane l over slots l, l + 32, ... in slot order
  float lo_c = INFINITY, hi_c = -INFINITY, resp = 0.0f;
  for (int j = lane_off[lane]; j < lane_off[lane] + lane_cnt[lane]; ++j) {
    const int q = lane_list[j];
    if (s_bin[q] >= run_start && s_bin[q] <= run_end) {
      lo_c = fminf(lo_c, s_coord[q]);
      hi_c = fmaxf(hi_c, s_coord[q]);
      resp = __fadd_rn(resp, s_mag[q]);
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    resp = __fadd_rn(resp, __shfl_down_sync(kFull, resp, o));
    lo_c = fminf(lo_c, __shfl_xor_sync(kFull, lo_c, o));
    hi_c = fmaxf(hi_c, __shfl_xor_sync(kFull, hi_c, o));
  }
  if (lane != 0) return;
  const float fx = __fmul_rn(rho_l, nx), fy = __fmul_rn(rho_l, ny);
  float* f = line_f + (static_cast<size_t>(b) * L + l) * 6;
  f[0] = __fadd_rn(fx, __fmul_rn(lo_c, dirx));
  f[1] = __fadd_rn(fy, __fmul_rn(lo_c, diry));
  f[2] = __fadd_rn(fx, __fmul_rn(hi_c, dirx));
  f[3] = __fadd_rn(fy, __fmul_rn(hi_c, diry));
  f[4] = resp;
  f[5] = theta_l;
  line_valid[static_cast<size_t>(b) * L + l] =
      top_val[static_cast<size_t>(b) * L + l] > 0.0f &&
      __fsub_rn(hi_c, lo_c) >= k.min_length && isfinite(lo_c) &&
      isfinite(hi_c);
}

size_t segment_smem_bytes(int E) { return 22 * static_cast<size_t>(E); }

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

// The dynamic shared memory of the stencil (and compact), select, peaks
// and segment launches, each set on its kernel when it grows
// (psl_opt_in_smem; the card's limit read and kept per card, past
// kPslDevices cards read again every call); an error if the card has less
// for a block.
int set_launch_smem(size_t stencil, size_t select, size_t peaks,
                    size_t segment) {
  static std::mutex mu;
  static int cache[kPslDevices] = {};  // the opt-in limit, 0 until read
  const std::lock_guard<std::mutex> hold(mu);
  int once = 0;
  int* optin = psl_device_slot(cache);
  if (optin == nullptr) optin = &once;
  int rc = 0;
  if (*optin == 0) {
    int dev = 0, bytes = 0;
    rc = static_cast<int>(cudaGetDevice(&dev));
    if (rc == 0) {
      rc = static_cast<int>(cudaDeviceGetAttribute(
          &bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev));
    }
    if (rc != 0) return rc;
    *optin = bytes;
  }
  // the static shared memory of each kernel stays under 9 KB
  const std::pair<const void*, size_t> sets[] = {
      {reinterpret_cast<const void*>(lines_stencil_kernel), stencil},
      {reinterpret_cast<const void*>(lines_compact_kernel), stencil},
      {reinterpret_cast<const void*>(lines_select_kernel), select},
      {reinterpret_cast<const void*>(lines_peaks_kernel), peaks},
      {reinterpret_cast<const void*>(lines_segment_kernel), segment}};
  for (size_t i = 0; i < 5; ++i) {
    const size_t bytes = sets[i].second;
    if (bytes + 9 * 1024 > static_cast<size_t>(*optin)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    if ((rc = psl_opt_in_smem(sets[i].first, bytes)) != 0) return rc;
  }
  return 0;
}

// a band's magnitude, scores and directions
size_t stencil_smem_bytes(int w) {
  return static_cast<size_t>(w) * ((2 * kBandRows + 2) * 4 + kBandRows);
}

// The selection and its ranks: the select launch (keys in pixel order)
// and the counting rank across the card (slots).
void launch_selection(const Candidates& cand, int n_bands, int w, int hw,
                      int batch, int E, unsigned long long* sel_key,
                      int* rank, cudaStream_t stream) {
  const int eb = (E + kThreads - 1) / kThreads;
  const int chunks = (E + kRankChunk - 1) / kRankChunk;
  lines_select_kernel<<<dim3(kCluster, batch), kClusterThreads,
                        select_smem_bytes(n_bands), stream>>>(
      cand, n_bands, kBandRows * w, hw, E, sel_key, rank);
  lines_count_rank_kernel<unsigned long long>
      <<<dim3(eb, chunks, batch), kThreads, 0, stream>>>(sel_key, E, rank);
}

}  // namespace

// Words (4 bytes) of scratch psl_detect_lines needs.
PSL_API long long psl_detect_lines_scratch_words(int h, int w, int batch,
                                                 int E, int L, int n_rho) {
  return static_cast<long long>(
      scratch_words(h, w, batch, E, L, kNTheta * n_rho));
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
  if (batch < 1 || h < 2 || w < 2 || E < 1 || E > kMaxE || E > h * w ||
      L < 1 || L > E || L > 1024 || n_rho < 1 || keep_top < 0 ||
      kNTheta * n_rho >= 262144) {  // (bin, slot) keys fit 31 bits
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
  const int hw = h * w, n_bins = kNTheta * n_rho, n_bands = bands_of(h);
  Scratch s = carve(scratch, h, w, batch, E, L, n_bins);
  const size_t stencil_smem = stencil_smem_bytes(w);
  const size_t peaks_smem = peaks_smem_bytes(E);
  const size_t line_smem = segment_smem_bytes(E);
  const int rc = set_launch_smem(stencil_smem, select_smem_bytes(n_bands),
                                 peaks_smem, line_smem);
  if (rc != 0) return rc;
  SlotWork sw;
  sw.gx = gx;
  sw.gy = gy;
  sw.w = w;
  sw.n_rho = n_rho;
  sw.k = k;
  sw.slot_t = s.slot_t;
  sw.slot_rho = s.slot_rho;
  sw.bin_key = s.bin_key;
  sw.bin_rank = s.bin_rank;
  const int eb = (E + kThreads - 1) / kThreads;
  const int chunks = (E + kRankChunk - 1) / kRankChunk;
  const int mrc = static_cast<int>(cudaMemsetAsync(
      s.cand.top_hist, 0, sizeof(int) * kDigits * batch, stream));
  if (mrc != 0) return mrc;
  lines_stencil_kernel<<<dim3(n_bands, batch), kThreads, stencil_smem,
                         stream>>>(blur, h, w, k, gx, gy, s.cand, s.hough,
                                   n_bins);
  launch_selection(s.cand, n_bands, w, hw, batch, E, s.sel_key, s.rank,
                   stream);
  lines_slot_kernel<<<dim3(eb, batch), kThreads, 0, stream>>>(
      s.sel_key, s.rank, E, hw, s.slot_pix, s.slot_mag, sw);
  lines_count_rank_kernel<unsigned>
      <<<dim3(eb, chunks, batch), kThreads, 0, stream>>>(s.bin_key, E,
                                                          s.bin_rank);
  lines_peaks_kernel<<<batch, kSelectThreads, peaks_smem, stream>>>(
      s.bin_key, s.bin_rank, s.slot_mag, E, n_rho, L, s.hough, s.top_val,
      s.top_idx);
  lines_segment_kernel<<<dim3(L, batch), kThreads, line_smem, stream>>>(
      s.slot_pix, s.slot_mag, s.slot_t, s.slot_rho, s.top_val, s.top_idx, w,
      E, L, n_rho, k, s.line_f, s.line_valid);
  lines_rank_kernel<<<batch, ((L + 31) / 32) * 32, 4 * L, stream>>>(
      s.line_f, s.line_valid, L, keep_top, k, uv_s, uv_e, line2d, angle,
      response, valid);
  return static_cast<int>(cudaGetLastError());
}

// Words (4 bytes) of scratch psl_lines_select needs.
PSL_API long long psl_lines_select_scratch_words(int h, int w, int batch,
                                                 int E) {
  return static_cast<long long>(selection_words(h, w, batch, E));
}

// K20's selection stage alone, for its tests: the E largest of each frame's
// scores (batch, h, w), all >= 0, as lax_compat.top_k orders them (value
// descending, ties to the lower pixel; with fewer than E nonzero, the first
// zero pixels in pixel order): top_pix (batch, E) int32, top_val (batch, E).
// A memset and four launches: the candidates, the select, the rank, the
// slots.
PSL_API int psl_lines_select(const float* score, int h, int w, int batch,
                             int E, void* scratch, int* top_pix,
                             float* top_val, cudaStream_t stream) {
  if (batch < 1 || h < 1 || w < 1 || E < 1 || E > kMaxE || E > h * w) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_bands = bands_of(h);
  float* p = static_cast<float*>(scratch);
  const Candidates cand = carve_candidates(p, h, w, batch);
  auto* sel_key = reinterpret_cast<unsigned long long*>(p);
  int* rank = reinterpret_cast<int*>(p + 2 * static_cast<size_t>(batch) * E);
  const size_t band_smem = static_cast<size_t>(w) * kBandRows * 4;
  const int rc = set_launch_smem(max(band_smem, stencil_smem_bytes(w)),
                                 select_smem_bytes(n_bands), 0, 0);
  if (rc != 0) return rc;
  SlotWork sw = {};
  const int mrc = static_cast<int>(cudaMemsetAsync(
      cand.top_hist, 0, sizeof(int) * kDigits * batch, stream));
  if (mrc != 0) return mrc;
  lines_compact_kernel<<<dim3(n_bands, batch), kThreads, band_smem,
                         stream>>>(score, h, w, cand);
  launch_selection(cand, n_bands, w, h * w, batch, E, sel_key, rank, stream);
  lines_slot_kernel<<<dim3((E + kThreads - 1) / kThreads, batch), kThreads, 0,
                      stream>>>(sel_key, rank, E, h * w, top_pix, top_val,
                                sw);
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
