// The matching stage around K3: K24 project_landmarks, K25 match_select,
// K26 frame_match_select and K27 assemble_observations, `batch` problems
// per launch (B = 1 on the streaming path).
//
// K24 replaces the gates of planarslam_tpu/ops/matching.py::
// search_by_projection before the Hamming matrix (:142-179; the port's plain
// version is ops/matching.py::project_landmarks_plain). One thread per
// landmark: the transform by T_cw (device memory), se3.project, the
// in-front and in-image gates, the camera centre -R^T t and the distance,
// the optional distance-range gate and predicted level
// ceil(log(max(dmax / dist, 1)) / log(scale_factor)), the optional
// viewing-cosine gate, the radius radius * scale_factor^level and the
// pseudo-stereo prediction u - bf / max(z, 1e-6), written as the ProjGate
// fields K3 reads. The plain version spells the 3 x 3 product and the norm
// as products and sums in a fixed order, and the kernel (built with
// -fmad=false) repeats PyTorch's form of every operation on the card: a
// scalar over a tensor is the reciprocal times the scalar, log, pow and
// sqrt are the correctly rounded libdevice functions PyTorch's kernels
// call, so every output equals the plain version's bit for bit.
// Bound: latency (about 33 bytes in and 21 out per landmark).
//
// K25 replaces the tails of ::search_by_projection (:184-189) with
// ::_resolve_duplicates (:50-64), and of ::match_descriptors (:102-109).
// One 1024-thread block per problem; a thread keeps its rows tid, tid +
// 1024, ... (up to 4096 rows) in registers from the first load to the one
// store: every row's loads go out together, then the mutual check's
// gathers of back[best_idx] together; best <= max_dist, the optional ratio
// test float(best) < float32(ratio) * float(second), the optional mutual
// check back[best_idx] == row, then the optional duplicate resolution in
// one pass: a key per matched row (its distance, then its row: 32 bits
// for distances in [0, 16383], 64 in signed order otherwise), its
// target's least key by atomicMin in shared memory, the row kept where
// its own key is its target's least: the least distance, then the first
// source, as the plain version's two minima keep it (integer minima, so
// two launches give the same bits). Rows with no match take no part (one
// that passed its tests with a best_idx below 0, which K3 never gives,
// bounds slot n as the plain version's parking does); rows beyond 4096
// go through the outputs in memory as the first K25's did.
// Bound: latency (~16 bytes per row).
//
// K26 replaces the frame-to-frame selection of planarslam_tpu/slam/
// device_tracker.py (:314-338) with ::rotation_histogram_filter (:67-87).
// One 1024-thread block per problem; a thread keeps its rows tid, tid +
// 1024, ... (up to 4096 rows) in registers from the one load round to the
// stores: row 0's uv and level (a dropped match's gathers) and the
// per-level table (staged in shared memory) first, then proj_idx, bf_idx
// and the source angle together, with the projection match's gathers
// (target angle, uv, u_right, level) issued as soon as proj_idx is in.
// The count of projection matches (__syncthreads_count) decides the
// brute-force fallback on the device (count < kMinProj; its gathers then
// go out again). The angle
// difference (a denormal one taken as 0, as JAX on the CPU flushes it) is
// jnp.mod'ed into [0, 2 pi) (fmod, then shifted) and binned once, in the
// float form of JAX's jitted rot * 30 / two_pi: one product with
// float32(30) / float32(two_pi), the constant XLA folds it to; the 30 bins are counted warp by warp (__match_any_sync, the
// leader adding the popcount: integer sums, the same bits in any order);
// every warp takes the three largest by three __reduce_max_sync of count
// << 5 | (31 - bin) (ties to the lower bin, as lax.top_k; the same pick in
// every warp, so no barrier follows it), the second and third kept at >=
// 10% of the first; then each row's outputs come from its registers: the
// first stage's PointObs fields (uv, u_right or -1, 1/sigma^2 from the
// table, valid). Filter mode takes the matched target
// angles and a validity mask and writes only the kept mask. Rows beyond
// the registers' go through memory, read again after the pick.
// Bound: latency (~40 bytes per source).
//
// K27 replaces the observation assembly of planarslam_tpu/slam/
// device_tracker.py (:352-362, the lines; :406-428, the points). One
// block per problem: the window-to-target slot inversion by
// integer atomicMax in shared memory (.at[].max; a target of -1 takes no
// row, one at n or above is clamped to n - 1), in point mode also the
// temporal landmarks scattered by ff_idx (.at[].set, mode="drop": a target
// outside [0, n) is dropped; a clash, which the duplicate resolution and
// the mutual check rule out, keeps the largest source id, so the bits
// never depend on order), then per target the window row or the temporal
// landmark, u_right or -1, the level's 1/sigma^2 and the validity
// (points); both window endpoints, 1 and the validity (lines).
// Bound: latency (~40 KB a problem, 19 ns at the HBM rate): the
// assembly's loads form a chain (the targets' indices; the rows, u_right
// and levels; the level table's entry), so every load that does not need
// the inversion, the level's table entry among them, goes out before the
// first barrier, and the rows follow it in one more round trip. The
// block has a thread a window row up to 1024 (256 a line problem, 1024 a
// point problem: the widths measured fastest, PERF.md). Loading every
// window row before the barrier instead, so that the winning row stores
// itself, took longer on the card: one block moves every row through one
// SM (PERF.md, the K27 row).
#include <cfloat>

#include "common.cuh"

namespace {

constexpr int kProjThreads = 256;
constexpr int kBlockThreads = 1024;
constexpr int kInfDist = 10000;
constexpr int kHisto = 30;    // rotation histogram bins (HISTO_LENGTH)
constexpr int kMinProj = 20;  // fewer projection matches: the brute-force
                              // fallback (MIN_PROJ_MATCHES)

struct ProjConsts {
  float fx, fy, cx, cy, width, height, bf, scale_factor, radius;
};

// torch.clamp(x, min=lo): NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}

// ((a0 * x + a1 * y) + a2 * z), each product and sum rounded
__device__ __forceinline__ float dot3(float a0, float a1, float a2, float x,
                                      float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a0, x), __fmul_rn(a1, y)),
                   __fmul_rn(a2, z));
}

__global__ void project_landmarks_kernel(
    const float* __restrict__ pts, const unsigned char* __restrict__ valid,
    const float* __restrict__ T_cw, const float* __restrict__ normals,
    const float* __restrict__ dmin, const float* __restrict__ dmax, int m,
    ProjConsts c, float* __restrict__ a_uv, float* __restrict__ a_r,
    int* __restrict__ a_level, float* __restrict__ a_ur_pred,
    unsigned char* __restrict__ gate) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const long long row = static_cast<long long>(blockIdx.y) * m + i;
  const float* T = T_cw + 16 * blockIdx.y;
  const float x = pts[3 * row], y = pts[3 * row + 1], z = pts[3 * row + 2];
  float pc[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    pc[r] = __fadd_rn(dot3(T[4 * r], T[4 * r + 1], T[4 * r + 2], x, y, z),
                      T[4 * r + 3]);
  }
  // se3.project: 1.0 / where(|z| < 1e-8, 1e-8, z) is a reciprocal
  const float zs = fabsf(pc[2]) < 1e-8f ? 1e-8f : pc[2];
  const float inv_z = __fdiv_rn(1.0f, zs);
  const float u = __fadd_rn(__fmul_rn(__fmul_rn(c.fx, pc[0]), inv_z), c.cx);
  const float v = __fadd_rn(__fmul_rn(__fmul_rn(c.fy, pc[1]), inv_z), c.cy);
  bool g = (valid[row] != 0) && (pc[2] > 0.05f) && (u >= 0.0f) &&
           (u < c.width) && (v >= 0.0f) && (v < c.height);

  // camera centre -R^T t, the vector to the landmark and its length
  const float tx = T[3], ty = T[7], tz = T[11];
  const float vx = __fsub_rn(x, -dot3(T[0], T[4], T[8], tx, ty, tz));
  const float vy = __fsub_rn(y, -dot3(T[1], T[5], T[9], tx, ty, tz));
  const float vz = __fsub_rn(z, -dot3(T[2], T[6], T[10], tx, ty, tz));
  const float dist =
      clamp_min(__fsqrt_rn(dot3(vx, vy, vz, vx, vy, vz)), 1e-6f);
  int level = 0;
  if (dmax != nullptr) {
    const float lo = dmin[row], hi = dmax[row];
    g = g && (dist >= __fmul_rn(0.8f, lo)) && (dist <= __fmul_rn(1.2f, hi));
    const float ratio = clamp_min(__fdiv_rn(hi, dist), 1.0f);
    level = static_cast<int>(
        ceilf(__fdiv_rn(logf(ratio), logf(c.scale_factor))));
  }
  if (normals != nullptr) {
    const float cosv =
        __fdiv_rn(dot3(vx, vy, vz, normals[3 * row], normals[3 * row + 1],
                       normals[3 * row + 2]),
                  dist);
    g = g && (cosv > 0.5f);
  }
  const float inv_zc = __fdiv_rn(1.0f, clamp_min(pc[2], 1e-6f));
  a_uv[2 * row] = u;
  a_uv[2 * row + 1] = v;
  a_r[row] = __fmul_rn(c.radius,
                       powf(c.scale_factor, static_cast<float>(level)));
  a_level[row] = level;
  a_ur_pred[row] = __fsub_rn(u, __fmul_rn(inv_zc, c.bf));
  gate[row] = g ? 1 : 0;
}

// K25's rows a thread keeps in registers: rows tid, tid + 1024, ...,
// below kSelectRegRows * kBlockThreads; rows beyond pass through idx_out
// and dist_out as the first K25's did.
constexpr int kSelectRegRows = 4;
// A duplicate key orders a target's rows by distance, then row: its least
// key is the least distance, then the first source. It takes 32 bits (the
// distance's 14 above the row's 18) where every matched row's distance
// lies in [0, kKeyDist] and the rows number fewer than kKeyRows, as K3's
// Hamming distances and kInfDist do; else 64 (the distance in signed
// order above the row).
constexpr int kKeyRowBits = 18;
constexpr int kKeyRows = 1 << kKeyRowBits;
constexpr int kKeyDist = (1 << (32 - kKeyRowBits)) - 1;
__device__ __forceinline__ unsigned key32(int d, int row) {
  return (static_cast<unsigned>(d) << kKeyRowBits) |
         static_cast<unsigned>(row);
}
__device__ __forceinline__ unsigned long long key64(int d, int row) {
  return (static_cast<unsigned long long>(static_cast<unsigned>(d) ^
                                          0x80000000u) << 32) |
         static_cast<unsigned>(row);
}
// A target's key before any row: kInfDist above every row, so that a row
// is kept only at a distance of at most kInfDist, as the first K25's
// minimum from kInfDist kept it.
constexpr unsigned kInitKey32 =
    (static_cast<unsigned>(kInfDist) << kKeyRowBits) | (kKeyRows - 1);
constexpr unsigned long long kInitKey64 =
    (static_cast<unsigned long long>(static_cast<unsigned>(kInfDist) ^
                                     0x80000000u) << 32) | 0xffffffffull;

struct SelectArgs {
  const int* best;
  const int* second;
  const int* best_idx;
  const int* back;
  int m, n, max_dist, use_ratio, resolve;
  float ratio;
  int* idx_out;
  int* dist_out;
};

// A matched row (target t in [0, n]) whose key needs 64 bits.
__device__ __forceinline__ bool wide_key(int t, int d, int n) {
  return t >= 0 && t <= n && (d < 0 || d > kKeyDist);
}

// The resolution's key tables, 32 or 64 bits a target in one area.
struct KeyTable {
  void* area;
  bool wide;
  // An atomicMin where the key is below the target's current one (a key
  // only falls, so a key at or above what is read cannot be the least):
  // a target many rows reach takes few atomics.
  __device__ void min(int t, int d, int row) const {
    if (wide) {
      unsigned long long* k = static_cast<unsigned long long*>(area) + t;
      const unsigned long long key = key64(d, row);
      if (key < *static_cast<volatile unsigned long long*>(k)) {
        atomicMin(k, key);
      }
    } else {
      unsigned* k = static_cast<unsigned*>(area) + t;
      const unsigned key = key32(d, row);
      if (key < *static_cast<volatile unsigned*>(k)) atomicMin(k, key);
    }
  }
  __device__ bool least(int t, int d, int row) const {
    return wide ? static_cast<const unsigned long long*>(area)[t] ==
                      key64(d, row)
                : static_cast<const unsigned*>(area)[t] == key32(d, row);
  }
};

// A row's tests: best <= max_dist, the optional ratio test, the optional
// mutual check (bk: back[best_idx], read where best_idx is in [0, n)).
__device__ __forceinline__ bool select_passes(const SelectArgs& a, bool mutual,
                                              int b, int bi, int sc, int bk,
                                              int row) {
  bool ok = b <= a.max_dist;
  if (a.use_ratio) {
    ok = ok && (static_cast<float>(b) <
                __fmul_rn(a.ratio, static_cast<float>(sc)));
  }
  if (mutual) ok = ok && bi >= 0 && bi < a.n && bk == row;
  return ok;
}

// A row's part in the resolution: its key offered to its target, or, past
// its tests with a best_idx below 0, its distance to the parked bound.
__device__ __forceinline__ void select_offer(const KeyTable& keys,
                                             int* parked, int t, int d,
                                             int row, int n) {
  if (t >= 0 && t <= n) {
    keys.min(t, d, row);
  } else if (t < 0 && d < kInfDist) {
    atomicMin(parked, d);
  }
}

// Whether a row stays matched after the resolution.
__device__ __forceinline__ bool select_kept(const KeyTable& keys, int parked,
                                            int t, int d, int row, int n) {
  return t >= 0 && t <= n && keys.least(t, d, row) &&
         (t < n || d <= parked);
}

// R rows a thread in registers (R * kBlockThreads >= m, or kSelectRegRows);
// one block per problem.
template <int R>
__global__ void __launch_bounds__(kBlockThreads) match_select_kernel(
    SelectArgs a) {
  // resolve: the targets' keys, n + 1 of 32 bits (or of 64)
  extern __shared__ unsigned long long key_area[];
  // the least distance of the rows the plain version parks in slot n
  // beside a best_idx of n (a test passed with a best_idx below 0)
  __shared__ int parked;
  const int tid = threadIdx.x;
  const long long base = static_cast<long long>(blockIdx.x) * a.m;
  const int* back_b =
      a.back != nullptr ? a.back + static_cast<long long>(blockIdx.x) * a.n
                        : nullptr;
  // the row loads: every row's best, best_idx and second at once
  int b[R], bi[R], sc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = tid + r * kBlockThreads;
    const bool here = i < a.m;
    b[r] = here ? a.best[base + i] : kInfDist;
    bi[r] = here ? a.best_idx[base + i] : -1;
    sc[r] = here && a.use_ratio ? a.second[base + i] : 0;
  }
  if (a.resolve) {
    unsigned* k32 = reinterpret_cast<unsigned*>(key_area);
    for (int j = tid; j <= a.n; j += kBlockThreads) k32[j] = kInitKey32;
    if (tid == 0) parked = kInfDist;
  }
  // the tests: best <= max_dist, the ratio test, then the mutual check's
  // gathers of back[best_idx] all at once
  const bool mutual = back_b != nullptr;
  int idx[R], d[R];
  bool wide = a.m >= kKeyRows;
  {
    int bk[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      bk[r] = mutual && bi[r] >= 0 && bi[r] < a.n ? back_b[bi[r]] : -1;
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = tid + r * kBlockThreads;
      const bool ok =
          i < a.m && select_passes(a, mutual, b[r], bi[r], sc[r], bk[r], i);
      idx[r] = ok ? bi[r] : -1;
      d[r] = ok ? b[r] : kInfDist;
      wide = wide || wide_key(idx[r], d[r], a.n);
    }
  }
  // rows beyond the registers' (m > R * kBlockThreads): through memory
  for (int i = tid + R * kBlockThreads; i < a.m; i += kBlockThreads) {
    const int bb = a.best[base + i];
    const int bj = a.best_idx[base + i];
    const int sc_i = a.use_ratio ? a.second[base + i] : 0;
    const int bk = mutual && bj >= 0 && bj < a.n ? back_b[bj] : -1;
    const bool ok = select_passes(a, mutual, bb, bj, sc_i, bk, i);
    a.idx_out[base + i] = ok ? bj : -1;
    a.dist_out[base + i] = ok ? bb : kInfDist;
    wide = wide || (ok && wide_key(bj, bb, a.n));
  }
  if (a.resolve) {
    // the resolution pass: one atomicMin per matched row on its target's
    // key; integer minima give the same bits in any order. 64-bit keys
    // only where a matched row's distance leaves [0, kKeyDist]: the table
    // is then laid out again.
    const KeyTable keys{key_area, __syncthreads_or(wide) != 0};
    if (keys.wide) {
      for (int j = tid; j <= a.n; j += kBlockThreads) {
        key_area[j] = kInitKey64;
      }
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      select_offer(keys, &parked, idx[r], d[r], tid + r * kBlockThreads,
                   a.n);
    }
    for (int i = tid + R * kBlockThreads; i < a.m; i += kBlockThreads) {
      select_offer(keys, &parked, a.idx_out[base + i], a.dist_out[base + i],
                   i, a.n);
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const bool keep = select_kept(keys, parked, idx[r], d[r],
                                    tid + r * kBlockThreads, a.n);
      idx[r] = keep ? idx[r] : -1;
      d[r] = keep ? d[r] : kInfDist;
    }
    for (int i = tid + R * kBlockThreads; i < a.m; i += kBlockThreads) {
      const int t = a.idx_out[base + i];
      const int dd = a.dist_out[base + i];
      const bool keep = select_kept(keys, parked, t, dd, i, a.n);
      a.idx_out[base + i] = keep ? t : -1;
      a.dist_out[base + i] = keep ? dd : kInfDist;
    }
  }
  // the stores: each row once
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = tid + r * kBlockThreads;
    if (i < a.m) {
      a.idx_out[base + i] = idx[r];
      a.dist_out[base + i] = d[r];
    }
  }
}

// mod(a_src - a_tgt, two_pi), then clamp(int(rot * kHisto / two_pi), 0,
// kHisto - 1) as JAX's jitted rotation_histogram_filter bins it: one
// product with bin_scale = float32(kHisto) / float32(two_pi). A denormal
// difference counts as 0 (bin 0), as JAX on the CPU flushes it; the card
// keeps denormals, so the flush is explicit here and in the plain version.
__device__ __forceinline__ int rotation_bin(float a_src, float a_tgt,
                                            float two_pi, float bin_scale) {
  float d = __fsub_rn(a_src, a_tgt);
  if (fabsf(d) < FLT_MIN) d = 0.0f;
  float rot = fmodf(d, two_pi);
  if (rot != 0.0f && rot < 0.0f) rot = __fadd_rn(rot, two_pi);
  return psl_clamp(static_cast<int>(__fmul_rn(rot, bin_scale)), 0,
                   kHisto - 1);
}

// K26's rows a thread keeps in registers: rows tid, tid + 1024, ...,
// below kFrameRegRows * kBlockThreads; rows beyond pass through memory
// (their inputs read again after the pick).
constexpr int kFrameRegRows = 4;
// a count enters a pick key above 5 bits of bin: counts below 2^26
constexpr int kFrameMaxRows = 1 << 26;

struct FrameArgs {
  const int* proj_idx;   // (B, M) frame mode
  const int* bf_idx;     // (B, M) frame mode, or NULL: no fallback
  const unsigned char* valid_in;  // (B, M) filter mode
  const float* angle_src;         // (B, M)
  const float* angle_tgt;  // (B, N) frame mode; (B, M) matched, filter mode
  int m, n;
  const float* uv_tgt;     // (B, N, 2)
  const float* ur_tgt;     // (B, N)
  const int* level_tgt;    // (B, N)
  const float* inv_s2_table;  // (n_levels,)
  int n_levels;
  float two_pi, bin_scale;
  int* ff_out;
  float* obs_uv;
  float* obs_ur;
  float* obs_inv_s2;
  unsigned char* obs_valid;
  unsigned char* keep_out;  // filter mode
};

// A frame-mode row: the chosen match, its target's gathered angle, uv,
// u_right and level (the match's own row, clamped to [0, n)), and the bin
// of its rotation (-1 unmatched).
struct FrameRow {
  int ff, bin;
  float at, u, v, ur;
  int level;
};

// The gathers of a frame-mode row's match ff, all issued together.
__device__ __forceinline__ FrameRow frame_gather(const FrameArgs& a,
                                                 long long bn, int ff) {
  FrameRow r{ff, -1, 0.0f, 0.0f, 0.0f, -1.0f, 0};
  if (ff >= 0) {
    const long long g = bn + psl_clamp(ff, 0, a.n - 1);
    r.at = __ldg(a.angle_tgt + g);
    r.u = __ldg(a.uv_tgt + 2 * g);
    r.v = __ldg(a.uv_tgt + 2 * g + 1);
    r.ur = __ldg(a.ur_tgt + g);
    r.level = __ldg(a.level_tgt + g);
  }
  return r;
}

// A frame-mode row's bin, computed once.
__device__ __forceinline__ void frame_bin(const FrameArgs& a, FrameRow& r,
                                          float a_src) {
  r.bin = r.ff >= 0 ? rotation_bin(a_src, r.at, a.two_pi, a.bin_scale) : -1;
}

// One histogram entry per warp and bin: the lanes of a bin found by
// __match_any_sync, their leader adding the popcount (integer sums: the
// same bits in any order). Every lane of the warp calls it.
__device__ __forceinline__ void histogram_add(int* counts, int bin) {
  const unsigned same = __match_any_sync(0xffffffffu, bin);
  if (bin >= 0 && (threadIdx.x & 31) == __ffs(same) - 1) {
    atomicAdd(counts + bin, __popc(same));
  }
}

// A frame-mode row's outputs: the match where its bin is kept, else -1
// and row 0's gathers (u0, v0, level0), as the plain version's clamp of
// -1 reads them.
__device__ __forceinline__ void frame_store(const FrameArgs& a,
                                            const float* table, long long o,
                                            const FrameRow& r, unsigned keep,
                                            float u0, float v0, int level0) {
  const bool matched = r.bin >= 0 && ((keep >> r.bin) & 1u);
  a.ff_out[o] = matched ? r.ff : -1;
  // obs_uv is the wrapper's own (B, M, 2) tensor: 8-byte aligned rows
  reinterpret_cast<float2*>(a.obs_uv)[o] =
      matched ? make_float2(r.u, r.v) : make_float2(u0, v0);
  a.obs_ur[o] = matched ? r.ur : -1.0f;
  a.obs_inv_s2[o] =
      table[psl_clamp(matched ? r.level : level0, 0, a.n_levels - 1)];
  a.obs_valid[o] = matched ? 1 : 0;
}

// R rows a thread in registers (R * kBlockThreads >= m, or kFrameRegRows);
// one block per problem. Frame mode: the projection matches, or the
// brute-force ones where fewer than kMinProj projected, through the
// rotation histogram, and the first pose solve's observations. Filter
// mode: the kept mask of the valid rows.
template <int R, bool kFilter>
__global__ void __launch_bounds__(kBlockThreads) frame_matches_kernel(
    FrameArgs a) {
  extern __shared__ float table[];  // frame mode: the per-level table
  __shared__ int counts[32];        // the histogram (bins 30, 31 unused)
  const int tid = threadIdx.x, lane = tid & 31;
  const long long bm = static_cast<long long>(blockIdx.x) * a.m;
  const long long bn = static_cast<long long>(blockIdx.x) * a.n;
  const int rows_beyond = R * kBlockThreads;

  // the load round: row 0's gathers (a dropped match's) and the per-level
  // table first, then every row's inputs at once and, in frame mode, the
  // projection match's gathers (the brute-force ones, rarely taken, after
  // the count)
  float a_src[R];
  FrameRow row[R];
  int bf[R];
  bool ok[R];
  float a_tgt[R];
  float u0 = 0.0f, v0 = 0.0f, level_s = 0.0f;
  int level0 = 0;
  if (tid < 32) counts[tid] = 0;
  if (!kFilter) {
    u0 = __ldg(a.uv_tgt + 2 * bn);
    v0 = __ldg(a.uv_tgt + 2 * bn + 1);
    level0 = __ldg(a.level_tgt + bn);
    if (tid < a.n_levels) level_s = __ldg(a.inv_s2_table + tid);
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = tid + r * kBlockThreads;
    const bool here = i < a.m;
    a_src[r] = here ? __ldg(a.angle_src + bm + i) : 0.0f;
    if (kFilter) {
      ok[r] = here && __ldg(a.valid_in + bm + i) != 0;
      a_tgt[r] = here ? __ldg(a.angle_tgt + bm + i) : 0.0f;
    } else {
      const int pj = here ? __ldg(a.proj_idx + bm + i) : -1;
      bf[r] = here && a.bf_idx != nullptr ? __ldg(a.bf_idx + bm + i) : -1;
      row[r] = frame_gather(a, bn, pj);
    }
  }
  if (!kFilter) {
    if (tid < a.n_levels) table[tid] = level_s;
    for (int k = tid + kBlockThreads; k < a.n_levels; k += kBlockThreads) {
      table[k] = __ldg(a.inv_s2_table + k);
    }
  }

  // the count: use_bf = count(proj_idx >= 0) < kMinProj, the same in
  // every thread (its barriers also order the histogram's zeros)
  bool use_bf = false;
  if (kFilter) {
    __syncthreads();
  } else {
    int n_proj = 0;
#pragma unroll
    for (int r = 0; r < R; ++r) n_proj += __syncthreads_count(row[r].ff >= 0);
    for (int base = rows_beyond; base < a.m; base += kBlockThreads) {
      const int i = base + tid;
      n_proj +=
          __syncthreads_count(i < a.m && __ldg(a.proj_idx + bm + i) >= 0);
    }
    use_bf = a.bf_idx != nullptr && n_proj < kMinProj;
    // the gathers: the brute-force matches' where they are taken
    if (use_bf) {
#pragma unroll
      for (int r = 0; r < R; ++r) row[r] = frame_gather(a, bn, bf[r]);
    }
  }
  const int* ff_in = use_bf ? a.bf_idx : a.proj_idx;

  // the histogram: each row's bin computed once, warp-aggregated
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (kFilter) {
      row[r].bin = ok[r] ? rotation_bin(a_src[r], a_tgt[r], a.two_pi,
                                        a.bin_scale)
                         : -1;
    } else {
      frame_bin(a, row[r], a_src[r]);
    }
    histogram_add(counts, row[r].bin);
  }
  for (int base = rows_beyond; base < a.m; base += kBlockThreads) {
    const int i = base + tid;
    int bin = -1;
    if (i < a.m) {
      if (kFilter) {
        if (__ldg(a.valid_in + bm + i) != 0) {
          bin = rotation_bin(__ldg(a.angle_src + bm + i),
                             __ldg(a.angle_tgt + bm + i), a.two_pi,
                             a.bin_scale);
        }
      } else {
        FrameRow x = frame_gather(a, bn, __ldg(ff_in + bm + i));
        frame_bin(a, x, __ldg(a.angle_src + bm + i));
        bin = x.bin;
      }
    }
    histogram_add(counts, bin);
  }
  __syncthreads();

  // the pick: every warp alike (no barrier after it), three reductions of
  // count << 5 | (31 - bin), so that equal counts go to the lower bin
  // (lax.top_k); the second and third kept at >= 10% of the first
  unsigned keep;
  {
    int key = lane < kHisto ? (counts[lane] << 5) | (31 - lane) : 0;
    const int k0 = __reduce_max_sync(0xffffffffu, key);
    key = key == k0 ? 0 : key;
    const int k1 = __reduce_max_sync(0xffffffffu, key);
    key = key == k1 ? 0 : key;
    const int k2 = __reduce_max_sync(0xffffffffu, key);
    const float tenth = __fmul_rn(0.1f, static_cast<float>(k0 >> 5));
    keep = (1u << (31 - (k0 & 31))) |
           (static_cast<unsigned>(static_cast<float>(k1 >> 5) >= tenth)
            << (31 - (k1 & 31))) |
           (static_cast<unsigned>(static_cast<float>(k2 >> 5) >= tenth)
            << (31 - (k2 & 31)));
  }

  // the stores, from registers
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = tid + r * kBlockThreads;
    if (i >= a.m) continue;
    if (kFilter) {
      a.keep_out[bm + i] =
          row[r].bin >= 0 && ((keep >> row[r].bin) & 1u) ? 1 : 0;
    } else {
      frame_store(a, table, bm + i, row[r], keep, u0, v0, level0);
    }
  }
  for (int i = rows_beyond + tid; i < a.m; i += kBlockThreads) {
    if (kFilter) {
      const bool v = __ldg(a.valid_in + bm + i) != 0;
      const int bin =
          v ? rotation_bin(__ldg(a.angle_src + bm + i),
                           __ldg(a.angle_tgt + bm + i), a.two_pi,
                           a.bin_scale)
            : -1;
      a.keep_out[bm + i] = bin >= 0 && ((keep >> bin) & 1u) ? 1 : 0;
    } else {
      FrameRow x = frame_gather(a, bn, __ldg(ff_in + bm + i));
      frame_bin(a, x, __ldg(a.angle_src + bm + i));
      frame_store(a, table, bm + i, x, keep, u0, v0, level0);
    }
  }
}

template <bool kFilter>
int frame_matches_launch(const FrameArgs& a, int batch, cudaStream_t stream) {
  const size_t smem =
      kFilter ? 0 : static_cast<size_t>(a.n_levels) * sizeof(float);
  const int rows = (a.m + kBlockThreads - 1) / kBlockThreads;
  const void* fn =
      rows <= 1 ? reinterpret_cast<const void*>(
                      frame_matches_kernel<1, kFilter>)
      : rows <= 2 ? reinterpret_cast<const void*>(
                        frame_matches_kernel<2, kFilter>)
                  : reinterpret_cast<const void*>(
                        frame_matches_kernel<kFrameRegRows, kFilter>);
  if (smem > 32768) {  // far more levels than a pyramid has
    const int rc = psl_opt_in_smem(fn, smem);
    if (rc != 0) return rc;
  }
  if (rows <= 1) {
    frame_matches_kernel<1, kFilter>
        <<<batch, kBlockThreads, smem, stream>>>(a);
  } else if (rows <= 2) {
    frame_matches_kernel<2, kFilter>
        <<<batch, kBlockThreads, smem, stream>>>(a);
  } else {
    frame_matches_kernel<kFrameRegRows, kFilter>
        <<<batch, kBlockThreads, smem, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// K27's inputs and outputs of one launch (points: win_b == nullptr and
// ff_idx != nullptr; lines: ff_idx == nullptr).
struct AssembleArgs {
  const int* win_idx;  // (B, W) target of each window row, or -1
  const float* win_a;  // (B, W, 3) window points or line starts
  const float* win_b;  // (B, W, 3) line ends
  const int* ff_idx;   // (B, M) target of each temporal source, or -1
  const float* src_xw;  // (B, M, 3)
  const unsigned char* tgt_valid;  // (B, N)
  const float* tgt_ur;             // (B, N)
  const int* tgt_level;            // (B, N)
  const float* inv_s2_table;       // (n_levels,)
  int n_win, m_src, n, n_levels;
  int* slot_out;
  float* out_a;
  float* out_b;
  float* out_ur;
  float* out_inv_s2;
  unsigned char* out_valid;
};

constexpr int kAssembleItems = 4;  // window rows a thread keeps in registers

// 1 / sigma^2 of target t's level (clamped to the table)
__device__ __forceinline__ float level_inv_s2(const AssembleArgs& a,
                                              long long t) {
  return __ldg(a.inv_s2_table +
               psl_clamp(__ldg(a.tgt_level + t), 0, a.n_levels - 1));
}

// One block a problem, of a warp or more: a thread a window row, a
// temporal source and a target up to kBlockThreads threads, past that up
// to kAssembleItems window rows' targets a thread in registers. Before the
// first barrier every load of the inputs the inversion and the scalars
// need is in flight at once: the rows' and the sources' targets, the
// targets' valid and u_right, and the level's table entry (a load that
// waits for the level's). After the atomics and the second barrier a
// target's thread gathers its row (the window row, the temporal landmark,
// zeros; for lines both window endpoints, row 0 where no row took it) and
// stores every output of its target. Rows, sources and targets beyond a
// block's registers go through memory.
template <bool kLines>
__global__ void __launch_bounds__(kBlockThreads)
    assemble_observations_kernel(const AssembleArgs a) {
  extern __shared__ int slots[];  // slot[n], for points source[n]
  int* slot = slots;
  int* src = slots + a.n;
  const int tid = threadIdx.x, T = blockDim.x;
  const long long bw = static_cast<long long>(blockIdx.x) * a.n_win;
  const long long bs = static_cast<long long>(blockIdx.x) * a.m_src;
  const long long bn = static_cast<long long>(blockIdx.x) * a.n;
  for (int j = tid; j < a.n; j += T) {
    slot[j] = -1;
    if (!kLines) src[j] = -1;
  }
  int wt[kAssembleItems];
#pragma unroll
  for (int r = 0; r < kAssembleItems; ++r) {
    const int w = tid + r * T;
    wt[r] = w < a.n_win ? __ldg(a.win_idx + bw + w) : -1;
  }
  const int ft = !kLines && tid < a.m_src ? __ldg(a.ff_idx + bs + tid) : -1;
  bool tv = false;
  float tur = 0.0f, tis2 = 0.0f;
  if (tid < a.n) {
    tv = __ldg(a.tgt_valid + bn + tid) != 0;
    if (!kLines) {
      tur = __ldg(a.tgt_ur + bn + tid);
      tis2 = level_inv_s2(a, bn + tid);
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kAssembleItems; ++r) {
    if (wt[r] >= 0) {
      atomicMax(&slot[psl_clamp(wt[r], 0, a.n - 1)], tid + r * T);
    }
  }
  for (int w = kAssembleItems * T + tid; w < a.n_win; w += T) {
    const int t = __ldg(a.win_idx + bw + w);
    if (t >= 0) atomicMax(&slot[psl_clamp(t, 0, a.n - 1)], w);
  }
  if (!kLines) {
    if (ft >= 0 && ft < a.n) atomicMax(&src[ft], tid);
    for (int i = T + tid; i < a.m_src; i += T) {
      const int t = __ldg(a.ff_idx + bs + i);
      if (t >= 0 && t < a.n) atomicMax(&src[t], i);
    }
  }
  __syncthreads();
  for (int j = tid; j < a.n; j += T) {
    if (j != tid) {
      tv = __ldg(a.tgt_valid + bn + j) != 0;
      if (!kLines) {
        tur = __ldg(a.tgt_ur + bn + j);
        tis2 = level_inv_s2(a, bn + j);
      }
    }
    const int s = slot[j];
    a.slot_out[bn + j] = s;
    if (kLines) {
      const float* ra = a.win_a + 3 * (bw + (s < 0 ? 0 : s));
      const float* rb = a.win_b + 3 * (bw + (s < 0 ? 0 : s));
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        a.out_a[3 * (bn + j) + q] = __ldg(ra + q);
        a.out_b[3 * (bn + j) + q] = __ldg(rb + q);
      }
      a.out_inv_s2[bn + j] = 1.0f;
      a.out_valid[bn + j] = (s >= 0 && tv) ? 1 : 0;
    } else {
      const int f = src[j];
      const bool any = s >= 0 || f >= 0;
      const float* row = s >= 0 ? a.win_a + 3 * (bw + s)
                                : a.src_xw + 3 * (bs + (f < 0 ? 0 : f));
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        a.out_a[3 * (bn + j) + q] = any ? __ldg(row + q) : 0.0f;
      }
      const bool valid = any && tv;
      a.out_ur[bn + j] = valid ? tur : -1.0f;
      a.out_inv_s2[bn + j] = tis2;
      a.out_valid[bn + j] = valid ? 1 : 0;
    }
  }
}

}  // namespace

PSL_API int psl_project_landmarks(
    const float* pts, const unsigned char* valid, const float* T_cw,
    const float* normals, const float* dmin, const float* dmax, int m,
    int batch, float fx, float fy, float cx, float cy, float width,
    float height, float bf, float scale_factor, float radius, float* a_uv,
    float* a_r, int* a_level, float* a_ur_pred, unsigned char* gate,
    cudaStream_t stream) {
  if (m > 0 && batch > 0) {
    const ProjConsts c{fx, fy, cx, cy, width, height, bf, scale_factor,
                       radius};
    const dim3 grid((m + kProjThreads - 1) / kProjThreads, batch);
    project_landmarks_kernel<<<grid, kProjThreads, 0, stream>>>(
        pts, valid, T_cw, normals, dmin, dmax, m, c, a_uv, a_r, a_level,
        a_ur_pred, gate);
  }
  return static_cast<int>(cudaGetLastError());
}

PSL_API int psl_match_select(const int* best, const int* second,
                             const int* best_idx, const int* back, int m,
                             int n, int batch, int max_dist, int use_ratio,
                             float ratio, int resolve, int* idx_out,
                             int* dist_out, cudaStream_t stream) {
  if (m > 0 && batch > 0) {
    if (resolve && n < 0) return static_cast<int>(cudaErrorInvalidValue);
    const SelectArgs a{best,   second,   best_idx, back,  m,
                       n,      max_dist, use_ratio, resolve, ratio,
                       idx_out, dist_out};
    const size_t smem =
        resolve ? (static_cast<size_t>(n) + 1) * sizeof(unsigned long long)
                : 0;
    const int rows = (m + kBlockThreads - 1) / kBlockThreads;
    const void* fn =
        rows <= 1 ? reinterpret_cast<const void*>(match_select_kernel<1>)
        : rows <= 2 ? reinterpret_cast<const void*>(match_select_kernel<2>)
                    : reinterpret_cast<const void*>(
                          match_select_kernel<kSelectRegRows>);
    const int rc = psl_opt_in_smem(fn, smem);
    if (rc != 0) return rc;
    if (rows <= 1) {
      match_select_kernel<1><<<batch, kBlockThreads, smem, stream>>>(a);
    } else if (rows <= 2) {
      match_select_kernel<2><<<batch, kBlockThreads, smem, stream>>>(a);
    } else {
      match_select_kernel<kSelectRegRows>
          <<<batch, kBlockThreads, smem, stream>>>(a);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

PSL_API int psl_frame_match_select(
    const int* proj_idx, const int* bf_idx, const unsigned char* valid_in,
    const float* angle_src, const float* angle_tgt, int m, int n, int batch,
    const float* uv_tgt, const float* ur_tgt, const int* level_tgt,
    const float* inv_s2_table, int n_levels, float two_pi, int* ff_out,
    float* obs_uv, float* obs_ur, float* obs_inv_s2, unsigned char* obs_valid,
    unsigned char* keep_out, cudaStream_t stream) {
  if (m > 0 && batch > 0) {
    const bool filter = valid_in != nullptr;
    if (m >= kFrameMaxRows || (!filter && (n < 1 || n_levels < 1))) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    // JAX's bin scale: float32(30) / float32(two_pi), one rounding
    const float bin_scale = static_cast<float>(kHisto) / two_pi;
    const FrameArgs a{proj_idx,  bf_idx, valid_in,  angle_src, angle_tgt,
                      m,         n,      uv_tgt,    ur_tgt,    level_tgt,
                      inv_s2_table, n_levels, two_pi, bin_scale, ff_out,
                      obs_uv,    obs_ur, obs_inv_s2, obs_valid, keep_out};
    return filter ? frame_matches_launch<true>(a, batch, stream)
                  : frame_matches_launch<false>(a, batch, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

PSL_API int psl_assemble_observations(
    const int* win_idx, int n_win, const float* win_a, const float* win_b,
    const int* ff_idx, int m_src, const float* src_xw,
    const unsigned char* tgt_valid, const float* tgt_ur, const int* tgt_level,
    const float* inv_s2_table, int n_levels, int n, int batch, int* slot_out,
    float* out_a, float* out_b, float* out_ur, float* out_inv_s2,
    unsigned char* out_valid, cudaStream_t stream) {
  if (n > 0 && batch > 0) {
    const bool lines = ff_idx == nullptr;
    if (n_win < 1 ||
        (lines ? win_b == nullptr : m_src < 0 || n_levels < 1)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const AssembleArgs a{win_idx,   win_a,  win_b,      ff_idx,
                         src_xw,    tgt_valid, tgt_ur,  tgt_level,
                         inv_s2_table, n_win, lines ? 0 : m_src, n,
                         lines ? 0 : n_levels, slot_out, out_a, out_b,
                         out_ur,    out_inv_s2, out_valid};
    // a warp or more: a window row, a source and a target a thread, up to
    // kBlockThreads (then up to kAssembleItems window rows a thread)
    int need = n_win > n ? n_win : n;
    if (!lines) need = need > m_src ? need : m_src;
    const int threads =
        need >= kBlockThreads ? kBlockThreads : (need + 31) / 32 * 32;
    // slot[n], and for points source[n]: under 48 KB up to MAX_TARGETS
    const size_t smem = (lines ? 1 : 2) * static_cast<size_t>(n) * sizeof(int);
    if (lines) {
      assemble_observations_kernel<true>
          <<<batch, threads, smem, stream>>>(a);
    } else {
      assemble_observations_kernel<false>
          <<<batch, threads, smem, stream>>>(a);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
