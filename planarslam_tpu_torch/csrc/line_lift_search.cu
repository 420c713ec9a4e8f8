// K22 lift_lines_3d and K23 search_lines_by_projection: a frame's segments
// lifted to 3D, and map lines matched to a frame's segments by projection,
// `batch` problems per call.
//
// K22 replaces planarslam_tpu/ops/lines.py::lift_lines_3d (the port's plain
// version is ops/lines.py::lift_lines_3d_plain). A block of eight warps per
// line. The sampling, a thread a sample: the nearest depth at
// n_depth_samples points of the segment (round half to even), the
// back-projection and sigma(z); each sample's gate 1.5 sigma + 0.01 is
// kept as its sqrt_threshold, the least float whose sqrtf reaches it
// (sqrtf rounds correctly and so is monotone: sqrtf(x) < gate exactly
// where x < that threshold), so the hypothesis pass takes no square root.
// The hypothesis pass over the fixed two-point table (lines.ransac_table,
// numpy seed 99), a warp an eighth of it: a lane prepares one hypothesis
// (its anchor and unit direction), and for each of the warp's hypotheses
// every lane tests samples lane and lane + 32, so that the hypothesis's
// inlier word is a ballot of the lanes and its count the word's population
// count. Warp 0 then picks the first best count by one warp reduction of
// count and index (torch.argmax's answer) and fits the weighted PCA: the
// mean's twelve accumulator chains and the six covariance entries' chains
// of fused multiply-adds one a lane over terms every lane made first, the
// eigen-solve of eig3.cuh::psl_eigh_sym3x3 on every lane, the extent along
// the principal direction by warp reductions of ordered integer keys, and
// the has_3d test. An invalid line slot writes its zeros and does nothing
// else. Every float operation is the plain version's PyTorch arithmetic on
// the card in the first K22's order (a sum of three terms adds the first
// and the third first, as PyTorch's reduction over a last dimension of 3
// does; the weighted mean sums the samples into four interleaved
// accumulators, each in ascending sample order, as its reduction over
// dimension 1 does; a covariance entry is the chain of fused multiply-adds
// of the batched product einsum runs, in ascending sample order), and the
// extent's reduction returns the serial walk's answer (a minimum or maximum
// of zero, whose sign the walk's fminf / fmaxf may pick otherwise, is
// walked in order): the inlier counts and the best hypothesis are the plain
// version's, and the bits are the first K22's. The eigen-solve is
// eig3.cuh's, so the direction, the endpoints and the extent gate agree
// with the plain version to float rounding.
// Bound: latency (64 lines x 32 hypotheses x 48 samples, ~1.5e6 operations).
//
// K23 replaces planarslam_tpu/ops/lines.py::search_lines_by_projection and
// its _adaptive_sim_gate. A row tile is 32 map lines: a block projects its
// lines' endpoints through T_cw (the fused multiply-add chain of the 3 x 3
// product, one thread a line), gates each pair with every frame segment
// (in front, on screen, endpoint distance to the projected infinite line,
// midpoint parameter, angle) and forms the 72-wide descriptor products as
// chains of fused multiply-adds in index order. A warp takes 2 lines and
// each lane 2 segments of every 64: four independent chains a thread,
// the tile's descriptors read from shared memory as float4s, the frame's
// at a stride of an odd number of float4s so that a warp's reads hit
// every bank quad once. A row's best segment is a shuffle reduction over
// its warp, a column's best row a reduction over the warps; both in
// torch.argmax's order (NaN above every number, the first index among
// equals), which is a total order: any reduction tree gives argmax's
// answer, and without NaN the first K23's (a first best by > in index
// order). Then the gate: the two nanmedians of the MAD-adaptive threshold
// (the candidates' keys gathered and sorted by a bitonic network, one a
// thread by shuffles and 6 barriers up to 256 of them and in shared memory
// above, and the values at lax_compat.nanmedian's two middle ranks with
// its weights), the earned count, the threshold and the mutual check.
// The descriptors are staged by asynchronous copies, all of a thread's in
// flight at once.
// - M <= 256 (tracking's window): one launch, a cluster of 8 blocks per
//   problem; the first block gathers the tiles' bests through distributed
//   shared memory, merges the columns' in tile order and runs the gate.
// - M > 256 (local mapping's fuse, M = 4096): two launches, the tiles, then
//   one block per problem for the merge and the gate (a sort of its
//   candidates' keys where the first K23 counted ranks in O(M^2)).
// Bound: operations (M x L pairs x 72 multiply-adds: 2.4 MFLOP for M = 256,
// 38 MFLOP for the 4096 lines of local mapping's fuse).
#include <cooperative_groups.h>
#include <cuda_pipeline.h>

#include "common.cuh"
#include "eig3.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxSamples = 64;
constexpr int kMaxHyp = 64;
// K22: a block of eight warps a line
constexpr int kLiftWarps = 8;
constexpr int kLiftThreads = 32 * kLiftWarps;
// K23: a row tile is 32 map lines (16 warps of 2), a cluster 8 tiles
constexpr int kRows = 32;
constexpr int kSearchThreads = 512;
constexpr int kWarps = kSearchThreads / 32;
constexpr int kRowsPerWarp = kRows / kWarps;
constexpr int kSearchCluster = 8;
constexpr int kGateThreads = 1024;
constexpr int kThreadSort = 256;  // keys thread_bitonic sorts one a thread

__device__ __forceinline__ float clamp_nan(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}

// torch.minimum: NaN propagates
__device__ __forceinline__ float min_nan(float a, float b) {
  return (isnan(a) || isnan(b)) ? NAN : fminf(a, b);
}

__device__ __forceinline__ float mod_pos(float x, float y) {
  const float r = fmodf(x, y);
  return (r != 0.0f && r < 0.0f) ? __fadd_rn(r, y) : r;
}

// torch.sum over a last dimension of 3 on the card: (a + c) + b
__device__ __forceinline__ float sum3(float a, float b, float c) {
  return __fadd_rn(__fadd_rn(a, c), b);
}

struct LiftConsts {
  float cx, cy, inv_fx, inv_fy;  // x / fx is x * (1 / float(fx))
  float c1, c2, c3;
  int min_inliers;               // int(0.6 n_depth_samples)
};

// The covariance entries (i, j), i <= j, one a lane: (j, i) rounds as
// (i, j) does, since fmaf(a, b, c) is fmaf(b, a, c).
__device__ __forceinline__ int cov_row(int e) {
  return e < 3 ? 0 : (e < 5 ? 1 : 2);
}
__device__ __forceinline__ int cov_col(int e) {
  return e < 3 ? e : (e < 5 ? e - 2 : 2);
}
__device__ __forceinline__ float pick3(const float* v, int k) {
  return k == 0 ? v[0] : (k == 1 ? v[1] : v[2]);
}

// K22's extent: a float's key in signed integer order (NaN aside; -0
// below +0), and back.
__device__ __forceinline__ int extent_key(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}
__device__ __forceinline__ float extent_value(int k) {
  return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
}

// The least float t whose square root sqrtf(t) is at least g (NaN for a
// NaN g, 0 for g <= 0, +inf for +inf). sqrtf rounds correctly, so it is
// monotone: sqrtf(x) < g exactly where x < t, and a distance's test against
// its gate takes no square root. sqrtf(t) >= g where sqrt(t) passes the
// midpoint m of g and the float below it; m has 25 significant bits, so m^2
// is exact in double and never a float (no tie): t is m^2 rounded up.
__device__ __forceinline__ float sqrt_threshold(float g) {
  if (!(g > 0.0f) || isinf(g)) return isnan(g) || g > 0.0f ? g : 0.0f;
  const double m = 0.5 * (static_cast<double>(nextafterf(g, 0.0f)) + g);
  return __double2float_ru(m * m);
}

// A sample's test against a hypothesis (anchor a, unit direction u): its
// point-line distance sqrtf(x) under its gate, as x under the gate's
// sqrt_threshold, x in the first K22's operations.
__device__ __forceinline__ bool lift_inlier(float x, float y, float z,
                                            float below, float ax, float ay,
                                            float az, float ux, float uy,
                                            float uz) {
  const float rx = __fsub_rn(x, ax), ry = __fsub_rn(y, ay);
  const float rz = __fsub_rn(z, az);
  const float proj = sum3(__fmul_rn(rx, ux), __fmul_rn(ry, uy),
                          __fmul_rn(rz, uz));
  const float ox = __fsub_rn(rx, __fmul_rn(proj, ux));
  const float oy = __fsub_rn(ry, __fmul_rn(proj, uy));
  const float oz = __fsub_rn(rz, __fmul_rn(proj, uz));
  return __fadd_rn(sum3(__fmul_rn(ox, ox), __fmul_rn(oy, oy),
                        __fmul_rn(oz, oz)), 1e-18f) < below;
}

__global__ void __launch_bounds__(kLiftThreads) lines_lift_kernel(
    const float* __restrict__ depth, int h, int w,
    const float* __restrict__ uv_s, const float* __restrict__ uv_e,
    const unsigned char* __restrict__ valid, int L,
    const float* __restrict__ alphas, int S, const long long* __restrict__ hyp,
    int iters, LiftConsts c, float* __restrict__ p3d_s,
    float* __restrict__ p3d_e, unsigned char* __restrict__ has_3d) {
  __shared__ float p[3][kMaxSamples];
  __shared__ float gate_sq[kMaxSamples];  // the gates' sqrt_threshold
  __shared__ float t_s[kMaxSamples];
  __shared__ float term[3][kMaxSamples];  // the mean's terms, p wt
  __shared__ float cen[3][kMaxSamples];   // the covariance's, (p - mean) wt
  __shared__ unsigned z_word[2];
  __shared__ int n_inl[kMaxHyp];
  __shared__ unsigned long long inl_bits[kMaxHyp];
  const int l = blockIdx.x, b = blockIdx.y;
  const size_t li = static_cast<size_t>(b) * L + l;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // every load of the line, its sample position and this warp's
  // hypotheses goes out before the first use
  const bool line_ok = valid[li] != 0;
  const float sx = uv_s[2 * li], sy = uv_s[2 * li + 1];
  const float ex = uv_e[2 * li], ey = uv_e[2 * li + 1];
  const float alpha = tid < S ? alphas[tid] : 0.0f;
  const int per_warp = (iters + kLiftWarps - 1) / kLiftWarps;
  const int hh = warp * per_warp + lane;
  const bool h_mine = lane < per_warp && hh < iters;
  const int i0 = h_mine ? static_cast<int>(hyp[2 * hh]) : 0;
  const int i1 = h_mine ? static_cast<int>(hyp[2 * hh + 1]) : 0;
  if (!line_ok) {  // has_3d requires valid: the zeros, and no work
    if (tid < 3) {
      p3d_s[3 * li + tid] = 0.0f;
      p3d_e[3 * li + tid] = 0.0f;
    }
    if (tid == 0) has_3d[li] = 0;
    return;
  }
  // sampling: a thread a sample, its nearest depth and back-projection
  {
    const float dx = __fsub_rn(ex, sx), dy = __fsub_rn(ey, sy);
    bool zok = false;
    if (tid < S) {
      const float pu = __fadd_rn(sx, __fmul_rn(alpha, dx));
      const float pv = __fadd_rn(sy, __fmul_rn(alpha, dy));
      // image.nearest_sample: round half to even, cast, clamp
      const long long ui = max(0LL, min(static_cast<long long>(rintf(pu)),
                                        static_cast<long long>(w - 1)));
      const long long vi = max(0LL, min(static_cast<long long>(rintf(pv)),
                                        static_cast<long long>(h - 1)));
      const float z = depth[static_cast<size_t>(b) * h * w + vi * w + ui];
      zok = z > 1e-6f;
      p[0][tid] = __fmul_rn(__fmul_rn(__fsub_rn(pu, c.cx), c.inv_fx), z);
      p[1][tid] = __fmul_rn(__fmul_rn(__fsub_rn(pv, c.cy), c.inv_fy), z);
      p[2][tid] = z;
      const float sg = __fadd_rn(
          __fadd_rn(__fmul_rn(__fmul_rn(c.c1, z), z), __fmul_rn(c.c2, z)),
          c.c3);
      gate_sq[tid] = sqrt_threshold(__fadd_rn(
          __fmul_rn(1.5f, clamp_nan(sg, 2e-3f, INFINITY)), 0.01f));
    }
    const unsigned word = __ballot_sync(0xffffffffu, zok);
    if (warp < 2 && lane == 0) z_word[warp] = word;
  }
  __syncthreads();
  const unsigned long long z_ok =
      z_word[0] | (static_cast<unsigned long long>(z_word[1]) << 32);
  // the hypothesis pass: a warp a share of the hypotheses, a lane the
  // samples lane and lane + 32, an inlier word a ballot of the lanes' gates
  {
    float ax = 0.0f, ay = 0.0f, az = 0.0f, ux = 0.0f, uy = 0.0f, uz = 0.0f;
    bool h_ok = false;
    if (h_mine) {
      ax = p[0][i0];
      ay = p[1][i0];
      az = p[2][i0];
      ux = __fsub_rn(p[0][i1], ax);
      uy = __fsub_rn(p[1][i1], ay);
      uz = __fsub_rn(p[2][i1], az);
      const float dlen = sqrtf(__fadd_rn(
          sum3(__fmul_rn(ux, ux), __fmul_rn(uy, uy), __fmul_rn(uz, uz)),
          1e-12f));
      ux = __fdiv_rn(ux, dlen);
      uy = __fdiv_rn(uy, dlen);
      uz = __fdiv_rn(uz, dlen);
      h_ok = ((z_ok >> i0) & 1ull) && ((z_ok >> i1) & 1ull) && dlen > 0.02f;
    }
    // this lane's samples lane and lane + 32: point, gate, z_ok
    const int s0 = lane, s1 = lane + 32;
    const bool in0 = s0 < S && ((z_ok >> s0) & 1ull);
    const bool in1 = s1 < S && ((z_ok >> s1) & 1ull);
    const float x0 = s0 < S ? p[0][s0] : 0.0f, y0 = s0 < S ? p[1][s0] : 0.0f;
    const float z0 = s0 < S ? p[2][s0] : 0.0f, g0 = s0 < S ? gate_sq[s0] : 0.0f;
    const float x1 = s1 < S ? p[0][s1] : 0.0f, y1 = s1 < S ? p[1][s1] : 0.0f;
    const float z1 = s1 < S ? p[2][s1] : 0.0f, g1 = s1 < S ? gate_sq[s1] : 0.0f;
    const int n_here = min(per_warp, iters - warp * per_warp);
    unsigned long long mine = 0;
#pragma unroll 4
    for (int j = 0; j < n_here; ++j) {
      const float hax = __shfl_sync(0xffffffffu, ax, j);
      const float hay = __shfl_sync(0xffffffffu, ay, j);
      const float haz = __shfl_sync(0xffffffffu, az, j);
      const float hux = __shfl_sync(0xffffffffu, ux, j);
      const float huy = __shfl_sync(0xffffffffu, uy, j);
      const float huz = __shfl_sync(0xffffffffu, uz, j);
      const bool t0 =
          lift_inlier(x0, y0, z0, g0, hax, hay, haz, hux, huy, huz);
      const bool t1 =
          lift_inlier(x1, y1, z1, g1, hax, hay, haz, hux, huy, huz);
      const unsigned w0 = __ballot_sync(0xffffffffu, in0 && t0);
      const unsigned w1 = __ballot_sync(0xffffffffu, in1 && t1);
      if (lane == j) {
        mine = w0 | (static_cast<unsigned long long>(w1) << 32);
      }
    }
    if (h_mine) {
      inl_bits[hh] = mine;
      n_inl[hh] = h_ok ? __popcll(mine) : 0;
    }
  }
  __syncthreads();
  if (warp != 0) return;
  // the pick of the best: the first largest count (torch.argmax's answer),
  // one warp reduction of the keys count << 8 | (255 - index)
  unsigned pick = lane < iters
                      ? (static_cast<unsigned>(n_inl[lane]) << 8) | (255 - lane)
                      : 0u;
  if (lane + 32 < iters) {
    pick = max(pick, (static_cast<unsigned>(n_inl[lane + 32]) << 8) |
                         (255 - (lane + 32)));
  }
  pick = __reduce_max_sync(0xffffffffu, pick);
  const int best = 255 - static_cast<int>(pick & 255u);
  const int best_n = static_cast<int>(pick >> 8);
  const unsigned long long in = inl_bits[best];
  const float wsum = fmaxf(static_cast<float>(__popcll(in)), 1.0f);
  // the mean and the covariance: the weighted mean's four interleaved
  // accumulators of each coordinate on lanes 0-11, each in ascending s,
  // folded in order; a covariance entry's chain of fused multiply-adds in
  // ascending s on each of lanes 0-5. Every lane first makes its samples'
  // terms (the rounded products and differences of the serial loops)
  for (int k = 0; k < 2; ++k) {
    const int s = lane + 32 * k;
    if (s < S) {
      const float wt = (in >> s) & 1ull ? 1.0f : 0.0f;
      for (int d = 0; d < 3; ++d) term[d][s] = __fmul_rn(p[d][s], wt);
    }
  }
  __syncwarp();
  float acc = 0.0f;
  if (lane < 12) {
    const int k = lane >> 2;
#pragma unroll 4
    for (int s = lane & 3; s < S; s += 4) acc = __fadd_rn(acc, term[k][s]);
  }
  // coordinate k's fold and division on lane k (0-2), then to every lane
  float mean[3];
  {
    const int k = lane < 3 ? lane : 0;
    const float a0 = __shfl_sync(0xffffffffu, acc, 4 * k);
    const float a1 = __shfl_sync(0xffffffffu, acc, 4 * k + 1);
    const float a2 = __shfl_sync(0xffffffffu, acc, 4 * k + 2);
    const float a3 = __shfl_sync(0xffffffffu, acc, 4 * k + 3);
    const float mk =
        __fdiv_rn(__fadd_rn(__fadd_rn(__fadd_rn(a0, a1), a2), a3), wsum);
    for (int d = 0; d < 3; ++d) mean[d] = __shfl_sync(0xffffffffu, mk, d);
  }
  for (int k = 0; k < 2; ++k) {
    const int s = lane + 32 * k;
    if (s < S) {
      const float wt = (in >> s) & 1ull ? 1.0f : 0.0f;
      for (int d = 0; d < 3; ++d) {
        cen[d][s] = __fmul_rn(__fsub_rn(p[d][s], mean[d]), wt);
      }
    }
  }
  __syncwarp();
  float cv = 0.0f;
  if (lane < 6) {
    const int i = cov_row(lane), j = cov_col(lane);
#pragma unroll 8
    for (int s = 0; s < S; ++s) cv = __fmaf_rn(cen[i][s], cen[j][s], cv);
    cv = __fadd_rn(__fdiv_rn(cv, wsum), i == j ? 1e-12f : 0.0f);
  }
  float cov[9];
  for (int e = 0; e < 6; ++e) {
    const float v = __shfl_sync(0xffffffffu, cv, e);
    cov[3 * cov_row(e) + cov_col(e)] = v;
    cov[3 * cov_col(e) + cov_row(e)] = v;
  }
  // the eigen-solve: every lane of the warp the same one
  float evals[3], V[9];
  psl_eigh_sym3x3(cov, evals, V);
  const float dir[3] = {V[2], V[5], V[8]};
  // the extent along dir: the least and the largest t of the inliers by
  // warp reductions of ordered integer keys, from +-infinity as the walk
  // starts, NaN left out as fminf / fmaxf leave it; only a zero, whose sign
  // the walk's fminf / fmaxf may pick otherwise, is walked in order
  int lo_key = extent_key(INFINITY), hi_key = extent_key(-INFINITY);
  for (int k = 0; k < 2; ++k) {
    const int s = lane + 32 * k;
    if (s < S && ((in >> s) & 1ull)) {
      const float t = sum3(__fmul_rn(__fsub_rn(p[0][s], mean[0]), dir[0]),
                           __fmul_rn(__fsub_rn(p[1][s], mean[1]), dir[1]),
                           __fmul_rn(__fsub_rn(p[2][s], mean[2]), dir[2]));
      t_s[s] = t;
      if (!isnan(t)) {
        lo_key = min(lo_key, extent_key(t));
        hi_key = max(hi_key, extent_key(t));
      }
    }
  }
  float lo = extent_value(__reduce_min_sync(0xffffffffu, lo_key));
  float hi = extent_value(__reduce_max_sync(0xffffffffu, hi_key));
  if (lo == 0.0f || hi == 0.0f) {
    __syncwarp();
    float wlo = INFINITY, whi = -INFINITY;
    for (int s = 0; s < S; ++s) {
      if (!((in >> s) & 1ull)) continue;
      wlo = fminf(wlo, t_s[s]);
      whi = fmaxf(whi, t_s[s]);
    }
    lo = wlo;
    hi = whi;
  }
  // the outputs
  const bool has = best_n >= c.min_inliers && isfinite(lo) &&
                   isfinite(hi) && __fsub_rn(hi, lo) > 0.05f;
  if (lane < 3) {
    const float d = pick3(dir, lane), m = pick3(mean, lane);
    p3d_s[3 * li + lane] = has ? __fadd_rn(m, __fmul_rn(lo, d)) : 0.0f;
    p3d_e[3 * li + lane] = has ? __fadd_rn(m, __fmul_rn(hi, d)) : 0.0f;
  }
  if (lane == 0) has_3d[li] = has ? 1 : 0;
}

struct SearchConsts {
  float fx, fy, cx, cy, W, H;
  float radius, max_angle, pi;
};

// A row's projected segment: start, direction, line (a, b, c), angle.
struct Row {
  float us, vs, dx, dy, a, b, c, ang, nrm2;
  bool vis;
};

__device__ Row project_row(const float* sw, const float* ew, bool valid,
                           const float* T, const SearchConsts& k) {
  float ps[3], pe[3];
  for (int i = 0; i < 3; ++i) {
    // sw_w @ R.T + t: the product's fused multiply-add chain, then t
    float as = 0.0f, ae = 0.0f;
    for (int j = 0; j < 3; ++j) {
      as = __fmaf_rn(sw[j], T[4 * i + j], as);
      ae = __fmaf_rn(ew[j], T[4 * i + j], ae);
    }
    ps[i] = __fadd_rn(as, T[4 * i + 3]);
    pe[i] = __fadd_rn(ae, T[4 * i + 3]);
  }
  const bool in_front = ps[2] > 0.05f && pe[2] > 0.05f;
  const float zs = clamp_nan(ps[2], 1e-6f, INFINITY);
  const float ze = clamp_nan(pe[2], 1e-6f, INFINITY);
  Row r;
  r.us = __fadd_rn(__fdiv_rn(__fmul_rn(k.fx, ps[0]), zs), k.cx);
  r.vs = __fadd_rn(__fdiv_rn(__fmul_rn(k.fy, ps[1]), zs), k.cy);
  const float ue = __fadd_rn(__fdiv_rn(__fmul_rn(k.fx, pe[0]), ze), k.cx);
  const float ve = __fadd_rn(__fdiv_rn(__fmul_rn(k.fy, pe[1]), ze), k.cy);
  const bool on_s = r.us >= 0.0f && r.us < k.W && r.vs >= 0.0f && r.vs < k.H;
  const bool on_e = ue >= 0.0f && ue < k.W && ve >= 0.0f && ve < k.H;
  r.vis = valid && in_front && (on_s || on_e);
  r.dx = __fsub_rn(ue, r.us);
  r.dy = __fsub_rn(ve, r.vs);
  const float nrm = __fadd_rn(
      sqrtf(__fadd_rn(__fmul_rn(r.dx, r.dx), __fmul_rn(r.dy, r.dy))), 1e-9f);
  r.a = __fdiv_rn(-r.dy, nrm);
  r.b = __fdiv_rn(r.dx, nrm);
  r.c = -__fadd_rn(__fmul_rn(r.a, r.us), __fmul_rn(r.b, r.vs));
  r.ang = mod_pos(atan2f(r.dy, r.dx), k.pi);
  r.nrm2 = __fmul_rn(nrm, nrm);
  return r;
}

// K23's parameters, by value into each launch.
struct SearchArgs {
  const float* sw;           // (batch, M, 3) map line start, world
  const float* ew;           // (batch, M, 3) end
  const float* desc_m;       // (batch, M, D)
  const unsigned char* valid_m;
  const float* T_cw;         // (batch, 4, 4)
  const float* f_uv_s;       // (batch, L, 2)
  const float* f_uv_e;
  const float* f_angle;      // (batch, L)
  const float* f_desc;       // (batch, L, D)
  const unsigned char* f_valid;
  float* sim;                // (batch, M) output: each row's best similarity
  int M, L, D;
  int S;                     // shared descriptor stride (floats), see stride
  SearchConsts k;
};

struct GateParams {
  float min_sim, sim_floor, quality_bar;
};

// A frame segment's gate inputs, as the rows see them.
struct Seg {
  float s0, s1, e0, e1, mu, mv, ang;
  bool ok;
};

// The gates of one (row, segment) pair: in front and on screen (the row's
// vis), endpoint distances to the projected infinite line, the midpoint's
// parameter along the projected segment, the angle. The plain version's
// float32 operations in its order (the midpoint 0.5 (s + e) is the same
// number for every row).
__device__ __forceinline__ bool pair_gate(const Row& row, const Seg& g,
                                          const SearchConsts& k) {
  const float d_s = fabsf(__fadd_rn(
      __fadd_rn(__fmul_rn(row.a, g.s0), __fmul_rn(row.b, g.s1)), row.c));
  const float d_e = fabsf(__fadd_rn(
      __fadd_rn(__fmul_rn(row.a, g.e0), __fmul_rn(row.b, g.e1)), row.c));
  const bool close = d_s < k.radius && d_e < k.radius;
  const float rel_u = __fsub_rn(g.mu, row.us);
  const float rel_v = __fsub_rn(g.mv, row.vs);
  const float tpar = __fdiv_rn(
      __fadd_rn(__fmul_rn(rel_u, row.dx), __fmul_rn(rel_v, row.dy)),
      row.nrm2);
  const bool overlap = tpar > -0.25f && tpar < 1.25f;
  const float da0 = fabsf(__fsub_rn(row.ang, g.ang));
  const float da = min_nan(da0, __fsub_rn(k.pi, da0));
  return row.vis && g.ok && close && overlap && da < k.max_angle;
}

// (v, i) before (u, j) in torch.argmax's order: NaN above every number,
// equal values (NaN among NaN) by the lower index. A total order, so a
// best found by any tree of these comparisons is the first index of the
// largest value, as argmax's; without NaN it is the first index of the
// largest value by >, the order the first K23 scanned in.
__device__ __forceinline__ bool wins(float v, int i, float u, int j) {
  const bool vn = isnan(v), un = isnan(u);
  if (vn != un) return vn;
  if (vn) return i < j;
  return v > u || (v == u && i < j);
}

// A float's key in an unsigned order that is the float order (-0 below
// +0; the values here hold no -0: similarities are fused multiply-add
// chains from +0, deviations are absolute values), NaN last.
constexpr unsigned kNanKey = 0xffffffffu;
__device__ __forceinline__ unsigned float_key(float x) {
  const unsigned u = __float_as_uint(x);
  return isnan(x) ? kNanKey : ((u & 0x80000000u) ? ~u : (u | 0x80000000u));
}
__device__ __forceinline__ float key_float(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

__host__ __device__ __forceinline__ int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// Ascending bitonic sort of n2 (a power of two) keys in shared memory by
// the whole block; ends with a barrier.
__device__ void bitonic_sort(unsigned* keys, int n2) {
  for (int k = 2; k <= n2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < n2 / 2; t += blockDim.x) {
        const int i = ((t & ~(j - 1)) << 1) | (t & (j - 1));
        const int p = i | j;
        const unsigned a = keys[i], b = keys[p];
        if ((a > b) == ((i & k) == 0)) {
          keys[i] = b;
          keys[p] = a;
        }
      }
      __syncthreads();
    }
  }
}

// The same bitonic network on kThreadSort keys held one a thread by
// threads 0..kThreadSort-1 (every thread of the block calls it): partners
// in a warp by shuffles, across warps through xchg (kThreadSort shared
// words) and a barrier.
// Returns the key at rank threadIdx.x.
__device__ unsigned thread_bitonic(unsigned key, unsigned* xchg) {
  const int i = threadIdx.x;
  const bool in = i < kThreadSort;
  for (int k = 2; k <= kThreadSort; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      unsigned o;
      if (j >= 32) {
        if (in) xchg[i] = key;
        __syncthreads();
        o = in ? xchg[i ^ j] : key;
        __syncthreads();
      } else {
        o = __shfl_xor_sync(0xffffffffu, key, j);
      }
      const bool keep_min = ((i & j) == 0) == ((i & k) == 0);
      key = keep_min ? min(key, o) : max(key, o);
    }
  }
  return key;
}

// lax_compat.nanmedian's two middle ranks of n values and their weights,
// in float32.
struct MiddleRanks {
  int lo, hi;
  float lw, hw;
};

__device__ __forceinline__ MiddleRanks middle_ranks(int n) {
  const float nf = static_cast<float>(n);
  const float q = __fmul_rn(0.5f, __fsub_rn(nf, 1.0f));
  const float lo = floorf(q), hi = ceilf(q);
  const float last = __fsub_rn(nf, 1.0f);
  MiddleRanks m;
  m.lo = static_cast<int>(fmaxf(fminf(lo, last), 0.0f));
  m.hi = static_cast<int>(fmaxf(fminf(hi, last), 0.0f));
  m.hw = __fsub_rn(q, lo);
  m.lw = __fsub_rn(1.0f, m.hw);
  return m;
}

// lax_compat.nanmedian of n non-NaN values from the keys at their two
// middle ranks (sorted); NaN when n = 0.
__device__ __forceinline__ float weighted_median(int n, const MiddleRanks& m,
                                                 unsigned k_lo,
                                                 unsigned k_hi) {
  const float at_lo = n > 0 ? key_float(k_lo) : NAN;
  const float at_hi = n > 0 ? key_float(k_hi) : NAN;
  return __fadd_rn(__fmul_rn(at_lo, m.lw), __fmul_rn(at_hi, m.hw));
}

// The nanmedian of n2 sorted keys in shared memory (n of them not NaN).
__device__ __forceinline__ float block_nanmedian(const unsigned* keys,
                                                 int n) {
  const MiddleRanks m = middle_ranks(n);
  return weighted_median(n, m, keys[m.lo], keys[m.hi]);
}

// A candidate's absolute deviation from the first median, as a key; NaN
// (kNanKey) where the deviation is NaN.
__device__ __forceinline__ unsigned deviation_key(unsigned key, float med) {
  const float dev = fabsf(__fsub_rn(key_float(key), med));
  return float_key(dev);
}

// The MAD-adaptive gate and the mutual check of one problem, by the whole
// block: bs, bi its M rows' best similarities and segments, back the L
// columns' best rows, row_ok (or NULL) a test each row must also pass;
// counts four shared words; keys max(kThreadSort, pow2_at_least(M)) words
// of shared memory. Writes idx (M); needs
// blockDim >= kThreadSort. The candidates' keys are gathered (in any
// order: a sort's result does not depend on it), then sorted one a thread
// up to kThreadSort of them (thread_bitonic), else in shared memory
// (bitonic_sort).
__device__ void gate_tail(const float* bs, const int* bi, const int* back,
                          int M, unsigned* keys, int* counts,
                          const GateParams& g, int* __restrict__ idx,
                          const int* row_ok = nullptr) {
  const int tid = threadIdx.x, lane = tid & 31;
  if (tid < 3) counts[tid] = 0;
  __syncthreads();
  // the two medians: the candidates (best > -0.5), sorted; then their
  // absolute deviations from the first median, sorted
  const int span = (M + blockDim.x - 1) / blockDim.x * blockDim.x;
  for (int i = tid; i < span; i += blockDim.x) {
    const bool cand = i < M && bs[i] > -0.5f;
    const unsigned ball = __ballot_sync(0xffffffffu, cand);
    const unsigned earned =
        __ballot_sync(0xffffffffu, cand && bs[i] >= g.quality_bar);
    int base = 0;
    if (lane == 0 && ball != 0) {
      base = atomicAdd(&counts[0], __popc(ball));  // integers: exact
      atomicAdd(&counts[1], __popc(earned));
    }
    base = __shfl_sync(0xffffffffu, base, 0);
    if (cand) {
      keys[base + __popc(ball & ((1u << lane) - 1u))] = float_key(bs[i]);
    }
  }
  __syncthreads();
  const int n = counts[0];
  float* th_s = reinterpret_cast<float*>(counts + 3);
  if (n <= kThreadSort) {
    // one key a thread: the candidates' first, then their deviations
    unsigned key = tid < n ? keys[tid] : kNanKey;
    __syncthreads();  // keys is the exchange area from here
    key = thread_bitonic(key, keys);
    if (tid < kThreadSort) keys[tid] = key;
    __syncthreads();
    const float med = block_nanmedian(keys, n);
    key = tid < n ? deviation_key(key, med) : kNanKey;
    const int nd = __syncthreads_count(tid < kThreadSort && key != kNanKey);
    key = thread_bitonic(key, keys);
    if (tid < kThreadSort) keys[tid] = key;
    __syncthreads();
    const float mad = __fmul_rn(1.4826f, block_nanmedian(keys, nd));
    const float th_adapt = clamp_nan(__fsub_rn(med, __fmul_rn(1.0f, mad)),
                                     g.sim_floor, g.min_sim);
    if (tid == 0) {
      *th_s = (counts[1] >= 6 && isfinite(th_adapt)) ? th_adapt : g.min_sim;
    }
  } else {
    const int n2 = pow2_at_least(n);
    for (int i = n + tid; i < n2; i += blockDim.x) keys[i] = kNanKey;
    __syncthreads();
    bitonic_sort(keys, n2);
    const float med = block_nanmedian(keys, n);
    __syncthreads();  // every thread read the keys
    int nd = 0;
    for (int i = tid; i < n; i += blockDim.x) {
      keys[i] = deviation_key(keys[i], med);
      nd += keys[i] != kNanKey ? 1 : 0;
    }
    atomicAdd(&counts[2], nd);
    __syncthreads();
    bitonic_sort(keys, n2);
    const float mad = __fmul_rn(1.4826f, block_nanmedian(keys, counts[2]));
    const float th_adapt = clamp_nan(__fsub_rn(med, __fmul_rn(1.0f, mad)),
                                     g.sim_floor, g.min_sim);
    if (tid == 0) {
      *th_s = (counts[1] >= 6 && isfinite(th_adapt)) ? th_adapt : g.min_sim;
    }
  }
  __syncthreads();
  const float th = *th_s;
  // the mutual check: a row's best segment must have it as its best row
  // (and, where given, the row's own test passed)
  for (int m = tid; m < M; m += blockDim.x) {
    const int b = bi[m];
    const bool own = row_ok == nullptr || row_ok[m] != 0;
    idx[m] = (bs[m] > th && back[b] == m && own) ? b : -1;
  }
}

// The shared stride of a descriptor row (floats): D rounded up to whole
// float4s, an odd number of them, so that 8 lanes reading 8 rows' float4
// at one column hit 8 distinct bank quads.
__host__ __device__ __forceinline__ int desc_stride(int D) {
  const int q = (D + 3) / 4;
  return 4 * (q | 1);
}

// A row tile's outputs, at the start of the block's dynamic shared memory
// (the cluster's first block reads them through distributed shared
// memory): each row's best similarity and segment, each column's best
// value and row among the tile's rows.
__host__ __device__ __forceinline__ int tile_out_words(int L) {
  return (2 * kRows + 2 * L + 3) / 4 * 4;
}

// Words of the tile's work area after its outputs: the frame's and the
// tile's descriptors, the segments' gate inputs and the warps' column
// bests.
__host__ __device__ __forceinline__ int tile_work_words(int L, int S) {
  return L * S + kRows * S + 8 * L + 2 * kWarps * L;
}

// One row tile of problem b: rows [m0, m0 + n_rows) (n_rows >= 1) against
// every frame segment. Leaves the tile's outputs at sh (tile_out_words)
// and writes the rows' best similarities to a.sim.
__device__ void search_tile(const SearchArgs& a, int b, int m0, int n_rows,
                            float* sh, Row* rows) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int L = a.L, D = a.D, S = a.S;
  float* out_bs = sh;
  int* out_bi = reinterpret_cast<int*>(sh + kRows);
  float* out_cv = sh + 2 * kRows;
  int* out_cr = reinterpret_cast<int*>(sh + 2 * kRows + L);
  float* fd = sh + tile_out_words(L);  // L x S
  float* md = fd + L * S;              // kRows x S
  float* seg = md + kRows * S;         // 8 x L: the Seg fields
  float* wcv = seg + 8 * L;            // kWarps x L column bests
  int* wcr = reinterpret_cast<int*>(wcv + kWarps * L);
  const size_t mb = static_cast<size_t>(b) * a.M;
  const size_t lb = static_cast<size_t>(b) * L;
  // projection: a row's endpoints through T_cw, by one thread a row
  if (tid < n_rows) {
    const size_t m = mb + m0 + tid;
    rows[tid] = project_row(a.sw + 3 * m, a.ew + 3 * m, a.valid_m[m] != 0,
                            a.T_cw + 16 * static_cast<size_t>(b), a.k);
  }
  for (int l = tid; l < L; l += blockDim.x) {
    const size_t f = lb + l;
    const float s0 = a.f_uv_s[2 * f], s1 = a.f_uv_s[2 * f + 1];
    const float e0 = a.f_uv_e[2 * f], e1 = a.f_uv_e[2 * f + 1];
    seg[l] = s0;
    seg[L + l] = s1;
    seg[2 * L + l] = e0;
    seg[3 * L + l] = e1;
    seg[4 * L + l] = __fmul_rn(0.5f, __fadd_rn(s0, e0));
    seg[5 * L + l] = __fmul_rn(0.5f, __fadd_rn(s1, e1));
    seg[6 * L + l] = a.f_angle[f];
    seg[7 * L + l] = a.f_valid[f] ? 1.0f : 0.0f;
  }
  // the descriptors: every copy of a thread in flight at once
  // (asynchronous copies), the rows past the tile's zero
  for (int l = warp; l < L; l += kWarps) {
    const float* src = a.f_desc + (lb + l) * D;
    for (int j = lane; j < D; j += 32) {
      __pipeline_memcpy_async(fd + l * S + j, src + j, sizeof(float));
    }
  }
  for (int r = warp; r < kRows; r += kWarps) {
    if (r < n_rows) {
      const float* src = a.desc_m + (mb + m0 + r) * D;
      for (int j = lane; j < D; j += 32) {
        __pipeline_memcpy_async(md + r * S + j, src + j, sizeof(float));
      }
    } else {
      for (int j = lane; j < D; j += 32) md[r * S + j] = 0.0f;
    }
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  // products: warp w takes rows 2w and 2w + 1, lane the segments lane
  // and lane + 32 of each group of 64, four independent chains of fused
  // multiply-adds a thread, each in index order
  const int r0 = warp * kRowsPerWarp;
  const float4* md4 = reinterpret_cast<const float4*>(md);
  const float4* fd4 = reinterpret_cast<const float4*>(fd);
  const int S4 = S / 4, D4 = D / 4;
  float row_v[kRowsPerWarp];
  int row_l[kRowsPerWarp];
  for (int i = 0; i < kRowsPerWarp; ++i) {
    row_v[i] = -INFINITY;
    row_l[i] = INT_MAX;  // below every segment
  }
  for (int lg = 0; lg < L; lg += 64) {
    int lx[2];
    const float4* y[2];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      lx[c] = lg + 32 * c + lane;
      y[c] = fd4 + min(lx[c], L - 1) * S4;
    }
    float acc[kRowsPerWarp][2];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) acc[i][0] = acc[i][1] = 0.0f;
#pragma unroll 2
    for (int j4 = 0; j4 < D4; ++j4) {
      const float4 y0 = y[0][j4], y1 = y[1][j4];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float4 x = md4[(r0 + i) * S4 + j4];
        acc[i][0] = __fmaf_rn(x.x, y0.x, acc[i][0]);
        acc[i][0] = __fmaf_rn(x.y, y0.y, acc[i][0]);
        acc[i][0] = __fmaf_rn(x.z, y0.z, acc[i][0]);
        acc[i][0] = __fmaf_rn(x.w, y0.w, acc[i][0]);
        acc[i][1] = __fmaf_rn(x.x, y1.x, acc[i][1]);
        acc[i][1] = __fmaf_rn(x.y, y1.y, acc[i][1]);
        acc[i][1] = __fmaf_rn(x.z, y1.z, acc[i][1]);
        acc[i][1] = __fmaf_rn(x.w, y1.w, acc[i][1]);
      }
    }
    for (int j = 4 * D4; j < D; ++j) {
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float x = md[(r0 + i) * S + j];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          acc[i][c] = __fmaf_rn(x, fd[min(lx[c], L - 1) * S + j], acc[i][c]);
        }
      }
    }
    // the gates; a pair that fails one has similarity -1
    float col_v[2];
    int col_r[2];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      col_v[c] = -INFINITY;
      col_r[c] = INT_MAX;
      const int l = lx[c];
      if (l >= L) continue;
      Seg g;
      g.s0 = seg[l];
      g.s1 = seg[L + l];
      g.e0 = seg[2 * L + l];
      g.e1 = seg[3 * L + l];
      g.mu = seg[4 * L + l];
      g.mv = seg[5 * L + l];
      g.ang = seg[6 * L + l];
      g.ok = seg[7 * L + l] != 0.0f;
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const int r = r0 + i;
        if (r >= n_rows) continue;
        const float s = pair_gate(rows[r], g, a.k) ? acc[i][c] : -1.0f;
        if (wins(s, l, row_v[i], row_l[i])) {
          row_v[i] = s;
          row_l[i] = l;
        }
        if (wins(s, r, col_v[c], col_r[c])) {
          col_v[c] = s;
          col_r[c] = r;
        }
      }
      wcv[warp * L + l] = col_v[c];
      wcr[warp * L + l] = col_r[c];
    }
  }
  // row and column bests: a row's over the warp's lanes by shuffles, a
  // column's over the warps in row order
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    float v = row_v[i];
    int l = row_l[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, v, off);
      const int ol = __shfl_xor_sync(0xffffffffu, l, off);
      if (wins(ov, ol, v, l)) {
        v = ov;
        l = ol;
      }
    }
    const int r = r0 + i;
    if (lane == 0 && r < n_rows) {
      out_bs[r] = v;
      out_bi[r] = l;
      a.sim[mb + m0 + r] = v;
    }
  }
  __syncthreads();
  const int n_warps = (n_rows + kRowsPerWarp - 1) / kRowsPerWarp;
  for (int l = tid; l < L; l += blockDim.x) {
    float v = wcv[l];
    int r = wcr[l];
    for (int w = 1; w < n_warps; ++w) {
      if (wins(wcv[w * L + l], wcr[w * L + l], v, r)) {
        v = wcv[w * L + l];
        r = wcr[w * L + l];
      }
    }
    out_cv[l] = v;
    out_cr[l] = m0 + r;
  }
  __syncthreads();
}

// K23 at M <= kSearchCluster * kRows: one cluster per problem, block q
// the rows [32 q, 32 q + 32); the first block gathers every tile's
// outputs through distributed shared memory and runs the gate.
__global__ void __cluster_dims__(kSearchCluster, 1, 1)
    __launch_bounds__(kSearchThreads)
    lines_search_cluster_kernel(const SearchArgs a, const GateParams g,
                                int n2, int* __restrict__ idx) {
  cg::cluster_group cl = cg::this_cluster();
  extern __shared__ __align__(16) float search_smem[];
  __shared__ Row rows[kRows];
  __shared__ int counts[4];
  const int q = static_cast<int>(cl.block_rank()), b = blockIdx.y;
  const int m0 = q * kRows, n_rows = min(kRows, a.M - m0);
  const int L = a.L;
  if (n_rows > 0) search_tile(a, b, m0, n_rows, search_smem, rows);
  cl.sync();  // every tile's outputs
  // the first block: its gather area after its own tile's outputs
  unsigned* keys =
      reinterpret_cast<unsigned*>(search_smem + tile_out_words(L));
  float* bs = reinterpret_cast<float*>(keys + n2);
  int* bi = reinterpret_cast<int*>(bs + a.M);
  int* back = bi + a.M;
  if (q == 0) {
    for (int m = threadIdx.x; m < a.M; m += blockDim.x) {
      const float* o = cl.map_shared_rank(search_smem, m / kRows);
      bs[m] = o[m % kRows];
      bi[m] = reinterpret_cast<const int*>(o + kRows)[m % kRows];
    }
    const int n_tiles = (a.M + kRows - 1) / kRows;
    for (int l = threadIdx.x; l < L; l += blockDim.x) {
      float v = search_smem[2 * kRows + l];
      int r = reinterpret_cast<const int*>(search_smem + 2 * kRows + L)[l];
      for (int t = 1; t < n_tiles; ++t) {
        const float* o = cl.map_shared_rank(search_smem, t);
        const float ov = o[2 * kRows + l];
        const int orow = reinterpret_cast<const int*>(o + 2 * kRows + L)[l];
        if (wins(ov, orow, v, r)) {
          v = ov;
          r = orow;
        }
      }
      back[l] = r;
    }
  }
  cl.sync();  // no block leaves while the first reads its shared memory
  if (q != 0) return;
  gate_tail(bs, bi, back, a.M, keys, counts, g,
            idx + static_cast<size_t>(b) * a.M);
}

// K23 above one cluster's rows, launch 1 of 2: one block per row tile of
// every problem; the tiles' outputs to global scratch.
__global__ void __launch_bounds__(kSearchThreads)
    lines_search_rows_kernel(const SearchArgs a, int* __restrict__ best_idx,
                             float* __restrict__ col_val,
                             int* __restrict__ col_row) {
  extern __shared__ __align__(16) float search_smem[];
  __shared__ Row rows[kRows];
  const int b = blockIdx.y, m0 = blockIdx.x * kRows;
  const int n_rows = min(kRows, a.M - m0), L = a.L;
  search_tile(a, b, m0, n_rows, search_smem, rows);
  const int* out_bi = reinterpret_cast<const int*>(search_smem + kRows);
  const int* out_cr =
      reinterpret_cast<const int*>(search_smem + 2 * kRows + L);
  if (threadIdx.x < n_rows) {
    best_idx[static_cast<size_t>(b) * a.M + m0 + threadIdx.x] =
        out_bi[threadIdx.x];
  }
  const size_t o = (static_cast<size_t>(b) * gridDim.x + blockIdx.x) * L;
  for (int l = threadIdx.x; l < L; l += blockDim.x) {
    col_val[o + l] = search_smem[2 * kRows + l];
    col_row[o + l] = out_cr[l];
  }
}

// Launch 2 of 2: one block per problem merges the columns' bests over the
// tiles in row order and runs the gate.
__global__ void __launch_bounds__(kGateThreads) lines_search_gate_kernel(
    const int* __restrict__ best_idx, const float* __restrict__ best_sim,
    const float* __restrict__ col_val, const int* __restrict__ col_row, int M,
    int L, int n_blk, int n2, const GateParams g, int* __restrict__ idx) {
  extern __shared__ __align__(16) unsigned gate_keys[];  // n2, then L
  int* back = reinterpret_cast<int*>(gate_keys + n2);
  __shared__ int counts[4];
  const int b = blockIdx.x;
  const size_t mb = static_cast<size_t>(b) * M;
  for (int l = threadIdx.x; l < L; l += blockDim.x) {
    const size_t c0 = static_cast<size_t>(b) * n_blk * L + l;
    float v = col_val[c0];
    int r = col_row[c0];
    for (int t = 1; t < n_blk; ++t) {
      const size_t c = c0 + static_cast<size_t>(t) * L;
      if (wins(col_val[c], col_row[c], v, r)) {
        v = col_val[c];
        r = col_row[c];
      }
    }
    back[l] = r;
  }
  gate_tail(best_sim + mb, best_idx + mb, back, M, gate_keys, counts, g,
            idx + mb);
}

int search_blocks(int M) { return (M + kRows - 1) / kRows; }

// K47: a block of eight warps a problem. Shared memory (words): the two
// descriptor sets at an odd stride, the gated similarities, the rows' bests,
// best segments and ratio tests, the columns' best rows, the gate's keys.
constexpr int kMatchThreads = 256;
constexpr int kMatchChains = 4;  // independent products a thread forms at once

__host__ __device__ __forceinline__ int match_stride(int D) { return D | 1; }

__host__ __device__ __forceinline__ size_t match_smem_words(int A, int B,
                                                            int D, int n2) {
  return static_cast<size_t>(A + B) * match_stride(D) +
         static_cast<size_t>(A) * B + 3 * static_cast<size_t>(A) + B + n2;
}

struct MatchParams {
  float max_angle, ratio, pi;
};

// K47, one problem a block: the A x B similarities (each the plain
// version's chain d = 0 .. D - 1 of rounded products and sums), the angle
// gate, each row's top two in lax.top_k's order, the ratio test, each
// column's best row, then the adaptive gate and the mutual check of
// gate_tail.
__global__ void __launch_bounds__(kMatchThreads) match_lines_kernel(
    const float* __restrict__ desc_a, const float* __restrict__ desc_b,
    const unsigned char* __restrict__ valid_a,
    const unsigned char* __restrict__ valid_b,
    const float* __restrict__ angle_a, const float* __restrict__ angle_b,
    int A, int B, int D, int n2, const MatchParams p, const GateParams g,
    int* __restrict__ idx, float* __restrict__ best) {
  extern __shared__ __align__(16) float match_smem[];
  __shared__ int counts[4];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int prob = blockIdx.x, S = match_stride(D);
  float* da = match_smem;
  float* db = da + static_cast<size_t>(A) * S;
  float* sim = db + static_cast<size_t>(B) * S;
  float* bs = sim + static_cast<size_t>(A) * B;
  int* bi = reinterpret_cast<int*>(bs + A);
  int* rok = bi + A;
  int* back = rok + A;
  unsigned* keys = reinterpret_cast<unsigned*>(back + B);
  desc_a += static_cast<size_t>(prob) * A * D;
  desc_b += static_cast<size_t>(prob) * B * D;
  valid_a += static_cast<size_t>(prob) * A;
  valid_b += static_cast<size_t>(prob) * B;
  angle_a += static_cast<size_t>(prob) * A;
  angle_b += static_cast<size_t>(prob) * B;
  for (int i = tid; i < A * D; i += kMatchThreads) {
    da[(i / D) * S + i % D] = desc_a[i];
  }
  for (int i = tid; i < B * D; i += kMatchThreads) {
    db[(i / D) * S + i % D] = desc_b[i];
  }
  __syncthreads();
  // the similarities, kMatchChains pairs a thread at once, and the gate
  const int pairs = A * B;
  for (int base = 0; base < pairs; base += kMatchChains * kMatchThreads) {
    int pa[kMatchChains], pb[kMatchChains];
    float acc[kMatchChains];
#pragma unroll
    for (int c = 0; c < kMatchChains; ++c) {
      const int q = min(base + c * kMatchThreads + tid, pairs - 1);
      pa[c] = q / B;
      pb[c] = q % B;
      acc[c] = __fmul_rn(da[pa[c] * S], db[pb[c] * S]);
    }
    for (int d = 1; d < D; ++d) {
#pragma unroll
      for (int c = 0; c < kMatchChains; ++c) {
        acc[c] = __fadd_rn(acc[c],
                           __fmul_rn(da[pa[c] * S + d], db[pb[c] * S + d]));
      }
    }
#pragma unroll
    for (int c = 0; c < kMatchChains; ++c) {
      const int q = base + c * kMatchThreads + tid;
      if (q >= pairs) continue;
      const float d0 = fabsf(__fsub_rn(angle_a[pa[c]], angle_b[pb[c]]));
      const float dang = min_nan(d0, __fsub_rn(p.pi, d0));
      const bool gate = valid_a[pa[c]] != 0 && valid_b[pb[c]] != 0 &&
                        dang < p.max_angle;
      sim[q] = gate ? acc[c] : -1.0f;
    }
  }
  __syncthreads();
  // each row's top two (a warp a row) and its ratio test
  for (int a = warp; a < A; a += kMatchThreads / 32) {
    float v1 = -INFINITY, v2 = -INFINITY;
    int i1 = INT_MAX, i2 = INT_MAX;
    for (int b = lane; b < B; b += 32) {
      const float v = sim[a * B + b];
      if (wins(v, b, v1, i1)) {
        v2 = v1;
        i2 = i1;
        v1 = v;
        i1 = b;
      } else if (wins(v, b, v2, i2)) {
        v2 = v;
        i2 = b;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float o1 = __shfl_xor_sync(0xffffffffu, v1, off);
      const float o2 = __shfl_xor_sync(0xffffffffu, v2, off);
      const int j1 = __shfl_xor_sync(0xffffffffu, i1, off);
      const int j2 = __shfl_xor_sync(0xffffffffu, i2, off);
      if (wins(o1, j1, v1, i1)) {  // the other's first leads
        if (wins(v1, i1, o2, j2)) {
          v2 = v1;
          i2 = i1;
        } else {
          v2 = o2;
          i2 = j2;
        }
        v1 = o1;
        i1 = j1;
      } else if (wins(o1, j1, v2, i2)) {
        v2 = o1;
        i2 = j1;
      }
    }
    if (lane == 0) {
      bs[a] = v1;
      bi[a] = i1;
      rok[a] = __fsub_rn(1.0f, v1) <
               __fadd_rn(__fmul_rn(p.ratio, __fsub_rn(1.0f, v2)), 1e-9f);
      best[static_cast<size_t>(prob) * A + a] = v1;
    }
  }
  // each column's best row
  for (int b = tid; b < B; b += kMatchThreads) {
    float v = sim[b];
    int r = 0;
    for (int a = 1; a < A; ++a) {
      if (wins(sim[a * B + b], a, v, r)) {
        v = sim[a * B + b];
        r = a;
      }
    }
    back[b] = r;
  }
  __syncthreads();
  gate_tail(bs, bi, back, A, keys, counts, g,
            idx + static_cast<size_t>(prob) * A, rok);
}


}  // namespace

// K22 for `batch` frames: depth (batch, h, w) metres; uv_s, uv_e (batch,
// L, 2), valid (batch, L); alphas the S float32 sample positions
// (lax_compat.linspace(0.02, 0.98, S)); hyp the (iters, 2) int64 table;
// outputs p3d_s, p3d_e (batch, L, 3), has_3d (batch, L).
PSL_API int psl_lift_lines_3d(const float* depth, int h, int w,
                              const float* uv_s, const float* uv_e,
                              const unsigned char* valid, int batch, int L,
                              const float* alphas, int S,
                              const long long* hyp, int iters, float fx,
                              float fy, float cx, float cy, float c1,
                              float c2, float c3, int min_inliers,
                              float* p3d_s, float* p3d_e,
                              unsigned char* has_3d, cudaStream_t stream) {
  if (batch < 1 || L < 1 || h < 1 || w < 1 || S < 2 || S > kMaxSamples ||
      iters < 1 || iters > kMaxHyp) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  LiftConsts c;
  c.cx = cx;
  c.cy = cy;
  c.inv_fx = 1.0f / fx;
  c.inv_fy = 1.0f / fy;
  c.c1 = c1;
  c.c2 = c2;
  c.c3 = c3;
  c.min_inliers = min_inliers;
  lines_lift_kernel<<<dim3(L, batch), kLiftThreads, 0, stream>>>(
      depth, h, w, uv_s, uv_e, valid, L, alphas, S, hyp, iters, c, p3d_s,
      p3d_e, has_3d);
  return static_cast<int>(cudaGetLastError());
}

// Words (4 bytes) of scratch psl_search_lines needs: none when a problem's
// rows fit one cluster.
PSL_API long long psl_search_lines_scratch_words(int M, int L, int batch) {
  if (M <= kSearchCluster * kRows) return 0;
  return static_cast<long long>(batch) *
         (M + 2LL * search_blocks(M) * L);
}

// K23 for `batch` problems: map lines sw, ew (batch, M, 3), desc_m (batch,
// M, D), valid_m (batch, M); T_cw (batch, 4, 4); frame segments f_uv_s,
// f_uv_e (batch, L, 2), f_angle (batch, L), f_desc (batch, L, D), f_valid
// (batch, L); quality_bar = float(0.5 (sim_floor + min_sim)); outputs idx
// (batch, M) int32 and sim (batch, M). *launches is the number of
// launches made: 1 up to kSearchCluster * kRows rows (256), 2 above.
PSL_API int psl_search_lines(const float* sw, const float* ew,
                             const float* desc_m, const unsigned char* valid_m,
                             const float* T_cw, int M, const float* f_uv_s,
                             const float* f_uv_e, const float* f_angle,
                             const float* f_desc,
                             const unsigned char* f_valid, int L, int D,
                             int batch, float fx, float fy, float cx,
                             float cy, float W, float H, float radius,
                             float max_angle, float min_sim, float sim_floor,
                             float quality_bar, void* scratch, int* idx,
                             float* sim, int* launches, cudaStream_t stream) {
  *launches = 0;
  if (batch < 1 || batch > 65535 || M < 1 || L < 1 || D < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  SearchArgs a;
  a.sw = sw;
  a.ew = ew;
  a.desc_m = desc_m;
  a.valid_m = valid_m;
  a.T_cw = T_cw;
  a.f_uv_s = f_uv_s;
  a.f_uv_e = f_uv_e;
  a.f_angle = f_angle;
  a.f_desc = f_desc;
  a.f_valid = f_valid;
  a.sim = sim;
  a.M = M;
  a.L = L;
  a.D = D;
  a.S = desc_stride(D);
  a.k.fx = fx;
  a.k.fy = fy;
  a.k.cx = cx;
  a.k.cy = cy;
  a.k.W = W;
  a.k.H = H;
  a.k.radius = radius;
  a.k.max_angle = max_angle;
  a.k.pi = static_cast<float>(3.14159265358979323846);
  GateParams g;
  g.min_sim = min_sim;
  g.sim_floor = sim_floor;
  g.quality_bar = quality_bar;
  // the gate's keys: the candidates', or kThreadSort to sort one a thread
  const int n2 = pow2_at_least(M) > kThreadSort ? pow2_at_least(M)
                                                : kThreadSort;
  const size_t tile_words = tile_out_words(L) +
                            static_cast<size_t>(tile_work_words(L, a.S));
  int rc = 0;
  if (M <= kSearchCluster * kRows) {
    // the first block's gather area: keys, rows' bests, columns' rows
    const size_t gather = tile_out_words(L) + static_cast<size_t>(n2) +
                          2 * static_cast<size_t>(M) + L;
    const size_t smem = 4 * (tile_words > gather ? tile_words : gather);
    rc = psl_opt_in_smem(
        reinterpret_cast<const void*>(lines_search_cluster_kernel), smem);
    if (rc != 0) return rc;
    lines_search_cluster_kernel<<<dim3(kSearchCluster, batch),
                                  kSearchThreads, smem, stream>>>(a, g, n2,
                                                                  idx);
    rc = static_cast<int>(cudaGetLastError());
    if (rc == 0) *launches = 1;
    return rc;
  }
  const int n_blk = search_blocks(M);
  int* best_idx = static_cast<int*>(scratch);
  float* col_val =
      reinterpret_cast<float*>(best_idx + static_cast<size_t>(batch) * M);
  int* col_row = reinterpret_cast<int*>(
      col_val + static_cast<size_t>(batch) * n_blk * L);
  const size_t rows_smem = 4 * tile_words;
  const size_t gate_smem = 4 * (static_cast<size_t>(n2) + L);
  rc = psl_opt_in_smem(
      reinterpret_cast<const void*>(lines_search_rows_kernel), rows_smem);
  if (rc == 0) {
    rc = psl_opt_in_smem(
        reinterpret_cast<const void*>(lines_search_gate_kernel), gate_smem);
  }
  if (rc != 0) return rc;
  lines_search_rows_kernel<<<dim3(n_blk, batch), kSearchThreads, rows_smem,
                             stream>>>(a, best_idx, col_val, col_row);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  *launches = 1;
  lines_search_gate_kernel<<<batch, kGateThreads, gate_smem, stream>>>(
      best_idx, sim, col_val, col_row, M, L, n_blk, n2, g, idx);
  rc = static_cast<int>(cudaGetLastError());
  if (rc == 0) *launches = 2;
  return rc;
}

// K47 for `batch` problems: desc_a (batch, A, D), desc_b (batch, B, D),
// valid_a (batch, A), valid_b (batch, B), angle_a (batch, A), angle_b
// (batch, B); quality_bar = float(0.5 (sim_floor + min_sim)); outputs idx
// (batch, A) int32 (the matched column or -1) and best (batch, A), each
// row's best similarity.
PSL_API int psl_match_lines(const float* desc_a, const float* desc_b,
                            const unsigned char* valid_a,
                            const unsigned char* valid_b,
                            const float* angle_a, const float* angle_b,
                            int A, int B, int D, int batch, float max_angle,
                            float ratio, float min_sim, float sim_floor,
                            float quality_bar, int* idx, float* best,
                            cudaStream_t stream) {
  if (batch < 1 || A < 1 || B < 1 || D < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n2 = pow2_at_least(A) > kThreadSort ? pow2_at_least(A)
                                                : kThreadSort;
  const size_t smem = 4 * match_smem_words(A, B, D, n2);
  const int rc = psl_opt_in_smem(
      reinterpret_cast<const void*>(match_lines_kernel), smem);
  if (rc != 0) return rc;
  MatchParams p;
  p.max_angle = max_angle;
  p.ratio = ratio;
  p.pi = static_cast<float>(3.14159265358979323846);
  GateParams g;
  g.min_sim = min_sim;
  g.sim_floor = sim_floor;
  g.quality_bar = quality_bar;
  match_lines_kernel<<<batch, kMatchThreads, smem, stream>>>(
      desc_a, desc_b, valid_a, valid_b, angle_a, angle_b, A, B, D, n2, p, g,
      idx, best);
  return static_cast<int>(cudaGetLastError());
}
