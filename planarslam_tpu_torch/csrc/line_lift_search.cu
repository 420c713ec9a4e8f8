// K22 lift_lines_3d and K23 search_lines_by_projection: a frame's segments
// lifted to 3D, and map lines matched to a frame's segments by projection,
// `batch` problems per call.
//
// K22 replaces planarslam_tpu/ops/lines.py::lift_lines_3d (the port's plain
// version is ops/lines.py::lift_lines_3d_plain). One block per line: the
// nearest depth at n_depth_samples points of the segment (round half to
// even) and their back-projection, sigma(z), the fixed two-point hypothesis
// table (lines.ransac_table, numpy seed 99), the point-line distances under
// the gate 1.5 sigma + 0.01, the inlier counts and the first best, then a
// weighted PCA through eig3.cuh::psl_eigh_sym3x3, the extent along the
// principal direction and the has_3d test. The sample, hypothesis and
// inlier arithmetic is the plain version's PyTorch arithmetic on the card,
// operation by operation (a sum of three terms adds the first and the third
// first, as PyTorch's reduction over a last dimension of 3 does; the
// weighted mean sums the samples into four interleaved accumulators as its
// reduction over dimension 1 does; the covariance is the chain of fused
// multiply-adds of the batched product einsum runs): the inlier counts and
// the best hypothesis are the plain version's. The eigen-solve is eig3.cuh's,
// so the direction, the endpoints and the extent gate agree to float
// rounding.
// Bound: latency (64 lines x 32 hypotheses x 48 samples, ~1.5e6 operations).
//
// K23 replaces planarslam_tpu/ops/lines.py::search_lines_by_projection and
// its _adaptive_sim_gate. Two launches:
//   1. rows: a block projects 32 map lines' endpoints through T_cw (the
//      projection is the fused multiply-add chain of the 3 x 3 product),
//      gates their pairs with every frame segment (in front, on screen,
//      endpoint distance to the projected infinite line, midpoint
//      parameter, angle), forms the 72-wide descriptor dot products as a
//      chain of fused multiply-adds in index order, takes each row's first
//      best and each column's first best among its rows;
//   2. gate, one block per problem: the two nanmedians of the MAD-adaptive
//      gate (the values at the two middle ranks found by counting, weighted
//      as lax_compat.nanmedian weights them), the earned count, the
//      threshold, the columns' first best over the blocks in row order, and
//      the mutual check.
// Bound: operations (M x L pairs x 72 multiply-adds: 2.4 MFLOP for M = 256,
// 38 MFLOP for the 4096 lines of local mapping's fuse).
#include "common.cuh"
#include "eig3.cuh"

namespace {

constexpr int kMaxSamples = 64;
constexpr int kMaxHyp = 64;
constexpr int kLiftThreads = 64;
constexpr int kRows = 32;
constexpr int kSearchThreads = 256;
constexpr int kGateThreads = 1024;

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

__global__ void lines_lift_kernel(
    const float* __restrict__ depth, int h, int w,
    const float* __restrict__ uv_s, const float* __restrict__ uv_e,
    const unsigned char* __restrict__ valid, int L,
    const float* __restrict__ alphas, int S, const long long* __restrict__ hyp,
    int iters, LiftConsts c, float* __restrict__ p3d_s,
    float* __restrict__ p3d_e, unsigned char* __restrict__ has_3d) {
  __shared__ float p[kMaxSamples][3];
  __shared__ float sigma[kMaxSamples];
  __shared__ bool z_ok[kMaxSamples];
  __shared__ int n_inl[kMaxHyp];
  __shared__ unsigned long long inl_bits[kMaxHyp];
  const int l = blockIdx.x, b = blockIdx.y;
  const size_t li = static_cast<size_t>(b) * L + l;
  const float sx = uv_s[2 * li], sy = uv_s[2 * li + 1];
  const float dx = __fsub_rn(uv_e[2 * li], sx);
  const float dy = __fsub_rn(uv_e[2 * li + 1], sy);
  const float* dep = depth + static_cast<size_t>(b) * h * w;
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    const float pu = __fadd_rn(sx, __fmul_rn(alphas[s], dx));
    const float pv = __fadd_rn(sy, __fmul_rn(alphas[s], dy));
    // image.nearest_sample: round half to even, cast, clamp
    const long long ui = max(0LL, min(static_cast<long long>(rintf(pu)),
                                      static_cast<long long>(w - 1)));
    const long long vi = max(0LL, min(static_cast<long long>(rintf(pv)),
                                      static_cast<long long>(h - 1)));
    const float z = dep[vi * w + ui];
    z_ok[s] = z > 1e-6f;
    p[s][0] = __fmul_rn(__fmul_rn(__fsub_rn(pu, c.cx), c.inv_fx), z);
    p[s][1] = __fmul_rn(__fmul_rn(__fsub_rn(pv, c.cy), c.inv_fy), z);
    p[s][2] = z;
    const float sg = __fadd_rn(
        __fadd_rn(__fmul_rn(__fmul_rn(c.c1, z), z), __fmul_rn(c.c2, z)),
        c.c3);
    sigma[s] = clamp_nan(sg, 2e-3f, INFINITY);
  }
  __syncthreads();
  for (int hh = threadIdx.x; hh < iters; hh += blockDim.x) {
    const int i0 = static_cast<int>(hyp[2 * hh]);
    const int i1 = static_cast<int>(hyp[2 * hh + 1]);
    const float a[3] = {p[i0][0], p[i0][1], p[i0][2]};
    float u[3];
    for (int k = 0; k < 3; ++k) u[k] = __fsub_rn(p[i1][k], a[k]);
    const float dlen = sqrtf(__fadd_rn(
        sum3(__fmul_rn(u[0], u[0]), __fmul_rn(u[1], u[1]),
             __fmul_rn(u[2], u[2])),
        1e-12f));
    for (int k = 0; k < 3; ++k) u[k] = __fdiv_rn(u[k], dlen);
    const bool ok = z_ok[i0] && z_ok[i1] && dlen > 0.02f;
    int count = 0;
    unsigned long long bits = 0;
    for (int s = 0; s < S; ++s) {
      float r[3];
      for (int k = 0; k < 3; ++k) r[k] = __fsub_rn(p[s][k], a[k]);
      const float proj = sum3(__fmul_rn(r[0], u[0]), __fmul_rn(r[1], u[1]),
                              __fmul_rn(r[2], u[2]));
      float q[3];
      for (int k = 0; k < 3; ++k) q[k] = __fsub_rn(r[k], __fmul_rn(proj, u[k]));
      const float dist = sqrtf(__fadd_rn(
          sum3(__fmul_rn(q[0], q[0]), __fmul_rn(q[1], q[1]),
               __fmul_rn(q[2], q[2])),
          1e-18f));
      const float gate = __fadd_rn(__fmul_rn(1.5f, sigma[s]), 0.01f);
      if (dist < gate && z_ok[s]) {
        ++count;
        bits |= 1ull << s;
      }
    }
    n_inl[hh] = ok ? count : 0;
    inl_bits[hh] = bits;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  int best = 0;
  for (int hh = 1; hh < iters; ++hh) {
    if (n_inl[hh] > n_inl[best]) best = hh;
  }
  const unsigned long long in = inl_bits[best];
  const float wsum = fmaxf(static_cast<float>(__popcll(in)), 1.0f);
  // weighted mean: four interleaved accumulators, folded in order
  float acc[4][3] = {};
  for (int s = 0; s < S; ++s) {
    const float wt = (in >> s) & 1ull ? 1.0f : 0.0f;
    for (int k = 0; k < 3; ++k) {
      acc[s & 3][k] = __fadd_rn(acc[s & 3][k], __fmul_rn(p[s][k], wt));
    }
  }
  float mean[3];
  for (int k = 0; k < 3; ++k) {
    const float m = __fadd_rn(__fadd_rn(__fadd_rn(acc[0][k], acc[1][k]),
                                        acc[2][k]),
                              acc[3][k]);
    mean[k] = __fdiv_rn(m, wsum);
  }
  float cov[9] = {};
  for (int s = 0; s < S; ++s) {
    const float wt = (in >> s) & 1ull ? 1.0f : 0.0f;
    float cen[3];
    for (int k = 0; k < 3; ++k) {
      cen[k] = __fmul_rn(__fsub_rn(p[s][k], mean[k]), wt);
    }
    for (int i = 0; i < 3; ++i) {
      for (int j = 0; j < 3; ++j) {
        cov[3 * i + j] = __fmaf_rn(cen[i], cen[j], cov[3 * i + j]);
      }
    }
  }
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) {
      cov[3 * i + j] = __fadd_rn(__fdiv_rn(cov[3 * i + j], wsum),
                                 i == j ? 1e-12f : 0.0f);
    }
  }
  float evals[3], V[9];
  psl_eigh_sym3x3(cov, evals, V);
  const float dir[3] = {V[2], V[5], V[8]};
  float lo = INFINITY, hi = -INFINITY;
  for (int s = 0; s < S; ++s) {
    if (!((in >> s) & 1ull)) continue;
    const float t = sum3(__fmul_rn(__fsub_rn(p[s][0], mean[0]), dir[0]),
                         __fmul_rn(__fsub_rn(p[s][1], mean[1]), dir[1]),
                         __fmul_rn(__fsub_rn(p[s][2], mean[2]), dir[2]));
    lo = fminf(lo, t);
    hi = fmaxf(hi, t);
  }
  const bool has = valid[li] && n_inl[best] >= c.min_inliers &&
                   isfinite(lo) && isfinite(hi) && __fsub_rn(hi, lo) > 0.05f;
  for (int k = 0; k < 3; ++k) {
    p3d_s[3 * li + k] = has ? __fadd_rn(mean[k], __fmul_rn(lo, dir[k])) : 0.0f;
    p3d_e[3 * li + k] = has ? __fadd_rn(mean[k], __fmul_rn(hi, dir[k])) : 0.0f;
  }
  has_3d[li] = has ? 1 : 0;
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

__global__ void lines_search_rows_kernel(
    const float* __restrict__ sw, const float* __restrict__ ew,
    const float* __restrict__ desc_m, const unsigned char* __restrict__ valid_m,
    const float* __restrict__ T_cw, int M, const float* __restrict__ f_uv_s,
    const float* __restrict__ f_uv_e, const float* __restrict__ f_angle,
    const float* __restrict__ f_desc, const unsigned char* __restrict__ f_valid,
    int L, int D, SearchConsts k, int* __restrict__ best_idx,
    float* __restrict__ best_sim, float* __restrict__ col_val,
    int* __restrict__ col_row) {
  extern __shared__ float sh[];
  float* fd = sh;              // L x D frame descriptors
  float* md = fd + L * D;      // kRows x D map descriptors
  float* sims = md + kRows * D;  // kRows x L
  __shared__ Row rows[kRows];
  const int b = blockIdx.y, m0 = blockIdx.x * kRows;
  const int n_rows = min(kRows, M - m0);
  const size_t mb = static_cast<size_t>(b) * M;
  const size_t lb = static_cast<size_t>(b) * L;
  for (int i = threadIdx.x; i < L * D; i += blockDim.x) {
    fd[i] = f_desc[lb * D + i];
  }
  for (int i = threadIdx.x; i < n_rows * D; i += blockDim.x) {
    md[i] = desc_m[(mb + m0) * D + i];
  }
  if (threadIdx.x < n_rows) {
    const size_t m = mb + m0 + threadIdx.x;
    rows[threadIdx.x] = project_row(sw + 3 * m, ew + 3 * m, valid_m[m] != 0,
                                    T_cw + 16 * static_cast<size_t>(b), k);
  }
  __syncthreads();
  for (int pi = threadIdx.x; pi < n_rows * L; pi += blockDim.x) {
    const int r = pi / L, l = pi % L;
    const Row& row = rows[r];
    const size_t f = lb + l;
    const float s0 = f_uv_s[2 * f], s1 = f_uv_s[2 * f + 1];
    const float e0 = f_uv_e[2 * f], e1 = f_uv_e[2 * f + 1];
    const float d_s = fabsf(__fadd_rn(
        __fadd_rn(__fmul_rn(row.a, s0), __fmul_rn(row.b, s1)), row.c));
    const float d_e = fabsf(__fadd_rn(
        __fadd_rn(__fmul_rn(row.a, e0), __fmul_rn(row.b, e1)), row.c));
    const bool close = d_s < k.radius && d_e < k.radius;
    const float rel_u = __fsub_rn(__fmul_rn(0.5f, __fadd_rn(s0, e0)), row.us);
    const float rel_v = __fsub_rn(__fmul_rn(0.5f, __fadd_rn(s1, e1)), row.vs);
    const float tpar = __fdiv_rn(
        __fadd_rn(__fmul_rn(rel_u, row.dx), __fmul_rn(rel_v, row.dy)),
        row.nrm2);
    const bool overlap = tpar > -0.25f && tpar < 1.25f;
    const float da0 = fabsf(__fsub_rn(row.ang, f_angle[f]));
    const float da = min_nan(da0, __fsub_rn(k.pi, da0));
    const bool gate = row.vis && f_valid[f] && close && overlap &&
                      da < k.max_angle;
    float dot = 0.0f;
    const float* x = md + r * D;
    const float* y = fd + l * D;
    for (int j = 0; j < D; ++j) dot = __fmaf_rn(x[j], y[j], dot);
    sims[r * L + l] = gate ? dot : -1.0f;
  }
  __syncthreads();
  if (threadIdx.x < n_rows) {
    const float* s = sims + threadIdx.x * L;
    int bi = 0;
    for (int l = 1; l < L; ++l) {
      if (s[l] > s[bi]) bi = l;
    }
    best_idx[mb + m0 + threadIdx.x] = bi;
    best_sim[mb + m0 + threadIdx.x] = s[bi];
  }
  if (threadIdx.x < L) {
    int br = 0;
    for (int r = 1; r < n_rows; ++r) {
      if (sims[r * L + threadIdx.x] > sims[br * L + threadIdx.x]) br = r;
    }
    const size_t o = (static_cast<size_t>(b) * gridDim.x + blockIdx.x) * L +
                     threadIdx.x;
    col_val[o] = sims[br * L + threadIdx.x];
    col_row[o] = m0 + br;
  }
}

// lax_compat.nanmedian of x (n values) by the whole block: the values at
// the two middle ranks of the non-NaN entries (ranks by counting), weighted
// as its formula weighs them; NaN when every entry is NaN.
__device__ float block_nanmedian(const float* x, int n, int* count,
                                 float* at_lo, float* at_hi) {
  if (threadIdx.x == 0) {
    *count = 0;
    *at_lo = NAN;
    *at_hi = NAN;
  }
  __syncthreads();
  int mine = 0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) mine += isnan(x[i]) ? 0 : 1;
  atomicAdd(count, mine);
  __syncthreads();
  const float nf = static_cast<float>(*count);
  const float q = __fmul_rn(0.5f, __fsub_rn(nf, 1.0f));
  const float lo = floorf(q), hi = ceilf(q);
  const float hw = __fsub_rn(q, lo), lw = __fsub_rn(1.0f, hw);
  const float last = __fsub_rn(nf, 1.0f);
  const int r_lo = static_cast<int>(fmaxf(fminf(lo, last), 0.0f));
  const int r_hi = static_cast<int>(fmaxf(fminf(hi, last), 0.0f));
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float v = x[i];
    if (isnan(v)) continue;
    int rank = 0;
    for (int j = 0; j < n; ++j) {
      const float o = x[j];
      rank += (o < v || (o == v && j < i)) ? 1 : 0;
    }
    if (rank == r_lo) *at_lo = v;
    if (rank == r_hi) *at_hi = v;
  }
  __syncthreads();
  const float med = __fadd_rn(__fmul_rn(*at_lo, lw), __fmul_rn(*at_hi, hw));
  __syncthreads();
  return med;
}

__global__ void lines_search_gate_kernel(
    const int* __restrict__ best_idx, const float* __restrict__ best_sim,
    const float* __restrict__ col_val, const int* __restrict__ col_row, int M,
    int L, int n_blk, float min_sim, float sim_floor, float quality_bar,
    int* __restrict__ idx) {
  extern __shared__ float bn[];  // M candidates (NaN where none), M spare
  float* dev = bn + M;
  int* back = reinterpret_cast<int*>(dev + M);  // L
  __shared__ int count, earned;
  __shared__ float at_lo, at_hi;
  const int b = blockIdx.x;
  const size_t mb = static_cast<size_t>(b) * M;
  if (threadIdx.x == 0) earned = 0;
  __syncthreads();
  int mine = 0;
  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    const float s = best_sim[mb + m];
    const bool cand = s > -0.5f;
    bn[m] = cand ? s : NAN;
    mine += (cand && s >= quality_bar) ? 1 : 0;
  }
  atomicAdd(&earned, mine);
  __syncthreads();
  const float med = block_nanmedian(bn, M, &count, &at_lo, &at_hi);
  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    dev[m] = fabsf(__fsub_rn(bn[m], med));
  }
  __syncthreads();
  const float mad =
      __fmul_rn(1.4826f, block_nanmedian(dev, M, &count, &at_lo, &at_hi));
  const float th_adapt =
      clamp_nan(__fsub_rn(med, __fmul_rn(1.0f, mad)), sim_floor, min_sim);
  const float th = (earned >= 6 && isfinite(th_adapt)) ? th_adapt : min_sim;
  for (int l = threadIdx.x; l < L; l += blockDim.x) {
    const size_t c0 = static_cast<size_t>(b) * n_blk * L + l;
    float bv = col_val[c0];
    int br = col_row[c0];
    for (int k = 1; k < n_blk; ++k) {
      if (col_val[c0 + static_cast<size_t>(k) * L] > bv) {
        bv = col_val[c0 + static_cast<size_t>(k) * L];
        br = col_row[c0 + static_cast<size_t>(k) * L];
      }
    }
    back[l] = br;
  }
  __syncthreads();
  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    const int bi = best_idx[mb + m];
    const bool ok = best_sim[mb + m] > th && back[bi] == m;
    idx[mb + m] = ok ? bi : -1;
  }
}

int set_smem(const void* fn, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

int search_blocks(int M) { return (M + kRows - 1) / kRows; }

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

// Words (4 bytes) of scratch psl_search_lines needs.
PSL_API long long psl_search_lines_scratch_words(int M, int L, int batch) {
  return static_cast<long long>(batch) *
         (M + 2LL * search_blocks(M) * L);
}

// K23 for `batch` problems: map lines sw, ew (batch, M, 3), desc_m (batch,
// M, D), valid_m (batch, M); T_cw (batch, 4, 4); frame segments f_uv_s,
// f_uv_e (batch, L, 2), f_angle (batch, L), f_desc (batch, L, D), f_valid
// (batch, L); quality_bar = float(0.5 (sim_floor + min_sim)); outputs idx
// (batch, M) int32 and sim (batch, M).
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
                             float* sim, cudaStream_t stream) {
  // a row block's threads take one frame segment each for its columns
  if (batch < 1 || M < 1 || L < 1 || L > kSearchThreads || D < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  SearchConsts k;
  k.fx = fx;
  k.fy = fy;
  k.cx = cx;
  k.cy = cy;
  k.W = W;
  k.H = H;
  k.radius = radius;
  k.max_angle = max_angle;
  k.pi = static_cast<float>(3.14159265358979323846);
  const int n_blk = search_blocks(M);
  int* best_idx = static_cast<int*>(scratch);
  float* col_val =
      reinterpret_cast<float*>(best_idx + static_cast<size_t>(batch) * M);
  int* col_row = reinterpret_cast<int*>(
      col_val + static_cast<size_t>(batch) * n_blk * L);
  const size_t rows_smem = sizeof(float) *
                           (static_cast<size_t>(L) * D + kRows * D + kRows * L);
  const size_t gate_smem = sizeof(float) * (2 * static_cast<size_t>(M) + L);
  int rc = set_smem(reinterpret_cast<const void*>(lines_search_rows_kernel),
                    rows_smem);
  if (rc == 0) {
    rc = set_smem(reinterpret_cast<const void*>(lines_search_gate_kernel),
                  gate_smem);
  }
  if (rc != 0) return rc;
  lines_search_rows_kernel<<<dim3(n_blk, batch), kSearchThreads, rows_smem,
                       stream>>>(sw, ew, desc_m, valid_m, T_cw, M, f_uv_s,
                                 f_uv_e, f_angle, f_desc, f_valid, L, D, k,
                                 best_idx, sim, col_val, col_row);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  lines_search_gate_kernel<<<batch, kGateThreads, gate_smem, stream>>>(
      best_idx, sim, col_val, col_row, M, L, n_blk, min_sim, sim_floor,
      quality_bar, idx);
  return static_cast<int>(cudaGetLastError());
}
