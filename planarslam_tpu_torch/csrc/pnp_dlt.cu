// K7 pnp_dlt_hypotheses — 6-point DLT pose hypotheses and their inlier
// counts, one hypothesis per block; and K46 pnp_select — the RANSAC's best
// hypothesis, its pose and its final inlier mask, one block per problem.
// Both take a leading batch of problems.
//
// K7 replaces planarslam_tpu/solvers/pnp.py::_dlt_pose and the hypo body of
// ::_pnp_ransac (:25-61): per hypothesis, the 12 x 12 DLT system of its six
// picked correspondences, the right singular vector of the smallest
// singular value (the JAX package's jnp.linalg.svd, full_matrices), the
// depth-sign fix, the projection of P[:, :3] onto SO(3) with the uniform
// scale mean(S), then the reprojection chi2 of every correspondence and the
// inlier count (-1 when T is not finite).
//
// A warp solves the hypothesis, the block scores it. The SVD is linalg.cuh's
// one-sided Jacobi in fp64 with its rotation and its stopping criterion, but
// its rotations run in parallel: lane j < 12 holds column j of A and of V in
// registers, and each round rotates the 6 disjoint column pairs of a
// round-robin ordering (11 rounds a sweep, every pair once). The two lanes
// of a pair swap their columns by shuffles, form the same three dot products
// in the same order and so the same rotation, and each applies it to its own
// column. The sweeps stop when no pair of a sweep rotated (every pair below
// the criterion, __any_sync), or at linalg.cuh's cap of 40. Beyond that
// criterion a pair is left alone when both its columns are rounding noise
// (sqrt(alpha beta) <= 1e-26 |A|_F^2): a pick that repeats a point leaves
// two such columns, which no rotation makes orthogonal to 1e-15, so its
// solve ran to the cap (40 sweeps where the others take 7-9) and with it
// the whole launch; their V columns already span the null space. The order
// of the rotations is not the cyclic order of psl_null_vector, so T differs
// from a serial solve in its last bits; a hypothesis whose picks repeat a
// point has a null space of dimension 2 or more, and any unit vector in it
// is a valid answer. The null vector is V's column with the least |A v| (ties to the
// lower column), broadcast by shuffles; lane 0 then fixes the sign and
// projects onto SO(3) (linalg.cuh::psl_nearest_rotation). The block's
// threads then test their correspondences in float32, in K46's operations,
// and reduce the count. What bounds it on an H100: the latency of the
// Jacobi rounds (a sweep is 11 dependent rounds of 24 double shuffles, 36
// multiply-adds, two square roots and three divisions), 7-9 sweeps; 128
// hypotheses are one wave of blocks, so the launch lasts its slowest solve.
//
// K46 replaces the tail of ::_pnp_ransac (:62-70): the first-index arg-max
// of the int32 scores (jnp.argmax's), the copy of that T, and the final
// inlier mask and its count, written as one packed float32 row per problem
// (T 16, the count's int32 bits, the mask as 0 / 1) that the wrapper pulls
// with one copy. Every float operation is spelled as a rounded intrinsic in
// the plain version's order (solvers/pnp.py::_inliers), so the mask and
// count are the plain version's bits. Bound: launch latency (one block reads
// N x 28 bytes).
#include "common.cuh"
#include "linalg.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kPick = 6;
constexpr int kCols = 12;    // unknowns of the DLT; A is kCols x kCols
constexpr int kRounds = 11;  // round-robin rounds of kCols columns
constexpr int kSweeps = 40;  // linalg.cuh::psl_svd_jacobi's cap
constexpr int kSelectThreads = 256;

// The partner of column j in round r of the round-robin (circle) ordering
// of 12 columns: column 11 stays, the others turn; every pair meets once in
// 11 rounds and the 6 pairs of a round are disjoint.
__device__ __forceinline__ int round_partner(int j, int r) {
  if (j == kCols - 1) return r;
  if (j == r) return kCols - 1;
  const int p = (2 * r - j) % kRounds;
  return p < 0 ? p + kRounds : p;
}

// torch.clamp(x, min=lo): NaN stays NaN
__device__ __forceinline__ float clamp_min_nan(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}

// The inlier test of one correspondence against T (row-major 3 x 4 of a
// 4 x 4): solvers/pnp.py::_inliers' operations in its order.
__device__ __forceinline__ bool pnp_inlier(const float* T, const float* xw,
                                           const float* uv_n,
                                           const float* inv_sigma2,
                                           const unsigned char* valid, int i,
                                           float chi2_gate) {
  const float x = xw[3 * i], y = xw[3 * i + 1], z = xw[3 * i + 2];
  float pc[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    pc[a] = __fadd_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(x, T[4 * a]), __fmul_rn(y, T[4 * a + 1])),
                  __fmul_rn(z, T[4 * a + 2])),
        T[4 * a + 3]);
  }
  const float zc = clamp_min_nan(pc[2], 1e-6f);
  const float du = __fsub_rn(__fdiv_rn(pc[0], zc), uv_n[2 * i]);
  const float dv = __fsub_rn(__fdiv_rn(pc[1], zc), uv_n[2 * i + 1]);
  const float chi2 =
      __fmul_rn(__fadd_rn(__fmul_rn(du, du), __fmul_rn(dv, dv)), inv_sigma2[i]);
  return chi2 < chi2_gate && pc[2] > 0.05f && valid[i] != 0;
}

// A block's sum of one int a thread (every thread gets it); red holds
// blockDim.x / 32 ints.
__device__ __forceinline__ int block_count(int count, int* red) {
  for (int off = 16; off > 0; off >>= 1) {
    count += __shfl_xor_sync(0xffffffffu, count, off);
  }
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = count;
  __syncthreads();
  int total = 0;
  for (int k = 0; k < static_cast<int>(blockDim.x >> 5); ++k) total += red[k];
  __syncthreads();
  return total;
}

// The DLT pose of one hypothesis by warp 0 (lane 0 writes T, 16 floats).
__device__ void dlt_pose_warp(const float* xw, const float* uv_n,
                              const int* pick, float* T) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const bool live = lane < kCols;
  double X[kPick][4], xn[kPick], yn[kPick];
#pragma unroll
  for (int r = 0; r < kPick; ++r) {
    const int p = pick[r];
    for (int k = 0; k < 3; ++k) X[r][k] = xw[3 * p + k];
    X[r][3] = 1.0;
    xn[r] = uv_n[2 * p];
    yn[r] = uv_n[2 * p + 1];
  }
  // column j of A (rows_u of the picks, then rows_v) and of V = I
  double a[kCols], v[kCols];
  const int j = live ? lane : 0;
#pragma unroll
  for (int r = 0; r < kPick; ++r) {
    const int c = j & 3;
    a[r] = j < 4 ? X[r][c] : (j < 8 ? 0.0 : -xn[r] * X[r][c]);
    a[kPick + r] = j < 4 ? 0.0 : (j < 8 ? X[r][c] : -yn[r] * X[r][c]);
  }
#pragma unroll
  for (int k = 0; k < kCols; ++k) v[k] = (k == j) ? 1.0 : 0.0;
  // |A|_F^2, the same sum on every lane (the columns in order): a pair
  // whose two columns are rounding noise against it (sqrt(alpha beta) <=
  // 1e-26 |A|_F^2) is not rotated
  double col2 = 0.0;
#pragma unroll
  for (int k = 0; k < kCols; ++k) col2 += a[k] * a[k];
  double fro2 = 0.0;
  for (int c = 0; c < kCols; ++c) fro2 += __shfl_sync(full, col2, c);
  const double noise = 1e-26 * fro2;

  for (int sweep = 0; sweep < kSweeps; ++sweep) {
    bool rotated = false;
    for (int r = 0; r < kRounds; ++r) {
      const int p = live ? round_partner(lane, r) : lane;
      const bool lo = lane < p;
      double x[kCols], y[kCols], xv[kCols], yv[kCols];
#pragma unroll
      for (int k = 0; k < kCols; ++k) {
        const double oa = __shfl_sync(full, a[k], p);
        const double ov = __shfl_sync(full, v[k], p);
        x[k] = lo ? a[k] : oa;  // the pair's lower column
        y[k] = lo ? oa : a[k];  // and its higher
        xv[k] = lo ? v[k] : ov;
        yv[k] = lo ? ov : v[k];
      }
      double alpha = 0.0, beta = 0.0, gamma = 0.0;
#pragma unroll
      for (int k = 0; k < kCols; ++k) {
        alpha += x[k] * x[k];
        beta += y[k] * y[k];
        gamma += x[k] * y[k];
      }
      const double g = sqrt(alpha * beta);
      const bool rot =
          live && !(gamma == 0.0 || fabs(gamma) <= 1e-15 * g || g <= noise);
      if (rot) {
        const double zeta = (beta - alpha) / (2.0 * gamma);
        const double t = (zeta >= 0.0 ? 1.0 : -1.0) /
                         (fabs(zeta) + sqrt(1.0 + zeta * zeta));
        const double c = 1.0 / sqrt(1.0 + t * t);
        const double s = c * t;
#pragma unroll
        for (int k = 0; k < kCols; ++k) {
          a[k] = lo ? c * x[k] - s * y[k] : s * x[k] + c * y[k];
          v[k] = lo ? c * xv[k] - s * yv[k] : s * xv[k] + c * yv[k];
        }
        rotated = true;
      }
    }
    if (!__any_sync(full, rotated)) break;
  }
  // the column of least |A v|, ties to the lower index
  double n2 = 0.0;
#pragma unroll
  for (int k = 0; k < kCols; ++k) n2 += a[k] * a[k];
  if (!live) n2 = INFINITY;
  int best = lane;
  for (int off = 16; off > 0; off >>= 1) {
    const double on = __shfl_xor_sync(full, n2, off);
    const int ob = __shfl_xor_sync(full, best, off);
    if (on < n2 || (on == n2 && ob < best)) {
      n2 = on;
      best = ob;
    }
  }
  double P[kCols];
#pragma unroll
  for (int k = 0; k < kCols; ++k) P[k] = __shfl_sync(full, v[k], best);
  if (lane != 0) return;
  // points in front: flip the sign when the summed depth is negative
  double depth_sum = 0.0;
  for (int r = 0; r < kPick; ++r) {
    depth_sum += X[r][0] * P[8] + X[r][1] * P[9] + X[r][2] * P[10] +
                 X[r][3] * P[11];
  }
  if (depth_sum < 0.0) {
    for (int k = 0; k < kCols; ++k) P[k] = -P[k];
  }
  double M3[9], R[9], sv[3];
  for (int a3 = 0; a3 < 3; ++a3) {
    for (int b = 0; b < 3; ++b) M3[3 * a3 + b] = P[4 * a3 + b];
  }
  psl_nearest_rotation(M3, R, sv);
  const double scale = fmax((sv[0] + sv[1] + sv[2]) / 3.0, 1e-9);
  for (int a3 = 0; a3 < 3; ++a3) {
    for (int b = 0; b < 3; ++b) T[4 * a3 + b] = static_cast<float>(R[3 * a3 + b]);
    T[4 * a3 + 3] = static_cast<float>(P[4 * a3 + 3] / scale);
  }
  T[12] = T[13] = T[14] = 0.0f;
  T[15] = 1.0f;
}

__global__ void __launch_bounds__(kThreads) pnp_dlt_kernel(
    const float* __restrict__ xw, const float* __restrict__ uv_n,
    const float* __restrict__ inv_sigma2, const unsigned char* __restrict__ valid,
    const int* __restrict__ picks, int n, int n_hyp, float chi2_gate,
    int* __restrict__ scores, float* __restrict__ T_out) {
  __shared__ float T[16];
  __shared__ int red[kThreads / 32];
  const int h = blockIdx.x, b = blockIdx.y;
  const size_t hb = static_cast<size_t>(b) * n_hyp + h;
  const size_t nb = static_cast<size_t>(b) * n;
  xw += 3 * nb;
  uv_n += 2 * nb;
  inv_sigma2 += nb;
  valid += nb;
  if (threadIdx.x < 32) dlt_pose_warp(xw, uv_n, picks + kPick * hb, T);
  __syncthreads();

  bool finite = true;
  for (int k = 0; k < 16; ++k) finite = finite && isfinite(T[k]);
  int count = 0;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    count += pnp_inlier(T, xw, uv_n, inv_sigma2, valid, i, chi2_gate) ? 1 : 0;
  }
  const int total = block_count(count, red);
  if (threadIdx.x == 0) scores[hb] = finite ? total : -1;
  if (threadIdx.x < 16) T_out[16 * hb + threadIdx.x] = T[threadIdx.x];
}

__global__ void __launch_bounds__(kSelectThreads) pnp_select_kernel(
    const float* __restrict__ xw, const float* __restrict__ uv_n,
    const float* __restrict__ inv_sigma2, const unsigned char* __restrict__ valid,
    const int* __restrict__ scores, const float* __restrict__ Ts, int n,
    int n_hyp, float chi2_gate, float* __restrict__ out) {
  __shared__ float T[16];
  __shared__ int red_v[kSelectThreads / 32], red_i[kSelectThreads / 32];
  __shared__ int red[kSelectThreads / 32];
  const int b = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t nb = static_cast<size_t>(b) * n;
  scores += static_cast<size_t>(b) * n_hyp;
  Ts += static_cast<size_t>(b) * n_hyp * 16;
  out += static_cast<size_t>(b) * (17 + n);
  // the first index of the largest score
  int bv = INT_MIN, bi = INT_MAX;
  for (int h = threadIdx.x; h < n_hyp; h += kSelectThreads) {
    const int s = scores[h];
    if (s > bv) {  // ascending h: the first of equals stays
      bv = s;
      bi = h;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const int ov = __shfl_xor_sync(0xffffffffu, bv, off);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
    if (ov > bv || (ov == bv && oi < bi)) {
      bv = ov;
      bi = oi;
    }
  }
  if (lane == 0) {
    red_v[warp] = bv;
    red_i[warp] = bi;
  }
  __syncthreads();
  if (threadIdx.x < 16) {
    int v = red_v[0], best = red_i[0];
    for (int w = 1; w < kSelectThreads / 32; ++w) {
      if (red_v[w] > v || (red_v[w] == v && red_i[w] < best)) {
        v = red_v[w];
        best = red_i[w];
      }
    }
    const float x = Ts[16 * static_cast<size_t>(best) + threadIdx.x];
    T[threadIdx.x] = x;
    out[threadIdx.x] = x;
  }
  __syncthreads();
  int count = 0;
  for (int i = threadIdx.x; i < n; i += kSelectThreads) {
    const bool ok = pnp_inlier(T, xw + 3 * nb, uv_n + 2 * nb,
                               inv_sigma2 + nb, valid + nb, i, chi2_gate);
    out[17 + i] = ok ? 1.0f : 0.0f;
    count += ok ? 1 : 0;
  }
  const int total = block_count(count, red);
  if (threadIdx.x == 0) out[16] = __int_as_float(total);
}

}  // namespace

// K7 for `batch` problems: xw (batch, n, 3), uv_n (batch, n, 2), inv_sigma2
// (batch, n), valid (batch, n), picks (batch, n_hyp, 6) int32; outputs
// scores (batch, n_hyp) int32 and T (batch, n_hyp, 4, 4).
PSL_API int psl_pnp_dlt_hypotheses(const float* xw, const float* uv_n,
                                   const float* inv_sigma2,
                                   const unsigned char* valid,
                                   const int* picks, int n, int n_hyp,
                                   int batch, float chi2_gate, int* scores,
                                   float* T, cudaStream_t stream) {
  if (batch < 0 || batch > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_hyp > 0 && n > 0 && batch > 0) {
    pnp_dlt_kernel<<<dim3(n_hyp, batch), kThreads, 0, stream>>>(
        xw, uv_n, inv_sigma2, valid, picks, n, n_hyp, chi2_gate, scores, T);
  }
  return static_cast<int>(cudaGetLastError());
}

// K46 for `batch` problems: the inputs of K7 and its outputs scores (batch,
// n_hyp) and Ts (batch, n_hyp, 4, 4); out (batch, 17 + n) float32: T, the
// inlier count's int32 bits, the inlier mask as 0 / 1.
PSL_API int psl_pnp_select(const float* xw, const float* uv_n,
                           const float* inv_sigma2, const unsigned char* valid,
                           const int* scores, const float* Ts, int n,
                           int n_hyp, int batch, float chi2_gate, float* out,
                           cudaStream_t stream) {
  if (n < 1 || n_hyp < 1 || batch < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  pnp_select_kernel<<<batch, kSelectThreads, 0, stream>>>(
      xw, uv_n, inv_sigma2, valid, scores, Ts, n, n_hyp, chi2_gate, out);
  return static_cast<int>(cudaGetLastError());
}
