// K48 two_view_hypotheses — the monocular initializer's F and H hypotheses
// and their scores, one hypothesis pair per block; and K49 two_view_select
// — the best F and H and their final inlier masks, one block per problem.
// Both take a leading batch of problems.
//
// K48 replaces the hypothesis bodies of planarslam_tpu/solvers/
// initializer.py::_dual_ransac (:116-127) with _eight_point_F (:52-61),
// _four_point_H (:64-75), _score_F (:78-90) and _score_H (:93-105): per
// pick of 8 correspondences, the null vector of the 8 x 9 eight-point
// system on raw pixels made rank 2, and the null vector of the 8 x 9 DLT of
// its first 4; each model scored by symmetric transfer over all N
// correspondences, -1 where it is not finite.
//
// Warp 0 solves F, warp 1 solves H, with K7's parallel one-sided Jacobi in
// fp64 (csrc/pnp_dlt.cu): lane j < 9 holds column j of A (8 rows; the
// zero row that makes the system square changes no dot product) and of V,
// and each round rotates the disjoint pairs of a round-robin of 10 slots,
// the tenth an empty column that no pair rotates against (9 rounds a
// sweep). A pair whose columns are both rounding noise against |A|_F^2 is
// left alone, as in K7: a pick that repeats a point leaves two such
// columns. The null vector is V's column of least |A v| among the 9. Lane 0
// of warp 0 then makes F rank 2 with linalg.cuh's 3 x 3 Jacobi SVD (the
// column of A V of least norm dropped: U diag(s1, s2, 0) V^T whatever the
// SVD's signs), lane 0 of warp 1 inverts H + 1e-12 I by its adjugate in
// fp64. The block's threads then score both models over the N
// correspondences in float32, every product and sum in the plain
// version's order (this source builds with -fmad=false), a thread's
// points in ascending order, then a fixed tree.
//
// K49 replaces the tail of ::_dual_ransac (:128-134): the first-index
// arg-max of sf and of sh (jnp.argmax's, NaN above every number), the copy
// of that F and that H, and both final inlier masks, written as one packed
// float32 row per problem (F 9, H 9, sf, sh, the F mask and the H mask as
// 0 / 1) that the wrapper pulls with one copy; bit-equal to the plain tail.
//
// What bounds them on an H100: K48 the latency of the Jacobi rounds (9
// dependent rounds of 17 double shuffles and 8-long multiply-add chains a
// sweep), then the scoring pass over N; 128 hypotheses are one wave of
// blocks. K49 is launch latency (one block reads N x 17 bytes).
#include "common.cuh"
#include "linalg.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kSelectThreads = 256;
constexpr int kPick = 8;
constexpr int kRows = 8;     // rows of both systems
constexpr int kCols = 9;     // unknowns
constexpr int kSlots = 10;   // the round-robin's columns, the last empty
constexpr int kRounds = 9;   // rounds of a sweep: every pair once
constexpr int kSweeps = 40;  // linalg.cuh::psl_svd_jacobi's cap
constexpr float kThF = 3.841f;
constexpr float kThScore = 5.991f;

// The partner of slot j in round r of the circle ordering of 10 slots:
// slot 9 stays, the others turn.
__device__ __forceinline__ int round_partner(int j, int r) {
  if (j == kSlots - 1) return r;
  if (j == r) return kSlots - 1;
  const int p = (2 * r - j) % kRounds;
  return p < 0 ? p + kRounds : p;
}

// The null vector of the 8 x 9 system whose column `lane` this lane holds
// in a (zeros on lanes 9-31), on every lane of the warp.
__device__ void warp_null_vector(const double (&a_in)[kRows],
                                 double (&out)[kCols]) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const bool slot = lane < kSlots;
  double a[kRows], v[kCols];
#pragma unroll
  for (int k = 0; k < kRows; ++k) a[k] = a_in[k];
#pragma unroll
  for (int k = 0; k < kCols; ++k) v[k] = (k == lane) ? 1.0 : 0.0;
  double col2 = 0.0;
#pragma unroll
  for (int k = 0; k < kRows; ++k) col2 += a[k] * a[k];
  double fro2 = 0.0;
  for (int c = 0; c < kCols; ++c) fro2 += __shfl_sync(full, col2, c);
  const double noise = 1e-26 * fro2;

  for (int sweep = 0; sweep < kSweeps; ++sweep) {
    bool rotated = false;
    for (int r = 0; r < kRounds; ++r) {
      const int p = slot ? round_partner(lane, r) : lane;
      const bool lo = lane < p;
      double x[kRows], y[kRows], xv[kCols], yv[kCols];
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        const double oa = __shfl_sync(full, a[k], p);
        x[k] = lo ? a[k] : oa;  // the pair's lower column
        y[k] = lo ? oa : a[k];  // and its higher
      }
#pragma unroll
      for (int k = 0; k < kCols; ++k) {
        const double ov = __shfl_sync(full, v[k], p);
        xv[k] = lo ? v[k] : ov;
        yv[k] = lo ? ov : v[k];
      }
      double alpha = 0.0, beta = 0.0, gamma = 0.0;
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        alpha += x[k] * x[k];
        beta += y[k] * y[k];
        gamma += x[k] * y[k];
      }
      const double g = sqrt(alpha * beta);
      const bool rot =
          slot && !(gamma == 0.0 || fabs(gamma) <= 1e-15 * g || g <= noise);
      if (rot) {
        const double zeta = (beta - alpha) / (2.0 * gamma);
        const double t = (zeta >= 0.0 ? 1.0 : -1.0) /
                         (fabs(zeta) + sqrt(1.0 + zeta * zeta));
        const double c = 1.0 / sqrt(1.0 + t * t);
        const double s = c * t;
#pragma unroll
        for (int k = 0; k < kRows; ++k) {
          a[k] = lo ? c * x[k] - s * y[k] : s * x[k] + c * y[k];
        }
#pragma unroll
        for (int k = 0; k < kCols; ++k) {
          v[k] = lo ? c * xv[k] - s * yv[k] : s * xv[k] + c * yv[k];
        }
        rotated = true;
      }
    }
    if (!__any_sync(full, rotated)) break;
  }
  // the column of least |A v| among the 9, ties to the lower index
  double n2 = 0.0;
#pragma unroll
  for (int k = 0; k < kRows; ++k) n2 += a[k] * a[k];
  if (lane >= kCols) n2 = INFINITY;
  int best = lane;
  for (int off = 16; off > 0; off >>= 1) {
    const double on = __shfl_xor_sync(full, n2, off);
    const int ob = __shfl_xor_sync(full, best, off);
    if (on < n2 || (on == n2 && ob < best)) {
      n2 = on;
      best = ob;
    }
  }
#pragma unroll
  for (int k = 0; k < kCols; ++k) out[k] = __shfl_sync(full, v[k], best);
}

// Column j of the eight-point system's row (u1, v1) -> (u2, v2):
// [u2 u1, u2 v1, u2, v2 u1, v2 v1, v2, u1, v1, 1].
__device__ __forceinline__ double f_entry(int j, double u1, double v1,
                                          double u2, double v2) {
  switch (j) {
    case 0: return u2 * u1;
    case 1: return u2 * v1;
    case 2: return u2;
    case 3: return v2 * u1;
    case 4: return v2 * v1;
    case 5: return v2;
    case 6: return u1;
    case 7: return v1;
    case 8: return 1.0;
    default: return 0.0;
  }
}

// Column j of the DLT rows of (u, v) -> (x, y): r1 = [-u, -v, -1, 0, 0, 0,
// x u, x v, x], r2 = [0, 0, 0, -u, -v, -1, y u, y v, y].
__device__ __forceinline__ double h_entry(int j, bool second, double u,
                                          double v, double x, double y) {
  const double w = second ? y : x;
  if (j < 3) return second ? 0.0 : (j == 0 ? -u : (j == 1 ? -v : -1.0));
  if (j < 6) return second ? (j == 3 ? -u : (j == 4 ? -v : -1.0)) : 0.0;
  if (j == 6) return w * u;
  if (j == 7) return w * v;
  if (j == 8) return w;
  return 0.0;
}

// F (3 x 3, fp64, row-major) made rank 2 -> float32: A V of its one-sided
// Jacobi SVD without its column of least norm, times V^T.
__device__ void rank2(const double* f, float* F) {
  double a[9], v[9];
  for (int i = 0; i < 9; ++i) a[i] = f[i];
  psl_svd_jacobi<3, 3>(a, v);
  int drop = 0;
  double dn = psl_col_norm2<3, 3>(a, 0);
  for (int j = 1; j < 3; ++j) {
    const double nj = psl_col_norm2<3, 3>(a, j);
    if (nj < dn) {
      dn = nj;
      drop = j;
    }
  }
  for (int i = 0; i < 3; ++i) {
    for (int k = 0; k < 3; ++k) {
      double acc = 0.0;
      for (int c = 0; c < 3; ++c) {
        if (c != drop) acc += a[i * 3 + c] * v[k * 3 + c];
      }
      F[i * 3 + k] = static_cast<float>(acc);
    }
  }
}

// inv(H + 1e-12 I): the float32 sum, then the adjugate over the
// determinant in fp64, rounded to float32 (initializer.py::_h_inverse).
__device__ void h_inverse(const float* H, float* Hi) {
  double h[9];
  for (int i = 0; i < 9; ++i) {
    h[i] = static_cast<double>(H[i] + ((i % 4 == 0) ? 1e-12f : 0.0f));
  }
  double c[9];
  for (int i = 0; i < 3; ++i) {
    const int r0 = i == 0 ? 1 : 0, r1 = i == 2 ? 1 : 2;
    for (int j = 0; j < 3; ++j) {
      const int c0 = j == 0 ? 1 : 0, c1 = j == 2 ? 1 : 2;
      const double minor =
          h[r0 * 3 + c0] * h[r1 * 3 + c1] - h[r0 * 3 + c1] * h[r1 * 3 + c0];
      c[i * 3 + j] = ((i + j) & 1) ? -minor : minor;
    }
  }
  const double det = (h[0] * c[0] + h[1] * c[1]) + h[2] * c[2];
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) {
      Hi[i * 3 + j] = static_cast<float>(c[j * 3 + i] / det);
    }
  }
}

// The squared distance of (xb, yb) to the epipolar line M (xa, ya, 1)
// (M^T (xa, ya, 1) with `tr`) over sigma^2 (initializer.py::_line_dist).
__device__ __forceinline__ float line_dist(const float* M, bool tr, float xa,
                                           float ya, float xb, float yb,
                                           float sigma2) {
  float l[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float m0 = tr ? M[a] : M[3 * a];
    const float m1 = tr ? M[3 + a] : M[3 * a + 1];
    const float m2 = tr ? M[6 + a] : M[3 * a + 2];
    l[a] = (xa * m0 + ya * m1) + m2;
  }
  const float num = (l[0] * xb + l[1] * yb) + l[2];
  return (num * num / ((l[0] * l[0] + l[1] * l[1]) + 1e-12f)) / sigma2;
}

// The squared distance of (xb, yb) to M (xa, ya, 1) dehomogenized over
// sigma^2 (initializer.py::_transfer_dist).
__device__ __forceinline__ float transfer_dist(const float* M, float xa,
                                               float ya, float xb, float yb,
                                               float sigma2) {
  float p[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    p[a] = (xa * M[3 * a] + ya * M[3 * a + 1]) + M[3 * a + 2];
  }
  const float w = fabsf(p[2]) < 1e-12f ? 1e-12f : p[2];
  const float dx = p[0] / w - xb;
  const float dy = p[1] / w - yb;
  return (dx * dx + dy * dy) / sigma2;
}

struct Corr {
  float u1, v1, u2, v2;
  bool ok;
};

__device__ __forceinline__ Corr load_corr(const float* uv1, const float* uv2,
                                          const unsigned char* valid, int i) {
  return Corr{uv1[2 * i], uv1[2 * i + 1], uv2[2 * i], uv2[2 * i + 1],
              valid[i] != 0};
}

// F's distances in view 1 (d1) and view 2 (d2) of one correspondence
__device__ __forceinline__ void f_dists(const float* F, Corr c, float s2,
                                        float* d1, float* d2) {
  *d2 = line_dist(F, false, c.u1, c.v1, c.u2, c.v2, s2);
  *d1 = line_dist(F, true, c.u2, c.v2, c.u1, c.v1, s2);
}

__device__ __forceinline__ void h_dists(const float* H, const float* Hi,
                                        Corr c, float s2, float* d1,
                                        float* d2) {
  *d2 = transfer_dist(H, c.u1, c.v1, c.u2, c.v2, s2);
  *d1 = transfer_dist(Hi, c.u2, c.v2, c.u1, c.v1, s2);
}

// A correspondence's score term: (th_score - d1 where d1 < th) + (the same
// of d2), each only where the correspondence is valid.
__device__ __forceinline__ float score_term(float d1, float d2, float th,
                                            bool ok) {
  const float t1 = (d1 < th && ok) ? kThScore - d1 : 0.0f;
  const float t2 = (d2 < th && ok) ? kThScore - d2 : 0.0f;
  return t1 + t2;
}

__device__ __forceinline__ bool all_finite9(const float* m) {
  bool ok = true;
  for (int k = 0; k < 9; ++k) ok = ok && isfinite(m[k]);
  return ok;
}

// The block's sum of one float a thread, in a fixed tree (thread 0 gets
// it); red holds blockDim.x / 32 floats.
__device__ __forceinline__ float block_sum(float x, float* red) {
  for (int off = 16; off > 0; off >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, off);
  }
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  float total = 0.0f;
  if (threadIdx.x == 0) {
    for (int k = 0; k < static_cast<int>(blockDim.x >> 5); ++k) {
      total += red[k];
    }
  }
  return total;
}

__global__ void __launch_bounds__(kThreads) two_view_hypotheses_kernel(
    const float* __restrict__ uv1, const float* __restrict__ uv2,
    const unsigned char* __restrict__ valid,
    const float* __restrict__ sigma2, const int* __restrict__ picks, int n,
    int n_hyp, float* __restrict__ sf, float* __restrict__ sh,
    float* __restrict__ Fs, float* __restrict__ Hs) {
  __shared__ float sF[9], sH[9], sHi[9];
  __shared__ float red_f[kThreads / 32], red_h[kThreads / 32];
  const int h = blockIdx.x, b = blockIdx.y;
  const size_t hb = static_cast<size_t>(b) * n_hyp + h;
  const size_t nb = static_cast<size_t>(b) * n;
  uv1 += 2 * nb;
  uv2 += 2 * nb;
  valid += nb;
  const int* pick = picks + kPick * hb;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp < 2) {
    double a[kRows];
    if (warp == 0) {  // the eight-point system, a row a pick
#pragma unroll
      for (int r = 0; r < kPick; ++r) {
        const int p = pick[r];
        a[r] = f_entry(lane, uv1[2 * p], uv1[2 * p + 1], uv2[2 * p],
                       uv2[2 * p + 1]);
      }
    } else {  // the DLT of the first four, two rows a pick
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int p = pick[r];
        const double u = uv1[2 * p], v = uv1[2 * p + 1];
        const double x = uv2[2 * p], y = uv2[2 * p + 1];
        a[2 * r] = h_entry(lane, false, u, v, x, y);
        a[2 * r + 1] = h_entry(lane, true, u, v, x, y);
      }
    }
    double f[kCols];
    warp_null_vector(a, f);
    if (lane == 0) {
      if (warp == 0) {
        rank2(f, sF);
      } else {
        for (int k = 0; k < kCols; ++k) sH[k] = static_cast<float>(f[k]);
        h_inverse(sH, sHi);
      }
    }
  }
  __syncthreads();

  const float s2 = sigma2[b];
  float acc_f = 0.0f, acc_h = 0.0f;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const Corr c = load_corr(uv1, uv2, valid, i);
    float d1, d2;
    f_dists(sF, c, s2, &d1, &d2);
    acc_f += score_term(d1, d2, kThF, c.ok);
    h_dists(sH, sHi, c, s2, &d1, &d2);
    acc_h += score_term(d1, d2, kThScore, c.ok);
  }
  const float tot_f = block_sum(acc_f, red_f);
  const float tot_h = block_sum(acc_h, red_h);
  if (threadIdx.x == 0) {
    sf[hb] = all_finite9(sF) ? tot_f : -1.0f;
    sh[hb] = all_finite9(sH) ? tot_h : -1.0f;
  }
  if (threadIdx.x < 9) {
    Fs[9 * hb + threadIdx.x] = sF[threadIdx.x];
    Hs[9 * hb + threadIdx.x] = sH[threadIdx.x];
  }
}

// (a, ia) before (b, ib) in jnp.argmax's order: NaN above every number,
// then the larger, then the lower index
__device__ __forceinline__ bool before(float a, int ia, float b, int ib) {
  const bool na = isnan(a), nb = isnan(b);
  if (na != nb) return na;
  if (!na && a != b) return a > b;
  return ia < ib;
}

// The first index of the largest of s[0, n_hyp) (every thread gets it);
// red_v, red_i hold blockDim.x / 32 entries.
__device__ int block_argmax(const float* s, int n_hyp, float* red_v,
                            int* red_i) {
  float bv = -INFINITY;
  int bi = INT_MAX;
  for (int h = threadIdx.x; h < n_hyp; h += blockDim.x) {
    if (before(s[h], h, bv, bi)) {
      bv = s[h];
      bi = h;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
    if (before(ov, oi, bv, bi)) {
      bv = ov;
      bi = oi;
    }
  }
  if ((threadIdx.x & 31) == 0) {
    red_v[threadIdx.x >> 5] = bv;
    red_i[threadIdx.x >> 5] = bi;
  }
  __syncthreads();
  bv = red_v[0];
  bi = red_i[0];
  for (int w = 1; w < static_cast<int>(blockDim.x >> 5); ++w) {
    if (before(red_v[w], red_i[w], bv, bi)) {
      bv = red_v[w];
      bi = red_i[w];
    }
  }
  __syncthreads();
  return bi;
}

__global__ void __launch_bounds__(kSelectThreads) two_view_select_kernel(
    const float* __restrict__ uv1, const float* __restrict__ uv2,
    const unsigned char* __restrict__ valid,
    const float* __restrict__ sigma2, const float* __restrict__ sf,
    const float* __restrict__ sh, const float* __restrict__ Fs,
    const float* __restrict__ Hs, int n, int n_hyp, float* __restrict__ out) {
  __shared__ float sF[9], sH[9], sHi[9];
  __shared__ float red_v[kSelectThreads / 32];
  __shared__ int red_i[kSelectThreads / 32];
  const int b = blockIdx.x;
  const size_t nb = static_cast<size_t>(b) * n;
  const size_t hb = static_cast<size_t>(b) * n_hyp;
  uv1 += 2 * nb;
  uv2 += 2 * nb;
  valid += nb;
  out += static_cast<size_t>(b) * (20 + 2 * static_cast<size_t>(n));
  const int bf = block_argmax(sf + hb, n_hyp, red_v, red_i);
  const int bh = block_argmax(sh + hb, n_hyp, red_v, red_i);
  if (threadIdx.x < 9) {
    const float f = Fs[9 * (hb + bf) + threadIdx.x];
    const float h = Hs[9 * (hb + bh) + threadIdx.x];
    sF[threadIdx.x] = f;
    sH[threadIdx.x] = h;
    out[threadIdx.x] = f;
    out[9 + threadIdx.x] = h;
  }
  if (threadIdx.x == 0) {
    out[18] = sf[hb + bf];
    out[19] = sh[hb + bh];
  }
  __syncthreads();
  if (threadIdx.x == 0) h_inverse(sH, sHi);
  __syncthreads();
  const float s2 = sigma2[b];
  for (int i = threadIdx.x; i < n; i += kSelectThreads) {
    const Corr c = load_corr(uv1, uv2, valid, i);
    float d1, d2;
    f_dists(sF, c, s2, &d1, &d2);
    out[20 + i] = (d1 < kThF && d2 < kThF && c.ok) ? 1.0f : 0.0f;
    h_dists(sH, sHi, c, s2, &d1, &d2);
    out[20 + n + i] = (d1 < kThScore && d2 < kThScore && c.ok) ? 1.0f : 0.0f;
  }
}

}  // namespace

// K48 for `batch` problems: uv1, uv2 (batch, n, 2), valid (batch, n),
// sigma2 (batch, 1), picks (batch, n_hyp, 8) int32 in [0, n); outputs sf,
// sh (batch, n_hyp) and Fs, Hs (batch, n_hyp, 3, 3).
PSL_API int psl_two_view_hypotheses(const float* uv1, const float* uv2,
                                    const unsigned char* valid,
                                    const float* sigma2, const int* picks,
                                    int n, int n_hyp, int batch, float* sf,
                                    float* sh, float* Fs, float* Hs,
                                    cudaStream_t stream) {
  if (n < 1 || n_hyp < 0 || batch < 0 || batch > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_hyp > 0 && batch > 0) {
    two_view_hypotheses_kernel<<<dim3(n_hyp, batch), kThreads, 0, stream>>>(
        uv1, uv2, valid, sigma2, picks, n, n_hyp, sf, sh, Fs, Hs);
  }
  return static_cast<int>(cudaGetLastError());
}

// K49 for `batch` problems: the inputs of K48 but the picks, and its
// outputs; out (batch, 20 + 2 n) float32: F, H, sf, sh, the F and the H
// inlier masks as 0 / 1.
PSL_API int psl_two_view_select(const float* uv1, const float* uv2,
                                const unsigned char* valid,
                                const float* sigma2, const float* sf,
                                const float* sh, const float* Fs,
                                const float* Hs, int n, int n_hyp, int batch,
                                float* out, cudaStream_t stream) {
  if (n < 1 || n_hyp < 1 || batch < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  two_view_select_kernel<<<batch, kSelectThreads, 0, stream>>>(
      uv1, uv2, valid, sigma2, sf, sh, Fs, Hs, n, n_hyp, out);
  return static_cast<int>(cudaGetLastError());
}
