// K5 triangulate_two_view — two-view DLT triangulation with the chi2 gates;
// and K50 triangulate_dlt — the DLT of given projection matrices, and its
// reprojection gates (below K5's entry).
//
// Replaces the inline tri_one of
// planarslam_tpu/slam/device_mapper.py::_mapping_step_impl (:125-167): per
// (neighbour, feature) pair, the 4 x 4 DLT matrix A of the two pixel
// observations, its smallest right singular vector (the JAX package's
// jnp.linalg.svd), dehomogenised with the |w| < 1e-12 guard; a finite
// check; the own and the neighbour reprojection chi2 < 5.991 with the
// per-level 1 / sigma^2 and z > 0.05 (proj_gate); and the good mask.
//
// One thread per pair. The nullspace is the right singular vector of the
// smallest singular value, from a 4 x 4 one-sided Jacobi SVD in fp64
// registers (linalg.cuh), where the JAX function's float32 SVD keeps only
// a few digits for short baselines. The point and the gates are then
// float32, as in the plain version.
//
// What bounds it on an H100: nothing at this size. 5 x 1024 pairs are 40
// blocks of 128 threads, each thread a few thousand fp64 flops; the kernel
// is one launch where the plain version is some forty.
#include "common.cuh"
#include "linalg.cuh"

namespace {

constexpr int kThreads = 128;

struct Cam {
  float fx, fy, cx, cy;
};

// P = K [R | t] (3 x 4, fp64) of a row-major 4 x 4 pose
__device__ __forceinline__ void projection(const float* T, Cam k, double* P) {
  for (int c = 0; c < 4; ++c) {
    const double r0 = T[c], r1 = T[4 + c], r2 = T[8 + c];
    P[c] = k.fx * r0 + k.cx * r2;
    P[4 + c] = k.fy * r1 + k.cy * r2;
    P[8 + c] = r2;
  }
}

// proj_gate: z > 0.05 and the reprojection chi2 below 5.991
__device__ __forceinline__ bool proj_gate(const float* T, const float* X,
                                          Cam k, float u_obs, float v_obs,
                                          float inv_s2) {
  const float x = X[0] * T[0] + X[1] * T[1] + X[2] * T[2] + T[3];
  const float y = X[0] * T[4] + X[1] * T[5] + X[2] * T[6] + T[7];
  const float z = X[0] * T[8] + X[1] * T[9] + X[2] * T[10] + T[11];
  const float zc = fmaxf(z, 1e-9f);
  const float u = k.fx * x / zc + k.cx;
  const float v = k.fy * y / zc + k.cy;
  const float du = u - u_obs, dv = v - v_obs;
  const float err = (du * du + dv * dv) * inv_s2;
  return (z > 0.05f) && (err < 5.991f);
}

__global__ void triangulate_kernel(
    const float* __restrict__ own_uv, const int* __restrict__ own_level,
    const float* __restrict__ uv2, const int* __restrict__ level2,
    const unsigned char* __restrict__ has, const float* __restrict__ own_T,
    const float* __restrict__ nb_T, int nb, int k_feat, Cam cam,
    float scale_factor, float* __restrict__ X_out, int* __restrict__ good) {
  const int pair = blockIdx.x * kThreads + threadIdx.x;
  if (pair >= nb * k_feat) return;
  const int i = pair / k_feat;
  const int f = pair - i * k_feat;
  const float* T2 = nb_T + 16 * i;

  double P1[12], P2[12];
  projection(own_T, cam, P1);
  projection(T2, cam, P2);
  const double u1 = own_uv[2 * f], v1 = own_uv[2 * f + 1];
  const double u2 = uv2[2 * pair], v2 = uv2[2 * pair + 1];
  double A[16];
  for (int c = 0; c < 4; ++c) {
    A[c] = u1 * P1[8 + c] - P1[c];
    A[4 + c] = v1 * P1[8 + c] - P1[4 + c];
    A[8 + c] = u2 * P2[8 + c] - P2[c];
    A[12 + c] = v2 * P2[8 + c] - P2[4 + c];
  }
  double V[16], Xh[4];
  psl_null_vector<4, 4>(A, V, Xh);
  double w = Xh[3];
  if (fabs(w) < 1e-12) w = 1e-12;
  float X[3];
  for (int k = 0; k < 3; ++k) X[k] = static_cast<float>(Xh[k] / w);
  const bool finite = isfinite(X[0]) && isfinite(X[1]) && isfinite(X[2]);

  const float s2a = powf(scale_factor, -2.0f * static_cast<float>(own_level[f]));
  const float s2b = powf(scale_factor, -2.0f * static_cast<float>(level2[pair]));
  const bool ok = (has[pair] != 0) && finite &&
                  proj_gate(own_T, X, cam, own_uv[2 * f], own_uv[2 * f + 1],
                            s2a) &&
                  proj_gate(T2, X, cam, uv2[2 * pair], uv2[2 * pair + 1], s2b);
  X_out[3 * pair] = X[0];
  X_out[3 * pair + 1] = X[1];
  X_out[3 * pair + 2] = X[2];
  good[pair] = ok ? 1 : 0;
}

}  // namespace

PSL_API int psl_triangulate_two_view(
    const float* own_uv, const int* own_level, const float* uv2,
    const int* level2, const unsigned char* has, const float* own_T,
    const float* nb_T, int nb, int k_feat, float fx, float fy, float cx,
    float cy, float scale_factor, float* X, int* good, cudaStream_t stream) {
  const int n = nb * k_feat;
  if (n > 0) {
    triangulate_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                         stream>>>(own_uv, own_level, uv2, level2, has, own_T,
                                   nb_T, nb, k_feat, Cam{fx, fy, cx, cy},
                                   scale_factor, X, good);
  }
  return static_cast<int>(cudaGetLastError());
}

// K50 triangulate_dlt replaces planarslam_tpu/solvers/triangulation.py::
// triangulate (:16-40), in its DLT mode, and ::reprojection_checks
// (:43-58), in its gates mode. Both take a leading batch of problems.
//
// The DLT mode is K5's per-pair solve with P1, P2 (3 x 4, each problem's)
// as given rather than built from K and poses: the 4 x 4 DLT matrix in
// fp64, linalg.cuh's null vector, the point dehomogenized with |w| < 1e-12
// -> 1e-12, rounded to float32, and its finite flag. One thread a pair.
//
// The gates mode tests z > 0.05 and the reprojection chi2 < gate of a
// point in both views, every float32 product and sum a rounded intrinsic
// in the plain version's order (triangulation.py::_view_gate), so its mask
// is the plain version's bits; this source builds with contraction on,
// for K5. One thread a point.
//
// What bounds it on an H100: launch latency at the initializer's sizes
// (4 x 1000 pairs are 32 blocks); each DLT pair is a few thousand fp64
// flops.
namespace {

__global__ void triangulate_dlt_kernel(const float* __restrict__ P1,
                                       const float* __restrict__ P2,
                                       const float* __restrict__ uv1,
                                       const float* __restrict__ uv2, int n,
                                       int batch, float* __restrict__ X_out,
                                       unsigned char* __restrict__ ok) {
  const long long pair =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (pair >= static_cast<long long>(n) * batch) return;
  const int b = static_cast<int>(pair / n);
  double p1[12], p2[12];
  for (int k = 0; k < 12; ++k) {
    p1[k] = P1[12 * b + k];
    p2[k] = P2[12 * b + k];
  }
  const double u1 = uv1[2 * pair], v1 = uv1[2 * pair + 1];
  const double u2 = uv2[2 * pair], v2 = uv2[2 * pair + 1];
  double A[16];
  for (int c = 0; c < 4; ++c) {
    A[c] = u1 * p1[8 + c] - p1[c];
    A[4 + c] = v1 * p1[8 + c] - p1[4 + c];
    A[8 + c] = u2 * p2[8 + c] - p2[c];
    A[12 + c] = v2 * p2[8 + c] - p2[4 + c];
  }
  double V[16], Xh[4];
  psl_null_vector<4, 4>(A, V, Xh);
  double w = Xh[3];
  if (fabs(w) < 1e-12) w = 1e-12;
  float X[3];
  for (int k = 0; k < 3; ++k) X[k] = static_cast<float>(Xh[k] / w);
  X_out[3 * pair] = X[0];
  X_out[3 * pair + 1] = X[1];
  X_out[3 * pair + 2] = X[2];
  ok[pair] = (isfinite(X[0]) && isfinite(X[1]) && isfinite(X[2])) ? 1 : 0;
}

struct Intrinsics {
  float fx, fy, cx, cy;
};

// z > 0.05 and chi2 < gate of X in the view T (row-major 4 x 4)
__device__ __forceinline__ bool view_gate(const float* T, const float* X,
                                          Intrinsics k, float u_obs,
                                          float v_obs, float inv_s2,
                                          float gate) {
  float pc[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    pc[a] = __fadd_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(X[0], T[4 * a]),
                            __fmul_rn(X[1], T[4 * a + 1])),
                  __fmul_rn(X[2], T[4 * a + 2])),
        T[4 * a + 3]);
  }
  const float zc = isnan(pc[2]) ? pc[2] : fmaxf(pc[2], 1e-9f);
  const float du = __fsub_rn(
      __fadd_rn(__fdiv_rn(__fmul_rn(k.fx, pc[0]), zc), k.cx), u_obs);
  const float dv = __fsub_rn(
      __fadd_rn(__fdiv_rn(__fmul_rn(k.fy, pc[1]), zc), k.cy), v_obs);
  const float err =
      __fmul_rn(__fadd_rn(__fmul_rn(du, du), __fmul_rn(dv, dv)), inv_s2);
  return pc[2] > 0.05f && err < gate;
}

__global__ void reprojection_checks_kernel(
    const float* __restrict__ X, const float* __restrict__ T1,
    const float* __restrict__ T2, const float* __restrict__ uv1,
    const float* __restrict__ uv2, const float* __restrict__ is2_1,
    const float* __restrict__ is2_2, float s1, float s2, int n, int batch,
    Intrinsics k, float gate, bool* __restrict__ mask) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= static_cast<long long>(n) * batch) return;
  const int b = static_cast<int>(i / n);
  const float w1 = is2_1 != nullptr ? is2_1[i] : s1;
  const float w2 = is2_2 != nullptr ? is2_2[i] : s2;
  mask[i] = view_gate(T1 + 16 * b, X + 3 * i, k, uv1[2 * i], uv1[2 * i + 1],
                      w1, gate) &&
            view_gate(T2 + 16 * b, X + 3 * i, k, uv2[2 * i], uv2[2 * i + 1],
                      w2, gate);
}

}  // namespace

// K50's DLT mode for `batch` problems: P1, P2 (batch, 3, 4), uv1, uv2
// (batch, n, 2); outputs X (batch, n, 3) float32 and ok (batch, n) bool.
PSL_API int psl_triangulate_dlt(const float* P1, const float* P2,
                                const float* uv1, const float* uv2, int n,
                                int batch, float* X, unsigned char* ok,
                                cudaStream_t stream) {
  if (n < 0 || batch < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long total = static_cast<long long>(n) * batch;
  if (total > 0) {
    triangulate_dlt_kernel<<<static_cast<unsigned>((total + kThreads - 1) /
                                                   kThreads),
                             kThreads, 0, stream>>>(P1, P2, uv1, uv2, n, batch,
                                                    X, ok);
  }
  return static_cast<int>(cudaGetLastError());
}

// K50's gates mode for `batch` problems: X (batch, n, 3), T1, T2 (batch, 4,
// 4) camera-from-world, uv1, uv2 (batch, n, 2), the inverse sigma^2 of each
// view per point (batch, n) or, where NULL, the number s1 / s2; mask
// (batch, n) bool.
PSL_API int psl_reprojection_checks(const float* X, const float* T1,
                                    const float* T2, const float* uv1,
                                    const float* uv2, const float* is2_1,
                                    const float* is2_2, float s1, float s2,
                                    int n, int batch, float fx, float fy,
                                    float cx, float cy, float gate,
                                    bool* mask, cudaStream_t stream) {
  if (n < 0 || batch < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long total = static_cast<long long>(n) * batch;
  if (total > 0) {
    reprojection_checks_kernel<<<static_cast<unsigned>(
                                     (total + kThreads - 1) / kThreads),
                                 kThreads, 0, stream>>>(
        X, T1, T2, uv1, uv2, is2_1, is2_2, s1, s2, n, batch,
        Intrinsics{fx, fy, cx, cy}, gate, mask);
  }
  return static_cast<int>(cudaGetLastError());
}
