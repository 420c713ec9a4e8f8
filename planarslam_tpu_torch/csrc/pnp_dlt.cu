// K7 pnp_dlt_hypotheses — 6-point DLT pose hypotheses and their inlier
// counts, one hypothesis per block.
//
// Replaces planarslam_tpu/solvers/pnp.py::_dlt_pose and the hypo body of
// ::_pnp_ransac (:25-70): per hypothesis, the 12 x 12 DLT system of its six
// picked correspondences, the right singular vector of the smallest
// singular value (the JAX package's jnp.linalg.svd, full_matrices), the
// depth-sign fix, the projection of P[:, :3] onto SO(3) with the uniform
// scale mean(S), then the reprojection chi2 of every correspondence and the
// inlier count (-1 when T is not finite). The argmax over hypotheses and the
// final inlier mask stay in PyTorch.
//
// One thread solves the hypothesis in fp64: a one-sided Jacobi SVD of A
// (linalg.cuh) in the thread's local memory, then the 3 x 3 polar rotation.
// The block's 128 threads then count inliers in float32 and reduce. What
// bounds it on an H100: the serial Jacobi (~10 sweeps of 66 rotations);
// 128 hypotheses fill 128 of the 132 SMs, so the launch is one solve long.
#include "common.cuh"
#include "linalg.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kPick = 6;

__global__ void pnp_dlt_kernel(
    const float* __restrict__ xw, const float* __restrict__ uv_n,
    const float* __restrict__ inv_sigma2, const unsigned char* __restrict__ valid,
    const int* __restrict__ picks, int n, float chi2_gate,
    int* __restrict__ scores, float* __restrict__ T_out) {
  __shared__ float T[16];
  __shared__ int cnt[kThreads / 32];
  const int h = blockIdx.x;

  if (threadIdx.x == 0) {
    double X[kPick][4], A[2 * kPick * 12];
    for (int r = 0; r < kPick; ++r) {
      const int p = picks[kPick * h + r];
      for (int k = 0; k < 3; ++k) X[r][k] = xw[3 * p + k];
      X[r][3] = 1.0;
      const double xn = uv_n[2 * p], yn = uv_n[2 * p + 1];
      double* ru = A + 12 * r;            // rows_u
      double* rv = A + 12 * (kPick + r);  // rows_v
      for (int k = 0; k < 4; ++k) {
        ru[k] = X[r][k];
        ru[4 + k] = 0.0;
        ru[8 + k] = -xn * X[r][k];
        rv[k] = 0.0;
        rv[4 + k] = X[r][k];
        rv[8 + k] = -yn * X[r][k];
      }
    }
    double V[144], P[12];
    psl_null_vector<2 * kPick, 12>(A, V, P);
    // points in front: flip the sign when the summed depth is negative
    double depth_sum = 0.0;
    for (int r = 0; r < kPick; ++r) {
      depth_sum += X[r][0] * P[8] + X[r][1] * P[9] + X[r][2] * P[10] +
                   X[r][3] * P[11];
    }
    if (depth_sum < 0.0) {
      for (int k = 0; k < 12; ++k) P[k] = -P[k];
    }
    double M3[9], R[9], sv[3];
    for (int a = 0; a < 3; ++a) {
      for (int b = 0; b < 3; ++b) M3[3 * a + b] = P[4 * a + b];
    }
    psl_nearest_rotation(M3, R, sv);
    const double scale = fmax((sv[0] + sv[1] + sv[2]) / 3.0, 1e-9);
    for (int a = 0; a < 3; ++a) {
      for (int b = 0; b < 3; ++b) T[4 * a + b] = static_cast<float>(R[3 * a + b]);
      T[4 * a + 3] = static_cast<float>(P[4 * a + 3] / scale);
    }
    T[12] = T[13] = T[14] = 0.0f;
    T[15] = 1.0f;
  }
  __syncthreads();

  bool finite = true;
  for (int k = 0; k < 16; ++k) finite = finite && isfinite(T[k]);
  int count = 0;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float x = xw[3 * i], y = xw[3 * i + 1], z = xw[3 * i + 2];
    const float pcx = T[0] * x + T[1] * y + T[2] * z + T[3];
    const float pcy = T[4] * x + T[5] * y + T[6] * z + T[7];
    const float pcz = T[8] * x + T[9] * y + T[10] * z + T[11];
    const float zc = fmaxf(pcz, 1e-6f);
    const float du = pcx / zc - uv_n[2 * i];
    const float dv = pcy / zc - uv_n[2 * i + 1];
    const float chi2 = (du * du + dv * dv) * inv_sigma2[i];
    count += ((chi2 < chi2_gate) && (pcz > 0.05f) && (valid[i] != 0)) ? 1 : 0;
  }
  for (int off = 16; off > 0; off >>= 1) {
    count += __shfl_xor_sync(0xffffffffu, count, off);
  }
  if ((threadIdx.x & 31) == 0) cnt[threadIdx.x >> 5] = count;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int k = 0; k < kThreads / 32; ++k) total += cnt[k];
    scores[h] = finite ? total : -1;
    for (int k = 0; k < 16; ++k) T_out[16 * h + k] = T[k];
  }
}

}  // namespace

PSL_API int psl_pnp_dlt_hypotheses(const float* xw, const float* uv_n,
                                   const float* inv_sigma2,
                                   const unsigned char* valid,
                                   const int* picks, int n, int n_hyp,
                                   float chi2_gate, int* scores, float* T,
                                   cudaStream_t stream) {
  if (n_hyp > 0 && n > 0) {
    pnp_dlt_kernel<<<n_hyp, kThreads, 0, stream>>>(
        xw, uv_n, inv_sigma2, valid, picks, n, chi2_gate, scores, T);
  }
  return static_cast<int>(cudaGetLastError());
}
