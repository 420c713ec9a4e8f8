// K6 horn_align_batch — weighted rigid alignment and its inlier count, one
// weight row per block.
//
// Replaces planarslam_tpu/solvers/sim3_solver.py::horn_align inside
// ::_ransac_align (:23-73): for each weight row, the weighted means and the
// 3 x 3 cross-covariance over all N correspondences (every point carries the
// wrapper's +1e-9 weight, as in JAX), R = U diag(1, 1, det(U V^T)) V^T of its
// SVD, t = mu_dst - R mu_src, and the inlier mask and count at
// |R src + t - dst|^2 < thr^2 on valid points. The wrapper launches it twice
// per RANSAC: once with the 64 one-hot hypothesis rows, once with the single
// row of the inlier refit; the argmax between them stays in PyTorch.
//
// R is unique for rank(C) >= 2, whatever sign or order convention an SVD
// routine follows, so the kernel need not reproduce LAPACK's: it takes U
// and V from a one-sided Jacobi SVD of C and the third singular vectors as
// cross products (linalg.cuh::psl_nearest_rotation). A hypothesis whose
// picks repeat a point leaves C near rank 1; the one-sided form keeps its
// second singular vector, which an eigen-decomposition of C^T C loses.
//
// One 256-thread block per row: two fp64 block reductions (the weighted
// means, then the centred cross-covariance, as the JAX function centres
// before its product), one thread for the 3 x 3 rotation, then every
// thread tests its points in float32. What bounds it on an H100: launch and
// the reductions' barriers; 65 rows x 4096 points x 24 B is 6 MB of L2
// traffic.
#include "common.cuh"
#include "linalg.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <int K>
__device__ __forceinline__ void block_sum(double* vals, double* smem) {
  // vals: K per-thread partials -> every thread gets the block totals
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int k = 0; k < K; ++k) {
    double x = vals[k];
    for (int off = 16; off > 0; off >>= 1) {
      x += __shfl_xor_sync(0xffffffffu, x, off);
    }
    if (lane == 0) smem[warp * K + k] = x;
  }
  __syncthreads();
  for (int k = 0; k < K; ++k) {
    double acc = 0.0;
    for (int w = 0; w < kWarps; ++w) acc += smem[w * K + k];
    vals[k] = acc;
  }
  __syncthreads();
}

__global__ void horn_align_kernel(
    const float* __restrict__ src, const float* __restrict__ dst,
    const float* __restrict__ valid, const float* __restrict__ weights,
    int n, float threshold, float* __restrict__ R_out,
    float* __restrict__ t_out, int* __restrict__ n_inl,
    unsigned char* __restrict__ inl) {
  __shared__ double red[kWarps * 9];
  __shared__ float rt[12];
  __shared__ int cnt[kWarps];
  const int row = blockIdx.x;
  const float* w = weights + static_cast<size_t>(row) * n;

  // pass 1: weight total and weighted sums of src and dst
  double s1[7] = {0, 0, 0, 0, 0, 0, 0};
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const double wi = w[i];
    s1[0] += wi;
    for (int k = 0; k < 3; ++k) {
      s1[1 + k] += wi * src[3 * i + k];
      s1[4 + k] += wi * dst[3 * i + k];
    }
  }
  block_sum<7>(s1, red);
  const double wsum = fmax(s1[0], 1e-9);
  const double mu_s[3] = {s1[1] / wsum, s1[2] / wsum, s1[3] / wsum};
  const double mu_d[3] = {s1[4] / wsum, s1[5] / wsum, s1[6] / wsum};

  // pass 2: centred cross-covariance C = sum w (d - mu_d)(s - mu_s)^T / W
  double c[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const double wi = w[i] / wsum;
    double xs[3], xd[3];
    for (int k = 0; k < 3; ++k) {
      xs[k] = src[3 * i + k] - mu_s[k];
      xd[k] = dst[3 * i + k] - mu_d[k];
    }
    for (int a = 0; a < 3; ++a) {
      for (int b = 0; b < 3; ++b) c[3 * a + b] += wi * xd[a] * xs[b];
    }
  }
  block_sum<9>(c, red);

  if (threadIdx.x == 0) {
    double R[9], sv[3];
    psl_nearest_rotation(c, R, sv);
    for (int a = 0; a < 3; ++a) {
      const double t = mu_d[a] - (R[3 * a] * mu_s[0] + R[3 * a + 1] * mu_s[1] +
                                  R[3 * a + 2] * mu_s[2]);
      for (int b = 0; b < 3; ++b) rt[3 * a + b] = static_cast<float>(R[3 * a + b]);
      rt[9 + a] = static_cast<float>(t);
    }
    for (int k = 0; k < 9; ++k) R_out[9 * row + k] = rt[k];
    for (int k = 0; k < 3; ++k) t_out[3 * row + k] = rt[9 + k];
  }
  __syncthreads();

  // pass 3: inliers at the float32 pose
  const float thr2 = threshold * threshold;
  int count = 0;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float sx = src[3 * i], sy = src[3 * i + 1], sz = src[3 * i + 2];
    float err = 0.0f;
    for (int a = 0; a < 3; ++a) {
      const float p = sx * rt[3 * a] + sy * rt[3 * a + 1] + sz * rt[3 * a + 2] +
                      rt[9 + a];
      const float d = p - dst[3 * i + a];
      err += d * d;
    }
    const bool ok = (err < thr2) && (valid[i] > 0.0f);
    inl[static_cast<size_t>(row) * n + i] = ok ? 1 : 0;
    count += ok ? 1 : 0;
  }
  for (int off = 16; off > 0; off >>= 1) {
    count += __shfl_xor_sync(0xffffffffu, count, off);
  }
  if ((threadIdx.x & 31) == 0) cnt[threadIdx.x >> 5] = count;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int k = 0; k < kWarps; ++k) total += cnt[k];
    n_inl[row] = total;
  }
}

}  // namespace

PSL_API int psl_horn_align_batch(const float* src, const float* dst,
                                 const float* valid, const float* weights,
                                 int h, int n, float threshold, float* R,
                                 float* t, int* n_inl, unsigned char* inl,
                                 cudaStream_t stream) {
  if (h > 0 && n > 0) {
    horn_align_kernel<<<h, kThreads, 0, stream>>>(src, dst, valid, weights, n,
                                                  threshold, R, t, n_inl, inl);
  }
  return static_cast<int>(cudaGetLastError());
}
