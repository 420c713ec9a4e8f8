// K32 refine_relative — Gauss-Newton refinement of a loop edge.
//
// Replaces planarslam_tpu/solvers/sim3_solver.py::_refine_relative
// (:117-167, a lax.scan of 8 steps with jax.jacfwd of the residual): the
// relative transform S12 = (s R, t) between two keyframes, refined on the
// bidirectional reprojection of N correspondences (camera 2's points into
// camera 1 through S12, camera 1's into camera 2 through S12^-1) with a
// Huber weight on each direction's chi2, a 7-dof left update [rho, phi,
// sigma] (sigma frozen when fix_scale), H = J^T W J + 1e-6 I, dx = -H^-1 g,
// and the step kept only when dx is finite.
//
// One block per problem runs every step: per correspondence the residuals
// and the analytic Jacobian (sim3_solver._refine_relative_plain writes the
// same columns out), the 28 + 7 sums of J^T W J and J^T W r in float64 in a
// fixed order (a strided loop per thread, then shuffle trees), a 7 x 7
// solve with partial pivoting in float64 on one thread, the se3_exp update
// in float32. What bounds it on an H100: a chain of n_iters dependent
// steps, each a block reduction and a serial solve; the bytes (N x 52 per
// problem, read once per step from L1/L2) are not the limit.
#include "common.cuh"
#include "lie.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 35;  // 28 of J^T W J (upper triangle), 7 of J^T W r

__device__ __forceinline__ int sym7(int i, int j) {
  return i * 7 - i * (i - 1) / 2 + (j - i);  // i <= j
}

struct Problem {
  float fx, fy, cx, cy, huber;
  int N, fix_scale;
};

// project() of the refinement and d(u, v)/dp; the clamp at z = 1e-6 passes
// no derivative to z below it
__device__ __forceinline__ void proj_jac(const Problem& P, const float* p,
                                         float* uv, float (*J)[3]) {
  const float z = fmaxf(p[2], 1e-6f);
  const bool front = p[2] > 1e-6f;
  const float z2 = z * z;
  uv[0] = P.fx * p[0] / z + P.cx;
  uv[1] = P.fy * p[1] / z + P.cy;
  J[0][0] = P.fx / z;
  J[0][1] = 0.0f;
  J[0][2] = front ? -P.fx * p[0] / z2 : 0.0f;
  J[1][0] = 0.0f;
  J[1][1] = P.fy / z;
  J[1][2] = front ? -P.fy * p[1] / z2 : 0.0f;
}

// one correspondence's weighted terms of both directions, added to acc
__device__ __forceinline__ void correspondence_terms(
    const Problem& P, const float* T, float s, const float* p1,
    const float* p2, const float* uv1, const float* uv2, float v,
    double* acc) {
  const float sc = fmaxf(s, 1e-9f);
  const float sig = P.fix_scale ? 0.0f : 1.0f;
  float sR2[3], p21[3], q[3], p12[3];
  for (int k = 0; k < 3; ++k) {
    sR2[k] = s * (T[4 * k] * p2[0] + T[4 * k + 1] * p2[1] +
                  T[4 * k + 2] * p2[2]);
    p21[k] = sR2[k] + T[4 * k + 3];
    q[k] = p1[k] - T[4 * k + 3];
  }
  for (int k = 0; k < 3; ++k) {
    p12[k] = (q[0] * T[k] + q[1] * T[4 + k] + q[2] * T[8 + k]) / sc;
  }
  // dp/dxi (3 x 7) of both directions
  float D1[3][7], D2[3][7];
  const float h21[3][3] = {{0.0f, -p21[2], p21[1]},
                           {p21[2], 0.0f, -p21[0]},
                           {-p21[1], p21[0], 0.0f}};
  const float h1[3][3] = {{0.0f, -p1[2], p1[1]},
                          {p1[2], 0.0f, -p1[0]},
                          {-p1[1], p1[0], 0.0f}};
  for (int a = 0; a < 3; ++a) {
    for (int k = 0; k < 3; ++k) {
      D1[a][k] = a == k ? 1.0f : 0.0f;
      D1[a][3 + k] = -h21[a][k];
      // R^T: (R^T)[a][m] = T[4 m + a]
      D2[a][k] = -T[4 * k + a] / sc;
      D2[a][3 + k] = (T[a] * h1[0][k] + T[4 + a] * h1[1][k] +
                      T[8 + a] * h1[2][k]) / sc;
    }
    D1[a][6] = sig * sR2[a];
    D2[a][6] = -sig * (s > 1e-9f ? p12[a] : 0.0f);
  }
  float uvh[2], Pj[2][3];
  for (int dir = 0; dir < 2; ++dir) {
    const float(*D)[7] = dir == 0 ? D1 : D2;
    const float* obs = dir == 0 ? uv1 : uv2;
    proj_jac(P, dir == 0 ? p21 : p12, uvh, Pj);
    const float r[2] = {(obs[0] - uvh[0]) * v, (obs[1] - uvh[1]) * v};
    float J[2][7];
    for (int a = 0; a < 2; ++a) {
      for (int c = 0; c < 7; ++c) {
        J[a][c] = -(Pj[a][0] * D[0][c] + Pj[a][1] * D[1][c] +
                    Pj[a][2] * D[2][c]) * v;
      }
    }
    const float chi = r[0] * r[0] + r[1] * r[1];
    const float w =
        chi > P.huber ? sqrtf(P.huber / fmaxf(chi, 1e-9f)) : 1.0f;
    for (int a = 0; a < 2; ++a) {
      for (int i = 0; i < 7; ++i) {
        const float jw = J[a][i] * w;
        for (int j = i; j < 7; ++j) {
          acc[sym7(i, j)] += static_cast<double>(jw * J[a][j]);
        }
        acc[28 + i] += static_cast<double>(jw * r[a]);
      }
    }
  }
}

// dx = -(H + 1e-6 I)^-1 g in float64, LU with partial pivoting (as
// jnp.linalg.solve); a zero pivot gives a non-finite dx, which the step
// rejects
__device__ void solve7(const double* sums, float* dx) {
  double A[7][8];
  for (int a = 0; a < 7; ++a) {
    for (int b = a; b < 7; ++b) {
      A[a][b] = sums[sym7(a, b)];
      A[b][a] = A[a][b];
    }
  }
  for (int a = 0; a < 7; ++a) {
    A[a][a] += 1e-6;
    A[a][7] = sums[28 + a];
  }
  for (int c = 0; c < 7; ++c) {
    int piv = c;
    for (int r = c + 1; r < 7; ++r) {
      if (fabs(A[r][c]) > fabs(A[piv][c])) piv = r;
    }
    if (piv != c) {
      for (int q = 0; q < 8; ++q) {
        const double tmp = A[c][q];
        A[c][q] = A[piv][q];
        A[piv][q] = tmp;
      }
    }
    for (int r = c + 1; r < 7; ++r) {
      const double f = A[r][c] / A[c][c];
      for (int q = c; q < 8; ++q) A[r][q] -= f * A[c][q];
    }
  }
  double x[7];
  for (int a = 6; a >= 0; --a) {
    double s = A[a][7];
    for (int q = a + 1; q < 7; ++q) s -= A[a][q] * x[q];
    x[a] = s / A[a][a];
  }
  for (int a = 0; a < 7; ++a) dx[a] = -static_cast<float>(x[a]);
}

__global__ void __launch_bounds__(kThreads)
    refine_relative_kernel(const float* __restrict__ T_init,
                           const float* __restrict__ s_init,
                           const float* __restrict__ pts1,
                           const float* __restrict__ pts2,
                           const float* __restrict__ uv1,
                           const float* __restrict__ uv2,
                           const float* __restrict__ valid, const Problem P,
                           int n_iters, float* __restrict__ T_out,
                           float* __restrict__ s_out) {
  __shared__ float T[16], T_new[16];
  __shared__ float s_cur;
  __shared__ double warp_buf[kWarps][kSums];
  __shared__ double sums[kSums];
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t off = static_cast<size_t>(b) * P.N;
  if (tid < 16) T[tid] = T_init[16 * b + tid];
  if (tid == 0) s_cur = s_init[b];
  __syncthreads();
  for (int it = 0; it < n_iters; ++it) {
    double acc[kSums];
    for (int c = 0; c < kSums; ++c) acc[c] = 0.0;
    const float s = s_cur;
    for (int i = tid; i < P.N; i += kThreads) {
      correspondence_terms(P, T, s, pts1 + 3 * (off + i),
                           pts2 + 3 * (off + i), uv1 + 2 * (off + i),
                           uv2 + 2 * (off + i), valid[off + i], acc);
    }
    for (int c = 0; c < kSums; ++c) {
      double x = acc[c];
      for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
      if (lane == 0) warp_buf[warp][c] = x;
    }
    __syncthreads();
    if (tid < kSums) {
      double x = 0.0;
      for (int w = 0; w < kWarps; ++w) x += warp_buf[w][tid];
      sums[tid] = x;
    }
    __syncthreads();
    if (tid == 0) {
      float dx[7];
      solve7(sums, dx);
      bool ok = true;
      for (int a = 0; a < 7; ++a) ok = ok && isfinite(dx[a]);
      psl::se3_exp_mul(dx, T, T_new);
      if (ok) {
        for (int k = 0; k < 16; ++k) T[k] = T_new[k];
        if (!P.fix_scale) s_cur = s * expf(dx[6]);
      }
    }
    __syncthreads();
  }
  if (tid < 16) T_out[16 * b + tid] = T[tid];
  if (tid == 0) s_out[b] = s_cur;
}

}  // namespace

PSL_API int psl_refine_relative(const float* T_init, const float* s_init,
                                const float* pts1, const float* pts2,
                                const float* uv1, const float* uv2,
                                const float* valid, int batch, int N,
                                float fx, float fy, float cx, float cy,
                                int fix_scale, int n_iters, float huber,
                                float* T_out, float* s_out,
                                cudaStream_t stream) {
  if (batch <= 0) return 0;
  const Problem P{fx, fy, cx, cy, huber, N, fix_scale};
  refine_relative_kernel<<<batch, kThreads, 0, stream>>>(
      T_init, s_init, pts1, pts2, uv1, uv2, valid, P, n_iters, T_out, s_out);
  return static_cast<int>(cudaGetLastError());
}
