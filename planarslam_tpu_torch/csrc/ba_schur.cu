// K9 ba_schur_eliminate — Schur elimination of the landmark blocks of one
// bundle-adjustment LM step, and its back-substitution.
//
// Replaces planarslam_tpu/solvers/ba_core.py::ba_solve.step :463-473 and
// :491-492. First entry, psl_ba_schur_eliminate:
//   Hpp_d = Hpp + lam diag(Hpp) + (lam mu_p + 1e-6) I     (float32)
//   Hpp_inv = Hpp_d^-1                                    (adjugate, fp64)
//   HcpHinv[k, :, p, :] = Hcp[k, :, p, :] Hpp_inv[p]      (Kt, 6, M, 3)
//   rhs[k] = bc[k] - sum_p HcpHinv[k, :, p, :] bp[p]
// lam and mu_p are device scalars, so the LM loop needs no host sync. The
// rhs sum runs per block in a fixed tree, then per keyframe over the
// blocks in order (no atomics). Second entry, psl_ba_schur_backsub:
//   dxp[p] = -Hpp_inv[p] (bp[p] + sum_k Hcp[k, :, p, :]^T dxc[k]),
// split over keyframe ranges and summed in order. The reduced camera
// system (HcpHinv Hcp^T) stays one matrix product outside the kernel.
// What bounds it on an H100: bytes. At Kt = 128, M = 12864 the first entry
// reads Hcp (118.6 MB) and writes HcpHinv (118.6 MB): 71 us at 3.35 TB/s;
// the second reads Hcp once more.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void schur_inv_kernel(const float* __restrict__ Hpp,
                                 const float* __restrict__ lam_p,
                                 const float* __restrict__ mu_p, int M,
                                 float* __restrict__ Hinv) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= M) return;
  const float lam = *lam_p;
  const float floor_ = lam * (*mu_p) + 1e-6f;
  double a[9];
  for (int c = 0; c < 9; ++c) {
    float v = Hpp[9 * p + c];
    if (c % 4 == 0) v = (v + lam * v) + floor_;
    a[c] = v;
  }
  const double c00 = a[4] * a[8] - a[5] * a[7];
  const double c01 = a[5] * a[6] - a[3] * a[8];
  const double c02 = a[3] * a[7] - a[4] * a[6];
  const double det = a[0] * c00 + a[1] * c01 + a[2] * c02;
  const double inv[9] = {c00,
                         a[2] * a[7] - a[1] * a[8],
                         a[1] * a[5] - a[2] * a[4],
                         c01,
                         a[0] * a[8] - a[2] * a[6],
                         a[2] * a[3] - a[0] * a[5],
                         c02,
                         a[1] * a[6] - a[0] * a[7],
                         a[0] * a[4] - a[1] * a[3]};
  for (int c = 0; c < 9; ++c) {
    Hinv[9 * p + c] = static_cast<float>(inv[c] / det);
  }
}

__global__ void schur_elim_kernel(const float* __restrict__ Hcp,
                                  const float* __restrict__ Hinv,
                                  const float* __restrict__ bp, int M,
                                  float* __restrict__ HcpHinv,
                                  float* __restrict__ partial) {
  __shared__ float red[kThreads / 32][6];
  const int k = blockIdx.y;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  float part[6] = {0, 0, 0, 0, 0, 0};
  if (p < M) {
    float h[9], b[3];
    for (int c = 0; c < 9; ++c) h[c] = Hinv[9 * p + c];
    for (int c = 0; c < 3; ++c) b[c] = bp[3 * p + c];
    for (int i = 0; i < 6; ++i) {
      const size_t off = (static_cast<size_t>(k * 6 + i) * M + p) * 3;
      const float x0 = Hcp[off], x1 = Hcp[off + 1], x2 = Hcp[off + 2];
      float y[3];
      for (int l = 0; l < 3; ++l) {
        y[l] = x0 * h[l] + x1 * h[3 + l] + x2 * h[6 + l];
        HcpHinv[off + l] = y[l];
      }
      part[i] = y[0] * b[0] + y[1] * b[1] + y[2] * b[2];
    }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = 0; i < 6; ++i) {
    float x = part[i];
    for (int off = 16; off > 0; off >>= 1) {
      x += __shfl_down_sync(0xffffffffu, x, off);
    }
    if (lane == 0) red[warp][i] = x;
  }
  __syncthreads();
  if (threadIdx.x < 6) {
    float s = 0.0f;
    for (int w = 0; w < kThreads / 32; ++w) s += red[w][threadIdx.x];
    partial[(static_cast<size_t>(k) * gridDim.x + blockIdx.x) * 6 +
            threadIdx.x] = s;
  }
}

__global__ void schur_rhs_kernel(const float* __restrict__ partial,
                                 const float* __restrict__ bc, int n_blk,
                                 float* __restrict__ rhs) {
  const int k = blockIdx.x, i = threadIdx.x;
  if (i >= 6) return;
  float s = 0.0f;
  for (int b = 0; b < n_blk; ++b) {
    s += partial[(static_cast<size_t>(k) * n_blk + b) * 6 + i];
  }
  rhs[6 * k + i] = bc[6 * k + i] - s;
}

// partial[s, p] = sum over keyframes k = s, s + ks, ... of
// Hcp[k, :, p]^T dxc[k]
__global__ void schur_backsub_partial_kernel(const float* __restrict__ Hcp,
                                             const float* __restrict__ dxc,
                                             int Kt,
                                             int M,
                                             float* __restrict__ partial) {
  const int s = blockIdx.y, ks = gridDim.y;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= M) return;
  float v[3] = {0.0f, 0.0f, 0.0f};
  for (int k = s; k < Kt; k += ks) {
    for (int i = 0; i < 6; ++i) {
      const float d = dxc[6 * k + i];
      const size_t off = (static_cast<size_t>(k * 6 + i) * M + p) * 3;
      v[0] += Hcp[off] * d;
      v[1] += Hcp[off + 1] * d;
      v[2] += Hcp[off + 2] * d;
    }
  }
  for (int j = 0; j < 3; ++j) {
    partial[(static_cast<size_t>(s) * M + p) * 3 + j] = v[j];
  }
}

__global__ void schur_backsub_final_kernel(const float* __restrict__ Hinv,
                                           const float* __restrict__ bp,
                                           const float* __restrict__ partial,
                                           int M, int ks,
                                           float* __restrict__ dxp) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= M) return;
  float v[3] = {bp[3 * p], bp[3 * p + 1], bp[3 * p + 2]};
  for (int s = 0; s < ks; ++s) {
    for (int j = 0; j < 3; ++j) {
      v[j] += partial[(static_cast<size_t>(s) * M + p) * 3 + j];
    }
  }
  for (int i = 0; i < 3; ++i) {
    dxp[3 * p + i] = -(Hinv[9 * p + 3 * i] * v[0] +
                       Hinv[9 * p + 3 * i + 1] * v[1] +
                       Hinv[9 * p + 3 * i + 2] * v[2]);
  }
}

}  // namespace

PSL_API int psl_ba_schur_eliminate(const float* Hpp, const float* bp,
                                   const float* Hcp, const float* bc,
                                   const float* lam, const float* mu_p,
                                   int Kt, int M, float* Hinv,
                                   float* HcpHinv, float* rhs,
                                   float* partial, cudaStream_t stream) {
  const int n_blk = (M + kThreads - 1) / kThreads;
  if (M > 0) {
    schur_inv_kernel<<<n_blk, kThreads, 0, stream>>>(Hpp, lam, mu_p, M, Hinv);
  }
  if (Kt > 0) {
    if (M > 0) {
      schur_elim_kernel<<<dim3(n_blk, Kt), kThreads, 0, stream>>>(
          Hcp, Hinv, bp, M, HcpHinv, partial);
    }
    schur_rhs_kernel<<<Kt, 32, 0, stream>>>(partial, bc, n_blk, rhs);
  }
  return static_cast<int>(cudaGetLastError());
}

PSL_API int psl_ba_schur_backsub(const float* Hinv, const float* bp,
                                 const float* Hcp, const float* dxc, int Kt,
                                 int M, int ks, float* partial, float* dxp,
                                 cudaStream_t stream) {
  const int n_blk = (M + kThreads - 1) / kThreads;
  if (M > 0 && ks > 0) {
    schur_backsub_partial_kernel<<<dim3(n_blk, ks), kThreads, 0, stream>>>(
        Hcp, dxc, Kt, M, partial);
    schur_backsub_final_kernel<<<n_blk, kThreads, 0, stream>>>(
        Hinv, bp, partial, M, ks, dxp);
  }
  return static_cast<int>(cudaGetLastError());
}
