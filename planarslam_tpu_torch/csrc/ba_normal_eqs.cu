// K8 ba_normal_eqs — the point and line-endpoint normal equations of one
// bundle-adjustment LM step.
//
// Replaces the point and line blocks of planarslam_tpu/solvers/ba_core.py
// ::ba_solve.step (:361-404) and ba_pcg.py (:103-149): for every
// observation the residual, the analytic Jacobians (ba_core._point_jacs,
// ::_line_jacs), the Huber IRLS weight and chi2, summed into
//   Hcc (Kt, 6, 6), bc (Kt, 6)      per keyframe,
//   Hpp (M, 3, 3), bp (M, 3)        per landmark block,
//   Hcp (Kt, 6, M, 3)               per (keyframe, landmark), optional,
// and chi_pt (Kt, F), chi_ln (Kt, L2). Planes stay in PyTorch.
//
// No float atomics, so an LM accept test sees the same sums every run:
//   1. normal_eqs_obs_kernel, one thread per observation, writes its 54
//      terms (21 of J^T W J for the pose, 6 of J^T W r, 6 + 3 for the
//      landmark, 18 of the cross block) to scratch;
//   2. normal_eqs_kf_kernel, one block per keyframe, reduces its rows in a
//      fixed tree;
//   3. normal_eqs_lm_kernel, one thread per landmark, adds its observations
//      in the order of the plan (a stable sort by slot, built once per
//      solve);
//   4. normal_eqs_hcp_kernel, one thread per (keyframe, landmark), finds its
//      run in the keyframe's slot-sorted list by binary search and writes
//      the dense cross block, zeros included; a (k, slot) pair seen twice
//      adds.
// What bounds it on an H100: the dense Hcp write (118.6 MB at the GBA size
// Kt = 128, M = 12864: 35 us at 3.35 TB/s); the observation pass reads and
// writes 29 MB of scratch.
#include "common.cuh"

namespace {

constexpr int kStride = 54;
constexpr int kHcc = 0, kBc = 21, kHpp = 27, kBp = 33, kHcp = 36;
constexpr int kThreads = 256;
constexpr int kLmThreads = 128;

__device__ __forceinline__ int sym6(int i, int j) {
  return i * 6 - i * (i - 1) / 2 + (j - i);  // i <= j
}
__device__ __forceinline__ int sym3(int i, int j) {
  return i * 3 - i * (i - 1) / 2 + (j - i);  // i <= j
}

__device__ __forceinline__ float huber_w(float chi, float gate, int huber) {
  return (huber && chi > gate) ? sqrtf(gate / fmaxf(chi, 1e-12f)) : 1.0f;
}

__global__ void normal_eqs_obs_kernel(
    const float* __restrict__ poses, const float* __restrict__ pts,
    const int* __restrict__ pt_slot, const float* __restrict__ pt_uv,
    const float* __restrict__ pt_ur, const float* __restrict__ pt_is2,
    const float* __restrict__ pt_mask, const int* __restrict__ ln_slot,
    const float* __restrict__ ln_l2d, const float* __restrict__ ln_is2,
    const float* __restrict__ ln_mask, int Kt, int F, int L2, float fx,
    float fy, float cx, float cy, float bf, int huber,
    float* __restrict__ scratch, float* __restrict__ chi_pt,
    float* __restrict__ chi_ln) {
  const int n_pt = Kt * F;
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= Kt * (F + L2)) return;
  float* out = scratch + static_cast<size_t>(o) * kStride;
  const bool is_pt = o < n_pt;
  const int q = is_pt ? o : o - n_pt;
  const int k = is_pt ? q / F : q / L2;
  const float* T = poses + 16 * k;
  const int slot = is_pt ? pt_slot[q] : ln_slot[q];
  const float x0 = pts[3 * slot], x1 = pts[3 * slot + 1],
              x2 = pts[3 * slot + 2];
  float pc[3];
  for (int i = 0; i < 3; ++i) {
    pc[i] = T[4 * i] * x0 + T[4 * i + 1] * x1 + T[4 * i + 2] * x2 +
            T[4 * i + 3];
  }
  const float z = fmaxf(pc[2], 1e-6f), z2 = z * z;
  // hat(pc), rows
  const float hp[3][3] = {{0.0f, -pc[2], pc[1]},
                          {pc[2], 0.0f, -pc[0]},
                          {-pc[1], pc[0], 0.0f}};

  float Jc[3][6], Jl[3][3], r[3], W[3];
  int na;
  if (is_pt) {
    na = 3;
    const float u = fx * pc[0] / z + cx, v = fy * pc[1] / z + cy;
    const bool stereo = pt_ur[q] >= 0.0f;
    r[0] = pt_uv[2 * q] - u;
    r[1] = pt_uv[2 * q + 1] - v;
    r[2] = stereo ? pt_ur[q] - (u - bf / z) : 0.0f;
    const float chi = (r[0] * r[0] + r[1] * r[1] + r[2] * r[2]) * pt_is2[q];
    chi_pt[q] = chi;
    const float w = pt_is2[q] *
                    huber_w(chi, stereo ? 7.815f : 5.991f, huber) * pt_mask[q];
    W[0] = w;
    W[1] = w;
    W[2] = stereo ? w : 0.0f;
    const float dh[3][3] = {{fx / z, 0.0f, -fx * pc[0] / z2},
                            {0.0f, fy / z, -fy * pc[1] / z2},
                            {fx / z, 0.0f, -fx * pc[0] / z2 + bf / z2}};
    for (int a = 0; a < 3; ++a) {
      for (int j = 0; j < 3; ++j) {
        Jc[a][j] = -dh[a][j];
        Jc[a][3 + j] = dh[a][0] * hp[0][j] + dh[a][1] * hp[1][j] +
                       dh[a][2] * hp[2][j];
        Jl[a][j] = -(dh[a][0] * T[j] + dh[a][1] * T[4 + j] +
                     dh[a][2] * T[8 + j]);
      }
    }
  } else {
    na = 1;
    const float la = ln_l2d[3 * q], lb = ln_l2d[3 * q + 1],
                lc = ln_l2d[3 * q + 2];
    const float u = fx * pc[0] / z + cx, v = fy * pc[1] / z + cy;
    r[0] = la * u + lb * v + lc;
    const float chi = r[0] * r[0] * ln_is2[q];
    chi_ln[q] = chi;
    W[0] = ln_is2[q] * huber_w(chi, 5.991f, huber) * ln_mask[q];
    const float row[3] = {la * fx / z, lb * fy / z,
                          -(la * fx * pc[0] + lb * fy * pc[1]) / z2};
    for (int j = 0; j < 3; ++j) {
      Jc[0][j] = row[j];
      Jc[0][3 + j] = -(row[0] * hp[0][j] + row[1] * hp[1][j] +
                       row[2] * hp[2][j]);
      Jl[0][j] = row[0] * T[j] + row[1] * T[4 + j] + row[2] * T[8 + j];
    }
  }

  for (int i = 0; i < 6; ++i) {
    for (int j = i; j < 6; ++j) {
      float s = 0.0f;
      for (int a = 0; a < na; ++a) s += Jc[a][i] * W[a] * Jc[a][j];
      out[kHcc + sym6(i, j)] = s;
    }
    float b = 0.0f, c[3] = {0.0f, 0.0f, 0.0f};
    for (int a = 0; a < na; ++a) {
      b += Jc[a][i] * (r[a] * W[a]);
      for (int j = 0; j < 3; ++j) c[j] += Jc[a][i] * W[a] * Jl[a][j];
    }
    out[kBc + i] = b;
    for (int j = 0; j < 3; ++j) out[kHcp + 3 * i + j] = c[j];
  }
  for (int i = 0; i < 3; ++i) {
    for (int j = i; j < 3; ++j) {
      float s = 0.0f;
      for (int a = 0; a < na; ++a) s += Jl[a][i] * W[a] * Jl[a][j];
      out[kHpp + sym3(i, j)] = s;
    }
    float b = 0.0f;
    for (int a = 0; a < na; ++a) b += Jl[a][i] * (r[a] * W[a]);
    out[kBp + i] = b;
  }
}

// one block per keyframe: Hcc and bc over its F + L2 rows, fixed tree
__global__ void normal_eqs_kf_kernel(const float* __restrict__ scratch,
                                     int Kt, int F, int L2,
                                     float* __restrict__ Hcc,
                                     float* __restrict__ bc) {
  constexpr int kN = 27;
  __shared__ float red[kThreads / 32][kN];
  const int k = blockIdx.x;
  float acc[kN];
  for (int c = 0; c < kN; ++c) acc[c] = 0.0f;
  for (int idx = threadIdx.x; idx < F + L2; idx += kThreads) {
    const int o = idx < F ? k * F + idx : Kt * F + k * L2 + (idx - F);
    const float* row = scratch + static_cast<size_t>(o) * kStride;
    for (int c = 0; c < kN; ++c) acc[c] += row[c];
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int c = 0; c < kN; ++c) {
    float x = acc[c];
    for (int off = 16; off > 0; off >>= 1) {
      x += __shfl_down_sync(0xffffffffu, x, off);
    }
    if (lane == 0) red[warp][c] = x;
  }
  __syncthreads();
  if (threadIdx.x < kN) {
    float s = 0.0f;
    for (int w = 0; w < kThreads / 32; ++w) s += red[w][threadIdx.x];
    const int c = threadIdx.x;
    if (c < 21) {
      // c -> (i, j), i <= j
      int i = 0;
      while (c >= sym6(i, 5) + 1) ++i;
      const int j = i + (c - sym6(i, i));
      Hcc[36 * k + 6 * i + j] = s;
      Hcc[36 * k + 6 * j + i] = s;
    } else {
      bc[6 * k + (c - 21)] = s;
    }
  }
}

// one thread per landmark block: Hpp and bp in plan order
__global__ void normal_eqs_lm_kernel(const float* __restrict__ scratch,
                                     const int* __restrict__ lm_order,
                                     const int* __restrict__ lm_start, int M,
                                     float* __restrict__ Hpp,
                                     float* __restrict__ bp) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= M) return;
  float acc[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
  for (int e = lm_start[p]; e < lm_start[p + 1]; ++e) {
    const float* row = scratch + static_cast<size_t>(lm_order[e]) * kStride;
    for (int c = 0; c < 9; ++c) acc[c] += row[kHpp + c];
  }
  for (int i = 0; i < 3; ++i) {
    for (int j = i; j < 3; ++j) {
      Hpp[9 * p + 3 * i + j] = acc[sym3(i, j)];
      Hpp[9 * p + 3 * j + i] = acc[sym3(i, j)];
    }
    bp[3 * p + i] = acc[6 + i];
  }
}

// one thread per (keyframe, landmark): the dense cross block
__global__ void normal_eqs_hcp_kernel(const float* __restrict__ scratch,
                                      const int* __restrict__ kf_order,
                                      const int* __restrict__ kf_start,
                                      const int* __restrict__ kf_slot, int M,
                                      float* __restrict__ Hcp) {
  const int k = blockIdx.y;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= M) return;
  int lo = kf_start[k], hi = kf_start[k + 1];
  while (lo < hi) {  // first entry with slot >= p
    const int mid = (lo + hi) >> 1;
    if (kf_slot[mid] < p) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  float acc[18];
  for (int c = 0; c < 18; ++c) acc[c] = 0.0f;
  for (int e = lo; e < kf_start[k + 1] && kf_slot[e] == p; ++e) {
    const float* row = scratch + static_cast<size_t>(kf_order[e]) * kStride;
    for (int c = 0; c < 18; ++c) acc[c] += row[kHcp + c];
  }
  for (int i = 0; i < 6; ++i) {
    float* dst = Hcp + (static_cast<size_t>(k * 6 + i) * M + p) * 3;
    dst[0] = acc[3 * i];
    dst[1] = acc[3 * i + 1];
    dst[2] = acc[3 * i + 2];
  }
}

}  // namespace

PSL_API int psl_ba_normal_eqs(
    const float* poses, const float* pts, const int* pt_slot,
    const float* pt_uv, const float* pt_ur, const float* pt_is2,
    const float* pt_mask, const int* ln_slot, const float* ln_l2d,
    const float* ln_is2, const float* ln_mask, int Kt, int F, int L2, int M,
    float fx, float fy, float cx, float cy, float bf, int huber,
    const int* lm_order, const int* lm_start, const int* kf_order,
    const int* kf_start, const int* kf_slot, float* scratch, float* Hcc,
    float* bc, float* Hpp, float* bp, float* Hcp, float* chi_pt,
    float* chi_ln, cudaStream_t stream) {
  const int n_obs = Kt * (F + L2);
  if (n_obs > 0) {
    normal_eqs_obs_kernel<<<(n_obs + kThreads - 1) / kThreads, kThreads, 0,
                            stream>>>(
        poses, pts, pt_slot, pt_uv, pt_ur, pt_is2, pt_mask, ln_slot, ln_l2d,
        ln_is2, ln_mask, Kt, F, L2, fx, fy, cx, cy, bf, huber, scratch,
        chi_pt, chi_ln);
  }
  if (Kt > 0) {
    normal_eqs_kf_kernel<<<Kt, kThreads, 0, stream>>>(scratch, Kt, F, L2,
                                                      Hcc, bc);
  }
  const int n_blk = (M + kLmThreads - 1) / kLmThreads;
  if (M > 0) {
    normal_eqs_lm_kernel<<<n_blk, kLmThreads, 0, stream>>>(
        scratch, lm_order, lm_start, M, Hpp, bp);
  }
  if (Hcp != nullptr && M > 0 && Kt > 0) {
    normal_eqs_hcp_kernel<<<dim3(n_blk, Kt), kLmThreads, 0, stream>>>(
        scratch, kf_order, kf_start, kf_slot, M, Hcp);
  }
  return static_cast<int>(cudaGetLastError());
}
