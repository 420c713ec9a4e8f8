// K15 manhattan_mean_shift — all rounds of the Manhattan-frame rotation
// refinement from one frame's normals, in one launch of one block.
//
// Replaces planarslam_tpu/ops/manhattan.py::track_manhattan_frame :38-121
// (per round: rotate the normals into the frame, cone membership, per axis
// ms_iters mean-shift steps on the tangent plane, support counts, the
// cross-product completion of one missing axis, re-orthonormalization, the
// ok select). The plain version is
// planarslam_tpu_torch/ops/manhattan.py::track_manhattan_frame_plain; the
// float32 arithmetic follows it operation by operation (eig3.cuh; compiled
// with -fmad=false; expf, sqrtf and IEEE division as PyTorch uses them).
//
// What bounds it on an H100: the latency of iters x (1 + ms_iters)
// dependent block reductions over N ~ 2k normals (~34 KB, ~1 MFLOP: under
// a microsecond at the card's rates). One block of 512 threads per frame
// (a batch of B frames, every array with a leading B, is one launch of B
// blocks, block b reading frame b at its strides); thread t
// owns normals t, t + 512, ... and recomputes their frame coordinates in
// registers each step. A normal votes for at most one axis, so one pass
// gives the weight sums of all three axes; they are summed in float64 by a
// shuffle tree in each warp and a second tree over the warp sums, a fixed
// order with no atomics, so two launches give equal bits. Thread 0 then
// does the serial tail of the round (axes, completion, polar factor).
//
// Optional epilogue (the tracking step's initial pose, replacing
// planarslam_tpu/slam/device_tracker.py:296-299): given T_pred, R_wm and
// the Manhattan switch, thread 0 writes use_manh = enabled && success and
// T_init = T_pred with its rotation replaced by R_cm R_wm^T where use_manh
// holds. Each entry of the product is ((a0 b0 + a1 b1) + a2 b2), the
// order of the plain version, ops/manhattan.py::init_select_plain.
#include <math.h>

#include "common.cuh"
#include "eig3.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

template <int NV>
__device__ __forceinline__ void block_sum(const double* v, double* warp_buf,
                                          double* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    double x = v[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      x += __shfl_down_sync(0xffffffffu, x, off);
    }
    if (lane == 0) warp_buf[warp * NV + k] = x;
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      double x = lane < kWarps ? warp_buf[lane * NV + k] : 0.0;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        x += __shfl_down_sync(0xffffffffu, x, off);
      }
      if (lane == 0) out[k] = x;
    }
  }
  __syncthreads();
}

// One normal in the frame R (row-major, columns = axes): the axis whose
// cone holds it (or -1) and its tangent-plane coordinates (u, v) there.
__device__ __forceinline__ int cone_of(const float* R, const float* n,
                                       bool valid, float cos_half, float* u,
                                       float* v) {
  float nm[3];
  for (int k = 0; k < 3; ++k) {
    nm[k] = n[0] * R[k] + n[1] * R[3 + k] + n[2] * R[6 + k];
  }
  int best = 0;
  float best_val = fabsf(nm[0]);
  for (int k = 1; k < 3; ++k) {
    if (fabsf(nm[k]) > best_val) {
      best_val = fabsf(nm[k]);
      best = k;
    }
  }
  if (!(best_val > cos_half) || !valid) return -1;
  const int i = (best + 1) % 3, j = (best + 2) % 3;
  const float s = nm[best] >= 0.0f ? 1.0f : -1.0f;
  const float denom = fmaxf(best_val, 1e-6f);
  *u = s * nm[i] / denom;
  *v = s * nm[j] / denom;
  return best;
}

struct InitSelect {
  const float* T_pred;               // (B, 4, 4), or NULL: no epilogue
  const float* R_wm;                 // (B, 3, 3)
  const unsigned char* enabled;      // (B,)
  float* T_init;                     // (B, 4, 4)
  unsigned char* use_manh;           // (B,)
};

// The epilogue for one frame, by thread 0 after the last round.
__device__ __forceinline__ void init_select(const InitSelect& e, int f,
                                            const float* R_cm, bool ok) {
  const float* T = e.T_pred + 16 * f;
  const float* W = e.R_wm + 9 * f;
  const bool use = e.enabled[f] != 0 && ok;
  float* out = e.T_init + 16 * f;
  for (int q = 0; q < 16; ++q) out[q] = T[q];
  if (use) {
    for (int i = 0; i < 3; ++i) {
      for (int j = 0; j < 3; ++j) {
        out[4 * i + j] = psl_dot3(R_cm + 3 * i, W + 3 * j);
      }
    }
  }
  e.use_manh[f] = use ? 1 : 0;
}

__global__ void __launch_bounds__(kThreads, 1)
    manhattan_kernel(const float* R_init, const float* normals,
                     const unsigned char* valid, int N, float cos_half,
                     float kernel, int min_support, int iters, int ms_iters,
                     float* R_out, long long* support_out,
                     long long* n_axes_out, unsigned char* success_out,
                     const InitSelect sel) {
  __shared__ float R[9];
  const int frame = blockIdx.x;
  {  // this block's frame
    const size_t f = frame;
    R_init += 9 * f;
    normals += 3 * f * N;
    valid += f * N;
    R_out += 9 * f;
    support_out += 3 * f;
    n_axes_out += f;
    success_out += f;
  }
  __shared__ float center[3][2];
  __shared__ double warp_buf[kWarps * 9];
  __shared__ double sums[9];
  const int tid = threadIdx.x;
  if (tid < 9) R[tid] = R_init[tid];
  __syncthreads();

  for (int rnd = 0; rnd < iters; ++rnd) {
    float Rr[9];
    for (int q = 0; q < 9; ++q) Rr[q] = R[q];
    if (tid < 6) center[tid / 2][tid % 2] = 0.0f;
    // support counts (whole numbers: exact in float64)
    double cnt[3] = {0.0, 0.0, 0.0};
    for (int i = tid; i < N; i += kThreads) {
      float u, v;
      const int k = cone_of(Rr, normals + 3 * i, valid[i] != 0, cos_half,
                            &u, &v);
      if (k >= 0) cnt[k] += 1.0;
    }
    block_sum<3>(cnt, warp_buf, sums);
    long long supp[3];
    for (int k = 0; k < 3; ++k) supp[k] = static_cast<long long>(sums[k]);
    __syncthreads();

    for (int ms = 0; ms < ms_iters; ++ms) {
      float c[3][2];
      for (int k = 0; k < 3; ++k) {
        c[k][0] = center[k][0];
        c[k][1] = center[k][1];
      }
      double acc[9];
      for (int q = 0; q < 9; ++q) acc[q] = 0.0;
      for (int i = tid; i < N; i += kThreads) {
        float u, v;
        const int k = cone_of(Rr, normals + 3 * i, valid[i] != 0, cos_half,
                              &u, &v);
        if (k < 0) continue;
        const float du = u - c[k][0], dv = v - c[k][1];
        const float d2 = du * du + dv * dv;
        const float wgt = expf(-kernel * d2);
        acc[3 * k] += wgt;
        acc[3 * k + 1] += wgt * u;
        acc[3 * k + 2] += wgt * v;
      }
      block_sum<9>(acc, warp_buf, sums);
      if (tid < 3) {
        const float wsum = fmaxf(static_cast<float>(sums[3 * tid]), 1e-9f);
        center[tid][0] = static_cast<float>(sums[3 * tid + 1]) / wsum;
        center[tid][1] = static_cast<float>(sums[3 * tid + 2]) / wsum;
      }
      __syncthreads();
    }

    if (tid == 0) {
      float axes[3][3];  // axes[k] = new axis k in the camera frame
      int n_found = 0;
      bool found[3];
      for (int k = 0; k < 3; ++k) {
        const int i = (k + 1) % 3, j = (k + 2) % 3;
        float dir[3];
        dir[i] = center[k][0];
        dir[j] = center[k][1];
        dir[k] = 1.0f;
        const float nrm = sqrtf(psl_dot3(dir, dir));
        for (int q = 0; q < 3; ++q) dir[q] = dir[q] / nrm;
        for (int r = 0; r < 3; ++r) axes[k][r] = psl_dot3(Rr + 3 * r, dir);
        found[k] = supp[k] >= min_support;
        n_found += found[k] ? 1 : 0;
      }
      float cols[3][3];  // cols[k] = column k
      for (int k = 0; k < 3; ++k) {
        for (int r = 0; r < 3; ++r) {
          cols[k][r] = found[k] ? axes[k][r] : Rr[3 * r + k];
        }
      }
      float crosses[3][3];
      psl_cross3(cols[1], cols[2], crosses[0]);
      psl_cross3(cols[2], cols[0], crosses[1]);
      psl_cross3(cols[0], cols[1], crosses[2]);
      float next[9];
      for (int k = 0; k < 3; ++k) {
        const float prev[3] = {Rr[k], Rr[3 + k], Rr[6 + k]};
        const float sgn = psl_dot3(crosses[k], prev) >= 0.0f ? 1.0f : -1.0f;
        const bool use_cross = !found[k] && n_found == 2;
        for (int r = 0; r < 3; ++r) {
          next[3 * r + k] = use_cross ? crosses[k][r] * sgn : cols[k][r];
        }
      }
      const bool ok = n_found >= 2;
      if (ok) {
        float R_new[9];
        psl_orthonormalize(next, R_new);
        for (int q = 0; q < 9; ++q) R[q] = R_new[q];
      }
      if (rnd == iters - 1) {
        for (int q = 0; q < 9; ++q) R_out[q] = R[q];
        for (int k = 0; k < 3; ++k) support_out[k] = supp[k];
        *n_axes_out = n_found;
        *success_out = ok ? 1 : 0;
        if (sel.T_pred != nullptr) init_select(sel, frame, R, ok);
      }
    }
    __syncthreads();
  }
}

}  // namespace

PSL_API int psl_manhattan_mean_shift(
    const float* R_init, const float* normals, const unsigned char* valid,
    int N, int batch, float cos_half, float kernel, int min_support,
    int iters, int ms_iters, float* R_out, long long* support,
    long long* n_axes, unsigned char* success, const float* T_pred,
    const float* R_wm, const unsigned char* enabled, float* T_init,
    unsigned char* use_manh, cudaStream_t stream) {
  if (iters < 1 || batch < 1) return static_cast<int>(cudaErrorInvalidValue);
  const InitSelect sel{T_pred, R_wm, enabled, T_init, use_manh};
  manhattan_kernel<<<batch, kThreads, 0, stream>>>(
      R_init, normals, valid, N, cos_half, kernel, min_support, iters,
      ms_iters, R_out, support, n_axes, success, sel);
  return static_cast<int>(cudaGetLastError());
}
