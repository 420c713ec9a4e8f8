// K36 step_prelude — the tracking step's prelude, between extraction and
// the Manhattan mean shift (K15).
//
// Replaces planarslam_tpu/slam/device_tracker.py::_track_core :274-290:
// the pose override and velocity selections (T_last, the motion model),
// the predicted pose T_pred = velocity T_last, the 3D line directions with
// their validity (length > 0.1 m, lifted and valid), their concatenation
// after the frame's surface normals (K15's N = n_normals + n_lines
// directions) and the Manhattan prediction R_init = T_pred[:3, :3] R_wm.
// The plain version is
// planarslam_tpu_torch/slam/device_tracker.py::step_prelude_plain. Both
// spell each operation in the float form the step's PyTorch ops took on
// the card before this kernel (measured on an H100), so tracking keeps its
// bits: T_pred's entries fma(a1, b1, a0 b0) + fma(a3, b3, a2 b2) (the
// library's 4 x 4 product), R_init's fma(a1, b1, a0 b0) + a2 b2 (its 3 x 3
// product of a 4 x 4's corner), |v| = sqrt((v0^2 + v2^2) + v1^2) (its
// vector norm), IEEE division and square root. A fused multiply-add is
// computed as the float64 sum of the exact float64 product, rounded to
// float32, by both (this file is compiled with -fmad=false), so the kernel
// equals its plain version bit for bit.
//
// Design. One block of 256 threads per frame of a batch (every array
// carries a leading B): threads 0-15 form T_last and the selected
// velocity, then T_pred, threads 0-8 R_init, and all threads walk the
// n_normals + n_lines rows of the direction set. What bounds it on an
// H100: launch latency. It moves ~34 KB per frame (the 2048 normals in
// and out, 64 lines) and does ~1k operations: tens of nanoseconds at the
// card's rates.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// a b + c rounded once to float32 (the product is exact in float64)
__device__ __forceinline__ float fma64(float a, float b, float c) {
  return __double2float_rn(__dadd_rn(__dmul_rn(a, b), c));
}

__global__ void __launch_bounds__(kThreads)
    step_prelude_kernel(const float* __restrict__ T_override,
                        const unsigned char* __restrict__ use_override,
                        const float* __restrict__ T_cw,
                        const float* __restrict__ velocity,
                        const float* __restrict__ p3d_s,
                        const float* __restrict__ p3d_e,
                        const unsigned char* __restrict__ has_3d,
                        const unsigned char* __restrict__ ln_valid, int L,
                        const float* __restrict__ normals,
                        const unsigned char* __restrict__ normals_valid,
                        int Nn, const float* __restrict__ R_wm,
                        float* __restrict__ T_last_out,
                        float* __restrict__ T_pred_out,
                        float* __restrict__ dirs,
                        unsigned char* __restrict__ dirs_valid,
                        float* __restrict__ R_init) {
  __shared__ float T_last[16], vel[16], T_pred[16];
  const int tid = threadIdx.x;
  const size_t f = blockIdx.x;
  const bool ovr = use_override[f] != 0;
  if (tid < 16) {
    const int i = tid / 4, j = tid % 4;
    T_last[tid] = ovr ? T_override[16 * f + tid] : T_cw[16 * f + tid];
    vel[tid] = ovr ? (i == j ? 1.0f : 0.0f) : velocity[16 * f + tid];
  }
  __syncthreads();
  if (tid < 16) {
    const int i = tid / 4, j = tid % 4;
    const float* v = vel + 4 * i;
    const float p = fma64(v[1], T_last[4 + j], v[0] * T_last[j]) +
                    fma64(v[3], T_last[12 + j], v[2] * T_last[8 + j]);
    T_pred[tid] = p;
    T_pred_out[16 * f + tid] = p;
    T_last_out[16 * f + tid] = T_last[tid];
  }
  __syncthreads();
  if (tid < 9) {
    const int i = tid / 3, j = tid % 3;
    const float* W = R_wm + 9 * f;
    const float* t = T_pred + 4 * i;
    R_init[9 * f + tid] =
        fma64(t[1], W[3 + j], t[0] * W[j]) + t[2] * W[6 + j];
  }
  const int N = Nn + L;
  float* d_out = dirs + 3 * f * N;
  unsigned char* ok_out = dirs_valid + f * N;
  for (int r = tid; r < N; r += kThreads) {
    if (r < Nn) {
      const float* n = normals + 3 * (f * Nn + r);
      d_out[3 * r] = n[0];
      d_out[3 * r + 1] = n[1];
      d_out[3 * r + 2] = n[2];
      ok_out[r] = normals_valid[f * Nn + r];
    } else {
      const size_t l = f * L + (r - Nn);
      const float* s = p3d_s + 3 * l;
      const float* e = p3d_e + 3 * l;
      const float v0 = e[0] - s[0], v1 = e[1] - s[1], v2 = e[2] - s[2];
      const float len = __fsqrt_rn((v0 * v0 + v2 * v2) + v1 * v1);
      // torch.clamp(len, min=1e-9): NaN stays NaN
      const float den = len < 1e-9f ? 1e-9f : len;
      d_out[3 * r] = __fdiv_rn(v0, den);
      d_out[3 * r + 1] = __fdiv_rn(v1, den);
      d_out[3 * r + 2] = __fdiv_rn(v2, den);
      ok_out[r] = (has_3d[l] != 0 && ln_valid[l] != 0 && len > 0.1f) ? 1 : 0;
    }
  }
}

}  // namespace

PSL_API int psl_step_prelude(
    const float* T_override, const unsigned char* use_override,
    const float* T_cw, const float* velocity, const float* p3d_s,
    const float* p3d_e, const unsigned char* has_3d,
    const unsigned char* ln_valid, int L, const float* normals,
    const unsigned char* normals_valid, int Nn, const float* R_wm, int batch,
    float* T_last, float* T_pred, float* dirs, unsigned char* dirs_valid,
    float* R_init, cudaStream_t stream) {
  if (batch < 1 || L < 0 || Nn < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  step_prelude_kernel<<<batch, kThreads, 0, stream>>>(
      T_override, use_override, T_cw, velocity, p3d_s, p3d_e, has_3d,
      ln_valid, L, normals, normals_valid, Nn, R_wm, T_last, T_pred, dirs,
      dirs_valid, R_init);
  return static_cast<int>(cudaGetLastError());
}
