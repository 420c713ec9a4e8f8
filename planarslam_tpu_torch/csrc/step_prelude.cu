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
// Design. A frame of a batch (every array carries a leading B) is a row
// of blocks (blockIdx.y), its work units spread over them a thread each:
// unit 0-31, warp 0 of the row's first block, forms T_last and the
// selected velocity in lanes 0-15, T_pred from them by shuffles, and
// R_init in lanes 0-8 from T_pred's rows by shuffles; then the normals'
// copy, as float4s and the validity as int4s where both strides and
// pointers allow (3 n_normals and n_normals + n_lines multiples of 16;
// else a normal a thread); then a line a thread. Every thread issues its
// loads before any store: one dependent round trip. What bounds it on an
// H100: launch latency and that round trip. It moves ~56 KB per frame (the
// 2048 normals in and out, 64 lines) and does ~1k operations: tens of
// nanoseconds at the card's rates.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPoseUnits = 32;   // warp 0 of a frame's first block
constexpr unsigned kFull = 0xffffffffu;

// a b + c rounded once to float32 (the product is exact in float64)
__device__ __forceinline__ float fma64(float a, float b, float c) {
  return __double2float_rn(__dadd_rn(__dmul_rn(a, b), c));
}

struct PreludeArgs {
  const float* T_override;
  const unsigned char* use_override;
  const float* T_cw;
  const float* velocity;
  const float* p3d_s;
  const float* p3d_e;
  const unsigned char* has_3d;
  const unsigned char* ln_valid;
  int L;
  const float* normals;
  const unsigned char* normals_valid;
  int Nn;
  const float* R_wm;
  float* T_last;
  float* T_pred;
  float* dirs;
  unsigned char* dirs_valid;
  float* R_init;
  int vec;  // the normals as float4 and their validity as int4
};

// Frame f's poses by one warp: lane i (mod 16) is entry (i / 4, i % 4).
__device__ __forceinline__ void prelude_poses(const PreludeArgs& a, size_t f,
                                              int lane) {
  const int i = lane & 15;
  const int r = i >> 2, c = i & 3;
  const int jw = lane < 9 ? lane % 3 : 0;  // R_init's column
  const int iw = lane < 9 ? lane / 3 : 0;  // its row
  const bool ovr = __ldg(a.use_override + f) != 0;
  const float t_over = __ldg(a.T_override + 16 * f + i);
  const float t_cw = __ldg(a.T_cw + 16 * f + i);
  const float t_vel = __ldg(a.velocity + 16 * f + i);
  const float* W = a.R_wm + 9 * f;
  const float w0 = __ldg(W + jw), w1 = __ldg(W + 3 + jw),
              w2 = __ldg(W + 6 + jw);
  const float tl = ovr ? t_over : t_cw;
  const float vel = ovr ? (r == c ? 1.0f : 0.0f) : t_vel;
  float v[4], t[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[k] = __shfl_sync(kFull, vel, 4 * r + k);   // vel[r][k]
    t[k] = __shfl_sync(kFull, tl, 4 * k + c);    // T_last[k][c]
  }
  const float p = fma64(v[1], t[1], v[0] * t[0]) +
                  fma64(v[3], t[3], v[2] * t[2]);
  float q[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) q[k] = __shfl_sync(kFull, p, 4 * iw + k);
  if (lane < 16) {
    a.T_pred[16 * f + i] = p;
    a.T_last[16 * f + i] = tl;
  }
  if (lane < 9) {
    a.R_init[9 * f + lane] = fma64(q[1], w1, q[0] * w0) + q[2] * w2;
  }
}

// Line u of frame f: its direction and validity at row Nn + u.
__device__ __forceinline__ void prelude_line(const PreludeArgs& a, size_t f,
                                             int u) {
  const size_t l = f * a.L + u;
  const float* s = a.p3d_s + 3 * l;
  const float* e = a.p3d_e + 3 * l;
  const float s0 = __ldg(s), s1 = __ldg(s + 1), s2 = __ldg(s + 2);
  const float e0 = __ldg(e), e1 = __ldg(e + 1), e2 = __ldg(e + 2);
  const bool lifted = __ldg(a.has_3d + l) != 0 && __ldg(a.ln_valid + l) != 0;
  const float v0 = e0 - s0, v1 = e1 - s1, v2 = e2 - s2;
  // A zero sum and zero numerators (an unlifted line's zero vector) skip
  // the IEEE square root's and division's slow paths: sqrt(+0) = +0, and
  // +-0 / den = +-0 for den >= 1e-9 or +inf (den is never negative).
  const float sq = (v0 * v0 + v2 * v2) + v1 * v1;
  const float len = sq == 0.0f ? 0.0f : __fsqrt_rn(sq);
  // torch.clamp(len, min=1e-9): NaN stays NaN
  const float den = len < 1e-9f ? 1e-9f : len;
  const bool num = den == den;
  const size_t row = f * (a.Nn + a.L) + a.Nn + u;
  float* d = a.dirs + 3 * row;
  d[0] = num && v0 == 0.0f ? v0 : __fdiv_rn(v0, den);
  d[1] = num && v1 == 0.0f ? v1 : __fdiv_rn(v1, den);
  d[2] = num && v2 == 0.0f ? v2 : __fdiv_rn(v2, den);
  a.dirs_valid[row] = (lifted && len > 0.1f) ? 1 : 0;
}

__global__ void __launch_bounds__(kThreads)
    step_prelude_kernel(const PreludeArgs a) {
  const size_t f = blockIdx.y;
  const int g = blockIdx.x * kThreads + threadIdx.x;
  if (g < kPoseUnits) {
    prelude_poses(a, f, g);
    return;
  }
  int u = g - kPoseUnits;
  const int Nn = a.Nn;
  const size_t N = static_cast<size_t>(Nn) + a.L;
  if (a.vec) {
    const int n4 = 3 * Nn / 4;   // float4s of the normals
    const int nv = Nn / 16;      // int4s of their validity
    if (u < n4) {
      const float4 x =
          __ldg(reinterpret_cast<const float4*>(a.normals) + f * n4 + u);
      reinterpret_cast<float4*>(a.dirs)[f * (3 * N / 4) + u] = x;
      return;
    }
    u -= n4;
    if (u < nv) {
      const int4 x = __ldg(
          reinterpret_cast<const int4*>(a.normals_valid) + f * nv + u);
      reinterpret_cast<int4*>(a.dirs_valid)[f * (N / 16) + u] = x;
      return;
    }
    u -= nv;
  } else {
    if (u < Nn) {
      const float* n = a.normals + 3 * (f * Nn + u);
      const float n0 = __ldg(n), n1 = __ldg(n + 1), n2 = __ldg(n + 2);
      const unsigned char ok = __ldg(a.normals_valid + f * Nn + u);
      float* d = a.dirs + 3 * (f * N + u);
      d[0] = n0;
      d[1] = n1;
      d[2] = n2;
      a.dirs_valid[f * N + u] = ok;
      return;
    }
    u -= Nn;
  }
  if (u < a.L) prelude_line(a, f, u);
}

bool aligned16(const void* p) {
  return reinterpret_cast<size_t>(p) % 16 == 0;
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
  if (batch < 1 || batch > 65535 || L < 0 || Nn < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec = Nn % 16 == 0 && (Nn + L) % 16 == 0 && aligned16(normals) &&
                   aligned16(dirs) && aligned16(normals_valid) &&
                   aligned16(dirs_valid);
  const long long units = kPoseUnits + L +
      (vec ? 3LL * Nn / 4 + Nn / 16 : static_cast<long long>(Nn));
  const PreludeArgs a{T_override, use_override, T_cw, velocity, p3d_s,
                      p3d_e, has_3d, ln_valid, L, normals, normals_valid, Nn,
                      R_wm, T_last, T_pred, dirs, dirs_valid, R_init,
                      vec ? 1 : 0};
  const dim3 grid(static_cast<unsigned>((units + kThreads - 1) / kThreads),
                  batch);
  step_prelude_kernel<<<grid, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}
