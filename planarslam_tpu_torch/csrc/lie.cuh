// Float32 SE(3) and plane helpers of the loop-correction kernels (K32-K34),
// each written as the port's PyTorch function computes it
// (planarslam_tpu_torch/geometry/se3.py, geometry/plane.py).
#pragma once

#include <math.h>

namespace psl {

__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

__device__ __forceinline__ void cross3(const float* a, const float* b,
                                       float* c) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}

// plane._safe_norm of a 3-vector
__device__ __forceinline__ float safe_norm3(const float* v) {
  return sqrtf(v[0] * v[0] + v[1] * v[1] + v[2] * v[2] + 1e-9f);
}

// se3.se3_exp(xi) @ T for row-major 4 x 4 matrices: Rodrigues with the
// Taylor branch below theta^2 = 1e-8 and the SO(3) left Jacobian for t
__device__ __forceinline__ void se3_exp_mul(const float* xi, const float* T,
                                            float* T_new) {
  const float* rho = xi;
  const float* phi = xi + 3;
  const float th2 = phi[0] * phi[0] + phi[1] * phi[1] + phi[2] * phi[2];
  const float th = sqrtf(th2 + 1e-8f);
  const float K[9] = {0.0f, -phi[2], phi[1], phi[2], 0.0f, -phi[0],
                      -phi[1], phi[0], 0.0f};
  float K2[9];
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) {
      K2[3 * i + j] = K[3 * i] * K[j] + K[3 * i + 1] * K[3 + j] +
                      K[3 * i + 2] * K[6 + j];
    }
  }
  const bool small = th2 < 1e-8f;
  const float th2c = fmaxf(th2, 1e-8f);
  const float s = sinf(th), co = cosf(th);
  const float a = small ? 1.0f - th2 / 6.0f : s / th;
  const float b = small ? 0.5f - th2 / 24.0f : (1.0f - co) / th2c;
  const float ja = small ? 0.5f - th2 / 24.0f : (1.0f - co) / th2c;
  const float jb = small ? 1.0f / 6.0f - th2 / 120.0f : (th - s) / (th2c * th);
  float E[16];
  for (int i = 0; i < 3; ++i) {
    float Jrow[3];
    for (int j = 0; j < 3; ++j) {
      const float eye = i == j ? 1.0f : 0.0f;
      E[4 * i + j] = eye + a * K[3 * i + j] + b * K2[3 * i + j];
      Jrow[j] = eye + ja * K[3 * i + j] + jb * K2[3 * i + j];
    }
    E[4 * i + 3] = Jrow[0] * rho[0] + Jrow[1] * rho[1] + Jrow[2] * rho[2];
  }
  E[12] = 0.0f;
  E[13] = 0.0f;
  E[14] = 0.0f;
  E[15] = 1.0f;
  for (int i = 0; i < 4; ++i) {
    for (int j = 0; j < 4; ++j) {
      T_new[4 * i + j] = E[4 * i] * T[j] + E[4 * i + 1] * T[4 + j] +
                         E[4 * i + 2] * T[8 + j] + E[4 * i + 3] * T[12 + j];
    }
  }
}

// plane.normalize: unit normal (safe norm), d >= 0
__device__ __forceinline__ void normalize_plane(const float* c, float* out) {
  const float nn = safe_norm3(c);
  for (int k = 0; k < 4; ++k) out[k] = c[k] / nn;
  if (out[3] < 0.0f) {
    for (int k = 0; k < 4; ++k) out[k] = -out[k];
  }
}

// plane.tangent_basis: b1 = n x seed / |n x seed|, b2 = n x b1, the seed the
// axis of the smallest |n_i| (ties to the lower axis)
__device__ __forceinline__ void tangent_basis(const float* n, float* b1,
                                              float* b2) {
  const float a0 = fabsf(n[0]), a1 = fabsf(n[1]), a2 = fabsf(n[2]);
  float s[3] = {0.0f, 0.0f, 0.0f};
  if (a0 <= a1 && a0 <= a2) {
    s[0] = 1.0f;
  } else if (a1 <= a2) {
    s[1] = 1.0f;
  } else {
    s[2] = 1.0f;
  }
  cross3(n, s, b1);
  const float nb = safe_norm3(b1);
  for (int k = 0; k < 3; ++k) b1[k] = b1[k] / nb;
  cross3(n, b1, b2);
}

// ba_core.plane_retract of one plane: base (n0, d0) moved by the chart
// coordinates theta; also returns the basis and |n| for the Jacobians
__device__ __forceinline__ void plane_retract(const float* base,
                                              const float* theta, float* pi,
                                              float* b1, float* b2,
                                              float* sn) {
  tangent_basis(base, b1, b2);
  float n[3];
  for (int k = 0; k < 3; ++k) {
    n[k] = base[k] + theta[0] * b1[k] + theta[1] * b2[k];
  }
  *sn = safe_norm3(n);
  for (int k = 0; k < 3; ++k) pi[k] = n[k] / *sn;
  pi[3] = base[3] + theta[2];
}

// plane.transform(T, pi): n' = R n, d' = d - n' . t
__device__ __forceinline__ void plane_transform(const float* T,
                                                const float* pi, float* c) {
  for (int i = 0; i < 3; ++i) {
    c[i] = T[4 * i] * pi[0] + T[4 * i + 1] * pi[1] + T[4 * i + 2] * pi[2];
  }
  c[3] = pi[3] - (c[0] * T[3] + c[1] * T[7] + c[2] * T[11]);
}

// The error of the camera-frame estimate c against the measurement pi_obs
// (plane.ominus, kind 0; ominus_par, 1; ominus_ver, 2): the normalized
// estimate e, the D rows of the error, and the vectors u[d] of the
// measurement each row dots the estimate's normal with (dist: the
// distance row of kind 0, which reads e[3]).
__device__ __forceinline__ int plane_error(int kind, const float* c,
                                           const float* pi_obs, float* e,
                                           float* r, float (*u)[3]) {
  const float nn = safe_norm3(c);
  for (int k = 0; k < 4; ++k) e[k] = c[k] / nn;
  const float sgn = e[3] < 0.0f ? -1.0f : 1.0f;
  for (int k = 0; k < 4; ++k) e[k] = e[k] * sgn;
  float m[4];
  normalize_plane(pi_obs, m);
  if (kind == 2) {
    for (int k = 0; k < 3; ++k) u[0][k] = m[k];
    r[0] = dot3(e, m);
    r[1] = 0.0f;
    return 2;
  }
  if (kind == 1 && dot3(m, e) < 0.0f) {  // _hemi_align to the estimate
    for (int k = 0; k < 4; ++k) m[k] = -m[k];
  }
  tangent_basis(m, u[0], u[1]);
  r[0] = dot3(u[0], e);
  r[1] = dot3(u[1], e);
  if (kind == 0) {
    r[2] = e[3] - m[3];
    return 3;
  }
  return 2;
}

}  // namespace psl
