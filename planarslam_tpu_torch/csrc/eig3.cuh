// Closed-form eigendecomposition of a symmetric 3 x 3 matrix and the plane
// fit built on it, float32, one thread.
//
// Device copies of planarslam_tpu_torch/ops/eig3.py::eigh_sym3x3,
// ops/planes.py::_plane_from_moments and geometry/se3.py::orthonormalize,
// written operation by operation in the order of the PyTorch code (sums
// left to right, IEEE division and square root, acosf and cosf). The
// sources that include this header are compiled with -fmad=false, so a
// product and the sum after it round separately as two PyTorch ops do:
// the gates that read these values (block validity, coplanarity edges,
// candidate dedup, ghost merge) then flip only where the plain version's
// value sits on its threshold.
#pragma once

#include <math.h>

__device__ __forceinline__ void psl_cross3(const float* a, const float* b,
                                           float* o) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

__device__ __forceinline__ float psl_dot3(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// eig3.py::_unit_or
__device__ __forceinline__ void psl_unit_or(float* v, int axis) {
  const float nrm = sqrtf(psl_dot3(v, v));
  if (nrm > 1e-20f) {
    const float den = fmaxf(nrm, 1e-30f);
    v[0] = v[0] / den;
    v[1] = v[1] / den;
    v[2] = v[2] / den;
  } else {
    v[0] = axis == 0 ? 1.0f : 0.0f;
    v[1] = axis == 1 ? 1.0f : 0.0f;
    v[2] = axis == 2 ? 1.0f : 0.0f;
  }
}

// eig3.py::_eigenvector_for; A row-major symmetric
__device__ __forceinline__ void psl_eigenvector_for(const float* A, float lam,
                                                    float* v) {
  const float r0[3] = {A[0] - lam, A[1], A[2]};
  const float r1[3] = {A[3], A[4] - lam, A[5]};
  const float r2[3] = {A[6], A[7], A[8] - lam};
  float c01[3], c02[3], c12[3];
  psl_cross3(r0, r1, c01);
  psl_cross3(r0, r2, c02);
  psl_cross3(r1, r2, c12);
  const float n01 = psl_dot3(c01, c01);
  const float n02 = psl_dot3(c02, c02);
  const float n12 = psl_dot3(c12, c12);
  // the components picked by value, so that no array lives in memory
  const bool p01 = n01 >= n02 && n01 >= n12, p02 = n02 >= n12;
  for (int k = 0; k < 3; ++k) v[k] = p01 ? c01[k] : (p02 ? c02[k] : c12[k]);
  psl_unit_or(v, 2);
}

// eig3.py::eigh_sym3x3. A: row-major 3 x 3 (symmetrized here); evals
// ascending; V row-major with the eigenvectors as columns.
__device__ __forceinline__ void psl_eigh_sym3x3(const float* A_in,
                                                float* evals, float* V) {
  float A[9];
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) {
      A[3 * i + j] = 0.5f * (A_in[3 * i + j] + A_in[3 * j + i]);
    }
  }
  float amax = 0.0f;
  for (int i = 0; i < 9; ++i) amax = fmaxf(amax, fabsf(A[i]));
  const float scale = fmaxf(amax, 1e-30f);
  for (int i = 0; i < 9; ++i) A[i] = A[i] / scale;

  // _eigenvalues_sym3
  const float a00 = A[0], a11 = A[4], a22 = A[8];
  const float a01 = A[1], a02 = A[2], a12 = A[5];
  const float q = (a00 + a11 + a22) / 3.0f;
  const float b00 = a00 - q, b11 = a11 - q, b22 = a22 - q;
  const float p2 = b00 * b00 + b11 * b11 + b22 * b22 +
                   2.0f * (a01 * a01 + a02 * a02 + a12 * a12);
  const float p = sqrtf(fmaxf(p2 / 6.0f, 1e-30f));
  const float c00 = b00 / p, c11 = b11 / p, c22 = b22 / p;
  const float c01 = a01 / p, c02 = a02 / p, c12 = a12 / p;
  const float detBn = c00 * (c11 * c22 - c12 * c12) -
                      c01 * (c01 * c22 - c12 * c02) +
                      c02 * (c01 * c12 - c11 * c02);
  const float r = fminf(fmaxf(detBn / 2.0f, -1.0f), 1.0f);
  const float phi = acosf(r) / 3.0f;
  const float two_p = 2.0f * p;
  const float e_hi = q + two_p * cosf(phi);
  const float e_lo = q + two_p * cosf(phi + 2.0943951023931953f);
  const float e_mid = 3.0f * q - e_hi - e_lo;

  float v_lo[3], v_hi[3], v_mid[3];
  psl_eigenvector_for(A, e_lo, v_lo);
  psl_eigenvector_for(A, e_hi, v_hi);
  psl_cross3(v_hi, v_lo, v_mid);
  psl_unit_or(v_mid, 1);
  psl_cross3(v_mid, v_hi, v_lo);
  const float den = fmaxf(sqrtf(psl_dot3(v_lo, v_lo)), 1e-30f);
  for (int i = 0; i < 3; ++i) {
    V[3 * i + 0] = v_lo[i] / den;
    V[3 * i + 1] = v_mid[i];
    V[3 * i + 2] = v_hi[i];
  }
  evals[0] = e_lo * scale;
  evals[1] = e_mid * scale;
  evals[2] = e_hi * scale;
}

// planes.py::_plane_from_moments: the least-squares plane of the moment
// sums s1 (3), s2 (3 x 3 row-major) and the count n.
__device__ __forceinline__ void psl_plane_from_moments(
    const float* s1, const float* s2, float n, float* normal, float* d,
    float* mse, float* mean) {
  const float n_safe = fmaxf(n, 1.0f);
  for (int i = 0; i < 3; ++i) mean[i] = s1[i] / n_safe;
  float cov[9];
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) {
      cov[3 * i + j] = s2[3 * i + j] / n_safe - mean[i] * mean[j];
      if (i == j) cov[3 * i + j] = cov[3 * i + j] + 1e-12f;
    }
  }
  float evals[3], V[9];
  psl_eigh_sym3x3(cov, evals, V);
  normal[0] = V[0];
  normal[1] = V[3];
  normal[2] = V[6];
  *mse = evals[0];
  if (psl_dot3(normal, mean) > 0.0f) {
    normal[0] = -normal[0];
    normal[1] = -normal[1];
    normal[2] = -normal[2];
  }
  *d = -psl_dot3(normal, mean);
}

__device__ __forceinline__ float psl_det3_cols(const float* Q) {
  // se3.py::_det3: a0 . (a1 x a2) over the columns of row-major Q
  const float a0[3] = {Q[0], Q[3], Q[6]};
  const float a1[3] = {Q[1], Q[4], Q[7]};
  const float a2[3] = {Q[2], Q[5], Q[8]};
  float c[3];
  psl_cross3(a1, a2, c);
  return psl_dot3(a0, c);
}

// se3.py::_orthonormal_basis: V's columns (row-major V) made orthonormal
// where the eigensolver's are more than 1e-4 from it (R^T R near a multiple
// of I): the high column kept, the middle one the unit axis least aligned
// with it (the first among equals) made orthogonal to it, the low one
// their cross product.
__device__ __forceinline__ void psl_orthonormal_basis(float* V) {
  const float lo[3] = {V[0], V[3], V[6]};
  const float mid[3] = {V[1], V[4], V[7]};
  const float hi[3] = {V[2], V[5], V[8]};
  const float off = fmaxf(fmaxf(fabsf(psl_dot3(lo, mid)),
                                fabsf(psl_dot3(lo, hi))),
                          fabsf(psl_dot3(mid, hi)));
  if (!(off > 1e-4f)) return;
  const float a0 = fabsf(hi[0]), a1 = fabsf(hi[1]), a2 = fabsf(hi[2]);
  const int k = (a0 <= a1 && a0 <= a2) ? 0 : (a1 <= a2 ? 1 : 2);
  float m[3];
  for (int i = 0; i < 3; ++i) m[i] = (i == k ? 1.0f : 0.0f) - hi[k] * hi[i];
  const float nrm = fmaxf(sqrtf(psl_dot3(m, m)), 1e-30f);
  for (int i = 0; i < 3; ++i) m[i] = m[i] / nrm;
  float c[3];
  psl_cross3(m, hi, c);
  for (int i = 0; i < 3; ++i) {
    V[3 * i] = c[i];
    V[3 * i + 1] = m[i];
  }
}

// se3.py::orthonormalize: the polar factor R (R^T R)^-1/2 through the
// closed-form eigensolver (its eigenvectors made orthonormal,
// psl_orthonormal_basis), one Newton step, the smallest singular
// direction flipped when det R < 0. R, out: row-major 3 x 3.
__device__ __forceinline__ void psl_orthonormalize(const float* R,
                                                   float* out) {
  float M[9];
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) {
      M[3 * i + j] = R[i] * R[j] + R[3 + i] * R[3 + j] + R[6 + i] * R[6 + j];
    }
  }
  float evals[3], V[9];
  psl_eigh_sym3x3(M, evals, V);
  psl_orthonormal_basis(V);
  float inv_sqrt[3];
  for (int k = 0; k < 3; ++k) {
    inv_sqrt[k] = 1.0f / sqrtf(fmaxf(evals[k], 1e-30f));
  }
  float RV[9], Q[9];
  for (int i = 0; i < 3; ++i) {
    for (int k = 0; k < 3; ++k) {
      RV[3 * i + k] = R[3 * i] * (V[k] * inv_sqrt[k]) +
                      R[3 * i + 1] * (V[3 + k] * inv_sqrt[k]) +
                      R[3 * i + 2] * (V[6 + k] * inv_sqrt[k]);
    }
  }
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) {
      Q[3 * i + j] = RV[3 * i] * V[3 * j] + RV[3 * i + 1] * V[3 * j + 1] +
                     RV[3 * i + 2] * V[3 * j + 2];
    }
  }
  const float q0[3] = {Q[0], Q[3], Q[6]};
  const float q1[3] = {Q[1], Q[4], Q[7]};
  const float q2[3] = {Q[2], Q[5], Q[8]};
  float cof[3][3];  // cof[k] = column k of the cofactor matrix
  psl_cross3(q1, q2, cof[0]);
  psl_cross3(q2, q0, cof[1]);
  psl_cross3(q0, q1, cof[2]);
  const float det_q = psl_det3_cols(Q);
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) {
      Q[3 * i + j] = 0.5f * (Q[3 * i + j] + cof[j][i] / det_q);
    }
  }
  const float det_r = psl_det3_cols(R);
  const float s = det_r > 0.0f ? 1.0f : (det_r < 0.0f ? -1.0f : 0.0f);
  const float v[3] = {V[0], V[3], V[6]};
  const float one_minus_s = 1.0f - s;
  for (int i = 0; i < 3; ++i) {
    const float Qv = Q[3 * i] * v[0] + Q[3 * i + 1] * v[1] +
                     Q[3 * i + 2] * v[2];
    for (int j = 0; j < 3; ++j) {
      out[3 * i + j] = Q[3 * i + j] - one_minus_s * Qv * v[j];
    }
  }
}
