// Small dense linear algebra for one thread, in fp64: the one-sided
// (Hestenes) Jacobi SVD of an M x N matrix, its nullspace vector, and the
// rotation nearest to a 3 x 3 matrix (its polar factor with the
// determinant forced to +1).
//
// K5-K7 take a nullspace or an SVD where the JAX package calls
// jnp.linalg.svd on tiny matrices. One-sided Jacobi orthogonalizes the
// columns of A itself by plane rotations, so it needs no pivoting or
// workspace, runs in registers (N = 3, 4) or in the thread's local memory
// (12 x 12), and keeps the relative accuracy of small singular values: an
// eigen-decomposition of A^T A would square the condition number, which
// costs a near-rank-1 cross-covariance its second singular vector.
#pragma once

#include <math.h>

// a: M x N row-major, overwritten by A V (column j = s_j u_j); v: N x N,
// receives the right singular vectors as columns.
template <int M, int N>
__device__ __forceinline__ void psl_svd_jacobi(double* a, double* v) {
  for (int i = 0; i < N; ++i) {
    for (int j = 0; j < N; ++j) v[i * N + j] = (i == j) ? 1.0 : 0.0;
  }
  for (int sweep = 0; sweep < 40; ++sweep) {
    bool rotated = false;
    for (int p = 0; p < N - 1; ++p) {
      for (int q = p + 1; q < N; ++q) {
        double alpha = 0.0, beta = 0.0, gamma = 0.0;
        for (int k = 0; k < M; ++k) {
          const double ap = a[k * N + p], aq = a[k * N + q];
          alpha += ap * ap;
          beta += aq * aq;
          gamma += ap * aq;
        }
        if (gamma == 0.0 || fabs(gamma) <= 1e-15 * sqrt(alpha * beta)) {
          continue;
        }
        rotated = true;
        // rotation making columns p and q orthogonal: t is the smaller
        // root of t^2 + 2 zeta t - 1 = 0
        const double zeta = (beta - alpha) / (2.0 * gamma);
        const double t = (zeta >= 0.0 ? 1.0 : -1.0) /
                         (fabs(zeta) + sqrt(1.0 + zeta * zeta));
        const double c = 1.0 / sqrt(1.0 + t * t);
        const double s = c * t;
        for (int k = 0; k < M; ++k) {
          const double ap = a[k * N + p], aq = a[k * N + q];
          a[k * N + p] = c * ap - s * aq;
          a[k * N + q] = s * ap + c * aq;
        }
        for (int k = 0; k < N; ++k) {
          const double vp = v[k * N + p], vq = v[k * N + q];
          v[k * N + p] = c * vp - s * vq;
          v[k * N + q] = s * vp + c * vq;
        }
      }
    }
    if (!rotated) break;
  }
}

// Squared norm of column j of an M x N row-major matrix.
template <int M, int N>
__device__ __forceinline__ double psl_col_norm2(const double* a, int j) {
  double acc = 0.0;
  for (int k = 0; k < M; ++k) acc += a[k * N + j] * a[k * N + j];
  return acc;
}

// The right singular vector of the smallest singular value of a (M x N,
// M >= N, overwritten): the nullspace direction of a DLT system. Ties go
// to the lower index.
template <int M, int N>
__device__ __forceinline__ void psl_null_vector(double* a, double* v,
                                                double* out) {
  psl_svd_jacobi<M, N>(a, v);
  int best = 0;
  double best_n = psl_col_norm2<M, N>(a, 0);
  for (int j = 1; j < N; ++j) {
    const double n2 = psl_col_norm2<M, N>(a, j);
    if (n2 < best_n) {
      best_n = n2;
      best = j;
    }
  }
  for (int k = 0; k < N; ++k) out[k] = v[k * N + best];
}

__device__ __forceinline__ void psl_cross(const double* a, const double* b,
                                          double* out) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

// The rotation R = U diag(1, 1, det(U V^T)) V^T of the SVD m = U S V^T
// (row-major 3 x 3): the proper rotation that maximizes tr(R^T m). u_i and
// v_i of the two largest singular values come from the Jacobi SVD; the
// third columns are the cross products u1 x u2 and v1 x v2, which folds
// the determinant sign in. For rank(m) >= 2 this R is unique, whatever sign
// or order convention an SVD routine uses, so it equals the JAX package's.
// sv receives the singular values (descending).
__device__ __forceinline__ void psl_nearest_rotation(const double* m,
                                                     double* r, double* sv) {
  double a[9], v[9];
  for (int i = 0; i < 9; ++i) a[i] = m[i];
  psl_svd_jacobi<3, 3>(a, v);
  double s[3];
  for (int j = 0; j < 3; ++j) s[j] = sqrt(psl_col_norm2<3, 3>(a, j));
  int order[3] = {0, 1, 2};
  for (int i = 0; i < 2; ++i) {  // sort descending, stable
    for (int j = 0; j < 2 - i; ++j) {
      if (s[order[j]] < s[order[j + 1]]) {
        const int tmp = order[j];
        order[j] = order[j + 1];
        order[j + 1] = tmp;
      }
    }
  }
  double uu[3][3], vv[3][3];
  for (int c = 0; c < 3; ++c) {
    sv[c] = s[order[c]];
    for (int k = 0; k < 3; ++k) {
      vv[c][k] = v[k * 3 + order[c]];
      uu[c][k] = a[k * 3 + order[c]];
    }
  }
  if (!(sv[0] > 1e-300)) {  // m == 0: the identity, as an SVD of 0 gives
    for (int i = 0; i < 9; ++i) r[i] = (i % 4 == 0) ? 1.0 : 0.0;
    return;
  }
  for (int k = 0; k < 3; ++k) uu[0][k] /= sv[0];
  // u2: Gram-Schmidt against u1 (A V has orthogonal columns up to rounding)
  const double d01 =
      uu[0][0] * uu[1][0] + uu[0][1] * uu[1][1] + uu[0][2] * uu[1][2];
  for (int k = 0; k < 3; ++k) uu[1][k] -= d01 * uu[0][k];
  double n2 = sqrt(uu[1][0] * uu[1][0] + uu[1][1] * uu[1][1] +
                   uu[1][2] * uu[1][2]);
  if (!(n2 > 1e-300)) {  // rank 1: any unit vector orthogonal to u1
    const double e[3] = {fabs(uu[0][0]) < 0.9 ? 1.0 : 0.0,
                         fabs(uu[0][0]) < 0.9 ? 0.0 : 1.0, 0.0};
    psl_cross(uu[0], e, uu[1]);
    n2 = sqrt(uu[1][0] * uu[1][0] + uu[1][1] * uu[1][1] +
              uu[1][2] * uu[1][2]);
  }
  for (int k = 0; k < 3; ++k) uu[1][k] /= n2;
  psl_cross(uu[0], uu[1], uu[2]);
  psl_cross(vv[0], vv[1], vv[2]);
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) {
      r[i * 3 + j] =
          uu[0][i] * vv[0][j] + uu[1][i] * vv[1][j] + uu[2][i] * vv[2][j];
    }
  }
}
