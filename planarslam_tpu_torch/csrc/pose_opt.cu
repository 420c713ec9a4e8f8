// K11 pose_optimize — one call of the robust pose-only solver: n_rounds x
// n_iters Levenberg-Marquardt steps over the point, line-endpoint, plane,
// parallel-plane and vertical-plane residuals, in one launch of one block.
//
// Replaces planarslam_tpu/solvers/pose_opt.py::pose_optimize :163-301
// (jax.jacfwd of the stacked residuals, lax.scan over the LM steps, the 6x6
// solve, the chi2 gates). The arithmetic follows the plain version,
// planarslam_tpu_torch/solvers/pose_opt.py::_pose_optimize_plain, line by
// line: float32 residuals and their closed-form Jacobians (the left-update
// derivative at xi = 0, with the same z guards: |z| >= 1e-8 in the
// projection and its derivative, max(z, 1e-6) in the stereo term), Huber
// weights from the residuals at the step's pose (off in the last round),
// the rotation columns of J zeroed when rotation_fixed is set,
// H_lm = H + lam diag(H) + 1e-9 I, dx = -H_lm^-1 g, T_new = se3_exp(dx) T,
// accepted when the chi2 at T_new, with the weights of T, is below the
// chi2 at T and dx is finite; lam halves or quadruples within [1e-8, 1e6].
// Every round restarts from T_init; the chi2 gates at the round's pose
// refresh the five inlier masks.
//
// Design. The call is a chain of 40 dependent steps over ~3.3k rows, so it
// is bound by latency, not by bytes or operations: one block of 512
// threads per problem loops over the rounds and steps (a batch of B
// independent problems, every array with a leading B, is one launch of B
// blocks, block b reading problem b at its lane strides), and between them nothing leaves
// the SM except each item's row weights (global scratch, written and read
// back by the same thread) and its inlier flag (the output mask, likewise).
// An item is a point (3 rows, the third zero for mono), a line (its two
// endpoint rows) or a plane (3 rows direct, 2 parallel or vertical);
// thread t owns items t, t + 512, ... in every pass. Each thread sums its
// rows' 21 upper-triangle entries of J^T W J, the 6 of J^T W r and the
// weighted chi2 in float32 (as the plain version's float32 product does);
// one block reduction in float64 in a fixed order (a warp shuffle tree,
// then the 16 warp sums by a second tree) gives the same bits on every
// launch, with no atomics. Thread 0 solves the 6x6 system in float64 by
// LU with partial pivoting (the plain version: torch.linalg.solve_ex,
// float32 LU with partial pivoting) and forms T_new in float32.
// What bounds it on an H100: the latency of the step chain (a pass over
// the items, two block reductions and one serial 6x6 solve per step); its
// bytes (~60 KB at the main path's shapes) and operations (~15 MFLOP)
// would take well under a microsecond at the card's rates.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 28;  // upper triangle of H (21), g (6), chi2
constexpr float kChi2Mono = 5.991f;
constexpr float kChi2Stereo = 7.815f;
constexpr float kChi2Line = 11.982f;  // 2 x 5.991 per endpoint

enum Kind { kPoint = 0, kLine = 1, kPlane = 2, kPar = 3, kVer = 4 };

struct PlaneBlock {
  const float* pi_w;   // (n, 4) map plane, world frame
  const float* pi_obs; // (n, 4) observed plane, camera frame
  const unsigned char* valid;
  unsigned char* in;   // inlier flags between rounds; valid & in at the end
  int n;
};

struct Params {
  const float* T_init;  // (4, 4)
  const float* pt_xw;   // (N, 3)
  const float* pt_uv;   // (N, 2)
  const float* pt_ur;   // (N,) pseudo-stereo u, -1 = mono
  const float* pt_is2;  // (N,)
  const unsigned char* pt_valid;
  unsigned char* pt_in;
  int n_pt;
  const float* ln_s;    // (L, 3)
  const float* ln_e;    // (L, 3)
  const float* ln_l2d;  // (L, 3)
  const float* ln_is2;  // (L,)
  const unsigned char* ln_valid;
  unsigned char* ln_in;
  int n_ln;
  PlaneBlock pl[3];     // direct, parallel, vertical
  const unsigned char* rot_flag;  // device bool, or NULL: rot_fixed_host
  int rot_fixed_host;
  float fx, fy, cx, cy, bf;
  float angle_info, dis_info, par_info, ver_info, plane_chi, vp_chi;
  int n_rounds, n_iters;
  float* w_scr;         // 3 row weights per item
  float* T_out;         // (4, 4)
  long long* n_in;
  float* chi2;
};

// Residual rows of one item at a pose, their Jacobian rows, and the chi2
// values its gate and Huber weights read (a line has one per endpoint).
struct Rows {
  int n;
  float r[3];
  float J[3][6];
  float chi[2];
};

__device__ __forceinline__ void transform_pt(const float* T, const float* x,
                                             float* p) {
  for (int i = 0; i < 3; ++i) {
    p[i] = x[0] * T[4 * i] + x[1] * T[4 * i + 1] + x[2] * T[4 * i + 2] +
           T[4 * i + 3];
  }
}

// se3.project
__device__ __forceinline__ void project(const Params& P, const float* p,
                                        float& u, float& v) {
  const float z = p[2];
  const float inv_z = 1.0f / (fabsf(z) < 1e-8f ? 1e-8f : z);
  u = P.fx * p[0] * inv_z + P.cx;
  v = P.fy * p[1] * inv_z + P.cy;
}

// _point_jac: du/dxi and dv/dxi = d(u, v)/dp [I | -hat(p)]
__device__ __forceinline__ void point_jac(const Params& P, const float* p,
                                          float* du, float* dv) {
  const float z = p[2];
  const bool big = fabsf(z) >= 1e-8f;
  const float inv_z = 1.0f / (big ? z : 1e-8f);
  const float dinv = big ? -inv_z * inv_z : 0.0f;
  const float a = P.fx * inv_z, b = P.fx * p[0] * dinv;  // du/dp = [a 0 b]
  const float e = P.fy * inv_z, f = P.fy * p[1] * dinv;  // dv/dp = [0 e f]
  du[0] = a;
  du[1] = 0.0f;
  du[2] = b;
  du[3] = b * p[1];
  du[4] = a * p[2] - b * p[0];
  du[5] = -a * p[1];
  dv[0] = 0.0f;
  dv[1] = e;
  dv[2] = f;
  dv[3] = -e * p[2] + f * p[1];
  dv[4] = -f * p[0];
  dv[5] = e * p[0];
}

__device__ __forceinline__ void point_rows(const Params& P, const float* T,
                                           int i, bool jac, Rows& o) {
  const float x[3] = {P.pt_xw[3 * i], P.pt_xw[3 * i + 1], P.pt_xw[3 * i + 2]};
  float p[3];
  transform_pt(T, x, p);
  float u, v;
  project(P, p, u, v);
  const float zc = fmaxf(p[2], 1e-6f);
  const float ur = P.pt_ur[i];
  const bool stereo = ur >= 0.0f;
  o.n = 3;
  o.r[0] = P.pt_uv[2 * i] - u;
  o.r[1] = P.pt_uv[2 * i + 1] - v;
  o.r[2] = stereo ? ur - (u - P.bf / zc) : 0.0f;
  o.chi[0] = (o.r[0] * o.r[0] + o.r[1] * o.r[1] + o.r[2] * o.r[2]) *
             P.pt_is2[i];
  if (!jac) return;
  float du[6], dv[6];
  point_jac(P, p, du, dv);
  // d(bf / z)/dxi = -bf / z^2 [0 0 1 p1 -p0 0]; ur_hat = u - bf / z
  const float dz_inv = p[2] > 1e-6f ? P.bf / (zc * zc) : 0.0f;
  const float dz[6] = {0.0f, 0.0f, 1.0f, p[1], -p[0], 0.0f};
  for (int k = 0; k < 6; ++k) {
    o.J[0][k] = -du[k];
    o.J[1][k] = -dv[k];
    o.J[2][k] = stereo ? -(du[k] + dz_inv * dz[k]) : 0.0f;
  }
}

__device__ __forceinline__ void line_rows(const Params& P, const float* T,
                                          int l, bool jac, Rows& o) {
  const float* l2 = P.ln_l2d + 3 * l;
  o.n = 2;
  for (int e = 0; e < 2; ++e) {
    const float* xw = (e == 0 ? P.ln_s : P.ln_e) + 3 * l;
    const float x[3] = {xw[0], xw[1], xw[2]};
    float p[3];
    transform_pt(T, x, p);
    float u, v;
    project(P, p, u, v);
    o.r[e] = l2[0] * u + l2[1] * v + l2[2];
    o.chi[e] = o.r[e] * o.r[e] * P.ln_is2[l];
    if (jac) {
      float du[6], dv[6];
      point_jac(P, p, du, dv);
      for (int k = 0; k < 6; ++k) o.J[e][k] = l2[0] * du[k] + l2[1] * dv[k];
    }
  }
}

__device__ __forceinline__ void cross3(const float* a, const float* b,
                                       float* c) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}

__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// plane.normalize: unit normal, d >= 0
__device__ __forceinline__ void normalize_plane(const float* c, float* out) {
  const float nn = sqrtf(c[0] * c[0] + c[1] * c[1] + c[2] * c[2] + 1e-9f);
  for (int k = 0; k < 4; ++k) out[k] = c[k] / nn;
  if (out[3] < 0.0f) {
    for (int k = 0; k < 4; ++k) out[k] = -out[k];
  }
}

// plane.tangent_basis
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
  const float nb = sqrtf(dot3(b1, b1) + 1e-9f);
  for (int k = 0; k < 3; ++k) b1[k] = b1[k] / nb;
  cross3(n, b1, b2);
}

// ominus / ominus_par / ominus_ver of transform(T, pi_w) against pi_obs,
// and (jac) the stacked rows of _residuals_and_jacobian
__device__ __forceinline__ void plane_rows(const Params& P, const float* T,
                                           int kind, int j, bool jac,
                                           Rows& o) {
  const PlaneBlock& B = P.pl[kind - kPlane];
  const float* w = B.pi_w + 4 * j;
  float c[4];
  for (int i = 0; i < 3; ++i) {
    c[i] = T[4 * i] * w[0] + T[4 * i + 1] * w[1] + T[4 * i + 2] * w[2];
  }
  c[3] = w[3] - (c[0] * T[3] + c[1] * T[7] + c[2] * T[11]);
  // estimate: normalize(c); its derivative is sgn dc / nn, since
  // n . dn = n . (n x e_k) = 0 for the rotation columns of dc
  const float nn = sqrtf(c[0] * c[0] + c[1] * c[1] + c[2] * c[2] + 1e-9f);
  float e[4];
  for (int k = 0; k < 4; ++k) e[k] = c[k] / nn;
  const float sgn = e[3] < 0.0f ? -1.0f : 1.0f;
  for (int k = 0; k < 4; ++k) e[k] = e[k] * sgn;
  float m[4];
  normalize_plane(B.pi_obs + 4 * j, m);
  if (kind == kPar && dot3(m, e) < 0.0f) {  // _hemi_align to the estimate
    for (int k = 0; k < 4; ++k) m[k] = -m[k];
  }
  float b1[3], b2[3];
  if (kind != kVer) tangent_basis(m, b1, b2);
  if (kind == kPlane) {
    o.n = 3;
    o.r[0] = dot3(b1, e);
    o.r[1] = dot3(b2, e);
    o.r[2] = e[3] - m[3];
    o.chi[0] = P.angle_info * (o.r[0] * o.r[0] + o.r[1] * o.r[1]) +
               P.dis_info * (o.r[2] * o.r[2]);
  } else if (kind == kPar) {
    o.n = 2;
    o.r[0] = dot3(b1, e);
    o.r[1] = dot3(b2, e);
    o.chi[0] = P.par_info * (o.r[0] * o.r[0] + o.r[1] * o.r[1]);
  } else {
    o.n = 2;
    o.r[0] = dot3(e, m);
    o.r[1] = 0.0f;
    o.chi[0] = P.ver_info * (o.r[0] * o.r[0] + o.r[1] * o.r[1]);
  }
  if (!jac) return;
  // dc = [[0 | -hat(n)], [-n | 0]] (4 x 6) for n = c[:3]; de = sgn dc / nn
  const float dn[3][6] = {
      {0.0f, 0.0f, 0.0f, 0.0f, c[2], -c[1]},
      {0.0f, 0.0f, 0.0f, -c[2], 0.0f, c[0]},
      {0.0f, 0.0f, 0.0f, c[1], -c[0], 0.0f}};
  const float dd[6] = {-c[0], -c[1], -c[2], 0.0f, 0.0f, 0.0f};
  for (int k = 0; k < 6; ++k) {
    const float d0 = dn[0][k] / nn * sgn, d1 = dn[1][k] / nn * sgn,
                d2 = dn[2][k] / nn * sgn;
    if (kind == kVer) {
      o.J[0][k] = m[0] * d0 + m[1] * d1 + m[2] * d2;
      o.J[1][k] = 0.0f;
    } else {
      o.J[0][k] = b1[0] * d0 + b1[1] * d1 + b1[2] * d2;
      o.J[1][k] = b2[0] * d0 + b2[1] * d1 + b2[2] * d2;
      if (kind == kPlane) o.J[2][k] = dd[k] / nn * sgn;
    }
  }
}

__device__ __forceinline__ void locate(const Params& P, int it, int& kind,
                                       int& j) {
  if (it < P.n_pt) {
    kind = kPoint;
    j = it;
    return;
  }
  it -= P.n_pt;
  if (it < P.n_ln) {
    kind = kLine;
    j = it;
    return;
  }
  it -= P.n_ln;
  for (int q = 0; q < 2; ++q) {
    if (it < P.pl[q].n) {
      kind = kPlane + q;
      j = it;
      return;
    }
    it -= P.pl[q].n;
  }
  kind = kVer;
  j = it;
}

__device__ __forceinline__ void item_rows(const Params& P, const float* T,
                                          int kind, int j, bool jac,
                                          Rows& o) {
  if (kind == kPoint) {
    point_rows(P, T, j, jac, o);
  } else if (kind == kLine) {
    line_rows(P, T, j, jac, o);
  } else {
    plane_rows(P, T, kind, j, jac, o);
  }
}

__device__ __forceinline__ unsigned char* in_flag(const Params& P, int kind,
                                                  int j) {
  if (kind == kPoint) return P.pt_in + j;
  if (kind == kLine) return P.ln_in + j;
  return P.pl[kind - kPlane].in + j;
}

__device__ __forceinline__ bool valid_of(const Params& P, int kind, int j) {
  if (kind == kPoint) return P.pt_valid[j] != 0;
  if (kind == kLine) return P.ln_valid[j] != 0;
  return P.pl[kind - kPlane].valid[j] != 0;
}

// _huber_w
__device__ __forceinline__ float huber_w(float chi2, float delta2, bool on) {
  if (!on || !(chi2 > delta2)) return 1.0f;
  return sqrtf(delta2 / fmaxf(chi2, 1e-12f));
}

// weights_at: the row weights of one item at its residuals
__device__ __forceinline__ void item_weights(const Params& P, int kind,
                                             int j, const Rows& o,
                                             bool huber_on, float* w) {
  const float mask = (valid_of(P, kind, j) && *in_flag(P, kind, j)) ? 1.0f
                                                                     : 0.0f;
  if (kind == kPoint) {
    const bool stereo = P.pt_ur[j] >= 0.0f;
    const float gate = stereo ? kChi2Stereo : kChi2Mono;
    const float base = P.pt_is2[j] * huber_w(o.chi[0], gate, huber_on) * mask;
    w[0] = base;
    w[1] = base;
    w[2] = base * (stereo ? 1.0f : 0.0f);
  } else if (kind == kLine) {
    for (int e = 0; e < 2; ++e) {
      w[e] = P.ln_is2[j] * huber_w(o.chi[e], kChi2Mono, huber_on) * mask;
    }
  } else if (kind == kPlane) {
    const float s = huber_w(o.chi[0], P.plane_chi, huber_on) * mask;
    w[0] = s * P.angle_info;
    w[1] = s * P.angle_info;
    w[2] = s * P.dis_info;
  } else {
    const float info = kind == kPar ? P.par_info : P.ver_info;
    const float s = info * huber_w(o.chi[0], P.vp_chi, huber_on) * mask;
    w[0] = s;
    w[1] = s;
  }
}

// the chi2 gates after a round
__device__ __forceinline__ bool item_gate(const Params& P, int kind, int j,
                                          const Rows& o) {
  if (kind == kPoint) {
    return o.chi[0] <= (P.pt_ur[j] >= 0.0f ? kChi2Stereo : kChi2Mono);
  }
  if (kind == kLine) return o.chi[0] <= kChi2Line && o.chi[1] <= kChi2Line;
  if (kind == kPlane) return o.chi[0] <= P.plane_chi;
  return o.chi[0] <= P.vp_chi;
}

// Sum NV values over the block in a fixed order: a shuffle tree in each
// warp, then a shuffle tree over the warp sums in warp 0. out[] holds the
// sums for every thread after the call.
template <int NV>
__device__ __forceinline__ void block_sum(const float* v, double* warp_buf,
                                          double* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    double x = static_cast<double>(v[k]);
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

// dx = -H_lm^-1 g, float64 LU with partial pivoting; a zero pivot gives a
// non-finite dx, which the step rejects
__device__ void solve_step(const double* sums, float lam, bool rot_fixed,
                           float* dx) {
  double A[6][7];
  int k = 0;
  for (int a = 0; a < 6; ++a) {
    for (int b = a; b < 6; ++b, ++k) {
      const bool keep = !rot_fixed || (a < 3 && b < 3);
      A[a][b] = keep ? sums[k] : 0.0;
      A[b][a] = A[a][b];
    }
  }
  for (int a = 0; a < 6; ++a) {
    A[a][a] += static_cast<double>(lam) * A[a][a] + 1e-9;
    A[a][6] = (!rot_fixed || a < 3) ? sums[21 + a] : 0.0;
  }
  for (int c = 0; c < 6; ++c) {
    int piv = c;
    for (int r = c + 1; r < 6; ++r) {
      if (fabs(A[r][c]) > fabs(A[piv][c])) piv = r;
    }
    if (piv != c) {
      for (int q = 0; q < 7; ++q) {
        const double tmp = A[c][q];
        A[c][q] = A[piv][q];
        A[piv][q] = tmp;
      }
    }
    for (int r = c + 1; r < 6; ++r) {
      const double f = A[r][c] / A[c][c];
      for (int q = c; q < 7; ++q) A[r][q] -= f * A[c][q];
    }
  }
  double x[6];
  for (int a = 5; a >= 0; --a) {
    double s = A[a][6];
    for (int q = a + 1; q < 6; ++q) s -= A[a][q] * x[q];
    x[a] = s / A[a][a];
  }
  for (int a = 0; a < 6; ++a) dx[a] = -static_cast<float>(x[a]);
}

// T_new = se3.se3_exp(xi) @ T, float32 (rows of 4x4 row-major matrices)
__device__ void se3_exp_mul(const float* xi, const float* T, float* T_new) {
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

// Params of problem `lane` of a batch: every array advanced by the lane's
// stride (its row count times its width).
__device__ __forceinline__ Params at_lane(Params P, int lane) {
  const size_t b = lane;
  const size_t n_items =
      P.n_pt + P.n_ln + P.pl[0].n + P.pl[1].n + P.pl[2].n;
  P.T_init += 16 * b;
  P.pt_xw += 3 * b * P.n_pt;
  P.pt_uv += 2 * b * P.n_pt;
  P.pt_ur += b * P.n_pt;
  P.pt_is2 += b * P.n_pt;
  P.pt_valid += b * P.n_pt;
  P.pt_in += b * P.n_pt;
  P.ln_s += 3 * b * P.n_ln;
  P.ln_e += 3 * b * P.n_ln;
  P.ln_l2d += 3 * b * P.n_ln;
  P.ln_is2 += b * P.n_ln;
  P.ln_valid += b * P.n_ln;
  P.ln_in += b * P.n_ln;
  for (int q = 0; q < 3; ++q) {
    P.pl[q].pi_w += 4 * b * P.pl[q].n;
    P.pl[q].pi_obs += 4 * b * P.pl[q].n;
    P.pl[q].valid += b * P.pl[q].n;
    P.pl[q].in += b * P.pl[q].n;
  }
  if (P.rot_flag != nullptr) P.rot_flag += b;
  P.w_scr += 3 * b * n_items;
  P.T_out += 16 * b;
  P.n_in += b;
  P.chi2 += b;
  return P;
}

__global__ void __launch_bounds__(kThreads, 1)
    pose_opt_kernel(const Params P_batch) {
  const Params P = at_lane(P_batch, blockIdx.x);
  __shared__ float T0[16], T[16], T_new[16];
  __shared__ double warp_buf[kWarps * kSums];
  __shared__ double sums[kSums];
  __shared__ double sum1[1];
  const int tid = threadIdx.x;
  const int n_items = P.n_pt + P.n_ln + P.pl[0].n + P.pl[1].n + P.pl[2].n;
  const bool rot_fixed =
      P.rot_flag != nullptr ? *P.rot_flag != 0 : P.rot_fixed_host != 0;
  if (tid < 16) {
    T0[tid] = P.T_init[tid];
    T[tid] = T0[tid];
  }
  for (int it = tid; it < n_items; it += kThreads) {
    int kind, j;
    locate(P, it, kind, j);
    *in_flag(P, kind, j) = 1;
  }
  float chi_total = 0.0f;  // thread 0's
  __syncthreads();

  for (int rnd = 0; rnd < P.n_rounds; ++rnd) {
    const bool huber_on = rnd < P.n_rounds - 1;
    if (tid < 16) T[tid] = T0[tid];
    float lam = 1e-4f, chi_cur = INFINITY;  // thread 0's
    __syncthreads();
    for (int step = 0; step < P.n_iters; ++step) {
      // pass 1 at T: rows, Jacobians, weights; J^T W J, J^T W r, chi2
      float Tr[12];
      for (int k = 0; k < 12; ++k) Tr[k] = T[k];
      float acc[kSums];
      for (int k = 0; k < kSums; ++k) acc[k] = 0.0f;
#pragma unroll 1
      for (int it = tid; it < n_items; it += kThreads) {
        int kind, j;
        locate(P, it, kind, j);
        Rows o;
        item_rows(P, Tr, kind, j, true, o);
        float w[3];
        item_weights(P, kind, j, o, huber_on, w);
        for (int r = 0; r < o.n; ++r) {
          P.w_scr[3 * it + r] = w[r];
          float wj[6];
          for (int a = 0; a < 6; ++a) wj[a] = o.J[r][a] * w[r];
          int k = 0;
          for (int a = 0; a < 6; ++a) {
            for (int b = a; b < 6; ++b, ++k) acc[k] += wj[a] * o.J[r][b];
          }
          for (int a = 0; a < 6; ++a) acc[21 + a] += wj[a] * o.r[r];
          acc[27] += w[r] * o.r[r] * o.r[r];
        }
      }
      block_sum<kSums>(acc, warp_buf, sums);
      float chi_old = 0.0f;
      bool finite = false;
      if (tid == 0) {
        chi_old = static_cast<float>(sums[27]);
        float dx[6];
        solve_step(sums, lam, rot_fixed, dx);
        finite = true;
        for (int a = 0; a < 6; ++a) finite = finite && isfinite(dx[a]);
        se3_exp_mul(dx, T, T_new);
      }
      __syncthreads();
      // pass 2 at T_new with the weights of T
      for (int k = 0; k < 12; ++k) Tr[k] = T_new[k];
      float chi_new_part = 0.0f;
#pragma unroll 1
      for (int it = tid; it < n_items; it += kThreads) {
        int kind, j;
        locate(P, it, kind, j);
        Rows o;
        item_rows(P, Tr, kind, j, false, o);
        for (int r = 0; r < o.n; ++r) {
          chi_new_part += P.w_scr[3 * it + r] * o.r[r] * o.r[r];
        }
      }
      block_sum<1>(&chi_new_part, warp_buf, sum1);
      if (tid == 0) {
        const float chi_new = static_cast<float>(sum1[0]);
        const bool accept = chi_new < chi_old && finite;
        if (accept) {
          for (int k = 0; k < 16; ++k) T[k] = T_new[k];
        }
        lam = fminf(fmaxf(accept ? lam * 0.5f : lam * 4.0f, 1e-8f), 1e6f);
        chi_cur = accept ? chi_new : chi_old;
      }
      __syncthreads();
    }
    if (tid == 0) chi_total = chi_cur;
    // chi2 gates at the round's pose refresh the inlier flags
    float Tr[12];
    for (int k = 0; k < 12; ++k) Tr[k] = T[k];
#pragma unroll 1
    for (int it = tid; it < n_items; it += kThreads) {
      int kind, j;
      locate(P, it, kind, j);
      Rows o;
      item_rows(P, Tr, kind, j, false, o);
      *in_flag(P, kind, j) = item_gate(P, kind, j, o) ? 1 : 0;
    }
    __syncthreads();
  }

  float n_in = 0.0f;
  for (int it = tid; it < n_items; it += kThreads) {
    int kind, j;
    locate(P, it, kind, j);
    unsigned char* f = in_flag(P, kind, j);
    *f = (*f && valid_of(P, kind, j)) ? 1 : 0;
    if (kind == kPoint && *f) n_in += 1.0f;
  }
  block_sum<1>(&n_in, warp_buf, sum1);
  if (tid < 16) P.T_out[tid] = T[tid];
  if (tid == 0) {
    *P.n_in = static_cast<long long>(sum1[0]);
    *P.chi2 = chi_total;
  }
}

}  // namespace

PSL_API int psl_pose_optimize(
    const float* T_init, const float* pt_xw, const float* pt_uv,
    const float* pt_ur, const float* pt_is2, const unsigned char* pt_valid,
    int n_pt, const float* ln_s, const float* ln_e, const float* ln_l2d,
    const float* ln_is2, const unsigned char* ln_valid, int n_ln,
    const float* pl_w, const float* pl_obs, const unsigned char* pl_valid,
    int n_pl, const float* par_w, const float* par_obs,
    const unsigned char* par_valid, int n_par, const float* ver_w,
    const float* ver_obs, const unsigned char* ver_valid, int n_ver,
    const unsigned char* rot_flag, int rot_fixed, float fx, float fy,
    float cx, float cy, float bf, float angle_info, float dis_info,
    float par_info, float ver_info, float plane_chi, float vp_chi,
    int n_rounds, int n_iters, int batch, float* w_scr, float* T_out,
    unsigned char* pt_in, unsigned char* ln_in, unsigned char* pl_in,
    unsigned char* par_in, unsigned char* ver_in, long long* n_in,
    float* chi2, cudaStream_t stream) {
  Params P;
  P.T_init = T_init;
  P.pt_xw = pt_xw;
  P.pt_uv = pt_uv;
  P.pt_ur = pt_ur;
  P.pt_is2 = pt_is2;
  P.pt_valid = pt_valid;
  P.pt_in = pt_in;
  P.n_pt = n_pt;
  P.ln_s = ln_s;
  P.ln_e = ln_e;
  P.ln_l2d = ln_l2d;
  P.ln_is2 = ln_is2;
  P.ln_valid = ln_valid;
  P.ln_in = ln_in;
  P.n_ln = n_ln;
  P.pl[0] = PlaneBlock{pl_w, pl_obs, pl_valid, pl_in, n_pl};
  P.pl[1] = PlaneBlock{par_w, par_obs, par_valid, par_in, n_par};
  P.pl[2] = PlaneBlock{ver_w, ver_obs, ver_valid, ver_in, n_ver};
  P.rot_flag = rot_flag;
  P.rot_fixed_host = rot_fixed;
  P.fx = fx;
  P.fy = fy;
  P.cx = cx;
  P.cy = cy;
  P.bf = bf;
  P.angle_info = angle_info;
  P.dis_info = dis_info;
  P.par_info = par_info;
  P.ver_info = ver_info;
  P.plane_chi = plane_chi;
  P.vp_chi = vp_chi;
  P.n_rounds = n_rounds;
  P.n_iters = n_iters;
  P.w_scr = w_scr;
  P.T_out = T_out;
  P.n_in = n_in;
  P.chi2 = chi2;
  if (batch < 1) return static_cast<int>(cudaErrorInvalidValue);
  pose_opt_kernel<<<batch, kThreads, 0, stream>>>(P);
  return static_cast<int>(cudaGetLastError());
}
