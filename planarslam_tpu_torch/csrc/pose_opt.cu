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
// Design. The call is a chain of 40 dependent steps over ~1.1k items
// (~3.3k rows), so it is bound by latency, not by bytes or operations:
// one block of 512 threads per problem loops over the rounds
// and steps (a batch of B independent problems, every array with a leading
// B, is one launch of B blocks, block b reading problem b at its lane
// strides). An item is a point (3 rows, the third zero for mono), a line
// (its two endpoint rows) or a plane (3 rows direct, 2 parallel or
// vertical); thread t owns items t, t + 512, ... for the whole call.
// - One pass per LM step. The pass at T_new sums the accept test's chi2
//   (with the weights of T, recomputed from the chi kept for T) and, for
//   the next step, the 28 sums of J^T W J, J^T W r and chi2 at T_new with
//   the weights of T_new. An accepted step takes those as the next step's
//   system; a rejected one keeps the sums it had, which is what a pass at
//   the unchanged T and masks would recompute bit for bit. Each round
//   starts with one pass at T_init; its last step sums no system; the chi2
//   gates read the chi kept at the round's pose: 44 passes per call.
// - Everything stays on the SM: each item's inputs (a plane's observation
//   normalized once), its chi at the kept pose and at T_new (two buffers,
//   swapped on accept) and its valid and inlier flags live in dynamic shared
//   memory (57 bytes an item, so up to ~3990 items; a larger problem keeps
//   the same layout in a global scratch). The masks are written once.
// - Each thread sums its rows in float32 (as the plain version's float32
//   product does); the block reduces the 29 sums in float64 with no
//   atomics: a butterfly over each warp leaves sum k on lane k (16 float
//   and 15 double shuffles for all 29, pairing lanes as a shuffle-down
//   tree does), then sum k over the 16 warps by a 16-lane
//   shuffle tree, so two launches give the same bits.
// - Thread 0 solves the 6x6 system in float64 by LU with partial pivoting
//   (the plain version: torch.linalg.solve_ex, float32 LU with partial
//   pivoting), unrolled with compile-time indices (no run-time index into
//   the matrix), and forms T_new in float32; it then decides the step and
//   solves the next one before the block's one barrier.
// What bounds it on an H100: the latency of the step chain (a pass, a
// reduction with two barriers, one serial solve per step); its bytes (~60
// KB at the main path's shapes) and operations (~15 MFLOP) would take well
// under a microsecond at the card's rates.
#include <math.h>

#include <mutex>

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 28;    // upper triangle of H (21), g (6), chi2
constexpr int kChiNew = 28;  // the accept test's chi2, reduced beside them
constexpr int kVals = 32;    // the values one reduction sums: a warp's width
constexpr int kInputs = 10;  // staged input floats per item (a line's ten)
constexpr unsigned kFull = 0xffffffffu;
constexpr float kChi2Mono = 5.991f;
constexpr float kChi2Stereo = 7.815f;
constexpr float kChi2Line = 11.982f;  // 2 x 5.991 per endpoint
constexpr unsigned char kValid = 1, kInlier = 2;

enum Kind { kPoint = 0, kLine = 1, kPlane = 2, kPar = 3, kVer = 4 };

struct PlaneBlock {
  const float* pi_w;   // (n, 4) map plane, world frame
  const float* pi_obs; // (n, 4) observed plane, camera frame
  const unsigned char* valid;
  unsigned char* in;   // the output mask: valid & inlier
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
  unsigned char* stage;  // global staging, stage_bytes per problem, or NULL
  size_t stage_bytes;
  float* T_out;         // (4, 4)
  long long* n_in;
  float* chi2;
};

__host__ __device__ __forceinline__ int n_items_of(const Params& P) {
  return P.n_pt + P.n_ln + P.pl[0].n + P.pl[1].n + P.pl[2].n;
}

// Bytes of one problem's staging: kInputs floats, two chi buffers of two
// floats and one flag byte per item, rounded up to 16.
__host__ __device__ __forceinline__ size_t stage_bytes_for(int n) {
  return ((static_cast<size_t>(kInputs + 4) * 4 + 1) * n + 15) / 16 * 16;
}

// An item's staged record, structure of arrays over the problem's items:
// in[k][it] (points: xw, uv, ur, is2; lines: s, e, l2d, is2; planes: pi_w,
// the normalized observation), chi[buf][endpoint][it], flags[it].
struct Stage {
  float* in;
  float* chi;
  unsigned char* flags;
  int n;
  __device__ __forceinline__ float& x(int k, int it) const {
    return in[k * n + it];
  }
  __device__ __forceinline__ float& c(int buf, int e, int it) const {
    return chi[(2 * buf + e) * n + it];
  }
};

__device__ __forceinline__ Stage stage_at(unsigned char* base, int n) {
  Stage S;
  S.in = reinterpret_cast<float*>(base);
  S.chi = S.in + kInputs * n;
  S.flags = reinterpret_cast<unsigned char*>(S.chi + 4 * n);
  S.n = n;
  return S;
}

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

// v: xw (3), uv (2), ur, is2
__device__ __forceinline__ void point_rows(const Params& P, const float* T,
                                           const float* v, bool jac,
                                           Rows& o) {
  const float x[3] = {v[0], v[1], v[2]};
  float p[3];
  transform_pt(T, x, p);
  float u, vv;
  project(P, p, u, vv);
  const float zc = fmaxf(p[2], 1e-6f);
  const float ur = v[5];
  const bool stereo = ur >= 0.0f;
  o.n = 3;
  o.r[0] = v[3] - u;
  o.r[1] = v[4] - vv;
  o.r[2] = stereo ? ur - (u - P.bf / zc) : 0.0f;
  o.chi[0] = (o.r[0] * o.r[0] + o.r[1] * o.r[1] + o.r[2] * o.r[2]) * v[6];
  o.chi[1] = 0.0f;
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

// v: start (3), end (3), l2d (3), is2
__device__ __forceinline__ void line_rows(const Params& P, const float* T,
                                          const float* v, bool jac,
                                          Rows& o) {
  const float* l2 = v + 6;
  o.n = 2;
  for (int e = 0; e < 2; ++e) {
    const float x[3] = {v[3 * e], v[3 * e + 1], v[3 * e + 2]};
    float p[3];
    transform_pt(T, x, p);
    float u, vv;
    project(P, p, u, vv);
    o.r[e] = l2[0] * u + l2[1] * vv + l2[2];
    o.chi[e] = o.r[e] * o.r[e] * v[9];
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

// ominus / ominus_par / ominus_ver of transform(T, pi_w) against the
// normalized observation, and (jac) the stacked rows of
// _residuals_and_jacobian; v: pi_w (4), normalize(pi_obs) (4)
__device__ __forceinline__ void plane_rows(const Params& P, const float* T,
                                           int kind, const float* v,
                                           bool jac, Rows& o) {
  const float* w = v;
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
  float m[4] = {v[4], v[5], v[6], v[7]};
  if (kind == kPar && dot3(m, e) < 0.0f) {  // _hemi_align to the estimate
    for (int k = 0; k < 4; ++k) m[k] = -m[k];
  }
  float b1[3], b2[3];
  if (kind != kVer) tangent_basis(m, b1, b2);
  o.chi[1] = 0.0f;
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
  // dc = [[0 | -hat(n)], [-n | 0]] (4 x 6) for n = c[:3]; de = sgn dc / nn.
  // Its structural zeros are 0 / nn * sgn = 0 * sgn without the division
  // (nn >= sqrt(1e-9) > 0 for finite c)
  const float dn[3][6] = {
      {0.0f, 0.0f, 0.0f, 0.0f, c[2], -c[1]},
      {0.0f, 0.0f, 0.0f, -c[2], 0.0f, c[0]},
      {0.0f, 0.0f, 0.0f, c[1], -c[0], 0.0f}};
  const float dd[6] = {-c[0], -c[1], -c[2], 0.0f, 0.0f, 0.0f};
  const float zero = 0.0f * sgn;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const float d0 = k < 3 ? zero : dn[0][k] / nn * sgn;
    const float d1 = k < 3 ? zero : dn[1][k] / nn * sgn;
    const float d2 = k < 3 ? zero : dn[2][k] / nn * sgn;
    if (kind == kVer) {
      o.J[0][k] = m[0] * d0 + m[1] * d1 + m[2] * d2;
      o.J[1][k] = 0.0f;
    } else {
      o.J[0][k] = b1[0] * d0 + b1[1] * d1 + b1[2] * d2;
      o.J[1][k] = b2[0] * d0 + b2[1] * d1 + b2[2] * d2;
      if (kind == kPlane) o.J[2][k] = k < 3 ? dd[k] / nn * sgn : zero;
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

// _huber_w
__device__ __forceinline__ float huber_w(float chi2, float delta2, bool on) {
  if (!on || !(chi2 > delta2)) return 1.0f;
  return sqrtf(delta2 / fmaxf(chi2, 1e-12f));
}

// weights_at: the row weights of one item at its chi values; mask is 1
// for a valid inlier, else 0
__device__ __forceinline__ void item_weights(const Params& P, int kind,
                                             const float* v, const float* chi,
                                             float mask, bool huber_on,
                                             float* w) {
  if (kind == kPoint) {
    const bool stereo = v[5] >= 0.0f;
    const float gate = stereo ? kChi2Stereo : kChi2Mono;
    const float base = v[6] * huber_w(chi[0], gate, huber_on) * mask;
    w[0] = base;
    w[1] = base;
    w[2] = base * (stereo ? 1.0f : 0.0f);
  } else if (kind == kLine) {
    for (int e = 0; e < 2; ++e) {
      w[e] = v[9] * huber_w(chi[e], kChi2Mono, huber_on) * mask;
    }
  } else if (kind == kPlane) {
    const float s = huber_w(chi[0], P.plane_chi, huber_on) * mask;
    w[0] = s * P.angle_info;
    w[1] = s * P.angle_info;
    w[2] = s * P.dis_info;
  } else {
    const float info = kind == kPar ? P.par_info : P.ver_info;
    const float s = info * huber_w(chi[0], P.vp_chi, huber_on) * mask;
    w[0] = s;
    w[1] = s;
  }
}

// the chi2 gates after a round
__device__ __forceinline__ bool item_gate(const Params& P, int kind,
                                          const float* v, const float* chi) {
  if (kind == kPoint) return chi[0] <= (v[5] >= 0.0f ? kChi2Stereo : kChi2Mono);
  if (kind == kLine) return chi[0] <= kChi2Line && chi[1] <= kChi2Line;
  if (kind == kPlane) return chi[0] <= P.plane_chi;
  return chi[0] <= P.vp_chi;
}

// The plane block of a plane kind, chosen by selects: an index into P.pl
// at run time would put the parameters in local memory.
__device__ __forceinline__ PlaneBlock plane_block(const Params& P, int kind) {
  return kind == kPlane ? P.pl[0] : (kind == kPar ? P.pl[1] : P.pl[2]);
}

__device__ __forceinline__ void load_item(const Stage& S, int it, float* v) {
#pragma unroll
  for (int k = 0; k < kInputs; ++k) v[k] = S.x(k, it);
}

// Copy this thread's items into the staging, every item an inlier.
__device__ void stage_items(const Params& P, const Stage& S) {
  for (int it = threadIdx.x; it < S.n; it += kThreads) {
    int kind, j;
    locate(P, it, kind, j);
    bool valid;
    if (kind == kPoint) {
      for (int k = 0; k < 3; ++k) S.x(k, it) = P.pt_xw[3 * j + k];
      S.x(3, it) = P.pt_uv[2 * j];
      S.x(4, it) = P.pt_uv[2 * j + 1];
      S.x(5, it) = P.pt_ur[j];
      S.x(6, it) = P.pt_is2[j];
      valid = P.pt_valid[j] != 0;
    } else if (kind == kLine) {
      for (int k = 0; k < 3; ++k) {
        S.x(k, it) = P.ln_s[3 * j + k];
        S.x(3 + k, it) = P.ln_e[3 * j + k];
        S.x(6 + k, it) = P.ln_l2d[3 * j + k];
      }
      S.x(9, it) = P.ln_is2[j];
      valid = P.ln_valid[j] != 0;
    } else {
      const PlaneBlock B = plane_block(P, kind);
      float m[4];
      normalize_plane(B.pi_obs + 4 * j, m);
      for (int k = 0; k < 4; ++k) {
        S.x(k, it) = B.pi_w[4 * j + k];
        S.x(4 + k, it) = m[k];
      }
      valid = B.valid[j] != 0;
    }
    S.flags[it] = valid ? (kValid | kInlier) : kInlier;
  }
}

// One pass over this thread's items at the pose T (row-major 3 x 4 of a
// 4 x 4). Writes each item's chi at T into chi buffer `out`. kStep: adds
// the accept test's chi2 with the weights at chi buffer `cur` into
// acc[kChiNew]. kJac: adds the 28 sums at T with the weights at T into
// acc[0..27], each row's 28 products in a fixed order.
template <bool kJac, bool kStep>
__device__ __forceinline__ void item_pass(const Params& P, const Stage& S,
                                          const float* T, bool huber_on,
                                          int cur, int out, float* acc) {
  float Tr[12];
  for (int k = 0; k < 12; ++k) Tr[k] = T[k];
#pragma unroll
  for (int k = 0; k < kVals; ++k) acc[k] = 0.0f;
#pragma unroll 1
  for (int it = threadIdx.x; it < S.n; it += kThreads) {
    int kind, j;
    locate(P, it, kind, j);
    float v[kInputs];
    load_item(S, it, v);
    Rows o;
    if (kind == kPoint) {
      point_rows(P, Tr, v, kJac, o);
    } else if (kind == kLine) {
      line_rows(P, Tr, v, kJac, o);
    } else {
      plane_rows(P, Tr, kind, v, kJac, o);
    }
    const float mask = S.flags[it] == (kValid | kInlier) ? 1.0f : 0.0f;
    // rows r < o.n, unrolled so that the rows stay in registers
    if (kStep) {
      const float chi_t[2] = {S.c(cur, 0, it), S.c(cur, 1, it)};
      float w[3];
      item_weights(P, kind, v, chi_t, mask, huber_on, w);
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        if (r < o.n) acc[kChiNew] += w[r] * o.r[r] * o.r[r];
      }
    }
    S.c(out, 0, it) = o.chi[0];
    S.c(out, 1, it) = o.chi[1];
    if (kJac) {
      float w[3];
      item_weights(P, kind, v, o.chi, mask, huber_on, w);
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        if (r >= o.n) continue;
        float wj[6];
#pragma unroll
        for (int a = 0; a < 6; ++a) wj[a] = o.J[r][a] * w[r];
#pragma unroll
        for (int a = 0; a < 6; ++a) {
#pragma unroll
          for (int b = a; b < 6; ++b) {
            acc[a * 6 - a * (a - 1) / 2 + (b - a)] += wj[a] * o.J[r][b];
          }
        }
#pragma unroll
        for (int a = 0; a < 6; ++a) acc[21 + a] += wj[a] * o.r[r];
        acc[27] += w[r] * o.r[r] * o.r[r];
      }
    }
  }
}

// Sum the kVals values of every thread over the block in float64, in a
// fixed order: a butterfly in each warp leaves value k's warp sum on lane k
// (the additions of a shuffle-down tree: lanes paired across bit 4 first,
// bit 0 last), then value k's 16 warp sums by a 16-lane shuffle-down tree.
// red[] holds the sums for every thread after the call.
__device__ __forceinline__ void block_sum(const float* acc, double* warp_buf,
                                          double* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // the first step exchanges the float32 values and adds them in float64
  // (the conversion is exact): 16 doubles live, not 32
  double v[kVals / 2];
  {
    const bool upper = (lane & 16) != 0;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float send = upper ? acc[i] : acc[i + 16];
      const float keep = upper ? acc[i + 16] : acc[i];
      v[i] = static_cast<double>(keep) +
             static_cast<double>(__shfl_xor_sync(kFull, send, 16));
    }
  }
  // a level counter, not o >>= 1, so that the loops unroll and v stays in
  // registers
#pragma unroll
  for (int level = 1; level < 5; ++level) {
    const int o = 16 >> level;
    const bool upper = (lane & o) != 0;
#pragma unroll
    for (int i = 0; i < o; ++i) {
      const double send = upper ? v[i] : v[i + o];
      const double keep = upper ? v[i + o] : v[i];
      v[i] = keep + __shfl_xor_sync(kFull, send, o);
    }
  }
  warp_buf[warp * kVals + lane] = v[0];
  __syncthreads();
  static_assert(kThreads == 16 * kVals, "one 16-lane group per value");
  const int k = threadIdx.x >> 4, w = threadIdx.x & 15;
  double x = warp_buf[w * kVals + k];
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    x += __shfl_down_sync(kFull, x, off, 16);
  }
  if (w == 0) red[k] = x;
  __syncthreads();
}

// dx = -H_lm^-1 g, float64 LU with partial pivoting (the first row of the
// largest magnitude), unrolled so that A stays in registers; a zero pivot
// gives a non-finite dx, which the step rejects
__device__ __forceinline__ void solve_step(const double* sums, float lam,
                                           bool rot_fixed, float* dx) {
  double A[6][7];
#pragma unroll
  for (int a = 0; a < 6; ++a) {
#pragma unroll
    for (int b = a; b < 6; ++b) {
      const bool keep = !rot_fixed || (a < 3 && b < 3);
      A[a][b] = keep ? sums[a * 6 - a * (a - 1) / 2 + (b - a)] : 0.0;
      A[b][a] = A[a][b];
    }
  }
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    A[a][a] += static_cast<double>(lam) * A[a][a] + 1e-9;
    A[a][6] = (!rot_fixed || a < 3) ? sums[21 + a] : 0.0;
  }
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    int piv = c;
    double best = fabs(A[c][c]);
#pragma unroll
    for (int r = c + 1; r < 6; ++r) {
      const double a = fabs(A[r][c]);
      if (a > best) {
        best = a;
        piv = r;
      }
    }
    // the pivot row into row c by selects (columns before c are no longer
    // read)
#pragma unroll
    for (int r = c + 1; r < 6; ++r) {
      const bool sw = piv == r;
#pragma unroll
      for (int q = c; q < 7; ++q) {
        const double a = A[c][q], b = A[r][q];
        A[c][q] = sw ? b : a;
        A[r][q] = sw ? a : b;
      }
    }
#pragma unroll
    for (int r = c + 1; r < 6; ++r) {
      const double f = A[r][c] / A[c][c];
#pragma unroll
      for (int q = c; q < 7; ++q) A[r][q] -= f * A[c][q];
    }
  }
  double x[6];
#pragma unroll
  for (int a = 5; a >= 0; --a) {
    double s = A[a][6];
#pragma unroll
    for (int q = a + 1; q < 6; ++q) s -= A[a][q] * x[q];
    x[a] = s / A[a][a];
  }
#pragma unroll
  for (int a = 0; a < 6; ++a) dx[a] = -static_cast<float>(x[a]);
}

// T_new = se3.se3_exp(xi) @ T, float32 (rows of 4x4 row-major matrices)
__device__ __forceinline__ void se3_exp_mul(const float* xi, const float* T,
                                            float* T_new) {
  const float* rho = xi;
  const float* phi = xi + 3;
  const float th2 = phi[0] * phi[0] + phi[1] * phi[1] + phi[2] * phi[2];
  const float th = sqrtf(th2 + 1e-8f);
  const float K[9] = {0.0f, -phi[2], phi[1], phi[2], 0.0f, -phi[0],
                      -phi[1], phi[0], 0.0f};
  float K2[9];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      K2[3 * i + j] = K[3 * i] * K[j] + K[3 * i + 1] * K[3 + j] +
                      K[3 * i + 2] * K[6 + j];
    }
  }
  const bool small = th2 < 1e-8f;
  const float th2c = fmaxf(th2, 1e-8f);
  float s, co;
  sincosf(th, &s, &co);
  const float a = small ? 1.0f - th2 / 6.0f : s / th;
  const float b = small ? 0.5f - th2 / 24.0f : (1.0f - co) / th2c;
  const float ja = small ? 0.5f - th2 / 24.0f : (1.0f - co) / th2c;
  const float jb = small ? 1.0f / 6.0f - th2 / 120.0f : (th - s) / (th2c * th);
  float E[16];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float Jrow[3];
#pragma unroll
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
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      T_new[4 * i + j] = E[4 * i] * T[j] + E[4 * i + 1] * T[4 + j] +
                         E[4 * i + 2] * T[8 + j] + E[4 * i + 3] * T[12 + j];
    }
  }
}

// Thread 0: the step's system from sums, its solution, T_new.
__device__ __forceinline__ void next_step(const double* sums, float lam,
                                          bool rot_fixed, const float* T,
                                          float* T_new, float& chi_old,
                                          bool& finite) {
  chi_old = static_cast<float>(sums[27]);
  float dx[6];
  solve_step(sums, lam, rot_fixed, dx);
  finite = true;
  for (int a = 0; a < 6; ++a) finite = finite && isfinite(dx[a]);
  se3_exp_mul(dx, T, T_new);
}

// Params of problem `lane` of a batch: every array advanced by the lane's
// stride (its row count times its width).
__device__ __forceinline__ Params at_lane(Params P, int lane) {
  const size_t b = lane;
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
  P.T_out += 16 * b;
  P.n_in += b;
  P.chi2 += b;
  return P;
}

// kShared: the staging in dynamic shared memory, else in P.stage.
template <bool kShared>
__global__ void __launch_bounds__(kThreads, 1)
    pose_opt_kernel(const Params P_batch) {
  extern __shared__ __align__(16) unsigned char smem_stage[];
  // the counts and constants, read from parameter memory; the problem's
  // arrays (at_lane) only where staged in and written out
  const Params& P = P_batch;
  __shared__ float T0[16], T[16], T_new[16];
  __shared__ double warp_buf[kWarps * kVals];
  __shared__ double red[kVals];
  __shared__ double sums[kSums];  // the current step's system
  __shared__ int accepted, n_in_block;
  const int tid = threadIdx.x;
  const Stage S = stage_at(
      kShared ? smem_stage : P.stage + blockIdx.x * P.stage_bytes,
      n_items_of(P));
  bool rot_fixed;
  {
    const Params lane = at_lane(P_batch, blockIdx.x);
    rot_fixed = lane.rot_flag != nullptr ? *lane.rot_flag != 0
                                         : lane.rot_fixed_host != 0;
    if (tid < 16) {
      T0[tid] = lane.T_init[tid];
      T[tid] = T0[tid];
    }
    stage_items(lane, S);
  }
  if (tid == 0) n_in_block = 0;
  float chi_total = 0.0f;  // thread 0's
  int cur = 0;             // the chi buffer of the kept pose, every thread's
  float acc[kVals];
  __syncthreads();

  for (int rnd = 0; rnd < P.n_rounds; ++rnd) {
    const bool huber_on = rnd < P.n_rounds - 1;
    if (tid < 16) T[tid] = T0[tid];
    float lam = 1e-4f, chi_cur = INFINITY, chi_old = 0.0f;  // thread 0's
    bool finite = false;                                     // thread 0's
    __syncthreads();
    // the round's first pass at T_init: the first step's system
    if (P.n_iters > 0) {
      item_pass<true, false>(P, S, T, huber_on, cur, cur, acc);
      block_sum(acc, warp_buf, red);
      if (tid == 0) {
        for (int k = 0; k < kSums; ++k) sums[k] = red[k];
        next_step(sums, lam, rot_fixed, T, T_new, chi_old, finite);
      }
      __syncthreads();
    } else {
      item_pass<false, false>(P, S, T, huber_on, cur, cur, acc);
    }
    for (int step = 0; step < P.n_iters; ++step) {
      // one pass at T_new: the accept test's chi2, and (but in the round's
      // last step) the next step's system should the step be accepted
      const bool last = step == P.n_iters - 1;
      if (last) {
        item_pass<false, true>(P, S, T_new, huber_on, cur, 1 - cur, acc);
      } else {
        item_pass<true, true>(P, S, T_new, huber_on, cur, 1 - cur, acc);
      }
      block_sum(acc, warp_buf, red);
      if (tid == 0) {
        const float chi_new = static_cast<float>(red[kChiNew]);
        const bool accept = chi_new < chi_old && finite;
        if (accept) {
          for (int k = 0; k < 16; ++k) T[k] = T_new[k];
          for (int k = 0; k < kSums; ++k) sums[k] = red[k];
        }
        lam = fminf(fmaxf(accept ? lam * 0.5f : lam * 4.0f, 1e-8f), 1e6f);
        chi_cur = accept ? chi_new : chi_old;
        accepted = accept ? 1 : 0;
        if (!last) next_step(sums, lam, rot_fixed, T, T_new, chi_old, finite);
      }
      __syncthreads();
      if (accepted) cur = 1 - cur;
    }
    if (tid == 0) chi_total = chi_cur;
    // the chi2 gates at the round's pose refresh the inlier flags
    for (int it = tid; it < S.n; it += kThreads) {
      int kind, j;
      locate(P, it, kind, j);
      float v[kInputs];
      load_item(S, it, v);
      const float chi[2] = {S.c(cur, 0, it), S.c(cur, 1, it)};
      S.flags[it] = (S.flags[it] & kValid) |
                    (item_gate(P, kind, v, chi) ? kInlier : 0);
    }
  }

  const Params lane = at_lane(P_batch, blockIdx.x);
  int n_in = 0;
  for (int it = tid; it < S.n; it += kThreads) {
    int kind, j;
    locate(lane, it, kind, j);
    const unsigned char f = S.flags[it] == (kValid | kInlier) ? 1 : 0;
    if (kind == kPoint) {
      lane.pt_in[j] = f;
      n_in += f;
    } else if (kind == kLine) {
      lane.ln_in[j] = f;
    } else {
      plane_block(lane, kind).in[j] = f;
    }
  }
  if (n_in > 0) atomicAdd(&n_in_block, n_in);  // an integer count
  __syncthreads();
  if (tid < 16) lane.T_out[tid] = T[tid];
  if (tid == 0) {
    *lane.n_in = n_in_block;
    *lane.chi2 = chi_total;
  }
}

// The dynamic shared memory the staging may take: the card's opt-in limit
// per block less the kernel's static shared memory, set on the kernel once
// per card (every call past kPslDevices cards); -1 on an error.
long long stage_smem_limit() {
  static std::mutex mu;
  static long long limits[kPslDevices] = {};  // 0 until set
  const std::lock_guard<std::mutex> hold(mu);
  long long* cached = psl_device_slot(limits);
  if (cached != nullptr && *cached > 0) return *cached;
  int dev = 0, optin = 0;
  cudaFuncAttributes fa;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess ||
      cudaFuncGetAttributes(
          &fa, reinterpret_cast<const void*>(pose_opt_kernel<true>)) !=
          cudaSuccess) {
    return -1;
  }
  const long long limit = static_cast<long long>(optin) -
                          static_cast<long long>(fa.sharedSizeBytes);
  if (limit <= 0 ||
      cudaFuncSetAttribute(
          reinterpret_cast<const void*>(pose_opt_kernel<true>),
          cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(limit)) != cudaSuccess) {
    return -1;
  }
  if (cached != nullptr) *cached = limit;
  return limit;
}

}  // namespace

// Bytes of global staging psl_pose_optimize needs per problem: 0 when a
// problem of n_items items stages in shared memory; -1 on an error.
PSL_API long long psl_pose_optimize_scratch_bytes(int n_items) {
  const long long limit = stage_smem_limit();
  if (limit < 0) return -1;
  const long long need = static_cast<long long>(stage_bytes_for(n_items));
  return need <= limit ? 0 : need;
}

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
    int n_rounds, int n_iters, int batch, void* scratch, float* T_out,
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
  P.T_out = T_out;
  P.n_in = n_in;
  P.chi2 = chi2;
  if (batch < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long global = psl_pose_optimize_scratch_bytes(n_items_of(P));
  if (global < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (global == 0) {
    P.stage = nullptr;
    P.stage_bytes = 0;
    pose_opt_kernel<true><<<batch, kThreads, stage_bytes_for(n_items_of(P)),
                            stream>>>(P);
  } else {
    if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    P.stage = static_cast<unsigned char*>(scratch);
    P.stage_bytes = static_cast<size_t>(global);
    pose_opt_kernel<false><<<batch, kThreads, 0, stream>>>(P);
  }
  return static_cast<int>(cudaGetLastError());
}
