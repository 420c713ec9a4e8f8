// K43 pcg_prepare, K44 pcg_schur_matvec, K45 pcg_cg_update — the
// matrix-free preconditioned-CG solve of global BA's reduced camera system
// S = Hcc_d - Hcp Hpp_d^-1 Hcp^T, with fixed poses pinned.
//
// Replace the CG part of planarslam_tpu/solvers/ba_pcg.py::ba_solve_pcg.
// step (:44-289): the damping and inverses (:162-175), the matrix-free
// products (:179-214), the rhs (:216), the block-Jacobi preconditioner
// (:218-236), the CG loop's body (:238-259) and the back-substitution
// (:262). The JAX package builds them of batched einsums and segment sums
// inside one jitted program; here a CG step is two kernels.
//
// Observations are numbered per lane: points o = k F + f, line endpoints
// Kt F + k L2 + l, then each plane table with slots (in the order direct,
// parallel, vertical) its k Pp + p. Each has a 6 x 3 cross block C_o =
// J_pose^T W J_lm (row i a pose entry, column j a landmark entry). The
// plan (solvers/ba_pcg.py::pcg_plan, built once per solve) lists the live
// observations (mask > 0) by landmark (lm_order, lm_start) and by keyframe
// (kf_order, kf_start), each stably by observation number: every sum below
// runs in that order, so two launches give equal bits (no float atomics).
//
// K43 (once per LM step; one launch): keyframe blocks form mu_c (each
// block the same sum over all keyframes, in one fixed order, so no block
// waits on another), Hcc_d = Hcc + lam diag(Hcc) + (lam mu_c + 1e-8) I, the
// block-Jacobi correction sum_o C_o Hpp_d^-1 C_o^T over their observations
// and its 6 x 6 inverse Minv = (Hcc_d - corr + (1e-3 mu_c + 1e-8) I)^-1,
// and rhs = (bc - sum_o C_o Hpp_d^-1 bp) free; landmark blocks write
// Hpp_d^-1; observation blocks write every C_o: the point and line ones
// copied from K8's scratch (its 18 cross terms), the plane ones summed
// from K33's records (r, Wv, Jx, Jt per row). The 3 x 3 and 6 x 6 inverses
// are taken in float64 (the adjugate, Gauss-Jordan with partial pivoting)
// and rounded to float32; a keyframe block takes the inverse of each
// landmark it sees with the same code, so it uses the bits the landmark
// blocks write.
// K44 (once per CG step; one C call of two launches): a landmark pass, a
// warp a landmark, v_m = Hpp_d^-1 sum_o C_o^T (p free)[k_o], then a
// keyframe pass, a warp a keyframe, Ap_k = (Hcc_d (p free)_k - sum_o C_o
// v[slot_o]) free_k; a lane takes every 32nd observation, so a step's
// chains of dependent loads are one or two observations long. With
// bp given, the landmark pass alone is the back-substitution dxp = -Hpp_d^-1
// (bp + sum_o C_o^T dxc[k_o]).
// K45 (once per CG step, and once in its init mode per LM step): one block
// a lane over all Kt x 6 values: pAp, alpha, x, r, z = Minv (r free) free,
// rz_new, beta and p, with JAX's guards (alpha 0 unless pAp > 0, beta 0
// unless rz > 0); the init mode gives x = 0, r = rhs, z, p = z and rz.
// Fixed poses' entries of x, r, z and p stay exactly 0: their free is 0.
//
// Built with -fmad=false, as the plain versions' separate PyTorch ops
// round. What bounds them on an H100 at path 4c (Kt = 256, 6144 point
// observations, M = 1024): a few hundred KB a CG step, about 0.0003 ms of
// bytes; the launches' latency sets their time (a thread a landmark,
// walking its observations' chains of dependent loads, took 12.6 us a
// landmark pass; a warp a landmark, its lanes on the observations at
// once, does away with the chain).
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kCgThreads = 256;
constexpr int kCorr = 42;  // 36 of the correction, 6 of the rhs sum

// Hpp_d^-1 of one landmark block, damped in float32 as the plain version
// (Hpp + lam diag(Hpp)) + (lam mu_p + 1e-6) I, inverted in float64 by the
// adjugate, rounded to float32.
__device__ __noinline__ void damped_inverse3(const float* __restrict__ H,
                                             float lam, float mu_p,
                                             float* out) {
  const float floor = lam * mu_p + 1e-6f;
  double h[9];
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) {
      const float x = H[3 * i + j];
      h[3 * i + j] = i == j ? (x + lam * x) + floor : x;
    }
  }
  const double c00 = h[4] * h[8] - h[5] * h[7];
  const double c01 = h[5] * h[6] - h[3] * h[8];
  const double c02 = h[3] * h[7] - h[4] * h[6];
  const double det = h[0] * c00 + h[1] * c01 + h[2] * c02;
  const double adj[9] = {c00, h[2] * h[7] - h[1] * h[8],
                         h[1] * h[5] - h[2] * h[4],
                         c01, h[0] * h[8] - h[2] * h[6],
                         h[2] * h[3] - h[0] * h[5],
                         c02, h[1] * h[6] - h[0] * h[7],
                         h[0] * h[4] - h[1] * h[3]};
  for (int e = 0; e < 9; ++e) out[e] = static_cast<float>(adj[e] / det);
}

// (a^-1) of a 6 x 6 float32 matrix, in float64 by Gauss-Jordan with
// partial pivoting, rounded to float32 (a singular pivot gives inf / NaN)
__device__ __noinline__ void inverse6(const float* a, float* out) {
  double m[6][12];
  for (int i = 0; i < 6; ++i) {
    for (int j = 0; j < 6; ++j) {
      m[i][j] = a[6 * i + j];
      m[i][6 + j] = i == j ? 1.0 : 0.0;
    }
  }
  for (int c = 0; c < 6; ++c) {
    int piv = c;
    for (int i = c + 1; i < 6; ++i) {
      if (fabs(m[i][c]) > fabs(m[piv][c])) piv = i;
    }
    if (piv != c) {
      for (int j = 0; j < 12; ++j) {
        const double t = m[c][j];
        m[c][j] = m[piv][j];
        m[piv][j] = t;
      }
    }
    const double inv = 1.0 / m[c][c];
    for (int j = 0; j < 12; ++j) m[c][j] *= inv;
    for (int i = 0; i < 6; ++i) {
      if (i == c) continue;
      const double f = m[i][c];
      for (int j = 0; j < 12; ++j) m[i][j] -= f * m[c][j];
    }
  }
  for (int i = 0; i < 6; ++i) {
    for (int j = 0; j < 6; ++j) out[6 * i + j] = static_cast<float>(m[i][6 + j]);
  }
}

struct PlaneTable {
  const float* rec;  // (B, Kt, Pp, D, 11): r, Wv, Jx (6), Jt (3) per row
  int D, Pp;
};

struct Prep {
  const float* Hcc;   // (B, Kt, 6, 6)
  const float* bc;    // (B, Kt, 6)
  const float* Hpp;   // (B, M, 3, 3)
  const float* bp;    // (B, M, 3)
  const float* lam;   // (B,)
  const float* mu_p;  // (B,)
  const float* free_w;  // (B, Kt)
  const float* cross;   // K8's cross terms, row o at o * cross_row
  long long cross_row, cross_lane;
  PlaneTable tab[3];
  const int* obs_slot;  // (B, n_obs)
  const int* kf_order;  // (B, n_obs)
  const int* kf_start;  // (B, Kt + 1)
  int Kt, M, n_obs, n_ptln;
  float* Hpp_inv;  // (B, M, 3, 3)
  float* Hcc_d;    // (B, Kt, 6, 6)
  float* Minv;     // (B, Kt, 6, 6)
  float* rhs;      // (B, Kt, 6)
  float* C;        // (B, n_obs, 6, 3)
};

// C_o of observation o of lane b: K8's 18 terms, or the plane rows' sum
// C[i][j] = sum_d (Jx[d][i] Wv[d]) Jt[d][j], d ascending
__device__ __forceinline__ void cross_block(const Prep& a, int b, int o,
                                            float* c) {
  if (o < a.n_ptln) {
    const float* src = a.cross + b * a.cross_lane + o * a.cross_row;
    for (int e = 0; e < 18; ++e) c[e] = src[e];
    return;
  }
  int q = o - a.n_ptln;
  int t = 0;
  while (t < 2 && q >= a.Kt * a.tab[t].Pp) {
    q -= a.Kt * a.tab[t].Pp;
    ++t;
  }
  const PlaneTable& tb = a.tab[t];
  const float* rec = tb.rec +
                     (static_cast<size_t>(b) * a.Kt * tb.Pp + q) * tb.D * 11;
  for (int e = 0; e < 18; ++e) c[e] = 0.0f;
  for (int d = 0; d < tb.D; ++d) {
    const float* row = rec + 11 * d;
    for (int i = 0; i < 6; ++i) {
      const float jw = row[2 + i] * row[1];
      for (int j = 0; j < 3; ++j) c[3 * i + j] = c[3 * i + j] + jw * row[8 + j];
    }
  }
}

// sum over the block (kThreads) of n <= kCorr values per thread, in a
// fixed tree (red: kThreads / 32 rows of kCorr); every thread receives the
// totals in out
__device__ __forceinline__ void block_sum(const float* v, int n, float* red,
                                          float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int c = 0; c < n; ++c) {
    float x = v[c];
    for (int off = 16; off > 0; off >>= 1) {
      x += __shfl_down_sync(0xffffffffu, x, off);
    }
    if (lane == 0) red[warp * kCorr + c] = x;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < n; c += kThreads) {
    float s = red[c];
    for (int w = 1; w < kThreads / 32; ++w) s = s + red[w * kCorr + c];
    out[c] = s;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads) pcg_prepare_kernel(Prep a) {
  __shared__ float red[kThreads / 32 * kCorr];
  __shared__ float tot[kCorr];
  const int b = blockIdx.y;
  const int Kt = a.Kt, M = a.M;
  const int n_lm = (M + kThreads - 1) / kThreads;
  const float lam = a.lam[b], mu_p = a.mu_p[b];
  const float* Hpp = a.Hpp + static_cast<size_t>(b) * M * 9;
  if (blockIdx.x >= Kt) {
    const int blk = blockIdx.x - Kt;
    if (blk < n_lm) {  // landmark block: Hpp_d^-1
      const int m = blk * kThreads + threadIdx.x;
      if (m < M) {
        damped_inverse3(Hpp + 9 * m, lam, mu_p,
                        a.Hpp_inv + (static_cast<size_t>(b) * M + m) * 9);
      }
      return;
    }
    // observation block: C_o
    const int o = (blk - n_lm) * kThreads + threadIdx.x;
    if (o < a.n_obs) {
      float c[18];
      cross_block(a, b, o, c);
      float* dst = a.C + (static_cast<size_t>(b) * a.n_obs + o) * 18;
      for (int e = 0; e < 18; ++e) dst[e] = c[e];
    }
    return;
  }

  // keyframe block k
  const int k = blockIdx.x;
  const float* Hcc = a.Hcc + static_cast<size_t>(b) * Kt * 36;
  const float* fw = a.free_w + static_cast<size_t>(b) * Kt;
  {  // mu_c = sum(diag(Hcc) free) / (sum(free) 6 + 1), the same in every block
    float v[2] = {0.0f, 0.0f};
    for (int e = threadIdx.x; e < Kt * 6; e += kThreads) {
      const int kk = e / 6, i = e - kk * 6;
      v[0] = v[0] + Hcc[36 * kk + 7 * i] * fw[kk];
    }
    for (int kk = threadIdx.x; kk < Kt; kk += kThreads) v[1] = v[1] + fw[kk];
    block_sum(v, 2, red, tot);
  }
  const float mu_c = tot[0] / (tot[1] * 6.0f + 1.0f);

  float acc[kCorr];
  for (int c = 0; c < kCorr; ++c) acc[c] = 0.0f;
  const float* bp = a.bp + static_cast<size_t>(b) * M * 3;
  const int* order = a.kf_order + static_cast<size_t>(b) * a.n_obs;
  const int* start = a.kf_start + static_cast<size_t>(b) * (Kt + 1);
  const int* oslot = a.obs_slot + static_cast<size_t>(b) * a.n_obs;
  for (int e = start[k] + threadIdx.x; e < start[k + 1]; e += kThreads) {
    const int o = order[e];
    const int s = oslot[o];
    float c[18], hi[9], y[3];
    cross_block(a, b, o, c);
    damped_inverse3(Hpp + 9 * s, lam, mu_p, hi);
    for (int j = 0; j < 3; ++j) {
      y[j] = hi[3 * j] * bp[3 * s] + hi[3 * j + 1] * bp[3 * s + 1] +
             hi[3 * j + 2] * bp[3 * s + 2];
    }
    for (int i = 0; i < 6; ++i) {
      const float* ci = c + 3 * i;
      acc[36 + i] = acc[36 + i] + (ci[0] * y[0] + ci[1] * y[1] + ci[2] * y[2]);
      float t[3];
      for (int l = 0; l < 3; ++l) {
        t[l] = ci[0] * hi[l] + ci[1] * hi[3 + l] + ci[2] * hi[6 + l];
      }
      for (int m = 0; m < 6; ++m) {
        const float* cm = c + 3 * m;
        acc[6 * i + m] =
            acc[6 * i + m] + (t[0] * cm[0] + t[1] * cm[1] + t[2] * cm[2]);
      }
    }
  }
  block_sum(acc, kCorr, red, tot);
  if (threadIdx.x == 0) {
    const size_t kb = static_cast<size_t>(b) * Kt + k;
    const float* H = Hcc + 36 * k;
    const float cfloor = lam * mu_c + 1e-8f;
    const float pfloor = 1e-3f * mu_c + 1e-8f;
    float hd[36], pm[36], mi[36];
    for (int i = 0; i < 6; ++i) {
      for (int j = 0; j < 6; ++j) {
        const float x = H[6 * i + j];
        hd[6 * i + j] = i == j ? (x + lam * x) + cfloor : x;
        pm[6 * i + j] = i == j ? (hd[6 * i + j] - tot[6 * i + j]) + pfloor
                               : hd[6 * i + j] - tot[6 * i + j];
      }
    }
    inverse6(pm, mi);
    for (int e = 0; e < 36; ++e) {
      a.Hcc_d[kb * 36 + e] = hd[e];
      a.Minv[kb * 36 + e] = mi[e];
    }
    const float fk = fw[k];
    const float* bck = a.bc + kb * 6;
    for (int i = 0; i < 6; ++i) a.rhs[kb * 6 + i] = (bck[i] - tot[36 + i]) * fk;
  }
}

struct Matvec {
  const float* C;        // (B, n_obs, 6, 3)
  const float* Hpp_inv;  // (B, M, 3, 3)
  const float* Hcc_d;    // (B, Kt, 6, 6)
  const float* free_w;   // (B, Kt); NULL in the back-substitution
  const int* obs_kf;     // (B, n_obs)
  const int* obs_slot;   // (B, n_obs)
  const int* lm_order;   // (B, n_obs)
  const int* lm_start;   // (B, M + 1)
  const int* kf_order;   // (B, n_obs)
  const int* kf_start;   // (B, Kt + 1)
  int Kt, M, n_obs;
  const float* x;   // p (matvec) or dxc (back-substitution), (B, Kt, 6)
  const float* bp;  // (B, M, 3), the back-substitution's; NULL: matvec
  float* v;         // (B, M, 3): the landmark pass's v, or dxp
  float* Ap;        // (B, Kt, 6), matvec
};

// a warp a landmark, a lane its observations e = start + lane, + 32, ...:
// acc = sum_o C_o^T q[k_o], q = p free (matvec) or dxc, the lanes' sums
// joined by a butterfly; lane j < 3 writes row j of v = Hpp_d^-1 acc, or of
// dxp = -Hpp_d^-1 (bp + acc)
__global__ void __launch_bounds__(kThreads) pcg_landmark_kernel(Matvec a) {
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (m >= a.M) return;
  const size_t lo = static_cast<size_t>(b) * a.n_obs;
  const int* start = a.lm_start + static_cast<size_t>(b) * (a.M + 1);
  const float* fw = a.free_w + (a.bp == nullptr ? b * a.Kt : 0);
  const float* xb = a.x + static_cast<size_t>(b) * a.Kt * 6;
  float acc[3] = {0.0f, 0.0f, 0.0f};
  for (int e = start[m] + lane; e < start[m + 1]; e += 32) {
    const int o = a.lm_order[lo + e];
    const int k = a.obs_kf[lo + o];
    const float* c = a.C + (lo + o) * 18;
    float q[6];
    for (int i = 0; i < 6; ++i) {
      q[i] = a.bp == nullptr ? xb[6 * k + i] * fw[k] : xb[6 * k + i];
    }
    for (int j = 0; j < 3; ++j) {
      float t = c[j] * q[0];
      for (int i = 1; i < 6; ++i) t = t + c[3 * i + j] * q[i];
      acc[j] = acc[j] + t;
    }
  }
  for (int j = 0; j < 3; ++j) {
    for (int off = 16; off > 0; off >>= 1) {
      acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], off);
    }
  }
  if (lane >= 3) return;
  const size_t mb = static_cast<size_t>(b) * a.M + m;
  const float* hi = a.Hpp_inv + mb * 9 + 3 * lane;
  if (a.bp != nullptr) {
    for (int j = 0; j < 3; ++j) acc[j] = a.bp[mb * 3 + j] + acc[j];
  }
  const float v = hi[0] * acc[0] + hi[1] * acc[1] + hi[2] * acc[2];
  a.v[mb * 3 + lane] = a.bp == nullptr ? v : -v;
}

// a warp a keyframe: Ap_k = (Hcc_d (p free)_k - sum_o C_o v[slot_o]) free_k
__global__ void __launch_bounds__(kThreads) pcg_keyframe_kernel(Matvec a) {
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int k = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (k >= a.Kt) return;
  const size_t lo = static_cast<size_t>(b) * a.n_obs;
  const int* start = a.kf_start + static_cast<size_t>(b) * (a.Kt + 1);
  const float* vb = a.v + static_cast<size_t>(b) * a.M * 3;
  float s[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int e = start[k] + lane; e < start[k + 1]; e += 32) {
    const int o = a.kf_order[lo + e];
    const int sl = a.obs_slot[lo + o];
    const float* c = a.C + (lo + o) * 18;
    const float* v = vb + 3 * sl;
    for (int i = 0; i < 6; ++i) {
      s[i] = s[i] + (c[3 * i] * v[0] + c[3 * i + 1] * v[1] +
                     c[3 * i + 2] * v[2]);
    }
  }
  for (int i = 0; i < 6; ++i) {
    for (int off = 16; off > 0; off >>= 1) {
      s[i] += __shfl_xor_sync(0xffffffffu, s[i], off);
    }
  }
  if (lane < 6) {
    const size_t kb = static_cast<size_t>(b) * a.Kt + k;
    const float f = a.free_w[kb];
    const float* p = a.x + kb * 6;
    const float* h = a.Hcc_d + kb * 36 + 6 * lane;
    float xm[6];
    for (int j = 0; j < 6; ++j) xm[j] = p[j] * f;
    float hx = h[0] * xm[0];
    for (int j = 1; j < 6; ++j) hx = hx + h[j] * xm[j];
    float mine = s[0];
    for (int i = 1; i < 6; ++i) {
      if (lane == i) mine = s[i];
    }
    a.Ap[kb * 6 + lane] = (hx - mine) * f;
  }
}

// sum of one value per thread over the block (kCgThreads), fixed tree;
// every thread receives it
__device__ __forceinline__ float cg_block_sum(float x, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1) {
    x += __shfl_down_sync(0xffffffffu, x, off);
  }
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float s = red[0];
  for (int w = 1; w < kCgThreads / 32; ++w) s = s + red[w];
  __syncthreads();
  return s;
}

// z_k = Minv_k (r_k free_k) free_k
__device__ __forceinline__ void precond(const float* Mi, const float* r,
                                        float f, float* z) {
  float rm[6];
  for (int j = 0; j < 6; ++j) rm[j] = r[j] * f;
  for (int i = 0; i < 6; ++i) {
    float t = Mi[6 * i] * rm[0];
    for (int j = 1; j < 6; ++j) t = t + Mi[6 * i + j] * rm[j];
    z[i] = t * f;
  }
}

// one block a lane; a thread the keyframes k = t, t + kCgThreads, ...
__global__ void __launch_bounds__(kCgThreads) pcg_cg_kernel(
    const float* __restrict__ Minv, const float* __restrict__ free_w, int Kt,
    const float* __restrict__ x, const float* __restrict__ r,
    const float* __restrict__ p, const float* __restrict__ Ap,
    const float* __restrict__ scal, float* __restrict__ x_out,
    float* __restrict__ r_out, float* __restrict__ p_out,
    float* __restrict__ scal_out) {
  __shared__ float red[kCgThreads / 32];
  const int b = blockIdx.x;
  const size_t base = static_cast<size_t>(b) * Kt;
  const bool init = Ap == nullptr;
  float alpha = 0.0f, rz = 0.0f, pAp = 0.0f;
  if (!init) {
    float part = 0.0f;
    for (int k = threadIdx.x; k < Kt; k += kCgThreads) {
      const float* pk = p + (base + k) * 6;
      const float* ak = Ap + (base + k) * 6;
      float t = pk[0] * ak[0];
      for (int i = 1; i < 6; ++i) t = t + pk[i] * ak[i];
      part = part + t;
    }
    pAp = cg_block_sum(part, red);
    rz = scal[2 * b];
    alpha = pAp > 0.0f ? rz / pAp : 0.0f;
  }
  float part = 0.0f;
  for (int k = threadIdx.x; k < Kt; k += kCgThreads) {
    const size_t kb = base + k;
    const float f = free_w[kb];
    float xn[6], rn[6], z[6];
    for (int i = 0; i < 6; ++i) {
      if (init) {
        xn[i] = 0.0f;
        rn[i] = r[kb * 6 + i];
      } else {
        xn[i] = x[kb * 6 + i] + alpha * p[kb * 6 + i];
        rn[i] = r[kb * 6 + i] - alpha * Ap[kb * 6 + i];
      }
    }
    precond(Minv + kb * 36, rn, f, z);
    float t = rn[0] * z[0];
    for (int i = 1; i < 6; ++i) t = t + rn[i] * z[i];
    part = part + t;
    for (int i = 0; i < 6; ++i) {
      x_out[kb * 6 + i] = xn[i];
      r_out[kb * 6 + i] = rn[i];
      // z for now; p = z + beta p once rz_new is known
      p_out[kb * 6 + i] = z[i];
    }
  }
  const float rz_new = cg_block_sum(part, red);
  if (!init) {
    const float beta = rz > 0.0f ? rz_new / rz : 0.0f;
    for (int k = threadIdx.x; k < Kt; k += kCgThreads) {
      const size_t kb = base + k;
      for (int i = 0; i < 6; ++i) {
        p_out[kb * 6 + i] = p_out[kb * 6 + i] + beta * p[kb * 6 + i];
      }
    }
  }
  if (threadIdx.x == 0) {
    scal_out[2 * b] = rz_new;
    scal_out[2 * b + 1] = pAp;
  }
}

}  // namespace

// K43: Hcc (B, Kt, 6, 6), bc (B, Kt, 6), Hpp (B, M, 3, 3), bp (B, M, 3),
// lam and mu_p (B,), free (B, Kt); K8's cross terms (row o of lane b at
// b cross_lane + o cross_row floats, 18 of them) for the n_ptln point and
// line observations; three plane tables' records (B, Kt, Pp, D, 11) with
// their D and Pp (Pp 0: no table); the plan's obs_slot, kf_order (B,
// n_obs), kf_start (B, Kt + 1). Writes Hpp_inv, Hcc_d, Minv, rhs, C (B,
// n_obs, 6, 3).
PSL_API int psl_pcg_prepare(
    const float* Hcc, const float* bc, const float* Hpp, const float* bp,
    const float* lam, const float* mu_p, const float* free_w,
    const float* cross, long long cross_row, long long cross_lane,
    int n_ptln, const float* rec0, int D0, int Pp0, const float* rec1,
    int D1, int Pp1, const float* rec2, int D2, int Pp2, const int* obs_slot,
    const int* kf_order, const int* kf_start, int batch, int Kt, int M,
    int n_obs, float* Hpp_inv, float* Hcc_d, float* Minv, float* rhs,
    float* C, cudaStream_t stream) {
  if (batch < 0 || Kt < 0 || M < 0 || n_obs < n_ptln || n_ptln < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0) return 0;
  Prep a{Hcc, bc, Hpp, bp, lam, mu_p, free_w, cross, cross_row, cross_lane,
         {{rec0, D0, Pp0}, {rec1, D1, Pp1}, {rec2, D2, Pp2}}, obs_slot,
         kf_order, kf_start, Kt, M, n_obs, n_ptln, Hpp_inv, Hcc_d, Minv,
         rhs, C};
  const int blocks = Kt + (M + kThreads - 1) / kThreads +
                     (n_obs + kThreads - 1) / kThreads;
  if (blocks == 0) return 0;
  pcg_prepare_kernel<<<dim3(blocks, batch), kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// K44: the matrix-free S p (bp NULL: two launches, v the landmark pass's
// scratch (B, M, 3), Ap (B, Kt, 6) the result) or the back-substitution
// (bp given: one launch, v receives dxp, x is dxc, free unread and may be
// NULL). `launches` receives the launches made.
PSL_API int psl_pcg_schur_matvec(
    const float* C, const float* Hpp_inv, const float* Hcc_d,
    const float* free_w, const int* obs_kf, const int* obs_slot,
    const int* lm_order, const int* lm_start, const int* kf_order,
    const int* kf_start, int batch, int Kt, int M, int n_obs, const float* x,
    const float* bp, float* v, float* Ap, int* launches,
    cudaStream_t stream) {
  *launches = 0;
  if (batch < 0 || Kt < 0 || M < 0 || n_obs < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0) return 0;
  Matvec a{C, Hpp_inv, Hcc_d, free_w, obs_kf, obs_slot, lm_order, lm_start,
           kf_order, kf_start, Kt, M, n_obs, x, bp, v, Ap};
  constexpr int per = kThreads / 32;  // warps a block
  if (M > 0) {
    pcg_landmark_kernel<<<dim3((M + per - 1) / per, batch), kThreads, 0,
                          stream>>>(a);
    ++*launches;
  }
  if (bp == nullptr && Kt > 0) {
    pcg_keyframe_kernel<<<dim3((Kt + per - 1) / per, batch), kThreads, 0,
                          stream>>>(a);
    ++*launches;
  }
  return static_cast<int>(cudaGetLastError());
}

// K45: Minv (B, Kt, 6, 6), free (B, Kt); the update from x, r, p, Ap (B,
// Kt, 6) and scal (B, 2: rz, pAp), or with Ap NULL the init mode from r =
// rhs (x, p, scal unused). Writes x_out, r_out, p_out and scal_out (rz_new,
// pAp; pAp 0 in the init mode).
PSL_API int psl_pcg_cg_update(const float* Minv, const float* free_w,
                              int batch, int Kt, const float* x,
                              const float* r, const float* p, const float* Ap,
                              const float* scal, float* x_out, float* r_out,
                              float* p_out, float* scal_out,
                              cudaStream_t stream) {
  if (batch < 0 || Kt < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  pcg_cg_kernel<<<batch, kCgThreads, 0, stream>>>(
      Minv, free_w, Kt, x, r, p, Ap, scal, x_out, r_out, p_out, scal_out);
  return static_cast<int>(cudaGetLastError());
}
