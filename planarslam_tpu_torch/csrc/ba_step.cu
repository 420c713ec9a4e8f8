// K33 ba_plane_blocks, K34 ba_cost_test, K35 ba_reduced_system — the parts
// of a bundle-adjustment LM step around K8, K9 and the Cholesky.
//
// Replace the rest of planarslam_tpu/solvers/ba_core.py::ba_solve.step:
//   K33: the plane blocks, _plane_jacs + add_plane_block (:188-215,
//        :407-445): per plane observation (direct, parallel and vertical
//        tables) the residual, the closed-form Jacobians wrt the pose and
//        the plane's chart (ba_core.plane_jacs_closed writes the same
//        formulas), the Huber weight, summed into K8's Hcc, bc, the plane
//        rows of Hpp, bp and the plane columns of Hcp, in place; then the
//        landmark damping floor mu_p (:459-461) in one block, which K9
//        reads from the device;
//   K34: the cost test, all_chi2 twice + robust_decrease + accept (:250-293,
//        :237-248, :492-506): the new state, the robust cost of every
//        point, line-endpoint and plane observation at both states, the
//        decrease summed per keyframe and table, then over keyframes, the
//        tables added in the order pt, ln, pl, par, ver; the finite test,
//        the accept, the selected state and lam, on the device (no host
//        sync); its tables mode writes the per-observation chi2 (the last
//        all_chi2 of ba_solve);
//   K35: the damped reduced system (:459-482 around the Cholesky): Hcc on
//        the diagonal blocks of S, mu_c over the free diagonal, the
//        damping, the fixed poses eliminated (their rows and columns the
//        identity), the right-hand side masked.
// Compiled with -fmad=false: K35 repeats the plain version's operations
// one by one, so it differs from it only through mu_c's summation order.
//
// No float atomics: every sum has one fixed order (a loop in slot order,
// or a strided loop per thread and then a tree). What bounds them on an
// H100 at the GBA size (Kt = 128, F = 1024, 128 line endpoints, 16 planes
// per table, Q = 64, M = 12864): K33 the plane columns of Hcp, read and
// written (590 KB); K34 the tables and the two states (3.9 MB); K35 S read
// and written (4.7 MB). None is near its bound: each is a few launches of
// short, latency-bound blocks.
#include "common.cuh"
#include "lie.cuh"

namespace {

constexpr int kRec = 11;  // per row of a plane observation: r, Wv, Jx, Jt

struct PlaneTable {
  const int* slot;
  const float* pi_obs;
  const float* mask;
  int Pp;
  float* rec;  // (Kt, Pp, D, kRec)
};

struct PlaneParams {
  PlaneTable tab[3];
  float info[3][3];  // per kind: the information of each error row
  float gate[3];
  int huber;
};

__device__ __forceinline__ int rows_of(int kind) { return kind == 0 ? 3 : 2; }

__device__ __forceinline__ float huber_w(float chi, float gate, int huber) {
  return (huber && chi > gate) ? sqrtf(gate / fmaxf(chi, 1e-12f)) : 1.0f;
}

__device__ __forceinline__ float rho(float chi, float gate, float mask,
                                     int huber) {
  const float v = (huber && chi > gate)
                      ? 2.0f * sqrtf(gate * fmaxf(chi, 1e-12f)) - gate
                      : chi;
  return v * mask;
}

// One plane observation of keyframe pose T: its rows' records (r, Wv, Jx,
// Jt), as plane_jacs_closed and plane_blocks_plain compute them.
__device__ void plane_obs_terms(int kind, const float* T, const float* base,
                                const float* theta, const float* pi_obs,
                                float mask, const PlaneParams& PP,
                                float* rec) {
  float pi_w[4], b1[3], b2[3], sn;
  psl::plane_retract(base, theta, pi_w, b1, b2, &sn);
  float c[4];
  psl::plane_transform(T, pi_w, c);
  float e[4], r[3], u[2][3];
  const int D = psl::plane_error(kind, c, pi_obs, e, r, u);
  // dc/dx (4 x 9): [rho | phi | theta]
  float dc[4][9];
  for (int k = 0; k < 3; ++k) {
    dc[0][k] = 0.0f;
    dc[1][k] = 0.0f;
    dc[2][k] = 0.0f;
    dc[3][k] = -c[k];
  }
  dc[0][3] = 0.0f;
  dc[1][3] = -c[2];
  dc[2][3] = c[1];
  dc[0][4] = c[2];
  dc[1][4] = 0.0f;
  dc[2][4] = -c[0];
  dc[0][5] = -c[1];
  dc[1][5] = c[0];
  dc[2][5] = 0.0f;
  dc[3][3] = dc[3][4] = dc[3][5] = 0.0f;
  for (int j = 0; j < 2; ++j) {
    const float* bj = j == 0 ? b1 : b2;
    const float nb = psl::dot3(pi_w, bj);
    float dn_w[3];
    for (int k = 0; k < 3; ++k) dn_w[k] = (bj[k] - pi_w[k] * nb) / sn;
    float dn[3];
    for (int i = 0; i < 3; ++i) {
      dn[i] = T[4 * i] * dn_w[0] + T[4 * i + 1] * dn_w[1] +
              T[4 * i + 2] * dn_w[2];
      dc[i][6 + j] = dn[i];
    }
    dc[3][6 + j] = -(dn[0] * T[3] + dn[1] * T[7] + dn[2] * T[11]);
  }
  dc[0][8] = dc[1][8] = dc[2][8] = 0.0f;
  dc[3][8] = 1.0f;
  const float sc = psl::safe_norm3(c);
  const float sgn = c[3] / sc < 0.0f ? -1.0f : 1.0f;
  float de[4][9];
  for (int col = 0; col < 9; ++col) {
    const float nd = c[0] * dc[0][col] + c[1] * dc[1][col] + c[2] * dc[2][col];
    const float f = nd / (sc * sc);
    for (int i = 0; i < 4; ++i) {
      de[i][col] = sgn * (dc[i][col] - c[i] * f) / sc;
    }
  }
  const float* info = PP.info[kind];
  float chi = 0.0f;
  for (int d = 0; d < D; ++d) chi += r[d] * r[d] * info[d];
  const float w = huber_w(chi, PP.gate[kind], PP.huber) * mask;
  for (int d = 0; d < D; ++d) {
    float* o = rec + d * kRec;
    o[0] = r[d];
    o[1] = w * info[d];
    for (int col = 0; col < 9; ++col) {
      float J;
      if (kind == 0 && d == 2) {
        J = de[3][col];
      } else if (kind == 2 && d == 1) {
        J = 0.0f;
      } else {
        J = u[d][0] * de[0][col] + u[d][1] * de[1][col] +
            u[d][2] * de[2][col];
      }
      o[2 + col] = J;
    }
  }
}

__device__ __forceinline__ int sym6(int i, int j) {
  return i * 6 - i * (i - 1) / 2 + (j - i);  // i <= j
}

// K33, pass 1: one block per keyframe. Every plane observation of the
// keyframe writes its records; then Hcc, bc (27 entries) and the plane
// columns of Hcp (Q x 18 entries) add their sums, each over the tables in
// the order direct, parallel, vertical and within a table in p order.
// Problem b's tables and records of a batch (blockIdx.y): each array of
// the batch holds B problems of one shape, one after the other.
__device__ __forceinline__ PlaneParams plane_problem(const PlaneParams& PP,
                                                     int b, int Kt) {
  PlaneParams out = PP;
  for (int t = 0; t < 3; ++t) {
    const size_t n = static_cast<size_t>(b) * Kt * PP.tab[t].Pp;
    out.tab[t].slot += n;
    out.tab[t].pi_obs += 4 * n;
    out.tab[t].mask += n;
    if (out.tab[t].rec != nullptr) out.tab[t].rec += n * rows_of(t) * kRec;
  }
  return out;
}

__global__ void plane_kf_kernel(const float* __restrict__ poses,
                                const float* __restrict__ base,
                                const float* __restrict__ theta, int Kt,
                                int Q, int P, int M, const PlaneParams PP0,
                                float* __restrict__ Hcc,
                                float* __restrict__ bc,
                                float* __restrict__ Hcp) {
  const int k = blockIdx.x, b = blockIdx.y;
  const PlaneParams PP = plane_problem(PP0, b, Kt);
  poses += static_cast<size_t>(b) * 16 * Kt;
  base += static_cast<size_t>(b) * 4 * Q;
  theta += static_cast<size_t>(b) * 3 * Q;
  Hcc += static_cast<size_t>(b) * 36 * Kt;
  bc += static_cast<size_t>(b) * 6 * Kt;
  if (Hcp != nullptr) Hcp += static_cast<size_t>(b) * Kt * 18 * M;
  __shared__ float T[16];
  if (threadIdx.x < 16) T[threadIdx.x] = poses[16 * k + threadIdx.x];
  __syncthreads();
  for (int kind = 0; kind < 3; ++kind) {
    const PlaneTable& tb = PP.tab[kind];
    const int D = rows_of(kind);
    for (int p = threadIdx.x; p < tb.Pp; p += blockDim.x) {
      const int o = k * tb.Pp + p;
      const int q = tb.slot[o];
      plane_obs_terms(kind, T, base + 4 * q, theta + 3 * q,
                      tb.pi_obs + 4 * o, tb.mask[o], PP,
                      tb.rec + static_cast<size_t>(o) * D * kRec);
    }
  }
  __syncthreads();
  const int n_hcp = Hcp != nullptr ? Q * 18 : 0;
  for (int e = threadIdx.x; e < 27 + n_hcp; e += blockDim.x) {
    int i, j, q = -1;
    if (e < 21) {
      i = 0;
      while (e >= sym6(i, 5) + 1) ++i;
      j = i + (e - sym6(i, i));
    } else if (e < 27) {
      i = e - 21;
      j = -1;
    } else {
      q = (e - 27) / 18;
      i = ((e - 27) % 18) / 3;
      j = (e - 27) % 3;
    }
    float v;
    if (e < 21) {
      v = Hcc[36 * k + 6 * i + j];
    } else if (e < 27) {
      v = bc[6 * k + i];
    } else {
      v = Hcp[(static_cast<size_t>(k * 6 + i) * M + P + q) * 3 + j];
    }
    for (int kind = 0; kind < 3; ++kind) {
      const PlaneTable& tb = PP.tab[kind];
      if (tb.Pp == 0) continue;
      const int D = rows_of(kind);
      float s = 0.0f;
      for (int p = 0; p < tb.Pp; ++p) {
        const int o = k * tb.Pp + p;
        if (q >= 0 && tb.slot[o] != q) continue;
        const float* rec = tb.rec + static_cast<size_t>(o) * D * kRec;
        for (int d = 0; d < D; ++d) {
          const float* x = rec + d * kRec;
          if (e < 21) {
            s += x[2 + i] * x[1] * x[2 + j];
          } else if (e < 27) {
            s += x[2 + i] * (x[0] * x[1]);
          } else {
            s += x[2 + i] * x[1] * x[8 + j];
          }
        }
      }
      v = v + s;
    }
    if (e < 21) {
      Hcc[36 * k + 6 * i + j] = v;
      Hcc[36 * k + 6 * j + i] = v;
    } else if (e < 27) {
      bc[6 * k + i] = v;
    } else {
      Hcp[(static_cast<size_t>(k * 6 + i) * M + P + q) * 3 + j] = v;
    }
  }
}

constexpr int kPlThreads = 256;

// K33, pass 2: one block per plane. Its 6 + 3 entries of Hpp and bp add,
// per table in the order direct, parallel, vertical, the sum over the
// observations of the plane: each thread sums a contiguous run of (k, p)
// in order, then a fixed tree over the threads.
__global__ void __launch_bounds__(kPlThreads)
    plane_lm_kernel(int Kt, int P, int M, const PlaneParams PP0,
                    float* __restrict__ Hpp, float* __restrict__ bp) {
  const int q = blockIdx.x, b = blockIdx.y;
  const PlaneParams PP = plane_problem(PP0, b, Kt);
  Hpp += static_cast<size_t>(b) * 9 * M;
  bp += static_cast<size_t>(b) * 3 * M;
  __shared__ float red[kPlThreads][9];
  float out[9];
  for (int c = 0; c < 9; ++c) {
    const int i = c < 6 ? (c < 3 ? 0 : (c < 5 ? 1 : 2)) : c - 6;
    const int j = c < 3 ? c : (c < 5 ? c - 2 : 2);
    out[c] = c < 6 ? Hpp[9 * (P + q) + 3 * i + j] : bp[3 * (P + q) + i];
  }
  for (int kind = 0; kind < 3; ++kind) {
    const PlaneTable& tb = PP.tab[kind];
    if (tb.Pp == 0) continue;
    const int D = rows_of(kind);
    const int n = Kt * tb.Pp;
    const int run = (n + kPlThreads - 1) / kPlThreads;
    float acc[9];
    for (int c = 0; c < 9; ++c) acc[c] = 0.0f;
    const int lo = threadIdx.x * run;
    const int hi = min(n, lo + run);
    for (int o = lo; o < hi; ++o) {
      if (tb.slot[o] != q) continue;
      const float* rec = tb.rec + static_cast<size_t>(o) * D * kRec;
      for (int d = 0; d < D; ++d) {
        const float* x = rec + d * kRec;
        int c = 0;
        for (int i = 0; i < 3; ++i) {
          for (int j = i; j < 3; ++j, ++c) acc[c] += x[8 + i] * x[1] * x[8 + j];
        }
        for (int i = 0; i < 3; ++i) acc[6 + i] += x[8 + i] * (x[0] * x[1]);
      }
    }
    for (int c = 0; c < 9; ++c) red[threadIdx.x][c] = acc[c];
    __syncthreads();
    for (int half = kPlThreads / 2; half > 0; half >>= 1) {
      if (threadIdx.x < half) {
        for (int c = 0; c < 9; ++c) {
          red[threadIdx.x][c] += red[threadIdx.x + half][c];
        }
      }
      __syncthreads();
    }
    for (int c = 0; c < 9; ++c) out[c] = out[c] + red[0][c];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    int c = 0;
    for (int i = 0; i < 3; ++i) {
      for (int j = i; j < 3; ++j, ++c) {
        Hpp[9 * (P + q) + 3 * i + j] = out[c];
        Hpp[9 * (P + q) + 3 * j + i] = out[c];
      }
    }
    for (int i = 0; i < 3; ++i) bp[3 * (P + q) + i] = out[6 + i];
  }
}

constexpr int kMuThreads = 1024;

// K33's last pass (ba_core._mu_p): the sum of Hpp's diagonal and the count
// of rows with a positive diagonal sum, strided per thread, then a tree
__global__ void __launch_bounds__(kMuThreads)
    mu_p_kernel(const float* __restrict__ Hpp, int M, float* __restrict__ mu) {
  Hpp += static_cast<size_t>(blockIdx.x) * 9 * M;
  mu += blockIdx.x;
  __shared__ float red_s[kMuThreads];
  __shared__ int red_n[kMuThreads];
  float s = 0.0f;
  int n = 0;
  for (int m = threadIdx.x; m < M; m += kMuThreads) {
    const float d0 = Hpp[9 * m], d1 = Hpp[9 * m + 4], d2 = Hpp[9 * m + 8];
    s += d0;
    s += d1;
    s += d2;
    n += (d0 + d1) + d2 > 0.0f ? 1 : 0;
  }
  red_s[threadIdx.x] = s;
  red_n[threadIdx.x] = n;
  __syncthreads();
  for (int half = kMuThreads / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) {
      red_s[threadIdx.x] += red_s[threadIdx.x + half];
      red_n[threadIdx.x] += red_n[threadIdx.x + half];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    *mu = red_s[0] / static_cast<float>(3 * (red_n[0] + 1));
  }
}

// ---------------------------------------------------------------------------
// K34

struct CostParams {
  const int *pt_slot, *ln_slot;
  const float *pt_uv, *pt_ur, *pt_is2, *pt_mask;
  const float *ln_l2d, *ln_is2, *ln_mask;
  int F, L2, P, Q, M, huber;
  float fx, fy, cx, cy, bf;
  PlaneParams pl;
  float* chi[5];  // tables mode: per-observation chi2 (pt, ln, pl, par, ver)
};

constexpr int kCostThreads = 256;
constexpr int kCostWarps = kCostThreads / 32;
constexpr int kScratchPoses = 0, kScratchSums = 16, kScratchFinite = 21;
constexpr int kScratch = 22;  // per keyframe: new pose, 5 sums, finite

__device__ __forceinline__ void landmark(const float* lm, const float* dxp,
                                         int i, float* x) {
  for (int c = 0; c < 3; ++c) {
    x[c] = dxp != nullptr ? lm[3 * i + c] + dxp[3 * i + c] : lm[3 * i + c];
  }
}

__device__ __forceinline__ float point_chi(const CostParams& C, const float* T,
                                           const float* x, int o) {
  float pc[3];
  for (int i = 0; i < 3; ++i) {
    pc[i] = T[4 * i] * x[0] + T[4 * i + 1] * x[1] + T[4 * i + 2] * x[2] +
            T[4 * i + 3];
  }
  const float z = fmaxf(pc[2], 1e-6f);
  const float u = C.fx * pc[0] / z + C.cx, v = C.fy * pc[1] / z + C.cy;
  const float urh = u - C.bf / z;
  const float r0 = C.pt_uv[2 * o] - u, r1 = C.pt_uv[2 * o + 1] - v;
  const float r2 = C.pt_ur[o] >= 0.0f ? C.pt_ur[o] - urh : 0.0f;
  return (r0 * r0 + r1 * r1 + r2 * r2) * C.pt_is2[o];
}

__device__ __forceinline__ float line_chi(const CostParams& C, const float* T,
                                          const float* x, int o) {
  float pc[3];
  for (int i = 0; i < 3; ++i) {
    pc[i] = T[4 * i] * x[0] + T[4 * i + 1] * x[1] + T[4 * i + 2] * x[2] +
            T[4 * i + 3];
  }
  const float z = fmaxf(pc[2], 1e-6f);
  const float u = C.fx * pc[0] / z + C.cx, v = C.fy * pc[1] / z + C.cy;
  const float r = C.ln_l2d[3 * o] * u + C.ln_l2d[3 * o + 1] * v +
                  C.ln_l2d[3 * o + 2];
  return r * r * C.ln_is2[o];
}

__device__ __forceinline__ float plane_chi(const CostParams& C, int kind,
                                           const float* T, const float* base,
                                           const float* theta, int o) {
  const PlaneTable& tb = C.pl.tab[kind];
  float pi_w[4], b1[3], b2[3], sn;
  psl::plane_retract(base, theta, pi_w, b1, b2, &sn);
  float c[4];
  psl::plane_transform(T, pi_w, c);
  float e[4], r[3], u[2][3];
  const int D = psl::plane_error(kind, c, tb.pi_obs + 4 * o, e, r, u);
  float chi = 0.0f;
  for (int d = 0; d < D; ++d) chi += r[d] * r[d] * C.pl.info[kind][d];
  return chi;
}

// Problem b's tables of a batch (blockIdx.y), as plane_problem
__device__ __forceinline__ CostParams cost_problem(const CostParams& C0,
                                                   int b, int Kt) {
  CostParams C = C0;
  const size_t np = static_cast<size_t>(b) * Kt * C.F;
  const size_t nl = static_cast<size_t>(b) * Kt * C.L2;
  C.pt_slot += np;
  C.pt_uv += 2 * np;
  C.pt_ur += np;
  C.pt_is2 += np;
  C.pt_mask += np;
  C.ln_slot += nl;
  C.ln_l2d += 3 * nl;
  C.ln_is2 += nl;
  C.ln_mask += nl;
  if (C.chi[0] != nullptr) C.chi[0] += np;
  if (C.chi[1] != nullptr) C.chi[1] += nl;
  C.pl = plane_problem(C0.pl, b, Kt);
  for (int t = 0; t < 3; ++t) {
    if (C.chi[2 + t] != nullptr) {
      C.chi[2 + t] += static_cast<size_t>(b) * Kt * C.pl.tab[t].Pp;
    }
  }
  return C;
}

// K34, pass 1: one block per keyframe. Step mode: the keyframe's new pose,
// the decrease of its observations per table (a strided loop per thread,
// then shuffle trees), the finite flag of its dxc row and of its share of
// dxp. Tables mode (dxc NULL): the chi2 of every observation at one state.
__global__ void __launch_bounds__(kCostThreads)
    cost_obs_kernel(int Kt, const float* __restrict__ poses,
                    const float* __restrict__ lm,
                    const float* __restrict__ base,
                    const float* __restrict__ dxc,
                    const float* __restrict__ dxp, const CostParams C0,
                    float* __restrict__ scratch) {
  const int k = blockIdx.x, b = blockIdx.y;
  const bool step = dxc != nullptr;
  const CostParams C = cost_problem(C0, b, Kt);
  poses += static_cast<size_t>(b) * 16 * Kt;
  lm += static_cast<size_t>(b) * 3 * C.M;
  base += static_cast<size_t>(b) * 4 * C.Q;
  if (step) {
    dxc += static_cast<size_t>(b) * 6 * Kt;
    dxp += static_cast<size_t>(b) * 3 * C.M;
    scratch += static_cast<size_t>(b) * kScratch * Kt;
  }
  __shared__ float Tc[16], Tn[16];
  __shared__ float warp_sum[kCostWarps][5];
  if (threadIdx.x < 16) Tc[threadIdx.x] = poses[16 * k + threadIdx.x];
  __syncthreads();
  if (step && threadIdx.x == 0) {
    psl::se3_exp_mul(dxc + 6 * k, Tc, Tn);
  }
  __syncthreads();
  float acc[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int f = threadIdx.x; f < C.F; f += kCostThreads) {
    const int o = k * C.F + f;
    const int s = C.pt_slot[o];
    const float gate = C.pt_ur[o] >= 0.0f ? 7.815f : 5.991f;
    float x[3];
    landmark(lm, nullptr, s, x);
    const float chi_c = point_chi(C, Tc, x, o);
    if (!step) {
      C.chi[0][o] = chi_c;
      continue;
    }
    landmark(lm, dxp, s, x);
    const float chi_n = point_chi(C, Tn, x, o);
    acc[0] += rho(chi_n, gate, C.pt_mask[o], C.huber) -
              rho(chi_c, gate, C.pt_mask[o], C.huber);
  }
  for (int l = threadIdx.x; l < C.L2; l += kCostThreads) {
    const int o = k * C.L2 + l;
    const int s = C.ln_slot[o];
    float x[3];
    landmark(lm, nullptr, s, x);
    const float chi_c = line_chi(C, Tc, x, o);
    if (!step) {
      C.chi[1][o] = chi_c;
      continue;
    }
    landmark(lm, dxp, s, x);
    const float chi_n = line_chi(C, Tn, x, o);
    acc[1] += rho(chi_n, 5.991f, C.ln_mask[o], C.huber) -
              rho(chi_c, 5.991f, C.ln_mask[o], C.huber);
  }
  for (int kind = 0; kind < 3 && C.Q > 0; ++kind) {
    const PlaneTable& tb = C.pl.tab[kind];
    for (int p = threadIdx.x; p < tb.Pp; p += kCostThreads) {
      const int o = k * tb.Pp + p;
      const int q = tb.slot[o];
      float th[3];
      landmark(lm, nullptr, C.P + q, th);
      const float chi_c = plane_chi(C, kind, Tc, base + 4 * q, th, o);
      if (!step) {
        C.chi[2 + kind][o] = chi_c;
        continue;
      }
      landmark(lm, dxp, C.P + q, th);
      const float chi_n = plane_chi(C, kind, Tn, base + 4 * q, th, o);
      acc[2 + kind] += rho(chi_n, C.pl.gate[kind], tb.mask[o], C.huber) -
                       rho(chi_c, C.pl.gate[kind], tb.mask[o], C.huber);
    }
  }
  if (!step) return;
  // finite: this keyframe's dxc row and its share of dxp
  const int n3 = 3 * C.M;
  const int share = (n3 + Kt - 1) / Kt;
  bool fin = true;
  for (int i = k * share + threadIdx.x; i < min(n3, (k + 1) * share);
       i += kCostThreads) {
    fin = fin && isfinite(dxp[i]);
  }
  if (threadIdx.x < 6) fin = fin && isfinite(dxc[6 * k + threadIdx.x]);
  const int all_fin = __syncthreads_and(fin);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int t = 0; t < 5; ++t) {
    float v = acc[t];
    for (int off = 16; off > 0; off >>= 1) {
      v += __shfl_down_sync(0xffffffffu, v, off);
    }
    if (lane == 0) warp_sum[warp][t] = v;
  }
  __syncthreads();
  float* out = scratch + kScratch * k;
  if (threadIdx.x < 5) {
    float v = 0.0f;
    for (int w = 0; w < kCostWarps; ++w) v += warp_sum[w][threadIdx.x];
    out[kScratchSums + threadIdx.x] = v;
  }
  if (threadIdx.x < 16) out[kScratchPoses + threadIdx.x] = Tn[threadIdx.x];
  if (threadIdx.x == 0) out[kScratchFinite] = all_fin ? 1.0f : 0.0f;
}

// K34, pass 2: one block sums the per-keyframe decreases of each table (a
// fixed tree over keyframes), adds the tables in the order pt, ln, pl,
// par, ver, and decides: accept, lam.
__global__ void __launch_bounds__(kCostThreads)
    cost_decide_kernel(int Kt, const float* __restrict__ scratch,
                       const float* __restrict__ lam,
                       float* __restrict__ lam_out,
                       unsigned char* __restrict__ accept,
                       float* __restrict__ decrease) {
  const int b = blockIdx.x;
  scratch += static_cast<size_t>(b) * kScratch * Kt;
  lam += b;
  lam_out += b;
  accept += b;
  decrease += b;
  __shared__ float red[kCostThreads][5];
  __shared__ int red_f[kCostThreads];
  float acc[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  int fin = 1;
  for (int k = threadIdx.x; k < Kt; k += kCostThreads) {
    const float* s = scratch + kScratch * k;
    for (int t = 0; t < 5; ++t) acc[t] += s[kScratchSums + t];
    fin = fin && s[kScratchFinite] != 0.0f;
  }
  for (int t = 0; t < 5; ++t) red[threadIdx.x][t] = acc[t];
  red_f[threadIdx.x] = fin;
  __syncthreads();
  for (int half = kCostThreads / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) {
      for (int t = 0; t < 5; ++t) {
        red[threadIdx.x][t] += red[threadIdx.x + half][t];
      }
      red_f[threadIdx.x] = red_f[threadIdx.x] && red_f[threadIdx.x + half];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    float total = 0.0f;
    for (int t = 0; t < 5; ++t) total = total + red[0][t];
    const bool ok = isfinite(total) && red_f[0] != 0;
    const bool acc_step = total < 0.0f && ok;
    const float l = *lam;
    const float nl = acc_step ? l * 0.3f : l * 6.0f;
    *lam_out = fminf(fmaxf(nl, 1e-8f), 1e6f);
    *accept = acc_step ? 1 : 0;
    *decrease = total;
  }
}

// K34, pass 3: the selected state
__global__ void cost_select_kernel(int Kt, int M,
                                   const float* __restrict__ poses,
                                   const float* __restrict__ lm,
                                   const float* __restrict__ dxp,
                                   const float* __restrict__ scratch,
                                   const unsigned char* __restrict__ accept,
                                   float* __restrict__ poses_out,
                                   float* __restrict__ lm_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const size_t b = blockIdx.y;
  poses += b * 16 * Kt;
  poses_out += b * 16 * Kt;
  lm += b * 3 * M;
  dxp += b * 3 * M;
  lm_out += b * 3 * M;
  scratch += b * kScratch * Kt;
  const bool a = accept[b] != 0;
  if (i < 3 * M) {
    lm_out[i] = a ? lm[i] + dxp[i] : lm[i];
  } else if (i < 3 * M + 16 * Kt) {
    const int j = i - 3 * M, k = j / 16;
    poses_out[j] = a ? scratch[kScratch * k + kScratchPoses + j % 16]
                     : poses[j];
  }
}

// ---------------------------------------------------------------------------
// K35

constexpr int kRsThreads = 256;
constexpr int kRsRows = 8;  // rows of S per block

__global__ void __launch_bounds__(kRsThreads)
    reduced_system_kernel(const float* __restrict__ S,
                          const float* __restrict__ Hcc,
                          const float* __restrict__ rhs,
                          const float* __restrict__ lam,
                          const float* __restrict__ fixed, int Kt,
                          float* __restrict__ S_out,
                          float* __restrict__ rhs_vec) {
  const int b = blockIdx.y;
  const int n = 6 * Kt;
  const size_t nn = static_cast<size_t>(n) * n;
  S += b * nn;
  S_out += b * nn;
  Hcc += static_cast<size_t>(b) * 36 * Kt;
  rhs += static_cast<size_t>(b) * n;
  rhs_vec += static_cast<size_t>(b) * n;
  fixed += static_cast<size_t>(b) * Kt;
  const float l = lam[b];
  __shared__ float red_s[kRsThreads], red_f[kRsThreads];
  // mu_c over the diagonal with Hcc added, in one order for every block
  float s = 0.0f, f = 0.0f;
  for (int i = threadIdx.x; i < n; i += kRsThreads) {
    const int k = i / 6, a = i % 6;
    const float free_i = 1.0f - fixed[k];
    const float d = S[static_cast<size_t>(i) * n + i] + Hcc[36 * k + 7 * a];
    s += d * free_i;
    f += free_i;
  }
  red_s[threadIdx.x] = s;
  red_f[threadIdx.x] = f;
  __syncthreads();
  for (int half = kRsThreads / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) {
      red_s[threadIdx.x] += red_s[threadIdx.x + half];
      red_f[threadIdx.x] += red_f[threadIdx.x + half];
    }
    __syncthreads();
  }
  const float mu_c = red_s[0] / (red_f[0] + 1.0f);
  const float floor_c = l * mu_c + 1e-8f;
  const int r0 = blockIdx.x * kRsRows;
  for (int e = threadIdx.x; e < kRsRows * n; e += kRsThreads) {
    const int i = r0 + e / n, j = e % n;
    if (i >= n) break;
    const size_t ij = static_cast<size_t>(i) * n + j;
    const int ki = i / 6, kj = j / 6;
    float v = S[ij];
    if (ki == kj) v = v + Hcc[36 * ki + 6 * (i % 6) + j % 6];
    const float fi = 1.0f - fixed[ki], fj = 1.0f - fixed[kj];
    // S + lam diag(diag_S) + (lam mu_c + 1e-8) I, then the elimination
    float a = v + (i == j ? l * v : 0.0f);
    a = a + (i == j ? floor_c : 0.0f);
    a = a * fi * fj;
    a = a + (i == j ? 1.0f - fi : 0.0f);
    S_out[ij] = a;
  }
  if (blockIdx.x == 0) {
    for (int i = threadIdx.x; i < n; i += kRsThreads) {
      rhs_vec[i] = rhs[i] * (1.0f - fixed[i / 6]);
    }
  }
}

PlaneParams plane_params(const int* const* slot, const float* const* pi,
                         const float* const* mask, const int* Pp,
                         float* const* rec, float angle_info, float dis_info,
                         float par_info, float ver_info, float plane_chi,
                         float vp_chi, int huber) {
  PlaneParams PP;
  for (int t = 0; t < 3; ++t) {
    PP.tab[t] = PlaneTable{slot[t], pi[t], mask[t], Pp[t],
                           rec != nullptr ? rec[t] : nullptr};
  }
  const float info[3][3] = {{angle_info, angle_info, dis_info},
                            {par_info, par_info, 0.0f},
                            {ver_info, ver_info, 0.0f}};
  for (int t = 0; t < 3; ++t) {
    for (int d = 0; d < 3; ++d) PP.info[t][d] = info[t][d];
  }
  PP.gate[0] = plane_chi;
  PP.gate[1] = vp_chi;
  PP.gate[2] = vp_chi;
  PP.huber = huber;
  return PP;
}

}  // namespace

PSL_API int psl_ba_plane_blocks(
    const float* poses, const float* base, const float* theta, int batch,
    int Kt, int Q, int P, int M, const int* slot0, const float* pi0,
    const float* mask0,
    int Pp0, float* rec0, const int* slot1, const float* pi1,
    const float* mask1, int Pp1, float* rec1, const int* slot2,
    const float* pi2, const float* mask2, int Pp2, float* rec2,
    float angle_info, float dis_info, float par_info, float ver_info,
    float plane_chi, float vp_chi, int huber, float* Hcc, float* bc,
    float* Hpp, float* bp, float* Hcp, cudaStream_t stream) {
  if (batch <= 0 || Kt <= 0 || Q <= 0) return 0;
  const int* slot[3] = {slot0, slot1, slot2};
  const float* pi[3] = {pi0, pi1, pi2};
  const float* mask[3] = {mask0, mask1, mask2};
  const int Pp[3] = {Pp0, Pp1, Pp2};
  float* rec[3] = {rec0, rec1, rec2};
  const PlaneParams PP = plane_params(slot, pi, mask, Pp, rec, angle_info,
                                      dis_info, par_info, ver_info, plane_chi,
                                      vp_chi, huber);
  plane_kf_kernel<<<dim3(Kt, batch), 128, 0, stream>>>(
      poses, base, theta, Kt, Q, P, M, PP, Hcc, bc, Hcp);
  plane_lm_kernel<<<dim3(Q, batch), kPlThreads, 0, stream>>>(Kt, P, M, PP,
                                                              Hpp, bp);
  return static_cast<int>(cudaGetLastError());
}

PSL_API int psl_ba_mu_p(const float* Hpp, int batch, int M, float* mu,
                        cudaStream_t stream) {
  if (batch <= 0) return 0;
  mu_p_kernel<<<batch, kMuThreads, 0, stream>>>(Hpp, M, mu);
  return static_cast<int>(cudaGetLastError());
}

PSL_API int psl_ba_cost_test(
    const float* poses, const float* lm, const float* base, int batch, int Kt,
    int P, int Q, int M, const int* pt_slot, const float* pt_uv,
    const float* pt_ur,
    const float* pt_is2, const float* pt_mask, int F, const int* ln_slot,
    const float* ln_l2d, const float* ln_is2, const float* ln_mask, int L2,
    const int* slot0, const float* pi0, const float* mask0, int Pp0,
    const int* slot1, const float* pi1, const float* mask1, int Pp1,
    const int* slot2, const float* pi2, const float* mask2, int Pp2,
    float fx, float fy, float cx, float cy, float bf, float angle_info,
    float dis_info, float par_info, float ver_info, float plane_chi,
    float vp_chi, int huber, const float* dxc, const float* dxp,
    const float* lam, float* poses_out, float* lm_out, float* lam_out,
    unsigned char* accept, float* decrease, float* scratch, float* chi_pt,
    float* chi_ln, float* chi_pl, float* chi_par, float* chi_ver,
    cudaStream_t stream) {
  if (batch <= 0 || Kt <= 0) return 0;
  const int* slot[3] = {slot0, slot1, slot2};
  const float* pi[3] = {pi0, pi1, pi2};
  const float* mask[3] = {mask0, mask1, mask2};
  const int Pp[3] = {Q > 0 ? Pp0 : 0, Q > 0 ? Pp1 : 0, Q > 0 ? Pp2 : 0};
  CostParams C;
  C.pt_slot = pt_slot;
  C.ln_slot = ln_slot;
  C.pt_uv = pt_uv;
  C.pt_ur = pt_ur;
  C.pt_is2 = pt_is2;
  C.pt_mask = pt_mask;
  C.ln_l2d = ln_l2d;
  C.ln_is2 = ln_is2;
  C.ln_mask = ln_mask;
  C.F = F;
  C.L2 = L2;
  C.P = P;
  C.Q = Q;
  C.M = M;
  C.huber = huber;
  C.fx = fx;
  C.fy = fy;
  C.cx = cx;
  C.cy = cy;
  C.bf = bf;
  C.pl = plane_params(slot, pi, mask, Pp, nullptr, angle_info, dis_info,
                      par_info, ver_info, plane_chi, vp_chi, huber);
  C.chi[0] = chi_pt;
  C.chi[1] = chi_ln;
  C.chi[2] = chi_pl;
  C.chi[3] = chi_par;
  C.chi[4] = chi_ver;
  cost_obs_kernel<<<dim3(Kt, batch), kCostThreads, 0, stream>>>(
      Kt, poses, lm, base, dxc, dxp, C, scratch);
  if (dxc != nullptr) {
    cost_decide_kernel<<<batch, kCostThreads, 0, stream>>>(
        Kt, scratch, lam, lam_out, accept, decrease);
    const int n = 3 * M + 16 * Kt;
    cost_select_kernel<<<dim3((n + 255) / 256, batch), 256, 0, stream>>>(
        Kt, M, poses, lm, dxp, scratch, accept, poses_out, lm_out);
  }
  return static_cast<int>(cudaGetLastError());
}

PSL_API int psl_ba_reduced_system(const float* S, const float* Hcc,
                                  const float* rhs, const float* lam,
                                  const float* fixed, int batch, int Kt,
                                  float* S_out, float* rhs_vec,
                                  cudaStream_t stream) {
  if (batch <= 0 || Kt <= 0) return 0;
  const int n = 6 * Kt;
  const dim3 grid((n + kRsRows - 1) / kRsRows, batch);
  reduced_system_kernel<<<grid, kRsThreads, 0, stream>>>(
      S, Hcc, rhs, lam, fixed, Kt, S_out, rhs_vec);
  return static_cast<int>(cudaGetLastError());
}
