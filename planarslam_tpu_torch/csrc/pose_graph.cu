// K10 pose_graph_normal_eqs — edge residuals, Jacobians and the dense
// normal equations of one pose-graph Gauss-Newton step; K41
// pose_graph_update — the step's SE(3) update of every keyframe.
//
// K10 replaces planarslam_tpu/solvers/pose_graph.py::_optimize.step :44-72
// (jax.jacfwd of edge_res, vmapped over the edges, the block scatter into
// H (6N, 6N) and g (6N) and the gauge diagonal). Per edge e = (i, j), in
// float64:
//   A = T_i T_j^-1,  r0 = log(m_inv A),  r = w r0,
//   J_i = w Jr^-1(r0) Ad(A^-1),  J_j = -w Jr^-1(r0)
// (analytic form of the jacfwd at xi = 0; se3_log and Jr^-1 follow
// planarslam_tpu_torch/geometry/se3.py line by line).
// pose_graph_edge_kernel writes r, J_i, J_j to scratch;
// pose_graph_block_kernel gives every (row node, column node) block of H
// one thread block, which finds its terms in the host-built plan (an
// edge's four blocks (i, i), (j, j), (i, j), (j, i), stably sorted) by a
// binary search of the block's key and adds them in the plan's order: no
// atomics, and a repeated pair adds. Diagonal blocks also sum g = J^T r.
// Every entry of H and g is written, a block without terms as 0; with a
// fixed mask the epilogue adds the gauge diagonal as the port adds it:
// float32(sum) + (fixed * 1e8f + 1e-6f), each operation rounded.
// What bounds it on an H100: launch; the work is E x 24 KFLOP in fp64
// and the writes are H (4 (6N)^2 bytes).
//
// K41 replaces pose_graph.py:75 (vmap(se3_exp)(dx) @ poses): a thread a
// keyframe computes se3_exp(-step) T in float32 (lie.cuh::se3_exp_mul,
// the port's se3.se3_exp spelled in its order, with its small-angle
// branch below theta^2 = 1e-8); the sign of the port's dx = -solve(H, g)
// is folded in. Built with -fmad=false. A leading batch is more threads.
#include <math.h>

#include "common.cuh"
#include "lie.cuh"

namespace {

constexpr int kEdgeThreads = 128;
constexpr int kScr = 78;  // r (6), J_i (36), J_j (36)

__device__ void mat3_mul(const double* a, const double* b, double* c) {
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) {
      c[3 * i + j] = a[3 * i] * b[j] + a[3 * i + 1] * b[3 + j] +
                     a[3 * i + 2] * b[6 + j];
    }
  }
}

__device__ void hat3(const double* v, double* h) {
  h[0] = 0.0;   h[1] = -v[2]; h[2] = v[1];
  h[3] = v[2];  h[4] = 0.0;   h[5] = -v[0];
  h[6] = -v[1]; h[7] = v[0];  h[8] = 0.0;
}

// rigid 4x4 (row-major, float) -> R (3x3) and t, double
__device__ void load_rt(const float* T, double* R, double* t) {
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) R[3 * i + j] = T[4 * i + j];
    t[i] = T[4 * i + 3];
  }
}

// (R1, t1) (R2, t2)^-1
__device__ void mul_inv(const double* R1, const double* t1, const double* R2,
                        const double* t2, double* R, double* t) {
  double R2t[9];
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) R2t[3 * i + j] = R2[3 * j + i];
  }
  mat3_mul(R1, R2t, R);
  for (int i = 0; i < 3; ++i) {
    t[i] = t1[i] - (R[3 * i] * t2[0] + R[3 * i + 1] * t2[1] +
                    R[3 * i + 2] * t2[2]);
  }
}

// se3.so3_log
__device__ void so3_log(const double* R, double* phi) {
  const double kPi = 3.14159265358979323846;
  const double trace = R[0] + R[4] + R[8];
  const double cos_t = fmin(fmax((trace - 1.0) * 0.5, -1.0), 1.0);
  const double w[3] = {R[7] - R[5], R[2] - R[6], R[3] - R[1]};
  const double sin_t = 0.5 * sqrt(w[0] * w[0] + w[1] * w[1] + w[2] * w[2] +
                                  1e-8);
  const double theta = atan2(sin_t, cos_t);
  if (theta > kPi - 1e-3) {
    const double diag[3] = {R[0], R[4], R[8]};
    for (int i = 0; i < 3; ++i) {
      const double a2 = fmax((diag[i] - cos_t) / fmax(1.0 - cos_t, 1e-8), 0.0);
      phi[i] = sqrt(a2) * (w[i] >= 0.0 ? 1.0 : -1.0) * theta;
    }
    return;
  }
  const double scale = sin_t < 1e-4 ? 0.5 + theta * theta / 12.0
                                    : theta / (2.0 * sin_t);
  for (int i = 0; i < 3; ++i) phi[i] = scale * w[i];
}

// se3._so3_left_jacobian
__device__ void so3_jl(const double* phi, double* J) {
  const double th2 = phi[0] * phi[0] + phi[1] * phi[1] + phi[2] * phi[2];
  const double th = sqrt(th2 + 1e-8);
  double a = (1.0 - cos(th)) / fmax(th2, 1e-8);
  double b = (th - sin(th)) / (fmax(th2, 1e-8) * th);
  if (th2 < 1e-8) {
    a = 0.5 - th2 / 24.0;
    b = 1.0 / 6.0 - th2 / 120.0;
  }
  double K[9], K2[9];
  hat3(phi, K);
  mat3_mul(K, K, K2);
  for (int c = 0; c < 9; ++c) {
    J[c] = (c % 4 == 0 ? 1.0 : 0.0) + a * K[c] + b * K2[c];
  }
}

__device__ void solve3(const double* a, const double* y, double* x) {
  const double c00 = a[4] * a[8] - a[5] * a[7];
  const double c01 = a[5] * a[6] - a[3] * a[8];
  const double c02 = a[3] * a[7] - a[4] * a[6];
  const double det = a[0] * c00 + a[1] * c01 + a[2] * c02;
  const double inv[9] = {c00, a[2] * a[7] - a[1] * a[8],
                         a[1] * a[5] - a[2] * a[4], c01,
                         a[0] * a[8] - a[2] * a[6], a[2] * a[3] - a[0] * a[5],
                         c02, a[1] * a[6] - a[0] * a[7],
                         a[0] * a[4] - a[1] * a[3]};
  for (int i = 0; i < 3; ++i) {
    x[i] = (inv[3 * i] * y[0] + inv[3 * i + 1] * y[1] + inv[3 * i + 2] * y[2]) /
           det;
  }
}

// se3.se3_left_jacobian_inv at xi = [rho, phi] -> J (6x6 row-major)
__device__ void se3_jl_inv(const double* rho, const double* phi, double* J) {
  const double th2 = phi[0] * phi[0] + phi[1] * phi[1] + phi[2] * phi[2];
  const double t2 = fmax(th2, 1e-12);
  const double th = sqrt(t2);
  const bool small = th2 < 1e-4;
  const double s = sin(th), c = cos(th);
  const double a1 = small ? 1.0 / 6.0 - th2 / 120.0 : (th - s) / (t2 * th);
  const double a2 = small ? 1.0 / 24.0 - th2 / 720.0
                          : (th2 + 2.0 * c - 2.0) / (2.0 * t2 * t2);
  const double a3 = small ? 1.0 / 120.0 - th2 / 2520.0
                          : (2.0 * th - 3.0 * s + th * c) /
                                (2.0 * t2 * t2 * th);
  const double cj = small ? 1.0 / 12.0 + th2 / 720.0
                          : 1.0 / t2 - (1.0 + c) / (2.0 * th * s);
  double P[9], Rh[9], PR[9], RP[9], PRP[9], PP[9], tmp1[9], tmp2[9];
  hat3(phi, P);
  hat3(rho, Rh);
  mat3_mul(P, Rh, PR);
  mat3_mul(Rh, P, RP);
  mat3_mul(PR, P, PRP);
  mat3_mul(P, P, PP);
  double Q[9];
  mat3_mul(P, PR, tmp1);    // P PR
  mat3_mul(RP, P, tmp2);    // RP P
  double t3[9], t4[9];
  mat3_mul(PRP, P, t3);     // PRP P
  mat3_mul(P, PRP, t4);     // P PRP
  for (int k = 0; k < 9; ++k) {
    Q[k] = 0.5 * Rh[k] + a1 * (PR[k] + RP[k] + PRP[k]) +
           a2 * (tmp1[k] + tmp2[k] - 3.0 * PRP[k]) + a3 * (t3[k] + t4[k]);
  }
  double Ji[9];
  for (int k = 0; k < 9; ++k) {
    Ji[k] = (k % 4 == 0 ? 1.0 : 0.0) - 0.5 * P[k] + cj * PP[k];
  }
  double JQ[9], JQJ[9];
  mat3_mul(Ji, Q, JQ);
  mat3_mul(JQ, Ji, JQJ);
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) {
      J[6 * i + j] = Ji[3 * i + j];
      J[6 * i + 3 + j] = -JQJ[3 * i + j];
      J[6 * (3 + i) + j] = 0.0;
      J[6 * (3 + i) + 3 + j] = Ji[3 * i + j];
    }
  }
}

__global__ void pose_graph_edge_kernel(const float* __restrict__ poses,
                                       const int* __restrict__ edges,
                                       const float* __restrict__ meas_inv,
                                       const float* __restrict__ w_e, int E,
                                       double* __restrict__ scratch) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  const int i = edges[2 * e], j = edges[2 * e + 1];
  double Ri[9], ti[3], Rj[9], tj[3], Rm[9], tm[3];
  load_rt(poses + 16 * i, Ri, ti);
  load_rt(poses + 16 * j, Rj, tj);
  load_rt(meas_inv + 16 * e, Rm, tm);
  double RA[9], tA[3];
  mul_inv(Ri, ti, Rj, tj, RA, tA);  // A = T_i T_j^-1
  double RE[9], tE[3];
  mat3_mul(Rm, RA, RE);
  for (int a = 0; a < 3; ++a) {
    tE[a] = Rm[3 * a] * tA[0] + Rm[3 * a + 1] * tA[1] + Rm[3 * a + 2] * tA[2] +
            tm[a];
  }
  double phi[3], rho[3], Jl[9];
  so3_log(RE, phi);
  so3_jl(phi, Jl);
  solve3(Jl, tE, rho);
  const double w = w_e[e];
  double* out = scratch + static_cast<size_t>(e) * kScr;
  for (int a = 0; a < 3; ++a) {
    out[a] = w * rho[a];
    out[3 + a] = w * phi[a];
  }
  // Jr^-1(r0) = Jl^-1(-r0)
  const double mrho[3] = {-rho[0], -rho[1], -rho[2]};
  const double mphi[3] = {-phi[0], -phi[1], -phi[2]};
  double Jr[36];
  se3_jl_inv(mrho, mphi, Jr);
  // Ad(A^-1) with A^-1 = se3.T_inv(A) = (RA^T, -RA^T tA), as the plain
  // version forms it (T_j T_i^-1 differs from it where the float32
  // rotations are not exactly orthonormal)
  double RB[9], tB[3], th[9], tR[9];
  for (int a = 0; a < 3; ++a) {
    for (int b = 0; b < 3; ++b) RB[3 * a + b] = RA[3 * b + a];
  }
  for (int a = 0; a < 3; ++a) {
    tB[a] = -(RB[3 * a] * tA[0] + RB[3 * a + 1] * tA[1] +
              RB[3 * a + 2] * tA[2]);
  }
  hat3(tB, th);
  mat3_mul(th, RB, tR);
  double Ad[36];
  for (int a = 0; a < 3; ++a) {
    for (int b = 0; b < 3; ++b) {
      Ad[6 * a + b] = RB[3 * a + b];
      Ad[6 * a + 3 + b] = tR[3 * a + b];
      Ad[6 * (3 + a) + b] = 0.0;
      Ad[6 * (3 + a) + 3 + b] = RB[3 * a + b];
    }
  }
  for (int a = 0; a < 6; ++a) {
    for (int b = 0; b < 6; ++b) {
      double s = 0.0;
      for (int m = 0; m < 6; ++m) s += Jr[6 * a + m] * Ad[6 * m + b];
      out[6 + 6 * a + b] = w * s;
      out[42 + 6 * a + b] = -w * Jr[6 * a + b];
    }
  }
}

// one block per (row node, column node) block of H, blockIdx (column, row)
__global__ void pose_graph_block_kernel(const double* __restrict__ scratch,
                                        const int* __restrict__ order,
                                        const int* __restrict__ seg_start,
                                        const int* __restrict__ seg_key,
                                        int n_seg, int N,
                                        const float* __restrict__ fixed,
                                        float* __restrict__ H,
                                        float* __restrict__ g) {
  const int a = blockIdx.y, b = blockIdx.x, t = threadIdx.x;
  const bool diag = a == b;
  if (t >= 42 || (t >= 36 && !diag)) return;
  const int key = a * N + b;
  int lo = 0, hi = n_seg;  // the first segment whose key is not below
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (seg_key[mid] < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  const bool found = lo < n_seg && seg_key[lo] == key;
  double acc = 0.0;
  const int c0 = found ? seg_start[lo] : 0, c1 = found ? seg_start[lo + 1] : 0;
  for (int c = c0; c < c1; ++c) {
    const int id = order[c];
    const int kind = id & 3;
    const double* row = scratch + static_cast<size_t>(id >> 2) * kScr;
    const double* Ji = row + 6;
    const double* Jj = row + 42;
    if (t < 36) {
      // kinds: 0 (i, i), 1 (j, j), 2 (i, j), 3 (j, i)
      const double* J1 = (kind == 0 || kind == 2) ? Ji : Jj;
      const double* J2 = (kind == 0 || kind == 3) ? Ji : Jj;
      const int bi = t / 6, ci = t % 6;
      for (int m = 0; m < 6; ++m) acc += J1[6 * m + bi] * J2[6 * m + ci];
    } else {
      const double* J = kind == 0 ? Ji : Jj;
      const int gi = t - 36;
      for (int m = 0; m < 6; ++m) acc += J[6 * m + gi] * row[m];
    }
  }
  if (t < 36) {
    float h = static_cast<float>(acc);
    if (diag && t % 7 == 0 && fixed != nullptr) {
      h = __fadd_rn(h, __fadd_rn(__fmul_rn(fixed[a], 1e8f), 1e-6f));
    }
    H[static_cast<size_t>(6 * a + t / 6) * (6 * N) + 6 * b + t % 6] = h;
  } else {
    g[6 * a + (t - 36)] = static_cast<float>(acc);
  }
}

// K41: out[n] = se3_exp(-step[n]) poses[n], n over every pose of the batch
__global__ void pose_update_kernel(const float* __restrict__ poses,
                                   const float* __restrict__ step, int n,
                                   float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float xi[6], T[16], T_new[16];
  for (int c = 0; c < 6; ++c) xi[c] = -step[6 * static_cast<size_t>(i) + c];
  for (int c = 0; c < 16; ++c) T[c] = poses[16 * static_cast<size_t>(i) + c];
  psl::se3_exp_mul(xi, T, T_new);
  for (int c = 0; c < 16; ++c) out[16 * static_cast<size_t>(i) + c] = T_new[c];
}

}  // namespace

PSL_API int psl_pose_graph_normal_eqs(const float* poses, const int* edges,
                                      const float* meas_inv, const float* w,
                                      int E, int N, const int* order,
                                      const int* seg_start,
                                      const int* seg_key, int n_seg,
                                      const float* fixed, double* scratch,
                                      float* H, float* g,
                                      cudaStream_t stream) {
  if (E > 0) {
    pose_graph_edge_kernel<<<(E + kEdgeThreads - 1) / kEdgeThreads,
                             kEdgeThreads, 0, stream>>>(poses, edges,
                                                        meas_inv, w, E,
                                                        scratch);
  }
  if (N > 0) {
    pose_graph_block_kernel<<<dim3(N, N), 64, 0, stream>>>(
        scratch, order, seg_start, seg_key, n_seg, N, fixed, H, g);
  }
  return static_cast<int>(cudaGetLastError());
}

PSL_API int psl_pose_graph_update(const float* poses, const float* step,
                                  int n, float* out, cudaStream_t stream) {
  if (n > 0) {
    pose_update_kernel<<<(n + 127) / 128, 128, 0, stream>>>(poses, step, n,
                                                            out);
  }
  return static_cast<int>(cudaGetLastError());
}
