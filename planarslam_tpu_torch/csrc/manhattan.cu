// K15 manhattan_mean_shift — all rounds of the Manhattan-frame rotation
// refinement from one frame's normals, in one launch of one block.
//
// Replaces planarslam_tpu/ops/manhattan.py::track_manhattan_frame :38-121
// (per round: rotate the normals into the frame, cone membership, per axis
// ms_iters mean-shift steps on the tangent plane, support counts, the
// cross-product completion of one missing axis, re-orthonormalization, the
// ok select). The plain version is
// planarslam_tpu_torch/ops/manhattan.py::track_manhattan_frame_plain; the
// float32 arithmetic follows it operation by operation (eig3.cuh; compiled
// with -fmad=false; expf, sqrtf and IEEE division as PyTorch uses them).
//
// What bounds it on an H100: the latency of iters x (1 + ms_iters)
// dependent steps over N ~ 2k normals (~34 KB, ~1 MFLOP: under a
// microsecond at the card's rates). One block of 512 threads per frame (a
// batch of B frames, every array with a leading B, is one launch of B
// blocks, block b reading frame b at its strides); thread t owns normals
// t, t + 512, ... A round's rotation does not change inside it, so each
// thread rotates its normals once per round and keeps their cones and
// tangent coordinates in registers (kOwned of them, read from device
// memory once for all rounds; a thread recomputes any further ones in each
// pass). A normal votes for at most one axis, so one pass gives the weight
// sums of all three axes; each is summed in float64 by a shuffle tree in
// each warp and a second tree over the warp sums, a fixed order with no
// atomics, so two launches give equal bits.
// The warp trees carry several values in one shuffle (a lane keeps one of
// a pair and sends the other), each value's tree the one a plain
// shfl_down tree gives lane 0; the second trees run one axis to a warp,
// whose lane 0 forms the axis's new centre; the support counts ride in
// the first pass's sums. A pass takes two barriers, after which every
// thread reads the centres. Thread 0 then does the serial tail of the
// round (axes, completion, polar factor).
//
// Optional epilogue (the tracking step's initial pose, replacing
// planarslam_tpu/slam/device_tracker.py:296-299): given T_pred, R_wm and
// the Manhattan switch, thread 0 writes use_manh = enabled && success and
// T_init = T_pred with its rotation replaced by R_cm R_wm^T where use_manh
// holds. Each entry of the product is ((a0 b0 + a1 b1) + a2 b2), the
// order of the plain version, ops/manhattan.py::init_select_plain.
//
// K39 seed_manhattan — the initializer's Manhattan seed, one block per frame
// of a batch. Replaces planarslam_tpu/ops/manhattan.py::
// seed_from_plane_normals (:123-148, jitted) with the direction glue of the
// initializer around it (planarslam_tpu/slam/tracking.py:421-432): the 3D
// line directions and their mask (lifted, valid and longer than 0.1 m),
// their concatenation after the plane normals with the weights (plane
// pixel counts, line responses truncated to int), the weighted arg-max
// (the first index among equals, as torch.argmax), the perpendicular gate
// |n . a0| < 0.2 and its arg-max, the Gram-Schmidt step, the cross product
// and se3.orthonormalize (psl_orthonormalize, eig3.cuh, the polar factor
// K15 runs); it also writes the direction set K15 reads next (the frame's
// normals, then the line directions, as K36 writes it). The plain version
// is ops/manhattan.py::seed_manhattan_plain. The line directions repeat
// K36's float form (|v| = sqrt((v0^2 + v2^2) + v1^2), IEEE division), so
// they equal the plain version's bits; the seed's dot products and norm
// are spelled in a fixed order where the plain version's library calls
// (a matrix-vector product, a sum, the polar factor's products) keep
// theirs, so R_seed is held within 1e-6 of it and the picks and ok
// exactly. Bound: launch latency (~26 KB moved, ~1k operations). Design:
// all threads stage the candidates and copy the normals; warp 0 takes the
// two arg-maxes by warp reductions of (weight, -index) and lane 0 the
// serial tail.
#include <math.h>

#include "common.cuh"
#include "eig3.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kOwned = 5;  // normals a thread keeps: N <= 2560 in registers
// warp_buf's value rows: 9 weight sums, then 3 support counts and a zero
// (stored by the 4-value tree, never summed)
constexpr int kBufValues = 13;
constexpr unsigned kFull = 0xffffffffu;

// The first level of a block sum: the 32-lane tree of each of P values
// (P a power of two, <= 8) in this warp, stored at buf[(base + k) *
// kWarps + warp]. At each of the first log2(P) levels a lane keeps one
// value of each pair and sends the other to the lane `off` away, which
// keeps that one, so P values take the shuffles of one; what a lane holds
// is still the sum a shfl_down tree holds at the same lane, since a + b =
// b + a in IEEE arithmetic.
template <int P>
__device__ __forceinline__ void warp_tree(const double* v, int base,
                                          double* buf) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  double x[P];
#pragma unroll
  for (int k = 0; k < P; ++k) x[k] = v[k];
  int off = 16, k_lane = 0;
#pragma unroll
  for (int bit = 0; (1 << bit) < P; ++bit) {
    const bool hi = (lane & off) != 0;
#pragma unroll
    for (int m = 0; m < (P >> (bit + 1)); ++m) {
      const double keep = hi ? x[2 * m + 1] : x[2 * m];
      const double send = hi ? x[2 * m] : x[2 * m + 1];
      x[m] = keep + __shfl_xor_sync(kFull, send, off);
    }
    k_lane |= (hi ? 1 : 0) << bit;
    off >>= 1;
  }
  double s = x[0];
  for (; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
  if ((lane & (32 / P - 1)) == 0) buf[(base + k_lane) * kWarps + warp] = s;
}

// The second level for values v0, v0 + 1, v0 + 2: each the tree of lanes
// 0..31 over the warps' sums (lanes past kWarps adding 0), at lane 0.
__device__ __forceinline__ void warp_sums3(const double* buf, int v0,
                                           double* s) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    s[j] = lane < kWarps ? buf[(v0 + j) * kWarps + lane] : 0.0;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int j = 0; j < 3; ++j) s[j] += __shfl_down_sync(kFull, s[j], off);
  }
}

// One normal in the frame R (row-major, columns = axes): the axis whose
// cone holds it (or -1) and its tangent-plane coordinates (u, v) there.
__device__ __forceinline__ int cone_of(const float* R, const float* n,
                                       bool valid, float cos_half, float* u,
                                       float* v) {
  float nm[3];
  for (int k = 0; k < 3; ++k) {
    nm[k] = n[0] * R[k] + n[1] * R[3 + k] + n[2] * R[6 + k];
  }
  int best = 0;
  float best_val = fabsf(nm[0]);
  for (int k = 1; k < 3; ++k) {
    if (fabsf(nm[k]) > best_val) {
      best_val = fabsf(nm[k]);
      best = k;
    }
  }
  if (!(best_val > cos_half) || !valid) return -1;
  const int i = (best + 1) % 3, j = (best + 2) % 3;
  const float s = nm[best] >= 0.0f ? 1.0f : -1.0f;
  const float denom = fmaxf(best_val, 1e-6f);
  *u = s * nm[i] / denom;
  *v = s * nm[j] / denom;
  return best;
}

// One normal's mean-shift terms, added to acc[3 k ..] of its axis k: the
// weight once, then three predicated sums (no divergent branch per axis).
__device__ __forceinline__ void add_weight(int k, float u, float v,
                                           const float (&c)[3][2],
                                           float kernel, double* acc) {
  if (k < 0) return;
  const float c0 = k == 0 ? c[0][0] : (k == 1 ? c[1][0] : c[2][0]);
  const float c1 = k == 0 ? c[0][1] : (k == 1 ? c[1][1] : c[2][1]);
  const float du = u - c0, dv = v - c1;
  const float d2 = du * du + dv * dv;
  const float wgt = expf(-kernel * d2);
  const double w = wgt, wu = wgt * u, wv = wgt * v;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    if (k == a) {
      acc[3 * a] += w;
      acc[3 * a + 1] += wu;
      acc[3 * a + 2] += wv;
    }
  }
}

struct InitSelect {
  const float* T_pred;               // (B, 4, 4), or NULL: no epilogue
  const float* R_wm;                 // (B, 3, 3)
  const unsigned char* enabled;      // (B,)
  float* T_init;                     // (B, 4, 4)
  unsigned char* use_manh;           // (B,)
};

// The epilogue for one frame, by thread 0 after the last round.
__device__ __forceinline__ void init_select(const InitSelect& e, int f,
                                            const float* R_cm, bool ok) {
  const float* T = e.T_pred + 16 * f;
  const float* W = e.R_wm + 9 * f;
  const bool use = e.enabled[f] != 0 && ok;
  float* out = e.T_init + 16 * f;
  for (int q = 0; q < 16; ++q) out[q] = T[q];
  if (use) {
    for (int i = 0; i < 3; ++i) {
      for (int j = 0; j < 3; ++j) {
        out[4 * i + j] = psl_dot3(R_cm + 3 * i, W + 3 * j);
      }
    }
  }
  e.use_manh[f] = use ? 1 : 0;
}

__global__ void __launch_bounds__(kThreads, 1)
    manhattan_kernel(const float* R_init, const float* normals,
                     const unsigned char* valid, int N, float cos_half,
                     float kernel, int min_support, int iters, int ms_iters,
                     float* R_out, long long* support_out,
                     long long* n_axes_out, unsigned char* success_out,
                     const InitSelect sel) {
  __shared__ float R[9];
  const int frame = blockIdx.x;
  {  // this block's frame
    const size_t f = frame;
    R_init += 9 * f;
    normals += 3 * f * N;
    valid += f * N;
    R_out += 9 * f;
    support_out += 3 * f;
    n_axes_out += f;
    success_out += f;
  }
  __shared__ double warp_buf[kBufValues * kWarps];
  __shared__ float s_center[3][2];
  __shared__ long long s_supp[3];
  const int tid = threadIdx.x;
  if (tid < 9) R[tid] = R_init[tid];
  // the owned normals, read once for all rounds
  float own[kOwned][3];
  bool own_ok[kOwned];
#pragma unroll
  for (int j = 0; j < kOwned; ++j) {
    const int i = tid + j * kThreads;
    own_ok[j] = i < N && valid[i] != 0;
    for (int q = 0; q < 3; ++q) {
      own[j][q] = i < N ? normals[3 * i + q] : 0.0f;
    }
  }
  __syncthreads();

  for (int rnd = 0; rnd < iters; ++rnd) {
    float Rr[9];
    for (int q = 0; q < 9; ++q) Rr[q] = R[q];
    // cone pass: the owned normals' cones and (u, v) in this round's frame,
    // and the support counts (whole numbers: exact in float64)
    int ck[kOwned];
    float cu[kOwned], cv[kOwned];
    double cnt[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll
    for (int j = 0; j < kOwned; ++j) {
      cu[j] = cv[j] = 0.0f;
      ck[j] = cone_of(Rr, own[j], own_ok[j], cos_half, &cu[j], &cv[j]);
    }
    for (int i = tid + kOwned * kThreads; i < N; i += kThreads) {
      float u, v;
      const int k = cone_of(Rr, normals + 3 * i, valid[i] != 0, cos_half,
                            &u, &v);
      cnt[0] += k == 0 ? 1.0 : 0.0;
      cnt[1] += k == 1 ? 1.0 : 0.0;
      cnt[2] += k == 2 ? 1.0 : 0.0;
    }
#pragma unroll
    for (int j = 0; j < kOwned; ++j) {
      cnt[0] += ck[j] == 0 ? 1.0 : 0.0;
      cnt[1] += ck[j] == 1 ? 1.0 : 0.0;
      cnt[2] += ck[j] == 2 ? 1.0 : 0.0;
    }
    float c[3][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}, {0.0f, 0.0f}};

    for (int ms = 0; ms < (ms_iters > 0 ? ms_iters : 1); ++ms) {
      // a mean-shift pass: each thread's weight sums in normal order
      double acc[9];
      for (int q = 0; q < 9; ++q) acc[q] = 0.0;
      if (ms_iters > 0) {
#pragma unroll
        for (int j = 0; j < kOwned; ++j) {
          add_weight(ck[j], cu[j], cv[j], c, kernel, acc);
        }
        for (int i = tid + kOwned * kThreads; i < N; i += kThreads) {
          float u = 0.0f, v = 0.0f;
          const int k = cone_of(Rr, normals + 3 * i, valid[i] != 0, cos_half,
                                &u, &v);
          add_weight(k, u, v, c, kernel, acc);
        }
      }
      // the block reduction: the warps' trees, then warp a < 3 sums axis
      // a's three values over the warps and forms its centre (warp 3 the
      // support counts, in the first pass)
      const int warp = tid >> 5, lane = tid & 31;
      warp_tree<8>(acc, 0, warp_buf);
      warp_tree<1>(acc + 8, 8, warp_buf);
      if (ms == 0) warp_tree<4>(cnt, 9, warp_buf);
      __syncthreads();
      if (warp < 3 && ms_iters > 0) {
        double s3[3];
        warp_sums3(warp_buf, 3 * warp, s3);
        if (lane == 0) {
          const float wsum = fmaxf(static_cast<float>(s3[0]), 1e-9f);
          s_center[warp][0] = static_cast<float>(s3[1]) / wsum;
          s_center[warp][1] = static_cast<float>(s3[2]) / wsum;
        }
      } else if (warp == 3 && ms == 0) {
        double s3[3];
        warp_sums3(warp_buf, 9, s3);
        if (lane == 0) {
          for (int k = 0; k < 3; ++k) {
            s_supp[k] = static_cast<long long>(s3[k]);
          }
        }
      }
      __syncthreads();
      if (ms_iters > 0) {
        for (int k = 0; k < 3; ++k) {
          c[k][0] = s_center[k][0];
          c[k][1] = s_center[k][1];
        }
      }
    }

    // the round's tail
    if (tid == 0) {
      float axes[3][3];  // axes[k] = new axis k in the camera frame
      int n_found = 0;
      bool found[3];
      for (int k = 0; k < 3; ++k) {
        const int i = (k + 1) % 3, j = (k + 2) % 3;
        float dir[3];
        dir[i] = c[k][0];
        dir[j] = c[k][1];
        dir[k] = 1.0f;
        const float nrm = sqrtf(psl_dot3(dir, dir));
        for (int q = 0; q < 3; ++q) dir[q] = dir[q] / nrm;
        for (int r = 0; r < 3; ++r) axes[k][r] = psl_dot3(Rr + 3 * r, dir);
        found[k] = s_supp[k] >= min_support;
        n_found += found[k] ? 1 : 0;
      }
      float cols[3][3];  // cols[k] = column k
      for (int k = 0; k < 3; ++k) {
        for (int r = 0; r < 3; ++r) {
          cols[k][r] = found[k] ? axes[k][r] : Rr[3 * r + k];
        }
      }
      float crosses[3][3];
      psl_cross3(cols[1], cols[2], crosses[0]);
      psl_cross3(cols[2], cols[0], crosses[1]);
      psl_cross3(cols[0], cols[1], crosses[2]);
      float next[9];
      for (int k = 0; k < 3; ++k) {
        const float prev[3] = {Rr[k], Rr[3 + k], Rr[6 + k]};
        const float sgn = psl_dot3(crosses[k], prev) >= 0.0f ? 1.0f : -1.0f;
        const bool use_cross = !found[k] && n_found == 2;
        for (int r = 0; r < 3; ++r) {
          next[3 * r + k] = use_cross ? crosses[k][r] * sgn : cols[k][r];
        }
      }
      const bool ok = n_found >= 2;
      if (ok) {
        float R_new[9];
        psl_orthonormalize(next, R_new);
        for (int q = 0; q < 9; ++q) R[q] = R_new[q];
      }
      if (rnd == iters - 1) {
        for (int q = 0; q < 9; ++q) R_out[q] = R[q];
        for (int k = 0; k < 3; ++k) support_out[k] = s_supp[k];
        *n_axes_out = n_found;
        *success_out = ok ? 1 : 0;
        if (sel.T_pred != nullptr) init_select(sel, frame, R, ok);
      }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------- K39 ---

constexpr int kSeedThreads = 256;

// the better of two (weight, index) picks: the larger weight, the first
// index among equals
__device__ __forceinline__ void seed_pick_merge(float& w, int& i, float w2,
                                                int i2) {
  if (w2 > w || (w2 == w && i2 < i)) {
    w = w2;
    i = i2;
  }
}

// warp 0's arg-max of vals[0..n) (first index among equals); every lane
// returns it
__device__ __forceinline__ int seed_argmax(const float* vals, int n,
                                           int lane) {
  float w = -INFINITY;
  int i = INT_MAX;
  for (int j = lane; j < n; j += 32) seed_pick_merge(w, i, vals[j], j);
  for (int off = 16; off > 0; off >>= 1) {
    const float w2 = __shfl_xor_sync(kFull, w, off);
    const int i2 = __shfl_xor_sync(kFull, i, off);
    seed_pick_merge(w, i, w2, i2);
  }
  return i;
}

__global__ void __launch_bounds__(kSeedThreads) seed_manhattan_kernel(
    const float* __restrict__ coeffs, const int* __restrict__ count,
    const unsigned char* __restrict__ pl_valid, int P,
    const float* __restrict__ p3d_s, const float* __restrict__ p3d_e,
    const unsigned char* __restrict__ has_3d,
    const unsigned char* __restrict__ ln_valid,
    const float* __restrict__ response, int L,
    const float* __restrict__ normals,
    const unsigned char* __restrict__ normals_valid, int Nn,
    float* __restrict__ R_seed, unsigned char* __restrict__ seed_ok,
    int* __restrict__ picks, float* __restrict__ dirs,
    unsigned char* __restrict__ dirs_valid) {
  extern __shared__ float seed_smem[];
  const int N = P + L;
  float* cand = seed_smem;       // (N, 3) the candidate directions
  float* wgt = cand + 3 * N;     // (N,) weights (0 where invalid)
  float* score = wgt + N;        // (N,) the perpendicular pick's
  unsigned char* ok = reinterpret_cast<unsigned char*>(score + N);  // (N,)
  const int tid = threadIdx.x, lane = tid & 31;
  const size_t f = blockIdx.x;
  const int D = Nn + L;
  float* d_out = dirs + 3 * f * D;
  unsigned char* ok_out = dirs_valid + f * D;
  for (int r = tid; r < D; r += kSeedThreads) {
    if (r < Nn) {
      const float* n = normals + 3 * (f * Nn + r);
      d_out[3 * r] = n[0];
      d_out[3 * r + 1] = n[1];
      d_out[3 * r + 2] = n[2];
      ok_out[r] = normals_valid[f * Nn + r];
    }
  }
  for (int c = tid; c < N; c += kSeedThreads) {
    if (c < P) {
      const size_t q = f * P + c;
      for (int k = 0; k < 3; ++k) cand[3 * c + k] = coeffs[4 * q + k];
      ok[c] = pl_valid[q];
      wgt[c] = pl_valid[q] != 0 ? __int2float_rn(count[q]) : 0.0f;
    } else {
      // K36's line direction: |v| = sqrt((v0^2 + v2^2) + v1^2), IEEE
      // division by max(|v|, 1e-9)
      const int l = c - P;
      const size_t q = f * L + l;
      const float* s = p3d_s + 3 * q;
      const float* e = p3d_e + 3 * q;
      const float v0 = e[0] - s[0], v1 = e[1] - s[1], v2 = e[2] - s[2];
      const float len = __fsqrt_rn((v0 * v0 + v2 * v2) + v1 * v1);
      const float den = len < 1e-9f ? 1e-9f : len;
      const float d[3] = {__fdiv_rn(v0, den), __fdiv_rn(v1, den),
                          __fdiv_rn(v2, den)};
      const bool good = has_3d[q] != 0 && ln_valid[q] != 0 && len > 0.1f;
      for (int k = 0; k < 3; ++k) {
        cand[3 * c + k] = d[k];
        d_out[3 * (Nn + l) + k] = d[k];
      }
      ok_out[Nn + l] = good ? 1 : 0;
      ok[c] = good ? 1 : 0;
      // response.to(int32) (truncated), then to float32
      wgt[c] = good ? __int2float_rn(__float2int_rz(response[q])) : 0.0f;
    }
  }
  __syncthreads();
  if (tid >= 32) return;
  const int i0 = seed_argmax(wgt, N, lane);
  const float a0[3] = {cand[3 * i0], cand[3 * i0 + 1], cand[3 * i0 + 2]};
  for (int c = lane; c < N; c += 32) {
    const float* n = cand + 3 * c;
    const float perp = fabsf((n[0] * a0[0] + n[1] * a0[1]) + n[2] * a0[2]);
    score[c] = (ok[c] != 0 && perp < 0.2f) ? wgt[c] : -1.0f;
  }
  __syncwarp();
  const int i1 = seed_argmax(score, N, lane);
  if (lane != 0) return;
  const float s1 = score[i1];
  float a1[3] = {cand[3 * i1], cand[3 * i1 + 1], cand[3 * i1 + 2]};
  const float proj = (a1[0] * a0[0] + a1[1] * a0[1]) + a1[2] * a0[2];
  for (int k = 0; k < 3; ++k) a1[k] = a1[k] - proj * a0[k];
  const float nrm =
      __fsqrt_rn((a1[0] * a1[0] + a1[2] * a1[2]) + a1[1] * a1[1]);
  const float den = nrm < 1e-9f ? 1e-9f : nrm;
  for (int k = 0; k < 3; ++k) a1[k] = __fdiv_rn(a1[k], den);
  float a2[3];
  psl_cross3(a0, a1, a2);
  float R[9];
  for (int r = 0; r < 3; ++r) {
    R[3 * r] = a0[r];
    R[3 * r + 1] = a1[r];
    R[3 * r + 2] = a2[r];
  }
  psl_orthonormalize(R, R_seed + 9 * f);
  seed_ok[f] = s1 > 0.0f ? 1 : 0;
  picks[2 * f] = i0;
  picks[2 * f + 1] = i1;
}

}  // namespace

// coeffs (B, P, 4), count (B, P) int32, pl_valid (B, P), P; p3d_s, p3d_e
// (B, L, 3), has_3d, ln_valid (B, L), response (B, L) float32, L; normals
// (B, Nn, 3), normals_valid (B, Nn), Nn; batch; R_seed (B, 3, 3), seed_ok
// (B,), picks (B, 2) int32, dirs (B, Nn + L, 3), dirs_valid (B, Nn + L)
PSL_API int psl_seed_manhattan(
    const float* coeffs, const int* count, const unsigned char* pl_valid,
    int P, const float* p3d_s, const float* p3d_e,
    const unsigned char* has_3d, const unsigned char* ln_valid,
    const float* response, int L, const float* normals,
    const unsigned char* normals_valid, int Nn, int batch, float* R_seed,
    unsigned char* seed_ok, int* picks, float* dirs,
    unsigned char* dirs_valid, cudaStream_t stream) {
  if (P < 0 || L < 0 || Nn < 0 || P + L < 1 || batch < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(P + L) * (5 * sizeof(float) + 1);
  if (batch > 0) {
    const int rc = psl_opt_in_smem(
        reinterpret_cast<const void*>(seed_manhattan_kernel), smem);
    if (rc != 0) return rc;
    seed_manhattan_kernel<<<batch, kSeedThreads, smem, stream>>>(
        coeffs, count, pl_valid, P, p3d_s, p3d_e, has_3d, ln_valid, response,
        L, normals, normals_valid, Nn, R_seed, seed_ok, picks, dirs,
        dirs_valid);
  }
  return static_cast<int>(cudaGetLastError());
}

PSL_API int psl_manhattan_mean_shift(
    const float* R_init, const float* normals, const unsigned char* valid,
    int N, int batch, float cos_half, float kernel, int min_support,
    int iters, int ms_iters, float* R_out, long long* support,
    long long* n_axes, unsigned char* success, const float* T_pred,
    const float* R_wm, const unsigned char* enabled, float* T_init,
    unsigned char* use_manh, cudaStream_t stream) {
  if (iters < 1 || batch < 1) return static_cast<int>(cudaErrorInvalidValue);
  const InitSelect sel{T_pred, R_wm, enabled, T_init, use_manh};
  manhattan_kernel<<<batch, kThreads, 0, stream>>>(
      R_init, normals, valid, N, cos_half, kernel, min_support, iters,
      ms_iters, R_out, support, n_axes, success, sel);
  return static_cast<int>(cudaGetLastError());
}
