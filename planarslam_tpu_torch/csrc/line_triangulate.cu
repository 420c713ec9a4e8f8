// K42 triangulate_lines — the mapping step's line triangulation.
//
// Replaces the line part of planarslam_tpu/slam/device_mapper.py::
// _mapping_step_impl (:172-232, ln_tri_one :187; CreateNewMapLines2):
// per neighbour n and own line i
//   - the D-term descriptor similarities of own line i against the
//     neighbour's L lines, gated (own line free, neighbour line free,
//     nb_ok) to -1, their arg-max (NaN above every number, the first index
//     among equals, as torch.max and jnp.argmax order them) and the 0.75
//     gate on its value;
//   - the neighbour's back-projection plane pi2 = (K [R2 | t2])^T l2 of the
//     matched line, the parallax test |n1 . n2| / (|n1| |n2| + 1e-12) <
//     0.998 against the own line's plane n1;
//   - the own endpoint rays R1^T K^-1 (u, v, 1) from the own camera centre
//     C1 = -R1^T t1 cut with pi2 (|denominator| < 1e-9 replaced by 1e-9),
//     and the gates: both ray parameters > 0, both depths in the own camera
//     in (0.1, 40), the segment's length in (0.05, 20), both endpoints
//     finite.
// K^-1 is closed form from (fx, fy, cx, cy): the host passes 1 / fx, 1 / fy,
// -cx / fx and -cy / fy in float32.
//
// One block per (lane, neighbour): the own and the neighbour's descriptor
// rows staged in shared memory (rows padded to an odd stride, so a warp's
// 32 columns fall in 32 banks); a warp a row of similarities, a lane a
// column, its D products summed in order d = 0 .. D - 1; the warp's arg-max
// by butterfly shuffles in the total order above (every lane ends with the
// row's pick); then a thread a row for the geometry. Built with
// -fmad=false: each product and sum rounds alone, as the plain version's
// separate PyTorch ops, which spell every dot product in the same order,
// so idx, the endpoints and good are bit-equal to it.
//
// What bounds it on an H100: nothing at the mapping step's size (NB = 5,
// L = 64, D = 72): 1.5 M multiply-adds and 190 KB read, 0.0007 ms of
// bytes; a launch's latency and the warp's 72-long chains of dependent
// adds set its time.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Cam {
  float fx, fy, cx, cy;      // K
  float ifx, ify, ncx, ncy;  // K^-1: 1 / fx, 1 / fy, -cx / fx, -cy / fy
};

// (v, i) ranks above (w, j): NaN above every number, then the larger value,
// then the lower index; j < 0 is no candidate.
__device__ __forceinline__ bool ranks_above(float v, int i, float w, int j) {
  if (j < 0) return true;
  const bool vn = isnan(v), wn = isnan(w);
  if (vn != wn) return vn;
  if (!vn && v != w) return v > w;
  return i < j;
}

// a . b over three entries, (a0 b0 + a1 b1) + a2 b2
__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// the back-projection plane (K [R | t])^T l of image line l, pose T
__device__ __forceinline__ void backproject(const float* T, const float* l,
                                            Cam k, int n, float* pi) {
  for (int c = 0; c < n; ++c) {
    const float p0 = k.fx * T[c] + k.cx * T[8 + c];
    const float p1 = k.fy * T[4 + c] + k.cy * T[8 + c];
    const float p2 = T[8 + c];
    pi[c] = p0 * l[0] + p1 * l[1] + p2 * l[2];
  }
}

// the ray R^T K^-1 (u, v, 1) of pixel (u, v), R the rows of T
__device__ __forceinline__ void ray(const float* T, float u, float v, Cam k,
                                    float* d) {
  const float kx = u * k.ifx + k.ncx;
  const float ky = v * k.ify + k.ncy;
  for (int j = 0; j < 3; ++j) d[j] = kx * T[j] + ky * T[4 + j] + T[8 + j];
}

// the cut of the ray C + s d with the plane pi: returns s, writes X
__device__ __forceinline__ float cut(const float* pi, const float* C,
                                     const float* d, float* X) {
  const float denom = dot3(pi, d);
  const float num = dot3(pi, C) + pi[3];
  const float den = fabsf(denom) < 1e-9f ? 1e-9f : denom;
  const float s = -num / den;
  for (int j = 0; j < 3; ++j) X[j] = C[j] + s * d[j];
  return s;
}

__device__ __forceinline__ bool finite3(const float* X) {
  return isfinite(X[0]) && isfinite(X[1]) && isfinite(X[2]);
}

__global__ void __launch_bounds__(kThreads) triangulate_lines_kernel(
    const float* __restrict__ own_T, const float* __restrict__ own_uvs,
    const float* __restrict__ own_uve, const float* __restrict__ own_l2d,
    const float* __restrict__ own_desc,
    const unsigned char* __restrict__ own_free,
    const float* __restrict__ nb_T, const float* __restrict__ nb_l2d,
    const float* __restrict__ nb_desc,
    const unsigned char* __restrict__ nb_free,
    const unsigned char* __restrict__ nb_ok, int NB, int L, int D, Cam cam,
    int* __restrict__ idx_out, float* __restrict__ xs_out,
    float* __restrict__ xe_out, unsigned char* __restrict__ good_out) {
  extern __shared__ float smem[];
  const int n = blockIdx.x, b = blockIdx.y;
  const int nb = b * NB + n;
  const int Dp = D | 1;
  float* a = smem;                      // own rows, L x Dp
  float* c = a + L * Dp;                // neighbour rows, L x Dp
  float* best_v = c + L * Dp;           // L
  int* best_i = reinterpret_cast<int*>(best_v + L);  // L
  unsigned char* free_a = reinterpret_cast<unsigned char*>(best_i + L);
  unsigned char* free_c = free_a + L;

  const float* da = own_desc + static_cast<size_t>(b) * L * D;
  const float* dc = nb_desc + static_cast<size_t>(nb) * L * D;
  for (int e = threadIdx.x; e < L * D; e += kThreads) {
    const int r = e / D, d = e - r * D;
    a[r * Dp + d] = da[e];
    c[r * Dp + d] = dc[e];
  }
  for (int r = threadIdx.x; r < L; r += kThreads) {
    free_a[r] = own_free[b * L + r];
    free_c[r] = nb_free[nb * L + r];
  }
  const bool ok = nb_ok[nb] != 0;
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = warp; i < L; i += kWarps) {
    float bv = 0.0f;
    int bi = -1;
    const float* ra = a + i * Dp;
    for (int j = lane; j < L; j += 32) {
      float s = -1.0f;
      if (ok && free_a[i] && free_c[j]) {
        const float* rc = c + j * Dp;
        s = ra[0] * rc[0];
        for (int d = 1; d < D; ++d) s = s + ra[d] * rc[d];
      }
      if (ranks_above(s, j, bv, bi)) {
        bv = s;
        bi = j;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (oi >= 0 && ranks_above(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == 0) {
      best_v[i] = bv;
      best_i[i] = bi;
    }
  }
  __syncthreads();

  const float* T1 = own_T + 16 * b;
  const float* T2 = nb_T + 16 * nb;
  float C1[3];
  for (int j = 0; j < 3; ++j) {
    C1[j] = -(T1[j] * T1[3] + T1[4 + j] * T1[7] + T1[8 + j] * T1[11]);
  }
  for (int i = threadIdx.x; i < L; i += kThreads) {
    const int idx = best_i[i];
    const bool has = best_v[i] > 0.75f;
    const int j = psl_clamp(idx, 0, L - 1);
    float pi2[4], pi1[3];
    backproject(T2, nb_l2d + (static_cast<size_t>(nb) * L + j) * 3, cam, 4,
                pi2);
    backproject(T1, own_l2d + (static_cast<size_t>(b) * L + i) * 3, cam, 3,
                pi1);
    const float cosp = fabsf(dot3(pi1, pi2)) /
                       (sqrtf(dot3(pi1, pi1)) * sqrtf(dot3(pi2, pi2)) +
                        1e-12f);
    const size_t o = static_cast<size_t>(b) * L + i;
    float ds[3], de[3], Xs[3], Xe[3];
    ray(T1, own_uvs[2 * o], own_uvs[2 * o + 1], cam, ds);
    ray(T1, own_uve[2 * o], own_uve[2 * o + 1], cam, de);
    const float ts = cut(pi2, C1, ds, Xs);
    const float te = cut(pi2, C1, de, Xe);
    const float zs = dot3(T1 + 8, Xs) + T1[11];
    const float ze = dot3(T1 + 8, Xe) + T1[11];
    const float dx[3] = {Xe[0] - Xs[0], Xe[1] - Xs[1], Xe[2] - Xs[2]};
    const float seg = sqrtf(dot3(dx, dx));
    const bool good = has && cosp < 0.998f && ts > 0.0f && te > 0.0f &&
                      zs > 0.1f && zs < 40.0f && ze > 0.1f && ze < 40.0f &&
                      seg > 0.05f && seg < 20.0f && finite3(Xs) &&
                      finite3(Xe);
    const size_t q = static_cast<size_t>(nb) * L + i;
    idx_out[q] = idx;
    for (int k = 0; k < 3; ++k) {
      xs_out[3 * q + k] = Xs[k];
      xe_out[3 * q + k] = Xe[k];
    }
    good_out[q] = good ? 1 : 0;
  }
}

}  // namespace

// batch lanes of NB neighbours and L lines of D descriptor entries; own_*
// (batch, L, ...), nb_* (batch, NB, L, ...), poses row-major 4 x 4; the
// bools one byte each. idx (batch, NB, L) int32, Xs and Xe (batch, NB, L,
// 3), good (batch, NB, L) bytes.
PSL_API int psl_triangulate_lines(
    const float* own_T, const float* own_uvs, const float* own_uve,
    const float* own_l2d, const float* own_desc, const unsigned char* own_free,
    const float* nb_T, const float* nb_l2d, const float* nb_desc,
    const unsigned char* nb_free, const unsigned char* nb_ok, int batch,
    int NB, int L, int D, float fx, float fy, float cx, float cy, float ifx,
    float ify, float ncx, float ncy, int* idx, float* Xs, float* Xe,
    unsigned char* good, cudaStream_t stream) {
  if (batch < 0 || NB < 0 || L < 0 || D < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0 || NB == 0 || L == 0) return 0;
  const size_t smem = (2 * static_cast<size_t>(L) * (D | 1) + 2 * L) *
                          sizeof(float) + 2 * L;
  const int rc = psl_opt_in_smem(
      reinterpret_cast<const void*>(triangulate_lines_kernel), smem);
  if (rc != 0) return rc;
  triangulate_lines_kernel<<<dim3(NB, batch), kThreads, smem, stream>>>(
      own_T, own_uvs, own_uve, own_l2d, own_desc, own_free, nb_T, nb_l2d,
      nb_desc, nb_free, nb_ok, NB, L, D,
      Cam{fx, fy, cx, cy, ifx, ify, ncx, ncy}, idx, Xs, Xe, good);
  return static_cast<int>(cudaGetLastError());
}
