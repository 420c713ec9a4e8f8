// K12 plane_components, K13 plane_assign_refit, K14 plane_label_pixels —
// plane segmentation after the block moments of K4.
//
// Replaces planarslam_tpu/ops/planes.py::extract_planes :265-346 (K12: the
// per-block plane fits, block validity, coplanarity edges, label
// propagation, per-component refit, top-P and dedup), :363-437 (K13: one
// assign-and-refit round over the subsampled pixels, with the ghost merge
// of the refine rounds) and :439-473 (K14: the final gate and the
// full-resolution labeling). The plain versions are
// planarslam_tpu_torch/ops/planes.py::plane_components_plain,
// plane_assign_refit_plain and plane_label_pixels_plain; the float32
// arithmetic follows them operation by operation (eig3.cuh; this file is
// compiled with -fmad=false).
//
// What bounds them on an H100. K12 is a chain of dependent steps (the fits,
// then merge_rounds x (pull, barrier, jump, barrier), then the top P) over
// 4800 blocks, ~250 KB: latency and instructions, not bytes. Its 4800 fits
// (~3000 cycles each, tools/kernel_phases.py) run in a first kernel, one
// thread per block over the card, not ~5 per thread on one SM. One block
// of 1024 threads per frame then keeps both label buffers, a neighbour mask
// and the validity in shared memory for the rest of the chain; the pull
// reads the old labels everywhere and the jump reads only the pulled ones,
// as the plain version's synchronous update does, and a round that changes
// no label ends the rounds (the rest would change none). The top P rank
// the component roots directly, and the component sums read the blocks'
// moments as doubles staged in shared memory. K13 and K14
// read the depth map once (1.2 MB) and do ~100 operations per pixel, far
// under the card's rates for either: a launch plus one pass. They recompute
// the back-projection, the noise band and the depth gate per pixel in
// registers, so no full-resolution temporary exists.
//
// Batches. Every input and output may carry a leading B of independent
// frames, all served by one launch of each kernel: K12's fits take the
// frame from blockIdx.y and its chain one block per frame, K13's
// assign pass takes the frame from blockIdx.y and its refit one block per
// frame, K14 takes the frame from blockIdx.y. A block reads its frame at
// the frame's strides, so a frame's result does not depend on B.
//
// Sums have a fixed order and no float atomics. K12 counts component
// support with integer atomics (the counts are whole numbers) and sums
// each top component's moments per lane in ascending block order, in
// float64, then over the lanes by a shuffle tree. K13 sums each warp's 32
// pixels by a float64 shuffle tree into the warp's own shared accumulator,
// the warps of a block in order, the blocks' partials in order in a second
// one-block kernel that also fits the planes. Two launches on equal
// inputs give equal bits.
#include <math.h>

#include "common.cuh"
#include "eig3.cuh"

namespace {

constexpr int kMaxPlanes = 32;
constexpr int kFeat = 10;  // x y z xx xy xz yy yz zz 1
constexpr int kCcThreads = 1024;
constexpr int kFitThreads = 128;  // K12's fit kernel
constexpr int kFeatStaged = 12;  // floats of a block's moments (s1, s2)
constexpr int kChunk = 512;      // blocks of moments K12 stages at once
constexpr int kFewRoots = 512;   // K12 ranks this many roots directly
// K12's dynamic shared memory at most: the 227 KB a block may opt into
// less 16 KB for its static arrays
constexpr int kCcDynamicSmem = 232448 - 16384;
constexpr int kPixThreads = 256;
constexpr int kPixWarps = kPixThreads / 32;
constexpr float kCos25 = 0.9063f;

// ---------------------------------------------------------------- K12 ---

struct CcParams {
  const float* s1;   // (B, 3)
  const float* s2;   // (B, 3, 3)
  const float* n;    // (B,)
  int hb, wb, P, merge_rounds;
  float full_count;  // block * block - 4
  float mse_sigma, mse_tol, angle_cos, dist_thr;
  float min_support, assoc_angle, assoc_dist2;
  float* fit_b;      // (B, 7) scratch: normal, d, mean
  float* normal_c;   // (P, 3)
  float* d_c;        // (P,)
  unsigned char* cand_valid;   // (P,)
  int* labels;                 // (B,)
  unsigned char* block_valid;  // (B,)
};

// CcParams of frame f of a batch: the inputs and outputs advanced by the
// frame's strides.
__device__ __forceinline__ CcParams cc_at(CcParams p, int f) {
  const size_t b = f, B = static_cast<size_t>(p.hb) * p.wb;
  p.s1 += 3 * b * B;
  p.s2 += 9 * b * B;
  p.n += b * B;
  p.fit_b += 7 * b * B;
  p.normal_c += 3 * b * p.P;
  p.d_c += b * p.P;
  p.cand_valid += b * p.P;
  p.labels += b * B;
  p.block_valid += b * B;
  return p;
}

// K12, first kernel: the per-block plane fit and validity, one thread per
// block of the frame blockIdx.y.
__global__ void __launch_bounds__(kFitThreads)
    plane_fits_kernel(const CcParams p_batch) {
  const CcParams p = cc_at(p_batch, blockIdx.y);
  const int i = blockIdx.x * kFitThreads + threadIdx.x;
  if (i >= p.hb * p.wb) return;
  float normal[3], d, mse, mean[3];
  const float n = p.n[i];
  psl_plane_from_moments(p.s1 + 3 * i, p.s2 + 9 * i, n, normal, &d, &mse,
                         mean);
  const float z = mean[2];
  const float thr = p.mse_sigma * z * z + p.mse_tol;
  const bool ok = n >= p.full_count && mse < thr * thr && z > 1e-6f;
  float* f = p.fit_b + 7 * i;
  f[0] = normal[0];
  f[1] = normal[1];
  f[2] = normal[2];
  f[3] = d;
  f[4] = mean[0];
  f[5] = mean[1];
  f[6] = mean[2];
  p.block_valid[i] = ok ? 1 : 0;
}

// K12, second kernel: the rest of the chain, one block of kCcThreads per
// frame.
__global__ void __launch_bounds__(kCcThreads, 1)
    plane_components_kernel(const CcParams p_batch) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const CcParams p = cc_at(p_batch, blockIdx.x);
  const int B = p.hb * p.wb;
  const int tid = threadIdx.x;
  int* lab_a = reinterpret_cast<int*>(smem_raw);  // labels
  int* lab_b = lab_a + B;  // pulled labels, then the component counts
  // a staged chunk: rows of block fits (floats) for the edges, then the
  // moments of kChunk blocks (doubles) for the component sums
  double* dstage = reinterpret_cast<double*>(lab_b + B);
  float* stage = reinterpret_cast<float*>(dstage);
  const int cap = 2 * kFeatStaged * kChunk;  // floats
  // per block: bit 0 an edge to the right, 1 to the left, 2 down, 3 up
  unsigned char* nbr =
      reinterpret_cast<unsigned char*>(dstage + kFeatStaged * kChunk);
  unsigned char* valid = nbr + B;  // block validity
  __shared__ int top_idx[kMaxPlanes];
  __shared__ int top_cnt[kMaxPlanes];
  __shared__ float cand[kMaxPlanes][4];
  __shared__ unsigned char cand_ok[kMaxPlanes];
  __shared__ int list_cnt[kCcThreads / 32][kMaxPlanes];
  __shared__ int list_idx[kCcThreads / 32][kMaxPlanes];
  __shared__ int root_cnt[kFewRoots];
  __shared__ int root_idx[kFewRoots];
  __shared__ int n_roots;
  const int lane = tid & 31, warp = tid >> 5;

  for (int i = tid; i < B; i += kCcThreads) {
    valid[i] = p.block_valid[i];
    lab_a[i] = i;
  }
  __syncthreads();

  // coplanarity edges to the right and lower neighbour, over chunks of
  // block rows whose fits (with the next row) are staged in shared memory
  const int chunk_rows = max(1, cap / (7 * p.wb) - 1);
  const float inv_wb = 1.0f / static_cast<float>(p.wb);
  // (a thread's share of the rows is loaded one chunk ahead, as below)
  constexpr int kRowRegs = 2 * kFeatStaged * kChunk / kCcThreads;
  float fr[kRowRegs];
  auto load_rows = [&](int r0) {
    const int n7 = 7 * min(chunk_rows + 1, p.hb - r0) * p.wb;
    const float* src = p.fit_b + static_cast<size_t>(7) * r0 * p.wb;
#pragma unroll
    for (int u = 0; u < kRowRegs; ++u) {
      const int q = tid + u * kCcThreads;
      fr[u] = q < n7 ? src[q] : 0.0f;
    }
  };
  load_rows(0);
  for (int r0 = 0; r0 < p.hb; r0 += chunk_rows) {
    const int n7 = 7 * min(chunk_rows + 1, p.hb - r0) * p.wb;
    __syncthreads();  // the previous chunk is read
#pragma unroll
    for (int u = 0; u < kRowRegs; ++u) {
      const int q = tid + u * kCcThreads;
      if (q < n7) stage[q] = fr[u];
    }
    __syncthreads();
    if (r0 + chunk_rows < p.hb) load_rows(r0 + chunk_rows);
    const int i0 = r0 * p.wb, i1 = min(r0 + chunk_rows, p.hb) * p.wb;
    for (int i = i0 + tid; i < i1; i += kCcThreads) {
      bool er = false, ed = false;
      if (valid[i]) {
        const float* fi = stage + 7 * (i - i0);
        // the row of i within the chunk: a float quotient, corrected
        int ry = static_cast<int>(static_cast<float>(i - i0) * inv_wb);
        ry += (ry + 1) * p.wb <= i - i0;
        ry -= ry * p.wb > i - i0;
        const int ix = i - i0 - ry * p.wb, iy = r0 + ry;
        for (int dir = 0; dir < 2; ++dir) {
          const bool has = dir == 0 ? ix + 1 < p.wb : iy + 1 < p.hb;
          if (!has) continue;
          const int j = dir == 0 ? i + 1 : i + p.wb;
          const float* fj = stage + 7 * (j - i0);
          const float c = psl_dot3(fi, fj);
          const float dist = fabsf(psl_dot3(fj, fi + 4) + fj[3]);
          const bool e = c > p.angle_cos && dist < p.dist_thr && valid[j];
          if (dir == 0) er = e; else ed = e;
        }
      }
      nbr[i] = (er ? 1 : 0) | (ed ? 4 : 0);
    }
  }
  __syncthreads();
  // a block's left and upper edges are its neighbours' right and lower
  // ones (only bits 0 and 2 of a neighbour are read)
  for (int i = tid; i < B; i += kCcThreads) {
    const int left = i > 0 ? (nbr[i - 1] & 1) << 1 : 0;
    const int up = i >= p.wb ? (nbr[i - p.wb] & 4) << 1 : 0;
    nbr[i] = nbr[i] | left | up;
  }
  __syncthreads();

  // synchronous min-label pull over the 4 neighbours, then pointer
  // jumping; a round that changes no label is a fixed point, so the rounds
  // left would change none either
  for (int rnd = 0; rnd < p.merge_rounds; ++rnd) {
#pragma unroll 4
    for (int i = tid; i < B; i += kCcThreads) {
      const int e = nbr[i];
      int m = lab_a[i];
      if (e & 1) m = min(m, lab_a[i + 1]);
      if (e & 2) m = min(m, lab_a[i - 1]);
      if (e & 4) m = min(m, lab_a[i + p.wb]);
      if (e & 8) m = min(m, lab_a[i - p.wb]);
      lab_b[i] = m;
    }
    __syncthreads();
    int changed = 0;
#pragma unroll 4
    for (int i = tid; i < B; i += kCcThreads) {
      const int l = lab_b[lab_b[i]];
      changed |= l != lab_a[i];
      lab_a[i] = l;
    }
    if (!__syncthreads_or(changed)) break;
  }

  // component support: whole-number counts, integer atomics
  for (int i = tid; i < B; i += kCcThreads) {
    p.labels[i] = lab_a[i];
    lab_b[i] = 0;
  }
  __syncthreads();
  for (int i = tid; i < B; i += kCcThreads) {
    if (valid[i]) atomicAdd(&lab_b[lab_a[i]], static_cast<int>(p.n[i]));
  }
  __syncthreads();

  // top-P by support, ties to the lower index: the order of P arg-max
  // passes over the counts. Only component roots count more than 0. With
  // at most kFewRoots of them, each root's rank among the roots is counted
  // directly, and blocks of count 0 fill the ranks left in index order;
  // else each warp takes the P best of its range in order, marking each
  // taken (-1), and warp 0 merges the 32 sorted lists (a key: count + 1,
  // then the lowest index; two warp max-reductions a pick).
  if (tid == 0) n_roots = 0;
  __syncthreads();
  for (int i = tid; i < B; i += kCcThreads) {
    const int c = lab_b[i];
    if (c > 0) {
      const int at = atomicAdd(&n_roots, 1);
      if (at < kFewRoots) {
        root_cnt[at] = c;
        root_idx[at] = i;
      }
    }
  }
  __syncthreads();
  const int K = n_roots;
  if (K <= kFewRoots) {
    if (tid < K) {
      const int c = root_cnt[tid], i = root_idx[tid];
      int rank = 0;
      for (int u = 0; u < K; ++u) {
        const int cu = root_cnt[u];
        rank += cu > c || (cu == c && root_idx[u] < i);
      }
      if (rank < p.P) {
        top_idx[rank] = i;
        top_cnt[rank] = c;
      }
    }
    if (warp == 0 && K < p.P) {
      int filled = K;  // the lowest-index blocks of count 0
      for (int i0 = 0; filled < p.P && i0 < B; i0 += 32) {
        const int i = i0 + lane;
        const bool zero = i < B && lab_b[i] == 0;
        const unsigned mask = __ballot_sync(0xffffffffu, zero);
        const int at = filled + __popc(mask & ((1u << lane) - 1u));
        if (zero && at < p.P) {
          top_idx[at] = i;
          top_cnt[at] = 0;
        }
        filled += __popc(mask);
      }
    }
  } else {
    const int per = (B + 31) / 32;
    const int lo = warp * per, hi = min(B, lo + per);
    for (int k = 0; k < p.P; ++k) {
      int best_c = -1, best_i = INT_MAX;
      for (int i = lo + lane; i < hi; i += 32) {
        const int c = lab_b[i];
        if (c > best_c) {  // ascending i per lane: the first maximum stays
          best_c = c;
          best_i = i;
        }
      }
      const unsigned key = static_cast<unsigned>(best_c + 1);
      const unsigned top = __reduce_max_sync(0xffffffffu, key);
      const int top_i = static_cast<int>(~__reduce_max_sync(
          0xffffffffu, key == top ? ~static_cast<unsigned>(best_i) : 0u));
      if (lane == 0) {
        list_cnt[warp][k] = static_cast<int>(top) - 1;
        list_idx[warp][k] = top_i;
      }
      if (top > 0 && best_i == top_i) lab_b[best_i] = -1;  // taken
      __syncwarp();
    }
    __syncthreads();
    if (warp == 0) {
      int head = 0;  // this lane's next entry of list `lane`
      for (int k = 0; k < p.P; ++k) {
        const int c = head < p.P ? list_cnt[lane][head] : -1;
        const int i = head < p.P ? list_idx[lane][head] : INT_MAX;
        const unsigned key = static_cast<unsigned>(c + 1);
        const unsigned top = __reduce_max_sync(0xffffffffu, key);
        const int top_i = static_cast<int>(~__reduce_max_sync(
            0xffffffffu, key == top ? ~static_cast<unsigned>(i) : 0u));
        if (lane == 0) {
          top_idx[k] = top_i;
          top_cnt[k] = static_cast<int>(top) - 1;
        }
        if (key == top && i == top_i) ++head;
      }
    }
  }
  __syncthreads();

  // per-component moment sums (warp k for component k, lane l over the
  // blocks i = l mod 32 in ascending order, in float64), over chunks of
  // kChunk blocks whose moments are staged in shared memory as doubles,
  // a thread's share of the next chunk loaded while this one is summed.
  // Then the lanes by a shuffle tree and the plane fit.
  const int k = warp;
  const int root = k < p.P ? top_idx[k] : -1;
  const bool summing = k < p.P && top_cnt[k] > 0;
  double acc[12];
  for (int q = 0; q < 12; ++q) acc[q] = 0.0;
  constexpr int kPerThread = kFeatStaged * kChunk / kCcThreads;
  float v[kPerThread];
  auto load_chunk = [&](int c0) {
    const int cn = min(kChunk, B - c0);
    const float* s1 = p.s1 + 3 * static_cast<size_t>(c0);
    const float* s2 = p.s2 + 9 * static_cast<size_t>(c0);
#pragma unroll
    for (int u = 0; u < kPerThread; ++u) {
      const int q = tid + u * kCcThreads;
      v[u] = q < 3 * cn ? s1[q] : (q < 12 * cn ? s2[q - 3 * cn] : 0.0f);
    }
  };
  load_chunk(0);
  for (int c0 = 0; c0 < B; c0 += kChunk) {
    const int cn = min(kChunk, B - c0), c1 = c0 + cn;
    __syncthreads();  // the previous chunk is read
#pragma unroll
    for (int u = 0; u < kPerThread; ++u) {
      const int q = tid + u * kCcThreads;
      if (q < 12 * cn) dstage[q] = static_cast<double>(v[u]);
    }
    __syncthreads();
    if (c0 + kChunk < B) load_chunk(c0 + kChunk);
    if (summing) {
      for (int i = c0 + lane; i < c1; i += 32) {
        if (lab_a[i] == root && valid[i]) {
          const double* m1 = dstage + 3 * (i - c0);
          const double* m2 = dstage + 3 * cn + 9 * (i - c0);
          for (int q = 0; q < 3; ++q) acc[q] += m1[q];
          for (int q = 0; q < 9; ++q) acc[3 + q] += m2[q];
        }
      }
    }
  }
  if (k < p.P) {
    for (int q = 0; q < 12; ++q) {
      for (int off = 16; off > 0; off >>= 1) {
        acc[q] += __shfl_down_sync(0xffffffffu, acc[q], off);
      }
    }
    if (lane == 0) {
      float s1[3], s2[9], normal[3], d, mse, mean[3];
      for (int q = 0; q < 3; ++q) s1[q] = static_cast<float>(acc[q]);
      for (int q = 0; q < 9; ++q) s2[q] = static_cast<float>(acc[3 + q]);
      const float n = static_cast<float>(top_cnt[k]);
      psl_plane_from_moments(s1, s2, n, normal, &d, &mse, mean);
      cand[k][0] = normal[0];
      cand[k][1] = normal[1];
      cand[k][2] = normal[2];
      cand[k][3] = d;
      cand_ok[k] = n >= p.min_support ? 1 : 0;
    }
  }
  __syncthreads();

  // dedup: a candidate that a larger one (lower index) duplicates goes
  if (tid < p.P) {
    bool shadowed = false;
    for (int j = 0; j < tid; ++j) {
      const float c = psl_dot3(cand[tid], cand[j]);
      const float dd = fabsf(cand[tid][3] - cand[j][3]);
      if (c > p.assoc_angle && dd < p.assoc_dist2 && cand_ok[tid] &&
          cand_ok[j]) {
        shadowed = true;
      }
    }
    p.normal_c[3 * tid + 0] = cand[tid][0];
    p.normal_c[3 * tid + 1] = cand[tid][1];
    p.normal_c[3 * tid + 2] = cand[tid][2];
    p.d_c[tid] = cand[tid][3];
    p.cand_valid[tid] = (cand_ok[tid] && !shadowed) ? 1 : 0;
  }
}

// ---------------------------------------------------------- K13, K14 ---

struct PixParams {
  const float* depth;  // (H, W)
  const float* alpha;  // () device scalar
  int h, w, rs;        // rs: pixel stride of this pass
  float fx, fy, cx, cy, geo_tol, max_distance, dist_thr;
  float jump_coef;     // 3 sqrt(2), rounded as the plain version rounds it
  int P;
  const float* normal;          // (P, 3)
  const float* d;               // (P,)
  const unsigned char* valid;   // (P,)
  // the fit these planes came from (refine rounds and K14), or NULL
  const float* mse;             // (P,)
  const float* mean;            // (P, 3)
  const float* n_p;             // (P,)
};

// PixParams of frame f of a batch: the depth map, alpha and the plane
// arrays advanced by the frame's strides.
__device__ __forceinline__ PixParams pix_at(PixParams p, int f) {
  const size_t b = f;
  p.depth += b * p.h * p.w;
  p.alpha += b;
  p.normal += 3 * b * p.P;
  p.d += b * p.P;
  p.valid += b * p.P;
  if (p.mse != nullptr) {
    p.mse += b * p.P;
    p.mean += 3 * b * p.P;
    p.n_p += b * p.P;
  }
  return p;
}

struct PlaneSet {
  float normal[kMaxPlanes][3];
  float d[kMaxPlanes];
  float tau[kMaxPlanes];
  unsigned char alive[kMaxPlanes];
};

// planes.py:368-380: the ghost merge of a refine round and tau. Thread j
// < P fills its plane's entry; the caller synchronizes.
__device__ __forceinline__ void load_planes(const PixParams& p, bool refine,
                                            PlaneSet& ps) {
  const int j = threadIdx.x;
  if (j >= p.P) return;
  for (int q = 0; q < 3; ++q) ps.normal[j][q] = p.normal[3 * j + q];
  ps.d[j] = p.d[j];
  bool alive = p.valid[j] != 0;
  float tau = INFINITY;
  if (refine) {
    const float alpha = *p.alpha;
    alive = alive && p.n_p[j] > 3.0f;
    const float zc = fmaxf(p.mean[3 * j + 2], 1.0f);
    const float band_j = fmaxf(3.0f * alpha * (zc * zc), p.dist_thr);
    bool shadow = false;
    for (int i = 0; i < p.P; ++i) {
      const bool alive_i = p.valid[i] != 0 && p.n_p[i] > 3.0f;
      const float cosm = psl_dot3(p.normal + 3 * j, p.normal + 3 * i);
      const float cen_d =
          fabsf(psl_dot3(p.mean + 3 * j, p.normal + 3 * i) + p.d[i]);
      if (alive_i && alive && p.n_p[i] > p.n_p[j] && cosm > kCos25 &&
          cen_d < band_j) {
        shadow = true;
      }
    }
    alive = alive && !shadow;
    tau = fmaxf(2.5f * sqrtf(fmaxf(p.mse[j], 0.0f)), 1e-3f);
  }
  ps.alive[j] = alive ? 1 : 0;
  ps.tau[j] = tau;
}

// One pixel (v, u) of the full-resolution grid: back-projection, the
// depth-range and jump gate, the band, the nearest alive plane (first
// index on ties) and the band / tau gate. Returns the plane or -1.
__device__ __forceinline__ int assign_pixel(const PixParams& p,
                                            const PlaneSet& ps, float alpha,
                                            int v, int u, float* pt) {
  const float z = p.depth[v * p.w + u];
  const float zc = fmaxf(z, 1.0f);
  const float z2 = zc * zc;
  const float tol = fmaxf(p.geo_tol * zc, p.jump_coef * alpha * z2);
  const float jump_r =
      u + 1 < p.w ? fabsf(z - p.depth[v * p.w + u + 1]) : 0.0f;
  const float jump_d =
      v + 1 < p.h ? fabsf(z - p.depth[(v + 1) * p.w + u]) : 0.0f;
  const bool ok = z > 1e-6f && z < p.max_distance && jump_r < tol &&
                  jump_d < tol;
  const float band = fmaxf(3.0f * alpha * z2, p.dist_thr);
  const float x = (static_cast<float>(u) - p.cx) / p.fx * z;
  const float y = (static_cast<float>(v) - p.cy) / p.fy * z;
  pt[0] = x;
  pt[1] = y;
  pt[2] = z;
  int best = 0;
  float best_d = INFINITY;
  for (int j = 0; j < p.P; ++j) {
    if (!ps.alive[j]) continue;
    const float dist = fabsf(x * ps.normal[j][0] + y * ps.normal[j][1] +
                             z * ps.normal[j][2] + ps.d[j]);
    if (dist < best_d) {
      best_d = dist;
      best = j;
    }
  }
  const bool keep = best_d < fminf(ps.tau[best], band) && ok;
  return keep ? best : -1;
}

// K13, first kernel: labels of the subsampled pixels and each block's
// partial moment sums per plane.
__global__ void __launch_bounds__(kPixThreads)
    plane_assign_kernel(const PixParams p_batch, int refine, int hs, int ws,
                        int pix_per_block, int* label_sub, double* partial) {
  __shared__ PlaneSet ps;
  const PixParams p = pix_at(p_batch, blockIdx.y);
  label_sub += static_cast<size_t>(blockIdx.y) * hs * ws;
  partial += static_cast<size_t>(blockIdx.y) * gridDim.x * p.P * kFeat;
  __shared__ double acc[kPixWarps][kMaxPlanes][kFeat];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  load_planes(p, refine != 0, ps);
  for (int q = tid; q < kPixWarps * kMaxPlanes * kFeat; q += kPixThreads) {
    (&acc[0][0][0])[q] = 0.0;
  }
  __syncthreads();
  const float alpha = *p.alpha;
  const int S = hs * ws;
  const int base = blockIdx.x * pix_per_block;
  for (int off = 0; off < pix_per_block; off += kPixThreads) {
    const int s = base + off + tid;
    int label = -1;
    float pt[3] = {0.0f, 0.0f, 0.0f};
    if (off + tid < pix_per_block && s < S) {
      label = assign_pixel(p, ps, alpha, (s / ws) * p.rs, (s % ws) * p.rs,
                           pt);
      label_sub[s] = label < 0 ? p.P : label;
    }
    const float f[kFeat] = {pt[0], pt[1], pt[2], pt[0] * pt[0],
                            pt[0] * pt[1], pt[0] * pt[2], pt[1] * pt[1],
                            pt[1] * pt[2], pt[2] * pt[2], 1.0f};
    // the planes present in this warp, lowest first
    unsigned todo = __ballot_sync(0xffffffffu, label >= 0);
    while (todo) {
      const int src = __ffs(todo) - 1;
      const int j = __shfl_sync(0xffffffffu, label, src);
      const bool mine = label == j;
      todo &= ~__ballot_sync(0xffffffffu, mine);
#pragma unroll
      for (int q = 0; q < kFeat; ++q) {
        double x = mine ? static_cast<double>(f[q]) : 0.0;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          x += __shfl_down_sync(0xffffffffu, x, o);
        }
        if (lane == 0) acc[warp][j][q] += x;
      }
    }
  }
  __syncthreads();
  for (int q = tid; q < p.P * kFeat; q += kPixThreads) {
    double x = 0.0;
    for (int w = 0; w < kPixWarps; ++w) x += acc[w][q / kFeat][q % kFeat];
    partial[static_cast<size_t>(blockIdx.x) * p.P * kFeat + q] = x;
  }
}

// K13, second kernel (one block): the blocks' partials summed in order,
// then each plane's moment fit; the alive mask goes out with it.
__global__ void __launch_bounds__(kMaxPlanes * kFeat)
    plane_refit_kernel(const PixParams p_batch, int refine, int n_part,
                       const double* partial, float area, float* normal_f,
                       float* d_f, float* mse_f, float* mean_f, float* n_f,
                       unsigned char* alive_out) {
  __shared__ PlaneSet ps;
  __shared__ float agg[kMaxPlanes][kFeat];
  const int tid = threadIdx.x;
  const PixParams p = pix_at(p_batch, blockIdx.x);
  {  // this block's frame
    const size_t f = blockIdx.x;
    partial += f * n_part * p.P * kFeat;
    normal_f += 3 * f * p.P;
    d_f += f * p.P;
    mse_f += f * p.P;
    mean_f += 3 * f * p.P;
    n_f += f * p.P;
    alive_out += f * p.P;
  }
  load_planes(p, refine != 0, ps);
  if (tid < p.P * kFeat) {
    double x = 0.0;
    for (int b = 0; b < n_part; ++b) {
      x += partial[static_cast<size_t>(b) * p.P * kFeat + tid];
    }
    agg[tid / kFeat][tid % kFeat] = static_cast<float>(x) * area;
  }
  __syncthreads();
  if (tid < p.P) {
    const float* a = agg[tid];
    const float s2[9] = {a[3], a[4], a[5], a[4], a[6], a[7], a[5], a[7],
                         a[8]};
    float normal[3], d, mse, mean[3];
    psl_plane_from_moments(a, s2, a[9], normal, &d, &mse, mean);
    for (int q = 0; q < 3; ++q) {
      normal_f[3 * tid + q] = normal[q];
      mean_f[3 * tid + q] = mean[q];
    }
    d_f[tid] = d;
    mse_f[tid] = mse;
    n_f[tid] = a[9];
    alive_out[tid] = ps.alive[tid];
  }
}

// K14: the final gate per plane (every block computes it; block 0 writes
// it) and the label of every pixel against the planes that pass. With
// label_in (refine stride 1) the labels of the last round are kept and
// only gated by the planes' validity.
__global__ void __launch_bounds__(kPixThreads)
    plane_label_kernel(const PixParams p_batch, int min_size,
                       const int* label_in, float* coeffs,
                       unsigned char* valid_out, int* count_out,
                       int* pixel_label) {
  __shared__ PlaneSet ps;
  const int tid = threadIdx.x;
  const PixParams p = pix_at(p_batch, blockIdx.y);
  {  // this block's frame
    const size_t f = blockIdx.y;
    if (label_in != nullptr) label_in += f * p.h * p.w;
    coeffs += 4 * f * p.P;
    valid_out += f * p.P;
    count_out += f * p.P;
    pixel_label += f * p.h * p.w;
  }
  const float alpha = *p.alpha;
  if (tid < p.P) {
    const int count = static_cast<int>(p.n_p[tid]);
    const float mz = p.mean[3 * tid + 2];
    const float g = fmaxf(2.0f * alpha * (mz * mz), p.dist_thr);
    const bool ok = p.valid[tid] != 0 && count >= min_size &&
                    p.mse[tid] < g * g;
    float c[4] = {p.normal[3 * tid], p.normal[3 * tid + 1],
                  p.normal[3 * tid + 2], p.d[tid]};
    for (int q = 0; q < 3; ++q) ps.normal[tid][q] = c[q];
    ps.d[tid] = c[3];
    ps.alive[tid] = ok ? 1 : 0;
    ps.tau[tid] = fmaxf(2.5f * sqrtf(fmaxf(p.mse[tid], 0.0f)), 1e-3f);
    if (blockIdx.x == 0) {
      // plane.py::normalize, zeros where invalid
      const float nrm =
          sqrtf(c[0] * c[0] + c[1] * c[1] + c[2] * c[2] + 1e-9f);
      for (int q = 0; q < 4; ++q) c[q] = c[q] / nrm;
      const float sgn = c[3] < 0.0f ? -1.0f : 1.0f;
      for (int q = 0; q < 4; ++q) {
        coeffs[4 * tid + q] = ok ? c[q] * sgn : 0.0f;
      }
      valid_out[tid] = ok ? 1 : 0;
      count_out[tid] = count;
    }
  }
  __syncthreads();
  const int n_pix = p.h * p.w;
  for (int s = blockIdx.x * kPixThreads + tid; s < n_pix;
       s += gridDim.x * kPixThreads) {
    int label;
    if (label_in != nullptr) {
      const int l = label_in[s];
      label = (l < p.P && ps.alive[l]) ? l : -1;
    } else {
      float pt[3];
      label = assign_pixel(p, ps, alpha, s / p.w, s % p.w, pt);
    }
    pixel_label[s] = label;
  }
}

PixParams pix_params(const float* depth, const float* alpha, int h, int w,
                     int rs, float fx, float fy, float cx, float cy,
                     float geo_tol, float max_distance, float dist_thr,
                     float jump_coef, int P, const float* normal,
                     const float* d,
                     const unsigned char* valid, const float* mse,
                     const float* mean, const float* n_p) {
  PixParams p;
  p.depth = depth;
  p.alpha = alpha;
  p.h = h;
  p.w = w;
  p.rs = rs;
  p.fx = fx;
  p.fy = fy;
  p.cx = cx;
  p.cy = cy;
  p.geo_tol = geo_tol;
  p.max_distance = max_distance;
  p.dist_thr = dist_thr;
  p.jump_coef = jump_coef;
  p.P = P;
  p.normal = normal;
  p.d = d;
  p.valid = valid;
  p.mse = mse;
  p.mean = mean;
  p.n_p = n_p;
  return p;
}

}  // namespace

PSL_API int psl_plane_components(
    const float* s1, const float* s2, const float* n, int hb, int wb, int P,
    int merge_rounds, float full_count, float mse_sigma, float mse_tol,
    float angle_cos, float dist_thr, float min_support, float assoc_angle,
    float assoc_dist2, int batch, float* fit_b, float* normal_c, float* d_c,
    unsigned char* cand_valid, int* labels, unsigned char* block_valid,
    cudaStream_t stream) {
  if (P > kMaxPlanes || batch < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CcParams p;
  p.s1 = s1;
  p.s2 = s2;
  p.n = n;
  p.hb = hb;
  p.wb = wb;
  p.P = P;
  p.merge_rounds = merge_rounds;
  p.full_count = full_count;
  p.mse_sigma = mse_sigma;
  p.mse_tol = mse_tol;
  p.angle_cos = angle_cos;
  p.dist_thr = dist_thr;
  p.min_support = min_support;
  p.assoc_angle = assoc_angle;
  p.assoc_dist2 = assoc_dist2;
  p.fit_b = fit_b;
  p.normal_c = normal_c;
  p.d_c = d_c;
  p.cand_valid = cand_valid;
  p.labels = labels;
  p.block_valid = block_valid;
  // two int label buffers, the neighbour mask and the validity per block,
  // and a staged chunk of kChunk blocks' moments as doubles (which must
  // also hold two rows of block fits as floats)
  const int B = hb * wb;
  const int smem = B * (2 * static_cast<int>(sizeof(int)) + 2) +
                   kChunk * kFeatStaged * static_cast<int>(sizeof(double));
  if (smem > kCcDynamicSmem ||
      7 * wb * min(hb, 2) > 2 * kFeatStaged * kChunk) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static int opted = 0;  // the opt-in above 48 KB, for the largest asked
  if (smem > opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        plane_components_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted = smem;
  }
  if (batch > 65535) return static_cast<int>(cudaErrorInvalidValue);
  plane_fits_kernel<<<dim3((B + kFitThreads - 1) / kFitThreads, batch),
                      kFitThreads, 0, stream>>>(p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  plane_components_kernel<<<batch, kCcThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

PSL_API int psl_plane_assign_refit(
    const float* depth, const float* alpha, int h, int w, int rs, float fx,
    float fy, float cx, float cy, float geo_tol, float max_distance,
    float dist_thr, float jump_coef, int P, const float* normal,
    const float* d, const unsigned char* valid, const float* mse,
    const float* mean, const float* n_p, int pix_per_block, int batch,
    double* partial, int* label_sub, float* normal_f,
    float* d_f, float* mse_f, float* mean_f, float* n_f,
    unsigned char* alive, cudaStream_t stream) {
  if (P > kMaxPlanes || rs < 1 || pix_per_block < 1 || batch < 1 ||
      batch > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const PixParams p =
      pix_params(depth, alpha, h, w, rs, fx, fy, cx, cy, geo_tol,
                 max_distance, dist_thr, jump_coef, P, normal, d, valid, mse, mean,
                 n_p);
  const int refine = mse != nullptr ? 1 : 0;
  const int hs = (h + rs - 1) / rs, ws = (w + rs - 1) / rs;
  // the caller sized `partial` as batch x n_part x P x 10 float64
  const int n_part = (hs * ws + pix_per_block - 1) / pix_per_block;
  plane_assign_kernel<<<dim3(n_part, batch), kPixThreads, 0, stream>>>(
      p, refine, hs, ws, pix_per_block, label_sub, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  plane_refit_kernel<<<batch, kMaxPlanes * kFeat, 0, stream>>>(
      p, refine, n_part, partial, static_cast<float>(rs * rs), normal_f, d_f,
      mse_f, mean_f, n_f, alive);
  return static_cast<int>(cudaGetLastError());
}

PSL_API int psl_plane_label_pixels(
    const float* depth, const float* alpha, int h, int w, float fx, float fy,
    float cx, float cy, float geo_tol, float max_distance, float dist_thr,
    float jump_coef, int P, const float* normal, const float* d,
    const unsigned char* valid, const float* mse, const float* mean,
    const float* n_p, int min_size, int batch,
    const int* label_in, float* coeffs, unsigned char* valid_out,
    int* count_out, int* pixel_label, cudaStream_t stream) {
  if (P > kMaxPlanes || batch < 1 || batch > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const PixParams p =
      pix_params(depth, alpha, h, w, 1, fx, fy, cx, cy, geo_tol,
                 max_distance, dist_thr, jump_coef, P, normal, d, valid, mse, mean,
                 n_p);
  const int blocks = (h * w + kPixThreads - 1) / kPixThreads;
  plane_label_kernel<<<dim3(blocks < 1 ? 1 : blocks, batch), kPixThreads, 0,
                       stream>>>(
      p, min_size, label_in, coeffs, valid_out, count_out, pixel_label);
  return static_cast<int>(cudaGetLastError());
}
