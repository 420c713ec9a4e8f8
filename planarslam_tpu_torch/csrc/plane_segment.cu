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
// registers, so no full-resolution temporary exists. A K13 round is one
// launch (three per frame): its logical blocks publish their partials,
// each with a flag word, to the frame's collector blocks (one per plane),
// which load a plane's terms as the blocks publish, so no second kernel
// waits for the first and the loads run beside the assign pass; the flag
// words (one per logical block and a ticket per frame of a launch, the
// caller's per stream) are zeroed once by the caller and cleared by the
// frame's last collector, so no launch zeroes them and a captured step can
// replay the kernel. A block publishes with a release store and a
// collector reads its flag with an acquire load before the block's
// partial. What bounds a
// round is its chain: the ghost merge (one thread a pair of planes), the
// assign pass (the ten moment trees of a warp share their shuffles), the
// publication, the last block's terms (none loaded for a block whose
// plane mask lacks the plane), the 150 in-order additions of a sum and
// the fit, by a half-warp that spreads every step's divisions over its
// lanes (a one-thread fit is ~40 dependent divisions). K14's cost is its
// per-block prologue (the planes' gate and a barrier) and its per-pixel
// instructions: a block takes a tile of 4 x 128 pixels (600 a 640x480
// frame), four a thread from vector loads, against the alive planes only,
// with the back-projection's divisions once a column and once a row
// (plane_label_kernel).
//
// Batches. Every input and output may carry a leading B of independent
// frames, all served by one launch of each kernel (K13: one launch for up
// to kCollectFrames frames): K12's fits take the frame from blockIdx.y
// and its chain one block per frame, K13 and K14 take the frame from
// blockIdx.y. A block reads its frame at
// the frame's strides, so a frame's result does not depend on B.
//
// Sums have a fixed order and no float atomics. K12 counts component
// support with integer atomics (the counts are whole numbers) and sums
// each top component's moments per lane in ascending block order, in
// float64, then over the lanes by a shuffle tree. K13 sums each warp's 32
// pixels by a float64 shuffle tree into the warp's own shared accumulator,
// the warps of a block in order, the blocks' partials in order in the
// frame's collector, which also fits the planes. Two launches on equal
// inputs give equal bits, and the bits of K13's first version (one thread
// a fit, a tree a value, every partial added).
#include <math.h>
#include <stdint.h>

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
constexpr int kPixSteps = 2;   // K13: pixels a thread loads ahead
// K13: a logical block's flag word, its plane mask with this bit set
constexpr unsigned kPublished = 0x80000000u;
// K13: frames a launch collects (P collector blocks each, which wait),
// and the most logical blocks a frame may have: the flag words a stream
// needs are kCollectFrames x (kAssignMaxParts + 1)
constexpr int kCollectFrames = 8;
constexpr int kAssignMaxParts = 16384;
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
  unsigned char shadow[kMaxPlanes];  // K13's ghost merge
};

// planes.py:368-380: the ghost merge of a refine round and tau, by the
// whole block: one thread a pair (j, i) of planes tests whether i shadows
// j, then thread j < P fills its plane's entry (its own arrays loaded
// before the pairs' barriers). The caller synchronizes after it.
__device__ __forceinline__ void load_planes(const PixParams& p, bool refine,
                                            PlaneSet& ps) {
  const int t = threadIdx.x;
  const bool mine = t < p.P;
  float normal[3] = {0.0f, 0.0f, 0.0f}, d = 0.0f, n_p = 0.0f, mse = 0.0f;
  bool valid = false;
  if (mine) {
    for (int q = 0; q < 3; ++q) normal[q] = p.normal[3 * t + q];
    d = p.d[t];
    valid = p.valid[t] != 0;
    if (refine) {
      n_p = p.n_p[t];
      mse = p.mse[t];
    }
  }
  if (refine) {
    if (mine) ps.shadow[t] = 0;
    __syncthreads();
    const float alpha = *p.alpha;
    for (int pair = t; pair < p.P * p.P; pair += blockDim.x) {
      const int j = pair / p.P, i = pair % p.P;
      const bool alive_j = p.valid[j] != 0 && p.n_p[j] > 3.0f;
      const float zc = fmaxf(p.mean[3 * j + 2], 1.0f);
      const float band_j = fmaxf(3.0f * alpha * (zc * zc), p.dist_thr);
      const bool alive_i = p.valid[i] != 0 && p.n_p[i] > 3.0f;
      const float cosm = psl_dot3(p.normal + 3 * j, p.normal + 3 * i);
      const float cen_d =
          fabsf(psl_dot3(p.mean + 3 * j, p.normal + 3 * i) + p.d[i]);
      if (alive_i && alive_j && p.n_p[i] > p.n_p[j] && cosm > kCos25 &&
          cen_d < band_j) {
        ps.shadow[j] = 1;
      }
    }
    __syncthreads();
  }
  if (!mine) return;
  for (int q = 0; q < 3; ++q) ps.normal[t][q] = normal[q];
  ps.d[t] = d;
  bool alive = valid;
  float tau = INFINITY;
  if (refine) {
    alive = alive && n_p > 3.0f && !ps.shadow[t];
    tau = fmaxf(2.5f * sqrtf(fmaxf(mse, 0.0f)), 1e-3f);
  }
  ps.alive[t] = alive ? 1 : 0;
  ps.tau[t] = tau;
}

// psl_plane_from_moments (eig3.cuh) by the 16 lanes of a half-warp, each
// with the plane's moments: every operation of the one-thread version in
// its order, each step's independent divisions, square roots and cosines
// spread over the lanes (one each) and gathered by width-16 shuffles, so
// the chain holds one division where the thread's held up to twelve.
// Every lane ends with the same result, bit-equal to the thread's.
__device__ __forceinline__ float lane_pick(const float* a, int n, int i) {
  float r = a[0];
#pragma unroll
  for (int k = 1; k < 12; ++k) {
    if (k < n && k == i) r = a[k];
  }
  return r;
}

__device__ __forceinline__ float gather16(float v, int src) {
  return __shfl_sync(0xffffffffu, v, src, 16);
}

// psl_unit_or of two vectors at once (lanes 0-2 divide the first, 3-5
// the second)
__device__ __forceinline__ void unit_or_pair(float* a, int axis_a, float* b,
                                             int axis_b) {
  const int l = threadIdx.x & 15;
  const float sq = sqrtf(l & 1 ? psl_dot3(b, b) : psl_dot3(a, a));
  const float nrm_a = gather16(sq, 0), nrm_b = gather16(sq, 1);
  const float den_a = fmaxf(nrm_a, 1e-30f), den_b = fmaxf(nrm_b, 1e-30f);
  const float num[6] = {a[0], a[1], a[2], b[0], b[1], b[2]};
  float x = 0.0f;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    if (k == l) x = num[k];
  }
  const float quo = x / (l < 3 ? den_a : den_b);
  for (int k = 0; k < 3; ++k) {  // the shuffles outside the branches
    const float qa = gather16(quo, k), qb = gather16(quo, 3 + k);
    a[k] = nrm_a > 1e-20f ? qa : (axis_a == k ? 1.0f : 0.0f);
    b[k] = nrm_b > 1e-20f ? qb : (axis_b == k ? 1.0f : 0.0f);
  }
}

// eig3.cuh::psl_eigenvector_for without its psl_unit_or
__device__ __forceinline__ void eigenvector_pick(const float* A, float lam,
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
  const bool p01 = n01 >= n02 && n01 >= n12, p02 = n02 >= n12;
  for (int k = 0; k < 3; ++k) v[k] = p01 ? c01[k] : (p02 ? c02[k] : c12[k]);
}

__device__ __forceinline__ void plane_from_moments_lanes(
    const float* s1, const float* s2, float n, float* normal, float* d,
    float* mse, float* mean) {
  const int l = threadIdx.x & 15;
  const float n_safe = fmaxf(n, 1.0f);
  // mean and s2 / n: lanes 0-2 and 3-11
  const float mom[12] = {s1[0], s1[1], s1[2], s2[0], s2[1], s2[2], s2[3],
                         s2[4], s2[5], s2[6], s2[7], s2[8]};
  const float q12 = lane_pick(mom, 12, l) / n_safe;
  for (int i = 0; i < 3; ++i) mean[i] = gather16(q12, i);
  float cov[9];
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) {
      cov[3 * i + j] = gather16(q12, 3 + 3 * i + j) - mean[i] * mean[j];
      if (i == j) cov[3 * i + j] = cov[3 * i + j] + 1e-12f;
    }
  }
  // psl_eigh_sym3x3(cov)
  float A[9];
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) {
      A[3 * i + j] = 0.5f * (cov[3 * i + j] + cov[3 * j + i]);
    }
  }
  float amax = 0.0f;
  for (int i = 0; i < 9; ++i) amax = fmaxf(amax, fabsf(A[i]));
  const float scale = fmaxf(amax, 1e-30f);
  const float qa = lane_pick(A, 9, l) / scale;
  for (int i = 0; i < 9; ++i) A[i] = gather16(qa, i);
  const float a00 = A[0], a11 = A[4], a22 = A[8];
  const float a01 = A[1], a02 = A[2], a12 = A[5];
  const float q = (a00 + a11 + a22) / 3.0f;
  const float b00 = a00 - q, b11 = a11 - q, b22 = a22 - q;
  const float p2 = b00 * b00 + b11 * b11 + b22 * b22 +
                   2.0f * (a01 * a01 + a02 * a02 + a12 * a12);
  const float p = sqrtf(fmaxf(p2 / 6.0f, 1e-30f));
  const float bs[6] = {b00, b11, b22, a01, a02, a12};
  const float qc = lane_pick(bs, 6, l) / p;
  const float c00 = gather16(qc, 0), c11 = gather16(qc, 1);
  const float c22 = gather16(qc, 2), c01 = gather16(qc, 3);
  const float c02 = gather16(qc, 4), c12 = gather16(qc, 5);
  const float detBn = c00 * (c11 * c22 - c12 * c12) -
                      c01 * (c01 * c22 - c12 * c02) +
                      c02 * (c01 * c12 - c11 * c02);
  const float r = fminf(fmaxf(detBn / 2.0f, -1.0f), 1.0f);
  const float phi = acosf(r) / 3.0f;
  const float two_p = 2.0f * p;
  const float cs = cosf(l & 1 ? phi + 2.0943951023931953f : phi);
  const float e_hi = q + two_p * gather16(cs, 0);
  const float e_lo = q + two_p * gather16(cs, 1);
  float v_lo[3], v_hi[3], v_mid[3];
  eigenvector_pick(A, e_lo, v_lo);
  eigenvector_pick(A, e_hi, v_hi);
  unit_or_pair(v_lo, 2, v_hi, 2);
  psl_cross3(v_hi, v_lo, v_mid);
  const float sq = sqrtf(psl_dot3(v_mid, v_mid));
  const float mid_den = fmaxf(sq, 1e-30f);
  const float qm = lane_pick(v_mid, 3, l) / mid_den;
  for (int k = 0; k < 3; ++k) {
    const float g = gather16(qm, k);
    v_mid[k] = sq > 1e-20f ? g : (k == 1 ? 1.0f : 0.0f);
  }
  psl_cross3(v_mid, v_hi, v_lo);
  const float den = fmaxf(sqrtf(psl_dot3(v_lo, v_lo)), 1e-30f);
  const float qv = lane_pick(v_lo, 3, l) / den;
  for (int k = 0; k < 3; ++k) normal[k] = gather16(qv, k);
  *mse = e_lo * scale;
  if (psl_dot3(normal, mean) > 0.0f) {
    normal[0] = -normal[0];
    normal[1] = -normal[1];
    normal[2] = -normal[2];
  }
  *d = -psl_dot3(normal, mean);
}

// The float64 shfl_down tree of each of a warp's kFeat values (lane 0's
// x += shfl_down(x, o), o = 16, 8, 4, 2, 1), all of them at once: at each
// level a lane keeps the node of one of two values and trades the other
// with its partner, so every node is still the sum of the same two
// children (a + b = b + a in IEEE) while the warp makes 12 exchanges where
// the kFeat trees made 50 shuffles. Returns this lane's root: an even
// lane l holds the root of value tree_value(l) when that is below kFeat
// (value f's bits 0-3 are the lane's bits 4, 3, 2 and 1).
__device__ __forceinline__ int tree_value(int lane) {
  return ((lane >> 4) & 1) | (((lane >> 3) & 1) << 1) |
         (((lane >> 2) & 1) << 2) | (((lane >> 1) & 1) << 3);
}

// one level: n values -> (n + 1) / 2, partner lane ^ o
template <int kN>
__device__ __forceinline__ void tree_level(const double* in, double* out,
                                           int o) {
  const bool upper = (threadIdx.x & o) != 0;
#pragma unroll
  for (int k = 0; k < (kN + 1) / 2; ++k) {
    const double lo = in[2 * k], hi = 2 * k + 1 < kN ? in[2 * k + 1] : 0.0;
    const double send = upper ? lo : hi, keep = upper ? hi : lo;
    out[k] = keep + __shfl_xor_sync(0xffffffffu, send, o);
  }
}

__device__ __forceinline__ double moment_tree(const double (&v)[kFeat]) {
  static_assert(kFeat == 10, "moment_tree's levels are for ten values");
  double a[5], b[3], c[2], d[1];
  tree_level<10>(v, a, 16);
  tree_level<5>(a, b, 8);
  tree_level<3>(b, c, 4);
  tree_level<2>(c, d, 2);
  return d[0] + __shfl_xor_sync(0xffffffffu, d[0], 1);
}

// A flag word read with acquire semantics at the card's scope: the loads
// after it see what the block wrote before it published.
__device__ __forceinline__ unsigned load_acquire(const unsigned* ptr) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(ptr)
               : "memory");
  return v;
}

// A flag word published with release semantics at the card's scope.
__device__ __forceinline__ void store_release(unsigned* ptr, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;"
               :
               : "l"(ptr), "r"(v)
               : "memory");
}

// The ten terms src[0..9] where `on`, else +0: predicated loads in one
// asm, so they stay in flight together and none moves above the acquire
// load before it.
__device__ __forceinline__ void load_terms(const double* src, bool on,
                                           double (&v)[kFeat]) {
  static_assert(kFeat == 10, "load_terms loads ten terms");
#pragma unroll
  for (int q = 0; q < kFeat; ++q) v[q] = 0.0;
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.u32 p, %11, 0;\n"
      " @p ld.global.f64 %0, [%10];\n @p ld.global.f64 %1, [%10+8];\n"
      " @p ld.global.f64 %2, [%10+16];\n @p ld.global.f64 %3, [%10+24];\n"
      " @p ld.global.f64 %4, [%10+32];\n @p ld.global.f64 %5, [%10+40];\n"
      " @p ld.global.f64 %6, [%10+48];\n @p ld.global.f64 %7, [%10+56];\n"
      " @p ld.global.f64 %8, [%10+64];\n @p ld.global.f64 %9, [%10+72];\n}"
      : "+d"(v[0]), "+d"(v[1]), "+d"(v[2]), "+d"(v[3]), "+d"(v[4]),
        "+d"(v[5]), "+d"(v[6]), "+d"(v[7]), "+d"(v[8]), "+d"(v[9])
      : "l"(src), "r"(static_cast<unsigned>(on))
      : "memory");
}

// The depths a pixel (v, u) reads: its own, its right and its lower
// neighbour's (0 past the image's edge, where they are not read).
struct PixDepth {
  float z, right, down;
};

__device__ __forceinline__ PixDepth load_pixel(const PixParams& p, int v,
                                               int u) {
  PixDepth d;
  d.z = p.depth[v * p.w + u];
  d.right = u + 1 < p.w ? p.depth[v * p.w + u + 1] : 0.0f;
  d.down = v + 1 < p.h ? p.depth[(v + 1) * p.w + u] : 0.0f;
  return d;
}

// A pixel's depth-range and jump gate against its right and lower
// neighbours (a jump of 0 where the neighbour lies past the image's edge)
// and its band. K13's assign pass and K14 share it, and the helpers
// below, so that their labels agree to the bit.
struct PixGate {
  bool ok;
  float band;
};

__device__ __forceinline__ PixGate pixel_gate(const PixParams& p,
                                              float alpha, float z,
                                              float right, float down,
                                              bool has_r, bool has_d) {
  const float zc = fmaxf(z, 1.0f);
  const float z2 = zc * zc;
  const float tol = fmaxf(p.geo_tol * zc, p.jump_coef * alpha * z2);
  const float jump_r = has_r ? fabsf(z - right) : 0.0f;
  const float jump_d = has_d ? fabsf(z - down) : 0.0f;
  PixGate g;
  g.ok = z > 1e-6f && z < p.max_distance && jump_r < tol && jump_d < tol;
  g.band = fmaxf(3.0f * alpha * z2, p.dist_thr);
  return g;
}

// A back-projection's column term (u - cx) / fx or row term (v - cy) / fy.
__device__ __forceinline__ float grid_term(int i, float c, float f) {
  return (static_cast<float>(i) - c) / f;
}

// A back-projected point's distance to the plane (n, d), in the plain
// version's order.
__device__ __forceinline__ float plane_dist(float x, float y, float z,
                                            float n0, float n1, float n2,
                                            float d) {
  return fabsf(x * n0 + y * n1 + z * n2 + d);
}

// Whether a pixel keeps its nearest plane: within the plane's tau and the
// pixel's band, and through the gate.
__device__ __forceinline__ bool pixel_keep(const PixGate& g, float best_d,
                                           float tau) {
  return best_d < fminf(tau, g.band) && g.ok;
}

// One pixel (v, u) of the full-resolution grid from its depths:
// back-projection, the gate, the nearest alive plane (first index on
// ties) and the band / tau gate. Returns the plane or -1.
__device__ __forceinline__ int assign_pixel(const PixParams& p,
                                            const PlaneSet& ps, float alpha,
                                            int v, int u, const PixDepth& dp,
                                            float* pt) {
  const float z = dp.z;
  const PixGate g =
      pixel_gate(p, alpha, z, dp.right, dp.down, u + 1 < p.w, v + 1 < p.h);
  const float x = grid_term(u, p.cx, p.fx) * z;
  const float y = grid_term(v, p.cy, p.fy) * z;
  pt[0] = x;
  pt[1] = y;
  pt[2] = z;
  int best = 0;
  float best_d = INFINITY;
  for (int j = 0; j < p.P; ++j) {
    if (!ps.alive[j]) continue;
    const float dist = plane_dist(x, y, z, ps.normal[j][0], ps.normal[j][1],
                                  ps.normal[j][2], ps.d[j]);
    if (dist < best_d) {
      best_d = dist;
      best = j;
    }
  }
  return pixel_keep(g, best_d, ps.tau[best]) ? best : -1;
}

// K13's collector of plane j of a frame (P collectors a frame): the
// plane's in-order sums and its fit. Thread t waits for logical block c0
// + t's flag, then loads the block's ten sums of plane j into shared
// memory (none when the block's mask lacks the plane: x never holds -0,
// so adding +0 for it keeps the bits), so the loads run as the blocks
// publish; lane q < 10 of warp 0 then adds feature q in block order.
// Warp 0 fits the plane while warp 1 takes the frame's collectors'
// ticket: the last collector to finish clears the frame's flags.
__device__ __forceinline__ void collect_plane(
    const PixParams& p, size_t frame, int j, int n_part, float area,
    const double* partial, unsigned* flags, unsigned* done,
    const PlaneSet& ps, double* vals, float* normal_f, float* d_f,
    float* mse_f, float* mean_f, float* n_f, unsigned char* alive_out) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row = p.P * kFeat;
  // the in-order sums
  double x = 0.0;
  for (int c0 = 0; c0 < n_part; c0 += kPixThreads) {
    const int cn = min(kPixThreads, n_part - c0);
    if (c0 > 0) __syncthreads();  // the last chunk's terms are added
    if (tid < cn) {
      unsigned f;
      while ((f = load_acquire(flags + c0 + tid)) == 0u) __nanosleep(32);
      const double* src =
          partial + static_cast<size_t>(c0 + tid) * row + j * kFeat;
      double v[kFeat];
      load_terms(src, ((f >> j) & 1u) != 0u, v);
#pragma unroll
      for (int q = 0; q < kFeat; ++q) vals[q * kPixThreads + tid] = v[q];
    }
    __syncthreads();
    if (tid < kFeat) {
#pragma unroll 8
      for (int b = 0; b < cn; ++b) x += vals[tid * kPixThreads + b];
    }
  }
  __syncthreads();  // every flag read, every term added
  if (warp == 1) {
    // the ticket: the last collector clears the frame's flags
    unsigned last = 0u;
    if (lane == 0) {
      __threadfence();
      last = atomicAdd(done, 1u) == static_cast<unsigned>(p.P - 1);
      if (last) *done = 0u;
    }
    if (__shfl_sync(0xffffffffu, last, 0)) {
      for (int b = lane; b < n_part; b += 32) flags[b] = 0u;
    }
    return;
  }
  if (warp != 0) return;
  // the fits: plane j by warp 0's first half-warp
  const float a = lane < kFeat ? static_cast<float>(x) * area : 0.0f;
  float m[kFeat];
#pragma unroll
  for (int k = 0; k < kFeat; ++k) m[k] = __shfl_sync(0xffffffffu, a, k);
  const float s2[9] = {m[3], m[4], m[5], m[4], m[6], m[7], m[5], m[7], m[8]};
  float normal[3], d, mse, mean[3];
  plane_from_moments_lanes(m, s2, m[9], normal, &d, &mse, mean);
  if (lane == 0) {
    const size_t o = frame * p.P + j;
    for (int k = 0; k < 3; ++k) {
      normal_f[3 * o + k] = normal[k];
      mean_f[3 * o + k] = mean[k];
    }
    d_f[o] = d;
    mse_f[o] = mse;
    n_f[o] = m[9];
    alive_out[o] = ps.alive[j];
  }
}

// K13, one round in one launch: grid (n_part + P, frames), block x <
// n_part the logical 512-pixel block x of frame frame0 + y, block n_part
// + j the collector of the frame's plane j. Every logical block labels
// its pixels, writes its partial moment sums per plane and publishes them
// in its flag word with its plane mask; each collector gathers its
// plane's sums as they are published, adds them in block order and fits
// the plane. Only collectors wait, and only on blocks that never wait,
// so no order of dispatch can hang a launch that leaves the card slots
// besides its collectors (the entry checks that it does).
__global__ void __launch_bounds__(kPixThreads, 4)
    plane_assign_refit_kernel(const PixParams p_batch, int frame0,
                              int refine, int hs, int ws, int pix_per_block,
                              float area, int* label_sub, double* partial,
                              unsigned* flags, float* normal_f, float* d_f,
                              float* mse_f, float* mean_f, float* n_f,
                              unsigned char* alive_out) {
  __shared__ PlaneSet ps;
  __shared__ double acc[kPixWarps][kMaxPlanes][kFeat];
  __shared__ unsigned touched;  // the planes this block's pixels took
  const size_t frame = frame0 + blockIdx.y;
  const PixParams p = pix_at(p_batch, static_cast<int>(frame));
  const int n_part = gridDim.x - p.P, row = p.P * kFeat;
  label_sub += frame * hs * ws;
  partial += frame * n_part * row;
  // the flag words of the launch's frame y: one per logical block, then
  // its collectors' ticket
  flags += blockIdx.y * (n_part + 1);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const bool collector = static_cast<int>(blockIdx.x) >= n_part;
  // the depths of a thread's first kPixSteps pixels, loaded before the
  // ghost merge (they do not depend on it)
  const int S = hs * ws;
  const int base = blockIdx.x * pix_per_block;
  PixDepth dp[kPixSteps];
  if (!collector) {
#pragma unroll
    for (int k = 0; k < kPixSteps; ++k) {
      const int o = k * kPixThreads, s = base + o + tid;
      if (o + tid < pix_per_block && s < S) {
        dp[k] = load_pixel(p, (s / ws) * p.rs, (s % ws) * p.rs);
      }
    }
  }
  // the planes: the ghost merge, once per block
  load_planes(p, refine != 0, ps);
  if (collector) {
    // the collectors stage their terms in the accumulators' words
    collect_plane(p, frame, blockIdx.x - n_part, n_part, area, partial,
                  flags, flags + n_part, ps, &acc[0][0][0], normal_f, d_f,
                  mse_f, mean_f, n_f, alive_out);
    return;
  }
  for (int q = tid; q < kPixWarps * kMaxPlanes * kFeat; q += kPixThreads) {
    (&acc[0][0][0])[q] = 0.0;
  }
  if (tid == 0) touched = 0u;
  __syncthreads();
  // assign: each pixel's plane, each warp's moment sums per plane by a
  // float64 shuffle tree into the warp's accumulator; the depths of a
  // thread's kPixSteps pixels are loaded before the first is assigned
  const float alpha = *p.alpha;
  for (int off0 = 0; off0 < pix_per_block; off0 += kPixSteps * kPixThreads) {
    if (off0 > 0) {
#pragma unroll
      for (int k = 0; k < kPixSteps; ++k) {
        const int o = off0 + k * kPixThreads, s = base + o + tid;
        if (o + tid < pix_per_block && s < S) {
          dp[k] = load_pixel(p, (s / ws) * p.rs, (s % ws) * p.rs);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kPixSteps; ++k) {
      const int off = off0 + k * kPixThreads, s = base + off + tid;
      int label = -1;
      float pt[3] = {0.0f, 0.0f, 0.0f};
      if (off + tid < pix_per_block && s < S) {
        label = assign_pixel(p, ps, alpha, (s / ws) * p.rs, (s % ws) * p.rs,
                             dp[k], pt);
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
        double v[kFeat];
#pragma unroll
        for (int q = 0; q < kFeat; ++q) {
          v[q] = mine ? static_cast<double>(f[q]) : 0.0;
        }
        const double x = moment_tree(v);
        if ((lane & 1) == 0 && tree_value(lane) < kFeat) {
          acc[warp][j][tree_value(lane)] += x;
        }
      }
    }
  }
  __syncthreads();
  // this block's partial: its warps summed in order; a plane no pixel
  // took has every sum +0 (its count, the last feature, is 0)
  for (int q = tid; q < row; q += kPixThreads) {
    double x = 0.0;
    for (int w = 0; w < kPixWarps; ++w) x += acc[w][q / kFeat][q % kFeat];
    partial[static_cast<size_t>(blockIdx.x) * row + q] = x;
    if (q % kFeat == kFeat - 1 && x != 0.0) {
      atomicOr(&touched, 1u << (q / kFeat));
    }
  }
  // publish: the partial visible device-wide, then the flag
  __threadfence();
  __syncthreads();
  if (tid == 0) store_release(flags + blockIdx.x, touched | kPublished);
}

// K14's planes of a frame after the final gate: the alive ones, packed
// in ascending order of their index (the first index wins a tie, as in
// the plain version's argmin), with that index.
struct LabelPlanes {
  float normal[kMaxPlanes][3];
  float d[kMaxPlanes];
  float tau[kMaxPlanes];
  int index[kMaxPlanes];
  int n_alive;
  unsigned char alive[kMaxPlanes];  // by plane index (the label_in mode)
};

// The final gate of the P <= 32 planes by warp 0 (planes.py:439-446):
// the count and mse gate, tau, the alive planes packed by a ballot; the
// writer block also stores plane.py::normalize's coefficients (zeros
// where invalid), the validity and the counts.
__device__ __forceinline__ void gate_planes(const PixParams& p, float alpha,
                                            int min_size, bool writer,
                                            LabelPlanes& ps, float* coeffs,
                                            unsigned char* valid_out,
                                            int* count_out) {
  const int lane = threadIdx.x;
  bool ok = false;
  float c[4] = {0.0f, 0.0f, 0.0f, 0.0f}, tau = 0.0f;
  if (lane < p.P) {
    const int count = static_cast<int>(p.n_p[lane]);
    const float mz = p.mean[3 * lane + 2];
    const float g = fmaxf(2.0f * alpha * (mz * mz), p.dist_thr);
    ok = p.valid[lane] != 0 && count >= min_size && p.mse[lane] < g * g;
    for (int q = 0; q < 3; ++q) c[q] = p.normal[3 * lane + q];
    c[3] = p.d[lane];
    tau = fmaxf(2.5f * sqrtf(fmaxf(p.mse[lane], 0.0f)), 1e-3f);
    ps.alive[lane] = ok ? 1 : 0;
    if (writer) {
      float e[4];
      const float nrm =
          sqrtf(c[0] * c[0] + c[1] * c[1] + c[2] * c[2] + 1e-9f);
      for (int q = 0; q < 4; ++q) e[q] = c[q] / nrm;
      const float sgn = e[3] < 0.0f ? -1.0f : 1.0f;
      for (int q = 0; q < 4; ++q) {
        coeffs[4 * lane + q] = ok ? e[q] * sgn : 0.0f;
      }
      valid_out[lane] = ok ? 1 : 0;
      count_out[lane] = count;
    }
  }
  const unsigned alive = __ballot_sync(0xffffffffu, ok);
  if (ok) {
    const int k = __popc(alive & ((1u << lane) - 1u));
    for (int q = 0; q < 3; ++q) ps.normal[k][q] = c[q];
    ps.d[k] = c[3];
    ps.tau[k] = tau;
    ps.index[k] = lane;
  }
  if (lane == 0) ps.n_alive = __popc(alive);
}

// Four pixels of a row from their depths, their right and lower
// neighbours' (has_r: inside the image; has_d: the row below is), their
// column terms and the row's: assign_pixel's gate, back-projection and
// keep per pixel, the loop over the alive planes shared by the four. out:
// the plane or -1.
__device__ __forceinline__ void label_four(
    const PixParams& p, const LabelPlanes& ps, float alpha,
    const float (&z)[4], const float (&right)[4], const float (&down)[4],
    const bool (&has_r)[4], bool has_d, const float* xt, float yt,
    int (&out)[4]) {
  PixGate g[4];
  float x[4], y[4], best_d[4];
  int best[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    g[i] = pixel_gate(p, alpha, z[i], right[i], down[i], has_r[i], has_d);
    x[i] = xt[i] * z[i];
    y[i] = yt * z[i];
    best_d[i] = INFINITY;
    best[i] = 0;
  }
  for (int k = 0; k < ps.n_alive; ++k) {
    const float n0 = ps.normal[k][0], n1 = ps.normal[k][1],
                n2 = ps.normal[k][2], d = ps.d[k];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float dist = plane_dist(x[i], y[i], z[i], n0, n1, n2, d);
      if (dist < best_d[i]) {
        best_d[i] = dist;
        best[i] = k;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[i] = pixel_keep(g[i], best_d[i], ps.tau[best[i]]) ? ps.index[best[i]]
                                                           : -1;
  }
}

// K14: the final gate per plane and the label of every pixel against the
// planes that pass. A block a tile of kLabelRows rows by kLabelCols
// columns, a warp a row, a thread four pixels of it; the frame in
// blockIdx.y. Each thread first issues its loads, then warp 0 gates the
// planes (block 0 of a frame writes the gate's outputs) and the block
// computes the tile's column terms into shared memory and each thread its
// row's term (the same float32 divisions as per pixel, so the same
// bits). kMode kLabelVec (W a multiple of 4, the buffers 16-byte
// aligned): float4 loads of the row and of the row below, the fourth
// pixel's right neighbour from the next lane by a shuffle (a scalar load
// at the warp's edge), one int4 store. kLabelScalar: scalar loads and
// stores, any width. kLabelGather (refine stride 1): the last round's
// labels gated by the planes' validity.
constexpr int kLabelVec = 0, kLabelScalar = 1, kLabelGather = 2;
constexpr int kLabelRows = 4;
constexpr int kLabelCols = 128;  // 32 lanes x 4 pixels

template <int kMode>
__global__ void __launch_bounds__(32 * kLabelRows)
    plane_label_kernel(const PixParams p_batch, int min_size, int tiles_x,
                       const int* label_in, float* coeffs,
                       unsigned char* valid_out, int* count_out,
                       int* pixel_label) {
  __shared__ LabelPlanes ps;
  __shared__ float col[kLabelCols];
  const int tid = threadIdx.x, lane = tid & 31;
  const PixParams p = pix_at(p_batch, blockIdx.y);
  const long long n_pix = static_cast<long long>(p.h) * p.w;
  {  // this block's frame
    const size_t f = blockIdx.y;
    if (kMode == kLabelGather) label_in += f * n_pix;
    coeffs += 4 * f * p.P;
    valid_out += f * p.P;
    count_out += f * p.P;
    pixel_label += f * n_pix;
  }
  const int ty = blockIdx.x / tiles_x;
  const int u0 = (blockIdx.x - ty * tiles_x) * kLabelCols;
  const int v = ty * kLabelRows + (tid >> 5);
  const int u = u0 + 4 * lane;
  const bool has_d = v + 1 < p.h;
  const long long s0 = static_cast<long long>(v) * p.w + u;
  bool in[4], has_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    in[i] = v < p.h && u + i < p.w;
    has_r[i] = u + i + 1 < p.w;
  }
  float z[4] = {}, right[4] = {}, down[4] = {};
  int lbl[4] = {-1, -1, -1, -1};
  if (kMode == kLabelVec) {
    const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const float4* depth4 = reinterpret_cast<const float4*>(p.depth);
    const float4 c = in[0] ? __ldg(depth4 + s0 / 4) : zero;
    const float4 dn =
        in[0] && has_d ? __ldg(depth4 + (s0 + p.w) / 4) : zero;
    float next = __shfl_down_sync(0xffffffffu, c.x, 1);
    if (lane == 31 && in[0] && has_r[3]) next = __ldg(p.depth + s0 + 4);
    z[0] = c.x, z[1] = c.y, z[2] = c.z, z[3] = c.w;
    down[0] = dn.x, down[1] = dn.y, down[2] = dn.z, down[3] = dn.w;
    right[3] = next;
  } else if (kMode == kLabelScalar) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (in[i]) {
        z[i] = __ldg(p.depth + s0 + i);
        if (has_d) down[i] = __ldg(p.depth + s0 + p.w + i);
      }
    }
    if (in[3] && has_r[3]) right[3] = __ldg(p.depth + s0 + 4);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (in[i]) lbl[i] = label_in[s0 + i];
    }
  }
  right[0] = z[1], right[1] = z[2], right[2] = z[3];
  const float alpha = *p.alpha;
  if (tid < 32) {
    gate_planes(p, alpha, min_size, blockIdx.x == 0, ps, coeffs, valid_out,
                count_out);
  }
  float yt = 0.0f;
  if (kMode != kLabelGather) {
    for (int i = tid; i < kLabelCols && u0 + i < p.w; i += 32 * kLabelRows) {
      col[i] = grid_term(u0 + i, p.cx, p.fx);
    }
    yt = grid_term(v, p.cy, p.fy);
  }
  __syncthreads();
  if (!in[0]) return;
  int out[4];
  if (kMode == kLabelGather) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[i] = lbl[i] >= 0 && lbl[i] < p.P && ps.alive[lbl[i]] ? lbl[i] : -1;
    }
  } else {
    label_four(p, ps, alpha, z, right, down, has_r, has_d, col + 4 * lane,
               yt, out);
  }
  if (kMode == kLabelVec) {
    reinterpret_cast<int4*>(pixel_label)[s0 / 4] =
        make_int4(out[0], out[1], out[2], out[3]);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (in[i]) pixel_label[s0 + i] = out[i];
    }
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
  const int rc = psl_opt_in_smem(
      reinterpret_cast<const void*>(plane_components_kernel), smem);
  if (rc != 0) return rc;
  if (batch > 65535) return static_cast<int>(cudaErrorInvalidValue);
  plane_fits_kernel<<<dim3((B + kFitThreads - 1) / kFitThreads, batch),
                      kFitThreads, 0, stream>>>(p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  plane_components_kernel<<<batch, kCcThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Flag words psl_plane_assign_refit needs, which a caller keeps per
// stream, zeroed once: kCollectFrames frames of kAssignMaxParts logical
// blocks and a ticket each.
PSL_API long long psl_plane_assign_flag_words() {
  return static_cast<long long>(kCollectFrames) * (kAssignMaxParts + 1);
}

// K13 for `batch` frames, kCollectFrames a launch in turn; *launches is
// the number of launches made.
PSL_API int psl_plane_assign_refit(
    const float* depth, const float* alpha, int h, int w, int rs, float fx,
    float fy, float cx, float cy, float geo_tol, float max_distance,
    float dist_thr, float jump_coef, int P, const float* normal,
    const float* d, const unsigned char* valid, const float* mse,
    const float* mean, const float* n_p, int pix_per_block, int batch,
    double* partial, unsigned* flags, int* label_sub, float* normal_f,
    float* d_f, float* mse_f, float* mean_f, float* n_f,
    unsigned char* alive, int* launches, cudaStream_t stream) {
  *launches = 0;
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
  // the caller sized `partial` as batch x n_part x P x 10 float64 and
  // `flags` as psl_plane_assign_flag_words, zero between launches
  const long long n_part_l =
      (static_cast<long long>(hs) * ws + pix_per_block - 1) / pix_per_block;
  if (n_part_l > kAssignMaxParts) return kPslErrAssignParts;
  const int n_part = static_cast<int>(n_part_l);
  // the collectors of a launch wait for its other blocks: keep half the
  // card's slots for those (resident blocks per card, cached per card)
  static int slots[kPslDevices] = {};
  int* dev_slots = psl_device_slot(slots);
  int resident = dev_slots != nullptr ? *dev_slots : 0;
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, plane_assign_refit_kernel, kPixThreads, 0);
    resident = sms * per_sm;
    if (dev_slots != nullptr) *dev_slots = resident;
  }
  if (2 * kCollectFrames * P > resident) {
    return static_cast<int>(cudaErrorLaunchOutOfResources);
  }
  for (int f0 = 0; f0 < batch; f0 += kCollectFrames) {
    const int frames = batch - f0 < kCollectFrames ? batch - f0
                                                   : kCollectFrames;
    plane_assign_refit_kernel<<<dim3(n_part + P, frames), kPixThreads, 0,
                                stream>>>(
        p, f0, refine, hs, ws, pix_per_block, static_cast<float>(rs * rs),
        label_sub, partial, flags, normal_f, d_f, mse_f, mean_f, n_f,
        alive);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    ++*launches;
  }
  return 0;
}

PSL_API int psl_plane_label_pixels(
    const float* depth, const float* alpha, int h, int w, float fx, float fy,
    float cx, float cy, float geo_tol, float max_distance, float dist_thr,
    float jump_coef, int P, const float* normal, const float* d,
    const unsigned char* valid, const float* mse, const float* mean,
    const float* n_p, int min_size, int batch,
    const int* label_in, float* coeffs, unsigned char* valid_out,
    int* count_out, int* pixel_label, cudaStream_t stream) {
  if (P > kMaxPlanes || batch < 1 || batch > 65535 || h < 1 || w < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const PixParams p =
      pix_params(depth, alpha, h, w, 1, fx, fy, cx, cy, geo_tol,
                 max_distance, dist_thr, jump_coef, P, normal, d, valid, mse, mean,
                 n_p);
  const int tiles_x = (w + kLabelCols - 1) / kLabelCols;
  const long long tiles =
      static_cast<long long>(tiles_x) * ((h + kLabelRows - 1) / kLabelRows);
  if (tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(tiles), batch);
  // every frame's first pixel keeps the base's alignment when w % 4 == 0
  const bool vec = w % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(depth) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(pixel_label) % 16 == 0;
  const auto fn = label_in != nullptr ? plane_label_kernel<kLabelGather>
                  : vec               ? plane_label_kernel<kLabelVec>
                                      : plane_label_kernel<kLabelScalar>;
  fn<<<grid, 32 * kLabelRows, 0, stream>>>(p, min_size, tiles_x, label_in,
                                           coeffs, valid_out, count_out,
                                           pixel_label);
  return static_cast<int>(cudaGetLastError());
}
