// K3 gated_hamming_top2 — gated Hamming distance with per-row best/second.
//
// Replaces the core of planarslam_tpu/ops/matching.py::search_by_projection
// (:169-183): the window, level, validity and stereo gates on the (M, N)
// grid, the Hamming distance (the JAX package's ±1 bf16 matmul,
// ops/orb.py::hamming_distance) and ::_top2_min. Ungated (gated == 0) it is
// the core of ::match_descriptors: only the two validity masks apply.
//
// One 128-thread block owns one row (landmark) of one problem: blockIdx.x
// is the row, blockIdx.y the problem of a batch of B independent (M, N)
// problems (every input and output carries a leading B; one launch serves
// all of them). The row's 8 descriptor words
// live in registers, each thread walks columns j = tid, tid + 128, ... and
// keeps a running (best, best_idx, second); masked entries count as
// INF_DIST = 10000. A warp-shuffle then shared-memory merge of the
// per-thread triples keeps ties on the lowest column index, and a tie with
// the best gives second == best, exactly as _top2_min does.
//
// What bounds it on an H100: L2 bandwidth and integer issue. Every block
// re-reads the N column descriptors (32 B each) and gate fields (~20 B)
// from L2 — 4096 x 1024 x 52 B = 218 MB for the window search, ~50 us at
// L2 rates — against 8 XOR + 8 popcount per pair. Staging column tiles in
// shared memory across several rows per block is the next step.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kInfDist = 10000;

struct Top2 {
  int best;
  int idx;
  int second;
};

__device__ __forceinline__ Top2 merge(Top2 a, Top2 b) {
  const bool a_wins = (a.best < b.best) || (a.best == b.best && a.idx < b.idx);
  Top2 r;
  if (a_wins) {
    r.best = a.best;
    r.idx = a.idx;
    r.second = min(a.second, b.best);
  } else {
    r.best = b.best;
    r.idx = b.idx;
    r.second = min(b.second, a.best);
  }
  return r;
}

__global__ void hamming_top2_kernel(
    const int* __restrict__ a_desc, const int* __restrict__ b_desc, int n,
    const unsigned char* __restrict__ a_ok,
    const unsigned char* __restrict__ b_ok, int gated,
    const float* __restrict__ a_uv, const float* __restrict__ a_r,
    const int* __restrict__ a_level, const float* __restrict__ a_ur_pred,
    const float* __restrict__ b_uv, const int* __restrict__ b_level,
    const float* __restrict__ b_ur, int level_window, int* __restrict__ best,
    int* __restrict__ second, int* __restrict__ best_idx, int m) {
  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  // the problem's rows and columns
  const size_t lane = blockIdx.y;
  const size_t ra = lane * m, cb = lane * n;
  a_desc += 8 * ra;
  b_desc += 8 * cb;
  a_ok += ra;
  b_ok += cb;
  best += ra;
  second += ra;
  best_idx += ra;
  if (gated) {
    a_uv += 2 * ra;
    a_r += ra;
    a_level += ra;
    a_ur_pred += ra;
    b_uv += 2 * cb;
    b_level += cb;
    b_ur += cb;
  }
  unsigned a[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) a[q] = static_cast<unsigned>(a_desc[8 * row + q]);
  const bool row_ok = a_ok[row] != 0;
  float u = 0.0f, v = 0.0f, r = 0.0f, ur_pred = 0.0f;
  int lvl = 0;
  if (gated) {
    u = a_uv[2 * row];
    v = a_uv[2 * row + 1];
    r = a_r[row];
    lvl = a_level[row];
    ur_pred = a_ur_pred[row];
  }

  Top2 t{INT_MAX, INT_MAX, kInfDist};
  for (int j = tid; j < n; j += kThreads) {
    bool g = row_ok && (b_ok[j] != 0);
    if (gated && g) {
      const float du = fabsf(__fsub_rn(u, b_uv[2 * j]));
      const float dv = fabsf(__fsub_rn(v, b_uv[2 * j + 1]));
      const int dl = abs(b_level[j] - lvl);
      const float fur = b_ur[j];
      const bool ur_ok = (fur < 0.0f) || (fabsf(__fsub_rn(ur_pred, fur)) <= r);
      g = (du <= r) && (dv <= r) && (dl <= level_window) && ur_ok;
    }
    int d = kInfDist;
    if (g) {
      d = 0;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        d += __popc(a[q] ^ static_cast<unsigned>(b_desc[8 * j + q]));
      }
    }
    // columns arrive in increasing order per thread: ties keep the earlier
    if (d < t.best) {
      t.second = t.best;
      t.best = d;
      t.idx = j;
    } else {
      t.second = min(t.second, d);
    }
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Top2 o;
    o.best = __shfl_xor_sync(0xffffffffu, t.best, off);
    o.idx = __shfl_xor_sync(0xffffffffu, t.idx, off);
    o.second = __shfl_xor_sync(0xffffffffu, t.second, off);
    t = merge(t, o);
  }
  __shared__ Top2 warp_res[kThreads / 32];
  if ((tid & 31) == 0) warp_res[tid >> 5] = t;
  __syncthreads();
  if (tid == 0) {
    Top2 acc = warp_res[0];
    for (int i = 1; i < kThreads / 32; ++i) acc = merge(acc, warp_res[i]);
    best[row] = acc.best;
    second[row] = min(acc.second, kInfDist);
    best_idx[row] = acc.idx;
  }
}

}  // namespace

PSL_API int psl_gated_hamming_top2(
    const int* a_desc, const int* b_desc, int m, int n, int batch,
    const unsigned char* a_ok, const unsigned char* b_ok, int gated,
    const float* a_uv, const float* a_r, const int* a_level,
    const float* a_ur_pred, const float* b_uv, const int* b_level,
    const float* b_ur, int level_window, int* best, int* second,
    int* best_idx, cudaStream_t stream) {
  if (batch > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (m > 0 && n > 0 && batch > 0) {
    hamming_top2_kernel<<<dim3(m, batch), kThreads, 0, stream>>>(
        a_desc, b_desc, n, a_ok, b_ok, gated, a_uv, a_r, a_level, a_ur_pred,
        b_uv, b_level, b_ur, level_window, best, second, best_idx, m);
  }
  return static_cast<int>(cudaGetLastError());
}
