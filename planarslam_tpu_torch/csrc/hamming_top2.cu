// K3 gated_hamming_top2 — gated Hamming distance with per-row best/second.
//
// Replaces the core of planarslam_tpu/ops/matching.py::search_by_projection
// (:169-183): the window, level, validity and stereo gates on the (M, N)
// grid, the Hamming distance (the JAX package's ±1 bf16 matmul,
// ops/orb.py::hamming_distance) and ::_top2_min. Ungated (gated == 0) it is
// the core of ::match_descriptors: only the two validity masks apply, and
// one launch serves both directions of a mutual match (two problem sets).
//
// Layout. A 512-thread block owns a tile of R rows of one problem (R = 16
// where that gives every SM a block, else 8): blockIdx.x is the row tile,
// blockIdx.y the (set, problem) of a batch of B independent (M, N)
// problems per set (every input and output carries a leading B). The
// block stages the problem's columns, tile by tile of up to kTile, in
// shared memory: the 32-byte descriptor and, gated, u, v, u_right and the
// level (INT_MIN where the column is invalid) in one float4, or, ungated,
// the validity byte. Its live rows (a_ok) are compacted first, so a dead
// row costs one store and no warp walks columns for it.
// With L live rows padded to a power of two Lp, thread t takes slot t mod
// Lp and the columns j = t / Lp, + G, ... (G = 512 / Lp) and keeps a
// running (best, best_idx, second), masked entries at INF_DIST = 10000,
// four independent columns a step, without a branch but for the distance
// of a gated pair through the gates. The partial triples of a row merge by
// shuffles inside each warp, then over the warps. The merge takes (best,
// idx) as the lexicographic minimum and second as the minimum of
// everything else, so any split of the columns gives the bits of one walk
// in column order: _top2_min's ties on the lowest index, and a tie with
// the best giving second == best.
//
// What bounds it on an H100. The column set is read from L2 once per row
// tile, not once per row: the 4096 x 1024 window search reads 4096 / 16 x
// 48 KB = 12.6 MB. An ungated pair is 8 XOR and 8 POPC, and POPC retires
// 16 a clock per SM, so two 1024 x 1024 problems take ~4 us on 132 SMs
// whatever the layout; a gated pair is ~15 ALU operations, POPC only
// through the gates. Latency is the rest: the rows' validity is asked
// first and the first tile's loads go out before it returns. Every output
// is an integer: the kernel is bit-equal to its plain version. All
// main-path problems have N <= 1024 (one tile), so there is nothing for
// an asynchronous copy to overlap with inside the block.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kMaxRows = 16;  // rows per block: 8 or 16, see launch()
constexpr int kTile = 1024;   // columns staged per tile
constexpr int kPer = kTile / kThreads;  // a thread's columns per tile
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

// One problem set: B problems of M rows against N columns. best and
// second may be NULL (not written).
struct Problem {
  const int* a_desc;
  const int* b_desc;
  const unsigned char* a_ok;
  const unsigned char* b_ok;
  const float* a_uv;
  const float* a_r;
  const int* a_level;
  const float* a_ur_pred;
  const float* b_uv;
  const int* b_level;
  const float* b_ur;
  int* best;
  int* second;
  int* best_idx;
  int m, n;
};

struct Params {
  Problem set[2];
  int batch;
  int level_window;
  int tile;  // columns per staged tile: min(largest N, kTile)
  int rows;  // rows per block
};

// A thread's share of one column tile, held in registers between the
// loads and the stores to shared memory: the descriptor halves, and either
// the validity (ungated) or (u, v, u_right, level) with the level replaced
// by INT_MIN where the column is not valid (gated).
struct Staged {
  uint4 lo[kPer], hi[kPer];
  float4 gate[kPer];
  unsigned char ok[kPer];
};

template <bool kGated>
__device__ __forceinline__ void tile_load(const Problem& p, size_t cb,
                                          const int* bd, bool vec, int c0,
                                          int tn, Staged& st) {
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int j = threadIdx.x + k * kThreads;
    if (j >= tn) continue;
    const size_t c = cb + c0 + j;
    const bool ok = p.b_ok[c] != 0;
    if (kGated) {
      const int lvl = p.b_level[c];
      st.gate[k] = make_float4(p.b_uv[2 * c], p.b_uv[2 * c + 1], p.b_ur[c],
                               __int_as_float(ok ? lvl : INT_MIN));
    } else {
      st.ok[k] = ok ? 1 : 0;
    }
    if (vec) {
      const uint4* src = reinterpret_cast<const uint4*>(bd) + 2 * (c0 + j);
      st.lo[k] = src[0];
      st.hi[k] = src[1];
    } else {
      const unsigned* src =
          reinterpret_cast<const unsigned*>(bd) + 8 * (c0 + j);
      st.lo[k] = make_uint4(src[0], src[1], src[2], src[3]);
      st.hi[k] = make_uint4(src[4], src[5], src[6], src[7]);
    }
  }
}

// The Hamming distance of row a to a column's descriptor.
__device__ __forceinline__ int hamming(const unsigned (&a)[8], uint4 lo,
                                       uint4 hi) {
  return __popc(a[0] ^ lo.x) + __popc(a[1] ^ lo.y) + __popc(a[2] ^ lo.z) +
         __popc(a[3] ^ lo.w) + __popc(a[4] ^ hi.x) + __popc(a[5] ^ hi.y) +
         __popc(a[6] ^ hi.z) + __popc(a[7] ^ hi.w);
}

// The row's fields a pair needs.
struct Row {
  unsigned a[8];
  float u, v, r, ur_pred;
  int lvl;
};

// Whether the pair of row w and staged column j is unmasked: the validity
// and (gated) the gates of search_by_projection, without a branch.
template <bool kGated>
__device__ __forceinline__ bool pair_open(const Row& w, int level_window,
                                          const float4* s_gate,
                                          const unsigned char* s_ok, int j) {
  if (!kGated) return s_ok[j] != 0;
  const float4 g4 = s_gate[j];
  const int bl = __float_as_int(g4.w);
  const float du = fabsf(__fsub_rn(w.u, g4.x));
  const float dv = fabsf(__fsub_rn(w.v, g4.y));
  const int dl = abs(bl - w.lvl);
  const float fur = g4.z;
  const bool ur_ok = (fur < 0.0f) | (fabsf(__fsub_rn(w.ur_pred, fur)) <= w.r);
  return (bl != INT_MIN) & (du <= w.r) & (dv <= w.r) & (dl <= level_window) &
         ur_ok;
}

// A thread's columns arrive in increasing order: ties keep the earlier.
// Without a branch.
__device__ __forceinline__ void update(Top2& t, int d, int col) {
  const bool lt = d < t.best;
  t.second = lt ? t.best : min(t.second, d);
  t.idx = lt ? col : t.idx;
  t.best = lt ? d : t.best;
}

__device__ __forceinline__ void write_row(const Problem& p, size_t row,
                                          int best, int second, int idx) {
  if (p.best != nullptr) p.best[row] = best;
  if (p.second != nullptr) p.second[row] = second;
  p.best_idx[row] = idx;
}

template <bool kGated>
__global__ void __launch_bounds__(kThreads, 2)
    hamming_top2_kernel(const __grid_constant__ Params prm) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Top2 part[kThreads / 32][kMaxRows];
  __shared__ int live_rows[kMaxRows];
  __shared__ int n_live;

  const size_t lane_b = blockIdx.y % prm.batch;
  const Problem& p = blockIdx.y < prm.batch ? prm.set[0] : prm.set[1];
  const int m = p.m, n = p.n;
  const int row0 = blockIdx.x * prm.rows;
  if (row0 >= m) return;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t ra = lane_b * m, cb = lane_b * n;
  const int T = prm.tile;
  const int* bd = p.b_desc + 8 * cb;
  const bool vec = (reinterpret_cast<uintptr_t>(bd) & 15u) == 0;

  // the rows' validity is asked first, then the first column tile's loads
  // go out before the rows are known
  const int my_row = row0 + lane;
  const bool in = warp == 0 && lane < prm.rows && my_row < m;
  const bool row_ok = in && n > 0 && p.a_ok[ra + my_row] != 0;
  Staged st;
  tile_load<kGated>(p, cb, bd, vec, 0, min(T, n), st);

  // the tile's rows: dead ones written at once, live ones compacted
  if (warp == 0) {
    if (in && !row_ok) {
      // the full walk's result: every entry masked (N = 0: nothing seen)
      if (n > 0) {
        write_row(p, ra + my_row, kInfDist, kInfDist, 0);
      } else {
        write_row(p, ra + my_row, INT_MAX, kInfDist, INT_MAX);
      }
    }
    const unsigned mask = __ballot_sync(0xffffffffu, row_ok);
    if (row_ok) live_rows[__popc(mask & ((1u << lane) - 1u))] = my_row;
    if (lane == 0) n_live = __popc(mask);
  }
  __syncthreads();
  const int L = n_live;
  if (L == 0) return;

  // shared column tile: the descriptor halves, then (gated) the float4
  // gates or (ungated) the validity bytes
  uint4* s_lo = reinterpret_cast<uint4*>(smem);
  uint4* s_hi = s_lo + T;
  float4* s_gate = reinterpret_cast<float4*>(s_hi + T);
  unsigned char* s_ok = reinterpret_cast<unsigned char*>(s_hi + T);

  // live rows padded to a power of two Lp: thread t takes slot t mod Lp
  // (live when below L) and the columns t / Lp, + G, ... (G = 512 / Lp)
  int Lp = 1;
  while (Lp < L) Lp <<= 1;
  const int G = kThreads / Lp;
  const int slot = tid & (Lp - 1), grp = tid / Lp;
  const bool active = slot < L;
  Row w{};
  if (active) {
    const size_t row = ra + live_rows[slot];
    const int* ad = p.a_desc + 8 * row;
#pragma unroll
    for (int q = 0; q < 8; ++q) w.a[q] = static_cast<unsigned>(ad[q]);
    if (kGated) {
      w.u = p.a_uv[2 * row];
      w.v = p.a_uv[2 * row + 1];
      w.r = p.a_r[row];
      w.lvl = p.a_level[row];
      w.ur_pred = p.a_ur_pred[row];
    }
  }

  Top2 t{INT_MAX, INT_MAX, kInfDist};
  for (int c0 = 0; c0 < n; c0 += T) {
    const int tn = min(T, n - c0);
    if (c0 > 0) {
      __syncthreads();  // the previous tile's readers are done
      tile_load<kGated>(p, cb, bd, vec, c0, tn, st);
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int j = tid + k * kThreads;
      if (j >= tn) continue;
      s_lo[j] = st.lo[k];
      s_hi[j] = st.hi[k];
      if (kGated) {
        s_gate[j] = st.gate[k];
      } else {
        s_ok[j] = st.ok[k];
      }
    }
    __syncthreads();
    if (active) {
      // four independent columns per step, folded in column order (gated,
      // the distance only through the gates: a rare branch)
      int j = grp;
      for (; j + 3 * G < tn; j += 4 * G) {
        int d[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int jq = j + q * G;
          d[q] = kInfDist;
          if (pair_open<kGated>(w, prm.level_window, s_gate, s_ok, jq)) {
            d[q] = hamming(w.a, s_lo[jq], s_hi[jq]);
          }
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) update(t, d[q], c0 + j + q * G);
      }
      for (; j < tn; j += G) {
        int d = kInfDist;
        if (pair_open<kGated>(w, prm.level_window, s_gate, s_ok, j)) {
          d = hamming(w.a, s_lo[j], s_hi[j]);
        }
        update(t, d, c0 + j);
      }
    }
  }

  // the partial triples of a slot: inside a warp by shuffles (its lanes
  // lane, lane ^ Lp, ...), then the warps' in order by the slot's thread
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) {
    if (off < Lp) break;
    Top2 o;
    o.best = __shfl_xor_sync(0xffffffffu, t.best, off);
    o.idx = __shfl_xor_sync(0xffffffffu, t.idx, off);
    o.second = __shfl_xor_sync(0xffffffffu, t.second, off);
    t = merge(t, o);
  }
  if (lane < Lp) part[warp][lane] = t;
  __syncthreads();
  if (tid < L) {
    Top2 acc = part[0][tid];
#pragma unroll
    for (int q = 1; q < kThreads / 32; ++q) acc = merge(acc, part[q][tid]);
    write_row(p, ra + live_rows[tid], acc.best, min(acc.second, kInfDist),
              acc.idx);
  }
}

size_t smem_bytes(int tile, bool gated) {
  const size_t per_col = 32 + (gated ? 16 : 1);
  return (static_cast<size_t>(tile) * per_col + 15) / 16 * 16;
}

template <bool kGated>
int launch(const Params& prm, int n_sets, int max_m, cudaStream_t stream) {
  const size_t smem = smem_bytes(prm.tile, kGated);
  const int rc = psl_opt_in_smem(
      reinterpret_cast<const void*>(hamming_top2_kernel<kGated>), smem);
  if (rc != 0) return rc;
  // 16 rows a block where that gives a block to every SM, else 8
  Params q = prm;
  const int per_row16 = (max_m + 15) / 16 * prm.batch * n_sets;
  q.rows = per_row16 >= 128 ? 16 : 8;
  const dim3 grid((max_m + q.rows - 1) / q.rows, prm.batch * n_sets);
  hamming_top2_kernel<kGated><<<grid, kThreads, smem, stream>>>(q);
  return static_cast<int>(cudaGetLastError());
}

Problem problem(const int* a_desc, const int* b_desc, int m, int n,
                const unsigned char* a_ok, const unsigned char* b_ok,
                int* best, int* second, int* best_idx) {
  Problem p{};
  p.a_desc = a_desc;
  p.b_desc = b_desc;
  p.a_ok = a_ok;
  p.b_ok = b_ok;
  p.best = best;
  p.second = second;
  p.best_idx = best_idx;
  p.m = m;
  p.n = n;
  return p;
}

}  // namespace

PSL_API int psl_gated_hamming_top2(
    const int* a_desc, const int* b_desc, int m, int n, int batch,
    const unsigned char* a_ok, const unsigned char* b_ok, int gated,
    const float* a_uv, const float* a_r, const int* a_level,
    const float* a_ur_pred, const float* b_uv, const int* b_level,
    const float* b_ur, int level_window, int* best, int* second,
    int* best_idx, cudaStream_t stream) {
  if (batch > 65535 || m < 0 || n < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (m == 0 || batch < 1) return static_cast<int>(cudaGetLastError());
  Params prm{};
  prm.set[0] = problem(a_desc, b_desc, m, n, a_ok, b_ok, best, second,
                       best_idx);
  prm.set[0].a_uv = a_uv;
  prm.set[0].a_r = a_r;
  prm.set[0].a_level = a_level;
  prm.set[0].a_ur_pred = a_ur_pred;
  prm.set[0].b_uv = b_uv;
  prm.set[0].b_level = b_level;
  prm.set[0].b_ur = b_ur;
  prm.batch = batch;
  prm.level_window = level_window;
  prm.tile = max(1, min(n, kTile));
  return gated ? launch<true>(prm, 1, m, stream)
               : launch<false>(prm, 1, m, stream);
}

// Both directions of a mutual match in one launch: the rows of A against
// B (best, second, best_idx) and the rows of B against A (back_idx), each
// ungated, B problems each.
PSL_API int psl_mutual_hamming_top2(
    const int* a_desc, const int* b_desc, int m, int n, int batch,
    const unsigned char* a_ok, const unsigned char* b_ok, int* best,
    int* second, int* best_idx, int* back_idx, cudaStream_t stream) {
  if (batch > 65535 / 2 || m < 0 || n < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (max(m, n) == 0 || batch < 1) {
    return static_cast<int>(cudaGetLastError());
  }
  Params prm{};
  prm.set[0] = problem(a_desc, b_desc, m, n, a_ok, b_ok, best, second,
                       best_idx);
  prm.set[1] = problem(b_desc, a_desc, n, m, b_ok, a_ok, nullptr, nullptr,
                       back_idx);
  prm.batch = batch;
  prm.tile = max(1, min(max(m, n), kTile));
  return launch<false>(prm, 2, max(m, n), stream);
}
