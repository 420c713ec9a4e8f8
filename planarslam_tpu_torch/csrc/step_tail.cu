// K30 associate_planes and K31 finish_step: the tracking step's plane
// association and its tail, `batch` steps per launch (B = 1 on the
// streaming path).
//
// K30 replaces planarslam_tpu/slam/device_tracker.py::
// _associate_planes_device (:185-227; src/PlaneMatcher.cpp:10-81 in the
// C++ reference) and the three plane_block gathers of the step's plane
// observations (the port's plain version is slam/device_tracker.py::
// _associate_planes_plain): for each frame plane moved to the world by
// T_inv(T_cw) (device memory), the normalized normals' |cosine| with every
// map plane and the least point-to-plane distance over the first
// pl_cloud_n points of each map plane's cloud; then the direct match (the
// least distance among the planes within the angle and distance gates),
// the parallel partner (the largest cosine above the threshold) and the
// vertical one (the least below it), the matched plane itself excluded
// from both, each tie to the first map plane as torch.argmin and argmax,
// -1 when there is none; and the three PlaneObs gathered.
// Bound: bytes, and at the path's inputs latency: only the points of the
// valid map planes enter a decision (about 31 KB on path 1's steps: 3 of 16
// frame planes and 5 of 128 map planes valid, 2560 points; up to 128 x 512
// points as a map fills), and 16 x 128 cosines. The design: a cluster of
// kAssocCluster blocks per step, so that a dense window's distance pass
// spreads over as many SMs.
// - Staging, in every block of the cluster: one thread per map plane (the
//   clamped point count, the plane's units of kAssocPts points; in the
//   first block also the normalized normal) and per frame plane (its world
//   plane), in one pass; a warp's scan gives the units' offsets, so only
//   valid map planes with points are walked, and only valid frame planes
//   walk.
// - The distance pass: the cluster's lanes take the units in turn, a
//   unit's points as the contiguous floats they are, all loads in flight;
//   per valid frame plane the lane's least distance, then the lanes of one
//   map plane merged by a warp reduction and one atomicMin into the first
//   block's shared memory (distributed shared memory) on an integer key
//   (float bits + 0x7fffff as a signed int), which orders distances >= 0
//   as floats and puts NaN below them: the minimum, NaN winning as
//   torch.amin's, with the same bits in any order.
// - Picks and gathers, in the first block after the cluster's barrier: a
//   warp per frame plane takes the three picks by warp reductions of
//   ordered keys, and 12 lanes gather the observation blocks from the
//   staged coefficients.
//
// K31 replaces the tail of planarslam_tpu/slam/device_tracker.py::
// fused_track_step (:440-500): the choice of the final pose, the
// outlier-free window slots, the found and visible flags of the 4096 window
// points and 256 window lines (the _in_view projections at T_out), the four
// keyframe counts, the plane coefficients moved to the world, the packed
// host bundle (_pack: every field at its offset in the layout's table, the
// int32 fields by integer stores, so the bits of a bool's 1, a denormal as
// a float, survive), the carried pt3d_w and valid3d (_state_from, :171) and
// the new velocity T_out T_inv(T_last). One item a thread: block 0 of a
// step takes the 1024 features and the four keyframe counts (reduced by
// __reduce_add_sync per warp, then over the warps: no block waits on
// another); the other blocks the 4096 window points, 256 window lines, the
// frame line slots, the 16 planes and the 16 pose entries (with R_cm and
// the flags). Every input is read through the read-only path and a
// thread's loads all go out before its first store, so that nothing waits
// on the stores before it; the pose is no chain: warp 0 of each block
// loads both candidates, n_in2 and T_last together and selects into shared
// memory while the items' loads are in flight. (A cluster of 8 blocks
// adding the counts into its first block by distributed-shared-memory
// atomics, and one block a step with six items a thread, were slower on
// the card.) Bound: latency (about 140 KB in and 63 KB out per step).
//
// K38 lift_state replaces _state_from as planarslam_tpu/slam/
// device_tracker.py::make_last_state runs it (:163-183): the world points
// of a frame's features at T_cw and their mask, the carried state a lane
// starts from (at initialization, after a relocalization or a modular
// frame). It runs K31's lift alone (lift_feature), a feature a thread, so
// its bits are K31's new_state's and the plain _state_from's on the card.
// Bound: latency (about 24 KB in and 13 KB out per lane).
//
// The plain versions spell every 3 x 3 product, dot and norm in a fixed
// order and this file is built with -fmad=false, so every float equals the
// plain version's bit for bit: a division by a Python number is PyTorch's
// product with the number's reciprocal taken in double and rounded to
// float32 (the wrapper passes it), 1 / z and the rest IEEE.
#include <cooperative_groups.h>
#include <math.h>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}

__device__ __forceinline__ float dot3(float a0, float a1, float a2, float b0,
                                      float b1, float b2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a0, b0), __fmul_rn(a1, b1)),
                   __fmul_rn(a2, b2));
}

// T_inv(T) = [R^T, t'] with t'_i = -(column i of R . t)
__device__ __forceinline__ void t_inv_translation(const float* T,
                                                  float* tw) {
  for (int i = 0; i < 3; ++i) {
    tw[i] = -dot3(T[i], T[4 + i], T[8 + i], T[3], T[7], T[11]);
  }
}

// _state_from's lift (device_tracker.py::_lift_features) of one feature at
// the pose T: its camera point ((u - cx) inv_fx z, (v - cy) inv_fy z,
// max(z, 0)) moved to the world by T_inv(T), written to w (0 where it has
// no depth or is invalid); returns that it has. K31 and K38 share it.
__device__ __forceinline__ bool lift_feature(const float* T, float u, float v,
                                             float z, bool valid, float cx,
                                             float cy, float inv_fx,
                                             float inv_fy, float* w) {
  float tw[3];
  t_inv_translation(T, tw);
  const bool has = z > 0.0f && valid;
  const float pc[3] = {__fmul_rn(__fmul_rn(__fsub_rn(u, cx), inv_fx), z),
                       __fmul_rn(__fmul_rn(__fsub_rn(v, cy), inv_fy), z),
                       clamp_min(z, 0.0f)};
  for (int i = 0; i < 3; ++i) {
    const float x =
        __fadd_rn(dot3(T[i], T[4 + i], T[8 + i], pc[0], pc[1], pc[2]), tw[i]);
    w[i] = has ? x : 0.0f;
  }
  return has;
}

// plane_geo.transform(T_inv(T), c): n' = R^T n, d' = d - n' . t'
__device__ __forceinline__ void plane_to_world(const float* T, const float* c,
                                               float* out) {
  float tw[3];
  t_inv_translation(T, tw);
  for (int i = 0; i < 3; ++i) {
    out[i] = dot3(T[i], T[4 + i], T[8 + i], c[0], c[1], c[2]);
  }
  out[3] = __fsub_rn(c[3], dot3(out[0], out[1], out[2], tw[0], tw[1], tw[2]));
}

// ---------------------------------------------------------------- K30 ---

constexpr int kAssocThreads = 512;
constexpr int kAssocWarps = kAssocThreads / 32;
constexpr int kAssocPts = 8;  // cloud points of a unit of the distance pass
// blocks of a step: the largest portable cluster, so that a dense window's
// distance pass spreads furthest (path 1's sparse windows take the same
// time at 4 and 8)
constexpr int kAssocCluster = 8;

struct AssocConsts {
  int P, Mp, C;
  float assoc_angle, assoc_dist, par_thr, ver_thr;
};

// A distance d >= 0 (or NaN) as a key whose signed order is d's, NaN
// below every number; +inf is INT_MAX.
__device__ __forceinline__ int dist_key(float d) {
  return static_cast<int>(static_cast<unsigned>(__float_as_int(d)) +
                          0x7fffffu);
}

__device__ __forceinline__ float key_dist(int k) {
  return k < 0 ? __int_as_float(0x7fc00000) : __int_as_float(k - 0x7fffff);
}

// Shared memory of a K30 block: the map planes' rows, the frame planes'
// and the keys of the least distances (the first block's: the cluster's).
struct AssocSmem {
  float* coef;    // (Mp, 4) pl_coeffs as read
  float* nm;      // (Mp, 3) the normalized normals
  int* mvalid;    // (Mp,) pl_valid
  int* units;     // (Mp + 1,) the units' offsets: map plane m's from units[m]
  int* n_eff;     // (Mp,) the points counted: clamp(pl_cloud_n, 0, C)
  float* pf;      // (P, 8) pi_w, the normalized normal, d_f
  int* fvalid;    // (P,)
  int* walk;      // (P + 1,) the valid frame planes, their count last
  int* key;       // (P, Mp) dist_key of the least distance
};

__host__ __device__ inline size_t assoc_smem_bytes(int P, int Mp) {
  return sizeof(float) * (7 * static_cast<size_t>(Mp) + 8 * P) +
         sizeof(int) * (3 * static_cast<size_t>(Mp) + 1 + 2 * P + 1 +
                        static_cast<size_t>(P) * Mp);
}

__device__ AssocSmem assoc_smem(char* base, int P, int Mp) {
  AssocSmem s;
  s.coef = reinterpret_cast<float*>(base);
  s.nm = s.coef + 4 * Mp;
  s.pf = s.nm + 3 * Mp;
  s.mvalid = reinterpret_cast<int*>(s.pf + 8 * P);
  s.units = s.mvalid + Mp;
  s.n_eff = s.units + Mp + 1;
  s.fvalid = s.n_eff + Mp;
  s.walk = s.fvalid + P;
  s.key = s.walk + P + 1;
  return s;
}

__global__ void __cluster_dims__(kAssocCluster, 1, 1)
    __launch_bounds__(kAssocThreads) associate_planes_kernel(
        const float* __restrict__ coeffs,
        const unsigned char* __restrict__ valid,
        const float* __restrict__ T_cw, const float* __restrict__ pl_coeffs,
        const float* __restrict__ pl_cloud,
        const long long* __restrict__ pl_cloud_n,
        const unsigned char* __restrict__ pl_valid, AssocConsts c,
        int* __restrict__ direct, int* __restrict__ par,
        int* __restrict__ ver, float* __restrict__ pi_w,
        float* __restrict__ obs_pi_w, unsigned char* __restrict__ obs_valid) {
  extern __shared__ __align__(16) char assoc_raw[];
  const AssocSmem s = assoc_smem(assoc_raw, c.P, c.Mp);
  const cg::cluster_group cl = cg::this_cluster();
  const int rank = static_cast<int>(cl.block_rank());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / kAssocCluster;

  // staging: a thread a map plane or a frame plane, and the first block's
  // keys at +inf
  for (int i = tid; i < c.Mp + c.P; i += kAssocThreads) {
    if (i < c.Mp) {
      const size_t mb = static_cast<size_t>(b) * c.Mp + i;
      const long long n = pl_cloud_n[mb];
      const bool mv = pl_valid[mb] != 0;
      if (rank == 0) {  // the picks' rows
        const float* pc = pl_coeffs + 4 * mb;
        const float p0 = pc[0], p1 = pc[1], p2 = pc[2], p3 = pc[3];
        const float nm_norm =
            clamp_min(__fsqrt_rn(dot3(p0, p1, p2, p0, p1, p2)), 1e-9f);
        s.coef[4 * i] = p0;
        s.coef[4 * i + 1] = p1;
        s.coef[4 * i + 2] = p2;
        s.coef[4 * i + 3] = p3;
        s.nm[3 * i] = __fdiv_rn(p0, nm_norm);
        s.nm[3 * i + 1] = __fdiv_rn(p1, nm_norm);
        s.nm[3 * i + 2] = __fdiv_rn(p2, nm_norm);
        s.mvalid[i] = mv ? 1 : 0;
      }
      const int ne = n <= 0 ? 0 : (n >= c.C ? c.C : static_cast<int>(n));
      s.n_eff[i] = mv ? ne : 0;
    } else {
      const int p = i - c.Mp;
      const size_t fp = static_cast<size_t>(b) * c.P + p;
      float pw[4];
      plane_to_world(T_cw + 16 * b, coeffs + 4 * fp, pw);
      const float nf_norm = clamp_min(
          __fsqrt_rn(dot3(pw[0], pw[1], pw[2], pw[0], pw[1], pw[2])), 1e-9f);
      float* f = s.pf + 8 * p;
      for (int j = 0; j < 4; ++j) f[j] = pw[j];
      f[4] = __fdiv_rn(pw[0], nf_norm);
      f[5] = __fdiv_rn(pw[1], nf_norm);
      f[6] = __fdiv_rn(pw[2], nf_norm);
      f[7] = __fdiv_rn(pw[3], nf_norm);
      s.fvalid[p] = valid[fp] != 0 ? 1 : 0;
    }
  }
  if (rank == 0) {
    for (int i = tid; i < c.P * c.Mp; i += kAssocThreads) s.key[i] = INT_MAX;
  }
  __syncthreads();
  // the units' offsets (warp 0) and the valid frame planes (warp 1)
  if (warp == 0) {
    int run = 0;
    for (int m0 = 0; m0 < c.Mp; m0 += 32) {
      const int m = m0 + lane;
      const int u = m < c.Mp ? (s.n_eff[m] + kAssocPts - 1) / kAssocPts : 0;
      int x = u;
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(kFull, x, off);
        if (lane >= off) x += y;
      }
      if (m < c.Mp) s.units[m] = run + x - u;
      run += __shfl_sync(kFull, x, 31);
    }
    if (lane == 0) s.units[c.Mp] = run;
  } else if (warp == 1) {
    int n = 0;
    for (int p0 = 0; p0 < c.P; p0 += 32) {
      const int p = p0 + lane;
      const bool on = p < c.P && s.fvalid[p] != 0;
      const unsigned ball = __ballot_sync(kFull, on);
      if (on) s.walk[n + __popc(ball & ((1u << lane) - 1u))] = p;
      n += __popc(ball);
    }
    if (lane == 0) s.walk[c.P] = n;
  }
  cl.sync();  // the units, the walk and the first block's keys

  // the distance pass: the cluster's warps over the units, a lane a unit
  // of one map plane
  int* const key0 = cl.map_shared_rank(s.key, 0);
  const int n_units = s.units[c.Mp], n_walk = s.walk[c.P];
  for (int u0 = (rank * kAssocWarps + warp) * 32; u0 < n_units;
       u0 += kAssocCluster * kAssocThreads) {
    const int u = u0 + lane;
    int m = -1, len = 0;
    float q[3 * kAssocPts];
    if (u < n_units) {
      int lo = 0, hi = c.Mp - 1;  // the map plane whose units hold u
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (s.units[mid] <= u) {
          lo = mid;
        } else {
          hi = mid - 1;
        }
      }
      m = lo;
      const int j0 = (u - s.units[m]) * kAssocPts;
      len = min(kAssocPts, s.n_eff[m] - j0);
      const float* src =
          pl_cloud + 3 * ((static_cast<size_t>(b) * c.Mp + m) * c.C + j0);
#pragma unroll
      for (int i = 0; i < 3 * kAssocPts; ++i) {
        q[i] = i < 3 * len ? src[i] : 0.0f;
      }
    }
    const unsigned grp = __match_any_sync(kFull, m);
    const bool leader = m >= 0 && lane == __ffs(grp) - 1;
    for (int w = 0; w < n_walk; ++w) {
      const int p = s.walk[w];
      const float* f = s.pf + 8 * p;
      const float nf0 = f[4], nf1 = f[5], nf2 = f[6], d_f = f[7];
      int key = INT_MAX;
#pragma unroll
      for (int j = 0; j < kAssocPts; ++j) {
        if (j < len) {
          const float d = fabsf(__fadd_rn(
              dot3(q[3 * j], q[3 * j + 1], q[3 * j + 2], nf0, nf1, nf2),
              d_f));
          key = min(key, dist_key(d));
        }
      }
      key = __reduce_min_sync(grp, key);
      if (leader) atomicMin(key0 + p * c.Mp + m, key);
    }
  }
  cl.sync();  // the keys complete
  if (rank != 0) return;

  // picks and gathers: a warp per frame plane, in the first block. A lane
  // keeps the first best of its map planes (m = lane, lane + 32, ...), the
  // warp the least value (largest for the parallel partner), then the
  // least index holding it: the first map plane among equals, as
  // torch.argmin and argmax. Values enter as ordered int keys: a least
  // distance by dist_key, a cosine (>= 0) by its bits, the plain version's
  // -1 and 2 for none as -1 and the bits of 2.
  for (int p = warp; p < c.P; p += kAssocWarps) {
    const size_t fp = static_cast<size_t>(b) * c.P + p;
    const bool f_valid = s.fvalid[p] != 0;
    const float* f = s.pf + 8 * p;
    const float nf0 = f[4], nf1 = f[5], nf2 = f[6];
    // the direct match: the least distance within the gates, -1 if none
    int dv = INT_MAX, di = INT_MAX;
    for (int m = lane; m < c.Mp; m += 32) {
      const float cosv = fabsf(dot3(nf0, nf1, nf2, s.nm[3 * m],
                                    s.nm[3 * m + 1], s.nm[3 * m + 2]));
      const int key = s.key[p * c.Mp + m];
      const bool ok = f_valid && s.mvalid[m] != 0 && cosv > c.assoc_angle &&
                      key_dist(key) < c.assoc_dist;
      if (ok && key < dv) {
        dv = key;
        di = m;
      }
    }
    const int dmin = __reduce_min_sync(kFull, dv);
    const int d_idx =
        dmin == INT_MAX ? -1 : __reduce_min_sync(kFull, dv == dmin ? di
                                                                   : INT_MAX);
    // the parallel and vertical partners, the direct match excluded
    constexpr int kTwo = 0x40000000;  // the bits of 2.0f
    int pv = -1, pi = INT_MAX, vv = kTwo, vi = INT_MAX;
    for (int m = lane; m < c.Mp; m += 32) {
      const float cs = fabsf(dot3(nf0, nf1, nf2, s.nm[3 * m],
                                  s.nm[3 * m + 1], s.nm[3 * m + 2]));
      const bool cand = f_valid && s.mvalid[m] != 0 && m != d_idx;
      const int bits = __float_as_int(cs);
      if (cand && cs > c.par_thr && bits > pv) {
        pv = bits;
        pi = m;
      }
      if (cand && cs < c.ver_thr && bits < vv) {
        vv = bits;
        vi = m;
      }
    }
    const int pmax = __reduce_max_sync(kFull, pv);
    const int vmin = __reduce_min_sync(kFull, vv);
    const int id_par =
        pmax > 0 ? __reduce_min_sync(kFull, pv == pmax ? pi : INT_MAX) : -1;
    const int id_ver =
        vmin < kTwo ? __reduce_min_sync(kFull, vv == vmin ? vi : INT_MAX)
                    : -1;
    // 12 lanes: observation block k = lane / 4, entry lane % 4
    const int k = lane >> 2, j = lane & 3;
    const int id = k == 0 ? d_idx : (k == 1 ? id_par : id_ver);
    if (lane < 12) {
      const size_t o = (static_cast<size_t>(b) * 3 + k) * c.P + p;
      obs_pi_w[4 * o + j] = s.coef[4 * psl_clamp(id, 0, c.Mp - 1) + j];
      if (j == 0) obs_valid[o] = (id >= 0 && f_valid) ? 1 : 0;
    }
    if (lane < 4) pi_w[4 * fp + lane] = f[lane];
    if (lane == 0) {
      direct[fp] = d_idx;
      par[fp] = id_par;
      ver[fp] = id_ver;
    }
  }
}

// ---------------------------------------------------------------- K31 ---

// the bundle's fields, in BundleLayout's order
enum Field {
  kTOut, kRcm, kFlags, kFfIdx, kWinIdx, kPtInlier, kWinFound, kWinVisible,
  kLnWinIdx, kLnWinFound, kLnWinVisible, kPlDirect, kPlPar, kPlVer,
  kPlCoeffsW, kPlValid, kKfStats, kFields
};

// K31's launch: per step, block 0 the K features and 1 + ceil((items -
// K) / kTailThreads) - 1 blocks the rest, an item a thread (items beyond
// the threads in further rounds)
constexpr int kTailThreads = 1024;
constexpr int kTailWarps = kTailThreads / 32;
constexpr int kPoseItems = 16;  // T_out and the velocity (R_cm, flags)

struct TailArgs {
  const float* T_cand;          // (B, 4, 4) the final solve's pose
  const long long* n_in2;       // (B,) its point inliers
  const float* T1;              // (B, 4, 4) the pose before it
  const long long* n_in1;       // (B,) the first solve's point inliers
  const float* T_last;          // (B, 4, 4)
  const float* R_cm;            // (B, 3, 3)
  const unsigned char* manh_success;  // (B,)
  const unsigned char* use_manh;      // (B,)
  const int* ff_idx;            // (B, K)
  const int* feat_slot;         // (B, K)
  const unsigned char* inl;     // (B, K)
  const unsigned char* obs2_valid;  // (B, K)
  const float* pt_uv;           // (B, K, 2)
  const float* pt_depth;        // (B, K)
  const unsigned char* pt_valid;  // (B, K)
  const int* win_idx;           // (B, Wp)
  const float* win_xyz;         // (B, Wp, 3)
  const unsigned char* win_valid;  // (B, Wp)
  const int* lm_idx;            // (B, Wl)
  const float* ln_sw;           // (B, Wl, 3)
  const float* ln_ew;           // (B, Wl, 3)
  const unsigned char* ln_valid;  // (B, Wl)
  const int* ln_slot;           // (B, L)
  const int* pl_direct;         // (B, P)
  const int* pl_par;            // (B, P)
  const int* pl_ver;            // (B, P)
  const float* pl_coeffs;       // (B, P, 4)
  const unsigned char* pl_valid;  // (B, P)
  int K, L, P, Wp, Wl, total, min_inliers;
  int items;                    // K + Wp + Wl + L + P + kPoseItems
  float fx, fy, cx, cy, inv_fx, inv_fy, width, height, depth_threshold;
  int off[kFields];
  float* bundle;                // (B, total)
  float* T_out;                 // (B, 4, 4)
  float* velocity;              // (B, 4, 4)
  float* pt3d_w;                // (B, K, 3)
  unsigned char* valid3d;       // (B, K)
};

// The items of a step, in this order: K features, Wp window points, Wl
// window lines, L frame line slots, P planes, kPoseItems pose entries.
enum ItemKind { kNone, kFeature, kWinPoint, kWinLine, kLnSlot, kPlane,
                kPose };

// An item's inputs, loaded before the pose is known: up to 6 floats, 3
// ints and 3 flags (a feature: uv, depth, ff_idx, feat_slot, inl,
// obs2_valid, pt_valid; a window point: xyz, win_idx, win_valid; a line:
// both endpoints, lm_idx, ln_valid; a plane: its coefficients, the three
// matches, pl_valid; a pose entry: R_cm's, manh_success, use_manh, n_in1)
struct Item {
  int kind, idx;
  float f[6];
  int i[3];
  bool u[3];
  long long n1;
};

__device__ __forceinline__ Item tail_load(const TailArgs& a, int b, int j) {
  Item it;
  it.kind = kNone;
  it.idx = j;
  if (j < a.K) {
    const size_t o = static_cast<size_t>(b) * a.K + j;
    it.kind = kFeature;
    it.f[0] = __ldg(a.pt_uv + 2 * o);
    it.f[1] = __ldg(a.pt_uv + 2 * o + 1);
    it.f[2] = __ldg(a.pt_depth + o);
    it.i[0] = __ldg(a.ff_idx + o);
    it.i[1] = __ldg(a.feat_slot + o);
    it.u[0] = __ldg(a.inl + o) != 0;
    it.u[1] = __ldg(a.obs2_valid + o) != 0;
    it.u[2] = __ldg(a.pt_valid + o) != 0;
    return it;
  }
  j -= a.K;
  if (j < a.Wp) {
    const size_t o = static_cast<size_t>(b) * a.Wp + j;
    it.kind = kWinPoint;
    it.idx = j;
    for (int q = 0; q < 3; ++q) it.f[q] = __ldg(a.win_xyz + 3 * o + q);
    it.i[0] = __ldg(a.win_idx + o);
    it.u[0] = __ldg(a.win_valid + o) != 0;
    return it;
  }
  j -= a.Wp;
  if (j < a.Wl) {
    const size_t o = static_cast<size_t>(b) * a.Wl + j;
    it.kind = kWinLine;
    it.idx = j;
    for (int q = 0; q < 3; ++q) {
      it.f[q] = __ldg(a.ln_sw + 3 * o + q);
      it.f[3 + q] = __ldg(a.ln_ew + 3 * o + q);
    }
    it.i[0] = __ldg(a.lm_idx + o);
    it.u[0] = __ldg(a.ln_valid + o) != 0;
    return it;
  }
  j -= a.Wl;
  if (j < a.L) {
    it.kind = kLnSlot;
    it.idx = j;
    it.i[0] = __ldg(a.ln_slot + static_cast<size_t>(b) * a.L + j);
    return it;
  }
  j -= a.L;
  if (j < a.P) {
    const size_t o = static_cast<size_t>(b) * a.P + j;
    it.kind = kPlane;
    it.idx = j;
    for (int q = 0; q < 4; ++q) it.f[q] = __ldg(a.pl_coeffs + 4 * o + q);
    it.i[0] = __ldg(a.pl_direct + o);
    it.i[1] = __ldg(a.pl_par + o);
    it.i[2] = __ldg(a.pl_ver + o);
    it.u[0] = __ldg(a.pl_valid + o) != 0;
    return it;
  }
  j -= a.P;
  if (j < kPoseItems) {
    it.kind = kPose;
    it.idx = j;
    if (j < 9) it.f[0] = __ldg(a.R_cm + 9 * b + j);
    it.u[0] = __ldg(a.manh_success + b) != 0;
    it.u[1] = __ldg(a.use_manh + b) != 0;
    it.n1 = __ldg(a.n_in1 + b);
  }
  return it;
}

// se3.transform_points then se3.project at the pose T (rows 0-2), and the
// frustum gates
__device__ bool in_view(const float* T, float x, float y, float z,
                        const TailArgs& a) {
  float pc[3];
  for (int r = 0; r < 3; ++r) {
    pc[r] = __fadd_rn(dot3(T[4 * r], T[4 * r + 1], T[4 * r + 2], x, y, z),
                      T[4 * r + 3]);
  }
  const float zs = fabsf(pc[2]) < 1e-8f ? 1e-8f : pc[2];
  const float inv_z = __fdiv_rn(1.0f, zs);
  const float u = __fadd_rn(__fmul_rn(__fmul_rn(a.fx, pc[0]), inv_z), a.cx);
  const float v = __fadd_rn(__fmul_rn(__fmul_rn(a.fy, pc[1]), inv_z), a.cy);
  return pc[2] > 0.05f && u >= 0.0f && u < a.width && v >= 0.0f &&
         v < a.height;
}

// An item's outputs at the step's pose T and previous pose T_last (the
// block's shared copies); returns the keyframe counts a feature adds to
// (tracked close, non-tracked close, with depth, tracked) as the bits of
// one int.
__device__ __forceinline__ int tail_finish(const TailArgs& a, int b,
                                           const Item& it, const float* T,
                                           const float* T_last, float n2) {
  float* bundle = a.bundle + static_cast<size_t>(b) * a.total;
  int* bundle_i = reinterpret_cast<int*>(bundle);
  const int j = it.idx;
  switch (it.kind) {
    case kFeature: {
      const size_t o = static_cast<size_t>(b) * a.K + j;
      const bool inl = it.u[0], obs2 = it.u[1], valid = it.u[2];
      const int slot = it.i[1];
      const float z = it.f[2];
      bundle_i[a.off[kFfIdx] + j] = it.i[0];
      bundle_i[a.off[kWinIdx] + j] = (inl || slot < 0) ? slot : -1;
      bundle_i[a.off[kPtInlier] + j] = inl ? 1 : 0;
      // _state_from at T_out: the feature's camera point to the world
      const bool has = lift_feature(T, it.f[0], it.f[1], z, valid, a.cx,
                                    a.cy, a.inv_fx, a.inv_fy,
                                    a.pt3d_w + 3 * o);
      a.valid3d[o] = has ? 1 : 0;
      const bool close = z > 0.0f && z < a.depth_threshold;
      const bool tracked = obs2 && inl;
      return (close && tracked ? 1 : 0) |
             (close && !tracked && valid ? 2 : 0) | (z > 0.0f ? 4 : 0) |
             (tracked ? 8 : 0);
    }
    case kWinPoint: {
      const bool vis = it.u[0] && in_view(T, it.f[0], it.f[1], it.f[2], a);
      bundle_i[a.off[kWinFound] + j] = it.i[0] >= 0 ? 1 : 0;
      bundle_i[a.off[kWinVisible] + j] = vis ? 1 : 0;
      return 0;
    }
    case kWinLine: {
      const bool vis =
          it.u[0] && in_view(T, __fmul_rn(0.5f, __fadd_rn(it.f[0], it.f[3])),
                             __fmul_rn(0.5f, __fadd_rn(it.f[1], it.f[4])),
                             __fmul_rn(0.5f, __fadd_rn(it.f[2], it.f[5])),
                             a);
      bundle_i[a.off[kLnWinFound] + j] = it.i[0] >= 0 ? 1 : 0;
      bundle_i[a.off[kLnWinVisible] + j] = vis ? 1 : 0;
      return 0;
    }
    case kLnSlot:
      bundle_i[a.off[kLnWinIdx] + j] = it.i[0];
      return 0;
    case kPlane: {
      bundle_i[a.off[kPlDirect] + j] = it.i[0];
      bundle_i[a.off[kPlPar] + j] = it.i[1];
      bundle_i[a.off[kPlVer] + j] = it.i[2];
      bundle_i[a.off[kPlValid] + j] = it.u[0] ? 1 : 0;
      float pw[4];
      plane_to_world(T, it.f, pw);
      for (int q = 0; q < 4; ++q) bundle[a.off[kPlCoeffsW] + 4 * j + q] = pw[q];
      return 0;
    }
    case kPose: {
      bundle[a.off[kTOut] + j] = T[j];
      a.T_out[16 * b + j] = T[j];
      // new velocity: T_out T_inv(T_last), each entry a 4-term dot in order
      float tl[3];
      t_inv_translation(T_last, tl);
      const int r = j / 4, col = j % 4;
      // column col of T_inv(T_last): R^T's column (row col of R) and t'
      float inv[4];
      if (col < 3) {
        inv[0] = T_last[4 * col];
        inv[1] = T_last[4 * col + 1];
        inv[2] = T_last[4 * col + 2];
        inv[3] = 0.0f;
      } else {
        inv[0] = tl[0];
        inv[1] = tl[1];
        inv[2] = tl[2];
        inv[3] = 1.0f;
      }
      const float* row = T + 4 * r;
      a.velocity[16 * b + j] = __fadd_rn(
          dot3(row[0], row[1], row[2], inv[0], inv[1], inv[2]),
          __fmul_rn(row[3], inv[3]));
      if (j < 9) bundle[a.off[kRcm] + j] = it.f[0];
      if (j == 0) bundle[a.off[kFlags]] = it.u[0] ? 1.0f : 0.0f;
      if (j == 1) bundle[a.off[kFlags] + 1] = it.u[1] ? 1.0f : 0.0f;
      if (j == 2) bundle[a.off[kFlags] + 2] = __ll2float_rn(it.n1);
      if (j == 3) bundle[a.off[kFlags] + 3] = n2;
      return 0;
    }
    default:
      return 0;
  }
}

// One step per grid row (blockIdx.y). Block 0 takes the step's features,
// one a thread, and reduces the keyframe counts alone: by
// __reduce_add_sync per warp, then warp 0 over the warps' sums (integer
// sums, the same bits in any order), so no block waits on another. The
// other blocks take the rest, one item a thread. Every block stages the
// step's pose: warp 0 loads T_cand, T1, n_in2 and T_last together and
// selects afterwards, while every thread's item loads are in flight.
__global__ void __launch_bounds__(kTailThreads) finish_step_kernel(
    TailArgs a) {
  __shared__ __align__(16) float pose[16];       // T_out
  __shared__ __align__(16) float pose_last[16];  // T_last
  __shared__ float n2_s;                         // float(n_in2)
  __shared__ int partial[kTailWarps][4];         // block 0: per warp
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y;
  const bool feats = blockIdx.x == 0;
  const int stride =
      feats ? kTailThreads : (gridDim.x - 1) * kTailThreads;
  const int first =
      feats ? tid : a.K + (blockIdx.x - 1) * kTailThreads + tid;
  const int end = feats ? a.K : a.items;

  // the load round: this thread's first item, and in warp 0 both
  // candidate poses, n_in2 and T_last
  const Item it = first < end ? tail_load(a, b, first) : Item{kNone};
  if (warp == 0) {
    const long long n2 = __ldg(a.n_in2 + b);
    const float tc = lane < 16 ? __ldg(a.T_cand + 16 * b + lane) : 0.0f;
    const float t1 = lane < 16 ? __ldg(a.T1 + 16 * b + lane) : 0.0f;
    const float tl = lane < 16 ? __ldg(a.T_last + 16 * b + lane) : 0.0f;
    if (lane < 16) {
      pose[lane] = n2 >= a.min_inliers ? tc : t1;
      pose_last[lane] = tl;
    }
    if (lane == 0) n2_s = __ll2float_rn(n2);
  }
  __syncthreads();
  const float n2 = n2_s;

  // the items
  int c[4] = {0, 0, 0, 0};
  const auto count = [&](int bits) {
    for (int k = 0; k < 4; ++k) c[k] += (bits >> k) & 1;
  };
  count(tail_finish(a, b, it, pose, pose_last, n2));
  for (int j = first + stride; j < end; j += stride) {
    count(tail_finish(a, b, tail_load(a, b, j), pose, pose_last, n2));
  }

  // the counts: block 0's alone (the other blocks are done), per warp,
  // then over the warps
  if (!feats) return;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int s = __reduce_add_sync(kFull, c[k]);
    if (lane == 0) partial[warp][k] = s;
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      c[k] = __reduce_add_sync(kFull,
                               lane < kTailWarps ? partial[lane][k] : 0);
    }
  }
  // the stores: block 0's keyframe counts, lane k the k-th
  if (tid < 4) {
    const int n = tid == 0 ? c[0] : tid == 1 ? c[1] : tid == 2 ? c[2] : c[3];
    a.bundle[static_cast<size_t>(b) * a.total + a.off[kKfStats] + tid] =
        static_cast<float>(n);
  }
}

// ---------------------------------------------------------------- K38 ---

constexpr int kLiftThreads = 256;

// A feature a thread, lane blockIdx.y; the lane's pose staged in shared
// memory by its first 16 threads while every thread's loads are in flight.
__global__ void __launch_bounds__(kLiftThreads) lift_state_kernel(
    const float* __restrict__ pt_uv, const float* __restrict__ pt_depth,
    const unsigned char* __restrict__ pt_valid,
    const float* __restrict__ T_cw, int K, float cx, float cy, float inv_fx,
    float inv_fy, float* __restrict__ pt3d_w,
    unsigned char* __restrict__ valid3d) {
  __shared__ float T[16];
  const int b = blockIdx.y;
  const int j = blockIdx.x * kLiftThreads + threadIdx.x;
  const size_t o = static_cast<size_t>(b) * K + j;
  float u = 0.0f, v = 0.0f, z = 0.0f;
  bool valid = false;
  if (j < K) {
    u = __ldg(pt_uv + 2 * o);
    v = __ldg(pt_uv + 2 * o + 1);
    z = __ldg(pt_depth + o);
    valid = __ldg(pt_valid + o) != 0;
  }
  if (threadIdx.x < 16) T[threadIdx.x] = __ldg(T_cw + 16 * b + threadIdx.x);
  __syncthreads();
  if (j < K) {
    valid3d[o] = lift_feature(T, u, v, z, valid, cx, cy, inv_fx, inv_fy,
                              pt3d_w + 3 * o)
                     ? 1
                     : 0;
  }
}

}  // namespace

// pt_uv (B, K, 2), pt_depth (B, K), pt_valid (B, K), T_cw (B, 4, 4), K,
// batch, cx, cy, inv_fx, inv_fy (the reciprocals PyTorch's division by
// fx and fy multiplies with), pt3d_w (B, K, 3), valid3d (B, K)
PSL_API int psl_lift_state(const float* pt_uv, const float* pt_depth,
                           const unsigned char* pt_valid, const float* T_cw,
                           int K, int batch, float cx, float cy, float inv_fx,
                           float inv_fy, float* pt3d_w, unsigned char* valid3d,
                           cudaStream_t stream) {
  if (K < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (K > 0 && batch > 0) {
    const dim3 grid((K + kLiftThreads - 1) / kLiftThreads, batch);
    lift_state_kernel<<<grid, kLiftThreads, 0, stream>>>(
        pt_uv, pt_depth, pt_valid, T_cw, K, cx, cy, inv_fx, inv_fy, pt3d_w,
        valid3d);
  }
  return static_cast<int>(cudaGetLastError());
}

PSL_API int psl_associate_planes(
    const float* coeffs, const unsigned char* valid, const float* T_cw,
    const float* pl_coeffs, const float* pl_cloud,
    const long long* pl_cloud_n, const unsigned char* pl_valid, int P, int Mp,
    int C, int batch, float assoc_angle, float assoc_dist, float par_thr,
    float ver_thr, int* direct, int* par, int* ver,
    float* pi_w, float* obs_pi_w, unsigned char* obs_valid,
    cudaStream_t stream) {
  if (P < 1 || batch < 1) return static_cast<int>(cudaGetLastError());
  if (Mp < 1 || C < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const AssocConsts c{P, Mp, C, assoc_angle, assoc_dist, par_thr, ver_thr};
  const size_t smem = assoc_smem_bytes(P, Mp);
  const int rc = psl_opt_in_smem(
      reinterpret_cast<const void*>(associate_planes_kernel), smem);
  if (rc != 0) return rc;
  associate_planes_kernel<<<batch * kAssocCluster, kAssocThreads, smem,
                            stream>>>(
      coeffs, valid, T_cw, pl_coeffs, pl_cloud, pl_cloud_n, pl_valid, c,
      direct, par, ver, pi_w, obs_pi_w, obs_valid);
  return static_cast<int>(cudaGetLastError());
}

PSL_API int psl_finish_step(
    const float* T_cand, const long long* n_in2, const float* T1,
    const long long* n_in1, const float* T_last, const float* R_cm,
    const unsigned char* manh_success, const unsigned char* use_manh,
    const int* ff_idx, const int* feat_slot, const unsigned char* inl,
    const unsigned char* obs2_valid, const float* pt_uv,
    const float* pt_depth, const unsigned char* pt_valid, const int* win_idx,
    const float* win_xyz, const unsigned char* win_valid, const int* lm_idx,
    const float* ln_sw, const float* ln_ew, const unsigned char* ln_valid,
    const int* ln_slot, const int* pl_direct, const int* pl_par,
    const int* pl_ver, const float* pl_coeffs, const unsigned char* pl_valid,
    int K, int L, int P, int Wp, int Wl, int batch, int min_inliers,
    float fx, float fy, float cx, float cy, float inv_fx, float inv_fy,
    float width, float height, float depth_threshold, const int* offsets,
    int total, float* bundle,
    float* T_out, float* velocity, float* pt3d_w, unsigned char* valid3d,
    cudaStream_t stream) {
  if (batch > 0) {
    TailArgs a{T_cand, n_in2, T1, n_in1, T_last, R_cm, manh_success,
               use_manh, ff_idx, feat_slot, inl, obs2_valid, pt_uv,
               pt_depth, pt_valid, win_idx, win_xyz, win_valid, lm_idx,
               ln_sw, ln_ew, ln_valid, ln_slot, pl_direct, pl_par, pl_ver,
               pl_coeffs, pl_valid};
    a.K = K;
    a.L = L;
    a.P = P;
    a.Wp = Wp;
    a.Wl = Wl;
    a.total = total;
    a.min_inliers = min_inliers;
    a.fx = fx;
    a.fy = fy;
    a.cx = cx;
    a.cy = cy;
    a.inv_fx = inv_fx;
    a.inv_fy = inv_fy;
    a.width = width;
    a.height = height;
    a.depth_threshold = depth_threshold;
    for (int f = 0; f < kFields; ++f) a.off[f] = offsets[f];  // host table
    a.bundle = bundle;
    a.T_out = T_out;
    a.velocity = velocity;
    a.pt3d_w = pt3d_w;
    a.valid3d = valid3d;
    a.items = K + Wp + Wl + L + P + kPoseItems;
    const dim3 grid(1 + (a.items - K + kTailThreads - 1) / kTailThreads,
                    batch);
    finish_step_kernel<<<grid, kTailThreads, 0, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
