// K30 associate_planes and K31 finish_step: the tracking step's plane
// association and its tail, `batch` steps per launch (B = 1 on the
// streaming path).
//
// K30 replaces planarslam_tpu/slam/device_tracker.py::
// _associate_planes_device (:185-227; src/PlaneMatcher.cpp:10-81 in the
// C++ reference) and the three plane_block gathers of the step's plane
// observations (the port's plain version is slam/device_tracker.py::
// _associate_planes_plain). One block per (step, frame plane): the frame
// plane moved to the world by T_inv(T_cw) (device memory), then one warp
// per map plane at a time: the normalized normals' |cosine|, and the least
// point-to-plane distance over the first pl_cloud_n points of the map
// plane's cloud (512), the lanes striding the cloud and a shuffle tree
// taking the minimum (exact in any order). Then one warp takes the direct
// match (the least distance among the planes within the angle and distance
// gates), the parallel partner (the largest cosine above the threshold)
// and the vertical one (the least below it), the matched plane itself
// excluded from both, each tie to the first map plane as torch.argmin and
// argmax, -1 when there is none; and it gathers the three PlaneObs. Bound:
// latency (16 x 128 x 512 point distances, 3.1 MFLOP, and 786 KB of
// clouds that each of the 16 blocks reads from L2).
//
// K31 replaces the tail of planarslam_tpu/slam/device_tracker.py::
// fused_track_step (:440-500): the choice of the final pose, the
// outlier-free window slots, the found and visible flags of the 4096 window
// points and 256 window lines (the _in_view projections at T_out), the four
// keyframe counts, the plane coefficients moved to the world, the packed
// host bundle (_pack: every field at its offset in the layout's table, the
// int32 fields by integer stores, so the bits of a bool's 1, a denormal as
// a float, survive), the carried pt3d_w and valid3d (_state_from, :171) and
// the new velocity T_out T_inv(T_last). Block 0 of a step does the features
// (counts by integer atomics in shared memory), the planes and the pose
// fields; the other blocks one window point or line per thread. Bound:
// latency (about 140 KB in and 63 KB out per step).
//
// The plain versions spell every 3 x 3 product, dot and norm in a fixed
// order and this file is built with -fmad=false, so every float equals the
// plain version's bit for bit: a division by a Python number is PyTorch's
// product with the number's reciprocal taken in double and rounded to
// float32 (the wrapper passes it), 1 / z and the rest IEEE.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kAssocThreads = 512;
constexpr int kTailThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}

// torch.amin: NaN wins
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a < b || isnan(a)) ? a : b;
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

struct AssocConsts {
  int P, Mp, C;
  float assoc_angle, assoc_dist, par_thr, ver_thr;
};

// (value, index) reductions over the map planes: the first index wins ties
struct Best {
  float v;
  int i;
};

__device__ __forceinline__ Best pick(Best a, Best b, bool least) {
  const bool b_better = least ? (b.v < a.v) : (b.v > a.v);
  if (b_better || (b.v == a.v && b.i < a.i)) return b;
  return a;
}

__device__ Best warp_pick(Best x, bool least) {
  for (int off = 16; off > 0; off >>= 1) {
    Best o;
    o.v = __shfl_down_sync(kFull, x.v, off);
    o.i = __shfl_down_sync(kFull, x.i, off);
    x = pick(x, o, least);
  }
  return x;
}

__global__ void associate_planes_kernel(
    const float* __restrict__ coeffs, const unsigned char* __restrict__ valid,
    const float* __restrict__ T_cw, const float* __restrict__ pl_coeffs,
    const float* __restrict__ pl_cloud,
    const long long* __restrict__ pl_cloud_n,
    const unsigned char* __restrict__ pl_valid, AssocConsts c,
    int* __restrict__ direct, int* __restrict__ par, int* __restrict__ ver,
    float* __restrict__ pi_w, float* __restrict__ obs_pi_w,
    unsigned char* __restrict__ obs_valid) {
  extern __shared__ float smem[];
  float* s_dmin = smem;        // (Mp,)
  float* s_cos = smem + c.Mp;  // (Mp,)
  const int p = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const size_t fp = static_cast<size_t>(b) * c.P + p;
  const bool f_valid = valid[fp] != 0;
  float pw[4];
  plane_to_world(T_cw + 16 * b, coeffs + 4 * fp, pw);
  const float nf_norm =
      clamp_min(__fsqrt_rn(dot3(pw[0], pw[1], pw[2], pw[0], pw[1], pw[2])),
                1e-9f);
  const float nf0 = __fdiv_rn(pw[0], nf_norm), nf1 = __fdiv_rn(pw[1], nf_norm),
              nf2 = __fdiv_rn(pw[2], nf_norm);
  const float d_f = __fdiv_rn(pw[3], nf_norm);

  for (int m = warp; m < c.Mp; m += n_warps) {
    const size_t mb = static_cast<size_t>(b) * c.Mp + m;
    const float* pc = pl_coeffs + 4 * mb;
    const float nm_norm = clamp_min(
        __fsqrt_rn(dot3(pc[0], pc[1], pc[2], pc[0], pc[1], pc[2])), 1e-9f);
    const float cosv = fabsf(dot3(nf0, nf1, nf2, __fdiv_rn(pc[0], nm_norm),
                                  __fdiv_rn(pc[1], nm_norm),
                                  __fdiv_rn(pc[2], nm_norm)));
    const long long n_pts = pl_cloud_n[mb];
    const float* cloud = pl_cloud + 3 * mb * c.C;
    float dmin = INFINITY;
    for (int j = lane; j < c.C; j += 32) {
      if (j < n_pts) {
        const float* q = cloud + 3 * j;
        dmin = min_nan(dmin, fabsf(__fadd_rn(
                                 dot3(q[0], q[1], q[2], nf0, nf1, nf2), d_f)));
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      dmin = min_nan(dmin, __shfl_down_sync(kFull, dmin, off));
    }
    if (lane == 0) {
      s_dmin[m] = dmin;
      s_cos[m] = cosv;
    }
  }
  __syncthreads();
  if (warp != 0) return;

  const unsigned char* mv = pl_valid + static_cast<size_t>(b) * c.Mp;
  // the direct match: argmin of dscore, -1 unless its minimum is finite
  Best dbest{INFINITY, 0};
  for (int m = lane; m < c.Mp; m += 32) {
    const bool both = f_valid && mv[m] != 0;
    const bool ok = both && s_cos[m] > c.assoc_angle &&
                    s_dmin[m] < c.assoc_dist;
    dbest = pick(dbest, Best{ok ? s_dmin[m] : INFINITY, m}, true);
  }
  dbest = warp_pick(dbest, true);
  const bool has_direct = isfinite(__shfl_sync(kFull, dbest.v, 0));
  const int d_idx = has_direct ? __shfl_sync(kFull, dbest.i, 0) : -1;
  // the parallel and vertical partners, the direct match excluded
  Best pbest{-1.0f, 0}, vbest{2.0f, 0};
  for (int m = lane; m < c.Mp; m += 32) {
    const bool cand = f_valid && mv[m] != 0 && !(has_direct && m == d_idx);
    const float cs = s_cos[m];
    pbest = pick(pbest, Best{cand && cs > c.par_thr ? cs : -1.0f, m}, false);
    vbest = pick(vbest, Best{cand && cs < c.ver_thr ? cs : 2.0f, m}, true);
  }
  pbest = warp_pick(pbest, false);
  vbest = warp_pick(vbest, true);
  if (lane == 0) {
    const int ids[3] = {d_idx, pbest.v > 0.0f ? pbest.i : -1,
                        vbest.v < 2.0f ? vbest.i : -1};
    direct[fp] = ids[0];
    par[fp] = ids[1];
    ver[fp] = ids[2];
    for (int j = 0; j < 4; ++j) pi_w[4 * fp + j] = pw[j];
    for (int k = 0; k < 3; ++k) {
      const size_t o = (static_cast<size_t>(b) * 3 + k) * c.P + p;
      const int jm = psl_clamp(ids[k], 0, c.Mp - 1);
      const float* src =
          pl_coeffs + 4 * (static_cast<size_t>(b) * c.Mp + jm);
      for (int j = 0; j < 4; ++j) obs_pi_w[4 * o + j] = src[j];
      obs_valid[o] = (ids[k] >= 0 && f_valid) ? 1 : 0;
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
  float fx, fy, cx, cy, inv_fx, inv_fy, width, height, depth_threshold;
  int off[kFields];
  float* bundle;                // (B, total)
  float* T_out;                 // (B, 4, 4)
  float* velocity;              // (B, 4, 4)
  float* pt3d_w;                // (B, K, 3)
  unsigned char* valid3d;       // (B, K)
};

// se3.transform_points then se3.project, and the frustum gates
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

__global__ void finish_step_kernel(TailArgs a) {
  const int b = blockIdx.y;
  float* bundle = a.bundle + static_cast<size_t>(b) * a.total;
  int* bundle_i = reinterpret_cast<int*>(bundle);
  const bool ok2 = a.n_in2[b] >= a.min_inliers;
  const float* T = (ok2 ? a.T_cand : a.T1) + 16 * b;

  if (blockIdx.x > 0) {  // one window point or line per thread
    const int j = (blockIdx.x - 1) * blockDim.x + threadIdx.x;
    if (j < a.Wp) {
      const size_t o = static_cast<size_t>(b) * a.Wp + j;
      const float* q = a.win_xyz + 3 * o;
      const bool vis = a.win_valid[o] != 0 && in_view(T, q[0], q[1], q[2], a);
      bundle_i[a.off[kWinFound] + j] = a.win_idx[o] >= 0 ? 1 : 0;
      bundle_i[a.off[kWinVisible] + j] = vis ? 1 : 0;
    } else if (j < a.Wp + a.Wl) {
      const int l = j - a.Wp;
      const size_t o = static_cast<size_t>(b) * a.Wl + l;
      const float* s = a.ln_sw + 3 * o;
      const float* e = a.ln_ew + 3 * o;
      const bool vis =
          a.ln_valid[o] != 0 &&
          in_view(T, __fmul_rn(0.5f, __fadd_rn(s[0], e[0])),
                  __fmul_rn(0.5f, __fadd_rn(s[1], e[1])),
                  __fmul_rn(0.5f, __fadd_rn(s[2], e[2])), a);
      bundle_i[a.off[kLnWinFound] + l] = a.lm_idx[o] >= 0 ? 1 : 0;
      bundle_i[a.off[kLnWinVisible] + l] = vis ? 1 : 0;
    }
    return;
  }

  // block 0: the features, the planes and the pose fields
  __shared__ int counts[4];
  if (threadIdx.x < 4) counts[threadIdx.x] = 0;
  __syncthreads();
  float tw[3];
  t_inv_translation(T, tw);
  int c0 = 0, c1 = 0, c2 = 0, c3 = 0;
  for (int k = threadIdx.x; k < a.K; k += blockDim.x) {
    const size_t o = static_cast<size_t>(b) * a.K + k;
    const bool inl = a.inl[o] != 0;
    const int slot = a.feat_slot[o];
    const float z = a.pt_depth[o];
    const bool valid = a.pt_valid[o] != 0;
    bundle_i[a.off[kFfIdx] + k] = a.ff_idx[o];
    bundle_i[a.off[kWinIdx] + k] = (inl || slot < 0) ? slot : -1;
    bundle_i[a.off[kPtInlier] + k] = inl ? 1 : 0;
    const bool close = z > 0.0f && z < a.depth_threshold;
    const bool tracked = a.obs2_valid[o] != 0 && inl;
    c0 += close && tracked;
    c1 += close && !tracked && valid;
    c2 += z > 0.0f;
    c3 += tracked;
    // _state_from at T_out: the feature's camera point to the world
    const bool has = z > 0.0f && valid;
    const float pc[3] = {
        __fmul_rn(__fmul_rn(__fsub_rn(a.pt_uv[2 * o], a.cx), a.inv_fx), z),
        __fmul_rn(__fmul_rn(__fsub_rn(a.pt_uv[2 * o + 1], a.cy), a.inv_fy),
                  z),
        clamp_min(z, 0.0f)};
    for (int i = 0; i < 3; ++i) {
      const float w = __fadd_rn(
          dot3(T[i], T[4 + i], T[8 + i], pc[0], pc[1], pc[2]), tw[i]);
      a.pt3d_w[3 * o + i] = has ? w : 0.0f;
    }
    a.valid3d[o] = has ? 1 : 0;
  }
  if (c0) atomicAdd(&counts[0], c0);
  if (c1) atomicAdd(&counts[1], c1);
  if (c2) atomicAdd(&counts[2], c2);
  if (c3) atomicAdd(&counts[3], c3);
  for (int l = threadIdx.x; l < a.L; l += blockDim.x) {
    bundle_i[a.off[kLnWinIdx] + l] = a.ln_slot[static_cast<size_t>(b) * a.L +
                                               l];
  }
  for (int p = threadIdx.x; p < a.P; p += blockDim.x) {
    const size_t o = static_cast<size_t>(b) * a.P + p;
    bundle_i[a.off[kPlDirect] + p] = a.pl_direct[o];
    bundle_i[a.off[kPlPar] + p] = a.pl_par[o];
    bundle_i[a.off[kPlVer] + p] = a.pl_ver[o];
    bundle_i[a.off[kPlValid] + p] = a.pl_valid[o] != 0 ? 1 : 0;
    float pw[4];
    plane_to_world(T, a.pl_coeffs + 4 * o, pw);
    for (int j = 0; j < 4; ++j) bundle[a.off[kPlCoeffsW] + 4 * p + j] = pw[j];
  }
  if (threadIdx.x < 16) {
    const int i = threadIdx.x;
    bundle[a.off[kTOut] + i] = T[i];
    a.T_out[16 * b + i] = T[i];
    // new velocity: T_out T_inv(T_last), each entry a 4-term dot in order
    const float* Tl = a.T_last + 16 * b;
    float tl[3];
    t_inv_translation(Tl, tl);
    const int r = i / 4, col = i % 4;
    // column col of T_inv(T_last): R^T's column (row col of R) and t'
    float inv[4];
    if (col < 3) {
      inv[0] = Tl[4 * col];
      inv[1] = Tl[4 * col + 1];
      inv[2] = Tl[4 * col + 2];
      inv[3] = 0.0f;
    } else {
      inv[0] = tl[0];
      inv[1] = tl[1];
      inv[2] = tl[2];
      inv[3] = 1.0f;
    }
    const float* row = T + 4 * r;
    a.velocity[16 * b + i] = __fadd_rn(
        dot3(row[0], row[1], row[2], inv[0], inv[1], inv[2]),
        __fmul_rn(row[3], inv[3]));
  }
  if (threadIdx.x < 9) {
    bundle[a.off[kRcm] + threadIdx.x] = a.R_cm[9 * b + threadIdx.x];
  }
  if (threadIdx.x == 0) {
    bundle[a.off[kFlags]] = a.manh_success[b] != 0 ? 1.0f : 0.0f;
    bundle[a.off[kFlags] + 1] = a.use_manh[b] != 0 ? 1.0f : 0.0f;
    bundle[a.off[kFlags] + 2] = __ll2float_rn(a.n_in1[b]);
    bundle[a.off[kFlags] + 3] = __ll2float_rn(a.n_in2[b]);
  }
  __syncthreads();
  if (threadIdx.x < 4) {
    bundle[a.off[kKfStats] + threadIdx.x] =
        static_cast<float>(counts[threadIdx.x]);
  }
}

}  // namespace

PSL_API int psl_associate_planes(
    const float* coeffs, const unsigned char* valid, const float* T_cw,
    const float* pl_coeffs, const float* pl_cloud,
    const long long* pl_cloud_n, const unsigned char* pl_valid, int P, int Mp,
    int C, int batch, float assoc_angle, float assoc_dist, float par_thr,
    float ver_thr, int* direct, int* par, int* ver, float* pi_w,
    float* obs_pi_w, unsigned char* obs_valid, cudaStream_t stream) {
  if (P > 0 && batch > 0) {
    const AssocConsts c{P, Mp, C, assoc_angle, assoc_dist, par_thr, ver_thr};
    const size_t smem = 2 * static_cast<size_t>(Mp) * sizeof(float);
    associate_planes_kernel<<<dim3(P, batch), kAssocThreads, smem, stream>>>(
        coeffs, valid, T_cw, pl_coeffs, pl_cloud, pl_cloud_n, pl_valid, c,
        direct, par, ver, pi_w, obs_pi_w, obs_valid);
  }
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
    const int n_items = Wp + Wl;
    const dim3 grid(1 + (n_items + kTailThreads - 1) / kTailThreads, batch);
    finish_step_kernel<<<grid, kTailThreads, 0, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
