// K6 horn_align_batch — weighted rigid (or similarity) alignment and its
// inlier count, one weight row per block, in three modes.
//
// Replaces planarslam_tpu/solvers/sim3_solver.py::horn_align inside
// ::_ransac_align (:23-73): for each weight row, the weighted means and the
// 3 x 3 cross-covariance over all N correspondences (every point carries the
// +1e-9 weight, as in JAX), R = U diag(1, 1, det(U V^T)) V^T of its SVD,
// with scale s = sum(S diag(D)) / max(var, 1e-12) where the similarity is
// asked for (s = 1 otherwise), t = mu_dst - s R mu_src, and the inlier mask
// and count at |s R src + t - dst|^2 < thr^2 on valid points. The modes:
// - weights: the (H, N) rows given (one problem);
// - triplets: a batch of problems, (batch, H, 3) hypothesis triplets; a row's
//   weights are (i in tri ? valid_i : 0) + 1e-9f, the bits of JAX's
//   zeros.at[tri].set(1) * valid + 1e-9 (a repeated index weighs 1, not 2),
//   formed as they are read: the (H, N) rows are never written;
// - refit: one block per problem reads the triplet launch's counts and
//   masks, takes the first row of the largest count (jnp.argmax's), aligns
//   on that row's inliers (+1e-9f) and counts (JAX's :61-72); it writes one
//   packed float32 row per problem (R 9, t 3, s, the count's int32 bits,
//   the mask as 0 / 1) that the wrapper pulls with one copy.
// A RANSAC is a triplet launch and a refit launch, nothing between them.
//
// R is unique for rank(C) >= 2, whatever sign or order convention an SVD
// routine follows, so the kernel need not reproduce LAPACK's: it takes U
// and V from a one-sided Jacobi SVD of C and the third singular vectors as
// cross products (linalg.cuh::psl_nearest_rotation), which fold the
// determinant's sign in. The scale needs that sign apart: it is sign(det C)
// where rank(C) = 3, and +1 below (JAX's sign then multiplies the smallest
// singular value, 0). A hypothesis whose picks repeat a point leaves C near
// rank 1; the one-sided form keeps its second singular vector, which an
// eigen-decomposition of C^T C loses.
//
// One 256-thread block per row: two fp64 block reductions (the weighted
// means, then the centred cross-covariance, as the JAX function centres
// before its product), one thread for the 3 x 3 rotation, then every
// thread tests its points in float32. What bounds it on an H100: launch and
// the reductions' barriers; 65 rows x 4096 points x 24 B is 6 MB of L2
// traffic.
#include "common.cuh"
#include "linalg.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWeights = 0, kTriplets = 1, kRefit = 2;
constexpr int kPacked = 14;  // floats of a refit row before its mask

template <int K>
__device__ __forceinline__ void block_sum(double* vals, double* smem) {
  // vals: K per-thread partials -> every thread gets the block totals
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int k = 0; k < K; ++k) {
    double x = vals[k];
    for (int off = 16; off > 0; off >>= 1) {
      x += __shfl_xor_sync(0xffffffffu, x, off);
    }
    if (lane == 0) smem[warp * K + k] = x;
  }
  __syncthreads();
  for (int k = 0; k < K; ++k) {
    double acc = 0.0;
    for (int w = 0; w < kWarps; ++w) acc += smem[w * K + k];
    vals[k] = acc;
  }
  __syncthreads();
}

struct HornArgs {
  const float* src;               // (batch, n, 3)
  const float* dst;               // (batch, n, 3)
  const float* valid;             // (batch, n)
  const float* weights;           // weights mode: (h, n)
  const int* triplets;            // triplets mode: (batch, h, 3)
  const int* prev_n_inl;          // refit mode: (batch, h)
  const unsigned char* prev_inl;  // refit mode: (batch, h, n)
  int n, h;
  float threshold;
  float* R;                       // (batch, h, 3, 3), or the packed rows
  float* t;                       // (batch, h, 3)
  float* s;                       // (batch, h), or NULL
  int* n_inl;                     // (batch, h)
  unsigned char* inl;             // (batch, h, n)
};

// det of a row-major 3 x 3
__device__ __forceinline__ double det3(const double* m) {
  return m[0] * (m[4] * m[8] - m[5] * m[7]) -
         m[1] * (m[3] * m[8] - m[5] * m[6]) +
         m[2] * (m[3] * m[7] - m[4] * m[6]);
}

template <int kMode, bool kScale>
__global__ void __launch_bounds__(kThreads) horn_align_kernel(const HornArgs a) {
  __shared__ double red[kWarps * 10];
  __shared__ float rt[13];
  __shared__ int cnt[kWarps], cnt_i[kWarps];
  const int row = blockIdx.x, b = blockIdx.y, n = a.n;
  const size_t nb = static_cast<size_t>(b) * n;
  const float* src = a.src + 3 * nb;
  const float* dst = a.dst + 3 * nb;
  const float* valid = a.valid + nb;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  const float* w_row = nullptr;
  const unsigned char* inl_row = nullptr;
  int tri[3] = {-1, -1, -1};
  if (kMode == kWeights) w_row = a.weights + static_cast<size_t>(row) * n;
  if (kMode == kTriplets) {
    const int* tr = a.triplets + 3 * (static_cast<size_t>(b) * a.h + row);
    tri[0] = tr[0];
    tri[1] = tr[1];
    tri[2] = tr[2];
  }
  if (kMode == kRefit) {
    // the first row of the largest count
    const int* counts = a.prev_n_inl + static_cast<size_t>(b) * a.h;
    int bv = INT_MIN, bi = INT_MAX;
    for (int r = threadIdx.x; r < a.h; r += kThreads) {
      if (counts[r] > bv) {
        bv = counts[r];
        bi = r;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const int ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (ov > bv || (ov == bv && oi < bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == 0) {
      cnt[warp] = bv;
      cnt_i[warp] = bi;
    }
    __syncthreads();
    int v = cnt[0], best = cnt_i[0];
    for (int w = 1; w < kWarps; ++w) {
      if (cnt[w] > v || (cnt[w] == v && cnt_i[w] < best)) {
        v = cnt[w];
        best = cnt_i[w];
      }
    }
    __syncthreads();  // cnt is the count's scratch below
    inl_row = a.prev_inl + (static_cast<size_t>(b) * a.h + best) * n;
  }
  // the row's weight of point i, in its mode
  auto weight = [&](int i) -> float {
    if (kMode == kWeights) return w_row[i];
    if (kMode == kTriplets) {
      const bool hit = i == tri[0] || i == tri[1] || i == tri[2];
      return __fadd_rn(hit ? valid[i] : 0.0f, 1e-9f);
    }
    return __fadd_rn(inl_row[i] != 0 ? 1.0f : 0.0f, 1e-9f);
  };

  // pass 1: weight total and weighted sums of src and dst
  double s1[7] = {0, 0, 0, 0, 0, 0, 0};
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const double wi = weight(i);
    s1[0] += wi;
    for (int k = 0; k < 3; ++k) {
      s1[1 + k] += wi * src[3 * i + k];
      s1[4 + k] += wi * dst[3 * i + k];
    }
  }
  block_sum<7>(s1, red);
  const double wsum = fmax(s1[0], 1e-9);
  const double mu_s[3] = {s1[1] / wsum, s1[2] / wsum, s1[3] / wsum};
  const double mu_d[3] = {s1[4] / wsum, s1[5] / wsum, s1[6] / wsum};

  // pass 2: centred cross-covariance C = sum w (d - mu_d)(s - mu_s)^T / W,
  // and with the scale var = sum w |s - mu_s|^2 / W
  constexpr int kSums = kScale ? 10 : 9;
  double c[kSums];
  for (int k = 0; k < kSums; ++k) c[k] = 0.0;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const double wi = weight(i) / wsum;
    double xs[3], xd[3];
    for (int k = 0; k < 3; ++k) {
      xs[k] = src[3 * i + k] - mu_s[k];
      xd[k] = dst[3 * i + k] - mu_d[k];
    }
    for (int a3 = 0; a3 < 3; ++a3) {
      for (int b3 = 0; b3 < 3; ++b3) c[3 * a3 + b3] += wi * xd[a3] * xs[b3];
    }
    if (kScale) c[kSums - 1] += wi * (xs[0] * xs[0] + xs[1] * xs[1] + xs[2] * xs[2]);
  }
  block_sum<kSums>(c, red);

  const size_t out_row = static_cast<size_t>(b) * a.h + row;
  if (threadIdx.x == 0) {
    double R[9], sv[3];
    psl_nearest_rotation(c, R, sv);
    double scale = 1.0;
    if (kScale) {
      const double sign = det3(c) < 0.0 ? -1.0 : 1.0;
      scale = (sv[0] + sv[1] + sign * sv[2]) / fmax(c[kSums - 1], 1e-12);
    }
    for (int a3 = 0; a3 < 3; ++a3) {
      const double rm = R[3 * a3] * mu_s[0] + R[3 * a3 + 1] * mu_s[1] +
                        R[3 * a3 + 2] * mu_s[2];
      const double t = mu_d[a3] - (kScale ? scale * rm : rm);
      for (int b3 = 0; b3 < 3; ++b3) {
        rt[3 * a3 + b3] = static_cast<float>(R[3 * a3 + b3]);
      }
      rt[9 + a3] = static_cast<float>(t);
    }
    rt[12] = static_cast<float>(scale);
    if (kMode == kRefit) {
      float* o = a.R + static_cast<size_t>(b) * (kPacked + n);
      for (int k = 0; k < 13; ++k) o[k] = rt[k];
    } else {
      for (int k = 0; k < 9; ++k) a.R[9 * out_row + k] = rt[k];
      for (int k = 0; k < 3; ++k) a.t[3 * out_row + k] = rt[9 + k];
      if (a.s != nullptr) a.s[out_row] = rt[12];
    }
  }
  __syncthreads();

  // pass 3: inliers at the float32 pose
  const float thr2 = a.threshold * a.threshold;
  const float scale = rt[12];
  int count = 0;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float sx = src[3 * i], sy = src[3 * i + 1], sz = src[3 * i + 2];
    float err = 0.0f;
    for (int a3 = 0; a3 < 3; ++a3) {
      const float rs = sx * rt[3 * a3] + sy * rt[3 * a3 + 1] + sz * rt[3 * a3 + 2];
      const float p = (kScale ? scale * rs : rs) + rt[9 + a3];
      const float d = p - dst[3 * i + a3];
      err += d * d;
    }
    const bool ok = (err < thr2) && (valid[i] > 0.0f);
    if (kMode == kRefit) {
      a.R[static_cast<size_t>(b) * (kPacked + n) + kPacked + i] = ok ? 1.0f : 0.0f;
    } else {
      a.inl[out_row * n + i] = ok ? 1 : 0;
    }
    count += ok ? 1 : 0;
  }
  for (int off = 16; off > 0; off >>= 1) {
    count += __shfl_xor_sync(0xffffffffu, count, off);
  }
  if (lane == 0) cnt[warp] = count;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int k = 0; k < kWarps; ++k) total += cnt[k];
    if (kMode == kRefit) {
      a.R[static_cast<size_t>(b) * (kPacked + n) + 13] = __int_as_float(total);
    } else {
      a.n_inl[out_row] = total;
    }
  }
}

template <int kMode>
int launch_mode(const HornArgs& a, int rows, int batch, bool with_scale,
                cudaStream_t stream) {
  const dim3 grid(rows, batch);
  if (with_scale) {
    horn_align_kernel<kMode, true><<<grid, kThreads, 0, stream>>>(a);
  } else {
    horn_align_kernel<kMode, false><<<grid, kThreads, 0, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

HornArgs horn_args(const float* src, const float* dst, const float* valid,
                   int n, int h, float threshold) {
  HornArgs a = {};
  a.src = src;
  a.dst = dst;
  a.valid = valid;
  a.n = n;
  a.h = h;
  a.threshold = threshold;
  return a;
}

}  // namespace

// Weights mode, one problem: src, dst (n, 3), valid (n,), weights (h, n);
// outputs R (h, 3, 3), t (h, 3), n_inl (h,), inl (h, n).
PSL_API int psl_horn_align_batch(const float* src, const float* dst,
                                 const float* valid, const float* weights,
                                 int h, int n, float threshold, float* R,
                                 float* t, int* n_inl, unsigned char* inl,
                                 cudaStream_t stream) {
  if (h < 1 || n < 1) return static_cast<int>(cudaGetLastError());
  HornArgs a = horn_args(src, dst, valid, n, h, threshold);
  a.weights = weights;
  a.R = R;
  a.t = t;
  a.n_inl = n_inl;
  a.inl = inl;
  return launch_mode<kWeights>(a, h, 1, false, stream);
}

// Triplets mode, `batch` problems: src, dst (batch, n, 3), valid (batch,
// n), triplets (batch, h, 3) int32; outputs R (batch, h, 3, 3), t (batch,
// h, 3), s (batch, h), n_inl (batch, h), inl (batch, h, n).
PSL_API int psl_horn_triplets(const float* src, const float* dst,
                              const float* valid, const int* triplets, int n,
                              int h, int batch, float threshold,
                              int with_scale, float* R, float* t, float* s,
                              int* n_inl, unsigned char* inl,
                              cudaStream_t stream) {
  if (h < 1 || n < 1 || batch < 1 || batch > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  HornArgs a = horn_args(src, dst, valid, n, h, threshold);
  a.triplets = triplets;
  a.R = R;
  a.t = t;
  a.s = s;
  a.n_inl = n_inl;
  a.inl = inl;
  return launch_mode<kTriplets>(a, h, batch, with_scale != 0, stream);
}

// Refit mode, `batch` problems: the triplet launch's n_inl (batch, h) and
// inl (batch, h, n); out (batch, 14 + n) float32: R, t, s, the inlier
// count's int32 bits, the mask as 0 / 1.
PSL_API int psl_horn_refit(const float* src, const float* dst,
                           const float* valid, const int* n_inl,
                           const unsigned char* inl, int n, int h, int batch,
                           float threshold, int with_scale, float* out,
                           cudaStream_t stream) {
  if (h < 1 || n < 1 || batch < 1 || batch > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  HornArgs a = horn_args(src, dst, valid, n, h, threshold);
  a.prev_n_inl = n_inl;
  a.prev_inl = inl;
  a.R = out;
  return launch_mode<kRefit>(a, 1, batch, with_scale != 0, stream);
}
