// K40 ba_schur_complement — the reduced camera system's landmark product of
// one bundle-adjustment LM step, over the keyframe pairs that share a
// landmark only.
//
// Replaces planarslam_tpu/solvers/ba_core.py::ba_solve.step :469-472
// (S_blocks = einsum("kpil,qpml->kqim", HcpHinv, Hcp), one XLA product):
//   S[6 k + i, 6 q + m] = -sum_p sum_l HcpHinv[k, i, p, l] Hcp[q, m, p, l]
// with HcpHinv and Hcp laid out (Kt, 6, M, 3) (K9's output and K8's), into
// the dense (6 Kt, 6 Kt) float32 S that K35 reads. The plan (ba_core.py::
// pair_plan) is one bit row per keyframe: bit p of row k is set when k has
// a live observation of landmark p (points, line endpoints, planes at P +
// slot), so a pair (k, q) shares exactly the landmarks of row_k & row_q;
// with it each row's count of set bits, so that a pair with an empty row
// (the padding of a keyframe window) writes its zeros without a walk.
//
// A block per keyframe pair k <= q (blocks with k > q return): thread o <
// 36 sums entry (o / 6, o % 6) of S[k, q], thread 36 + o the same entry of
// S[q, k] (k < q only), each from its own terms, so the lower triangle is
// computed, not mirrored: every entry sums the products the plain dense
// product sums. Each warp walks the AND of the two rows 32 words at a time,
// lists the shared landmarks of those words in ascending order in its
// shared memory, and adds them in that order: per landmark the three
// products l = 0, 1, 2, each a fused multiply-add into the entry, as a
// float32 GEMM's inner loop adds its terms. No atomics:
// two launches give the same bits. A pair that shares no landmark writes
// -0.0, as the plain product's zero blocks are. A leading batch of B
// problems is the grid's third axis.
// What bounds it on an H100: the latency of the landmark loop of the pairs
// that share the most (the diagonal blocks); the work is 2 x 216 flops per
// (k <= q, p) triplet and the bytes the nonzero 6 x 3 blocks of both
// operands and S.
#include "common.cuh"

namespace {

constexpr int kThreads = 96;   // 72 outputs of a pair's two blocks
constexpr int kWarps = kThreads / 32;
constexpr int kListCap = 32 * 32;  // the landmarks of 32 words
constexpr int kUnroll = 8;

__device__ __forceinline__ void add_landmark(const float* __restrict__ a,
                                             const float* __restrict__ b,
                                             float& acc) {
  acc = __fmaf_rn(a[0], b[0], acc);
  acc = __fmaf_rn(a[1], b[1], acc);
  acc = __fmaf_rn(a[2], b[2], acc);
}

__global__ void __launch_bounds__(kThreads)
    camera_complement_kernel(const float* __restrict__ HcpHinv,
                             const float* __restrict__ Hcp,
                             const unsigned* __restrict__ bits,
                             const int* __restrict__ counts, int Kt, int M,
                             int W, float* __restrict__ S) {
  __shared__ int listed[kWarps][kListCap];
  const int k = blockIdx.x, q = blockIdx.y, b = blockIdx.z;
  if (k > q) return;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int o = threadIdx.x;
  const int n_out = k == q ? 36 : 72;
  if (warp * 32 >= n_out) return;  // a warp with no entry (diagonal pairs)
  const bool active = o < n_out;
  const bool upper = o < 36;
  const int ra = upper ? k : q, rb = upper ? q : k;
  const int ia = (upper ? o : o - 36) / 6, ib = (upper ? o : o - 36) % 6;
  const size_t n6 = static_cast<size_t>(Kt) * 6;
  float* out = S + b * n6 * n6 + (static_cast<size_t>(ra) * 6 + ia) * n6 +
               rb * 6 + ib;
  // a keyframe with no live observation shares nothing: its blocks are 0
  // without a walk of the rows
  if (__ldg(counts + b * Kt + k) == 0 || __ldg(counts + b * Kt + q) == 0) {
    if (active) *out = -0.0f;
    return;
  }
  const size_t prob = static_cast<size_t>(Kt) * 18 * M;
  const float* a_row = HcpHinv + b * prob +
                       (static_cast<size_t>(ra) * 6 + ia) * M * 3;
  const float* b_row = Hcp + b * prob +
                       (static_cast<size_t>(rb) * 6 + ib) * M * 3;
  const unsigned* rk = bits + (static_cast<size_t>(b) * Kt + k) * W;
  const unsigned* rq = bits + (static_cast<size_t>(b) * Kt + q) * W;
  int* lms = listed[warp];
  float acc = 0.0f;
  for (int w0 = 0; w0 < W; w0 += 32) {
    const int w = w0 + lane;
    unsigned x = w < W ? (__ldg(rk + w) & __ldg(rq + w)) : 0u;
    const int n = __popc(x);
    int incl = n;
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += y;
    }
    const int total = __shfl_sync(0xffffffffu, incl, 31);
    int pos = incl - n;
    while (x) {
      lms[pos++] = w * 32 + __ffs(x) - 1;
      x &= x - 1;
    }
    __syncwarp();
    if (active) {
      int j = 0;
      for (; j + kUnroll <= total; j += kUnroll) {
        float av[kUnroll][3], bv[kUnroll][3];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const size_t p3 = static_cast<size_t>(lms[j + u]) * 3;
#pragma unroll
          for (int l = 0; l < 3; ++l) {
            av[u][l] = __ldg(a_row + p3 + l);
            bv[u][l] = __ldg(b_row + p3 + l);
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) add_landmark(av[u], bv[u], acc);
      }
      for (; j < total; ++j) {
        const size_t p3 = static_cast<size_t>(lms[j]) * 3;
        const float av[3] = {__ldg(a_row + p3), __ldg(a_row + p3 + 1),
                             __ldg(a_row + p3 + 2)};
        const float bv[3] = {__ldg(b_row + p3), __ldg(b_row + p3 + 1),
                             __ldg(b_row + p3 + 2)};
        add_landmark(av, bv, acc);
      }
    }
    __syncwarp();
  }
  if (active) *out = -acc;
}

}  // namespace

PSL_API int psl_ba_schur_complement(const float* HcpHinv, const float* Hcp,
                                    const int* bits, const int* counts,
                                    int batch, int Kt, int M, int W, float* S,
                                    cudaStream_t stream) {
  if (batch > 0 && Kt > 0) {
    camera_complement_kernel<<<dim3(Kt, Kt, batch), kThreads, 0, stream>>>(
        HcpHinv, Hcp, reinterpret_cast<const unsigned*>(bits), counts, Kt, M,
        W, S);
  }
  return static_cast<int>(cudaGetLastError());
}
