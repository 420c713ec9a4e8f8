// K2 orb_describe — intensity-centroid orientation fused with steered BRIEF.
//
// Replaces planarslam_tpu/ops/orb.py::orientations (r=15 circular-patch
// moments m10/m01, atan2) together with ::descriptors and ::pack_bits (256
// orientation-steered comparisons on the blurred level, packed into 8
// 32-bit words). The JAX version gathers a (K, 31, 31) patch stack and a
// (K, 256) sample pair stack through device memory; here one warp owns one
// keypoint slot, with no shared memory and no barrier:
//   1. lane j reads the patch pixels p = j + 32 m (m = 0..30: consecutive
//      lanes on consecutive pixels) and adds its masked dx*I and dy*I into
//      accumulator m mod 8 in increasing m, then an xor butterfly over the
//      lanes reduces each of the 8 accumulators of both moments, and every
//      lane (all hold the same sums) adds the 8 from 0 and takes atan2f;
//   2. lane j evaluates comparison pairs 32 w + j (w = 0..7) at the steered
//      offsets, and __ballot_sync packs word w (bit j of word w =
//      comparison 32 w + j, the pack_bits layout); lane w < 8 stores word w.
// Each lane loads its 8 pattern rows (int4, angle-free) with the slot's uv,
// before the patch. Invalid slots get angle 0 and an all-zero descriptor,
// without reading the image.
//
// The sums are those of the kernel's first design, a 256-thread block a
// keypoint, bit for bit: its thread 32 w + j summed p = 32 w + j + 256 i in
// increasing i, which is lane j's accumulator w here, its warps reduced
// each sum by the same butterfly and its thread 0 added the 8 warp sums
// from 0. The masked product-sums are fused multiply-adds as that design's
// compiled `m10 += val * dx` was (this file keeps nvcc's contraction on).
//
// What bounds it on an H100: a warp's chain of three dependent round trips
// (uv and the pattern, the patch, the steered samples) and its
// instructions, not bytes or operations. A slot reads ~1.5k pixels from L2
// (the level images fit in L2 many times over) and does ~5k operations.
// 1024 slots a frame are 256 blocks of 4 warps; at 128 registers a thread
// an SM holds 4 blocks, so a frame is one wave and B = 4 two. The mask
// test stays a predicate: a per-lane bit table of the circle made it a
// divergent branch, and nvcc then issued each patch load after the branch
// before it. The steering products use explicit round-to-nearest
// intrinsics so nvcc cannot contract them into FMAs: the sample positions
// then round exactly as the plain version's do, up to sinf/cosf ulps.
//
// orb_describe_levels_kernel describes the keypoints of every level of a
// frame (and of every frame of a batch) in one launch: warp k owns slot k
// of the frame's keypoint block, finds its level in the by-value table
// (levels.cuh), reads that level of the image and blur buffers, and writes
// angle and descriptor straight into the fixed-capacity outputs; the slots
// past the last level's quota get angle 0 and a zero descriptor. A lone
// level is a one-level table (ops/orb.py::orb_describe).
#include "common.cuh"
#include "levels.cuh"

namespace {

constexpr int kHalfPatch = 15;
constexpr int kPatch = 2 * kHalfPatch + 1;
constexpr int kPatchPixels = kPatch * kPatch;
constexpr int kRounds = (kPatchPixels + 31) / 32;  // patch loads a lane
constexpr int kParts = 8;  // accumulators a moment: the first design's warps
constexpr int kWords = 8;  // descriptor words: 256 pairs
constexpr int kWarps = 4;  // slots a block
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;

// A slot without a keypoint: angle 0, zero descriptor.
__device__ __forceinline__ void write_empty(int lane, float* angle_out,
                                            int* desc_out) {
  if (lane == 0) angle_out[0] = 0.0f;
  if (lane < kWords) desc_out[lane] = 0;
}

// One valid keypoint by one warp: (u, v) level coordinates, `pat` the
// lane's pattern rows lane + 32 w; writes angle_out[0] and desc_out[0..7].
__device__ __forceinline__ void describe_keypoint(
    const float* __restrict__ img, const float* __restrict__ blur, int h,
    int w, float u, float v, const int4 (&pat)[kWords], int lane,
    float* __restrict__ angle_out, int* __restrict__ desc_out) {
  // 1. intensity centroid over the clamped 31x31 window, circular mask
  const int y0 = psl_clamp(static_cast<int>(rintf(v)) - kHalfPatch, 0,
                           h - kPatch);
  const int x0 = psl_clamp(static_cast<int>(rintf(u)) - kHalfPatch, 0,
                           w - kPatch);
  const float* win = img + static_cast<size_t>(y0) * w + x0;
  float val[kRounds];
#pragma unroll
  for (int m = 0; m < kRounds; ++m) {
    const int p = lane + 32 * m;
    val[m] = p < kPatchPixels ? __ldg(win + (p / kPatch) * w + p % kPatch)
                              : 0.0f;
  }
  float m10[kParts], m01[kParts];
#pragma unroll
  for (int i = 0; i < kParts; ++i) m10[i] = m01[i] = 0.0f;
#pragma unroll
  for (int m = 0; m < kRounds; ++m) {
    const int p = lane + 32 * m;
    const int dy = p / kPatch - kHalfPatch;
    const int dx = p % kPatch - kHalfPatch;
    if (p < kPatchPixels && dx * dx + dy * dy <= kHalfPatch * kHalfPatch) {
      m10[m % kParts] = __fmaf_rn(val[m], static_cast<float>(dx),
                                  m10[m % kParts]);
      m01[m % kParts] = __fmaf_rn(val[m], static_cast<float>(dy),
                                  m01[m % kParts]);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int i = 0; i < kParts; ++i) {
      m10[i] += __shfl_xor_sync(kFull, m10[i], off);
      m01[i] += __shfl_xor_sync(kFull, m01[i], off);
    }
  }
  // float addition commutes, so every lane holds the same 8 sums: the
  // first design's thread 0 added them from 0 in this order
  float a = 0.0f;
  float b = 0.0f;
#pragma unroll
  for (int i = 0; i < kParts; ++i) {
    a += m10[i];
    b += m01[i];
  }
  const float ang = atan2f(b, a);

  // 2. steered comparison pairs lane + 32 w: every sample index first, then
  // every gather, then the comparisons
  const float ca = cosf(ang);
  const float sa = sinf(ang);
  int ia[kWords], ib[kWords];
#pragma unroll
  for (int m = 0; m < kWords; ++m) {
    const float ax = static_cast<float>(pat[m].x);
    const float ay = static_cast<float>(pat[m].y);
    const float bx = static_cast<float>(pat[m].z);
    const float by = static_cast<float>(pat[m].w);
    const float rax = __fsub_rn(__fmul_rn(ca, ax), __fmul_rn(sa, ay));
    const float ray = __fadd_rn(__fmul_rn(sa, ax), __fmul_rn(ca, ay));
    const float rbx = __fsub_rn(__fmul_rn(ca, bx), __fmul_rn(sa, by));
    const float rby = __fadd_rn(__fmul_rn(sa, bx), __fmul_rn(ca, by));
    const int ua = psl_clamp(static_cast<int>(rintf(__fadd_rn(u, rax))), 0,
                             w - 1);
    const int va = psl_clamp(static_cast<int>(rintf(__fadd_rn(v, ray))), 0,
                             h - 1);
    const int ub = psl_clamp(static_cast<int>(rintf(__fadd_rn(u, rbx))), 0,
                             w - 1);
    const int vb = psl_clamp(static_cast<int>(rintf(__fadd_rn(v, rby))), 0,
                             h - 1);
    ia[m] = va * w + ua;
    ib[m] = vb * w + ub;
  }
  float sa_val[kWords], sb_val[kWords];
#pragma unroll
  for (int m = 0; m < kWords; ++m) {
    sa_val[m] = __ldg(blur + ia[m]);
    sb_val[m] = __ldg(blur + ib[m]);
  }
  unsigned mine = 0;
#pragma unroll
  for (int m = 0; m < kWords; ++m) {
    const unsigned word = __ballot_sync(kFull, sa_val[m] < sb_val[m]);
    if (lane == m) mine = word;
  }
  if (lane == 0) angle_out[0] = ang;
  if (lane < kWords) desc_out[lane] = static_cast<int>(mine);
}

// uv, valid: (batch, n_slots) level coordinates and validity of the slots
// the levels own; angle_out, desc_out: (batch, capacity), capacity >=
// n_slots; warp k of the grid's row blockIdx.y owns slot k of that frame.
__global__ void __launch_bounds__(kThreads) orb_describe_levels_kernel(
    const float* __restrict__ buf, const float* __restrict__ blur,
    const PslLevels lv, const float2* __restrict__ uv,
    const unsigned char* __restrict__ valid, int capacity,
    const int4* __restrict__ pattern, float* __restrict__ angle_out,
    int* __restrict__ desc_out) {
  const int lane = threadIdx.x & 31;
  const int k = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (k >= capacity) return;
  const int n_slots = lv.slot_off[lv.n];
  const size_t out = static_cast<size_t>(blockIdx.y) * capacity + k;
  if (k >= n_slots) {
    write_empty(lane, angle_out + out, desc_out + kWords * out);
    return;
  }
  int4 pat[kWords];  // the lane's pattern rows lane + 32 w (16 bytes each)
#pragma unroll
  for (int m = 0; m < kWords; ++m) pat[m] = __ldg(pattern + 32 * m + lane);
  const size_t in = static_cast<size_t>(blockIdx.y) * n_slots + k;
  const bool ok = __ldg(valid + in) != 0;
  const float2 p = __ldg(uv + in);
  if (!ok) {
    write_empty(lane, angle_out + out, desc_out + kWords * out);
    return;
  }
  const int l = psl_level_of(lv.slot_off, lv.n, k);
  const size_t px = static_cast<size_t>(blockIdx.y) * lv.n_pixels + lv.off[l];
  describe_keypoint(buf + px, blur + px, lv.h[l], lv.w[l], p.x, p.y, pat,
                    lane, angle_out + out, desc_out + kWords * out);
}

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<size_t>(p) % bytes == 0;
}

}  // namespace

// All levels of `batch` frames in one launch: buf, blur (batch, n_pixels);
// uv (batch, n_slots, 2), valid (batch, n_slots); angle (batch, capacity),
// desc (batch, capacity, 8); rows is the host's level table.
PSL_API int psl_orb_describe_levels(const float* buf, const float* blur,
                                    const int* rows, int n_levels, int batch,
                                    const float* uv,
                                    const unsigned char* valid, int capacity,
                                    const int* pattern, float* angle,
                                    int* desc, cudaStream_t stream) {
  PslLevels lv;
  if (!psl_levels_from_host(rows, nullptr, n_levels, &lv) || batch < 1 ||
      capacity < lv.slot_off[lv.n] || !aligned(pattern, 16) ||
      !aligned(uv, 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (capacity > 0) {
    const dim3 grid((capacity + kWarps - 1) / kWarps, batch);
    orb_describe_levels_kernel<<<grid, kThreads, 0, stream>>>(
        buf, blur, lv, reinterpret_cast<const float2*>(uv), valid, capacity,
        reinterpret_cast<const int4*>(pattern), angle, desc);
  }
  return static_cast<int>(cudaGetLastError());
}
