// K2 orb_describe — intensity-centroid orientation fused with steered BRIEF.
//
// Replaces planarslam_tpu/ops/orb.py::orientations (r=15 circular-patch
// moments m10/m01, atan2) together with ::descriptors and ::pack_bits (256
// orientation-steered comparisons on the blurred level, packed into 8
// 32-bit words). The JAX version gathers a (K, 31, 31) patch stack and a
// (K, 256) sample pair stack through device memory; here one 256-thread
// block owns one keypoint:
//   1. the block strides over the 961 patch pixels, each thread summing its
//      masked dx*I and dy*I, then a warp-shuffle + shared-memory reduction
//      gives m10/m01 and thread 0 takes atan2;
//   2. thread i evaluates comparison pair i at the steered offsets, and
//      __ballot_sync packs warp w's 32 bits into word w (bit j of word w =
//      comparison 32w + j, the pack_bits layout).
// Invalid keypoints get angle 0 and an all-zero descriptor.
//
// What bounds it on an H100: latency of dependent gathers. Each keypoint
// reads ~1.5k pixels from L2 (the level images fit in L2 many times over)
// and does ~4k flops; 1000 keypoints spread over 8 levels give at most a
// few hundred blocks per launch, fewer than the card can hold at once, so
// a launch costs a few microseconds of gather latency plus launch overhead.
// The steering products use explicit round-to-nearest intrinsics so nvcc
// cannot contract them into FMAs: the sample positions then round exactly
// as the plain version's do, up to sinf/cosf ulps.
//
// orb_describe_levels_kernel describes the keypoints of every level of a
// frame (and of every frame of a batch) in one launch: block k owns slot k
// of the frame's keypoint block, finds its level in the by-value table
// (levels.cuh), reads that level of the image and blur buffers, and writes
// angle and descriptor straight into the fixed-capacity outputs; the slots
// past the last level's quota get angle 0 and a zero descriptor.
#include "common.cuh"
#include "levels.cuh"

namespace {

constexpr int kHalfPatch = 15;
constexpr int kPatch = 2 * kHalfPatch + 1;
constexpr int kThreads = 256;

// One keypoint by one block of kThreads threads: (u, v) level coordinates,
// `ok` its validity; writes angle_out[0] and desc_out[0..7].
__device__ __forceinline__ void describe_keypoint(
    const float* __restrict__ img, const float* __restrict__ blur, int h,
    int w, float u, float v, bool ok, const int* __restrict__ pattern,
    float* __restrict__ angle_out, int* __restrict__ desc_out) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  __shared__ float red10[kThreads / 32];
  __shared__ float red01[kThreads / 32];
  __shared__ float s_angle;

  // 1. intensity centroid over the clamped 31x31 window, circular mask
  const int y0 = psl_clamp(static_cast<int>(rintf(v)) - kHalfPatch, 0,
                           h - kPatch);
  const int x0 = psl_clamp(static_cast<int>(rintf(u)) - kHalfPatch, 0,
                           w - kPatch);
  float m10 = 0.0f;
  float m01 = 0.0f;
  for (int p = tid; p < kPatch * kPatch; p += kThreads) {
    const int dy = p / kPatch - kHalfPatch;
    const int dx = p % kPatch - kHalfPatch;
    if (dx * dx + dy * dy <= kHalfPatch * kHalfPatch) {
      const float val = img[(y0 + dy + kHalfPatch) * w + (x0 + dx +
                                                          kHalfPatch)];
      m10 += val * static_cast<float>(dx);
      m01 += val * static_cast<float>(dy);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    m10 += __shfl_xor_sync(0xffffffffu, m10, off);
    m01 += __shfl_xor_sync(0xffffffffu, m01, off);
  }
  if (lane == 0) {
    red10[warp] = m10;
    red01[warp] = m01;
  }
  __syncthreads();
  if (tid == 0) {
    float a = 0.0f;
    float b = 0.0f;
    for (int i = 0; i < kThreads / 32; ++i) {
      a += red10[i];
      b += red01[i];
    }
    s_angle = ok ? atan2f(b, a) : 0.0f;
  }
  __syncthreads();
  const float ang = s_angle;
  if (tid == 0) angle_out[0] = ang;

  // 2. steered comparison pair `tid`
  const float ca = cosf(ang);
  const float sa = sinf(ang);
  const float ax = static_cast<float>(pattern[4 * tid + 0]);
  const float ay = static_cast<float>(pattern[4 * tid + 1]);
  const float bx = static_cast<float>(pattern[4 * tid + 2]);
  const float by = static_cast<float>(pattern[4 * tid + 3]);
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
  const bool bit = blur[va * w + ua] < blur[vb * w + ub];
  const unsigned word = __ballot_sync(0xffffffffu, bit);
  if (lane == 0) desc_out[warp] = ok ? static_cast<int>(word) : 0;
}

__global__ void orb_describe_kernel(const float* __restrict__ img,
                                    const float* __restrict__ blur, int h,
                                    int w, const float* __restrict__ uv,
                                    const unsigned char* __restrict__ valid,
                                    const int* __restrict__ pattern,
                                    float* __restrict__ angle_out,
                                    int* __restrict__ desc_out) {
  const int k = blockIdx.x;
  describe_keypoint(img, blur, h, w, uv[2 * k], uv[2 * k + 1], valid[k] != 0,
                    pattern, angle_out + k, desc_out + 8 * k);
}

// uv, valid: (batch, n_slots) level coordinates and validity of the slots
// the levels own; angle_out, desc_out: (batch, capacity) with capacity =
// gridDim.x >= n_slots.
__global__ void orb_describe_levels_kernel(
    const float* __restrict__ buf, const float* __restrict__ blur,
    const PslLevels lv, const float* __restrict__ uv,
    const unsigned char* __restrict__ valid, const int* __restrict__ pattern,
    float* __restrict__ angle_out, int* __restrict__ desc_out) {
  const int k = blockIdx.x;
  const int n_slots = lv.slot_off[lv.n];
  const size_t out = static_cast<size_t>(blockIdx.y) * gridDim.x + k;
  if (k >= n_slots) {
    if (threadIdx.x == 0) angle_out[out] = 0.0f;
    if (threadIdx.x < 8) desc_out[8 * out + threadIdx.x] = 0;
    return;
  }
  const int l = psl_level_of(lv.slot_off, lv.n, k);
  const size_t in = static_cast<size_t>(blockIdx.y) * n_slots + k;
  const size_t px = static_cast<size_t>(blockIdx.y) * lv.n_pixels + lv.off[l];
  describe_keypoint(buf + px, blur + px, lv.h[l], lv.w[l], uv[2 * in],
                    uv[2 * in + 1], valid[in] != 0, pattern, angle_out + out,
                    desc_out + 8 * out);
}

}  // namespace

PSL_API int psl_orb_describe(const float* img, const float* blur, int h,
                             int w, const float* uv,
                             const unsigned char* valid, int n,
                             const int* pattern, float* angle, int* desc,
                             cudaStream_t stream) {
  if (n > 0) {
    orb_describe_kernel<<<n, kThreads, 0, stream>>>(img, blur, h, w, uv,
                                                    valid, pattern, angle,
                                                    desc);
  }
  return static_cast<int>(cudaGetLastError());
}

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
      capacity < lv.slot_off[lv.n]) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (capacity > 0) {
    orb_describe_levels_kernel<<<dim3(capacity, batch), kThreads, 0, stream>>>(
        buf, blur, lv, uv, valid, pattern, angle, desc);
  }
  return static_cast<int>(cudaGetLastError());
}
