// K37 decode_step_inputs: the tracking step's sensor decode and the casts
// of its local-map window, `batch` lanes in one launch.
//
// Replaces planarslam_tpu/slam/device_tracker.py::to_gray_depth (:145-158)
// with the packed unpack of fused_track_step_packed (:573-590), and the
// casts of unpack_window (:762-790), all inside the JAX package's jitted
// step. The plain version is planarslam_tpu_torch/slam/device_tracker.py::
// decode_step_inputs_plain (unpack_frame, to_gray_depth, unpack_window).
// From the packed (B, 3, H, W) uint8 frame ([gray, depth_lo, depth_hi]) it
// writes the float32 grey (the byte, exactly) and the depth in metres:
// (lo | hi << 8) as a float, times `scale` = float32(1) /
// float32(depth_map_factor) in one rounding, the form of JAX's jitted
// division by the factor (device_tracker.py::depth_scale). Unpacked
// integer frames take the same path: grey as uint8 and depth as int32 or
// uint16 values (a source given as floats passes through the wrapper and
// is not read here). In the same launch the last blocks of the grid cast
// the window's flags, pt_valid (4096), ln_valid (256) and pl_valid (Mp),
// to bool as f > 0.5f (NaN false, as PyTorch's compare), and its cloud
// counts pl_cloud_n (Mp) to int64, truncated toward zero
// (cvt.rzi.s64.f32, PyTorch's .to(torch.int64)); the window's float fields
// stay views of the packed buffer in the wrapper.
//
// Bound: bytes. At 640x480 and B = 1 it reads 921,600 bytes of frame and
// writes 2,457,600 (about 22 KB of window besides): ~1.0 us at 3.35 TB/s.
// Design, a bandwidth-bound elementwise pass: a thread takes 4 pixels, one
// 32-bit load from each byte plane (16 bytes of int32 depth, 8 of uint16)
// and one float4 store each of grey and depth, every load issued before the
// arithmetic; the pixel blocks are sized for about one wave (8 blocks of
// 256 threads an SM) and stride over the lanes' pixels beyond it; a lane
// whose pixel count is not a multiple of 4 (or a source not aligned for
// the vector loads) takes the scalar path, a pixel a thread. The window's
// items follow in further blocks of the same grid, an item a thread.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kDecodeThreads = 256;
constexpr int kBlocksPerSm = 8;  // 2048 threads: one wave of 256-thread blocks

// how a lane's depth is read
enum DepthKind { kDepthNone = 0, kDepthBytes = 1, kDepthInt32 = 2,
                 kDepthUInt16 = 3 };

struct DecodeArgs {
  const unsigned char* gray;  // lane 0's grey plane (uint8), or NULL
  long long gray_stride;      // elements between two lanes' planes
  const void* depth;          // the lo plane (bytes) or the values
  const unsigned char* depth_hi;  // the hi plane (bytes)
  long long depth_stride;
  int depth_kind;
  int hw;                     // pixels a lane
  int batch;
  float scale;                // float32(1) / float32(depth_map_factor)
  float* gray_out;            // (B, hw), or NULL
  float* depth_out;           // (B, hw), or NULL
  bool vec;                   // 4 pixels a thread
  long long pixel_items;      // B * hw / 4 (vec) or B * hw
  int pixel_blocks;           // blocks of the grid that take pixels
  // the window
  const float* win;           // (B, win_stride), or NULL
  long long win_stride;
  int off_pt, n_pt, off_ln, n_ln, off_pl, off_cn, n_pl;
  unsigned char* pt_valid;    // (B, n_pt)
  unsigned char* ln_valid;    // (B, n_ln)
  unsigned char* pl_valid;    // (B, n_pl)
  long long* pl_cloud_n;      // (B, n_pl)
};

__device__ __forceinline__ float depth_value(unsigned v, float scale) {
  return __fmul_rn(__uint2float_rn(v), scale);
}

// pixels 4 g .. 4 g + 3 of lane b
__device__ __forceinline__ void decode_quad(const DecodeArgs& a, int b,
                                            long long g) {
  const long long p = 4 * g;
  uchar4 gq = make_uchar4(0, 0, 0, 0);
  uchar4 lo = make_uchar4(0, 0, 0, 0), hi = make_uchar4(0, 0, 0, 0);
  int4 di = make_int4(0, 0, 0, 0);
  ushort4 du = make_ushort4(0, 0, 0, 0);
  if (a.gray != nullptr) {
    gq = __ldg(reinterpret_cast<const uchar4*>(a.gray + b * a.gray_stride +
                                               p));
  }
  const long long dp = b * a.depth_stride + p;
  if (a.depth_kind == kDepthBytes) {
    lo = __ldg(reinterpret_cast<const uchar4*>(
        static_cast<const unsigned char*>(a.depth) + dp));
    hi = __ldg(reinterpret_cast<const uchar4*>(a.depth_hi + dp));
  } else if (a.depth_kind == kDepthInt32) {
    di = __ldg(reinterpret_cast<const int4*>(static_cast<const int*>(a.depth) +
                                             dp));
  } else if (a.depth_kind == kDepthUInt16) {
    du = __ldg(reinterpret_cast<const ushort4*>(
        static_cast<const unsigned short*>(a.depth) + dp));
  }
  const long long o = static_cast<long long>(b) * a.hw + p;
  if (a.gray_out != nullptr) {
    reinterpret_cast<float4*>(a.gray_out + o)[0] =
        make_float4(__uint2float_rn(gq.x), __uint2float_rn(gq.y),
                    __uint2float_rn(gq.z), __uint2float_rn(gq.w));
  }
  if (a.depth_kind == kDepthBytes) {
    reinterpret_cast<float4*>(a.depth_out + o)[0] = make_float4(
        depth_value(lo.x | (static_cast<unsigned>(hi.x) << 8), a.scale),
        depth_value(lo.y | (static_cast<unsigned>(hi.y) << 8), a.scale),
        depth_value(lo.z | (static_cast<unsigned>(hi.z) << 8), a.scale),
        depth_value(lo.w | (static_cast<unsigned>(hi.w) << 8), a.scale));
  } else if (a.depth_kind == kDepthInt32) {
    reinterpret_cast<float4*>(a.depth_out + o)[0] = make_float4(
        __fmul_rn(__int2float_rn(di.x), a.scale),
        __fmul_rn(__int2float_rn(di.y), a.scale),
        __fmul_rn(__int2float_rn(di.z), a.scale),
        __fmul_rn(__int2float_rn(di.w), a.scale));
  } else if (a.depth_kind == kDepthUInt16) {
    reinterpret_cast<float4*>(a.depth_out + o)[0] = make_float4(
        depth_value(du.x, a.scale), depth_value(du.y, a.scale),
        depth_value(du.z, a.scale), depth_value(du.w, a.scale));
  }
}

// pixel p of lane b, alone
__device__ __forceinline__ void decode_pixel(const DecodeArgs& a, int b,
                                             long long p) {
  const long long o = static_cast<long long>(b) * a.hw + p;
  const long long dp = b * a.depth_stride + p;
  if (a.gray_out != nullptr) {
    a.gray_out[o] = __uint2float_rn(__ldg(a.gray + b * a.gray_stride + p));
  }
  if (a.depth_kind == kDepthBytes) {
    const unsigned lo =
        __ldg(static_cast<const unsigned char*>(a.depth) + dp);
    const unsigned hi = __ldg(a.depth_hi + dp);
    a.depth_out[o] = depth_value(lo | (hi << 8), a.scale);
  } else if (a.depth_kind == kDepthInt32) {
    a.depth_out[o] = __fmul_rn(
        __int2float_rn(__ldg(static_cast<const int*>(a.depth) + dp)),
        a.scale);
  } else if (a.depth_kind == kDepthUInt16) {
    a.depth_out[o] = depth_value(
        __ldg(static_cast<const unsigned short*>(a.depth) + dp), a.scale);
  }
}

// item j of lane b's window: its flags, then its cloud counts
__device__ __forceinline__ void decode_window_item(const DecodeArgs& a, int b,
                                                   int j) {
  const float* w = a.win + b * a.win_stride;
  if (j < a.n_pt) {
    a.pt_valid[static_cast<long long>(b) * a.n_pt + j] =
        __ldg(w + a.off_pt + j) > 0.5f ? 1 : 0;
    return;
  }
  j -= a.n_pt;
  if (j < a.n_ln) {
    a.ln_valid[static_cast<long long>(b) * a.n_ln + j] =
        __ldg(w + a.off_ln + j) > 0.5f ? 1 : 0;
    return;
  }
  j -= a.n_ln;
  if (j < a.n_pl) {
    a.pl_valid[static_cast<long long>(b) * a.n_pl + j] =
        __ldg(w + a.off_pl + j) > 0.5f ? 1 : 0;
    return;
  }
  j -= a.n_pl;
  a.pl_cloud_n[static_cast<long long>(b) * a.n_pl + j] =
      __float2ll_rz(__ldg(w + a.off_cn + j));
}

__global__ void __launch_bounds__(kDecodeThreads)
    decode_step_kernel(DecodeArgs a) {
  if (static_cast<int>(blockIdx.x) < a.pixel_blocks) {
    const long long per_lane = a.vec ? a.hw / 4 : a.hw;
    const long long stride =
        static_cast<long long>(a.pixel_blocks) * kDecodeThreads;
    for (long long i =
             static_cast<long long>(blockIdx.x) * kDecodeThreads +
             threadIdx.x;
         i < a.pixel_items; i += stride) {
      const int b = static_cast<int>(i / per_lane);
      const long long g = i - b * per_lane;
      if (a.vec) {
        decode_quad(a, b, g);
      } else {
        decode_pixel(a, b, g);
      }
    }
    return;
  }
  const int items = a.n_pt + a.n_ln + 2 * a.n_pl;
  const long long i =
      static_cast<long long>(blockIdx.x - a.pixel_blocks) * kDecodeThreads +
      threadIdx.x;
  if (i < static_cast<long long>(items) * a.batch) {
    const int b = static_cast<int>(i / items);
    decode_window_item(a, b, static_cast<int>(i - b * items));
  }
}

int sm_count() {
  static int cache[kPslDevices];
  int* slot = psl_device_slot(cache);
  if (slot != nullptr && *slot > 0) return *slot;
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess || sms < 1) {
    sms = 132;
  }
  if (slot != nullptr) *slot = sms;
  return sms;
}

bool aligned(const void* p, size_t bytes) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// gray (uint8, or NULL), gray_stride; depth (lo plane, int32 or uint16
// values, or NULL), depth_hi (the hi plane, or NULL), depth_stride,
// depth_kind (DepthKind); hw, batch, scale; gray_out, depth_out (or NULL);
// win (or NULL), win_stride, the window's offsets and counts; the four
// window outputs
PSL_API int psl_decode_step_inputs(
    const unsigned char* gray, long long gray_stride, const void* depth,
    const unsigned char* depth_hi, long long depth_stride, int depth_kind,
    int hw, int batch, float scale, float* gray_out, float* depth_out,
    const float* win, long long win_stride, int off_pt, int n_pt, int off_ln,
    int n_ln, int off_pl, int off_cn, int n_pl, unsigned char* pt_valid,
    unsigned char* ln_valid, unsigned char* pl_valid, long long* pl_cloud_n,
    cudaStream_t stream) {
  if (batch < 1) return static_cast<int>(cudaGetLastError());
  const bool frame = gray != nullptr || depth_kind != kDepthNone;
  if (hw < 0 || depth_kind < kDepthNone || depth_kind > kDepthUInt16 ||
      (gray != nullptr) != (gray_out != nullptr) ||
      (depth_kind != kDepthNone) != (depth_out != nullptr) ||
      (depth_kind != kDepthNone && depth == nullptr) ||
      (depth_kind == kDepthBytes && depth_hi == nullptr) ||
      (win != nullptr && (n_pt < 0 || n_ln < 0 || n_pl < 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DecodeArgs a{};
  a.gray = gray;
  a.gray_stride = gray_stride;
  a.depth = depth;
  a.depth_hi = depth_hi;
  a.depth_stride = depth_stride;
  a.depth_kind = depth_kind;
  a.hw = frame ? hw : 0;
  a.batch = batch;
  a.scale = scale;
  a.gray_out = gray_out;
  a.depth_out = depth_out;
  const size_t depth_bytes = depth_kind == kDepthInt32    ? 16
                             : depth_kind == kDepthUInt16 ? 8
                                                          : 4;
  // every lane's first pixel keeps the base's alignment when hw % 4 == 0
  a.vec = a.hw % 4 == 0 && aligned(gray, 4) && aligned(depth, depth_bytes) &&
          aligned(depth_hi, 4) && aligned(gray_out, 16) &&
          aligned(depth_out, 16) && gray_stride % 4 == 0 &&
          depth_stride % 4 == 0;
  a.pixel_items = static_cast<long long>(batch) * (a.vec ? a.hw / 4 : a.hw);
  const long long wave = static_cast<long long>(sm_count()) * kBlocksPerSm;
  const long long need =
      (a.pixel_items + kDecodeThreads - 1) / kDecodeThreads;
  a.pixel_blocks = static_cast<int>(need < wave ? need : wave);
  a.win = win;
  a.win_stride = win_stride;
  a.off_pt = off_pt;
  a.n_pt = win != nullptr ? n_pt : 0;
  a.off_ln = off_ln;
  a.n_ln = win != nullptr ? n_ln : 0;
  a.off_pl = off_pl;
  a.off_cn = off_cn;
  a.n_pl = win != nullptr ? n_pl : 0;
  a.pt_valid = pt_valid;
  a.ln_valid = ln_valid;
  a.pl_valid = pl_valid;
  a.pl_cloud_n = pl_cloud_n;
  const long long win_items =
      static_cast<long long>(a.n_pt + a.n_ln + 2 * a.n_pl) * batch;
  const long long win_blocks =
      (win_items + kDecodeThreads - 1) / kDecodeThreads;
  const long long blocks = a.pixel_blocks + win_blocks;
  if (blocks > 0) {
    decode_step_kernel<<<static_cast<unsigned>(blocks), kDecodeThreads, 0,
                         stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
