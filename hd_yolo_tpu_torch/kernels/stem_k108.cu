// The yolov5 stem, silu(conv6x6/s2/p2(x) * scale + bias), as ONE K=108
// tensor-core product: space-to-depth(2) turns the 6x6/s2 conv over 3
// channels into a dense 3x3 conv over 12, and the 9 taps x 12 channels are
// the K = 108 rows of the weight matrix w_108 (tap-major, (108, 64) bf16).
//
// Replaces the TPU kernel tools/stem_lab.py `_k108_kernel` (reached through
// `pallas_k108`), which reads three row-shifted copies of the s2d tensor,
// concatenates the 9 taps along lanes and takes one K=108 MXU dot with the
// BN affine and SiLU fused.  Same function and rounding points: x rounded
// to bf16 (the s2d cast), bf16 weights, f32 accumulation over the same 7
// k16 steps in the same K order, acc * scale + bias and SiLU in f32, one
// bf16 write.
//
// Bound on an H100: memory.  At (16, 640, 640, 3) it reads the f32 image
// (78.6 MB) and writes the (16, 320, 320, 64) bf16 map (209.7 MB) while doing
// 22.6 GFLOP of bf16 products (0.023 ms at 989 TFLOP/s, against 0.086 ms of
// bytes).  Design: the image-row ring of stem_ring.cuh, shared with
// stem_tc.cu.  In the s2d order k = tap·12 + dy·6 + dx·3 + c (tap = 3ky' +
// kx') reads x row 2oy-2+2ky'+dy at columns 2ox-2+2kx'+dx, so for a fixed
// (tap, dy) its 6 K values are 6 contiguous values of one image row, and
// (6 being even) every bf16 pair of an A fragment is one 4-byte shared
// load from the ring's bf16 rows.  The kernel keeps no s2d tensor and
// builds no band: f32 rows stream in by 16-byte cp.async a ring step ahead
// and are rounded into the ring, in persistent blocks, and w_108 stays
// resident as wgmma's B (staged by the kernel from the f32 (6, 6, 3, 64)
// weight, rounded to bf16 as w_108 is: no conversion launch a call).  (The
// first version staged a bf16 s2d band per 4 output rows with element-wise
// div/mod, 4-byte reads and scattered 2-byte shared stores, the tensor
// cores idle meanwhile.)

#include "stem_ring.cuh"

namespace {

// The K pair (first k) lane t holds as its A/B fragment half h in k-step ks:
// the step's 16 K values as mma.sync's k 2t + 8h would take them, except
// that in 4 steps the pairs are dealt so that each half's 4 pairs lie in as
// few input rows as the step allows (its half-warps' reads then hit fewer
// shared-memory banks twice: 22 wavefronts a tile's A build instead of 27).
// Each step still sums the same 16 products.
__constant__ unsigned char kPerm[7][2][4] = {
    {{0, 2, 4, 12}, {6, 8, 10, 14}},      {{16, 24, 26, 28}, {18, 20, 22, 30}},
    {{32, 34, 36, 38}, {40, 42, 44, 46}}, {{48, 50, 52, 60}, {54, 56, 58, 62}},
    {{64, 66, 68, 70}, {72, 74, 76, 78}}, {{80, 82, 88, 94}, {84, 86, 90, 92}},
    {{96, 98, 100, 102}, {104, 106, 108, 110}}};

// K order s2d tap-major: k = 12·(3ky' + kx') + 6·dy + 3·dx + c reads row
// 2oy-2 + 2ky' + dy, float 6ox-6 + 6kx' + (k mod 6)
struct S2dOrder {
  static __device__ __forceinline__ int row(int k) {
    const int g = k / 6, tap = g >> 1;
    return 2 * (tap / 3) + (g & 1);
  }
  static __device__ __forceinline__ int col(int k) { return 6 * ((k / 12) % 3) + k % 6; }
  static __device__ __forceinline__ int k_of(int ks, int t, int h) { return kPerm[ks][h][t]; }
  // w_108's row k is the (6, 6, 3) weight's (ky, kx, c) = (row(k), 2kx' + dx, c)
  static __device__ __forceinline__ int wrow(int k) {
    const int kx = 2 * ((k / 12) % 3) + (k % 6) / 3;
    return (row(k) * 6 + kx) * 3 + k % 3;
  }
};

}  // namespace

// x (B, H, W, 3) f32 NHWC; w (6, 6, 3, 64) f32, staged as w_108's rows
// rounded to bf16; scale/bias (64,) f32; y (B, Hout, Wout, 64) bf16 with
// Hout/Wout those of the 6x6/s2/p2 conv.
HDY_EXPORT int stem_k108(const void* x, const void* w, const void* scale, const void* bias,
                         void* y, int B, int H, int W, int Hout, int Wout, int device,
                         void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (B < 1 || Hout < 1 || Wout < 1) return static_cast<int>(cudaErrorInvalidValue);
  return hdy::ring::launch<64, S2dOrder>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(y), B, H, W, Hout, Wout, device,
      static_cast<cudaStream_t>(stream));
}
