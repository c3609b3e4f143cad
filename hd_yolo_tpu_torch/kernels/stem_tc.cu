// The yolov5 stem at bf16 compute, silu(conv6x6/s2/p2(x) * scale + bias)
// over an f32 NHWC image with 3 channels, N = 16, 32, 48 or 64 output
// channels, as one K=108 tensor-core product per pixel.
//
// Replaces the TPU kernel hd_yolo_tpu/ops/pallas_stem.py `_stem_kernel`
// (reached through `stem_conv_pallas`) on the trunk's bf16 path; stem_tf32.cu
// takes f32 compute and the direct kernel (stem.cu) the other shapes of the
// family.
// Same function and rounding points: x and w rounded to bf16, f32
// accumulation, the affine and SiLU in f32, one bf16 write.
//
// Bound on an H100: memory.  At (16, 640, 640, 3) -> (16, 320, 320, 64) it
// reads the f32 image (78.6 MB) and writes the bf16 map (209.7 MB) for
// 22.6 GFLOP of bf16 products (0.023 ms at 989 TFLOP/s, against 0.086 ms of
// bytes).  Design: the ring of stem_ring.cuh (image rows rounded to bf16,
// two output rows a step, one a warpgroup, products on wgmma m64nNk16)
// with K in (ky, kx, c) order, the weight's own (6, 6, 3, N) order, so for
// a fixed input row ky one output pixel's 18 K values are 18 contiguous
// values of that row (columns 2ox-2 .. 2ox+3); the f32 weights are rounded
// to bf16 as they are staged.

#include "stem_ring.cuh"

namespace {

// K order (ky, kx, c): k = 18·ky + 3·kx + c reads row 2oy-2+ky, float 6ox-6 + k mod 18
struct TcOrder {
  static __device__ __forceinline__ int row(int k) { return k / 18; }
  static __device__ __forceinline__ int col(int k) { return k % 18; }
  static __device__ __forceinline__ int k_of(int ks, int t, int h) {
    return ks * 16 + 2 * t + 8 * h;
  }
  static __device__ __forceinline__ int wrow(int k) { return k; }
};

using hdy::ring::launch;
using hdy::ring::smem_bytes;

}  // namespace

// x (B, H, W, 3) f32 NHWC; w (6, 6, 3, N) f32, i.e. (108, N) with rows in
// (ky, kx, c) order, rounded to bf16 as the kernel stages it; scale/bias
// (N,) f32; y (B, Hout, Wout, N) bf16 with Hout/Wout those of the 6x6/s2/p2
// conv; N in {16, 32, 48, 64}.
HDY_EXPORT int stem_tc(const void* x, const void* w, const void* scale, const void* bias, void* y,
                       int B, int H, int W, int Hout, int Wout, int N, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (B < 1 || Hout < 1 || Wout < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto* xf = static_cast<const float*>(x);
  const auto* wb = static_cast<const float*>(w);
  const auto* s = static_cast<const float*>(scale);
  const auto* bb = static_cast<const float*>(bias);
  auto* yb = static_cast<__nv_bfloat16*>(y);
  auto st = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 16: return launch<16, TcOrder>(xf, wb, s, bb, yb, B, H, W, Hout, Wout, device, st);
    case 32: return launch<32, TcOrder>(xf, wb, s, bb, yb, B, H, W, Hout, Wout, device, st);
    case 48: return launch<48, TcOrder>(xf, wb, s, bb, yb, B, H, W, Hout, Wout, device, st);
    case 64: return launch<64, TcOrder>(xf, wb, s, bb, yb, B, H, W, Hout, Wout, device, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The kernel's dynamic shared memory per block, bytes, for image width W
// (output width Wout) and N output channels; 0 for an N it does not take.
HDY_EXPORT int stem_tc_smem_bytes(int W, int Wout, int N) {
  switch (N) {
    case 16: return static_cast<int>(smem_bytes<16>(W, Wout));
    case 32: return static_cast<int>(smem_bytes<32>(W, Wout));
    case 48: return static_cast<int>(smem_bytes<48>(W, Wout));
    case 64: return static_cast<int>(smem_bytes<64>(W, Wout));
    default: return 0;
  }
}
