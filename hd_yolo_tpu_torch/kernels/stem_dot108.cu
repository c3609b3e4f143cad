// The K=108 stem product over a ready im2col: y = silu(cols · w_108 * scale
// + bias), cols (M, 108) bf16 (the 9 s2d taps x 12 channels of each output
// pixel, tap-major), w_108 (108, 64) bf16, y (M, 64) bf16.
//
// Replaces the TPU kernel tools/stem_lab.py `_dot108_kernel` (reached
// through `pallas_dot108`), whose im2col XLA builds before the call; here
// the wrapper builds it with torch ops.  Same rounding points: bf16
// operands, f32 accumulation, acc * scale + bias and SiLU in f32, one bf16
// write.
//
// Bound on an H100: memory.  At B = 16, M = 1,638,400 rows: 353.9 MB of
// im2col read and 209.7 MB written (0.168 ms at 3.35 TB/s) against 22.6
// GFLOP (0.023 ms).  Design: a GEMM with N = 64 on mma.sync m16n8k16, K
// zero-padded to 112 in the fragments.  Blocks are persistent (two per SM):
// each loads the w_108 fragments (14 KB) into shared memory once and walks
// 128-row tiles, double-buffered with cp.async.  A 108-wide bf16 row is 216
// bytes, only 8-byte aligned, but a tile of 128 rows is 27,648 contiguous
// bytes starting on a 16-byte boundary (128 x 216 = 1728 x 16), so each tile
// is copied as one flat run of 16-byte cp.async (a ragged last tile of an
// odd row count ends with one 8-byte copy); no padded copy of the im2col is
// made.  A fragments are read from the flat tile as 32-bit bf16 pairs (row
// stride 54 words).  Each warp owns 16 rows of a tile; the epilogue is the
// shared one (scale, bias, SiLU, 16-byte stores of 2 KB contiguous rows).

#include "stem108.cuh"

namespace {

using namespace hdy::k108;

constexpr int TILE = NWARPS * 16;             // 128 rows per tile
constexpr int ROW_WORDS = KDIM / 2;           // 54
constexpr int TILE_BYTES = TILE * KDIM * 2;   // 27648
constexpr int SMEM = FIXED_SMEM + 2 * TILE_BYTES;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(smem_u32(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait1() { asm volatile("cp.async.wait_group 1;\n" ::); }

// Start copying tile `tile` (its valid rows) into dst.
__device__ __forceinline__ void start_tile_copy(const unsigned char* __restrict__ cols, long long M,
                                           long long tile, unsigned char* dst) {
  const long long r0 = tile * TILE;
  const int rows = M - r0 < TILE ? static_cast<int>(M - r0) : TILE;
  const int bytes = rows * KDIM * 2;
  const unsigned char* src = cols + r0 * (KDIM * 2);
  const int n16 = bytes >> 4;
  for (int i = threadIdx.x; i < n16; i += NTHREADS) cp_async16(dst + 16 * i, src + 16 * i);
  if ((bytes & 15) && threadIdx.x == 0) cp_async8(dst + 16 * n16, src + 16 * n16);
}

__global__ void __launch_bounds__(NTHREADS, 2)
dot108_kernel(const __nv_bfloat16* __restrict__ cols, const __nv_bfloat16* __restrict__ w,
              const float* __restrict__ scale, const float* __restrict__ bias,
              __nv_bfloat16* __restrict__ y, long long M) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* bfrag = reinterpret_cast<uint32_t*>(smem);
  uint32_t* stage = reinterpret_cast<uint32_t*>(smem + BFRAG_BYTES);
  float* sc = reinterpret_cast<float*>(smem + BFRAG_BYTES + NWARPS * STAGE_BYTES);
  float* bi = sc + N;
  unsigned char* bufs = smem + FIXED_SMEM;

  const unsigned char* src = reinterpret_cast<const unsigned char*>(cols);
  const long long ntiles = (M + TILE - 1) / TILE;
  long long tile = blockIdx.x;
  if (tile < ntiles) start_tile_copy(src, M, tile, bufs);
  cp_async_commit();
  load_weights(w, scale, bias, bfrag, sc, bi);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  int cur = 0;
  for (; tile < ntiles; tile += gridDim.x) {
    const long long next = tile + gridDim.x;
    if (next < ntiles) start_tile_copy(src, M, next, bufs + (cur ^ 1) * TILE_BYTES);
    cp_async_commit();
    cp_async_wait1();  // this tile's copy has landed (the next one may be in flight)
    __syncthreads();

    const long long r0 = tile * TILE + warp * 16;
    const int nrows = M - r0 < 16 ? static_cast<int>(M - r0) : 16;
    if (nrows > 0) {
      const uint32_t* aw = reinterpret_cast<const uint32_t*>(bufs + cur * TILE_BYTES) +
                           warp * 16 * ROW_WORDS;
      uint32_t a[KSTEPS][4];
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        const int k0 = ks * 16 + 2 * t, k1 = k0 + 8;  // k1 >= 108 is the zero padding
        a[ks][0] = aw[g * ROW_WORDS + (k0 >> 1)];
        a[ks][1] = aw[(g + 8) * ROW_WORDS + (k0 >> 1)];
        a[ks][2] = k1 < KDIM ? aw[g * ROW_WORDS + (k1 >> 1)] : 0u;
        a[ks][3] = k1 < KDIM ? aw[(g + 8) * ROW_WORDS + (k1 >> 1)] : 0u;
      }
      float acc[NT][4];
      tile_product(acc, a, bfrag, lane);
      store_tile(acc, sc, bi, stage + warp * (STAGE_BYTES / 4), lane, y + r0 * N, nrows);
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
    cur ^= 1;
  }
  asm volatile("cp.async.wait_all;\n" ::);
}

}  // namespace

// cols (M, 108) bf16, 16-byte aligned; w108 (108, 64) bf16; scale/bias (64,)
// f32; y (M, 64) bf16.
HDY_EXPORT int stem_dot108(const void* cols, const void* w108, const void* scale,
                           const void* bias, void* y, long long M, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (M < 1 || (reinterpret_cast<uintptr_t>(cols) & 15)) return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(dot108_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long ntiles = (M + TILE - 1) / TILE;
  const int grid = static_cast<int>(ntiles < 2LL * sms ? ntiles : 2LL * sms);
  dot108_kernel<<<grid, NTHREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(cols), static_cast<const __nv_bfloat16*>(w108),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(y), M);
  return hdy::launch_status();
}
