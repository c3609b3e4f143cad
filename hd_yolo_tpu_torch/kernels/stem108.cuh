// Shared pieces of the two K=108 stem kernels (stem_k108.cu, stem_dot108.cu):
// the product of a 16-row bf16 A tile (K = 108, zero-padded to 112 = 7 steps
// of mma.sync m16n8k16) with the resident (108, 64) bf16 weights, and the
// fused epilogue silu(acc * scale + bias) -> bf16 with 16-byte stores.
//
// Fragment layouts of mma.sync.m16n8k16 (bf16, f32 accumulate), g = lane / 4,
// t = lane % 4: A regs a0..a3 hold (row g, k 2t..2t+1), (row g+8, k 2t..2t+1),
// (row g, k 2t+8..2t+9), (row g+8, k 2t+8..2t+9); B regs b0, b1 hold
// (k 2t..2t+1, col g), (k 2t+8..2t+9, col g); C regs c0..c3 hold
// (row g, cols 2t, 2t+1), (row g+8, cols 2t, 2t+1).  A bf16 pair sits in one
// 32-bit register, lower index in the low half.
#pragma once

#include "common.cuh"

namespace hdy {
namespace k108 {

constexpr int KDIM = 108;                          // 9 taps x 12 s2d channels
constexpr int KSTEPS = 7;                          // 112 / 16
constexpr int N = 64;                              // output channels
constexpr int NT = N / 8;                          // 8-col tiles
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int BFRAG_BYTES = KSTEPS * (NT / 2) * 32 * 16;  // 14336
constexpr int STAGE_BYTES = 16 * N * 2;            // one warp's 16 x 64 bf16 tile
constexpr int EPI_BYTES = 2 * N * 4;               // scale, bias
constexpr int FIXED_SMEM = BFRAG_BYTES + NWARPS * STAGE_BYTES + EPI_BYTES;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Block-wide: the weights w (KDIM, N) bf16, row-major, as B fragments in
// shared memory, laid out [k-step][n-tile pair][lane][4 words] so that a lane
// reads the 8 n-tiles of a k-step as 4 conflict-free 16-byte loads; rows
// 108..111 are zero.  Also scale and bias into shared memory.
__device__ __forceinline__ void load_weights(const __nv_bfloat16* __restrict__ w,
                                             const float* __restrict__ scale,
                                             const float* __restrict__ bias, uint32_t* bfrag,
                                             float* sc, float* bi) {
  const unsigned short* wu = reinterpret_cast<const unsigned short*>(w);
  for (int i = threadIdx.x; i < KSTEPS * NT * 32; i += blockDim.x) {
    const int lane = i & 31, nt = (i >> 5) % NT, ks = (i >> 5) / NT;
    const int n = nt * 8 + (lane >> 2), t = lane & 3;
    uint32_t r[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = ks * 16 + 2 * t + 8 * h;
      const uint32_t lo = k < KDIM ? wu[k * N + n] : 0u;
      const uint32_t hi = k + 1 < KDIM ? wu[(k + 1) * N + n] : 0u;
      r[h] = lo | (hi << 16);
    }
    uint32_t* dst = bfrag + ((ks * (NT / 2) + nt / 2) * 32 + lane) * 4 + (nt & 1) * 2;
    dst[0] = r[0];
    dst[1] = r[1];
  }
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    sc[i] = scale[i];
    bi[i] = bias[i];
  }
}

// acc = A · W for one warp's 16-row tile, A given as its 7 k-steps of fragments.
__device__ __forceinline__ void tile_product(float (&acc)[NT][4], const uint32_t (&a)[KSTEPS][4],
                                             const uint32_t* bfrag, int lane) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[nt][j] = 0.f;
  const uint4* bq = reinterpret_cast<const uint4*>(bfrag) + lane;
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks) {
#pragma unroll
    for (int p = 0; p < NT / 2; ++p) {
      const uint4 q = bq[(ks * (NT / 2) + p) * 32];
      mma_bf16(acc[2 * p], a[ks], q.x, q.y);
      mma_bf16(acc[2 * p + 1], a[ks], q.z, q.w);
    }
  }
}

// Epilogue of one warp's tile: y = silu(acc * scale + bias) in f32, rounded
// to bf16, through the warp's stage buffer (16-byte chunks XOR-swizzled by
// row, so both the fragment writes and the row reads are conflict-free),
// then written as the first `nrows` rows of 128 contiguous bytes at dst.
__device__ __forceinline__ void store_tile(const float (&acc)[NT][4], const float* sc,
                                           const float* bi, uint32_t* stage, int lane,
                                           __nv_bfloat16* __restrict__ dst, int nrows) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = nt * 8 + 2 * t;
    const float s0 = sc[col], s1 = sc[col + 1], b0 = bi[col], b1 = bi[col + 1];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = g + 8 * h;
      const float v0 = acc[nt][2 * h] * s0 + b0;
      const float v1 = acc[nt][2 * h + 1] * s1 + b1;
      const __nv_bfloat162 pk =
          __floats2bfloat162_rn(v0 / (1.f + expf(-v0)), v1 / (1.f + expf(-v1)));
      stage[row * 32 + ((nt ^ (row & 7)) << 2) + t] = *reinterpret_cast<const uint32_t*>(&pk);
    }
  }
  __syncwarp();
  const uint4* st4 = reinterpret_cast<const uint4*>(stage);
  uint4* d4 = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = lane + 32 * i, row = q >> 3, c = q & 7;
    if (row < nrows) d4[q] = st4[row * 8 + (c ^ (row & 7))];
  }
  __syncwarp();
}

}  // namespace k108
}  // namespace hdy
