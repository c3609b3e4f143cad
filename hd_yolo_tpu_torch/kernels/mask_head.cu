// Inference mask head, fused: 4 x (3x3 conv 256->256 + bias + ReLU), the
// 2x2/stride-2 deconv as 4 taps + bias + ReLU, the dot with each ROI's
// selected logits column, + its bias, sigmoid, written as (N, 28, 28) f32.
//
// Replaces the TPU kernel hd_yolo_tpu/ops/pallas_mask_head.py `_kernel`
// (reached through `mask_head_pallas` / `fused_mask_probs`).  Same
// function and the same bf16 rounding points: every GEMM takes bf16
// operands with f32 accumulation, the accumulator is rounded to bf16 before
// the (bf16) bias add, ReLU stays bf16, and the selected-logit dot runs in f32
// over the bf16 deconv activations.  The deconv weight arrives already
// flipped (flax ConvTranspose applies its kernel flipped; the wrapper reads
// the reference-layout weight, where out[2i+dy, 2j+dx] = x[i,j] · W[:, :, dy, dx]).
//
// Bound on an H100: operations.  Per ROI the chain is ~1.03 GFLOP
// (4 x 196 x 2304 x 256 x 2 + 4 x 196 x 256 x 256 x 2); at N = 768 that is
// ~790 GFLOP against ~120 MB of input and output.  Design: one block (8 warps)
// per ROI keeps the ROI's 14x14x256 bf16 activations (100 KB) resident in
// shared memory across all five GEMMs, with a second 100 KB buffer for the
// next layer, so no intermediate touches device memory.  Each 3x3 conv is an
// implicit GEMM (M = 196 px padded to 16-row tiles, N = 256, K = 9 x 256)
// on bf16 tensor cores via mma.sync m16n8k16: A fragments come from shared
// memory with ldmatrix, where each lane supplies its own row address, so a
// tap's halo rows (outside the 14x14 tile) simply point at a 16-byte zero
// row; 16-byte chunks are XOR-swizzled by pixel so the 8 rows of each
// ldmatrix hit distinct banks.  B fragments are read straight from the
// (tap, co, ci) weights in global memory (L2-resident, 1.2 MB per layer),
// one k-step ahead of use.  Each warp owns 32 output channels; the 13 row
// tiles go in two passes of 7 to bound the accumulators at 112 registers.
// The deconv epilogue reduces each row's 256 channels against the ROI's
// logits column (quad shuffles, then 8 warps through shared memory, in a
// fixed order) and writes the sigmoid probabilities de-interleaved.

#include "common.cuh"

namespace {

constexpr int M = 14;
constexpr int MM = M * M;              // 196 pixels
constexpr int C = 256;
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int ROW_BYTES = C * 2;       // one pixel's channels, bf16
constexpr int BUF_BYTES = MM * ROW_BYTES;
constexpr int MT_PASS = 7;             // 16-row tiles per pass (2 passes: 224 >= 196 rows)
constexpr int NT = 4;                  // 8-col tiles per warp (32 channels)
constexpr int RED = 2 * MT_PASS * 16;  // 224 rows of partial sums per warp
constexpr int SMEM_BYTES = 2 * BUF_BYTES + 16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk `ch` (channels 8ch..8ch+7) of pixel `px`.
__device__ __forceinline__ int swz(int px, int ch) {
  return px * ROW_BYTES + ((ch ^ (px & 7)) << 4);
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// B fragments of k-step t (tap t/16, input channels 16*(t%16)..+16) for the
// warp's NT column tiles; W is (taps, co, ci) bf16, read as bf16 pairs.
template <int NTAPS>
__device__ __forceinline__ void load_b(const uint32_t* __restrict__ w, int t, int nbase, int g,
                                       int tig, uint32_t (&b)[NT][2]) {
  const int tap = t >> 4, ks = t & 15;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const size_t off =
        ((static_cast<size_t>(tap) * C + nbase + nt * 8 + g) * C + ks * 16 + tig * 2) >> 1;
    b[nt][0] = __ldg(w + off);
    b[nt][1] = __ldg(w + off + 4);
  }
}

// acc = A · W over NTAPS taps for the row tiles mt0..mt0+MT_PASS-1.  With
// NTAPS == 9 tap (ky, kx) reads the input shifted by (ky-1, kx-1) with zero
// halo; with NTAPS == 1 it reads the input unshifted.
template <int NTAPS>
__device__ __forceinline__ void gemm_pass(float (&acc)[MT_PASS][NT][4], uint32_t in_base,
                                          uint32_t zero_addr, const __nv_bfloat16* __restrict__ W,
                                          int mt0, int nbase, int lane) {
  const int r = lane & 15, khalf = lane >> 4;
  const int g = lane >> 2, tig = lane & 3;
  const uint32_t* w = reinterpret_cast<const uint32_t*>(W);
#pragma unroll
  for (int mt = 0; mt < MT_PASS; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mt][nt][j] = 0.f;

  constexpr int T = NTAPS * 16;
  uint32_t bcur[NT][2], bnxt[NT][2];
  load_b<NTAPS>(w, 0, nbase, g, tig, bcur);
  int inpx[MT_PASS];
  for (int t = 0; t < T; ++t) {
    const int tap = t >> 4, ks = t & 15;
    if (ks == 0) {
      const int ky = NTAPS == 9 ? tap / 3 : 1;
      const int kx = NTAPS == 9 ? tap % 3 : 1;
#pragma unroll
      for (int mt = 0; mt < MT_PASS; ++mt) {
        const int p = (mt0 + mt) * 16 + r;
        const int y = p / M, x = p - (p / M) * M;
        const int yy = y + ky - 1, xx = x + kx - 1;
        inpx[mt] = (p < MM && yy >= 0 && yy < M && xx >= 0 && xx < M) ? yy * M + xx : -1;
      }
    }
    if (t + 1 < T) load_b<NTAPS>(w, t + 1, nbase, g, tig, bnxt);
    const int ch = ks * 2 + khalf;
#pragma unroll
    for (int mt = 0; mt < MT_PASS; ++mt) {
      uint32_t a[4];
      ldsm_x4(inpx[mt] >= 0 ? in_base + swz(inpx[mt], ch) : zero_addr, a);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[mt][nt], a, bcur[nt][0], bcur[nt][1]);
    }
    if (t + 1 < T) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        bcur[nt][0] = bnxt[nt][0];
        bcur[nt][1] = bnxt[nt][1];
      }
    }
  }
}

// Conv epilogue: relu(bf16(bf16(acc) + bias)) into the next layer's buffer.
__device__ __forceinline__ void store_relu(const float (&acc)[MT_PASS][NT][4],
                                           unsigned char* out_buf,
                                           const __nv_bfloat16* __restrict__ bias, int mt0,
                                           int nbase, int lane) {
  const int g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int co = nbase + nt * 8 + tig * 2;
    const float b0 = __bfloat162float(bias[co]);
    const float b1 = __bfloat162float(bias[co + 1]);
#pragma unroll
    for (int mt = 0; mt < MT_PASS; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = (mt0 + mt) * 16 + g + half * 8;
        if (p < MM) {
          const float v0 = fmaxf(hdy::round_bf16(hdy::round_bf16(acc[mt][nt][half * 2]) + b0), 0.f);
          const float v1 = fmaxf(hdy::round_bf16(hdy::round_bf16(acc[mt][nt][half * 2 + 1]) + b1), 0.f);
          *reinterpret_cast<__nv_bfloat162*>(out_buf + swz(p, co >> 3) + (co & 7) * 2) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    }
  }
}

// Deconv-tap epilogue: per row, sum over the warp's 32 channels of
// relu(bf16(bf16(acc) + bd)) * wl, into red[warp][row].
__device__ __forceinline__ void select_partial(const float (&acc)[MT_PASS][NT][4], float* red,
                                               const __nv_bfloat16* __restrict__ bd,
                                               const __nv_bfloat16* __restrict__ wl, int mt0,
                                               int nbase, int warp, int lane) {
  const int g = lane >> 2, tig = lane & 3;
  float bb[NT][2], ww[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int co = nbase + nt * 8 + tig * 2;
    bb[nt][0] = __bfloat162float(bd[co]);
    bb[nt][1] = __bfloat162float(bd[co + 1]);
    ww[nt][0] = __bfloat162float(wl[co]);
    ww[nt][1] = __bfloat162float(wl[co + 1]);
  }
#pragma unroll
  for (int mt = 0; mt < MT_PASS; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float s = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float z =
              fmaxf(hdy::round_bf16(hdy::round_bf16(acc[mt][nt][half * 2 + j]) + bb[nt][j]), 0.f);
          s += z * ww[nt][j];
        }
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      if (tig == 0) red[warp * RED + (mt0 + mt) * 16 + g + half * 8] = s;
    }
  }
}

__global__ void __launch_bounds__(NTHREADS, 1)
mask_head_kernel(const __nv_bfloat16* __restrict__ pooled, const __nv_bfloat16* __restrict__ wf,
                 const __nv_bfloat16* __restrict__ bfc, const __nv_bfloat16* __restrict__ wd,
                 const __nv_bfloat16* __restrict__ bd, const __nv_bfloat16* __restrict__ wl_sel,
                 const float* __restrict__ bl_sel, float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* buf0 = smem;
  unsigned char* buf1 = smem + BUF_BYTES;
  unsigned char* zero = smem + 2 * BUF_BYTES;
  const int roi = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x < 4) reinterpret_cast<uint32_t*>(zero)[threadIdx.x] = 0u;
  const uint4* src = reinterpret_cast<const uint4*>(pooled + static_cast<size_t>(roi) * MM * C);
  for (int i = threadIdx.x; i < MM * (C / 8); i += NTHREADS) {
    *reinterpret_cast<uint4*>(buf0 + swz(i >> 5, i & 31)) = src[i];
  }
  __syncthreads();

  const int nbase = warp * 32;
  float acc[MT_PASS][NT][4];
  unsigned char* bin = buf0;
  unsigned char* bout = buf1;
  for (int layer = 0; layer < 4; ++layer) {
    for (int pass = 0; pass < 2; ++pass) {
      gemm_pass<9>(acc, smem_u32(bin), smem_u32(zero), wf + static_cast<size_t>(layer) * 9 * C * C,
                   pass * MT_PASS, nbase, lane);
      store_relu(acc, bout, bfc + layer * C, pass * MT_PASS, nbase, lane);
    }
    __syncthreads();
    unsigned char* tmp = bin;
    bin = bout;
    bout = tmp;
  }

  float* red = reinterpret_cast<float*>(bout);  // free after the last conv
  const __nv_bfloat16* wl = wl_sel + static_cast<size_t>(roi) * C;
  const float bl = bl_sel[roi];
  float* o = out + static_cast<size_t>(roi) * 4 * MM;
  for (int d = 0; d < 4; ++d) {
    for (int pass = 0; pass < 2; ++pass) {
      gemm_pass<1>(acc, smem_u32(bin), smem_u32(zero), wd + static_cast<size_t>(d) * C * C,
                   pass * MT_PASS, nbase, lane);
      select_partial(acc, red, bd, wl, pass * MT_PASS, nbase, warp, lane);
    }
    __syncthreads();
    const int dy = d >> 1, dx = d & 1;
    for (int p = threadIdx.x; p < MM; p += NTHREADS) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < NWARPS; ++w) s += red[w * RED + p];
      s += bl;
      const int y = p / M, x = p % M;
      o[(2 * y + dy) * (2 * M) + 2 * x + dx] = 1.f / (1.f + expf(-s));
    }
    __syncthreads();
  }
}

}  // namespace

// pooled (N, 14, 14, 256) bf16; wf (4, 9, 256co, 256ci) bf16; bf (4, 256)
// bf16; wd (4, 256co, 256ci) bf16 with d = dy*2+dx; bd (256,) bf16; wl_sel
// (N, 256) bf16; bl_sel (N,) f32; out (N, 28, 28) f32.
HDY_EXPORT int mask_head(const void* pooled, const void* wf, const void* bf, const void* wd,
                         const void* bd, const void* wl_sel, const void* bl_sel, void* out, int N,
                         int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (N == 0) return 0;
  e = cudaFuncSetAttribute(mask_head_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           SMEM_BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  mask_head_kernel<<<N, NTHREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(pooled), static_cast<const __nv_bfloat16*>(wf),
      static_cast<const __nv_bfloat16*>(bf), static_cast<const __nv_bfloat16*>(wd),
      static_cast<const __nv_bfloat16*>(bd), static_cast<const __nv_bfloat16*>(wl_sel),
      static_cast<const float*>(bl_sel), static_cast<float*>(out));
  return hdy::launch_status();
}
