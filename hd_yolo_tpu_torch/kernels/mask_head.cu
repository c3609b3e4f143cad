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
// ~790 GFLOP against ~120 MB of input and output.
//
// Design (Hopper): persistent blocks, one per SM, walk the ROIs below the
// `active` count (read from device memory; slots at or past it are written
// as 0).  A block keeps one ROI's 14x14x256 bf16 activations resident in
// shared memory across all five GEMMs (2 x 100,352 B ping-pong, 16-byte
// chunks XOR-swizzled by pixel, a 16-byte zero row for the halo).
//   * Products on `wgmma` m64n128k16, A from registers, B from shared memory.
//     Two consumer warpgroups own the 4 m64 row tiles (2 each: 196 pixels
//     padded to 256 rows, 1.31x the real rows, which wgmma's rate pays
//     for).  A layer runs in two passes over output channels (128 each), so
//     each warpgroup's accumulators are 2 x 64 f32 registers a thread and
//     the weights stream ONCE per layer per block.  A fragments come from
//     `ldmatrix.x4` with per-lane row addresses, so a tap's halo rows point
//     at the zero row.
//   * B streams through a ring of STAGES = 7 k-slices (16 ci x 128 co bf16
//     = 4 KB) in shared memory, two slices (k32) to a wgmma group.  The
//     wrapper pre-packs the weights as one 5.2 MB stream of slices in
//     consumption order, each already in wgmma's no-swizzle K-major
//     core-matrix layout, so one producer thread issues ONE `cp.async.bulk`
//     per slice, completing on the slice's full mbarrier; the 8 consumer
//     warps release it on its empty mbarrier once the wgmma that read it
//     has retired.  L2 reads per ROI: 5.2 MB (10.5 MB before).  The
//     producer warpgroup gives its registers to the consumers (setmaxnreg
//     40 / 232): 128 accumulators a thread need the room, or ptxas spills
//     and serializes the wgmma.
//   * Epilogues in bf16x2 (cvt.rn, add.rn, max): the same rounding points
//     as f32 round trips at a third of the instructions.
//   * The deconv epilogue reduces each row's 128 channels of a pass against
//     the ROI's logits column (thread, then quad shuffles), one partial per
//     (pass, row) in the buffer the last conv left free, summed in a fixed
//     order with the bias: no atomics, two launches give bit-identical
//     output.

#include "common.cuh"

namespace {

constexpr int M = 14;
constexpr int MM = M * M;                 // 196 pixels
constexpr int C = 256;
constexpr int NCONS = 8;                  // consumer warps (2 warpgroups)
constexpr int NTHREADS = NCONS * 32 + 128; // + 1 producer warpgroup (one thread issues)
constexpr int ROW_BYTES = C * 2;          // one pixel's channels, bf16
constexpr int BUF_BYTES = MM * ROW_BYTES; // 100,352
constexpr int NH = 128;                   // output channels per pass
constexpr int NJ = NH / 8;                // 8-col groups of the accumulator
constexpr int SLICE = 16 * NH * 2;        // one k-slice of B, 4096 B
constexpr int STAGES = 7;
constexpr int CONV_SLICES = 4 * 2 * 9 * 16;            // (layer, pass, tap, ks)
constexpr int NSLICES = CONV_SLICES + 4 * 2 * 16;      // + (d, pass, ks) = 1280
constexpr int OFF_ZERO = 2 * BUF_BYTES;
constexpr int OFF_RING = OFF_ZERO + 128;
constexpr int OFF_BAR = OFF_RING + STAGES * SLICE;
constexpr int SMEM_BYTES = OFF_BAR + 2 * STAGES * 8;   // 229,616

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

// ---- mbarriers and the bulk copy
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(NCONS * 32) : "memory");
}

// ---- wgmma
// B descriptor of one k-slice: no swizzle, K-major; core matrices of 8 rows
// (co) x 16 bytes (8 ci) stored as 128 contiguous bytes, the two k-halves of
// an 8-co group 128 B apart (LBO), consecutive 8-co groups 256 B apart (SBO).
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>(256 >> 4) << 32);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving or reusing registers an in-flight wgmma owns.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_a(uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// d (+)= A · B, m64n128k16, A (this warp's 16 rows) in registers, B in shared memory.
__device__ __forceinline__ void wgmma_128(float (&d)[64], const uint32_t (&a)[4], uint64_t desc,
                                          int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

// Two k-slices of a warpgroup's product, one wgmma group: load their A
// fragments into register buffer BUF (the group two back, which used it, has
// retired), wait for both B slices, issue the four wgmma, then wait until
// the previous group has retired and release its two slices to the producer.
template <int BUF>
__device__ __forceinline__ void kstep(float (&acc0)[64], float (&acc1)[64],
                                      uint32_t (&a)[2][2][2][4], const int (&inpx)[2], int ks,
                                      int khalf, uint32_t in_base, uint32_t zero_addr,
                                      uint32_t ring, uint32_t full, uint32_t empty, uint32_t& c,
                                      uint32_t c0, int lane) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int m = 0; m < 2; ++m)
      ldsm_x4(inpx[m] >= 0 ? in_base + swz(inpx[m], (ks + kk) * 2 + khalf) : zero_addr,
              a[BUF][kk][m]);
  mbar_wait(full + (c % STAGES) * 8, (c / STAGES) & 1);
  mbar_wait(full + ((c + 1) % STAGES) * 8, ((c + 1) / STAGES) & 1);
  fence_acc(acc0);
  fence_acc(acc1);
  wg_fence();
  const int accumulate = c != c0;
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    const uint64_t desc = b_desc(ring + ((c + kk) % STAGES) * SLICE);
    wgmma_128(acc0, a[BUF][kk][0], desc, accumulate | kk);
    wgmma_128(acc1, a[BUF][kk][1], desc, accumulate | kk);
  }
  wg_commit();
  wg_wait<1>();
  fence_acc(acc0);
  fence_acc(acc1);
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    fence_a(a[BUF ^ 1][kk][0]);
    fence_a(a[BUF ^ 1][kk][1]);
  }
  if (c != c0 && lane == 0) {
    mbar_arrive(empty + ((c - 2) % STAGES) * 8);
    mbar_arrive(empty + ((c - 1) % STAGES) * 8);
  }
  c += 2;
}

// One output-channel pass of a warpgroup's GEMM: acc0 / acc1 (its m64 tiles
// mt0 and mt0 + 1) = A · B over NTAPS x 16 k-slices taken from the ring at
// slice counter c.  NTAPS == 9: tap (ky, kx) reads the input shifted by
// (ky-1, kx-1) with zero halo; NTAPS == 1: the input unshifted.
template <int NTAPS>
__device__ __forceinline__ void gemm_pass(float (&acc0)[64], float (&acc1)[64], uint32_t in_base,
                                          uint32_t zero_addr, uint32_t ring, uint32_t full,
                                          uint32_t empty, uint32_t& c, int mt0, int wl, int lane) {
  const int r = lane & 15, khalf = lane >> 4;
  uint32_t a[2][2][2][4];  // [register buffer][k-slice][m-tile][fragment]
  int inpx[2];
  const uint32_t c0 = c;
  for (int tap = 0; tap < NTAPS; ++tap) {
    const int ky = NTAPS == 9 ? tap / 3 : 1;
    const int kx = NTAPS == 9 ? tap % 3 : 1;
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int p = (mt0 + m) * 64 + wl * 16 + r;
      const int y = p / M, x = p - (p / M) * M;
      const int yy = y + ky - 1, xx = x + kx - 1;
      inpx[m] = (p < MM && yy >= 0 && yy < M && xx >= 0 && xx < M) ? yy * M + xx : -1;
    }
#pragma unroll 1
    for (int ks = 0; ks < 16; ks += 4) {
      kstep<0>(acc0, acc1, a, inpx, ks, khalf, in_base, zero_addr, ring, full, empty, c, c0, lane);
      kstep<1>(acc0, acc1, a, inpx, ks + 2, khalf, in_base, zero_addr, ring, full, empty, c, c0,
               lane);
    }
  }
  wg_wait<0>();
  fence_acc(acc0);
  fence_acc(acc1);
  if (lane == 0) {
    mbar_arrive(empty + ((c - 2) % STAGES) * 8);
    mbar_arrive(empty + ((c - 1) % STAGES) * 8);
  }
}

// relu(bf16(bf16(acc) + bias)) of an accumulator pair, in bf16x2: the pair
// rounded once, the bias add rounded once (add.rn.bf16x2), ReLU exact.
__device__ __forceinline__ __nv_bfloat162 bias_relu(float v0, float v1, __nv_bfloat162 b) {
  return __hmax2(__hadd2(__floats2bfloat162_rn(v0, v1), b), __float2bfloat162_rn(0.f));
}

// Conv epilogue of one m64 tile: relu(bf16(bf16(acc) + bias)) into the next
// layer's buffer, output channels nbase .. nbase + 127.
__device__ __forceinline__ void store_relu(const float (&acc)[64], unsigned char* out_buf,
                                           const __nv_bfloat16* __restrict__ bias, int mt,
                                           int nbase, int wl, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int p0 = mt * 64 + wl * 16 + g;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int co = nbase + j * 8 + t * 2;
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(bias + co);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = p0 + h * 8;
      if (p < MM)
        *reinterpret_cast<__nv_bfloat162*>(out_buf + swz(p, co >> 3) + (co & 7) * 2) =
            bias_relu(acc[j * 4 + h * 2], acc[j * 4 + h * 2 + 1], b);
    }
  }
}

// Deconv-tap epilogue of one m64 tile: per row, the sum over channels
// nbase .. nbase + 127 of relu(bf16(bf16(acc) + bd)) * wl in f32, in a fixed
// order (the thread's 32 values, then the quad), into red[row].
__device__ __forceinline__ void select_partial(const float (&acc)[64], float* red,
                                               const __nv_bfloat16* __restrict__ bd,
                                               const __nv_bfloat16* __restrict__ wl, int mt,
                                               int nbase, int wlane, int lane) {
  const int g = lane >> 2, t = lane & 3;
  float s[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int co = nbase + j * 8 + t * 2;
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(bd + co);
    const float2 w = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(wl + co));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 z = __bfloat1622float2(bias_relu(acc[j * 4 + h * 2], acc[j * 4 + h * 2 + 1], b));
      s[h] += z.x * w.x;
      s[h] += z.y * w.y;
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    s[h] += __shfl_xor_sync(0xffffffffu, s[h], 1);
    s[h] += __shfl_xor_sync(0xffffffffu, s[h], 2);
    if (t == 0) red[mt * 64 + wlane * 16 + g + h * 8] = s[h];
  }
}

__global__ void __launch_bounds__(NTHREADS, 1)
mask_head_kernel(const __nv_bfloat16* __restrict__ pooled, const unsigned char* __restrict__ wstream,
                 const __nv_bfloat16* __restrict__ bfc, const __nv_bfloat16* __restrict__ bd,
                 const __nv_bfloat16* __restrict__ wlog, const float* __restrict__ blog,
                 const long long* __restrict__ labels, float* __restrict__ out, int N,
                 const long long* __restrict__ active) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* buf0 = smem;
  unsigned char* buf1 = smem + BUF_BYTES;
  const uint32_t zero = smem_u32(smem + OFF_ZERO);
  const uint32_t ring = smem_u32(smem + OFF_RING);
  const uint32_t full = smem_u32(smem + OFF_BAR);
  const uint32_t empty = full + STAGES * 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int act = active == nullptr ? N : static_cast<int>(max(0LL, min(*active, 1LL * N)));

  // slots at or past the active count are exactly 0
  float4* oz = reinterpret_cast<float4*>(out + static_cast<size_t>(act) * 4 * MM);
  const int nz = (N - act) * MM;  // float4s: 4 * MM floats per slot
  for (int i = blockIdx.x * NTHREADS + threadIdx.x; i < nz; i += gridDim.x * NTHREADS)
    oz[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (threadIdx.x < 4) reinterpret_cast<uint32_t*>(smem + OFF_ZERO)[threadIdx.x] = 0u;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s * 8, 1);
      mbar_init(empty + s * 8, NCONS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // one if/else for the whole kernel: the roles never reconverge, so the
  // register split (setmaxnreg) holds
  if (warp >= NCONS) {  // producer: the weight stream, once per ROI
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == NCONS * 32) {
      uint32_t c = 0;
      for (int roi = blockIdx.x; roi < act; roi += gridDim.x) {
        for (int s = 0; s < NSLICES; ++s, ++c) {
          const uint32_t stage = c % STAGES;
          mbar_wait(empty + stage * 8, ((c / STAGES) & 1) ^ 1);
          mbar_expect_tx(full + stage * 8, SLICE);
          bulk_load(ring + stage * SLICE, wstream + static_cast<size_t>(s) * SLICE, SLICE,
                    full + stage * 8);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = warp >> 2, wl = warp & 3;
    const int mt0 = wg * 2;  // this warpgroup's m64 tiles: mt0, mt0 + 1
    uint32_t c = 0;
    float acc0[64], acc1[64];
    for (int roi = blockIdx.x; roi < act; roi += gridDim.x) {
      // the ROI's activations: every 16-byte copy in flight at once
      const uint4* src = reinterpret_cast<const uint4*>(pooled + static_cast<size_t>(roi) * MM * C);
      for (int i = threadIdx.x; i < MM * (C / 8); i += NCONS * 32)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                         smem_u32(buf0 + swz(i >> 5, i & 31))),
                     "l"(src + i)
                     : "memory");
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      consumers_sync();

      unsigned char* bin = buf0;
      unsigned char* bout = buf1;
      for (int layer = 0; layer < 4; ++layer) {
        for (int pass = 0; pass < 2; ++pass) {
          gemm_pass<9>(acc0, acc1, smem_u32(bin), zero, ring, full, empty, c, mt0, wl, lane);
          store_relu(acc0, bout, bfc + layer * C, mt0, pass * NH, wl, lane);
          store_relu(acc1, bout, bfc + layer * C, mt0 + 1, pass * NH, wl, lane);
        }
        consumers_sync();
        unsigned char* tmp = bin;
        bin = bout;
        bout = tmp;
      }

      const long long label = labels[roi];  // the ROI's mask channel
      const __nv_bfloat16* wl_roi = wlog + label * C;
      const float bl = blog[label];
      float* o = out + static_cast<size_t>(roi) * 4 * MM;
      for (int d = 0; d < 4; ++d) {
        // per (pass, row) partials in the buffer the last conv left free,
        // double-buffered by tap: one barrier per tap
        float* rd = reinterpret_cast<float*>(bout) + (d & 1) * 512;
        for (int pass = 0; pass < 2; ++pass) {
          gemm_pass<1>(acc0, acc1, smem_u32(bin), zero, ring, full, empty, c, mt0, wl, lane);
          select_partial(acc0, rd + pass * 256, bd, wl_roi, mt0, pass * NH, wl, lane);
          select_partial(acc1, rd + pass * 256, bd, wl_roi, mt0 + 1, pass * NH, wl, lane);
        }
        consumers_sync();
        const int dy = d >> 1, dx = d & 1;
        for (int p = threadIdx.x; p < MM; p += NCONS * 32) {
          const float s = rd[p] + rd[256 + p] + bl;
          const int y = p / M, x = p % M;
          o[(2 * y + dy) * (2 * M) + 2 * x + dx] = 1.f / (1.f + expf(-s));
        }
      }
    }
  }
}

}  // namespace

// pooled (N, 14, 14, 256) bf16; wstream: the packed weight stream (1280
// slices of 4096 B, `ops/pallas_mask_head.mask_head_stream`); bf (4, 256)
// bf16; bd (256,) bf16; wl (nc, 256) bf16 and bl (nc,) f32, the logits
// conv; labels (N,) int64 in [0, nc), each ROI's logits column; out (N, 28,
// 28) f32; active: a device int64 holding how many leading slots to compute
// (the rest are written as 0), or null for all N.
HDY_EXPORT int mask_head(const void* pooled, const void* wstream, const void* bf, const void* bd,
                         const void* wl, const void* bl, const void* labels, void* out,
                         const void* active, int N, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (N == 0) return 0;
  // asked of the CUDA runtime once per device and process
  static int sms_of[64] = {0};
  if (device < 0 || device >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (sms_of[device] == 0) {
    e = cudaFuncSetAttribute(mask_head_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    e = cudaDeviceGetAttribute(&sms_of[device], cudaDevAttrMultiProcessorCount, device);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int sms = sms_of[device];
  mask_head_kernel<<<min(N, sms), NTHREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(pooled), static_cast<const unsigned char*>(wstream),
      static_cast<const __nv_bfloat16*>(bf), static_cast<const __nv_bfloat16*>(bd),
      static_cast<const __nv_bfloat16*>(wl), static_cast<const float*>(bl),
      static_cast<const long long*>(labels), static_cast<float*>(out), N,
      static_cast<const long long*>(active));
  return hdy::launch_status();
}

// The kernel's dynamic shared memory per block, bytes.
HDY_EXPORT int mask_head_smem_bytes() { return SMEM_BYTES; }
