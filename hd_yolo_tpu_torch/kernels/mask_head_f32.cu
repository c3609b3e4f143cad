// Inference mask head in f32: the f32 form of mask_head.cu.  The same chain
// (4 x (3x3 conv 256->256 + bias + ReLU), the 2x2/stride-2 deconv as 4 taps
// + bias + ReLU, the dot with each ROI's selected logits column, + its bias,
// sigmoid, written as (N, 28, 28) f32), every operand, accumulator and
// epilogue in f32, as an f32 model computes it.
//
// Replaces the TPU kernel hd_yolo_tpu/ops/pallas_mask_head.py `_kernel` for
// f32 features: that kernel computes in the pooled dtype, and mask_head.cu
// takes bf16 only.
//
// Bound on an H100: operations.  Per ROI the chain is ~1.03 GFLOP
// (4 x 196 x 2304 x 256 x 2 + 4 x 196 x 256 x 256 x 2) against 0.2 MB of
// input and 3 KB of output.  The CUDA cores' f32 peak (67 TFLOP/s) caps a
// SIMT kernel near cuDNN's f32 chain, so the products go to the tensor
// cores in split TF32 ("3xTF32"): each f32 operand a is split into
// hi = tf32(a) and lo = tf32(a - hi), and each product is formed as
// lo·hi + hi·lo + hi·hi, in that order, for f32-level products at up to
// 495 / 3 = 165 TFLOP/s.  The hardware
// truncates the low 13 bits of a tf32 operand, so hi is rounded (cvt.rna)
// and masked here, and lo is the exact remainder of that hi.  There is no
// single-pass TF32 path: it keeps ~3 decimal digits, a different function.
//
// Design (Hopper): five launches of one persistent kernel (four convs, the
// deconv), on the caller's stream, one block an SM.
//   * Flat pixel rows.  Each layer is one product over the N·196 pixel rows
//     of the active ROIs, cut into tiles of 128 rows; a tile may span two
//     ROIs and only the last one is padded.  A block walks the tiles and
//     owns each for all its output columns, so A is read once a layer.  It
//     stages the tile's rows and their 3x3 halo (15 rows each side) in
//     shared memory (158 rows x 1 KB, 16-byte chunks XOR-swizzled by row);
//     each lane knows its row's ROI and (h, w), and a tap's neighbour
//     outside the 14 x 14 window reads a 16-byte zero chunk instead.
//   * Products on `wgmma` m64n128k8 tf32, A from registers (`ldmatrix` of
//     the f32 rows as b16 pairs gives the tf32 fragment; split in
//     registers), B from shared memory.  Two consumer warpgroups own the
//     tile's two m64 row blocks; a layer runs in two passes of 128 output
//     columns.  Convs run K = 9 taps x 256 channels; the deconv is one
//     product with K = 256 and its 4 taps side by side as 1024 columns, a
//     tap's 256 columns at a time.
//   * The tensor cores' f32 accumulate does not round to nearest: over a
//     conv's 864 accumulates into one accumulator the error grows with K,
//     to ~5e-5 of a layer's values.  So every PROMOTE = 16 k-steps the
//     tensor-core partial (a fresh accumulator each time) is added to an
//     f32 accumulator in registers with round-to-nearest, 64 + 64 a thread
//     a 128-column pass (256 columns would need 256, past a consumer's 232).
//   * B streams through a ring of STAGES = 8 k8-slices (128 co x 8 ci, hi
//     then lo: 8 KB) fed by one producer thread with `cp.async.bulk` on
//     full/empty mbarriers.  The wrapper packs the weights once per weight
//     state as one stream of slices in consumption order, (co, ci) K-major
//     in wgmma's no-swizzle core-matrix layout, hi and lo already split.
//   * Epilogues in f32.  Convs: bias and ReLU, the activations to the
//     caller's workspace (two (N, 196, 256) f32 buffers).  The deconv:
//     bias, ReLU, the dot with the row's ROI's logits column (the thread's
//     64 columns over both passes, then the quad, in a fixed order: no
//     atomics, two launches give bit-identical output), the bias and the
//     sigmoid.  ROIs at or past `active` (read from device memory) are not
//     computed and are written as 0.

#include "common.cuh"

namespace {

constexpr int M = 14;
constexpr int MM = M * M;                   // 196 pixels
constexpr int C = 256;
constexpr int OUT = 2 * M;                  // 28
constexpr int NCONS = 8;                    // consumer warps (2 warpgroups)
constexpr int NTHREADS = NCONS * 32 + 128;  // + 1 producer warpgroup (one thread issues)
constexpr int BM = 128;                     // rows per tile: 2 x m64
constexpr int HALO = M + 1;                 // a 3x3 tap reaches 15 flat rows either way
constexpr int WIN = BM + 2 * HALO;          // 158 staged rows
constexpr int ROW_BYTES = C * 4;            // one pixel's channels, f32
constexpr int NH = 128;                     // output columns per pass
constexpr int NACC = NH / 2;                // accumulator registers a thread
constexpr int KSTEPS = C / 8;               // k8 steps per tap
constexpr int PROMOTE = 16;                 // k-steps per promotion into the f32 accumulator
constexpr int HALF = NH * 8 * 4;            // one k8 slice of 128 co, hi or lo: 4096 B
constexpr int SLICE = 2 * HALF;             // hi then lo: 8192 B
constexpr int STAGES = 8;
constexpr int CONV_SLICES = 2 * 9 * KSTEPS;            // (pass, tap, ks) of a conv: 576
constexpr int DECONV_SLICES = 4 * 2 * KSTEPS;          // (d, pass, ks) of the deconv: 256
constexpr int OFF_ZERO = WIN * ROW_BYTES;   // 161,792
constexpr int OFF_RING = OFF_ZERO + 128;
constexpr int OFF_BAR = OFF_RING + STAGES * SLICE;
constexpr int SMEM_BYTES = OFF_BAR + 2 * STAGES * 8;   // 227,584

static_assert(PROMOTE % 2 == 0, "k-steps go in pairs");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk `ch` (channels 4ch..4ch+3) of staged row `r`.
__device__ __forceinline__ int swz(int r, int ch) {
  return r * ROW_BYTES + ((ch ^ (r & 7)) << 4);
}

__device__ __forceinline__ int active_count(const long long* active, int N) {
  if (active == nullptr) return N;
  const long long a = *active;
  return a < 0 ? 0 : (a > N ? N : static_cast<int>(a));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// a rounded to the nearest tf32 (ties away from zero), low 13 bits zero.
__device__ __forceinline__ uint32_t tf32_hi(float a) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(a));
  return r & 0xFFFFE000u;
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
// B descriptor of one half-slice (128 co x 8 ci, 32-bit): no swizzle,
// K-major; core matrices of 8 rows (co) x 16 bytes (4 ci) stored as 128
// contiguous bytes, the two k-halves of an 8-co group 128 B apart (LBO),
// consecutive 8-co groups 256 B apart (SBO).
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
__device__ __forceinline__ void fence_acc(float (&d)[NACC]) {
#pragma unroll
  for (int i = 0; i < NACC; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_a(uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// d (+)= A · B, m64n128k8 tf32, A (this warp's 16 rows) in registers, B in shared memory.
__device__ __forceinline__ void wgmma_tf32(float (&d)[NACC], const uint32_t (&a)[4], uint64_t desc,
                                           int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
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

// The consumers' ring position and their A fragments, double-buffered.
struct Pipe {
  uint32_t win, zero, ring, full, empty;
  uint32_t c;         // slices consumed
  int khalf, lane;
  uint32_t hi[2][4], lo[2][4];
};

// One k8 step of a warpgroup's product into `part`: load this warp's A
// fragment (16 rows x 8 channels; a lane gives the address of staged row
// `srow`, channels 4·khalf.. of step ks, or the zero chunk when srow < 0)
// and split it into register buffer BUF (the step two back, which used it,
// has retired), wait for the B slice, issue lo·hi, hi·lo, hi·hi (the first
// starting a fresh partial when `fresh`), then wait until the previous step
// has retired and release its slice to the producer.
template <int BUF>
__device__ __forceinline__ void kstep(Pipe& q, float (&part)[NACC], int srow, int ks, bool fresh) {
  uint32_t raw[4];
  ldsm_x4(srow >= 0 ? q.win + swz(srow, ks * 2 + q.khalf) : q.zero, raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float a = __uint_as_float(raw[i]);
    q.hi[BUF][i] = tf32_hi(a);
    q.lo[BUF][i] = tf32_hi(a - __uint_as_float(q.hi[BUF][i]));
  }
  const uint32_t stage = q.c % STAGES;
  mbar_wait(q.full + stage * 8, (q.c / STAGES) & 1);
  fence_acc(part);
  wg_fence();
  const uint64_t dhi = b_desc(q.ring + stage * SLICE);
  const uint64_t dlo = b_desc(q.ring + stage * SLICE + HALF);
  wgmma_tf32(part, q.lo[BUF], dhi, !fresh);
  wgmma_tf32(part, q.hi[BUF], dlo, 1);
  wgmma_tf32(part, q.hi[BUF], dhi, 1);
  wg_commit();
  wg_wait<1>();
  fence_acc(part);
  fence_a(q.hi[BUF ^ 1]);
  fence_a(q.lo[BUF ^ 1]);
  if (!fresh && q.lane == 0) mbar_arrive(q.empty + ((q.c - 1) % STAGES) * 8);
  ++q.c;
}

// acc = A · B over nk k-steps (k-step kk: staged row srow_of(kk >> 5), its
// channels 8·(kk & 31)..), the tensor-core partial promoted into acc every
// PROMOTE k-steps with f32 round-to-nearest adds.
template <typename RowOf>
__device__ __forceinline__ void product(Pipe& q, float (&acc)[NACC], float (&part)[NACC], int nk,
                                        RowOf srow_of) {
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
#pragma unroll 1
  for (int kk0 = 0; kk0 < nk; kk0 += PROMOTE) {
    const int kk1 = kk0 + PROMOTE < nk ? kk0 + PROMOTE : nk;
#pragma unroll 1
    for (int kk = kk0; kk < kk1; kk += 2) {
      const int srow = srow_of(kk >> 5);
      kstep<0>(q, part, srow, kk & 31, kk == kk0);
      kstep<1>(q, part, srow, (kk + 1) & 31, false);
    }
    wg_wait<0>();
    fence_acc(part);
    if (q.lane == 0) mbar_arrive(q.empty + ((q.c - 1) % STAGES) * 8);
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] += part[i];
  }
}

// One layer over the active rows.  kDeconv false: conv `x` (rows, 256) ->
// relu(x * W + b) into `y` (rows, 256), the weight stream's 576 (pass,
// tap, ks) slices.  kDeconv true: the deconv's 256 (d, pass, ks) slices,
// each tap's selected-logit dot, bias and sigmoid into `y` = out (N, 28,
// 28); slots at or past the active count written as 0.
template <bool kDeconv>
__global__ void __launch_bounds__(NTHREADS, 1)
layer_kernel(const float* __restrict__ x, const unsigned char* __restrict__ wstream,
             const float* __restrict__ bias, float* __restrict__ y, const float* __restrict__ wl,
             const float* __restrict__ bl, const long long* __restrict__ labels, int N,
             const long long* __restrict__ active) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint32_t full = smem_u32(smem + OFF_BAR);
  const uint32_t empty = full + STAGES * 8;
  const uint32_t ring = smem_u32(smem + OFF_RING);
  const int act = active_count(active, N);
  const int rows = act * MM;
  const int tiles = (rows + BM - 1) / BM;
  constexpr int NS = kDeconv ? DECONV_SLICES : CONV_SLICES;

  if constexpr (kDeconv) {  // slots at or past the active count are exactly 0
    float4* oz = reinterpret_cast<float4*>(y + static_cast<size_t>(act) * OUT * OUT);
    const int nz = (N - act) * (OUT * OUT / 4);
    for (int i = blockIdx.x * NTHREADS + threadIdx.x; i < nz; i += gridDim.x * NTHREADS)
      oz[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
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
  // register split holds.  ptxas reports the launch budget (168 a thread at
  // 384 threads); the consumers' branch is compiled to 232, without which
  // one layer kernel spills 144 bytes and the chain runs slower.
  if (warp >= NCONS) {  // producer: the layer's weight slices, once per tile
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == NCONS * 32) {
      uint32_t c = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        for (int s = 0; s < NS; ++s, ++c) {
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
    Pipe q;
    q.win = smem_u32(smem);
    q.zero = smem_u32(smem + OFF_ZERO);
    q.ring = ring;
    q.full = full;
    q.empty = empty;
    q.c = 0;
    q.khalf = lane >> 4;
    q.lane = lane;
    const int wg = warp >> 2, wl4 = warp & 3;
    const int g = lane >> 2, t = lane & 3;
    float acc[NACC], part[NACC];
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int r0 = tile * BM;
      const int w0 = kDeconv ? r0 : r0 - HALO;  // flat row of staged row 0
      const int nwin = kDeconv ? BM : WIN;
      // the tile's rows and halo: every 16-byte copy in flight at once; the
      // previous tile's readers are done (the barrier)
      consumers_sync();
      for (int i = threadIdx.x; i < nwin * (C / 4); i += NCONS * 32) {
        const int r = i >> 6, ch = i & 63;
        const int gr = w0 + r;
        if (gr >= 0 && gr < rows)
          asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(q.win + swz(r, ch)),
                       "l"(x + static_cast<size_t>(gr) * C + ch * 4)
                       : "memory");
      }
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      consumers_sync();

      // this lane's A row (ldmatrix address row) and its pixel
      const int arow = r0 + wg * 64 + wl4 * 16 + (lane & 15);
      const int ap = arow % MM, ah = ap / M, aw = ap % M;
      if constexpr (!kDeconv) {
        // tap (ky, kx) reads the row's neighbour (h + ky - 1, w + kx - 1), or zeros
        auto srow_of = [&](int tap) {
          const int dy = tap / 3 - 1, dx = tap % 3 - 1;
          const bool ok = arow < rows && ah + dy >= 0 && ah + dy < M && aw + dx >= 0 &&
                          aw + dx < M;
          return ok ? arow + dy * M + dx - w0 : -1;
        };
        for (int pass = 0; pass < 2; ++pass) {
          product(q, acc, part, 9 * KSTEPS, srow_of);
          // relu(acc + b) into the next layer's rows
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int gr = r0 + wg * 64 + wl4 * 16 + g + h * 8;
            if (gr < rows) {
              float* yr = y + static_cast<size_t>(gr) * C + pass * NH;
              const float* br = bias + pass * NH;
#pragma unroll
              for (int j = 0; j < NH / 8; ++j) {
                const int co = j * 8 + t * 2;
                const float2 b = __ldg(reinterpret_cast<const float2*>(br + co));
                *reinterpret_cast<float2*>(yr + co) =
                    make_float2(fmaxf(acc[j * 4 + h * 2] + b.x, 0.f),
                                fmaxf(acc[j * 4 + h * 2 + 1] + b.y, 0.f));
              }
            }
          }
        }
      } else {
        const int srow = arow < rows ? arow - w0 : -1;
        auto srow_of = [&](int) { return srow; };
        int roi[2], pix[2];
        const float* wr[2];
        float blr[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int gr = r0 + wg * 64 + wl4 * 16 + g + h * 8;
          roi[h] = gr / MM;
          pix[h] = gr - roi[h] * MM;
          const long long label = gr < rows ? labels[roi[h]] : 0;
          wr[h] = wl + label * C;
          blr[h] = bl[label];
        }
        for (int d = 0; d < 4; ++d) {
          // per row: sum over the 256 columns of relu(acc + bd) * wl[label],
          // the thread's 32 of each pass in order, then the quad
          float s[2] = {0.f, 0.f};
          for (int pass = 0; pass < 2; ++pass) {
            product(q, acc, part, KSTEPS, srow_of);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
#pragma unroll
              for (int j = 0; j < NH / 8; ++j) {
                const int co = pass * NH + j * 8 + t * 2;
                const float2 b = __ldg(reinterpret_cast<const float2*>(bias + co));
                const float2 w = __ldg(reinterpret_cast<const float2*>(wr[h] + co));
                s[h] += fmaxf(acc[j * 4 + h * 2] + b.x, 0.f) * w.x;
                s[h] += fmaxf(acc[j * 4 + h * 2 + 1] + b.y, 0.f) * w.y;
              }
            }
          }
          const int dy = d >> 1, dx = d & 1;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            s[h] += __shfl_xor_sync(0xffffffffu, s[h], 1);
            s[h] += __shfl_xor_sync(0xffffffffu, s[h], 2);
            const int gr = r0 + wg * 64 + wl4 * 16 + g + h * 8;
            if (t == 0 && gr < rows) {
              const int i = pix[h] / M, j = pix[h] % M;
              y[static_cast<size_t>(roi[h]) * OUT * OUT + (2 * i + dy) * OUT + 2 * j + dx] =
                  1.f / (1.f + expf(-(s[h] + blr[h])));
            }
          }
        }
      }
    }
  }
}

// asked of the CUDA runtime once per device and process
int sms_of[64] = {0};

}  // namespace

// pooled (N, 14, 14, 256) f32; wstream: the packed weight stream (2560
// slices of 8192 B, hi then lo, `ops/pallas_mask_head.mask_head_stream_f32`:
// (layer, pass, tap, ks) for the convs, then (d, pass, ks) for the deconv);
// bf (4, 256) and bd (256,) f32; wl (nc, 256) and bl (nc,) f32, the logits
// conv; labels (N,) int64 in [0, nc), each ROI's logits column; out (N, 28,
// 28) f32; active: a device int64 holding how many leading slots to compute
// (the rest are written as 0), or null for all N; work: 2 x N x 196 x 256 f32.
HDY_EXPORT int mask_head_f32(const void* pooled, const void* wstream, const void* bf,
                             const void* bd, const void* wl, const void* bl, const void* labels,
                             void* out, const void* active, void* work, int N, int device,
                             void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (N == 0) return 0;
  if (device < 0 || device >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (sms_of[device] == 0) {
    e = cudaFuncSetAttribute(layer_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    e = cudaFuncSetAttribute(layer_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    e = cudaDeviceGetAttribute(&sms_of[device], cudaDevAttrMultiProcessorCount, device);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int tiles = (N * MM + BM - 1) / BM;  // at most; the kernel reads the active count
  const int grid = tiles < sms_of[device] ? tiles : sms_of[device];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long* act = static_cast<const long long*>(active);
  const long long* lab = static_cast<const long long*>(labels);
  const unsigned char* ws = static_cast<const unsigned char*>(wstream);
  float* buf[2] = {static_cast<float*>(work),
                   static_cast<float*>(work) + static_cast<size_t>(N) * MM * C};
  const float* src = static_cast<const float*>(pooled);
  for (int l = 0; l < 4; ++l) {
    layer_kernel<false><<<grid, NTHREADS, SMEM_BYTES, st>>>(
        src, ws + static_cast<size_t>(l) * CONV_SLICES * SLICE,
        static_cast<const float*>(bf) + l * C, buf[l & 1], nullptr, nullptr, lab, N, act);
    src = buf[l & 1];
  }
  layer_kernel<true><<<grid, NTHREADS, SMEM_BYTES, st>>>(
      src, ws + static_cast<size_t>(4) * CONV_SLICES * SLICE, static_cast<const float*>(bd),
      static_cast<float*>(out), static_cast<const float*>(wl), static_cast<const float*>(bl), lab,
      N, act);
  return hdy::launch_status();
}

// The kernel's dynamic shared memory per block, bytes.
HDY_EXPORT int mask_head_f32_smem_bytes() { return SMEM_BYTES; }
