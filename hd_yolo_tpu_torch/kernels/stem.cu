// The stem family's direct kernel: silu(conv k×k/s(x) * scale + bias) with
// zero padding p, NHWC, for every shape of the family that the two K=108
// ring kernels (stem_tc.cu, stem_tf32.cu) do not take: C = 1..4 input
// channels, any k % s == 0 with k >= s > 1, any p, N a multiple of 8, any
// width, bf16 or f32 compute, every product on the tensor cores.
//
// Replaces the TPU kernel hd_yolo_tpu/ops/pallas_stem.py `_stem_kernel`
// (reached through `stem_conv_pallas`) for the shapes ops/pallas_stem.stem_form
// sends here: a bf16 stem whose N is not 16, 32, 48 or 64 (yolov5x6's
// Conv(3, 80, 6, 2, 2)), an f32 stem wider than stem_tf32's MAX_W or with
// N above 64, and every other (k, s, C).  The same function as the plain
// version: at bf16 compute x and w rounded to bf16, bf16 tensor-core
// products (mma.sync m16n8k16) with f32 accumulation, one bf16 write; at
// f32 compute split TF32 as stem_tf32.cu forms it (each f32 operand a =
// hi + lo, hi = tf32(a), lo = tf32(a - hi); lo·hi and hi·lo into one
// accumulator, hi·hi into another, summed in f32; mma.sync m16n8k8), the
// affine as a rounded multiply then a rounded add, SiLU as
// v / (1 + expf(-v)) correctly rounded, one f32 write.  The epilogue
// helpers are stem_ring.cuh's (`silu` for bf16, `silu_rn` for f32).
//
// Bound on an H100: memory.  yolov5x6's stem in bf16 at (16, 640, 640, 3)
// -> (16, 320, 320, 80) reads the f32 image (78.6 MB) and writes the bf16
// map (262.1 MB): 0.1017 ms at 3.35 TB/s, against 28.3 GFLOP of bf16
// products (0.029 ms at 989 TFLOP/s).  In f32 at its published 1280 px,
// (4, 1280, 1280, 3) -> (4, 640, 640, 80), it reads 78.6 MB and writes
// 524.3 MB: 0.180 ms, against 3 x 28.3 GFLOP of TF32 products (0.172 ms at
// 495 TFLOP/s).  The flagship shape forced here, (16, 640, 640, 3) -> N 64:
// 0.0861 ms in bf16, 0.1487 in f32.
//
// What the kernel that stood here until now paid for, and what this design
// does about it:
//   * f32 FMAs on the CUDA cores in both dtypes (22.6 GFLOP at the flagship
//     shape, 0.338 ms at 67 TFLOP/s even with every cycle used).  Here every
//     product is a tensor-core mma.sync.  K = k·k·C in the weight's own
//     (ky, kx, c) order is k row segments of k·C contiguous floats: for an
//     output pixel, input row oy·s - p + ky gives its floats from column
//     ox·s - p on.  Each segment is cut into K pairs of two contiguous
//     floats (an odd k·C gets a padding float whose weight and operand are
//     zero), so one 8-byte shared load gives a lane both K values of a pair
//     for one pixel, and the pairs are padded to the k-step (8 pairs a
//     bf16 m16n8k16, 4 a tf32 m16n8k8) with zero weights.  A per-block
//     table from pair to (ky, float in the segment) lets this one compiled
//     kernel take every (k, s, C); K, k, s, p and C are run-time values.
//     Where s·C or p·C is odd the pair's floats are not 8-byte aligned, and
//     a lane reads them as two 4-byte loads (a block-uniform branch).
//   * Staging that never overlapped compute, one float and a div/mod at a
//     time.  Here each block owns a window of TW = 64 output columns of one
//     image and a run of output rows, and keeps the window's input columns,
//     (TW - 1)·s + k pixels of C floats with the halo, in a ring of raw
//     input rows, exactly as they lie in device memory from the 16-byte
//     boundary at or before the window's first float.  Rows arrive as
//     16-byte cp.async copies where the image's rows are 16-byte multiples
//     (W·C % 4 == 0), else as 4-byte ones; a ring step is ROWS output rows
//     (4, or fewer where shared memory is short), and the next step's ROWS·s
//     new input rows load while the step computes.  The window's columns
//     outside the image are zeroed once per slot at the start, rows outside
//     it as they come.  No width limit: the ring holds a window, not a row.
//   * Weights restaged for every 4 x 64 tile (177 MB of L2 reads at the
//     flagship shape).  Here the blocks are persistent over a run of rows:
//     each stages its N tile's weights once, as B fragments (rounded to
//     bf16, or split into tf32 hi and lo), and each input row is read once
//     per run plus the ring's k - s halo rows at a run's start.
//   * N tiled across blocks: NB output channels a block, the tiling of N
//     that computes the fewest padded channels (8 to 128 at bf16; 8 to 64
//     at split TF32, where N 80 is two tiles of 40), then the deepest ring
//     step (4, 2 or 1 output rows) whose weights and ring fit in shared
//     memory; a partial last tile has zero weights and is not written.
//     Where even N tile 8 at one row a step does not fit split (K in the
//     thousands), the f32 weights are staged whole and split as they are
//     read.  Every shape the old kernel could launch has a plan
//     (tests/test_torch_stem.py).
//   * Products: a warp takes 16 pixels of one output row against all NB
//     channels; for each k-step it loads its A fragment from the ring (bf16:
//     rounded and packed in registers; tf32: split in registers) and runs
//     one mma (three in split TF32) per 8 channels with B fragments read
//     from shared memory.  mma.sync rather than wgmma: the work is a tenth
//     (bf16) to about one (f32) of the byte bound, K and N vary per call,
//     and stem_tc.cu's mma.sync ring already reaches 2.1x of its bound.
//     The 6x6 stem over 3 channels at bf16 (K = 108: 7 k-steps) with N tile
//     64 or 80 also has its k-step loop unrolled whole at compile time.
//   * Occupancy: the bf16 form keeps two blocks an SM (at most 128
//     registers, no spill); the split-TF32 form takes ptxas's own count
//     (114-128 at N tiles 32 to 64, two blocks an SM, with its k-step loop
//     not unrolled there: its two accumulators spill under an explicit cap
//     of 128 or with two k-steps in flight).
//   * Epilogue: bf16 through a padded per-warp stage buffer and out as
//     16-byte streaming stores (16 pixels x NB channels); f32 straight from
//     the accumulators as 8-byte streaming stores, each store instruction
//     writing 8 pixels' whole 32-byte sectors.

#include "stem_ring.cuh"

namespace {

using hdy::ring::commit;
using hdy::ring::mma_bf16;
using hdy::ring::pack_bf16;
using hdy::ring::silu;
using hdy::ring::silu_rn;
using hdy::ring::smem_u32;
using hdy::ring::tf32_hi;
using hdy::ring::wait_groups;
using hdy::ring::weight_bits;

constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int MT = 4;              // m-tiles of 16 output pixels a window row
constexpr int TW = 16 * MT;        // output columns of a block's window
constexpr int MAX_ROWS = 4;        // output rows a ring step, at most
constexpr int SMEM_LIMIT = 232448;
constexpr int PAD_HI = 1 << 30;    // pair table: the pair's second float is padding
constexpr int OFF_MASK = PAD_HI - 1;

// The three forms: bf16 operands; split TF32 with the weights split as they
// are staged; split TF32 with the f32 weights staged whole and split as read.
enum Mode { BF16 = 0, TF32 = 1, TF32_RAW = 2 };

template <int MODE>
struct Form {
  static constexpr int PSTEP = MODE == BF16 ? 8 : 4;   // K pairs a k-step
  static constexpr int BWORDS = MODE == TF32 ? 4 : 2;  // B words of a lane per (k-step, n-tile)
};

struct Plan {
  int H, W, C, k, s, p, N, Ho, Wo;
  int L;            // floats of a row segment, k·C
  int npairs;       // K pairs, k·ceil(L / 2)
  int ksteps;
  int rows;         // output rows a ring step
  int nslot;        // ring slots: a step's (rows - 1)·s + k input rows and the next step's rows·s
  int slot_floats;
  int fixed;        // shared bytes before the ring
  int nwin, ntile, nruns, rows_per_run;
  int pairs;        // every K pair 8-byte aligned in the ring
  int vec;          // 16-byte row copies
};

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The two floats of K pair `ent` (a pair-table entry, >= 0) for the pixel
// at ring float p, the pair's input row `rb` floats on around the ring.
__device__ __forceinline__ float2 fetch(const float* slots, int ent, int rb, int ring, int p,
                                        bool pairs) {
  int o = (ent & OFF_MASK) + rb;
  if (o >= ring) o -= ring;
  float2 v;
  if (pairs) {
    v = *reinterpret_cast<const float2*>(slots + o + p);
  } else {
    v.x = slots[o + p];
    v.y = slots[o + p + 1];
  }
  if (ent & PAD_HI) v.y = 0.f;
  return v;
}

// Weight (row of pair q's float e, column n) of the (K, N) f32 weight, 0 for
// the padding.
__device__ __forceinline__ float weight_at(const float* __restrict__ w, const Plan& P, int q,
                                           int e, int n) {
  if (q >= P.npairs || n >= P.N) return 0.f;
  const int lp = (P.L + 1) >> 1;
  const int ky = q / lp, j = 2 * (q - ky * lp) + e;
  return j < P.L ? w[static_cast<size_t>(ky * P.L + j) * P.N + n] : 0.f;
}

template <int MODE>
__host__ __device__ constexpr int stage_words(int nb) {
  return MODE == BF16 ? NWARPS * 16 * (nb / 2 + 4) : 0;
}

// The kernel's body.  KS > 0: the k-steps known at compile time (7: the 6x6
// stem over 3 channels at bf16), the product loop unrolled whole; 0: read
// from the plan.
template <int MODE, int NB, int KS>
__device__ __forceinline__ void stem_body(const float* __restrict__ x,
                                          const float* __restrict__ w,
                                          const float* __restrict__ scale,
                                          const float* __restrict__ bias, void* __restrict__ yv,
                                          const Plan& P) {
  using F = Form<MODE>;
  constexpr int NT = NB / 8;
  // k-steps unrolled: all of a known K; else 2, or 1 for split TF32 at NB >= 32,
  // where ptxas at its own register count spills the second step's operands
  constexpr int KU = KS > 0 ? KS : (MODE == BF16 || NB < 32 ? 2 : 1);
  const int nks = KS > 0 ? KS : P.ksteps;
  constexpr int SROW = NB / 2 + 4;   // stage row, words (padded by 16 B)
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* bfrag = reinterpret_cast<uint32_t*>(smem);
  uint32_t* stage = bfrag + P.ksteps * NT * 32 * F::BWORDS;
  float* sc = reinterpret_cast<float*>(stage + stage_words<MODE>(NB));
  float* bi = sc + NB;
  int* ptab = reinterpret_cast<int*>(bi + NB);
  float* slots = reinterpret_cast<float*>(smem + P.fixed);

  // block -> (image, run of output rows, N tile, column window)
  int idx = blockIdx.x;
  const int win = idx % P.nwin;
  idx /= P.nwin;
  const int tile = idx % P.ntile;
  idx /= P.ntile;
  const int run = idx % P.nruns;
  const int b = idx / P.nruns;
  const int oy0 = run * P.rows_per_run;
  const int oy1 = min(P.Ho, oy0 + P.rows_per_run);
  const int n0 = tile * NB;
  const int ox_base = win * TW;

  // slot float i holds row float fbase + i, fbase the 16-byte boundary at or
  // before the window's first float; floats outside the row stay zero
  const int rowf = P.W * P.C;
  const int f0 = (ox_base * P.s - P.p) * P.C;
  const int fbase = f0 & ~3;
  const int lead = f0 - fbase;
  const int lo = min(max(0, -fbase), P.slot_floats);
  const int hi = max(lo, min(rowf - fbase, P.slot_floats));
  const float* xb = x + static_cast<size_t>(b) * P.H * rowf;
  const int iy_base = oy0 * P.s - P.p;   // input row of relative row 0 (ring slot 0)

  // relative input rows r0 .. r0 + n - 1 into slots r % nslot, one cp.async
  // group for the caller to commit
  auto load_rows = [&](int r0, int n) {
    if (P.vec) {
      const int c_lo = lo >> 2, nch = (hi >> 2) - c_lo;
      for (int i = threadIdx.x; i < n * nch; i += NTHREADS) {
        const int rr = i / nch, c = c_lo + i - rr * nch;
        const int r = r0 + rr, iy = iy_base + r;
        float* slot = slots + (r % P.nslot) * P.slot_floats + 4 * c;
        if (iy < 0 || iy >= P.H) {
          *reinterpret_cast<float4*>(slot) = make_float4(0.f, 0.f, 0.f, 0.f);
        } else {
          const float* src = xb + static_cast<size_t>(iy) * rowf + fbase + 4 * c;
          asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(slot)),
                       "l"(src)
                       : "memory");
        }
      }
    } else {
      const int nf = hi - lo;
      for (int i = threadIdx.x; i < n * nf; i += NTHREADS) {
        const int rr = i / nf, j = lo + i - rr * nf;
        const int r = r0 + rr, iy = iy_base + r;
        float* slot = slots + (r % P.nslot) * P.slot_floats + j;
        if (iy < 0 || iy >= P.H) {
          *slot = 0.f;
        } else {
          const float* src = xb + static_cast<size_t>(iy) * rowf + fbase + j;
          asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(slot)),
                       "l"(src)
                       : "memory");
        }
      }
    }
  };

  const int step_in = (P.rows - 1) * P.s + P.k;   // input rows of a step
  load_rows(0, step_in);
  commit();

  // the N tile's weights as B fragments [k-step][n-tile][lane]: bf16 pairs
  // {pair 8ks + t, pair 8ks + 4 + t}; tf32 {hi, hi, lo, lo} of pair 4ks + t's
  // two floats; or those two floats unsplit
  for (int i = threadIdx.x; i < P.ksteps * NT * 32; i += NTHREADS) {
    const int lane = i & 31, nt = (i >> 5) % NT, ks = (i >> 5) / NT;
    const int n = n0 + nt * 8 + (lane >> 2), t = lane & 3;
    if constexpr (MODE == BF16) {
      uint32_t r[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = ks * 8 + 4 * h + t;
        r[h] = weight_bits(weight_at(w, P, q, 0, n)) | (weight_bits(weight_at(w, P, q, 1, n)) << 16);
      }
      reinterpret_cast<uint2*>(bfrag)[i] = make_uint2(r[0], r[1]);
    } else {
      const int q = ks * 4 + t;
      const float v0 = weight_at(w, P, q, 0, n), v1 = weight_at(w, P, q, 1, n);
      if constexpr (MODE == TF32) {
        const uint32_t h0 = tf32_hi(v0), h1 = tf32_hi(v1);
        reinterpret_cast<uint4*>(bfrag)[i] =
            make_uint4(h0, h1, tf32_hi(v0 - __uint_as_float(h0)),
                       tf32_hi(v1 - __uint_as_float(h1)));
      } else {
        reinterpret_cast<uint2*>(bfrag)[i] = make_uint2(__float_as_uint(v0), __float_as_uint(v1));
      }
    }
  }
  // pair q -> slot float of its first float for pixel 0 (row ky's slot taken
  // as slot ky), with PAD_HI where its second float is padding; -1: a
  // padding pair
  const int lp = (P.L + 1) >> 1;
  for (int q = threadIdx.x; q < P.ksteps * F::PSTEP; q += NTHREADS) {
    int ent = -1;
    if (q < P.npairs) {
      const int ky = q / lp, j = 2 * (q - ky * lp);
      ent = ky * P.slot_floats + j + (j + 1 == P.L ? PAD_HI : 0);
    }
    ptab[q] = ent;
  }
  for (int i = threadIdx.x; i < NB; i += NTHREADS) {
    sc[i] = n0 + i < P.N ? scale[n0 + i] : 0.f;
    bi[i] = n0 + i < P.N ? bias[n0 + i] : 0.f;
  }
  // the window's floats outside the image row, once per slot
  const int outside = lo + (P.slot_floats - hi);
  for (int i = threadIdx.x; i < P.nslot * outside; i += NTHREADS) {
    const int sl = i / outside, j = i - sl * outside;
    slots[sl * P.slot_floats + (j < lo ? j : hi + j - lo)] = 0.f;
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ring = P.nslot * P.slot_floats;
  const int pix = P.s * P.C;                  // ring floats from one output pixel to the next
  const bool pairs = P.pairs != 0;
  int slot0 = 0;                              // slot of the step's first input row

  for (int oy = oy0; oy < oy1; oy += P.rows) {
    wait_groups<0>();
    __syncthreads();  // the step's rows are in; the last step is done with its slots
    if (oy + P.rows < oy1) load_rows((oy - oy0) * P.s + step_in, P.rows * P.s);
    commit();

    const int nr = min(P.rows, oy1 - oy);
    for (int u = warp; u < nr * MT; u += NWARPS) {   // uniform over a warp
      const int ri = u / MT;
      const int ox0 = ox_base + (u - ri * MT) * 16;
      if (ox0 >= P.Wo) continue;
      int rs = slot0 + ri * P.s;
      if (rs >= P.nslot) rs -= P.nslot;
      const int rb = rs * P.slot_floats;
      // pixels past the last column read the last one; they are not written
      const int p0 = lead + (min(ox0 + g, P.Wo - 1) - ox_base) * pix;
      const int p1 = lead + (min(ox0 + g + 8, P.Wo - 1) - ox_base) * pix;
      const size_t row0 = (static_cast<size_t>(b) * P.Ho + oy + ri) * P.Wo;

      if constexpr (MODE == BF16) {
        float acc[NT][4];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[nt][j] = 0.f;
        const uint2* bq = reinterpret_cast<const uint2*>(bfrag) + lane;
#pragma unroll KU
        for (int ks = 0; ks < nks; ++ks) {
          const int e0 = ptab[ks * 8 + t], e1 = ptab[ks * 8 + 4 + t];
          uint32_t a[4] = {0u, 0u, 0u, 0u};
          if (e0 >= 0) {
            a[0] = pack_bf16(fetch(slots, e0, rb, ring, p0, pairs));
            a[1] = pack_bf16(fetch(slots, e0, rb, ring, p1, pairs));
          }
          if (e1 >= 0) {
            a[2] = pack_bf16(fetch(slots, e1, rb, ring, p0, pairs));
            a[3] = pack_bf16(fetch(slots, e1, rb, ring, p1, pairs));
          }
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const uint2 q = bq[(ks * NT + nt) * 32];
            mma_bf16(acc[nt], a, q.x, q.y);
          }
        }
        // epilogue: silu(acc * scale + bias) -> bf16 through the stage
        // buffer, then the tile's pixels' NB channels as streaming 16-byte
        // stores (16 contiguous pixels' N channels where NB = N)
        uint32_t* st = stage + warp * 16 * SROW;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int col = nt * 8 + 2 * t;
          const float s0 = sc[col], s1 = sc[col + 1], b0 = bi[col], b1 = bi[col + 1];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float v0 = __fadd_rn(__fmul_rn(acc[nt][2 * h], s0), b0);
            const float v1 = __fadd_rn(__fmul_rn(acc[nt][2 * h + 1], s1), b1);
            st[(g + 8 * h) * SROW + nt * 4 + t] = pack_bf16(make_float2(silu(v0), silu(v1)));
          }
        }
        __syncwarp();
        const int nrows = min(16, P.Wo - ox0);
        const int nchunk = min(NT, (P.N - n0) >> 3);
        __nv_bfloat16* yrow = static_cast<__nv_bfloat16*>(yv) + (row0 + ox0) * P.N + n0;
#pragma unroll
        for (int i = 0; i < (16 * NT + 31) / 32; ++i) {
          const int q = lane + 32 * i, row = q / NT, c = q - row * NT;
          if (q < 16 * NT && row < nrows && c < nchunk)
            __stcs(reinterpret_cast<int4*>(yrow + static_cast<size_t>(row) * P.N) + c,
                   *reinterpret_cast<const int4*>(st + row * SROW + 4 * c));
        }
        __syncwarp();
      } else {
        float small[NT][4], big[NT][4];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int j = 0; j < 4; ++j) small[nt][j] = big[nt][j] = 0.f;
#pragma unroll KU
        for (int ks = 0; ks < nks; ++ks) {
          const int e = ptab[ks * 4 + t];
          // the fragment {(g, t), (g+8, t), (g, t+4), (g+8, t+4)}: K slots t
          // and t + 4 are the pair's two floats
          float v[4] = {0.f, 0.f, 0.f, 0.f};
          if (e >= 0) {
            const float2 u0 = fetch(slots, e, rb, ring, p0, pairs);
            const float2 u1 = fetch(slots, e, rb, ring, p1, pairs);
            v[0] = u0.x;
            v[1] = u1.x;
            v[2] = u0.y;
            v[3] = u1.y;
          }
          uint32_t ah[4], al[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            ah[i] = tf32_hi(v[i]);
            al[i] = tf32_hi(v[i] - __uint_as_float(ah[i]));
          }
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            uint32_t bh0, bh1, bl0, bl1;
            if constexpr (MODE == TF32) {
              const uint4 q = reinterpret_cast<const uint4*>(bfrag)[(ks * NT + nt) * 32 + lane];
              bh0 = q.x;
              bh1 = q.y;
              bl0 = q.z;
              bl1 = q.w;
            } else {
              const uint2 q = reinterpret_cast<const uint2*>(bfrag)[(ks * NT + nt) * 32 + lane];
              bh0 = tf32_hi(__uint_as_float(q.x));
              bh1 = tf32_hi(__uint_as_float(q.y));
              bl0 = tf32_hi(__uint_as_float(q.x) - __uint_as_float(bh0));
              bl1 = tf32_hi(__uint_as_float(q.y) - __uint_as_float(bh1));
            }
            mma_tf32(small[nt], al, bh0, bh1);
            mma_tf32(small[nt], ah, bl0, bl1);
            mma_tf32(big[nt], ah, bh0, bh1);
          }
        }
        // epilogue in f32: each lane's two pixels' channel pairs as 8-byte
        // streaming stores
        float* y0 = static_cast<float*>(yv) + (row0 + ox0 + g) * P.N + n0 + 2 * t;
        float* y1 = y0 + 8 * static_cast<size_t>(P.N);
        const bool in0 = ox0 + g < P.Wo, in1 = ox0 + g + 8 < P.Wo;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          if (n0 + nt * 8 >= P.N) break;
          const float2 s = *reinterpret_cast<const float2*>(sc + nt * 8 + 2 * t);
          const float2 c = *reinterpret_cast<const float2*>(bi + nt * 8 + 2 * t);
          const float v0 = __fadd_rn(__fmul_rn(small[nt][0] + big[nt][0], s.x), c.x);
          const float v1 = __fadd_rn(__fmul_rn(small[nt][1] + big[nt][1], s.y), c.y);
          const float v2 = __fadd_rn(__fmul_rn(small[nt][2] + big[nt][2], s.x), c.x);
          const float v3 = __fadd_rn(__fmul_rn(small[nt][3] + big[nt][3], s.y), c.y);
          if (in0) __stcs(reinterpret_cast<float2*>(y0 + nt * 8), make_float2(silu_rn(v0), silu_rn(v1)));
          if (in1) __stcs(reinterpret_cast<float2*>(y1 + nt * 8), make_float2(silu_rn(v2), silu_rn(v3)));
        }
      }
    }
    slot0 += P.rows * P.s;
    if (slot0 >= P.nslot) slot0 -= P.nslot;
  }
  wait_groups<0>();
}

// bf16: two blocks an SM (at most 128 registers; 126 at NB 128, no spill).
template <int MODE, int NB, int KS>
__global__ void __launch_bounds__(NTHREADS, 2)
stem_bf16_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ scale, const float* __restrict__ bias,
                 void* __restrict__ y, const Plan P) {
  stem_body<MODE, NB, KS>(x, w, scale, bias, y, P);
}

// split TF32: the compiler's own register count (its two accumulators
// spill under a cap of 128 at some N tiles).
template <int MODE, int NB, int KS>
__global__ void __launch_bounds__(NTHREADS)
stem_tf32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ scale, const float* __restrict__ bias,
                 void* __restrict__ y, const Plan P) {
  stem_body<MODE, NB, KS>(x, w, scale, bias, y, P);
}

// ------------------------------------------------------------------ host

template <int MODE>
int fixed_bytes(int nb, int ksteps) {
  const int bytes = ksteps * (nb / 8) * 32 * Form<MODE>::BWORDS * 4 + stage_words<MODE>(nb) * 4 +
                    2 * nb * 4 + ksteps * Form<MODE>::PSTEP * 4;
  return (bytes + 15) & ~15;
}

using Kernel = void (*)(const float*, const float*, const float*, const float*, void*, Plan);

// The N tiles each form is compiled for.
constexpr int BF16_NB[] = {128, 96, 80, 64, 48, 32, 16, 8};
constexpr int TF32_NB[] = {64, 48, 40, 32, 16, 8};

Kernel kernel_for(int mode, int nb, int ksteps) {
  if (mode == BF16 && ksteps == 7 && nb == 80) return stem_bf16_kernel<BF16, 80, 7>;
  if (mode == BF16 && ksteps == 7 && nb == 64) return stem_bf16_kernel<BF16, 64, 7>;
  if (mode == BF16) {
    switch (nb) {
      case 128: return stem_bf16_kernel<BF16, 128, 0>;
      case 96: return stem_bf16_kernel<BF16, 96, 0>;
      case 80: return stem_bf16_kernel<BF16, 80, 0>;
      case 64: return stem_bf16_kernel<BF16, 64, 0>;
      case 48: return stem_bf16_kernel<BF16, 48, 0>;
      case 32: return stem_bf16_kernel<BF16, 32, 0>;
      case 16: return stem_bf16_kernel<BF16, 16, 0>;
      case 8: return stem_bf16_kernel<BF16, 8, 0>;
    }
  } else if (mode == TF32) {
    switch (nb) {
      case 64: return stem_tf32_kernel<TF32, 64, 0>;
      case 48: return stem_tf32_kernel<TF32, 48, 0>;
      case 40: return stem_tf32_kernel<TF32, 40, 0>;
      case 32: return stem_tf32_kernel<TF32, 32, 0>;
      case 16: return stem_tf32_kernel<TF32, 16, 0>;
      case 8: return stem_tf32_kernel<TF32, 8, 0>;
    }
  } else if (nb == 8) {
    return stem_tf32_kernel<TF32_RAW, 8, 0>;
  }
  return nullptr;
}

int plan_fixed(int mode, int nb, int ksteps) {
  if (mode == BF16) return fixed_bytes<BF16>(nb, ksteps);
  if (mode == TF32) return fixed_bytes<TF32>(nb, ksteps);
  return fixed_bytes<TF32_RAW>(nb, ksteps);
}

// The plan of one call: form, N tile, ring depth and shared memory; the
// grid's runs are set at launch, from the card's resident blocks.  Returns
// the dynamic shared bytes, or 0 where no plan fits.
size_t make_plan(int H, int W, int C, int k, int s, int p, int N, int Ho, int Wo, bool bf16,
                 Plan& P, int& mode, int& nb) {
  P = Plan{};
  P.H = H, P.W = W, P.C = C, P.k = k, P.s = s, P.p = p, P.N = N, P.Ho = Ho, P.Wo = Wo;
  P.L = k * C;
  P.npairs = k * ((P.L + 1) / 2);
  P.slot_floats = (((TW - 1) * s + k) * C + 4 + 3) & ~3;
  P.nwin = (Wo + TW - 1) / TW;
  P.pairs = (s * C) % 2 == 0 && (p * C) % 2 == 0;
  P.vec = (W * C) % 4 == 0;
  // N tiles by the channels they compute, fewest first; ties to the larger tile
  const int* cand = bf16 ? BF16_NB : TF32_NB;
  const int ncand = bf16 ? 8 : 6;
  int order[8];
  for (int i = 0; i < ncand; ++i) order[i] = cand[i];
  for (int i = 1; i < ncand; ++i)
    for (int j = i; j > 0; --j) {
      const int a = order[j - 1], c = order[j];
      const long ca = static_cast<long>((N + a - 1) / a) * a, cc = static_cast<long>((N + c - 1) / c) * c;
      if (cc < ca) order[j - 1] = c, order[j] = a;
    }
  const int modes[2] = {bf16 ? BF16 : TF32, bf16 ? -1 : TF32_RAW};
  for (int m : modes) {
    if (m < 0) break;
    const int pstep = m == BF16 ? 8 : 4;
    P.ksteps = (P.npairs + pstep - 1) / pstep;
    for (int i = 0; i < (m == TF32_RAW ? 1 : ncand); ++i) {
      const int t = m == TF32_RAW ? 8 : order[i];
      for (int rows = MAX_ROWS; rows >= 1; rows >>= 1) {
        const int nslot = (2 * rows - 1) * s + k;
        const size_t smem = plan_fixed(m, t, P.ksteps) +
                            static_cast<size_t>(nslot) * P.slot_floats * 4;
        if (smem <= SMEM_LIMIT) {
          P.rows = rows, P.nslot = nslot, P.fixed = plan_fixed(m, t, P.ksteps);
          P.ntile = (N + t - 1) / t;
          mode = m, nb = t;
          return smem;
        }
      }
    }
  }
  return 0;
}

struct Resident {
  Kernel fn;
  int device;
  size_t smem;
  int per_sm;
};

// Blocks of `fn` resident on an SM at `smem` bytes, and the device's SMs;
// asked of the CUDA runtime once per (kernel, device, shared bytes).
int resident(Kernel fn, int device, size_t smem, int& sms) {
  static Resident cache[16];
  static int ncache = 0, sm_count[64] = {0};
  if (device < 0 || device >= 64) return -static_cast<int>(cudaErrorInvalidDevice);
  if (!sm_count[device]) {
    cudaError_t e = cudaDeviceGetAttribute(&sm_count[device], cudaDevAttrMultiProcessorCount, device);
    if (e != cudaSuccess) return -static_cast<int>(e);
  }
  sms = sm_count[device];
  for (int i = 0; i < ncache; ++i)
    if (cache[i].fn == fn && cache[i].device == device && cache[i].smem == smem)
      return cache[i].per_sm;
  // the limit, not this call's bytes: a later call of the kernel may need more
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       SMEM_LIMIT);
  if (e != cudaSuccess) return -static_cast<int>(e);
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, NTHREADS, smem);
  if (e != cudaSuccess) return -static_cast<int>(e);
  per_sm = max(per_sm, 1);
  cache[ncache % 16] = Resident{fn, device, smem, per_sm};
  ++ncache;
  return per_sm;
}

}  // namespace

// x (B, H, W, C) f32 NHWC, 16-byte aligned; w (K, K, C, N) f32, i.e. (K·K·C,
// N) with rows in (ky, kx, c) order, rounded to bf16 or split into tf32 hi
// and lo as the kernel stages it; scale/bias (N,) f32; y (B, Hout, Wout, N)
// bf16 (out_bf16 1: bf16 compute) or f32 (0: split-TF32 compute); N a
// multiple of 8, K % S == 0, K >= S > 1.
HDY_EXPORT int stem_conv(const void* x, const void* w, const void* scale, const void* bias,
                         void* y, int B, int H, int W, int C, int K, int S, int P, int N,
                         int Hout, int Wout, int out_bf16, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (B < 1 || Hout < 1 || Wout < 1 || C < 1 || N < 8 || N % 8 || S < 1 || K < S || K % S ||
      P < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Plan plan;
  int mode = 0, nb = 0;
  const size_t smem = make_plan(H, W, C, K, S, P, N, Hout, Wout, out_bf16 != 0, plan, mode, nb);
  if (!smem) return static_cast<int>(cudaErrorInvalidValue);
  Kernel fn = kernel_for(mode, nb, plan.ksteps);
  int sms = 0;
  const int per_sm = resident(fn, device, smem, sms);
  if (per_sm < 0) return -per_sm;
  // runs of output rows a (image, N tile, window): the fewest runs with the
  // least time, counting one round of resident blocks a wave and a ring
  // step of plan.rows output rows the unit of a block's work
  const long groups = static_cast<long>(B) * plan.ntile * plan.nwin;
  const long slots = static_cast<long>(sms) * per_sm;
  long best = -1;
  int nruns = 1;
  for (int n = 1; n <= Hout && n <= 4 * slots / groups + 1; ++n) {
    const long rows = (Hout + n - 1) / n;
    const long cost = ((groups * n + slots - 1) / slots) * ((rows + plan.rows - 1) / plan.rows);
    if (best < 0 || cost < best) best = cost, nruns = n;
  }
  plan.rows_per_run = (Hout + nruns - 1) / nruns;
  plan.nruns = (Hout + plan.rows_per_run - 1) / plan.rows_per_run;
  const long blocks = groups * plan.nruns;
  if (blocks > 0x7FFFFFFFL) return static_cast<int>(cudaErrorInvalidValue);
  fn<<<static_cast<unsigned>(blocks), NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias), y, plan);
  return hdy::launch_status();
}

// The plan of a call, without launching: info = {form (0 bf16, 1 split
// TF32, 2 split TF32 from unsplit weights), N tile, output rows a ring step,
// ring slots, floats a slot, k-steps, dynamic shared bytes}; returns 0, or
// cudaErrorInvalidValue where no plan fits.
HDY_EXPORT int stem_conv_plan(int H, int W, int C, int K, int S, int P, int N, int Hout,
                              int Wout, int out_bf16, int* info) {
  Plan plan;
  int mode = 0, nb = 0;
  const size_t smem = make_plan(H, W, C, K, S, P, N, Hout, Wout, out_bf16 != 0, plan, mode, nb);
  if (!smem) return static_cast<int>(cudaErrorInvalidValue);
  const int v[7] = {mode, nb, plan.rows, plan.nslot, plan.slot_floats, plan.ksteps,
                    static_cast<int>(smem)};
  for (int i = 0; i < 7; ++i) info[i] = v[i];
  return 0;
}
