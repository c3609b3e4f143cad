// Exact greedy NMS over score-sorted, padded boxes, batched over images.
//
// Replaces the TPU kernel hd_yolo_tpu/ops/pallas_nms.py `_nms_kernel`
// (reached through `_nms_keep_sorted` / `nms_padded_pallas`).  Same
// function: box i suppresses box j when i < j (score order), both are valid
// and IoU(i, j) > thr; the keep mask is the sequential greedy one; the first
// max_det kept positions are compacted in order into `idx`, and `keep` marks
// the filled slots (unfilled idx slots are 0).
//
// The result must be bit-identical to the plain version (ops/nms.py
// `nms_padded`), so the IoU uses exactly the op order of `box_iou` with
// round-to-nearest intrinsics, and this file is built with --fmad=false.
//
// Bound on an H100: neither bytes nor FLOPs.  Per image at K=1024 the
// inputs are 20 KB and the pairwise test is ~0.5 M IoUs (~10 MFLOP); the
// time goes to the sequential sweep.  Design:
//   1. nms_mask_kernel: one block per (image, 64-row block, 64-col block) of
//      the upper triangle only (column block >= row block; the lower
//      triangle is neither launched nor written), four threads a row on 16
//      columns each (the IEEE divide's latency needs the warps), writes the
//      conflict bits of its rows as one u64 word per row, stored word-major
//      (B, K/64 + 1, K) so that a word of 64 consecutive rows is 512
//      contiguous bytes.  The diagonal blocks also write, in the last plane,
//      each box's conflicters inside its own word (the bits below it).
//   2. nms_sweep_kernel: one 512-thread block per image walks the 64-box
//      words in order, so the chain is one step per word, not per kept box.
//      For word w, one warp resolves the greedy keep inside the word from
//      ~removed[w] and the conflicters words, in parallel rounds (as many as
//      the longest conflict chain in the word); meanwhile every warp has
//      already issued the loads of its later words u > w for all 64 rows of
//      w; once the kept bits are known, each warp ORs the kept rows' words
//      into removed[u] with a warp OR reduction (a fixed order; OR is exact
//      in any order).  Then one warp compacts the keep bits with popcounts
//      into idx/keep.
// `valid` and `keep` are torch bool storage: one byte, 0 or 1.

#include "common.cuh"

namespace {

typedef unsigned long long u64;

constexpr unsigned FULL = 0xffffffffu;
constexpr int MASK_GROUPS = 4;        // column groups of 16 per 64 x 64 block
constexpr int MASK_THREADS = 64 * MASK_GROUPS;
constexpr int SWEEP_THREADS = 512;
constexpr int SWEEP_WARPS = SWEEP_THREADS / 32;
constexpr int PREFETCH = 4;           // later words per warp whose loads are issued early

__device__ __forceinline__ float iou(const float4 a, const float4 b) {
  // box_iou: lt = max(a.xy, b.xy); rb = min(a.zw, b.zw); wh = clip(rb - lt, 0)
  const float ltx = fmaxf(a.x, b.x), lty = fmaxf(a.y, b.y);
  const float rbx = fminf(a.z, b.z), rby = fminf(a.w, b.w);
  const float w = fmaxf(__fsub_rn(rbx, ltx), 0.f);
  const float h = fmaxf(__fsub_rn(rby, lty), 0.f);
  const float inter = __fmul_rn(w, h);
  const float area_a = __fmul_rn(__fsub_rn(a.z, a.x), __fsub_rn(a.w, a.y));
  const float area_b = __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return __fdiv_rn(inter, fmaxf(uni, 1e-12f));
}

__global__ void __launch_bounds__(MASK_THREADS)
nms_mask_kernel(const float4* __restrict__ boxes, const uint8_t* __restrict__ valid, int K,
                int nwords, float thr, u64* __restrict__ mask) {
  // blockIdx.x enumerates the upper-triangle pairs (rb, cb >= rb) row by row
  int t = blockIdx.x, rb = 0;
  while (t >= nwords - rb) {
    t -= nwords - rb;
    ++rb;
  }
  const int cb = rb + t, b = blockIdx.y, tid = threadIdx.x;
  const int r = tid & 63, g = tid >> 6;    // row of the block, group of 16 columns
  __shared__ float4 cbox[64];
  __shared__ uint8_t cval[64];
  __shared__ u64 part[2][MASK_GROUPS][64];
  if (tid < 64) {
    const int col = cb * 64 + tid;
    cbox[tid] = col < K ? boxes[static_cast<size_t>(b) * K + col] : make_float4(0.f, 0.f, 0.f, 0.f);
    cval[tid] = col < K ? valid[static_cast<size_t>(b) * K + col] : 0;
  }
  __syncthreads();
  const int row = rb * 64 + r;
  u64 bits = 0ull, by = 0ull;
  if (row < K && valid[static_cast<size_t>(b) * K + row]) {
    const float4 rbox = boxes[static_cast<size_t>(b) * K + row];
    const int j1 = min((g + 1) * 16, K - cb * 64);
    for (int j = g * 16; j < j1; ++j) {
      // on the diagonal block IoU is symmetric bit for bit (every op of
      // box_iou is), so one test per pair gives the row's conflicts above it
      // and the column's below it
      if ((cb != rb || j != r) && cval[j] && iou(rbox, cbox[j]) > thr) {
        if (cb != rb || j > r) bits |= 1ull << j;
        else by |= 1ull << j;
      }
    }
  }
  part[0][g][r] = bits;
  part[1][g][r] = by;
  __syncthreads();
  if (g == 0 && row < K) {
#pragma unroll
    for (int q = 1; q < MASK_GROUPS; ++q) {
      bits |= part[0][q][r];
      by |= part[1][q][r];
    }
    const size_t plane = static_cast<size_t>(b) * (nwords + 1);
    mask[(plane + cb) * K + row] = bits;
    if (cb == rb) mask[(plane + nwords) * K + row] = by;
  }
}

__global__ void __launch_bounds__(SWEEP_THREADS)
nms_sweep_kernel(const uint8_t* __restrict__ valid, const u64* __restrict__ mask, int K,
                 int nwords, int max_det, int* __restrict__ out_idx,
                 uint8_t* __restrict__ out_keep) {
  extern __shared__ u64 words[];
  u64* removed = words;                    // (nwords,)
  u64* keepw = words + nwords;             // (nwords,)
  u64* by = words + 2 * nwords;            // (nwords * 64,): row i's conflicters in its word
  __shared__ int s_kept;
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const uint8_t* v = valid + static_cast<size_t>(b) * K;
  const u64* m = mask + static_cast<size_t>(b) * (nwords + 1) * K;

  // invalid and past-the-end slots start out removed; one 32-bit half a warp
  unsigned* rem32 = reinterpret_cast<unsigned*>(removed);
  for (int i0 = warp * 32; i0 < nwords * 64; i0 += SWEEP_THREADS) {
    const int i = i0 + lane;
    const unsigned ok = __ballot_sync(FULL, i < K && v[i]);
    if (lane == 0) rem32[i0 >> 5] = ~ok;
  }
  for (int i = tid; i < nwords * 64; i += SWEEP_THREADS)
    by[i] = i < K ? m[static_cast<size_t>(nwords) * K + i] : 0ull;
  __syncthreads();

  for (int w = 0; w < nwords; ++w) {
    // issue the loads of this warp's first later words for all 64 rows of w
    u64 pre[PREFETCH][2];
#pragma unroll
    for (int j = 0; j < PREFETCH; ++j) {
      const int u = w + 1 + warp + j * SWEEP_WARPS;
      const int r0 = w * 64 + lane, r1 = r0 + 32;
      const u64* col = m + static_cast<size_t>(u) * K;
      pre[j][0] = (u < nwords && r0 < K) ? col[r0] : 0ull;
      pre[j][1] = (u < nwords && r1 < K) ? col[r1] : 0ull;
    }
    if (warp == 0) {
      // the greedy keep inside word w, in rounds: an undecided box is kept
      // once no earlier box that conflicts with it is kept or undecided, and
      // removed once one of them is kept.  The lowest undecided box always
      // resolves, so this ends; it takes as many rounds as the longest chain
      // of conflicts among the word's live boxes.
      const u64 by0 = by[w * 64 + lane], by1 = by[w * 64 + 32 + lane];
      u64 und = ~removed[w], kept = 0ull;
      while (und) {
        const bool in0 = (und >> lane) & 1ull, in1 = (und >> (lane + 32)) & 1ull;
        const u64 blocking = kept | und;
        const unsigned k0 = __ballot_sync(FULL, in0 && !(by0 & blocking));
        const unsigned k1 = __ballot_sync(FULL, in1 && !(by1 & blocking));
        const u64 fresh = (static_cast<u64>(k1) << 32) | k0;
        const unsigned r0 = __ballot_sync(FULL, in0 && (by0 & fresh));
        const unsigned r1 = __ballot_sync(FULL, in1 && (by1 & fresh));
        kept |= fresh;
        und &= ~(fresh | (static_cast<u64>(r1) << 32) | r0);
      }
      if (lane == 0) keepw[w] = kept;
    }
    __syncthreads();
    const u64 kept = keepw[w];
    if (kept != 0ull) {
      const bool k0 = (kept >> lane) & 1ull, k1 = (kept >> (lane + 32)) & 1ull;
      // u is uniform across the warp, so every lane joins each reduction
      auto or_rows = [&](int u, u64 a0, u64 a1) {
        const u64 acc = (k0 ? a0 : 0ull) | (k1 ? a1 : 0ull);
        const unsigned lo = __reduce_or_sync(FULL, static_cast<unsigned>(acc));
        const unsigned hi = __reduce_or_sync(FULL, static_cast<unsigned>(acc >> 32));
        if (lane == 0) removed[u] |= (static_cast<u64>(hi) << 32) | lo;
      };
#pragma unroll
      for (int j = 0; j < PREFETCH; ++j) {
        const int u = w + 1 + warp + j * SWEEP_WARPS;
        if (u < nwords) or_rows(u, pre[j][0], pre[j][1]);
      }
      for (int u = w + 1 + warp + PREFETCH * SWEEP_WARPS; u < nwords; u += SWEEP_WARPS) {
        const u64* col = m + static_cast<size_t>(u) * K;
        const int r0 = w * 64 + lane, r1 = r0 + 32;
        or_rows(u, r0 < K ? col[r0] : 0ull, r1 < K ? col[r1] : 0ull);
      }
    }
    __syncthreads();
  }

  int* oi = out_idx + static_cast<size_t>(b) * max_det;
  if (warp == 0) {
    int base = 0;
    for (int w = 0; w < nwords; ++w) {
      const u64 kw = keepw[w];
      for (int half = 0; half < 2; ++half) {
        const int bit = half * 32 + lane;
        if ((kw >> bit) & 1ull) {
          const int rank = base + __popcll(kw & ((1ull << bit) - 1ull));
          if (rank < max_det) oi[rank] = w * 64 + bit;
        }
      }
      base += __popcll(kw);
    }
    if (lane == 0) s_kept = min(base, max_det);
  }
  __syncthreads();
  const int n_kept = s_kept;
  for (int p = tid; p < max_det; p += SWEEP_THREADS) {
    out_keep[static_cast<size_t>(b) * max_det + p] = p < n_kept;
    if (p >= n_kept) oi[p] = 0;
  }
}

}  // namespace

// boxes (B, K, 4) f32 score-sorted xyxy, 16-byte aligned; valid (B, K)
// bool bytes; mask scratch (B, ceil(K/64) + 1, K) u64 (only its
// upper-triangle words and the last plane are written and read); out_idx (B, max_det) int32 positions in the
// sorted order; out_keep (B, max_det) bool bytes.
HDY_EXPORT int nms_keep(const void* boxes, const void* valid, void* mask, void* out_idx,
                        void* out_keep, int B, int K, int max_det, float thr, int device,
                        void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (B == 0 || K == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nwords = (K + 63) / 64;
  const int smem = (2 + 64) * nwords * static_cast<int>(sizeof(u64));   // removed, keep, by
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(nms_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid(nwords * (nwords + 1) / 2, B);
  nms_mask_kernel<<<grid, MASK_THREADS, 0, s>>>(static_cast<const float4*>(boxes),
                                      static_cast<const uint8_t*>(valid), K, nwords, thr,
                                      static_cast<u64*>(mask));
  int st = hdy::launch_status();
  if (st) return st;
  nms_sweep_kernel<<<B, SWEEP_THREADS, smem, s>>>(
      static_cast<const uint8_t*>(valid), static_cast<const u64*>(mask), K, nwords, max_det,
      static_cast<int*>(out_idx), static_cast<uint8_t*>(out_keep));
  return hdy::launch_status();
}
