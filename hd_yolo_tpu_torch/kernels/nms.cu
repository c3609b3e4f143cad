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
// time goes to the sequential sweep, whose length is the number of kept
// boxes.  Design (the CUDA form of the TPU's tiled sweep):
//   1. nms_mask_kernel: one 64-thread block per (image, 64-row block,
//      64-col block) writes the conflict bits of its rows as one u64 word per
//      row — the (K, K/64) bitmask, upper triangle only.
//   2. nms_sweep_kernel: one warp per image walks the words in order.  The
//      removed set lives in shared memory as K/64 words; each surviving box
//      ORs its conflict row into it, one word per lane, so a kept box costs
//      one coalesced row read instead of K comparisons.  The same warp
//      then compacts the keep bits with popcounts into idx/keep.

#include "common.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;

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

__global__ void __launch_bounds__(64)
nms_mask_kernel(const float4* __restrict__ boxes, const uint8_t* __restrict__ valid, int K,
                int nwords, float thr, unsigned long long* __restrict__ mask) {
  const int b = blockIdx.z, rb = blockIdx.y, cb = blockIdx.x, t = threadIdx.x;
  __shared__ float4 cbox[64];
  __shared__ uint8_t cval[64];
  const int col = cb * 64 + t;
  if (col < K) {
    cbox[t] = boxes[static_cast<size_t>(b) * K + col];
    cval[t] = valid[static_cast<size_t>(b) * K + col];
  } else {
    cbox[t] = make_float4(0.f, 0.f, 0.f, 0.f);
    cval[t] = 0;
  }
  __syncthreads();
  const int row = rb * 64 + t;
  if (row >= K) return;
  unsigned long long bits = 0ull;
  if (cb >= rb && valid[static_cast<size_t>(b) * K + row]) {
    const float4 r = boxes[static_cast<size_t>(b) * K + row];
    const int ncol = min(64, K - cb * 64);
    for (int j = 0; j < ncol; ++j) {
      if (cb * 64 + j > row && cval[j] && iou(r, cbox[j]) > thr) bits |= 1ull << j;
    }
  }
  mask[(static_cast<size_t>(b) * K + row) * nwords + cb] = bits;
}

__global__ void __launch_bounds__(32)
nms_sweep_kernel(const uint8_t* __restrict__ valid, const unsigned long long* __restrict__ mask,
                 int K, int nwords, int max_det, int* __restrict__ out_idx,
                 uint8_t* __restrict__ out_keep) {
  extern __shared__ unsigned long long words[];
  unsigned long long* removed = words;            // (nwords,)
  unsigned long long* keepw = words + nwords;     // (nwords,)
  const int b = blockIdx.x, lane = threadIdx.x;
  const uint8_t* v = valid + static_cast<size_t>(b) * K;
  const unsigned long long* m = mask + static_cast<size_t>(b) * K * nwords;

  // invalid and past-the-end slots start out removed
  for (int w = 0; w < nwords; ++w) {
    const int i0 = w * 64 + lane, i1 = i0 + 32;
    const unsigned lo = __ballot_sync(FULL, i0 < K && v[i0]);
    const unsigned hi = __ballot_sync(FULL, i1 < K && v[i1]);
    if (lane == 0) {
      removed[w] = ~((static_cast<unsigned long long>(hi) << 32) | lo);
      keepw[w] = 0ull;
    }
  }
  __syncwarp();

  for (int w = 0; w < nwords; ++w) {
    unsigned long long cand = ~removed[w];
    while (cand) {
      const int bit = __ffsll(static_cast<long long>(cand)) - 1;
      const int i = w * 64 + bit;
      if (lane == 0) keepw[w] |= 1ull << bit;
      const unsigned long long* row = m + static_cast<size_t>(i) * nwords;
      for (int u = w + lane; u < nwords; u += 32) removed[u] |= row[u];
      __syncwarp();
      // candidates left in this word: above `bit` and not removed
      cand = ~removed[w] & ~((2ull << bit) - 1ull);
      __syncwarp();
    }
  }

  int base = 0;
  int* oi = out_idx + static_cast<size_t>(b) * max_det;
  for (int w = 0; w < nwords; ++w) {
    const unsigned long long kw = keepw[w];
    for (int half = 0; half < 2; ++half) {
      const int bit = half * 32 + lane;
      if ((kw >> bit) & 1ull) {
        const int rank = base + __popcll(kw & ((1ull << bit) - 1ull));
        if (rank < max_det) oi[rank] = w * 64 + bit;
      }
    }
    base += __popcll(kw);
  }
  const int n_kept = min(base, max_det);
  for (int p = lane; p < max_det; p += 32) {
    out_keep[static_cast<size_t>(b) * max_det + p] = p < n_kept;
    if (p >= n_kept) oi[p] = 0;
  }
}

}  // namespace

// boxes (B, K, 4) f32 score-sorted xyxy; valid (B, K) uint8; mask scratch
// (B, K, ceil(K/64)) u64; out_idx (B, max_det) int32 positions in the
// sorted order; out_keep (B, max_det) uint8.
HDY_EXPORT int nms_keep(const void* boxes, const void* valid, void* mask, void* out_idx,
                        void* out_keep, int B, int K, int max_det, float thr, int device,
                        void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nwords = (K + 63) / 64;
  dim3 grid(nwords, nwords, B);
  nms_mask_kernel<<<grid, 64, 0, s>>>(static_cast<const float4*>(boxes),
                                      static_cast<const uint8_t*>(valid), K, nwords, thr,
                                      static_cast<unsigned long long*>(mask));
  int st = hdy::launch_status();
  if (st) return st;
  nms_sweep_kernel<<<B, 32, 2 * nwords * sizeof(unsigned long long), s>>>(
      static_cast<const uint8_t*>(valid), static_cast<const unsigned long long*>(mask), K,
      nwords, max_det, static_cast<int*>(out_idx), static_cast<uint8_t*>(out_keep));
  return hdy::launch_status();
}
