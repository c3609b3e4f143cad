// Multiscale bilinear ROI-align with per-ROI bounds, on the flat packed
// layout: one ROI list across the batch, each ROI with its image, its window
// origin in the level-stacked canvas, and its own valid bounds.
//
// Replaces the TPU kernels hd_yolo_tpu/ops/pallas_roi_align.py
// `_canvas_kernel` / `_canvas_kernel_v4` (reached through
// `multiscale_roi_align_canvas_pallas`), and serves the main path's
// windowed packed pooling (ops/roi_align.py `multiscale_roi_align_packed`).
// Same function as `Wy · F · Wxᵀ` with the bin-pooled bounded
// interpolation matrices of `_bounded_interp_matrix`: per sample coordinate
// c with valid window [lo, hi): in_range = lo-1 < c < hi; c clamps to
// [lo, hi-1]; the two taps floor(c) and min(floor(c)+1, hi-1) get weights
// 1-frac and frac (zero when out of range); a tap outside the gathered
// window [0, win) contributes nothing (the packed path's border truncation);
// each output bin averages its n x n samples.
//
// Bound on an H100: memory.  At the main path's shape (768 ROIs x 14 x 14 x
// 256 bf16) the output is 77 MB and each ROI reads a few feature cells per
// bin; the arithmetic is ~0.6 GFLOP.  Design: one block per ROI.  The block
// first turns its 2·M·n sample coordinates into (index, weight) tap tables in
// shared memory (the matrices' nonzeros: at most 2 per sample, so the dense
// matrices are never formed); then each thread owns a pair of channels and
// walks the M x M bins, accumulating the 4·n·n taps in f32 and writing one
// 2-element store per bin, so a warp reads and writes 128 contiguous bytes.

#include "common.cuh"

namespace {

constexpr int NTHREADS = 128;
constexpr int MAX_S = 64;    // M * n samples per axis

// One axis: sample coord → (idx0, idx1, w0, w1) window-local taps; an index
// of -1 marks a tap with no contribution.
__device__ __forceinline__ void taps(float c, float lo, float hi, int win, float inv_n,
                                     int* i0, int* i1, float* w0, float* w1) {
  const bool in_range = (c > lo - 1.f) && (c < hi);
  const float cc = fminf(fmaxf(c, lo), hi - 1.f);
  const float low = floorf(cc);
  const float lw = cc - low;
  const float high = fminf(low + 1.f, hi - 1.f);
  const bool ok0 = in_range && low >= 0.f && low < static_cast<float>(win);
  const bool ok1 = in_range && high >= 0.f && high < static_cast<float>(win);
  *i0 = ok0 ? static_cast<int>(low) : -1;
  *i1 = ok1 ? static_cast<int>(high) : -1;
  *w0 = ok0 ? (1.f - lw) * inv_n : 0.f;
  *w1 = ok1 ? lw * inv_n : 0.f;
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
roi_align_kernel(const T* __restrict__ canvas, const int4* __restrict__ meta,
                 const float* __restrict__ ys, const float* __restrict__ xs,
                 const float4* __restrict__ bounds, T* __restrict__ out, int Ht, int W0,
                 int C, int win_h, int win_w, int M, int n) {
  __shared__ int yi[MAX_S][2], xi[MAX_S][2];
  __shared__ float yw[MAX_S][2], xw[MAX_S][2];
  const int k = blockIdx.x;
  const int S = M * n;
  const int4 mt = meta[k];                 // (image, oy, ox, -)
  const float4 bd = bounds[k];             // (lo_y, hi_y, lo_x, hi_x) window-local
  const float inv_n = 1.f / static_cast<float>(n);
  for (int s = threadIdx.x; s < 2 * S; s += NTHREADS) {
    if (s < S) {
      taps(ys[static_cast<size_t>(k) * S + s], bd.x, bd.y, win_h, inv_n,
           &yi[s][0], &yi[s][1], &yw[s][0], &yw[s][1]);
    } else {
      const int q = s - S;
      taps(xs[static_cast<size_t>(k) * S + q], bd.z, bd.w, win_w, inv_n,
           &xi[q][0], &xi[q][1], &xw[q][0], &xw[q][1]);
    }
  }
  __syncthreads();

  const T* img = canvas + (static_cast<size_t>(mt.x) * Ht + mt.y) * W0 * C +
                 static_cast<size_t>(mt.z) * C;
  T* o = out + static_cast<size_t>(k) * M * M * C;
  for (int c2 = threadIdx.x; c2 * 2 < C; c2 += NTHREADS) {
    const int c = c2 * 2;
    for (int p = 0; p < M; ++p) {
      for (int q = 0; q < M; ++q) {
        float a0 = 0.f, a1 = 0.f;
        for (int sy = p * n; sy < (p + 1) * n; ++sy) {
#pragma unroll
          for (int ty = 0; ty < 2; ++ty) {
            const int iy = yi[sy][ty];
            const float wy = yw[sy][ty];
            if (iy < 0 || wy == 0.f) continue;
            const T* row = img + static_cast<size_t>(iy) * W0 * C + c;
            for (int sx = q * n; sx < (q + 1) * n; ++sx) {
#pragma unroll
              for (int tx = 0; tx < 2; ++tx) {
                const int ix = xi[sx][tx];
                const float wx = xw[sx][tx];
                if (ix < 0 || wx == 0.f) continue;
                const float wgt = wy * wx;
                a0 += wgt * hdy::to_f32(row[static_cast<size_t>(ix) * C]);
                a1 += wgt * hdy::to_f32(row[static_cast<size_t>(ix) * C + 1]);
              }
            }
          }
        }
        T* dst = o + (static_cast<size_t>(p) * M + q) * C + c;
        dst[0] = hdy::from_f32<T>(a0);
        dst[1] = hdy::from_f32<T>(a1);
      }
    }
  }
}

}  // namespace

// canvas (B, Ht, W0, C) f32|bf16; meta (K, 4) int32 (image, oy, ox, 0);
// ys/xs (K, M*n) f32 window-local sample coords; bounds (K, 4) f32
// (lo_y, hi_y, lo_x, hi_x) window-local; out (K, M, M, C) canvas dtype.
// dtype: 0 f32, 1 bf16.  C must be even, M*n <= 64.
HDY_EXPORT int roi_align_bounded(const void* canvas, const void* meta, const void* ys,
                                 const void* xs, const void* bounds, void* out, int K, int Ht,
                                 int W0, int C, int win_h, int win_w, int M, int n, int dtype,
                                 int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (C % 2 != 0 || M * n > MAX_S) return static_cast<int>(cudaErrorInvalidValue);
  if (K == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    roi_align_kernel<__nv_bfloat16><<<K, NTHREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(canvas), static_cast<const int4*>(meta),
        static_cast<const float*>(ys), static_cast<const float*>(xs),
        static_cast<const float4*>(bounds), static_cast<__nv_bfloat16*>(out), Ht, W0, C, win_h,
        win_w, M, n);
  } else {
    roi_align_kernel<float><<<K, NTHREADS, 0, s>>>(
        static_cast<const float*>(canvas), static_cast<const int4*>(meta),
        static_cast<const float*>(ys), static_cast<const float*>(xs),
        static_cast<const float4*>(bounds), static_cast<float*>(out), Ht, W0, C, win_h, win_w,
        M, n);
  }
  return hdy::launch_status();
}
