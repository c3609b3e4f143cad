// Single-level bilinear ROI-align: (B, K) boxes, each pooled from its own
// image's (H, W, C) map into an M x M grid of n x n-sample bins.
//
// Replaces the TPU kernel hd_yolo_tpu/ops/pallas_roi_align.py `_kernel`
// (reached through `roi_align_pallas` / `_roi_align_pallas_impl`), the
// Pallas form of the JAX `roi_align` (`Wy · F · Wxᵀ` with interpolation
// matrices built in VMEM).  Same function, not the same blocks: per output
// bin, the mean of its n x n bilinear samples, torchvision `aligned=False`
// rules (`_sample_weights`): sample centres y1 + (s + 0.5)·roi_h / (M·n),
// roi_w/h at least 1; a sample outside (-1, size) contributes zero; an
// in-range coordinate clamps to [0, size-1] and its taps are floor(c) and
// min(floor(c) + 1, size-1).  The coordinates use explicit _rn intrinsics
// in the plain version's op order, so no FMA contraction moves a sample
// across a tap or range boundary.  Everything stays f32 until the single
// output write (the plain version rounds its matrices and row intermediate
// to bf16, as the JAX path does), so bf16 agrees to bf16 rounding.
//
// Bound on an H100: memory.  hnet-nucls pools each of four pyramid levels
// (4, S, S, 256) bf16 once with one ROI per image at M = S and n = 2: the
// input is read and an output of the same size written, 139 MB per forward
// over the four launches (~0.04 ms at 3.35 TB/s); the arithmetic, 16
// multiply-adds per output element, is ~5x below that.  Design: one block
// per (image, ROI, output row); each thread owns one output column and 8
// channels (16-byte bf16 loads, neighbouring threads on neighbouring
// channels, so a warp reads 512 contiguous bytes per tap), recomputes its
// taps in registers and accumulates in f32.  Neighbouring outputs share
// taps, which the L1 and L2 caches serve.  There is no cap on M·n (level 0
// samples 320 per axis), and any C works: C % 8 != 0 takes a scalar path.

#include <climits>

#include "common.cuh"

namespace {

constexpr int NTHREADS = 256;

struct Taps {
  int i0, i1;
  float w0, w1;
};

// Sample s of the M·n along an axis that starts at `start`, `bin` apart →
// its two taps on [0, size) and their weights (zero when out of range).
__device__ __forceinline__ Taps sample_taps(float start, float bin, int s, int size) {
  const float c = __fadd_rn(start, __fmul_rn(static_cast<float>(s) + 0.5f, bin));
  const float fsize = static_cast<float>(size);
  const bool in_range = (c > -1.f) && (c < fsize);
  const float cc = fminf(fmaxf(c, 0.f), fsize - 1.f);
  const float low = floorf(cc);
  const float lw = __fsub_rn(cc, low);
  Taps t;
  t.i0 = static_cast<int>(low);
  t.i1 = min(t.i0 + 1, size - 1);
  t.w0 = in_range ? __fsub_rn(1.f, lw) : 0.f;
  t.w1 = in_range ? lw : 0.f;
  return t;
}

// V consecutive channels → f32, and back.
template <int V>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* v) {
  if constexpr (V == 8) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = __bfloat162float(p[i]);
  }
}

template <int V>
__device__ __forceinline__ void load_vec(const float* p, float* v) {
  if constexpr (V == 8) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = __ldg(p + i);
  }
}

template <int V>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* v) {
  if constexpr (V == 8) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = raw;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = __float2bfloat16_rn(v[i]);
  }
}

template <int V>
__device__ __forceinline__ void store_vec(float* p, const float* v) {
  if constexpr (V == 8) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = v[i];
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(NTHREADS)
roi_align_single_kernel(const T* __restrict__ feat, const float4* __restrict__ boxes,
                        T* __restrict__ out, int H, int W, int C, int K, int M, int n,
                        float scale, int aligned) {
  const int p = blockIdx.x % M;            // output row
  const int bk = blockIdx.x / M;           // image * K + ROI
  const int b = bk / K;
  const float4 box = boxes[bk];
  const float off = aligned ? 0.5f : 0.f;
  const float x1 = __fsub_rn(__fmul_rn(box.x, scale), off);
  const float y1 = __fsub_rn(__fmul_rn(box.y, scale), off);
  float roi_w = __fsub_rn(__fsub_rn(__fmul_rn(box.z, scale), off), x1);
  float roi_h = __fsub_rn(__fsub_rn(__fmul_rn(box.w, scale), off), y1);
  if (!aligned) {
    roi_w = fmaxf(roi_w, 1.f);
    roi_h = fmaxf(roi_h, 1.f);
  }
  const float S = static_cast<float>(M * n);
  const float bin_w = __fdiv_rn(roi_w, S);
  const float bin_h = __fdiv_rn(roi_h, S);
  const float inv = 1.f / static_cast<float>(n * n);
  const T* img = feat + static_cast<size_t>(b) * H * W * C;
  T* orow = out + static_cast<size_t>(blockIdx.x) * M * C;
  const int CV = C / V;

  for (int t = threadIdx.x; t < M * CV; t += blockDim.x) {
    const int q = t / CV;                  // output column
    const int c = (t - q * CV) * V;
    float acc[V];
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = 0.f;
    for (int sy = p * n; sy < (p + 1) * n; ++sy) {
      const Taps ty = sample_taps(y1, bin_h, sy, H);
      for (int sx = q * n; sx < (q + 1) * n; ++sx) {
        const Taps tx = sample_taps(x1, bin_w, sx, W);
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          const float wy = a ? ty.w1 : ty.w0;
          if (wy == 0.f) continue;
          const T* row = img + static_cast<size_t>(a ? ty.i1 : ty.i0) * W * C + c;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float wx = e ? tx.w1 : tx.w0;
            if (wx == 0.f) continue;
            float v[V];
            load_vec<V>(row + static_cast<size_t>(e ? tx.i1 : tx.i0) * C, v);
            const float w = wy * wx;
#pragma unroll
            for (int i = 0; i < V; ++i) acc[i] = fmaf(w, v[i], acc[i]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] *= inv;
    store_vec<V>(orow + static_cast<size_t>(q) * C + c, acc);
  }
}

template <typename T>
void launch(const void* feat, const void* boxes, void* out, int rows, int H, int W, int C, int K,
            int M, int n, float scale, int aligned, cudaStream_t s) {
  const bool vec = C % 8 == 0 && reinterpret_cast<uintptr_t>(feat) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int work = M * (vec ? C / 8 : C);
  const int threads = work >= NTHREADS ? NTHREADS : ((work + 31) / 32) * 32;
  const T* f = static_cast<const T*>(feat);
  const float4* bx = static_cast<const float4*>(boxes);
  T* o = static_cast<T*>(out);
  if (vec) {
    roi_align_single_kernel<T, 8><<<rows, threads, 0, s>>>(f, bx, o, H, W, C, K, M, n, scale,
                                                            aligned);
  } else {
    roi_align_single_kernel<T, 1><<<rows, threads, 0, s>>>(f, bx, o, H, W, C, K, M, n, scale,
                                                            aligned);
  }
}

}  // namespace

// feat (B, H, W, C) f32|bf16; boxes (B, K, 4) f32 xyxy in image coordinates;
// out (B, K, M, M, C) feat dtype.  dtype: 0 f32, 1 bf16.  aligned: 0 is
// torchvision's legacy aligned=False.
HDY_EXPORT int roi_align_single(const void* feat, const void* boxes, void* out, int B, int H,
                                int W, int C, int K, int M, int n, float scale, int aligned,
                                int dtype, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (H < 1 || W < 1 || C < 1 || M < 1 || n < 1 || B < 0 || K < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = static_cast<long long>(B) * K * M;
  if (rows == 0) return 0;
  if (rows > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    launch<__nv_bfloat16>(feat, boxes, out, static_cast<int>(rows), H, W, C, K, M, n, scale,
                          aligned, s);
  } else {
    launch<float>(feat, boxes, out, static_cast<int>(rows), H, W, C, K, M, n, scale, aligned, s);
  }
  return hdy::launch_status();
}
