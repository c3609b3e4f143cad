// The single-level ROI-align's sample arithmetic and channel vectors, shared
// by its forward (roi_align_single.cu) and its backward
// (roi_align_single_bwd.cu), so both see the same bins.
#pragma once

#include "roi_taps.cuh"

namespace hdy {

// 16-byte vectors (8 bf16 or 4 f32 channels) or single elements, as f32.
template <typename T, int V> struct Vec;

template <> struct Vec<__nv_bfloat16, 8> {
  using Raw = uint4;
  static __device__ __forceinline__ void unpack(const Raw u, float* v) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ Raw pack(const float* v) {
    Raw u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    return u;
  }
};

template <> struct Vec<float, 4> {
  using Raw = uint4;
  static __device__ __forceinline__ void unpack(const Raw u, float* v) {
    v[0] = __uint_as_float(u.x);
    v[1] = __uint_as_float(u.y);
    v[2] = __uint_as_float(u.z);
    v[3] = __uint_as_float(u.w);
  }
  static __device__ __forceinline__ Raw pack(const float* v) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                      __float_as_uint(v[3]));
  }
};

template <> struct Vec<__nv_bfloat16, 1> {
  using Raw = __nv_bfloat16;
  static __device__ __forceinline__ void unpack(const Raw u, float* v) { v[0] = __bfloat162float(u); }
  static __device__ __forceinline__ Raw pack(const float* v) { return __float2bfloat16_rn(v[0]); }
};

template <> struct Vec<float, 1> {
  using Raw = float;
  static __device__ __forceinline__ void unpack(const Raw u, float* v) { v[0] = u; }
  static __device__ __forceinline__ Raw pack(const float* v) { return v[0]; }
};

// Sample s of the M·n along an axis that starts at `start`, `bin` apart:
// start + (s + 0.5)·bin with explicit _rn intrinsics in the plain version's
// op order, so no FMA contraction moves a sample across a tap or range
// boundary.
__device__ __forceinline__ float axis_sample(float start, float bin, int s) {
  return __fadd_rn(start, __fmul_rn(static_cast<float>(s) + 0.5f, bin));
}

// One bin's merged entries on a [0, size) axis: its n samples' taps
// (torchvision aligned=False rules: `sample_taps` with bounds [0, size))
// summed per index in sample order (first appearance order is ascending:
// floor is monotone), divided by n and rounded to the compute dtype (the
// plain version's bf16 matrices); zero weights dropped.  Returns the entry
// count; entries go to idx[0..) / w[0..).
template <bool BF16>
__device__ __forceinline__ int bin_entries(float start, float bin, int p, int n, int size,
                                           short* idx, float* w) {
  const float fsize = static_cast<float>(size);
  int cnt = 0;
  for (int s = p * n; s < (p + 1) * n; ++s) {
    int ti[2];
    float tw[2];
    sample_taps(axis_sample(start, bin, s), 0.f, fsize, size, ti, tw);
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      if (ti[t] < 0) continue;
      int e = cnt - 1;
      while (e >= 0 && idx[e] != ti[t]) --e;
      if (e < 0) {
        idx[cnt] = static_cast<short>(ti[t]);
        w[cnt] = tw[t];
        ++cnt;
      } else {
        w[e] = __fadd_rn(w[e], tw[t]);
      }
    }
  }
  // w / n; for n a power of two the multiply by 1/n is the same rounding
  const bool pow2 = (n & (n - 1)) == 0;
  const float inv = 1.f / static_cast<float>(n);
  int kept = 0;
  for (int e = 0; e < cnt; ++e) {
    float v = pow2 ? w[e] * inv : __fdiv_rn(w[e], static_cast<float>(n));
    if (BF16) v = round_bf16(v);
    if (v != 0.f) {
      idx[kept] = idx[e];
      w[kept] = v;
      ++kept;
    }
  }
  return kept;
}

}  // namespace hdy
