// The bilinear taps of the bounded ROI-align, shared by its forward
// (roi_align.cu) and its backward (roi_align_bwd.cu).
#pragma once

#include "common.cuh"

namespace hdy {

// One sample coordinate → its two window-local taps (index -1: no
// contribution) and their weights, in the op order of
// `_bounded_interp_matrix`; two taps on one index are merged as its
// (grid == low) + (grid == high) sum.
__device__ __forceinline__ void sample_taps(float c, float lo, float hi, int win, int* idx,
                                            float* w) {
  const bool in_range = (c > lo - 1.f) && (c < hi);
  const float cc = fminf(fmaxf(c, lo), hi - 1.f);
  const float low = floorf(cc);
  const float lw = cc - low;
  const float high = fminf(low + 1.f, hi - 1.f);
  const float inr = in_range ? 1.f : 0.f;
  const float a = (1.f - lw) * inr, b = lw * inr;
  const bool ok0 = in_range && low >= 0.f && low < static_cast<float>(win);
  const bool ok1 = in_range && high >= 0.f && high < static_cast<float>(win);
  if (high == low) {
    idx[0] = ok0 ? static_cast<int>(low) : -1;
    w[0] = a + b;
    idx[1] = -1;
    w[1] = 0.f;
  } else {
    idx[0] = ok0 ? static_cast<int>(low) : -1;
    w[0] = a;
    idx[1] = ok1 ? static_cast<int>(high) : -1;
    w[1] = b;
  }
}

}  // namespace hdy
