// Inference mask head in f32: the f32 form of mask_head.cu.  The same chain
// (4 x (3x3 conv 256->256 + bias + ReLU), the 2x2/stride-2 deconv as 4 taps
// + bias + ReLU, the dot with each ROI's selected logits column, + its bias,
// sigmoid, written as (N, 28, 28) f32), every operand and accumulator in
// f32, as an f32 model computes it.
//
// Replaces the TPU kernel hd_yolo_tpu/ops/pallas_mask_head.py `_kernel` for
// f32 features: that kernel computes in the pooled dtype, and mask_head.cu
// takes bf16 only.
//
// Bound on an H100: operations.  Per ROI the chain is ~1.03 GFLOP
// (4 x 196 x 2304 x 256 x 2 + 4 x 196 x 256 x 256 x 2) of f32 FMA against
// 0.2 MB of input and 3 KB of output.
//
// Design: five launches of one tiled SIMT GEMM and a small epilogue launch,
// all from one entry point on the caller's stream.  Each layer is a product
// of (196 pixels x K) activations and (K x 256) weights per ROI: the convs
// as an implicit GEMM over K = 9 taps x 256 channels (the tap's halo rows
// read as zeros), the deconv as one product with K = 256 and its four taps
// side by side as 1024 columns.  A block owns one ROI's 128-pixel x
// 64-column tile (196 pixels padded to 256, two tiles), streams K in slices
// of 16 through two shared-memory buffers (the next slice loaded into
// registers while the current one is multiplied), and a thread accumulates
// 8 pixels x 4 columns.  The activations between layers go through the
// caller's workspace (two (N, 196, 256) f32 buffers, L2-resident at the
// fixtures' sizes).  The deconv's epilogue applies bias, ReLU and the
// selected logits column and reduces each pixel's 64 columns (thread, then
// shuffles in a fixed order) to one partial per (pixel, tap, column tile);
// the last launch sums the four partials in order with the bias and writes
// the sigmoid: no atomics, two launches give bit-identical output.  ROIs at
// or past `active` (read from device memory) are skipped and written as 0.

#include "common.cuh"

namespace {

constexpr int M = 14;
constexpr int MM = M * M;                 // 196 pixels
constexpr int C = 256;
constexpr int BM = 128;                   // pixels per block tile
constexpr int BN = 64;                    // output columns per block tile
constexpr int BK = 16;                    // k per slice
constexpr int LDA = BM + 4;               // padded row of the A slice (16-byte aligned)
constexpr int NTHREADS = 256;
constexpr int TM = 8;                     // pixels per thread
constexpr int TN = 4;                     // columns per thread
constexpr int PX_TILES = 2;               // 196 pixels in tiles of 128
constexpr int CONV_COLS = C;              // a conv's output columns
constexpr int DECONV_COLS = 4 * C;        // the deconv's 4 taps x 256
constexpr int NPART = DECONV_COLS / BN;   // partials per pixel: 4 taps x 4 column tiles
constexpr int OUT = 2 * M;                // 28

__device__ __forceinline__ int active_count(const long long* active, int N) {
  if (active == nullptr) return N;
  const long long a = *active;
  return a < 0 ? 0 : (a > N ? N : static_cast<int>(a));
}

// One layer for ROI blockIdx.x: y = relu(x * W + b) for a conv (kDeconv
// false; K = 9 taps x 256, W as (9, ci, co)), or the deconv's selected-logit
// partials (kDeconv true; K = 256, W as (ci, 4 x 256)).
template <bool kDeconv>
__global__ void __launch_bounds__(NTHREADS)
layer_kernel(const float* __restrict__ x, const float* __restrict__ w,
             const float* __restrict__ b, float* __restrict__ y,
             const float* __restrict__ wl, const long long* __restrict__ labels,
             int N, const long long* __restrict__ active) {
  constexpr int COLS = kDeconv ? DECONV_COLS : CONV_COLS;
  constexpr int TAPS = kDeconv ? 1 : 9;
  constexpr int NSLICES = TAPS * (C / BK);
  const int roi = blockIdx.x;
  if (roi >= active_count(active, N)) return;
  const int px_tile = blockIdx.y % PX_TILES;
  const int col0 = (blockIdx.y / PX_TILES) * BN;

  __shared__ __align__(16) float As[2][BK][LDA];
  __shared__ __align__(16) float Bs[2][BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const float* xr = x + static_cast<size_t>(roi) * MM * C;

  // this thread's two A chunks (pixel, 4 channels) and one B chunk per slice
  int a_px[2], a_h[2], a_w[2];
  const int a_c4 = tid % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    a_px[r] = (tid + r * NTHREADS) / 4;
    const int p = px_tile * BM + a_px[r];
    a_h[r] = p < MM ? p / M : -100;     // padded rows read as zeros
    a_w[r] = p % M;
  }
  const int b_k = tid / 16, b_c4 = tid % 16;

  auto load = [&](int s, float4 (&ra)[2], float4& rb) {
    const int tap = s / (C / BK), kc = (s % (C / BK)) * BK;
    const int dy = kDeconv ? 1 : tap / 3, dx = kDeconv ? 1 : tap % 3;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int sh = a_h[r] + dy - 1, sw = a_w[r] + dx - 1;
      ra[r] = (sh >= 0 && sh < M && sw >= 0 && sw < M)
                  ? *reinterpret_cast<const float4*>(xr + (sh * M + sw) * C + kc + a_c4 * 4)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    rb = *reinterpret_cast<const float4*>(
        w + static_cast<size_t>(tap * C + kc + b_k) * COLS + col0 + b_c4 * 4);
  };
  auto store = [&](int buf, const float4 (&ra)[2], const float4& rb) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      As[buf][a_c4 * 4 + 0][a_px[r]] = ra[r].x;
      As[buf][a_c4 * 4 + 1][a_px[r]] = ra[r].y;
      As[buf][a_c4 * 4 + 2][a_px[r]] = ra[r].z;
      As[buf][a_c4 * 4 + 3][a_px[r]] = ra[r].w;
    }
    *reinterpret_cast<float4*>(&Bs[buf][b_k][b_c4 * 4]) = rb;
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  float4 ra[2], rb;
  load(0, ra, rb);
  store(0, ra, rb);
  __syncthreads();
  for (int s = 0; s < NSLICES; ++s) {
    const int buf = s & 1;
    if (s + 1 < NSLICES) load(s + 1, ra, rb);
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][k][ty * TM]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[buf][k][ty * TM + 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[buf][k][tx * TN]);
      const float av[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bw[TN] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bw[j], acc[i][j]);
    }
    if (s + 1 < NSLICES) store(buf ^ 1, ra, rb);
    __syncthreads();
  }

  const int p0 = px_tile * BM + ty * TM;
  const int c0 = col0 + tx * TN;
  if constexpr (!kDeconv) {
    const float4 bias = *reinterpret_cast<const float4*>(b + c0);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      if (p0 + i < MM) {
        float4 v;
        v.x = fmaxf(acc[i][0] + bias.x, 0.f);
        v.y = fmaxf(acc[i][1] + bias.y, 0.f);
        v.z = fmaxf(acc[i][2] + bias.z, 0.f);
        v.w = fmaxf(acc[i][3] + bias.w, 0.f);
        *reinterpret_cast<float4*>(y + (static_cast<size_t>(roi) * MM + p0 + i) * C + c0) = v;
      }
    }
  } else {
    const int co = c0 % C;
    const float4 bias = *reinterpret_cast<const float4*>(b + co);
    const float4 wv = *reinterpret_cast<const float4*>(wl + labels[roi] * C + co);
    const float bb[TN] = {bias.x, bias.y, bias.z, bias.w};
    const float ww[TN] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < TN; ++j) s += fmaxf(acc[i][j] + bb[j], 0.f) * ww[j];
      // the 16 column groups of a pixel row lie in one half-warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      if (tx == 0 && p0 + i < MM)
        y[(static_cast<size_t>(roi) * MM + p0 + i) * NPART + blockIdx.y / PX_TILES] = s;
    }
  }
}

// out[n, 2i+dy, 2j+dx] = sigmoid(sum of the 4 column-tile partials of tap
// dy*2+dx at pixel (i, j) + the ROI's logits bias); 0 past `active`.
__global__ void __launch_bounds__(NTHREADS)
finish_kernel(const float* __restrict__ part, const float* __restrict__ bl,
              const long long* __restrict__ labels, float* __restrict__ out, int N,
              const long long* __restrict__ active) {
  const int idx = blockIdx.x * NTHREADS + threadIdx.x;
  if (idx >= N * OUT * OUT) return;
  const int roi = idx / (OUT * OUT), r = idx % (OUT * OUT);
  if (roi >= active_count(active, N)) {
    out[idx] = 0.f;
    return;
  }
  const int oy = r / OUT, ox = r % OUT;
  const int p = (oy / 2) * M + ox / 2, d = (oy % 2) * 2 + ox % 2;
  const float* q = part + (static_cast<size_t>(roi) * MM + p) * NPART + d * (C / BN);
  float s = q[0];
#pragma unroll
  for (int t = 1; t < C / BN; ++t) s += q[t];
  s += bl[labels[roi]];
  out[idx] = 1.f / (1.f + expf(-s));
}

}  // namespace

// pooled (N, 14, 14, 256) f32; wf (4, 9, 256 ci, 256 co) f32; bf (4, 256);
// wd (256 ci, 4 x 256) with column (dy*2+dx)*256 + co; bd (256); wl
// (classes, 256) f32; bl (classes); labels (N) int64; out (N, 28, 28) f32;
// active: int64 device scalar or null; work: 2 x N x 196 x 256 + N x 196 x
// 16 f32.
HDY_EXPORT int mask_head_f32(const void* pooled, const void* wf, const void* bf, const void* wd,
                             const void* bd, const void* wl, const void* bl, const void* labels,
                             void* out, const void* active, void* work, int N, int device,
                             void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (N == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long* act = static_cast<const long long*>(active);
  const long long* lab = static_cast<const long long*>(labels);
  float* buf[2] = {static_cast<float*>(work), static_cast<float*>(work) + static_cast<size_t>(N) * MM * C};
  float* part = buf[1] + static_cast<size_t>(N) * MM * C;
  const float* src = static_cast<const float*>(pooled);
  for (int l = 0; l < 4; ++l) {
    layer_kernel<false><<<dim3(N, PX_TILES * CONV_COLS / BN), NTHREADS, 0, st>>>(
        src, static_cast<const float*>(wf) + static_cast<size_t>(l) * 9 * C * C,
        static_cast<const float*>(bf) + l * C, buf[l & 1], nullptr, lab, N, act);
    src = buf[l & 1];
  }
  layer_kernel<true><<<dim3(N, PX_TILES * DECONV_COLS / BN), NTHREADS, 0, st>>>(
      src, static_cast<const float*>(wd), static_cast<const float*>(bd), part,
      static_cast<const float*>(wl), lab, N, act);
  finish_kernel<<<(N * OUT * OUT + NTHREADS - 1) / NTHREADS, NTHREADS, 0, st>>>(
      part, static_cast<const float*>(bl), lab, static_cast<float*>(out), N, act);
  return hdy::launch_status();
}
