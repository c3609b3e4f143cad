// Stem convolution: KxK/stride-S conv (zero padding P) + folded inference
// BatchNorm affine + SiLU, NHWC in and out.
//
// Replaces the TPU kernel hd_yolo_tpu/ops/pallas_stem.py `_stem_kernel`
// (reached through `stem_conv_pallas`).  It computes the same function:
// y[b,oy,ox,n] = silu(scale[n] * sum_{ky,kx,c} x[b, oy*S+ky-P, ox*S+kx-P, c]
//                * w[ky,kx,c,n] + bias[n]), with the inputs rounded to bf16
// when the model computes in bf16, f32 accumulation, and one output write.
//
// Bound on an H100: memory.  The yolov5 stem at batch 16 x 640 px reads the
// f32 image (79 MB) and writes the (16,320,320,64) bf16 map (210 MB) while
// doing ~23 GFLOP of f32 FMA, so a kernel that streams each input byte once
// and writes each output once is near its bound.  Design: one block owns a
// TH x TW tile of output pixels for all N channels.  It stages the
// tile's input window (TH-1)*S+K rows x (TW-1)*S+K cols x C, zero-filled
// outside the image, and the whole K*K*C*N weight tensor in shared memory,
// so every global byte is read once per block.  A thread accumulates PPT
// pixels x 8 channels in registers (32 f32), reads its 8 weights as two
// float4 and each input value once per tap, and writes its 8 channels as one
// 16-byte store (bf16) so neighbouring threads write neighbouring bytes.

#include "common.cuh"

namespace {

constexpr int TH = 4;    // output rows per block
constexpr int TW = 64;   // output cols per block
constexpr int PPT = 4;   // output pixels per thread unit
constexpr int NTHREADS = 256;

template <typename Tout>
__global__ void __launch_bounds__(NTHREADS)
stem_kernel(const float* __restrict__ x, const float* __restrict__ w,
            const float* __restrict__ scale, const float* __restrict__ bias,
            Tout* __restrict__ y, int H, int W, int C, int K, int S, int P,
            int N, int Hout, int Wout, int round_in) {
  extern __shared__ __align__(16) float smem[];
  const int G = N / 8;                      // channel groups of 8
  const int win_h = (TH - 1) * S + K;
  const int win_w = (TW - 1) * S + K;
  const int nw = K * K * C * N;
  float* ws = smem;                         // (K, K, C, N)
  float* xs = smem + nw;                    // (win_h, win_w, C)

  const int b = blockIdx.z;
  const int oy0 = blockIdx.y * TH;
  const int ox0 = blockIdx.x * TW;
  const int iy0 = oy0 * S - P;
  const int ix0 = ox0 * S - P;

  for (int i = threadIdx.x; i < nw; i += NTHREADS) ws[i] = w[i];
  const int nin = win_h * win_w * C;
  for (int i = threadIdx.x; i < nin; i += NTHREADS) {
    const int c = i % C;
    const int t = i / C;
    const int xx = t % win_w;
    const int yy = t / win_w;
    const int iy = iy0 + yy;
    const int ix = ix0 + xx;
    float v = 0.f;
    if (iy >= 0 && iy < H && ix >= 0 && ix < W) {
      v = x[((static_cast<size_t>(b) * H + iy) * W + ix) * C + c];
      if (round_in) v = hdy::round_bf16(v);
    }
    xs[i] = v;
  }
  __syncthreads();

  constexpr int PIX = TH * TW;
  constexpr int GROUPS = PIX / PPT;         // pixel groups per tile
  const int units = GROUPS * G;
  for (int u = threadIdx.x; u < units; u += NTHREADS) {
    const int cg = u % G;
    const int pg = u / G;
    int base[PPT];
    float acc[PPT][8];
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      const int p = pg + i * GROUPS;
      base[i] = ((p / TW) * S * win_w + (p % TW) * S) * C;
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    }
    for (int ky = 0; ky < K; ++ky) {
      for (int kx = 0; kx < K; ++kx) {
        const int toff = (ky * win_w + kx) * C;
        for (int c = 0; c < C; ++c) {
          const float* wp = ws + ((ky * K + kx) * C + c) * N + cg * 8;
          const float4 w0 = *reinterpret_cast<const float4*>(wp);
          const float4 w1 = *reinterpret_cast<const float4*>(wp + 4);
#pragma unroll
          for (int i = 0; i < PPT; ++i) {
            const float v = xs[base[i] + toff + c];
            acc[i][0] += v * w0.x; acc[i][1] += v * w0.y;
            acc[i][2] += v * w0.z; acc[i][3] += v * w0.w;
            acc[i][4] += v * w1.x; acc[i][5] += v * w1.y;
            acc[i][6] += v * w1.z; acc[i][7] += v * w1.w;
          }
        }
      }
    }
    float sc[8], bi[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      sc[j] = scale[cg * 8 + j];
      bi[j] = bias[cg * 8 + j];
    }
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      const int p = pg + i * GROUPS;
      const int oy = oy0 + p / TW;
      const int ox = ox0 + p % TW;
      if (oy >= Hout || ox >= Wout) continue;
      float v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float t = acc[i][j] * sc[j] + bi[j];
        v[j] = t / (1.f + expf(-t));                  // SiLU
      }
      Tout* dst = y + ((static_cast<size_t>(b) * Hout + oy) * Wout + ox) * N + cg * 8;
      if constexpr (sizeof(Tout) == 2) {
        __align__(16) __nv_bfloat16 pk[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) pk[j] = __float2bfloat16_rn(v[j]);
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(pk);
      } else {
        reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
        reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
      }
    }
  }
}

template <typename Tout>
int launch(const float* x, const float* w, const float* scale, const float* bias, void* y,
           int B, int H, int W, int C, int K, int S, int P, int N, int Hout, int Wout,
           int round_in, cudaStream_t stream) {
  const int win_h = (TH - 1) * S + K;
  const int win_w = (TW - 1) * S + K;
  const size_t smem = sizeof(float) * (static_cast<size_t>(K) * K * C * N +
                                       static_cast<size_t>(win_h) * win_w * C);
  auto kern = stem_kernel<Tout>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid((Wout + TW - 1) / TW, (Hout + TH - 1) / TH, B);
  kern<<<grid, NTHREADS, smem, stream>>>(x, w, scale, bias, static_cast<Tout*>(y), H, W, C, K, S,
                                         P, N, Hout, Wout, round_in);
  return hdy::launch_status();
}

}  // namespace

// x (B, H, W, C) f32; w (K, K, C, N) f32; scale/bias (N,) f32; y (B, Ho, Wo, N)
// in out_dtype (0 f32, 1 bf16).  round_in: 1 rounds x and w to bf16 before the
// f32 products.  N must be a multiple of 8.
HDY_EXPORT int stem_conv(const void* x, const void* w, const void* scale, const void* bias,
                         void* y, int B, int H, int W, int C, int K, int S, int P, int N,
                         int Hout, int Wout, int out_dtype, int round_in, int device,
                         void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (N % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  if (out_dtype == 1)
    return launch<__nv_bfloat16>(xf, wf, sc, bi, y, B, H, W, C, K, S, P, N, Hout, Wout, round_in, s);
  return launch<float>(xf, wf, sc, bi, y, B, H, W, C, K, S, P, N, Hout, Wout, round_in, s);
}
