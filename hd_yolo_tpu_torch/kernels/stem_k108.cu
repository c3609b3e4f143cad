// The yolov5 stem, silu(conv6x6/s2/p2(x) * scale + bias), as ONE K=108
// tensor-core product: space-to-depth(2) turns the 6x6/s2 conv over 3
// channels into a dense 3x3 conv over 12, and the 9 taps x 12 channels are
// the K = 108 rows of the weight matrix w_108 (tap-major, (108, 64) bf16).
//
// Replaces the TPU kernel tools/stem_lab.py `_k108_kernel` (reached through
// `pallas_k108`), which reads three row-shifted copies of the s2d tensor,
// concatenates the 9 taps along lanes and takes one K=108 MXU dot with the
// BN affine and SiLU fused.  Same function and rounding points: x rounded
// to bf16 (the s2d cast), bf16 weights, f32 accumulation, acc * scale + bias
// and SiLU in f32, one bf16 write.
//
// Bound on an H100: memory.  At (16, 640, 640, 3) it reads the f32 image
// (78.6 MB) and writes the (16, 320, 320, 64) bf16 map (209.7 MB) while doing
// 22.6 GFLOP of bf16 products (0.023 ms at 989 TFLOP/s, against 0.086 ms of
// bytes).  Design: the kernel reads x itself (no s2d tensor in device
// memory).  One block per (image, band of `bh` output rows) stages the bh + 2
// s2d rows it needs, 12 channels each, rounded to bf16, in shared memory
// (zero outside the image): the TPU's row-shifted copies become row offsets
// into that band.  Each warp takes 16-pixel m-tiles of the band; a lane
// builds its im2col A fragments straight from the band, one 32-bit load per
// bf16 pair (a pair never straddles a tap, 12 being even), K zero-padded to
// 112 = 7 mma.sync m16n8k16 steps against the resident w_108 fragments
// (14 KB).  The epilogue fuses scale, bias and SiLU and writes each m-tile's
// 16 x 64 bf16 outputs (2 KB, contiguous) with 16-byte stores.

#include "stem108.cuh"

namespace {

using namespace hdy::k108;

constexpr int CIN = 3, S = 2, P = 2, KS = 3;
constexpr int CS = S * S * CIN;  // 12 s2d channels

__global__ void __launch_bounds__(NTHREADS, 2)
k108_kernel(const float* __restrict__ x, const __nv_bfloat16* __restrict__ w,
            const float* __restrict__ scale, const float* __restrict__ bias,
            __nv_bfloat16* __restrict__ y, int H, int W, int Hout, int Wout, int bh) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* bfrag = reinterpret_cast<uint32_t*>(smem);
  uint32_t* stage = reinterpret_cast<uint32_t*>(smem + BFRAG_BYTES);
  float* sc = reinterpret_cast<float*>(smem + BFRAG_BYTES + NWARPS * STAGE_BYTES);
  float* bi = sc + N;
  __nv_bfloat16* band = reinterpret_cast<__nv_bfloat16*>(smem + FIXED_SMEM);

  const int WS = Wout + KS - 1;  // s2d columns
  const int b = blockIdx.y, oy0 = blockIdx.x * bh;
  load_weights(w, scale, bias, bfrag, sc, bi);

  // The band: s2d rows oy0 .. oy0 + bh + 1, i.e. x rows 2*oy0 - P + jr for
  // jr < 2 * (bh + 2), x columns -P .. 2*WS - 1 - P; s2d channel
  // (dy * 2 + dx) * 3 + c of (row, col) holds x[2*row + dy - P][2*col + dx - P][c].
  const int rowlen = S * WS * CIN;
  const int total = S * (bh + KS - 1) * rowlen;
  const float* xb = x + static_cast<size_t>(b) * H * W * CIN;
  for (int i = threadIdx.x; i < total; i += NTHREADS) {
    const int jr = i / rowlen, e = i - jr * rowlen;
    const int yy = S * oy0 - P + jr;
    const int xx = e / CIN - P, c = e - (e / CIN) * CIN;
    float v = 0.f;
    if (yy >= 0 && yy < H && xx >= 0 && xx < W) v = xb[(static_cast<size_t>(yy) * W + xx) * CIN + c];
    const int br = jr >> 1, dy = jr & 1, col = (xx + P) >> 1, dx = (xx + P) & 1;
    band[(br * WS + col) * CS + (dy * S + dx) * CIN + c] = __float2bfloat16_rn(v);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // word offset (bf16 pair) of this lane's A columns k = 16*ks + 2t + 8h
  // from the pixel's tap (0, 0); -1 for the zero padding k >= 108
  int koff[KSTEPS][2];
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = ks * 16 + 2 * t + 8 * h;
      const int tap = k / CS, ch = k - tap * CS;
      koff[ks][h] = k < KDIM ? (((tap / KS) * WS + tap % KS) * CS + ch) >> 1 : -1;
    }
  const uint32_t* bw = reinterpret_cast<const uint32_t*>(band);
  const int mpr = (Wout + 15) / 16;  // m-tiles per output row
  const int nrow = min(bh, Hout - oy0);
  for (int mt = warp; mt < nrow * mpr; mt += NWARPS) {
    const int oyl = mt / mpr, ox0 = (mt - oyl * mpr) * 16;
    // rows past the image's last column read its last pixel; they are not written
    const int p0 = (oyl * WS + min(ox0 + g, Wout - 1)) * (CS / 2);
    const int p1 = (oyl * WS + min(ox0 + g + 8, Wout - 1)) * (CS / 2);
    uint32_t a[KSTEPS][4];
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      const int k0 = koff[ks][0], k1 = koff[ks][1];
      a[ks][0] = k0 >= 0 ? bw[p0 + k0] : 0u;
      a[ks][1] = k0 >= 0 ? bw[p1 + k0] : 0u;
      a[ks][2] = k1 >= 0 ? bw[p0 + k1] : 0u;
      a[ks][3] = k1 >= 0 ? bw[p1 + k1] : 0u;
    }
    float acc[NT][4];
    tile_product(acc, a, bfrag, lane);
    store_tile(acc, sc, bi, stage + warp * (STAGE_BYTES / 4), lane,
               y + ((static_cast<size_t>(b) * Hout + oy0 + oyl) * Wout + ox0) * N,
               min(16, Wout - ox0));
  }
}

}  // namespace

// x (B, H, W, 3) f32 NHWC; w108 (108, 64) bf16 tap-major; scale/bias (64,)
// f32; y (B, Hout, Wout, 64) bf16 with Hout/Wout those of the 6x6/s2/p2
// conv.  bh: output rows per block.
HDY_EXPORT int stem_k108(const void* x, const void* w108, const void* scale, const void* bias,
                         void* y, int B, int H, int W, int Hout, int Wout, int bh, int device,
                         void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (bh < 1 || Hout < 1 || Wout < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = FIXED_SMEM + static_cast<size_t>(bh + KS - 1) * (Wout + KS - 1) * CS * 2;
  e = cudaFuncSetAttribute(k108_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((Hout + bh - 1) / bh, B);
  k108_kernel<<<grid, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const __nv_bfloat16*>(w108),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(y), H, W, Hout, Wout, bh);
  return hdy::launch_status();
}
