// Backward of the bounded multiscale ROI-align (kernels/roi_align.cu) with
// respect to the level maps: the adjoint of `roi_align_bounded`.
//
// Replaces the XLA vjp that hd_yolo_tpu/ops/pallas_roi_align.py
// `_canvas_bwd` takes of the plain canvas form
// (`_multiscale_roi_align_canvas`): the gradient of the mask loss through the
// pooling of its ROIs, on the training path.  The forward pools
//   out[k][p][q][c] = Σ_h Σ_w Wy_k[p][h] · Wx_k[q][w] · F[b_k][h][w][c]
// with the bin-pooled bounded interpolation rows of `_bounded_interp_matrix`
// (the n samples of a bin merged per index in sample order, the mean over n,
// rounded to bf16 for bf16 maps as the forward rounds them); so
//   dF[b_k][h][w][c] += Σ_p Wy_k[p][h] · Σ_q Wx_k[q][w] · g[k][p][q][c]
// over every ROI k below `active`.  Taps outside the window or the ROI's
// bounds carry no weight; the boxes get no gradient.
//
// Bound on an H100: the flagship training step's 1024 ROIs x 14 x 14 x 256
// bf16 output gradient is 103 MB, read once; the level gradient is written
// once (and zeroed, and for bf16 cast from its f32 sums).  Design, simple
// first: one 256-thread block per ROI.  Two threads build the ROI's two axes
// (the taps of each bin merged per level index, then transposed: for each
// distinct level row / column the bins that touch it, with their weights);
// then for each touched (row, column) cell, a thread per channel sums
// Σ_p wy · Σ_q wx · g over the bins that touch it (g read from L1/L2, about
// as many times as the cell has (p, q) pairs) and adds the sum into an f32
// gradient with one atomicAdd.  Atomics, so a relaunch may differ in the
// last bits; a second kernel casts the f32 sums to bf16.

#include "roi_taps.cuh"

namespace {

constexpr int NTHREADS = 256;
constexpr int MAX_S = 64;              // M * n samples per axis
constexpr int MAX_E = 2 * MAX_S;       // tap entries per axis (<= 2 per sample)
constexpr int MAX_L = 8;               // pyramid levels

struct Levels {
  float* acc[MAX_L];                   // f32 gradient of level l, (B, H, W, C)
  int H[MAX_L], W[MAX_L], moff[MAX_L];
  int L;
};

// One ROI axis after transposition: for each distinct level index touched
// (idx[d]), its (bin, weight) pairs in bin[start[d]..start[d+1]).
struct Axis {
  int n_idx;
  int idx[MAX_E];
  int start[MAX_E + 1];
  int bin[MAX_E];
  float w[MAX_E];
};

// One axis of one ROI, by one thread.  Per bin p: its n samples' taps merged
// by level index (weights summed in sample order), the mean over n, rounded
// as the forward rounds (bf16 maps), zeros dropped — the forward's bin
// entries.  Then transposed per distinct level index.  `origin` maps a
// window index to a level index (clamped to [0, size)).
__device__ void build_axis(const float* coords, float lo, float hi, int win, int origin,
                           int size, int M, int n, bool bf16, int* e_idx, float* e_w,
                           int* e_cnt, int* cursor, Axis& ax) {
  for (int p = 0; p < M; ++p) {
    const int base = p * 2 * n;
    int cnt = 0;
    for (int s = p * n; s < (p + 1) * n; ++s) {
      int ti[2];
      float tw[2];
      hdy::sample_taps(coords[s], lo, hi, win, ti, tw);
      for (int t = 0; t < 2; ++t) {
        if (ti[t] < 0) continue;
        const int li = min(max(origin + ti[t], 0), size - 1);
        int e = 0;
        while (e < cnt && e_idx[base + e] != li) ++e;
        if (e == cnt) {
          e_idx[base + cnt] = li;
          e_w[base + cnt] = tw[t];
          ++cnt;
        } else {
          e_w[base + e] += tw[t];
        }
      }
    }
    int kept = 0;
    for (int e = 0; e < cnt; ++e) {
      float w = e_w[base + e] / static_cast<float>(n);
      if (bf16) w = hdy::round_bf16(w);
      if (w != 0.f) {
        e_idx[base + kept] = e_idx[base + e];
        e_w[base + kept] = w;
        ++kept;
      }
    }
    e_cnt[p] = kept;
  }
  // distinct level indices and the count of entries of each
  int nd = 0;
  for (int p = 0; p < M; ++p) {
    for (int e = 0; e < e_cnt[p]; ++e) {
      const int li = e_idx[p * 2 * n + e];
      int d = 0;
      while (d < nd && ax.idx[d] != li) ++d;
      if (d == nd) {
        ax.idx[nd] = li;
        cursor[nd] = 0;
        ++nd;
      }
      ++cursor[d];
    }
  }
  ax.n_idx = nd;
  ax.start[0] = 0;
  for (int d = 0; d < nd; ++d) {
    ax.start[d + 1] = ax.start[d] + cursor[d];
    cursor[d] = ax.start[d];
  }
  for (int p = 0; p < M; ++p) {
    for (int e = 0; e < e_cnt[p]; ++e) {
      const int li = e_idx[p * 2 * n + e];
      int d = 0;
      while (ax.idx[d] != li) ++d;
      ax.bin[cursor[d]] = p;
      ax.w[cursor[d]] = e_w[p * 2 * n + e];
      ++cursor[d];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
roi_align_bwd_kernel(const Levels lv, const T* __restrict__ grad, const int4* __restrict__ meta,
                     const float* __restrict__ ys, const float* __restrict__ xs,
                     const float4* __restrict__ bounds, const long long* __restrict__ active,
                     int K, int C, int win_h, int win_w, int M, int n) {
  __shared__ Axis s_ax[2];               // [0] rows, [1] columns
  __shared__ int s_eidx[2][MAX_E];
  __shared__ float s_ew[2][MAX_E];
  __shared__ int s_ecnt[2][MAX_S];
  __shared__ int s_cursor[2][MAX_E];

  const int k = blockIdx.x, tid = threadIdx.x;
  const long long act = active ? *active : static_cast<long long>(K);
  if (k >= act) return;
  const int S = M * n;
  const int4 mt = meta[k];               // (image, oy, ox, level)
  const float4 bd = bounds[k];           // (lo_y, hi_y, lo_x, hi_x) window-local
  const int l = min(max(mt.w, 0), lv.L - 1);
  const int H = lv.H[l], W = lv.W[l];
  if (tid == 0 || tid == 32) {           // one thread per axis, in two warps
    const int a = tid == 32;
    build_axis((a ? xs : ys) + static_cast<size_t>(k) * S, a ? bd.z : bd.x, a ? bd.w : bd.y,
               a ? win_w : win_h, a ? mt.z : mt.y - lv.moff[l], a ? W : H, M, n,
               sizeof(T) == 2, s_eidx[a], s_ew[a], s_ecnt[a], s_cursor[a], s_ax[a]);
  }
  __syncthreads();

  const Axis& ay = s_ax[0];
  const Axis& ax = s_ax[1];
  const int ny = ay.n_idx, nx = ax.n_idx;
  const T* g = grad + static_cast<size_t>(k) * M * M * C;
  float* dF = lv.acc[l] + static_cast<size_t>(mt.x) * H * W * C;
  for (int cell = 0; cell < ny * nx; ++cell) {
    const int dy = cell / nx, dx = cell - dy * nx;
    float* dst = dF + (static_cast<size_t>(ay.idx[dy]) * W + ax.idx[dx]) * C;
    const int y0 = ay.start[dy], y1 = ay.start[dy + 1];
    const int x0 = ax.start[dx], x1 = ax.start[dx + 1];
    for (int c = tid; c < C; c += NTHREADS) {
      float acc = 0.f;
      for (int a = y0; a < y1; ++a) {
        const T* gp = g + static_cast<size_t>(ay.bin[a]) * M * C + c;
        float u = 0.f;
        for (int b = x0; b < x1; ++b)
          u = fmaf(ax.w[b], hdy::to_f32(gp[static_cast<size_t>(ax.bin[b]) * C]), u);
        acc = fmaf(ay.w[a], u, acc);
      }
      if (acc != 0.f) atomicAdd(dst + c, acc);
    }
  }
}

__global__ void cast_bf16_kernel(const float* __restrict__ src, __nv_bfloat16* __restrict__ dst,
                                 long long count) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < count;
       i += static_cast<long long>(gridDim.x) * blockDim.x)
    dst[i] = __float2bfloat16_rn(src[i]);
}

}  // namespace

// table: host array of L rows (f32 gradient pointer, output pointer, H, W,
// row offset, element count) as int64; each level's gradient (B, H, W, C).
// For f32 maps the output is the f32 gradient itself (same pointer); for
// bf16 maps the f32 sums are cast into the output after the scatter.  grad
// (K, M, M, C) in the maps' dtype; meta (K, 4) int32 (image, oy, ox, level);
// ys/xs (K, M*n) f32 window-local; bounds (K, 4) f32 window-local; active:
// device int64 count of leading ROIs, or null for all K.  dtype: 0 f32,
// 1 bf16.  1 <= L <= 8, M*n <= 64.
HDY_EXPORT int roi_align_bounded_bwd(const long long* table, int L, const void* grad,
                                     const void* meta, const void* ys, const void* xs,
                                     const void* bounds, const void* active, int K, int C,
                                     int win_h, int win_w, int M, int n, int dtype, int device,
                                     void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (L < 1 || L > MAX_L || M < 1 || n < 1 || M * n > MAX_S || C < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Levels lv{};
  lv.L = L;
  for (int i = 0; i < L; ++i) {
    const long long* row = table + 6 * i;
    lv.acc[i] = reinterpret_cast<float*>(row[0]);
    lv.H[i] = static_cast<int>(row[2]);
    lv.W[i] = static_cast<int>(row[3]);
    lv.moff[i] = static_cast<int>(row[4]);
    e = cudaMemsetAsync(lv.acc[i], 0, static_cast<size_t>(row[5]) * sizeof(float), s);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (K > 0) {
    if (dtype == 1)
      roi_align_bwd_kernel<__nv_bfloat16><<<K, NTHREADS, 0, s>>>(
          lv, static_cast<const __nv_bfloat16*>(grad), static_cast<const int4*>(meta),
          static_cast<const float*>(ys), static_cast<const float*>(xs),
          static_cast<const float4*>(bounds), static_cast<const long long*>(active), K, C, win_h,
          win_w, M, n);
    else
      roi_align_bwd_kernel<float><<<K, NTHREADS, 0, s>>>(
          lv, static_cast<const float*>(grad), static_cast<const int4*>(meta),
          static_cast<const float*>(ys), static_cast<const float*>(xs),
          static_cast<const float4*>(bounds), static_cast<const long long*>(active), K, C, win_h,
          win_w, M, n);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (dtype == 1) {
    for (int i = 0; i < L; ++i) {
      const long long* row = table + 6 * i;
      const long long count = row[5];
      const long long want = (count + 255) / 256;
      const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
      if (blocks > 0)
        cast_bf16_kernel<<<blocks, 256, 0, s>>>(reinterpret_cast<const float*>(row[0]),
                                                reinterpret_cast<__nv_bfloat16*>(row[1]), count);
    }
  }
  return hdy::launch_status();
}
