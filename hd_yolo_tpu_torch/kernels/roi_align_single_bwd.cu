// Backward of the single-level ROI-align over several maps (kernels/
// roi_align_single.cu) with respect to the maps: each map's gradient from
// the gradient of its pooled output, in one launch for every map.
//
// Replaces the XLA vjp that hd_yolo_tpu/ops/pallas_roi_align.py
// `_roi_align_bwd` takes of the plain single-level form (the backward of
// `roi_align_pallas`'s custom vjp): hnet's per-annotation ROI pyramid
// (`extract_roi_feature_maps`, two calls a training step, bf16, C = 256) and
// the confliction loss's pooling of the seg probabilities (f32, C = 5, 100
// boxes an image, output 28).  The forward pools
//   out[k][p][q][c] = Σ_x Wx_k[q][x] · round(Σ_y Wy_k[p][y] · F[y][x][c])
// with the bin-pooled interpolation rows of the plain version (a bin's n
// samples merged per index in sample order, the mean over n, rounded to bf16
// for bf16 maps); its adjoint, as the plain version's autograd computes it:
//   R_k[p][x][c] = round(Σ_q Wx_k[q][x] · g[k][p][q][c])   (bf16 rounding for bf16 maps)
//   dF[y][x][c]  = Σ_k Σ_p Wy_k[p][y] · R_k[p][x][c]       (f32, one cast at the end)
// over the ROIs k of the map's image.  The boxes get no gradient.
//
// Bound on an H100: memory.  At hnet-nucls' pyramid the output gradient is
// 4 · 256 · (160² + 80² + 40² + 20²) ≈ 34.8 M bf16 values read once and the
// level gradients as many written once, ~0.042 ms at 3.35 TB/s.  Design,
// simple first, a gather with no atomics and no f32 scratch in device
// memory:
//   * Work items (map, image, band of level rows, channel slab) partition
//     every map's gradient, so each cell is written once, by plain stores,
//     in the maps' dtype; cells no ROI touches get 0.  Persistent blocks walk
//     the items, the largest map first.
//   * A thread keeps up to four (row, column, channel vector) cells of its
//     item in f32 registers and adds every ROI of the item's image to them
//     in ROI order, then bin order: deterministic.
//   * One map with many ROIs an image (the confliction loss's 100 boxes)
//     takes the per-ROI path below instead: a block per ROI pools its
//     adjoint patch, then the patches are summed per cell in ROI order.
//   * Per ROI that can reach the band (its first and last sample decide),
//     a thread per bin builds the merged (index, weight) entries of both
//     axes (roi_single.cuh, the forward's arithmetic) and, with shared
//     atomicMin / atomicMax, the first and last bin touching each column and
//     each band row: the bins touching an index are contiguous.
//   * R for the bins touching the band, over the ROI's column range and the
//     slab, is summed from the output gradient (16-byte loads, each bin row
//     read by neighbouring threads) into shared memory, rounded as the plain
//     version rounds it, in chunks of bins that fit; then each cell adds
//     Σ_p Wy · R from shared memory.
//   * C % 8 != 0 (bf16), C % 4 != 0 (f32) or unaligned pointers take a
//     scalar path (the confliction loss's 5 channels).

#include <algorithm>
#include <climits>
#include <cstring>

#include "roi_single.cuh"

namespace {

constexpr int NTHREADS = 256;
constexpr int MAX_L = 8;               // maps in one launch
constexpr int MAX_S = 512;             // M * n samples per axis
constexpr int MAX_E = 2 * MAX_S;       // merged entries per axis (<= 2n a bin)
constexpr int MAX_W = 1024;            // columns of a map
constexpr int MAX_BH = 32;             // level rows of a work item
constexpr int CELLS = 4;               // cells a thread accumulates
constexpr int R_BYTES = 48 * 1024;     // R of a chunk of bins, f32

struct Levels {
  const void* grad[MAX_L];             // (B, K, M, M, C) output gradient
  void* out[MAX_L];                    // (B, H, W, C) map gradient
  int H[MAX_L], W[MAX_L], C[MAX_L], M[MAX_L];
  int bh[MAX_L], nband[MAX_L], nslab[MAX_L], cs[MAX_L];
  float scale[MAX_L];
  int start[MAX_L + 1];                // first work item of each map; start[L] = total
  int L;
};

// The weight of level index `i` among a bin's entries (0 if it has none).
__device__ __forceinline__ float entry_weight(const short* idx, const float* w, int cnt, int i) {
  for (int e = 0; e < cnt; ++e)
    if (idx[e] == i) return w[e];
  return 0.f;
}

template <typename T, int V>
__global__ void __launch_bounds__(NTHREADS, 3)
roi_align_levels_bwd_kernel(const Levels lv, const float4* __restrict__ boxes, int K, int n,
                            int aligned) {
  using VV = hdy::Vec<T, V>;
  using Raw = typename VV::Raw;
  constexpr bool BF16 = sizeof(T) == 2;
  extern __shared__ __align__(16) float r_smem[];  // R: [bin - pa][column - xlo][channel]
  __shared__ short e_idx[2][MAX_E];      // [axis][bin * 2n + e]: level index (0 rows, 1 columns)
  __shared__ float e_w[2][MAX_E];
  __shared__ short e_cnt[2][MAX_S];
  __shared__ int q_lo[MAX_W], q_hi[MAX_W];     // per level column: first / last bin touching it
  __shared__ int p_lo[MAX_BH], p_hi[MAX_BH];   // per band row: first / last bin touching it
  __shared__ int s_xlo, s_xhi;

  const int tid = threadIdx.x;
  const int total = lv.start[lv.L];
  const float off = aligned ? 0.5f : 0.f;

  for (int item = blockIdx.x; item < total; item += gridDim.x) {
    int l = 0;
    while (item >= lv.start[l + 1]) ++l;
    const int H = lv.H[l], W = lv.W[l], C = lv.C[l], M = lv.M[l], bh = lv.bh[l];
    const int nslab = lv.nslab[l], nband = lv.nband[l];
    const int il = item - lv.start[l];
    const int slab = il % nslab, band = (il / nslab) % nband, b = il / (nslab * nband);
    const int h0 = band * bh, bhe = min(bh, H - h0);
    const int c0 = slab * lv.cs[l], cw = min(C, c0 + lv.cs[l]) - c0, ncv = cw / V;
    const int ne = 2 * n, S = M * n;
    const int ncell = bhe * W * ncv;
    const float scale = lv.scale[l];

    float acc[CELLS][V];
#pragma unroll
    for (int j = 0; j < CELLS; ++j)
#pragma unroll
      for (int i = 0; i < V; ++i) acc[j][i] = 0.f;

    for (int k = 0; k < K; ++k) {
      const float4 box = boxes[static_cast<size_t>(b) * K + k];
      const float x1 = __fsub_rn(__fmul_rn(box.x, scale), off);
      const float y1 = __fsub_rn(__fmul_rn(box.y, scale), off);
      float roi_w = __fsub_rn(__fsub_rn(__fmul_rn(box.z, scale), off), x1);
      float roi_h = __fsub_rn(__fsub_rn(__fmul_rn(box.w, scale), off), y1);
      if (!aligned) {
        roi_w = fmaxf(roi_w, 1.f);
        roi_h = fmaxf(roi_h, 1.f);
      }
      const float bin_w = __fdiv_rn(roi_w, static_cast<float>(S));
      const float bin_h = __fdiv_rn(roi_h, static_cast<float>(S));
      // the rows the ROI can reach lie between its first and last sample's
      // taps (every thread computes the same, so the skip is uniform)
      const float cy0 = hdy::axis_sample(y1, bin_h, 0), cy1 = hdy::axis_sample(y1, bin_h, S - 1);
      if (!(cy1 > -1.f) || !(cy0 < static_cast<float>(H))) continue;
      const int ylo = static_cast<int>(floorf(fminf(fmaxf(cy0, 0.f), H - 1.f)));
      const int yhi = static_cast<int>(floorf(fminf(fmaxf(cy1, 0.f), H - 1.f))) + 1;
      if (yhi < h0 || ylo >= h0 + bhe) continue;

      __syncthreads();                   // the previous ROI's readers are done
      for (int i = tid; i < W; i += NTHREADS) {
        q_lo[i] = INT_MAX;
        q_hi[i] = -1;
      }
      if (tid < bhe) {
        p_lo[tid] = INT_MAX;
        p_hi[tid] = -1;
      }
      if (tid == 0) {
        s_xlo = INT_MAX;
        s_xhi = -1;
      }
      __syncthreads();
      for (int t = tid; t < 2 * M; t += NTHREADS) {
        const int ax = t >= M, p = ax ? t - M : t;
        short* ei = &e_idx[ax][p * ne];
        float* ew = &e_w[ax][p * ne];
        const int cnt = ax ? hdy::bin_entries<BF16>(x1, bin_w, p, n, W, ei, ew)
                           : hdy::bin_entries<BF16>(y1, bin_h, p, n, H, ei, ew);
        e_cnt[ax][p] = static_cast<short>(cnt);
        for (int e = 0; e < cnt; ++e) {
          const int i = ei[e];
          if (ax) {
            atomicMin(&q_lo[i], p);
            atomicMax(&q_hi[i], p);
            atomicMin(&s_xlo, i);
            atomicMax(&s_xhi, i);
          } else if (i >= h0 && i < h0 + bhe) {
            atomicMin(&p_lo[i - h0], p);
            atomicMax(&p_hi[i - h0], p);
          }
        }
      }
      __syncthreads();
      int pmin = INT_MAX, pmax = -1;
      for (int r = 0; r < bhe; ++r) {
        pmin = min(pmin, p_lo[r]);
        pmax = max(pmax, p_hi[r]);
      }
      const int xlo = s_xlo, xhi = s_xhi;
      if (pmin > pmax || xlo > xhi) continue;

      const int ncol = xhi - xlo + 1;
      const int pc = max(1, R_BYTES / (ncol * cw * 4));   // bins of R a chunk holds
      const T* g = static_cast<const T*>(lv.grad[l]) +
                   (static_cast<size_t>(b) * K + k) * M * M * C + c0;
      for (int pa = pmin; pa <= pmax; pa += pc) {
        const int pb = min(pmax + 1, pa + pc);
        // R[p][x] = round(Σ_q Wx[q][x] · g[p][q]), a thread per (bin, column, vector)
        for (int t = tid; t < (pb - pa) * ncol * ncv; t += NTHREADS) {
          const int cv = t % ncv, rest = t / ncv, xi = rest % ncol, pi = rest / ncol;
          const int x = xlo + xi;
          const T* gp = g + static_cast<size_t>(pa + pi) * M * C + cv * V;
          float r[V];
#pragma unroll
          for (int i = 0; i < V; ++i) r[i] = 0.f;
          for (int q = q_lo[x]; q <= q_hi[x]; ++q) {
            const float wx = entry_weight(&e_idx[1][q * ne], &e_w[1][q * ne], e_cnt[1][q], x);
            float v[V];
            VV::unpack(*reinterpret_cast<const Raw*>(gp + static_cast<size_t>(q) * C), v);
#pragma unroll
            for (int i = 0; i < V; ++i) r[i] = fmaf(wx, v[i], r[i]);
          }
          VV::unpack(VV::pack(r), r);    // rounded to the maps' dtype, as the plain version
          float* dst = r_smem + (static_cast<size_t>(pi) * ncol + xi) * cw + cv * V;
#pragma unroll
          for (int i = 0; i < V; ++i) dst[i] = r[i];
        }
        __syncthreads();
        // each cell adds Σ_p Wy[p][y] · R[p][x] over the chunk's bins touching its row
#pragma unroll
        for (int j = 0; j < CELLS; ++j) {
          const int cell = tid + j * NTHREADS;
          const int cv = cell % ncv, rest = cell / ncv, x = rest % W, ri = rest / W;
          if (cell >= ncell || x < xlo || x > xhi) continue;
          const int p1 = min(p_hi[ri], pb - 1);
          for (int p = max(p_lo[ri], pa); p <= p1; ++p) {
            const float wy =
                entry_weight(&e_idx[0][p * ne], &e_w[0][p * ne], e_cnt[0][p], h0 + ri);
            const float* src =
                r_smem + (static_cast<size_t>(p - pa) * ncol + (x - xlo)) * cw + cv * V;
#pragma unroll
            for (int i = 0; i < V; ++i) acc[j][i] = fmaf(wy, src[i], acc[j][i]);
          }
        }
        __syncthreads();                 // R is rewritten by the next chunk
      }
    }

    T* o = static_cast<T*>(lv.out[l]) + (static_cast<size_t>(b) * H + h0) * W * C + c0;
#pragma unroll
    for (int j = 0; j < CELLS; ++j) {
      const int cell = tid + j * NTHREADS;
      if (cell >= ncell) continue;
      const int cv = cell % ncv, rest = cell / ncv, x = rest % W, ri = rest / W;
      *reinterpret_cast<Raw*>(o + (static_cast<size_t>(ri) * W + x) * C + cv * V) =
          VV::pack(acc[j]);
    }
  }
}

template <typename T, int V>
int launch(const Levels& lv, const float4* boxes, int K, int n, int aligned, int device,
           cudaStream_t s) {
  static int last_device = -1, blocks = 0;
  if (device != last_device) {
    cudaError_t e = cudaFuncSetAttribute(roi_align_levels_bwd_kernel<T, V>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, R_BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (e != cudaSuccess) return static_cast<int>(e);
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, roi_align_levels_bwd_kernel<T, V>,
                                                      NTHREADS, R_BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    blocks = sms * max(per_sm, 1);
    last_device = device;
  }
  const int total = lv.start[lv.L];
  roi_align_levels_bwd_kernel<T, V><<<min(total, blocks), NTHREADS, R_BYTES, s>>>(lv, boxes, K,
                                                                                  n, aligned);
  return hdy::launch_status();
}

// ---- the per-ROI path: one map, many ROIs an image --------------------------
//
// The gather above walks an image's ROIs in series inside every item, so an
// item whose rows many ROIs reach (the confliction loss's 100 boxes an
// image, clustered where the detections are) waits on ROI after ROI.  For one map
// with many ROIs an image the wrapper takes this path instead:
//   * pass A, a block per (image, ROI): the ROI's bin tables once, R over
//     the columns its taps reach (as above), then its adjoint patch
//       P_k[y][x][c] = Σ_p Wy_k[p][y] · R_k[p][x][c]
//     over the rows and columns it reaches, into f32 scratch laid out as the
//     map (only that footprint is written), and the footprint's bounds;
//   * pass B, a thread per map cell vector: the patches that cover the cell
//     summed in ROI order, written once in the map's dtype (0 where none).
// Deterministic and free of atomics on data; both passes are one call.

struct RoiMap {
  const void* grad;                    // (B, K, M, M, C) output gradient
  void* out;                           // (B, H, W, C) map gradient
  float* patch;                        // (B·K, H, W, C) f32 scratch
  int4* reach;                         // (B·K) footprint rows [x, y], columns [z, w]
  int H, W, C, M;
  float scale;
};

template <typename T, int V>
__global__ void __launch_bounds__(NTHREADS)
roi_patch_kernel(const RoiMap m, const float4* __restrict__ boxes, int n, int aligned,
                 int r_bytes) {
  using VV = hdy::Vec<T, V>;
  using Raw = typename VV::Raw;
  constexpr bool BF16 = sizeof(T) == 2;
  extern __shared__ __align__(16) float r_smem[];  // R: [bin - pa][column - xlo][channel]
  __shared__ short e_idx[2][MAX_E];
  __shared__ float e_w[2][MAX_E];
  __shared__ short e_cnt[2][MAX_S];
  __shared__ int q_lo[MAX_W], q_hi[MAX_W];     // per column: first / last bin touching it
  __shared__ int p_lo[MAX_W], p_hi[MAX_W];     // per row: first / last bin touching it
  __shared__ int s_lo[2], s_hi[2];             // rows, columns reached

  const int tid = threadIdx.x;
  const int bk = blockIdx.x;
  const int H = m.H, W = m.W, C = m.C, M = m.M, nc = C / V;
  const int ne = 2 * n, S = M * n;
  const float off = aligned ? 0.5f : 0.f;
  const float4 box = boxes[bk];
  const float x1 = __fsub_rn(__fmul_rn(box.x, m.scale), off);
  const float y1 = __fsub_rn(__fmul_rn(box.y, m.scale), off);
  float roi_w = __fsub_rn(__fsub_rn(__fmul_rn(box.z, m.scale), off), x1);
  float roi_h = __fsub_rn(__fsub_rn(__fmul_rn(box.w, m.scale), off), y1);
  if (!aligned) {
    roi_w = fmaxf(roi_w, 1.f);
    roi_h = fmaxf(roi_h, 1.f);
  }
  const float bin_w = __fdiv_rn(roi_w, static_cast<float>(S));
  const float bin_h = __fdiv_rn(roi_h, static_cast<float>(S));

  for (int i = tid; i < W; i += NTHREADS) {
    q_lo[i] = INT_MAX;
    q_hi[i] = -1;
  }
  for (int i = tid; i < H; i += NTHREADS) {
    p_lo[i] = INT_MAX;
    p_hi[i] = -1;
  }
  if (tid < 2) {
    s_lo[tid] = INT_MAX;
    s_hi[tid] = -1;
  }
  __syncthreads();
  for (int t = tid; t < 2 * M; t += NTHREADS) {
    const int ax = t >= M, p = ax ? t - M : t;
    short* ei = &e_idx[ax][p * ne];
    float* ew = &e_w[ax][p * ne];
    const int cnt = ax ? hdy::bin_entries<BF16>(x1, bin_w, p, n, W, ei, ew)
                       : hdy::bin_entries<BF16>(y1, bin_h, p, n, H, ei, ew);
    e_cnt[ax][p] = static_cast<short>(cnt);
    int* lo = ax ? q_lo : p_lo;
    int* hi = ax ? q_hi : p_hi;
    for (int e = 0; e < cnt; ++e) {
      const int i = ei[e];
      atomicMin(&lo[i], p);
      atomicMax(&hi[i], p);
      atomicMin(&s_lo[ax], i);
      atomicMax(&s_hi[ax], i);
    }
  }
  __syncthreads();
  const int ylo = s_lo[0], yhi = s_hi[0], xlo = s_lo[1], xhi = s_hi[1];
  if (tid == 0) m.reach[bk] = make_int4(ylo, yhi, xlo, xhi);   // empty: lo > hi
  if (ylo > yhi || xlo > xhi) return;

  const int nrow = yhi - ylo + 1, ncol = xhi - xlo + 1;
  const int pc = max(1, r_bytes / (ncol * C * 4));   // bins of R a chunk holds
  const T* g = static_cast<const T*>(m.grad) + static_cast<size_t>(bk) * M * M * C;
  float* patch = m.patch + static_cast<size_t>(bk) * H * W * C;
  for (int pa = 0; pa < M; pa += pc) {
    const int pb = min(M, pa + pc);
    // R[p][x] = round(Σ_q Wx[q][x] · g[p][q]), a thread per (bin, column, vector)
    for (int t = tid; t < (pb - pa) * ncol * nc; t += NTHREADS) {
      const int cv = t % nc, rest = t / nc, xi = rest % ncol, pi = rest / ncol;
      const int x = xlo + xi;
      const T* gp = g + static_cast<size_t>(pa + pi) * M * C + cv * V;
      float r[V];
#pragma unroll
      for (int i = 0; i < V; ++i) r[i] = 0.f;
      for (int q = q_lo[x]; q <= q_hi[x]; ++q) {
        const float wx = entry_weight(&e_idx[1][q * ne], &e_w[1][q * ne], e_cnt[1][q], x);
        float v[V];
        VV::unpack(*reinterpret_cast<const Raw*>(gp + static_cast<size_t>(q) * C), v);
#pragma unroll
        for (int i = 0; i < V; ++i) r[i] = fmaf(wx, v[i], r[i]);
      }
      VV::unpack(VV::pack(r), r);        // rounded to the map's dtype, as the plain version
      float* dst = r_smem + (static_cast<size_t>(pi) * ncol + xi) * C + cv * V;
#pragma unroll
      for (int i = 0; i < V; ++i) dst[i] = r[i];
    }
    __syncthreads();
    // P[y][x] (+)= Σ_p Wy[p][y] · R[p][x] over the chunk's bins touching row y;
    // each patch cell has one owner thread across the chunks
    for (int t = tid; t < nrow * ncol * nc; t += NTHREADS) {
      const int cv = t % nc, rest = t / nc, xi = rest % ncol, y = ylo + rest / ncol;
      float acc[V];
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] = 0.f;
      const int p1 = min(p_hi[y], pb - 1);
      for (int p = max(p_lo[y], pa); p <= p1; ++p) {
        const float wy = entry_weight(&e_idx[0][p * ne], &e_w[0][p * ne], e_cnt[0][p], y);
        const float* src = r_smem + (static_cast<size_t>(p - pa) * ncol + xi) * C + cv * V;
#pragma unroll
        for (int i = 0; i < V; ++i) acc[i] = fmaf(wy, src[i], acc[i]);
      }
      float* dst = patch + (static_cast<size_t>(y) * W + xlo + xi) * C + cv * V;
#pragma unroll
      for (int i = 0; i < V; ++i) dst[i] = pa == 0 ? acc[i] : dst[i] + acc[i];
    }
    __syncthreads();                     // R is rewritten by the next chunk
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(NTHREADS)
roi_merge_kernel(const RoiMap m, int B, int K) {
  using VV = hdy::Vec<T, V>;
  using Raw = typename VV::Raw;
  const int H = m.H, W = m.W, C = m.C, nc = C / V;
  const long long total = static_cast<long long>(B) * H * W * nc;
  for (long long t = blockIdx.x * static_cast<long long>(NTHREADS) + threadIdx.x; t < total;
       t += static_cast<long long>(gridDim.x) * NTHREADS) {
    const int cv = static_cast<int>(t % nc);
    const long long cell = t / nc;                 // (b·H + y)·W + x
    const int x = static_cast<int>(cell % W), y = static_cast<int>((cell / W) % H);
    const int b = static_cast<int>(cell / (static_cast<long long>(W) * H));
    const size_t at = (static_cast<size_t>(y) * W + x) * C + cv * V;
    float acc[V];
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = 0.f;
    for (int k = 0; k < K; ++k) {
      const int4 r = m.reach[static_cast<size_t>(b) * K + k];
      if (y < r.x || y > r.y || x < r.z || x > r.w) continue;
      const float* src = m.patch + (static_cast<size_t>(b) * K + k) * H * W * C + at;
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] += src[i];
    }
    *reinterpret_cast<Raw*>(static_cast<T*>(m.out) + static_cast<size_t>(cell) * C + cv * V) =
        VV::pack(acc);
  }
}

template <typename T, int V>
int launch_rois(const RoiMap& m, const float4* boxes, int B, int K, int n, int aligned,
                int device, cudaStream_t s) {
  static int last_device = -1, sms = 0;
  if (device != last_device) {
    cudaError_t e = cudaFuncSetAttribute(roi_patch_kernel<T, V>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, R_BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (e != cudaSuccess) return static_cast<int>(e);
    last_device = device;
  }
  // R of every bin at the map's whole width if it fits, else a chunk's worth
  const int r_bytes = min(R_BYTES, m.M * m.W * m.C * 4);
  roi_patch_kernel<T, V><<<B * K, NTHREADS, r_bytes, s>>>(m, boxes, n, aligned, r_bytes);
  const long long cells = static_cast<long long>(B) * m.H * m.W * (m.C / V);
  const int blocks =
      static_cast<int>(std::min<long long>((cells + NTHREADS - 1) / NTHREADS, 8LL * sms));
  roi_merge_kernel<T, V><<<std::max(blocks, 1), NTHREADS, 0, s>>>(m, B, K);
  return hdy::launch_status();
}

}  // namespace

// Limits of one launch, for the wrapper's checks and its choice of band and
// slab: maps, samples per axis, columns of a map, rows of a band, cells a
// thread accumulates x threads, and the R buffer in bytes.
HDY_EXPORT int roi_align_levels_bwd_limits(int which) {
  switch (which) {
    case 0: return MAX_L;
    case 1: return MAX_S;
    case 2: return MAX_W;
    case 3: return MAX_BH;
    case 4: return CELLS * NTHREADS;
    case 5: return R_BYTES;
    default: return 0;
  }
}

// table: host array of L rows of 10 int64 (output-gradient pointer, map
// gradient pointer, H, W, C, M, band rows, channel slab, scale as the bits
// of an f32, 0); each output gradient (B, K, M, M, C) and map gradient (B,
// H, W, C) contiguous, of one dtype.  boxes (B, K, 4) f32 xyxy image
// coordinates, 16-byte aligned.  dtype: 0 f32, 1 bf16; vec: 1 for 16-byte
// vectors (every C and slab a multiple of 8 for bf16 or 4 for f32, every
// pointer 16-byte aligned), 0 for the scalar path.  aligned: 0 is
// torchvision's legacy aligned=False.  Per map: band rows x W x slab
// vectors <= CELLS x NTHREADS cells, W x slab x 4 <= R_BYTES.
HDY_EXPORT int roi_align_levels_bwd(const long long* table, int L, const void* boxes, int B,
                                    int K, int n, int aligned, int dtype, int vec, int device,
                                    void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (L < 1 || L > MAX_L || n < 1 || B < 0 || K < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int V = vec ? (dtype == 1 ? 8 : 4) : 1;
  Levels lv{};
  lv.L = L;
  long long items = 0;
  for (int i = 0; i < L; ++i) {
    const long long* r = table + 10 * i;
    lv.grad[i] = reinterpret_cast<const void*>(r[0]);
    lv.out[i] = reinterpret_cast<void*>(r[1]);
    lv.H[i] = static_cast<int>(r[2]);
    lv.W[i] = static_cast<int>(r[3]);
    lv.C[i] = static_cast<int>(r[4]);
    lv.M[i] = static_cast<int>(r[5]);
    lv.bh[i] = static_cast<int>(r[6]);
    lv.cs[i] = static_cast<int>(r[7]);
    const uint32_t bits = static_cast<uint32_t>(r[8]);
    memcpy(&lv.scale[i], &bits, 4);
    const int ncv = lv.cs[i] / V;
    if (lv.H[i] < 1 || lv.H[i] > SHRT_MAX || lv.W[i] < 1 || lv.W[i] > MAX_W || lv.C[i] < 1 ||
        lv.M[i] < 1 || lv.M[i] * n > MAX_S || lv.bh[i] < 1 || lv.bh[i] > MAX_BH ||
        lv.cs[i] < V || lv.cs[i] % V || lv.C[i] % V ||
        static_cast<long long>(lv.bh[i]) * lv.W[i] * ncv > CELLS * NTHREADS ||
        static_cast<long long>(lv.W[i]) * lv.cs[i] * 4 > R_BYTES)
      return static_cast<int>(cudaErrorInvalidValue);
    lv.nband[i] = (lv.H[i] + lv.bh[i] - 1) / lv.bh[i];
    lv.nslab[i] = (lv.C[i] + lv.cs[i] - 1) / lv.cs[i];
    lv.start[i] = static_cast<int>(items);
    items += static_cast<long long>(B) * lv.nband[i] * lv.nslab[i];
    if (items > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  }
  lv.start[L] = static_cast<int>(items);
  if (items == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* bx = static_cast<const float4*>(boxes);
  if (dtype == 1)
    return vec ? launch<__nv_bfloat16, 8>(lv, bx, K, n, aligned, device, s)
               : launch<__nv_bfloat16, 1>(lv, bx, K, n, aligned, device, s);
  return vec ? launch<float, 4>(lv, bx, K, n, aligned, device, s)
             : launch<float, 1>(lv, bx, K, n, aligned, device, s);
}

// The per-ROI path for one map: grad (B, K, M, M, C) and out (B, H, W, C)
// contiguous, of one dtype; patch (B·K, H, W, C) f32 and reach (B·K, 4)
// int32 scratch, 16-byte aligned; boxes (B, K, 4) f32 xyxy image
// coordinates, 16-byte aligned; scale as the bits of an f32.  dtype: 0 f32,
// 1 bf16; vec: 1 for 16-byte vectors (C a multiple of 8 for bf16 or 4 for
// f32, pointers 16-byte aligned), 0 for the scalar path.  H, W <= MAX_W,
// W x C x 4 <= R_BYTES.
HDY_EXPORT int roi_align_levels_bwd_rois(const void* grad, void* out, void* patch, void* reach,
                                         const void* boxes, int B, int K, int H, int W, int C,
                                         int M, int n, int scale_bits, int aligned, int dtype,
                                         int vec, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int V = vec ? (dtype == 1 ? 8 : 4) : 1;
  if (B < 0 || K < 1 || n < 1 || H < 1 || H > MAX_W || W < 1 || W > MAX_W || C < 1 || C % V ||
      M < 1 || M * n > MAX_S || static_cast<long long>(W) * C * 4 > R_BYTES)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  RoiMap m{grad, out, static_cast<float*>(patch), static_cast<int4*>(reach), H, W, C, M, 0.f};
  const uint32_t bits = static_cast<uint32_t>(scale_bits);
  memcpy(&m.scale, &bits, 4);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* bx = static_cast<const float4*>(boxes);
  if (dtype == 1)
    return vec ? launch_rois<__nv_bfloat16, 8>(m, bx, B, K, n, aligned, device, s)
               : launch_rois<__nv_bfloat16, 1>(m, bx, B, K, n, aligned, device, s);
  return vec ? launch_rois<float, 4>(m, bx, B, K, n, aligned, device, s)
             : launch_rois<float, 1>(m, bx, B, K, n, aligned, device, s);
}
