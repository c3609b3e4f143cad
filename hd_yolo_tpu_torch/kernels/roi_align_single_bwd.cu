// Backward of the single-level ROI-align over several maps (kernels/
// roi_align_single.cu) with respect to the maps: each map's gradient from
// the gradient of its pooled output.
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
// level gradients as many written once, ~0.042 ms at 3.35 TB/s.  Two paths,
// each one launch, neither with atomics on data nor f32 scratch in device
// memory:
//   * The gather (`roi_align_levels_bwd`, every map in one launch): a block
//     per item (map, image, band of 8 rows, block of columns, channel slab)
//     partitions every map's gradient, so each cell is written once, in the
//     maps' dtype; cells no ROI reaches get 0.  A thread owns one (column,
//     16-byte channel vector) strip of the band, its 8 cells in f32
//     registers.  Per ROI of the image that can reach the item (its first
//     and last sample decide), the block builds the ROI's bin tables once
//     for the item — a thread per bin (roi_single.cuh, the forward's
//     arithmetic) writes its weights into dense (bin x band row) and (bin x
//     column) tables in shared memory — and then each thread forms R for
//     its column from the output gradient (16-byte loads, two bins and two
//     taps at once, L1 serving the neighbouring columns), rounds it as the
//     plain version does, and adds Wy · R to the band rows each bin
//     reaches.  No R buffer and three barriers a ROI.  Sums run in ROI
//     order, then bin order, as the plain version's: bit for bit at hnet's
//     pyramid.
//   * The per-ROI path (`roi_align_levels_bwd_rois`, one map with many ROIs
//     an image: the confliction loss's pooling): a thread-block cluster per
//     image, up to 16 blocks.  A round gives each warp of the cluster one
//     ROI: the warp stages the ROI's output gradient in its shared buffer
//     (`cp.async`, under the building of its bin tables), forms R with a
//     lane per (column, channel) and then the ROI's adjoint patch, each
//     sum over only the bins that reach its row or column; then the block's
//     warps add their patches, in turn, into the block's f32 copy of the
//     image's gradient in shared memory.  A footprint too large for a
//     warp's buffers the whole block forms in that warp's turn (its output
//     gradient staged in the warps' then idle buffers, its weights laid out
//     densely, R a chunk of bins at a time, a thread per (bin, column,
//     channel), then a thread per cell).  Last, every block
//     sums a slice of the map over the cluster's blocks, in block order,
//     through distributed shared memory and writes it once.  Deterministic;
//     no scratch in device memory.  What holds it back on a training step's
//     detections: the large boxes (about a tenth span 128 px or more) are
//     formed one after another in their turns, by a block each.
//   * C % 8 != 0 (bf16), C % 4 != 0 (f32) or unaligned pointers take a
//     scalar path (the confliction loss's 5 channels).

#include <cooperative_groups.h>

#include <algorithm>
#include <climits>
#include <cstring>

#include "roi_single.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NTHREADS = 256;
constexpr int MAX_L = 8;               // maps in one launch
constexpr int MAX_S = 512;             // M * n samples per axis
constexpr int MAX_E = 2 * MAX_S;       // merged entries per axis (<= 2n a bin)
constexpr int GATHER_SIDE = 32767;     // a side of a map (its indices are shorts)
constexpr int BH = 8;                  // band rows: a thread's accumulators
constexpr int MAX_CB = 64;             // columns of a gather item
constexpr int MAP_BYTES = 48 * 1024;   // per-ROI path: an image's f32 gradient a block
constexpr int ROI_MAX_S = 64;          // per-ROI path: M * n samples per axis
constexpr int ROI_E = 2 * ROI_MAX_S;
constexpr int W_CAP = 640;             // per-ROI path, floats a warp: dense weights,
constexpr int R_CAP = 1536;            //   R,
constexpr int P_CAP = 512;             //   the adjoint patch,
constexpr int ROW_CAP = 2 * 1024;      //   and at least a row of an ROI's output gradient (bytes)
constexpr int RNG_CAP = 64;            // per-ROI path: rows + columns of a warp's footprint
constexpr int PU = 4;                  // bins a lane sums R for at once
constexpr int IG = 4;                  // patch cells a lane forms at once
constexpr int MAX_CLUSTER = 16;
constexpr int MAX_SIDE = 1024;         // per-ROI path: a side of the map
constexpr int BIG_FLOATS = 6 * 1024;   // per-ROI path: R of a large footprint, a chunk of bins,
constexpr int DENSE_FLOATS = 2560;     //   and its dense weights, M x (H + W) at most

struct Levels {
  const void* grad[MAX_L];             // (B, K, M, M, C) output gradient
  void* out[MAX_L];                    // (B, H, W, C) map gradient
  int H[MAX_L], W[MAX_L], C[MAX_L], M[MAX_L];
  int nband[MAX_L], ncb[MAX_L], cb[MAX_L], nslab[MAX_L], cs[MAX_L], lpc_log2[MAX_L];
  float scale[MAX_L];
  int start[MAX_L + 1];                // first item of each map; start[L] = total
  int L;
};

// A ROI's box on a map: its corner and bin sizes, as the forward computes them.
struct Box {
  float x1, y1, bin_w, bin_h;
};

__device__ __forceinline__ Box roi_box(float4 box, float scale, int S, int aligned) {
  const float off = aligned ? 0.5f : 0.f;
  const float x1 = __fsub_rn(__fmul_rn(box.x, scale), off);
  const float y1 = __fsub_rn(__fmul_rn(box.y, scale), off);
  float roi_w = __fsub_rn(__fsub_rn(__fmul_rn(box.z, scale), off), x1);
  float roi_h = __fsub_rn(__fsub_rn(__fmul_rn(box.w, scale), off), y1);
  if (!aligned) {
    roi_w = fmaxf(roi_w, 1.f);
    roi_h = fmaxf(roi_h, 1.f);
  }
  return Box{x1, y1, __fdiv_rn(roi_w, static_cast<float>(S)),
             __fdiv_rn(roi_h, static_cast<float>(S))};
}

// Whether an axis' taps (first and last sample's) can reach [i0, i0 + len) of
// a [0, size) axis.
__device__ __forceinline__ bool axis_reaches(float start, float bin, int S, int size, int i0,
                                             int len) {
  const float c0 = hdy::axis_sample(start, bin, 0), c1 = hdy::axis_sample(start, bin, S - 1);
  if (!(c1 > -1.f) || !(c0 < static_cast<float>(size))) return false;
  const int lo = static_cast<int>(floorf(fminf(fmaxf(c0, 0.f), size - 1.f)));
  const int hi = static_cast<int>(floorf(fminf(fmaxf(c1, 0.f), size - 1.f))) + 1;
  return hi >= i0 && lo < i0 + len;
}

template <typename T, int V>
__global__ void __launch_bounds__(NTHREADS, 2)
roi_align_levels_bwd_kernel(const Levels lv, const float4* __restrict__ boxes, int K, int n,
                            int aligned, int m_max) {
  using VV = hdy::Vec<T, V>;
  using Raw = typename VV::Raw;
  constexpr bool BF16 = sizeof(T) == 2;
  extern __shared__ __align__(16) float w_smem[];  // Wy [bin][band row], then Wx [bin][column]
  __shared__ short e_idx[2][MAX_E];      // [axis][bin * 2n + e]: level index (0 rows, 1 columns)
  __shared__ float e_w[2][MAX_E];
  __shared__ int q_lo[MAX_CB], q_hi[MAX_CB];   // per item column: first / last bin reaching it
  __shared__ int s_pa, s_pb;                   // first / last bin reaching the band

  const int tid = threadIdx.x;
  int item = blockIdx.x, l = 0;
  while (item >= lv.start[l + 1]) ++l;
  item -= lv.start[l];
  const int H = lv.H[l], W = lv.W[l], C = lv.C[l], M = lv.M[l], cb = lv.cb[l];
  const int slab = item % lv.nslab[l];
  item /= lv.nslab[l];
  const int blk = item % lv.ncb[l];
  item /= lv.ncb[l];
  const int band = item % lv.nband[l], b = item / lv.nband[l];
  const int h0 = band * BH, bh = min(BH, H - h0);
  const int x0 = blk * cb, cw = min(cb, W - x0);
  const int c0 = slab * lv.cs[l], ncv = (min(C, c0 + lv.cs[l]) - c0) / V;
  const int cv = tid & ((1 << lv.lpc_log2[l]) - 1), xi = tid >> lv.lpc_log2[l];
  const bool live = xi < cw && cv < ncv;
  const int ne = 2 * n, S = M * n;
  float* wy_t = w_smem;                  // [m_max][BH]
  float* wx_t = w_smem + m_max * BH;     // [m_max][cb]

  float acc[BH][V];
#pragma unroll
  for (int j = 0; j < BH; ++j)
#pragma unroll
    for (int i = 0; i < V; ++i) acc[j][i] = 0.f;

  for (int k = 0; k < K; ++k) {
    const Box bx = roi_box(boxes[static_cast<size_t>(b) * K + k], lv.scale[l], S, aligned);
    // uniform across the block: skip a ROI that reaches no row or column of the item
    if (!axis_reaches(bx.y1, bx.bin_h, S, H, h0, bh) ||
        !axis_reaches(bx.x1, bx.bin_w, S, W, x0, cw))
      continue;
    __syncthreads();                     // the previous ROI's readers are done
    for (int i = tid; i < M * BH; i += NTHREADS) wy_t[i] = 0.f;
    for (int i = tid; i < M * cb; i += NTHREADS) wx_t[i] = 0.f;
    if (tid < cb) {
      q_lo[tid] = INT_MAX;
      q_hi[tid] = -1;
    }
    if (tid == 0) {
      s_pa = INT_MAX;
      s_pb = -1;
    }
    __syncthreads();
    for (int t = tid; t < 2 * M; t += NTHREADS) {
      const int ax = t >= M, p = ax ? t - M : t;
      short* ei = &e_idx[ax][p * ne];
      float* ew = &e_w[ax][p * ne];
      const int cnt = ax ? hdy::bin_entries<BF16>(bx.x1, bx.bin_w, p, n, W, ei, ew)
                         : hdy::bin_entries<BF16>(bx.y1, bx.bin_h, p, n, H, ei, ew);
      for (int e = 0; e < cnt; ++e) {
        const int i = ei[e];
        if (ax) {
          if (i >= x0 && i < x0 + cw) {
            wx_t[p * cb + i - x0] = ew[e];
            atomicMin(&q_lo[i - x0], p);
            atomicMax(&q_hi[i - x0], p);
          }
        } else if (i >= h0 && i < h0 + bh) {
          wy_t[p * BH + i - h0] = ew[e];
          atomicMin(&s_pa, p);
          atomicMax(&s_pb, p);
        }
      }
    }
    __syncthreads();
    if (!live) continue;
    const int qa = q_lo[xi], qb = q_hi[xi], pa = s_pa, pb = s_pb;
    if (qa > qb) continue;
    const T* g = static_cast<const T*>(lv.grad[l]) +
                 (static_cast<size_t>(b) * K + k) * M * M * C + c0 + cv * V;
    // two bins a step, two columns' taps at once: four 16-byte loads in flight
    for (int p = pa; p <= pb; p += 2) {
      // R[p][x] = round(Σ_q Wx[q][x] · g[p][q]), rounded to the maps' dtype as the plain version
      const bool p2 = p + 1 <= pb;
      const T* gp = g + static_cast<size_t>(p) * M * C;
      const T* gp1 = p2 ? gp + static_cast<size_t>(M) * C : gp;
      float r[2][V];
#pragma unroll
      for (int i = 0; i < V; ++i) r[0][i] = r[1][i] = 0.f;
      for (int q = qa; q <= qb; q += 2) {
        const bool q2 = q + 1 <= qb;
        const int qn = q2 ? q + 1 : q;
        const Raw u00 = *reinterpret_cast<const Raw*>(gp + static_cast<size_t>(q) * C);
        const Raw u01 = *reinterpret_cast<const Raw*>(gp + static_cast<size_t>(qn) * C);
        const Raw u10 = *reinterpret_cast<const Raw*>(gp1 + static_cast<size_t>(q) * C);
        const Raw u11 = *reinterpret_cast<const Raw*>(gp1 + static_cast<size_t>(qn) * C);
        const float w0 = wx_t[q * cb + xi], w1 = wx_t[qn * cb + xi];
        float v[V];
        VV::unpack(u00, v);
#pragma unroll
        for (int i = 0; i < V; ++i) r[0][i] = fmaf(w0, v[i], r[0][i]);
        VV::unpack(u10, v);
#pragma unroll
        for (int i = 0; i < V; ++i) r[1][i] = fmaf(w0, v[i], r[1][i]);
        if (q2) {
          VV::unpack(u01, v);
#pragma unroll
          for (int i = 0; i < V; ++i) r[0][i] = fmaf(w1, v[i], r[0][i]);
          VV::unpack(u11, v);
#pragma unroll
          for (int i = 0; i < V; ++i) r[1][i] = fmaf(w1, v[i], r[1][i]);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (h == 1 && !p2) break;
        VV::unpack(VV::pack(r[h]), r[h]);
#pragma unroll
        for (int j = 0; j < BH; ++j) {
          const float wy = wy_t[(p + h) * BH + j];
          if (wy != 0.f)
#pragma unroll
            for (int i = 0; i < V; ++i) acc[j][i] = fmaf(wy, r[h][i], acc[j][i]);
        }
      }
    }
  }

  if (!live) return;
  T* o = static_cast<T*>(lv.out[l]) + ((static_cast<size_t>(b) * H + h0) * W + x0 + xi) * C + c0 +
         cv * V;
#pragma unroll
  for (int j = 0; j < BH; ++j)
    if (j < bh) *reinterpret_cast<Raw*>(o + static_cast<size_t>(j) * W * C) = VV::pack(acc[j]);
}

template <typename T, int V>
int launch(const Levels& lv, const float4* boxes, int K, int n, int aligned, int m_max, int cb_max,
           cudaStream_t s) {
  const int smem = m_max * (BH + cb_max) * static_cast<int>(sizeof(float));
  static int last_device = -1;
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (device != last_device) {
    e = cudaFuncSetAttribute(roi_align_levels_bwd_kernel<T, V>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             MAX_S * (BH + MAX_CB) * static_cast<int>(sizeof(float)));
    if (e != cudaSuccess) return static_cast<int>(e);
    last_device = device;
  }
  roi_align_levels_bwd_kernel<T, V><<<lv.start[lv.L], NTHREADS, smem, s>>>(lv, boxes, K, n,
                                                                           aligned, m_max);
  return hdy::launch_status();
}

// ---- the per-ROI path: one map, many ROIs an image --------------------------

struct RoiMap {
  const void* grad;                    // (B, K, M, M, C) output gradient
  void* out;                           // (B, H, W, C) map gradient
  int H, W, C, M;
  float scale;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// `bytes` of device memory into a warp's shared buffer: 16- or 4-byte
// asynchronous copies where the source allows, else 2-byte loads.
__device__ __forceinline__ void warp_stage(unsigned char* dst, const unsigned char* src, int bytes,
                                           int lane) {
  const unsigned a = static_cast<unsigned>(reinterpret_cast<uintptr_t>(src)) | bytes;
  if ((a & 15) == 0) {
    for (int i = lane * 16; i < bytes; i += 32 * 16) cp_async16(dst + i, src + i);
  } else if ((a & 3) == 0) {
    for (int i = lane * 4; i < bytes; i += 32 * 4) cp_async4(dst + i, src + i);
  } else {
    for (int i = lane * 2; i < bytes; i += 32 * 2)
      *reinterpret_cast<unsigned short*>(dst + i) =
          *reinterpret_cast<const unsigned short*>(src + i);
  }
}

// A warp's working set for one ROI: its bin entries, dense weights over its
// footprint, R and the adjoint patch (rows of its output gradient follow all
// the warps' buffers, `g_bytes` a warp).
struct WarpBuf {
  short e_idx[2][ROI_E];
  float e_w[2][ROI_E];
  short e_cnt[2][ROI_MAX_S];
  float wd[W_CAP];                     // Wy [bin][row - ylo], then Wx [bin][column - xlo]
  float r[R_CAP];                      // R [bin][column - xlo][channel]
  float patch[P_CAP];                  // [row - ylo][column - xlo][channel]
  int rlo[RNG_CAP], rhi[RNG_CAP];      // first / last bin reaching each row, then each column
};

// The weight of level index `i` among bin p's entries (0 if it has none).
__device__ __forceinline__ float bin_weight(const WarpBuf& w, int ax, int p, int ne, int i) {
  for (int e = 0; e < w.e_cnt[ax][p]; ++e)
    if (w.e_idx[ax][p * ne + e] == i) return w.e_w[ax][p * ne + e];
  return 0.f;
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
roi_patch_cluster_kernel(const RoiMap m, const float4* __restrict__ boxes, int K, int n,
                         int aligned, int map_floats, int big_floats, int g_bytes) {
  constexpr bool BF16 = sizeof(T) == 2;
  constexpr int NWARPS = NTHREADS / 32;
  extern __shared__ __align__(16) float dsm[];   // the image's f32 gradient, a WarpBuf a warp,
                                                 // R of a large footprint, output-gradient rows
  __shared__ int q_lo[MAX_SIDE], q_hi[MAX_SIDE]; // a large footprint: per column / row, the
  __shared__ int p_lo[MAX_SIDE], p_hi[MAX_SIDE]; //   first and last bin reaching it
  __shared__ int s_big[NTHREADS / 32];
  __shared__ int4 s_foot[NTHREADS / 32];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int ncl = static_cast<int>(cluster.num_blocks());
  const int b = blockIdx.x / ncl;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int H = m.H, W = m.W, C = m.C, M = m.M;
  const int ne = 2 * n, S = M * n;
  float* map = dsm;
  WarpBuf& wb = reinterpret_cast<WarpBuf*>(dsm + map_floats)[warp];
  float* big = reinterpret_cast<float*>(reinterpret_cast<WarpBuf*>(dsm + map_floats) + NWARPS);
  float* dense = big + big_floats;       // a large footprint's Wy [bin][row], then Wx [bin][column]
  unsigned char* gbuf =
      reinterpret_cast<unsigned char*>(dense + (M * (H + W) + 3) / 4 * 4) + warp * g_bytes;
  const int row_bytes = M * C * static_cast<int>(sizeof(T));
  const int rows = g_bytes / row_bytes;  // rows of output gradient staged at once
  const T* grad = static_cast<const T*>(m.grad);

  for (int i = tid; i < H * W * C; i += NTHREADS) map[i] = 0.f;
  // a round gives the cluster's warps one ROI each: warp w of block r takes
  // ROI round + w·cluster + r (neighbouring ROIs, often alike in size, go
  // to different blocks), forms its patch, and adds it at its turn
  for (int round = 0; round < K; round += ncl * NWARPS) {
    const int k = round + warp * ncl + rank;
    int ylo = 0, yhi = -1, xlo = 0, xhi = -1;
    bool fast = false;
    const T* gk = grad + (static_cast<size_t>(b) * K + min(k, K - 1)) * M * M * C;
    if (k < K) {
      // the first rows of output gradient arrive while the tables are built
      warp_stage(gbuf, reinterpret_cast<const unsigned char*>(gk), min(M, rows) * row_bytes, lane);
      const Box bx = roi_box(boxes[static_cast<size_t>(b) * K + k], m.scale, S, aligned);
      int lo[2] = {INT_MAX, INT_MAX}, hi[2] = {-1, -1};
      for (int t = lane; t < 2 * M; t += 32) {
        const int ax = t >= M, p = ax ? t - M : t;
        short* ei = &wb.e_idx[ax][p * ne];
        const int cnt = ax ? hdy::bin_entries<BF16>(bx.x1, bx.bin_w, p, n, W, ei, &wb.e_w[ax][p * ne])
                           : hdy::bin_entries<BF16>(bx.y1, bx.bin_h, p, n, H, ei, &wb.e_w[ax][p * ne]);
        wb.e_cnt[ax][p] = static_cast<short>(cnt);
        for (int e = 0; e < cnt; ++e) {
          lo[ax] = min(lo[ax], static_cast<int>(ei[e]));
          hi[ax] = max(hi[ax], static_cast<int>(ei[e]));
        }
      }
      ylo = __reduce_min_sync(0xffffffffu, lo[0]);
      yhi = __reduce_max_sync(0xffffffffu, hi[0]);
      xlo = __reduce_min_sync(0xffffffffu, lo[1]);
      xhi = __reduce_max_sync(0xffffffffu, hi[1]);
      __syncwarp();
      const int nrow = yhi - ylo + 1, ncol = xhi - xlo + 1;
      fast = nrow > 0 && ncol > 0 && nrow * ncol * C <= P_CAP && M * ncol * C <= R_CAP &&
             M * (nrow + ncol) <= W_CAP && nrow + ncol <= RNG_CAP;
      if (fast) {
        float* wy = wb.wd;
        float* wx = wb.wd + M * nrow;
        for (int i = lane; i < M * (nrow + ncol); i += 32) wb.wd[i] = 0.f;
        for (int i = lane; i < nrow + ncol; i += 32) {
          wb.rlo[i] = INT_MAX;
          wb.rhi[i] = -1;
        }
        __syncwarp();
        // dense weights over the footprint, and the bins reaching each of
        // its rows and columns: the sums below skip the bins with no weight
        for (int t = lane; t < 2 * M; t += 32) {
          const int ax = t >= M, p = ax ? t - M : t;
          for (int e = 0; e < wb.e_cnt[ax][p]; ++e) {
            const int i = wb.e_idx[ax][p * ne + e];
            const int j = ax ? nrow + i - xlo : i - ylo;
            if (ax) wx[p * ncol + i - xlo] = wb.e_w[ax][p * ne + e];
            else wy[p * nrow + i - ylo] = wb.e_w[ax][p * ne + e];
            atomicMin(&wb.rlo[j], p);
            atomicMax(&wb.rhi[j], p);
          }
        }
        __syncwarp();
        // R[p][x][c] = round(Σ_q Wx[q][x] · g[p][q][c]), the output gradient
        // staged a chunk of rows at a time
        const int npair = ncol * C;
        const T* gs = reinterpret_cast<const T*>(gbuf);
        for (int p0 = 0; p0 < M; p0 += rows) {
          const int p1 = min(M, p0 + rows);
          if (p0 > 0) {
            __syncwarp();                // the previous rows' readers are done
            warp_stage(gbuf, reinterpret_cast<const unsigned char*>(gk + static_cast<size_t>(p0) * M * C),
                       (p1 - p0) * row_bytes, lane);
          }
          cp_async_wait_all();
          __syncwarp();
          // a lane per (column, channel), PU bins at once
          for (int pr = lane; pr < npair; pr += 32) {
            const int xi = pr / C, c = pr - xi * C;
            const int qa = wb.rlo[nrow + xi], qb = wb.rhi[nrow + xi];
            for (int p = p0; p < p1; p += PU) {
              float acc[PU];
#pragma unroll
              for (int u = 0; u < PU; ++u) acc[u] = 0.f;
              for (int q = qa; q <= qb; ++q) {
                const float w = wx[q * ncol + xi];
#pragma unroll
                for (int u = 0; u < PU; ++u) {
                  const int pp = min(p + u, p1 - 1) - p0;
                  acc[u] = fmaf(w, hdy::to_f32(gs[(pp * M + q) * C + c]), acc[u]);
                }
              }
#pragma unroll
              for (int u = 0; u < PU; ++u)
                if (p + u < p1) wb.r[(p + u) * npair + pr] = hdy::to_f32(hdy::from_f32<T>(acc[u]));
            }
          }
        }
        __syncwarp();
        // patch[y][x][c] = Σ_p Wy[p][y] · R[p][x][c], IG cells a lane at once
        const int ncell = nrow * npair;
        for (int c0 = lane; c0 < ncell; c0 += 32 * IG) {
          float v[IG];
          int yi[IG], ri[IG];
#pragma unroll
          for (int u = 0; u < IG; ++u) {
            v[u] = 0.f;
            const int cell = min(c0 + u * 32, ncell - 1);
            yi[u] = cell / npair;
            ri[u] = cell - yi[u] * npair;
          }
#pragma unroll
          for (int u = 0; u < IG; ++u)
            for (int p = wb.rlo[yi[u]]; p <= wb.rhi[yi[u]]; ++p)
              v[u] = fmaf(wy[p * nrow + yi[u]], wb.r[p * npair + ri[u]], v[u]);
#pragma unroll
          for (int u = 0; u < IG; ++u)
            if (c0 + u * 32 < ncell) wb.patch[c0 + u * 32] = v[u];
        }
      }
    }
    cp_async_wait_all();                 // the buffer is free for the next round
    if (lane == 0) {
      s_big[warp] = k < K && !fast && ylo <= yhi && xlo <= xhi;
      s_foot[warp] = make_int4(ylo, yhi, xlo, xhi);
    }
    // turns: the block's warps add their ROIs into the map in order
    for (int t = 0; t < NWARPS; ++t) {
      __syncthreads();
      if (s_big[t]) {
        // a footprint too large for a warp's buffers: the whole block forms
        // it here, from warp t's entries, R a chunk of bins at a time
        const WarpBuf& wt = reinterpret_cast<const WarpBuf*>(dsm + map_floats)[t];
        const int4 ft = s_foot[t];
        const int nrow = ft.y - ft.x + 1, ncol = ft.w - ft.z + 1, nc = C;
        const T* gt = grad + (static_cast<size_t>(b) * K + round + t * ncl + rank) * M * M * C;
        // the warps' staging buffers are free in the turns: the ROI's whole
        // output gradient goes there at once where it fits
        const int roi_b = M * M * C * static_cast<int>(sizeof(T));
        unsigned char* gall = gbuf - warp * g_bytes;
        if (roi_b <= NWARPS * g_bytes) {
          const unsigned a = static_cast<unsigned>(reinterpret_cast<uintptr_t>(gt)) | roi_b;
          const unsigned char* src = reinterpret_cast<const unsigned char*>(gt);
          if ((a & 15) == 0) {
            for (int i = tid * 16; i < roi_b; i += NTHREADS * 16) cp_async16(gall + i, src + i);
          } else if ((a & 3) == 0) {
            for (int i = tid * 4; i < roi_b; i += NTHREADS * 4) cp_async4(gall + i, src + i);
          } else {
            for (int i = tid * 2; i < roi_b; i += NTHREADS * 2)
              *reinterpret_cast<unsigned short*>(gall + i) =
                  *reinterpret_cast<const unsigned short*>(src + i);
          }
          gt = reinterpret_cast<const T*>(gall);
        }
        for (int j = tid; j < ncol; j += NTHREADS) {
          q_lo[j] = INT_MAX;
          q_hi[j] = -1;
        }
        for (int j = tid; j < nrow; j += NTHREADS) {
          p_lo[j] = INT_MAX;
          p_hi[j] = -1;
        }
        float* wyd = dense;              // [bin][row - ft.x]
        float* wxd = dense + M * nrow;   // [bin][column - ft.z]
        for (int j = tid; j < M * (nrow + ncol); j += NTHREADS) dense[j] = 0.f;
        __syncthreads();
        for (int u = tid; u < 2 * M; u += NTHREADS) {
          const int ax = u >= M, p = ax ? u - M : u;
          for (int e = 0; e < wt.e_cnt[ax][p]; ++e) {
            const int j = wt.e_idx[ax][p * ne + e] - (ax ? ft.z : ft.x);
            if (ax) wxd[p * ncol + j] = wt.e_w[ax][p * ne + e];
            else wyd[p * nrow + j] = wt.e_w[ax][p * ne + e];
            atomicMin(ax ? &q_lo[j] : &p_lo[j], p);
            atomicMax(ax ? &q_hi[j] : &p_hi[j], p);
          }
        }
        cp_async_wait_all();
        __syncthreads();
        // R a chunk of bins at a time, a thread per (bin, column, channel),
        // over the bins reaching its column; then each cell's Σ_p Wy · R
        // over the chunk's bins reaching its row
        const int npair = ncol * nc;
        const int pc = max(1, big_floats / npair);         // bins of R a chunk holds
        for (int pa = 0; pa < M; pa += pc) {
          const int pb = min(M, pa + pc);
          for (int u = tid; u < (pb - pa) * npair; u += NTHREADS) {
            const int pi = u / npair, pr = u - pi * npair, xi = pr / nc, c = pr - xi * nc;
            const T* gp = gt + static_cast<size_t>(pa + pi) * M * C + c;
            float r = 0.f;
            for (int q = q_lo[xi]; q <= q_hi[xi]; ++q)
              r = fmaf(wxd[q * ncol + xi], hdy::to_f32(gp[q * C]), r);
            big[u] = hdy::to_f32(hdy::from_f32<T>(r));
          }
          __syncthreads();
          for (int u = tid; u < nrow * npair; u += NTHREADS) {
            const int yi = u / npair, pr = u - yi * npair;
            float v = 0.f;
            for (int p = max(p_lo[yi], pa); p <= min(p_hi[yi], pb - 1); ++p)
              v = fmaf(wyd[p * nrow + yi], big[(p - pa) * npair + pr], v);
            map[(ft.x + yi) * W * C + ft.z * C + pr] += v;
          }
          __syncthreads();
        }
        continue;
      }
      if (warp != t || ylo > yhi || xlo > xhi) continue;
      const int nrow = yhi - ylo + 1, ncol = xhi - xlo + 1, npair = ncol * C;
      for (int i = lane; i < nrow * npair; i += 32) {
        const int yi = i / npair, rest = i - yi * npair;
        map[(ylo + yi) * W * C + xlo * C + rest] += wb.patch[i];
      }
    }
    __syncthreads();
  }

  // every block sums its slice of the image's gradient over the cluster, in
  // block order, and writes it once
  cluster.sync();
  const int hwc = H * W * C;
  T* out = static_cast<T*>(m.out) + static_cast<size_t>(b) * hwc;
  for (int i = rank * NTHREADS + tid; i < hwc; i += ncl * NTHREADS) {
    float v[MAX_CLUSTER];
#pragma unroll
    for (int r = 0; r < MAX_CLUSTER; ++r) v[r] = r < ncl ? cluster.map_shared_rank(map, r)[i] : 0.f;
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < MAX_CLUSTER; ++r) s += v[r];
    out[i] = hdy::from_f32<T>(s);
  }
  cluster.sync();                        // no block leaves while its map is read
}

template <typename T>
int launch_rois(const RoiMap& m, const float4* boxes, int B, int K, int n, int aligned,
                cudaStream_t s) {
  auto kern = roi_patch_cluster_kernel<T>;
  constexpr int NWARPS = NTHREADS / 32;
  const int map_floats = (m.H * m.W * m.C + 3) / 4 * 4;
  static int last_device = -1, max_cluster = 0, smem_max = 0;
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.blockDim = dim3(NTHREADS, 1, 1);
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (device != last_device) {
    e = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (e != cudaSuccess) return static_cast<int>(e);
    cudaFuncAttributes fa{};
    e = cudaFuncGetAttributes(&fa, kern);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_max -= static_cast<int>(fa.sharedSizeBytes);   // the static part
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_max);
    if (e != cudaSuccess) return static_cast<int>(e);
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return static_cast<int>(e);
    // the largest cluster that fits at the most shared memory a block takes
    max_cluster = 8;
    int active = 0;
    cfg.gridDim = dim3(MAX_CLUSTER, 1, 1);
    cfg.dynamicSmemBytes = smem_max;
    attr[0].val.clusterDim.x = MAX_CLUSTER;
    if (cudaOccupancyMaxActiveClusters(&active, kern, &cfg) == cudaSuccess && active > 0)
      max_cluster = MAX_CLUSTER;
    cudaGetLastError();                  // an unsupported size is not an error of the launch
    last_device = device;
  }
  // the rest of the block's shared memory stages output-gradient rows: the
  // whole ROI where it fits
  const int big_floats = std::min(BIG_FLOATS, (m.M * m.W * m.C + 3) / 4 * 4);
  const int fixed = map_floats * 4 + NWARPS * static_cast<int>(sizeof(WarpBuf)) + big_floats * 4 +
                    (m.M * (m.H + m.W) + 3) / 4 * 16;
  const int roi_bytes = (m.M * m.M * m.C * static_cast<int>(sizeof(T)) + 15) / 16 * 16;
  const int g_bytes = std::min(roi_bytes, (smem_max - fixed) / NWARPS / 16 * 16);
  if (g_bytes < m.M * m.C * static_cast<int>(sizeof(T)))
    return static_cast<int>(cudaErrorInvalidValue);
  // enough blocks that a round gives every ROI of an image a warp, in
  // powers of two up to the largest cluster
  int ncl = 1;
  while (ncl < max_cluster && ncl * NWARPS < K) ncl *= 2;
  cfg.gridDim = dim3(B * ncl, 1, 1);
  cfg.dynamicSmemBytes = fixed + NWARPS * g_bytes;
  attr[0].val.clusterDim.x = ncl;
  e = cudaLaunchKernelEx(&cfg, kern, m, boxes, K, n, aligned, map_floats, big_floats, g_bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  return hdy::launch_status();
}

}  // namespace

// table: host array of L rows of 16 int64 (output-gradient pointer, map
// gradient pointer, H, W, C, M, bands, column blocks, columns a block,
// slabs, channels a slab, log2 of the lanes a column, scale as the bits of
// an f32, 0, 0, 0); each output gradient (B, K, M, M, C) and map gradient
// (B, H, W, C) contiguous, of one dtype.  boxes (B, K, 4) f32 xyxy image
// coordinates, 16-byte aligned.  dtype: 0 f32, 1 bf16; vec: 1 for 16-byte
// vectors (every C and slab a multiple of 8 for bf16 or 4 for f32, every
// pointer 16-byte aligned), 0 for the scalar path.  aligned: 0 is
// torchvision's legacy aligned=False.  The tiling must be the wrapper's
// (`_bwd_plan`): checked.
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
  int m_max = 1, cb_max = 1;
  for (int i = 0; i < L; ++i) {
    const long long* r = table + 16 * i;
    lv.grad[i] = reinterpret_cast<const void*>(r[0]);
    lv.out[i] = reinterpret_cast<void*>(r[1]);
    const int H = lv.H[i] = static_cast<int>(r[2]);
    const int W = lv.W[i] = static_cast<int>(r[3]);
    const int C = lv.C[i] = static_cast<int>(r[4]);
    const int M = lv.M[i] = static_cast<int>(r[5]);
    lv.nband[i] = static_cast<int>(r[6]);
    lv.ncb[i] = static_cast<int>(r[7]);
    lv.cb[i] = static_cast<int>(r[8]);
    lv.nslab[i] = static_cast<int>(r[9]);
    lv.cs[i] = static_cast<int>(r[10]);
    lv.lpc_log2[i] = static_cast<int>(r[11]);
    const uint32_t bits = static_cast<uint32_t>(r[12]);
    memcpy(&lv.scale[i], &bits, 4);
    const int lpc = 1 << std::min(std::max(lv.lpc_log2[i], 0), 8);
    if (H < 1 || H > GATHER_SIDE || W < 1 || W > GATHER_SIDE || C < 1 || C % V || M < 1 ||
        M * n > MAX_S || lv.lpc_log2[i] < 0 || lv.lpc_log2[i] > 8 || lv.cs[i] < V ||
        lv.cs[i] % V || lv.cs[i] / V > lpc || lv.cb[i] < 1 || lv.cb[i] > MAX_CB ||
        lv.cb[i] * lpc > NTHREADS || lv.nband[i] != (H + BH - 1) / BH ||
        lv.ncb[i] != (W + lv.cb[i] - 1) / lv.cb[i] || lv.nslab[i] != (C + lv.cs[i] - 1) / lv.cs[i])
      return static_cast<int>(cudaErrorInvalidValue);
    m_max = std::max(m_max, M);
    cb_max = std::max(cb_max, lv.cb[i]);
    lv.start[i] = static_cast<int>(items);
    items += static_cast<long long>(B) * lv.nband[i] * lv.ncb[i] * lv.nslab[i];
    if (items > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  }
  lv.start[L] = static_cast<int>(items);
  if (items == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* bx = static_cast<const float4*>(boxes);
  if (dtype == 1)
    return vec ? launch<__nv_bfloat16, 8>(lv, bx, K, n, aligned, m_max, cb_max, s)
               : launch<__nv_bfloat16, 1>(lv, bx, K, n, aligned, m_max, cb_max, s);
  return vec ? launch<float, 4>(lv, bx, K, n, aligned, m_max, cb_max, s)
             : launch<float, 1>(lv, bx, K, n, aligned, m_max, cb_max, s);
}

// The per-ROI path for one map: grad (B, K, M, M, C) and out (B, H, W, C)
// contiguous, of one dtype; boxes (B, K, 4) f32 xyxy image coordinates,
// 16-byte aligned; scale as the bits of an f32.  dtype: 0 f32, 1 bf16.
// H, W <= MAX_SIDE, H·W·C·4 <= MAP_BYTES, M·n <= ROI_MAX_S, W·C <= BIG_FLOATS,
// M·(H + W) <= DENSE_FLOATS
// and a row of M x C output gradient
// within ROW_CAP bytes (the wrapper's `_bwd_plan` checks; here again).
HDY_EXPORT int roi_align_levels_bwd_rois(const void* grad, void* out, const void* boxes, int B,
                                         int K, int H, int W, int C, int M, int n, int scale_bits,
                                         int aligned, int dtype, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (B < 0 || K < 1 || n < 1 || H < 1 || H > MAX_SIDE || W < 1 || W > MAX_SIDE || C < 1 ||
      M < 1 || M * n > ROI_MAX_S || static_cast<long long>(H) * W * C * 4 > MAP_BYTES ||
      static_cast<long long>(M) * C * (dtype == 1 ? 2 : 4) > ROW_CAP ||
      static_cast<long long>(W) * C > BIG_FLOATS || static_cast<long long>(M) * (H + W) > DENSE_FLOATS)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  RoiMap m{grad, out, H, W, C, M, 0.f};
  const uint32_t bits = static_cast<uint32_t>(scale_bits);
  memcpy(&m.scale, &bits, 4);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* bx = static_cast<const float4*>(boxes);
  return dtype == 1 ? launch_rois<__nv_bfloat16>(m, bx, B, K, n, aligned, s)
                    : launch_rois<float>(m, bx, B, K, n, aligned, s);
}
