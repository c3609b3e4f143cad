// Single-level bilinear ROI-align over several maps in one launch: (B, K)
// boxes, each pooled from its own image's (H_l, W_l, C_l) map of every level
// l into an M_l x M_l grid of n x n-sample bins, each level at its own scale.
//
// Replaces the TPU kernel hd_yolo_tpu/ops/pallas_roi_align.py `_kernel`
// (reached through `roi_align_pallas` / `_roi_align_pallas_impl`), the
// Pallas form of the JAX `roi_align` (`Wy · F · Wxᵀ` with interpolation
// matrices built in VMEM).  Same function and rounding points as the plain
// version (ops/roi_align.py `roi_align`, as the JAX path computes it): per
// sample coordinate, torchvision `aligned=False` rules (centres y1 + (s +
// 0.5)·roi_h / (M·n), roi_w/h at least 1; a sample outside (-1, size)
// contributes zero; an in-range coordinate clamps to [0, size-1] and its
// taps are floor(c) and min(floor(c) + 1, size-1)), computed with explicit
// _rn intrinsics in the plain version's op order so no FMA contraction
// moves a sample across a tap or range boundary; each bin's taps merged per
// index in sample order, divided by n and rounded to the compute dtype (the
// plain version's bf16 matrices); the row intermediate Σ Wy·F rounded to
// the compute dtype; the column sum Σ Wx·R in f32, one write.  A bin of two
// distinct rows and two distinct columns (every bin of hnet's pyramid, where
// M = the map's size) sums two exact bf16 products per step, so the result
// cannot depend on order: bit for bit the plain version at bf16.
//
// Bound on an H100: memory.  hnet-nucls pools one 640 px tile ROI per image
// from each of four levels (4, S, S, 256) bf16, S = 160/80/40/20, at M = S
// and n = 2: 69.6 MB read once and 69.6 MB written, ~0.042 ms at 3.35 TB/s;
// the arithmetic is ~5x below that.  Design:
//   * One launch for all levels: a by-value table of per-level pointers,
//     shapes, M, scale, band height and channel slab.  Persistent blocks (2
//     per SM) walk work items (level, ROI, band of output rows, channel
//     slab), largest level first, so the small levels fill the last round.
//   * Per item, a thread per bin builds the merged (index, weight) entries
//     of the band's rows and of every output column; one warp compacts the
//     band's distinct input rows (at most 2n a bin) with match/ballot, and
//     the column range comes from warp reductions: one barrier.
//   * Each distinct input row of the band is read from device memory once,
//     one channel slab at a time, as 16-byte cp.async copies into shared
//     memory (8 output rows need 9 input rows at level 0: 1.125 reads per
//     byte instead of the 4 taps per output the direct form issues).
//   * Separable contraction out of shared memory: rows first (the row value
//     rounded to the compute dtype), then columns, 16-byte vectors of 8 bf16
//     or 4 f32 channels a thread.  A thread takes a run of 4 output columns
//     of one output row and keeps the last row value it computed, which the
//     next bin reuses when it starts on that column: no shared buffer and
//     no barrier for the row intermediate.
//   * Generic boxes keep working: the wrapper picks each level's band height
//     so that the band's most rows (2n a bin) at the map's whole width fit
//     the buffer one vector wide, and the kernel narrows the channel slab
//     to what the item's rows and column range need; C % 8 != 0 (bf16),
//     C % 4 != 0 (f32) or unaligned maps take a scalar path with element
//     copies.

#include <climits>
#include <cstring>

#include "roi_single.cuh"

namespace {

constexpr int NTHREADS = 256;
constexpr int MAX_L = 8;               // levels in one launch
constexpr int MAX_S = 512;             // M * n samples per axis
constexpr int MAX_YE = 128;            // y entries of a band: band rows * 2n
constexpr int T_BYTES = 96 * 1024;     // staged input rows of a band and slab
constexpr int QRUN = 4;                // output columns a thread computes in a row

struct Levels {
  const void* feat[MAX_L];
  void* out[MAX_L];
  int H[MAX_L], W[MAX_L], C[MAX_L], M[MAX_L];
  int bh[MAX_L], nband[MAX_L], nslab[MAX_L], cs[MAX_L];
  float scale[MAX_L];
  int start[MAX_L + 1];                // first work item of each level; start[L] = total
  int L;
};

// One row value of a two-entry band row: round(wy0·c0[off] + wy1·c1[off])
// over a vector, summed in entry order as the generic loop does.
template <typename VV, typename T>
__device__ __forceinline__ void row_value(const T* c0, const T* c1, int off, float wy0,
                                          float wy1, float* r) {
  using Raw = typename VV::Raw;
  constexpr int V = sizeof(Raw) / sizeof(T);
  float v0[V], v1[V];
  VV::unpack(*reinterpret_cast<const Raw*>(c0 + off), v0);
  VV::unpack(*reinterpret_cast<const Raw*>(c1 + off), v1);
#pragma unroll
  for (int i = 0; i < V; ++i) r[i] = fmaf(wy1, v1[i], fmaf(wy0, v0[i], 0.f));
  VV::unpack(VV::pack(r), r);                   // rounded to the compute dtype
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

template <typename T, int V>
__global__ void __launch_bounds__(NTHREADS, 2)
roi_align_levels_kernel(const Levels lv, const float4* __restrict__ boxes, int K, int n,
                        int aligned) {
  using VV = hdy::Vec<T, V>;
  using Raw = typename VV::Raw;
  constexpr bool BF16 = sizeof(T) == 2;
  extern __shared__ __align__(16) unsigned char t_smem[];
  T* stage = reinterpret_cast<T*>(t_smem);
  __shared__ short xe_idx[2 * MAX_S];    // [bin * 2n + e]: level column
  __shared__ float xe_w[2 * MAX_S];
  __shared__ unsigned char xe_cnt[MAX_S];
  __shared__ short ye_idx[MAX_YE];       // [band row * 2n + e]: level row, then compact row
  __shared__ float ye_w[MAX_YE];
  __shared__ unsigned char ye_cnt[MAX_YE];
  __shared__ int rows[MAX_YE];           // compact row → level row
  __shared__ int s_nr, s_xlo[NTHREADS / 32], s_xhi[NTHREADS / 32];

  const int tid = threadIdx.x;
  const int total = lv.start[lv.L];
  const float off = aligned ? 0.5f : 0.f;

  for (int item = blockIdx.x; item < total; item += gridDim.x) {
    int l = 0;
    while (item >= lv.start[l + 1]) ++l;
    const int H = lv.H[l], W = lv.W[l], C = lv.C[l], M = lv.M[l], bh = lv.bh[l];
    const int nslab = lv.nslab[l], nband = lv.nband[l];
    const int il = item - lv.start[l];
    const int slab = il % nslab, band = (il / nslab) % nband, roi = il / (nslab * nband);
    const int b = roi / K;
    const int p0 = band * bh, bhe = min(bh, M - p0);
    const int c0 = slab * lv.cs[l], c1 = min(C, c0 + lv.cs[l]);
    const int ne = 2 * n;

    const float4 box = boxes[roi];
    const float scale = lv.scale[l];
    const float x1 = __fsub_rn(__fmul_rn(box.x, scale), off);
    const float y1 = __fsub_rn(__fmul_rn(box.y, scale), off);
    float roi_w = __fsub_rn(__fsub_rn(__fmul_rn(box.z, scale), off), x1);
    float roi_h = __fsub_rn(__fsub_rn(__fmul_rn(box.w, scale), off), y1);
    if (!aligned) {
      roi_w = fmaxf(roi_w, 1.f);
      roi_h = fmaxf(roi_h, 1.f);
    }
    const float S = static_cast<float>(M * n);
    const float bin_w = __fdiv_rn(roi_w, S), bin_h = __fdiv_rn(roi_h, S);

    // the entries, a thread per bin: warp 0 takes the band rows and then
    // compacts their distinct input rows; the other warps take every output
    // column (all M) and reduce their column range a warp at a time.  A bin
    // of one entry is padded to two with a zero weight on the same index
    // (fma(0, v, r) is r), so the item takes the two-entry path when no bin
    // has more.
    const int warp = tid >> 5, lane = tid & 31;
    bool two = true;
    if (warp == 0) {
      int cnt = 0;
      if (lane < bhe) {
        cnt = hdy::bin_entries<BF16>(y1, bin_h, p0 + lane, n, H, &ye_idx[lane * ne],
                                     &ye_w[lane * ne]);
        ye_cnt[lane] = static_cast<unsigned char>(cnt);
        two = cnt <= 2;
      }
      for (int pl = 32 + lane; pl < bhe; pl += 32) {        // bands taller than a warp
        const int c =
            hdy::bin_entries<BF16>(y1, bin_h, p0 + pl, n, H, &ye_idx[pl * ne], &ye_w[pl * ne]);
        ye_cnt[pl] = static_cast<unsigned char>(c);
        two = two && c <= 2;
      }
      __syncwarp();
      // distinct rows in first-use order: a lane per entry slot, 32 at a
      // time; a value is new unless the list or an earlier lane has it
      int nr = 0;
      for (int s0 = 0; s0 < bhe * ne; s0 += 32) {
        const int slot = s0 + lane;
        const bool valid = slot < bhe * ne && slot % ne < ye_cnt[slot / ne];
        const int v = valid ? ye_idx[slot] : -1;
        int j = -1;
        for (int i = 0; i < nr && valid; ++i)
          if (rows[i] == v) j = i;
        const bool fresh = valid && j < 0;
        const unsigned same = __match_any_sync(0xffffffffu, fresh ? v : -2 - lane);
        const int leader = __ffs(same) - 1;
        const unsigned lead = __ballot_sync(0xffffffffu, fresh && leader == lane);
        const int rank = nr + __popc(lead & ((1u << lane) - 1u));
        if (fresh && leader == lane) rows[rank] = v;
        const int at = __shfl_sync(0xffffffffu, rank, leader);
        if (fresh) j = at;
        __syncwarp();
        if (valid) ye_idx[slot] = static_cast<short>(j);
        nr += __popc(lead);
      }
      __syncwarp();
      for (int pl = lane; pl < bhe; pl += 32)
        if (ye_cnt[pl] == 1) {
          ye_idx[pl * ne + 1] = ye_idx[pl * ne];
          ye_w[pl * ne + 1] = 0.f;
        }
      if (lane == 0) s_nr = nr;
    } else {
      int lo = INT_MAX, hi = -1;
      for (int q = tid - 32; q < M; q += NTHREADS - 32) {
        const int cnt = hdy::bin_entries<BF16>(x1, bin_w, q, n, W, &xe_idx[q * ne], &xe_w[q * ne]);
        xe_cnt[q] = static_cast<unsigned char>(cnt);
        two = two && cnt <= 2;
        if (cnt == 1) {
          xe_idx[q * ne + 1] = xe_idx[q * ne];
          xe_w[q * ne + 1] = 0.f;
        }
        for (int e = 0; e < cnt; ++e) {
          lo = min(lo, static_cast<int>(xe_idx[q * ne + e]));
          hi = max(hi, static_cast<int>(xe_idx[q * ne + e]));
        }
      }
      lo = __reduce_min_sync(0xffffffffu, lo);
      hi = __reduce_max_sync(0xffffffffu, hi);
      if (lane == 0) {
        s_xlo[warp] = lo;
        s_xhi[warp] = hi;
      }
    }
    const bool two_entries = __syncthreads_and(two);
    int xlo = INT_MAX, xhi = -1;
#pragma unroll
    for (int w = 1; w < NTHREADS / 32; ++w) {
      xlo = min(xlo, s_xlo[w]);
      xhi = max(xhi, s_xhi[w]);
    }

    const int nr = s_nr;
    const int esz = static_cast<int>(sizeof(T));
    const T* f = static_cast<const T*>(lv.feat[l]) + static_cast<size_t>(b) * H * W * C;
    T* o = static_cast<T*>(lv.out[l]) + (static_cast<size_t>(roi) * M + p0) * M * C;
    // staged: the band's rows x the ROI's column range [xlo, xhi], in
    // sub-slabs of the item's channel slab that fit the buffer (at least one
    // vector wide: the wrapper's band height guarantees it)
    const int ncol = xhi >= xlo ? xhi - xlo + 1 : 0;
    const int csub = max(V, min(T_BYTES / (max(nr, 1) * max(ncol, 1) * esz) / V * V, c1 - c0));

    for (int cc = c0; cc < c1; cc += csub) {
      const int cw = min(csub, c1 - cc), ncv = cw / V;
      // rows x [xlo, xhi] x [cc, cc + cw) as they lie in device memory; the
      // chunk's (row, column, vector) advance by a fixed step, no division
      {
        const int step_cell = NTHREADS / ncv, step_cv = NTHREADS - step_cell * ncv;
        int cv = tid % ncv, gc = tid / ncv, rr = 0;
        while (gc >= ncol && rr < nr) {
          gc -= ncol;
          ++rr;
        }
        while (ncol > 0 && rr < nr) {
          const T* src = f + (static_cast<size_t>(rows[rr]) * W + xlo + gc) * C + cc + cv * V;
          T* dst = stage + (static_cast<size_t>(rr) * ncol + gc) * cw + cv * V;
          if constexpr (V > 1) {
            cp_async16(dst, src);
          } else {
            *dst = *src;
          }
          cv += step_cv;
          gc += step_cell;
          if (cv >= ncv) {
            cv -= ncv;
            ++gc;
          }
          while (gc >= ncol && rr < nr) {
            gc -= ncol;
            ++rr;
          }
        }
      }
      if constexpr (V > 1) cp_async_wait_all();
      __syncthreads();
      // out[p][q] = Σ_x wx · round(Σ_y wy · F[row][col]), a thread per
      // (band row, vector, run of QRUN output columns): a row value is
      // computed once for a bin's last column and reused when the next bin
      // starts there (every column but the run's first, at M = the map's size)
      const int nrun = (M + QRUN - 1) / QRUN;
      if (two_entries) {
        // every bin of two (index, weight) entries on each axis: straight-line
        for (int t = tid; t < bhe * nrun * ncv; t += NTHREADS) {
          const int cv = t % ncv, rest = t / ncv, run = rest % nrun, pl = rest / nrun;
          const bool ny = ye_cnt[pl] > 0;
          const float wy0 = ye_w[pl * ne], wy1 = ye_w[pl * ne + 1];
          const T* c0p = stage + static_cast<size_t>(ye_idx[pl * ne]) * ncol * cw + cv * V;
          const T* c1p = stage + static_cast<size_t>(ye_idx[pl * ne + 1]) * ncol * cw + cv * V;
          T* dst = o + (static_cast<size_t>(pl) * M + run * QRUN) * C + cc + cv * V;
          int cached = -1;
          float rc[V];
#pragma unroll
          for (int u = 0; u < QRUN; ++u) {
            const int q = run * QRUN + u;
            if (q >= M) break;
            float acc[V];
#pragma unroll
            for (int i = 0; i < V; ++i) acc[i] = 0.f;
            if (ny && xe_cnt[q] > 0) {
              const int j0 = xe_idx[q * ne] - xlo, j1 = xe_idx[q * ne + 1] - xlo;
              float r0[V], r1[V];
              row_value<VV>(c0p, c1p, j1 * cw, wy0, wy1, r1);
              if (j0 == cached) {
#pragma unroll
                for (int i = 0; i < V; ++i) r0[i] = rc[i];
              } else {
                row_value<VV>(c0p, c1p, j0 * cw, wy0, wy1, r0);
              }
              const float wx0 = xe_w[q * ne], wx1 = xe_w[q * ne + 1];
#pragma unroll
              for (int i = 0; i < V; ++i) acc[i] = fmaf(wx1, r1[i], fmaf(wx0, r0[i], 0.f));
              cached = j1;
#pragma unroll
              for (int i = 0; i < V; ++i) rc[i] = r1[i];
            }
            *reinterpret_cast<Raw*>(dst + static_cast<size_t>(u) * C) = VV::pack(acc);
          }
        }
        __syncthreads();
        continue;
      }
      for (int t = tid; t < bhe * nrun * ncv; t += NTHREADS) {
        const int cv = t % ncv, rest = t / ncv, run = rest % nrun, pl = rest / nrun;
        const int ny = ye_cnt[pl];
        const short* yi = &ye_idx[pl * ne];
        const float* yw = &ye_w[pl * ne];
        const T* base = stage + cv * V;
        T* dst = o + (static_cast<size_t>(pl) * M + run * QRUN) * C + cc + cv * V;
        int cached = -1;
        float rc[V];
        for (int q = run * QRUN; q < min(M, run * QRUN + QRUN); ++q, dst += C) {
          const int nx = xe_cnt[q];
          float acc[V];
#pragma unroll
          for (int i = 0; i < V; ++i) acc[i] = 0.f;
          for (int ex = 0; ex < nx; ++ex) {
            const int j = xe_idx[q * ne + ex] - xlo;
            float r[V];
            if (j == cached) {
#pragma unroll
              for (int i = 0; i < V; ++i) r[i] = rc[i];
            } else {
              const T* col = base + static_cast<size_t>(j) * cw;
#pragma unroll
              for (int i = 0; i < V; ++i) r[i] = 0.f;
              for (int ey = 0; ey < ny; ++ey) {
                float v[V];
                VV::unpack(*reinterpret_cast<const Raw*>(col + static_cast<size_t>(yi[ey]) *
                                                                   ncol * cw),
                           v);
#pragma unroll
                for (int i = 0; i < V; ++i) r[i] = fmaf(yw[ey], v[i], r[i]);
              }
              VV::unpack(VV::pack(r), r);     // rounded to the compute dtype
              if (ex == nx - 1) {
                cached = j;
#pragma unroll
                for (int i = 0; i < V; ++i) rc[i] = r[i];
              }
            }
            const float wx = xe_w[q * ne + ex];
#pragma unroll
            for (int i = 0; i < V; ++i) acc[i] = fmaf(wx, r[i], acc[i]);
          }
          *reinterpret_cast<Raw*>(dst) = VV::pack(acc);
        }
      }
      __syncthreads();
    }
  }
}

template <typename T, int V>
int launch(const Levels& lv, const float4* boxes, int K, int n, int aligned, int device,
           cudaStream_t s) {
  static int last_device = -1, blocks = 0;
  if (device != last_device) {
    cudaError_t e = cudaFuncSetAttribute(roi_align_levels_kernel<T, V>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, T_BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (e != cudaSuccess) return static_cast<int>(e);
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, roi_align_levels_kernel<T, V>,
                                                      NTHREADS, T_BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    blocks = sms * max(per_sm, 1);
    last_device = device;
  }
  const int total = lv.start[lv.L];
  roi_align_levels_kernel<T, V><<<min(total, blocks), NTHREADS, T_BYTES, s>>>(lv, boxes, K, n,
                                                                             aligned);
  return hdy::launch_status();
}

}  // namespace

// Pooling limits of one launch, for the wrapper's checks and its choice of
// band and slab: levels, samples per axis, y entries of a band, and the
// staged buffer in bytes.
HDY_EXPORT int roi_align_levels_limits(int which) {
  switch (which) {
    case 0: return MAX_L;
    case 1: return MAX_S;
    case 2: return MAX_YE;
    case 3: return T_BYTES;
    default: return 0;
  }
}

// table: host array of L rows of 10 int64 (feature pointer, output pointer,
// H, W, C, M, band rows, channel slab, scale as the bits of an f32, 0); each
// feature map (B, H, W, C) contiguous, each output (B, K, M, M, C) of the
// same dtype.  boxes (B, K, 4) f32 xyxy image coordinates, 16-byte aligned.
// dtype: 0 f32, 1 bf16; vec: 1 for 16-byte vectors (every C a multiple of 8
// for bf16 or 4 for f32, every pointer 16-byte aligned), 0 for the scalar
// path.  aligned: 0 is torchvision's legacy aligned=False.
HDY_EXPORT int roi_align_levels(const long long* table, int L, const void* boxes, int B, int K,
                                int n, int aligned, int dtype, int vec, int device,
                                void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (L < 1 || L > MAX_L || n < 1 || B < 0 || K < 0) return static_cast<int>(cudaErrorInvalidValue);
  Levels lv{};
  lv.L = L;
  long long items = 0;
  for (int i = 0; i < L; ++i) {
    const long long* r = table + 10 * i;
    lv.feat[i] = reinterpret_cast<const void*>(r[0]);
    lv.out[i] = reinterpret_cast<void*>(r[1]);
    lv.H[i] = static_cast<int>(r[2]);
    lv.W[i] = static_cast<int>(r[3]);
    lv.C[i] = static_cast<int>(r[4]);
    lv.M[i] = static_cast<int>(r[5]);
    lv.bh[i] = static_cast<int>(r[6]);
    lv.cs[i] = static_cast<int>(r[7]);
    const uint32_t bits = static_cast<uint32_t>(r[8]);
    memcpy(&lv.scale[i], &bits, 4);
    if (lv.H[i] < 1 || lv.W[i] < 1 || lv.W[i] > SHRT_MAX || lv.H[i] > SHRT_MAX || lv.C[i] < 1 ||
        lv.M[i] < 1 || lv.M[i] * n > MAX_S || lv.bh[i] < 1 || lv.bh[i] * 2 * n > MAX_YE ||
        lv.cs[i] < 1)
      return static_cast<int>(cudaErrorInvalidValue);
    // a band's rows at one bin's column span and the narrowest slab must fit
    const long long cell = vec ? 16 : (dtype == 1 ? 2 : 4);
    if (static_cast<long long>(min(lv.H[i], lv.bh[i] * 2 * n)) * lv.W[i] * cell > T_BYTES)
      return static_cast<int>(cudaErrorInvalidValue);
    lv.nband[i] = (lv.M[i] + lv.bh[i] - 1) / lv.bh[i];
    lv.nslab[i] = (lv.C[i] + lv.cs[i] - 1) / lv.cs[i];
    lv.start[i] = static_cast<int>(items);
    items += static_cast<long long>(B) * K * lv.nband[i] * lv.nslab[i];
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
