// Multiscale bilinear ROI-align with per-ROI bounds, on the flat packed
// layout: one ROI list across the batch, each ROI with its image, its pyramid
// level, its window origin in level-stacked (canvas) coordinates, and its own
// valid bounds.  The level maps are read where they lie: a small table of
// (pointer, H, W, row offset) passed by value names each level, and nothing
// stacks them into one canvas first.
//
// Replaces the TPU kernels hd_yolo_tpu/ops/pallas_roi_align.py
// `_canvas_kernel` / `_canvas_kernel_v4` (reached through
// `multiscale_roi_align_canvas_pallas`), and serves the main path's
// windowed packed pooling (ops/roi_align.py `multiscale_roi_align_packed`).
// Same function as `Wy · F · Wxᵀ` with the bin-pooled bounded
// interpolation matrices of `_bounded_interp_matrix`: per sample coordinate
// c with valid window [lo, hi): in_range = lo-1 < c < hi; c clamps to
// [lo, hi-1]; the two taps floor(c) and min(floor(c)+1, hi-1) get weights
// 1-frac and frac (zero when out of range); a tap outside the gathered
// window [0, win) contributes nothing (the packed path's border truncation);
// each output bin averages its n x n samples.  A contributing tap's canvas
// row r lies in its level's rows [moff, moff + H), so the kernel reads level
// row r - moff: exact, since every other canvas row has zero weight.
//
// Bound on an H100: memory.  At the main path's shape (768 ROIs x 14 x 14 x
// 256 bf16) the output is 77 MB and each ROI reads at most a 16 x 16 window
// of 512-byte cells.  Design (separable, as the plain version contracts):
//   1. per ROI (one 512-thread block), the sample taps of both axes, then
//      each output bin's merged (index, weight) entries, a thread per bin:
//      the nonzeros of the bin-pooled rows of Wy and Wx, rounded to the
//      compute dtype as the plain version rounds its matrices; the touched
//      columns compacted by one warp's running-max scan;
//   2. the row intermediate R[p][col] = Σ Wy[p][h]·F[h][col] over the bin's
//      few rows, a warp per (p, col) pixel, 16-byte loads of 8 bf16 channels
//      a lane (a bin's up to four rows loaded at once: one round trip), f32
//      sums rounded to the compute dtype (the plain version's rounding
//      point), kept in shared memory for a group of bin rows;
//   3. out[p][q] = Σ Wx[q][col]·R[p][col] from shared memory, a warp per
//      output pixel, f32 sums, one 16-byte store a lane.
// Per ROI this is ~M·(ncol + M)·4·C multiply-adds instead of the direct
// form's M²·16·C, and each level cell is read from L2 about once per bin row
// that uses it.  Block size and buffer (512 threads, 16 KB) are the fastest
// of the sizes tried on an H100; the kernel issues about as many unpack and
// address instructions as FMAs, which is what holds it above its byte bound.
// A ROI whose intermediate exceeds the shared buffer (hnet's whole-canvas
// windows) runs the same loop in groups of bin rows and, past that, in
// channel slabs.  ROIs at or past the device-side `active` count are written
// as zeros with 16-byte stores.  No atomics: a relaunch is bit-identical.

#include "roi_taps.cuh"

namespace {

constexpr int NTHREADS = 512;          // >= 128: the bin tables use threads 0..127
constexpr int MAX_S = 64;              // M * n samples per axis
constexpr int MAX_E = 2 * MAX_S;       // tap entries per axis (<= 2 per sample)
constexpr int MAX_L = 8;               // pyramid levels
constexpr int R_BYTES = 16 * 1024;     // shared buffer of the row intermediate

struct Levels {
  const void* ptr[MAX_L];
  int H[MAX_L], W[MAX_L], moff[MAX_L];
  int L;
};

// 16-byte vectors: 8 bf16 or 4 f32 channels, unpacked to f32.
template <typename T> struct Vec;

template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void unpack(const uint4 u, float* v) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ uint4 pack(const float* v) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    return u;
  }
  static __device__ __forceinline__ float round(float w) { return hdy::round_bf16(w); }
};

template <> struct Vec<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void unpack(const uint4 u, float* v) {
    v[0] = __uint_as_float(u.x);
    v[1] = __uint_as_float(u.y);
    v[2] = __uint_as_float(u.z);
    v[3] = __uint_as_float(u.w);
  }
  static __device__ __forceinline__ uint4 pack(const float* v) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                      __float_as_uint(v[3]));
  }
  static __device__ __forceinline__ float round(float w) { return w; }
};

// acc = Σ_e w[e] · vector(e) over a bin's `cnt` entries, in entry order,
// f32.  The first four vectors (all of them when n = 2) are loaded before
// any is used, so a pixel costs one memory round trip, not one per entry.
template <typename V, typename Load>
__device__ __forceinline__ void contract(float* acc, int cnt, const float* w, Load load) {
  uint4 raw[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (e < cnt) raw[e] = load(e);
#pragma unroll
  for (int i = 0; i < V::N; ++i) acc[i] = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (e < cnt) {
      float v[V::N];
      V::unpack(raw[e], v);
#pragma unroll
      for (int i = 0; i < V::N; ++i) acc[i] = fmaf(w[e], v[i], acc[i]);
    }
  }
  for (int e = 4; e < cnt; ++e) {
    float v[V::N];
    V::unpack(load(e), v);
#pragma unroll
    for (int i = 0; i < V::N; ++i) acc[i] = fmaf(w[e], v[i], acc[i]);
  }
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
roi_align_kernel(const Levels lv, const int4* __restrict__ meta, const float* __restrict__ ys,
                 const float* __restrict__ xs, const float4* __restrict__ bounds,
                 const long long* __restrict__ active, T* __restrict__ out, int K, int C,
                 int win_h, int win_w, int M, int n, int CS) {
  using V = Vec<T>;
  constexpr int VEC = V::N;
  constexpr int NWARPS = NTHREADS / 32;
  extern __shared__ __align__(16) unsigned char r_smem[];
  T* R = reinterpret_cast<T*>(r_smem);
  __shared__ int s_idx[2][MAX_E];        // [axis][sample * 2 + tap]: window index, -1 = none
  __shared__ float s_w[2][MAX_E];
  __shared__ int s_j[MAX_E];             // x taps: compact column, -1 = none
  __shared__ int e_idx[2][MAX_E];        // [axis][bin * 2n + e]: y level row, x compact column
  __shared__ float e_w[2][MAX_E];
  __shared__ int e_cnt[2][MAX_S];
  __shared__ int cols[MAX_E];            // compact column → level column
  __shared__ int s_ncol;

  const int k = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  T* o = out + static_cast<size_t>(k) * M * M * C;
  const long long act = active ? *active : static_cast<long long>(K);
  if (k >= act) {
    uint4* oz = reinterpret_cast<uint4*>(o);
    for (int i = tid; i < M * M * C / VEC; i += NTHREADS) oz[i] = make_uint4(0u, 0u, 0u, 0u);
    return;
  }

  const int S = M * n;
  const int4 mt = meta[k];                 // (image, oy, ox, level)
  const float4 bd = bounds[k];             // (lo_y, hi_y, lo_x, hi_x) window-local
  const int l = min(max(mt.w, 0), lv.L - 1);
  const int H = lv.H[l], W = lv.W[l];
  for (int s = tid; s < 2 * S; s += NTHREADS) {
    const int ax = s >= S, q = s - ax * S;
    const float c = (ax ? xs : ys)[static_cast<size_t>(k) * S + q];
    hdy::sample_taps(c, ax ? bd.z : bd.x, ax ? bd.w : bd.y, ax ? win_w : win_h,
                     &s_idx[ax][2 * q], &s_w[ax][2 * q]);
  }
  __syncthreads();

  // The x taps' level columns compacted, one warp: in sample order each tap
  // is either above every earlier one (a new column) or equal to an earlier
  // one (floor is monotone and the second tap is the first + 1 or equal, and
  // the clamp keeps that), so a running-max scan finds the new columns.
  if (warp == 0) {
    int count = 0, runmax = -1;
    for (int c0 = 0; c0 < 2 * S; c0 += 32) {
      const int ci = c0 + lane;
      int v = -1;
      if (ci < 2 * S && s_idx[1][ci] >= 0) v = min(max(mt.z + s_idx[1][ci], 0), W - 1);
      int m = v;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, m, off);
        if (lane >= off) m = max(m, u);
      }
      int before = __shfl_up_sync(0xffffffffu, m, 1);
      before = max(lane == 0 ? -1 : before, runmax);
      const bool fresh = v >= 0 && v > before;
      const unsigned bal = __ballot_sync(0xffffffffu, fresh);
      const int rank = count + __popc(bal & ((1u << lane) - 1u));
      if (fresh) cols[rank] = v;
      __syncwarp();
      count += __popc(bal);
      runmax = max(runmax, __shfl_sync(0xffffffffu, m, 31));
      int j = -1;
      if (fresh) {
        j = rank;
      } else if (v >= 0) {
        j = count - 1;
        while (j > 0 && cols[j] != v) --j;
      }
      if (ci < 2 * S) s_j[ci] = j;
    }
    if (lane == 0) s_ncol = count;
  }
  __syncthreads();

  // Each bin's entries, a thread per bin and axis: its n samples' taps merged
  // by index (summed in sample order), the mean over n, rounded to the
  // compute dtype as the plain version rounds its matrices.
  if (tid < M || (tid >= 64 && tid < 64 + M)) {
    const int ax = tid >= 64, p = tid - ax * 64;
    const int base = p * 2 * n;
    int cnt = 0;
    for (int ci = p * 2 * n; ci < (p + 1) * 2 * n; ++ci) {
      int idx = ax ? s_j[ci] : s_idx[0][ci];
      if (idx < 0) continue;
      if (!ax) idx = min(max(mt.y + idx - lv.moff[l], 0), H - 1);   // window row → level row
      int e = 0;
      while (e < cnt && e_idx[ax][base + e] != idx) ++e;
      if (e == cnt) {
        e_idx[ax][base + cnt] = idx;
        e_w[ax][base + cnt] = s_w[ax][ci];
        ++cnt;
      } else {
        e_w[ax][base + e] += s_w[ax][ci];
      }
    }
    int kept = 0;
    for (int e = 0; e < cnt; ++e) {
      const float w = V::round(e_w[ax][base + e] / static_cast<float>(n));
      if (w != 0.f) {
        e_idx[ax][base + kept] = e_idx[ax][base + e];
        e_w[ax][base + kept] = w;
        ++kept;
      }
    }
    e_cnt[ax][p] = kept;
  }
  __syncthreads();

  const int ncol = s_ncol;
  const T* f = static_cast<const T*>(lv.ptr[l]) + static_cast<size_t>(mt.x) * H * W * C;
  for (int c0 = 0; c0 < C; c0 += CS) {
    const int cw = min(CS, C - c0), nch = cw / VEC;
    const int per_p = max(ncol, 1) * cw * static_cast<int>(sizeof(T));
    const int pg = max(1, min(M, R_BYTES / per_p));
    for (int p0 = 0; p0 < M; p0 += pg) {
      const int np = min(pg, M - p0);
      // R[pp][j] for the group's bin rows, a warp per (row, column) pixel:
      // Σ over the bin's rows of the level map
      for (int px = warp; px < np * ncol; px += NWARPS) {
        const int p = p0 + px / ncol, j = px - (px / ncol) * ncol;
        const int base = p * 2 * n, cnt = e_cnt[0][p];
        const T* src = f + static_cast<size_t>(cols[j]) * C + c0;
        T* dst = R + static_cast<size_t>(px) * cw;
        for (int ch = lane; ch < nch; ch += 32) {
          float acc[VEC];
          contract<V>(acc, cnt, &e_w[0][base], [&](int e) {
            return __ldg(reinterpret_cast<const uint4*>(
                src + static_cast<size_t>(e_idx[0][base + e]) * W * C + ch * VEC));
          });
          *reinterpret_cast<uint4*>(dst + ch * VEC) = V::pack(acc);
        }
      }
      __syncthreads();
      // out[p][q] = Σ over the bin's columns of R[p], a warp per output pixel
      for (int px = warp; px < np * M; px += NWARPS) {
        const int pp = px / M, q = px - pp * M;
        const int base = q * 2 * n, cnt = e_cnt[1][q];
        const T* row = R + static_cast<size_t>(pp) * ncol * cw;
        T* dst = o + (static_cast<size_t>(p0 + pp) * M + q) * C + c0;
        for (int ch = lane; ch < nch; ch += 32) {
          float acc[VEC];
          contract<V>(acc, cnt, &e_w[1][base], [&](int e) {
            return *reinterpret_cast<const uint4*>(
                row + static_cast<size_t>(e_idx[1][base + e]) * cw + ch * VEC);
          });
          *reinterpret_cast<uint4*>(dst + ch * VEC) = V::pack(acc);
        }
      }
      __syncthreads();
    }
  }
}

template <typename T>
int launch(const long long* table, int L, const void* meta, const void* ys, const void* xs,
           const void* bounds, const void* active, void* out, int K, int C, int win_h, int win_w,
           int M, int n, int device, cudaStream_t s) {
  constexpr int VEC = Vec<T>::N;
  if (C % VEC != 0) return static_cast<int>(cudaErrorInvalidValue);
  static unsigned long long attr_set = 0ull;      // devices whose attribute is set
  if (device < 64 && !((attr_set >> device) & 1ull)) {
    const cudaError_t e = cudaFuncSetAttribute(
        roi_align_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, R_BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set |= 1ull << device;
  }
  Levels lv{};
  lv.L = L;
  for (int i = 0; i < L; ++i) {
    lv.ptr[i] = reinterpret_cast<const void*>(table[4 * i]);
    lv.H[i] = static_cast<int>(table[4 * i + 1]);
    lv.W[i] = static_cast<int>(table[4 * i + 2]);
    lv.moff[i] = static_cast<int>(table[4 * i + 3]);
  }
  // channel slab: the widest multiple of VEC whose one bin row of R fits
  const int ncol_max = min(win_w, 2 * M * n);
  const int CS = min(C, R_BYTES / (ncol_max * static_cast<int>(sizeof(T))) / VEC * VEC);
  roi_align_kernel<T><<<K, NTHREADS, R_BYTES, s>>>(
      lv, static_cast<const int4*>(meta), static_cast<const float*>(ys),
      static_cast<const float*>(xs), static_cast<const float4*>(bounds),
      static_cast<const long long*>(active), static_cast<T*>(out), K, C, win_h, win_w, M, n, CS);
  return hdy::launch_status();
}

}  // namespace

// table: host array of L rows (level pointer, H, W, row offset) as int64,
// each level (B, H, W, C) f32|bf16 contiguous; meta (K, 4) int32 (image, oy,
// ox, level); ys/xs (K, M*n) f32 window-local sample coords; bounds (K, 4)
// f32 (lo_y, hi_y, lo_x, hi_x) window-local; active: device int64 count of
// leading ROIs to pool (the rest written as 0), or null for all K; out (K,
// M, M, C) in the levels' dtype.  dtype: 0 f32, 1 bf16.  C % 8 == 0 (bf16)
// or C % 4 == 0 (f32), 16-byte aligned levels, 1 <= L <= 8, M*n <= 64.
HDY_EXPORT int roi_align_bounded(const long long* table, int L, const void* meta, const void* ys,
                                 const void* xs, const void* bounds, const void* active,
                                 void* out, int K, int C, int win_h, int win_w, int M, int n,
                                 int dtype, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (L < 1 || L > MAX_L || M < 1 || n < 1 || M * n > MAX_S || win_w < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (K == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(table, L, meta, ys, xs, bounds, active, out, K, C, win_h, win_w,
                                 M, n, device, s);
  return launch<float>(table, L, meta, ys, xs, bounds, active, out, K, C, win_h, win_w, M, n,
                       device, s);
}
