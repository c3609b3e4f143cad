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
//   dF[b][h][w][c] = Σ_k Σ_p Σ_q Wy_k[p][h] · Wx_k[q][w] · g[k][p][q][c]
// over every ROI k of image b on that level below `active`.  Taps outside
// the window or the ROI's bounds carry no weight; the boxes get no gradient.
//
// Bound on an H100: memory.  At both training steps' shapes the output
// gradient (1024 ROIs x 14 x 14 x 256 bf16, 103 MB; hnet's 2048 x 7 x 7, 51
// MB) is read once and the 34.8 M level-gradient elements (70 MB in bf16)
// are written once.  Design: a deterministic gather in two launches, with no
// f32 copy of the level maps and no atomics on data.
//   1. `roi_tables_kernel`, a block per ROI and one per (image, level): a
//      thread per (axis, bin) merges the bin's taps as the forward does
//      (`roi_taps.cuh`), then the block sorts both axes' entries by (level
//      index, bin) and writes, per ROI, a small record: each axis' entries
//      in that order, the run of entries of every index of its footprint,
//      the footprint in tiles (`fpt`), whether some index is reached by more
//      than two entries (dense: a small ROI) and whether its output
//      gradient is all zero (read until a nonzero value turns up: the ROIs
//      a loss passes over, a batch's padding among them).  The last B·L
//      blocks list each (image, level)'s ROIs below `active` in ROI order.
//   2. `roi_gather_kernel`, a block per tile (image, level, TH rows x 8
//      columns, channel slab): the block keeps the listed ROIs whose
//      footprint reaches the tile and whose output gradient is not all
//      zero, in ROI order, and starts their records towards L1 and their
//      output gradients towards L2.  A group of lanes owns one tile row (a
//      lane per 16-byte channel vector, 8 cells a lane in f32 registers).
//      A sparse ROI (large: a cell reached by at most two bins an axis)
//      each warp takes for its rows alone, with no block barrier: Wx of the
//      bins reaching the tile's columns laid out densely in its shared
//      memory, G[q] = Σ_p wy · g[p][q] over its row's entries, then Wx · G
//      into each column.  A dense ROI (small, many bins a cell) the whole
//      block takes together: its tables at the tile (warps 0 and 1), its
//      rows of output gradient staged by one round of 16-byte cp.async,
//      R[p][x] = Σ_q Wx · g a lane group per (bin, column), then each row's
//      cells add Σ_p Wy · R.  Every cell is written once, in the maps'
//      dtype, with 16-byte stores; cells no ROI reaches get 0.
// Sums run in ROI order, then bin order: two launches on the same inputs
// give bit-identical outputs.  What holds it above its bound: the per-ROI
// latency of a tile's visits (tables, then rows of g) where many ROIs reach
// one tile — hnet's 7x7 calls list tens of dense and sparse ROIs on a
// tile, each visited in turn.

#include <algorithm>
#include <climits>

#include "roi_taps.cuh"
#include "roi_single.cuh"

namespace {

constexpr int MAX_S = 64;              // M * n samples per axis
constexpr int MAX_E = 2 * MAX_S;       // entries per axis (<= 2 per sample)
constexpr int MAX_L = 8;               // pyramid levels
constexpr int TAB_THREADS = 128;       // launch 1: a block per ROI
constexpr int NTHREADS = 256;          // launch 2: a block per tile
constexpr int NWARPS = NTHREADS / 32;
constexpr int TW = 8;                  // tile columns: the cells a lane owns
constexpr int CHUNK = 512;             // ROIs listed per round of the gather
constexpr int PER = CHUNK / NTHREADS;
constexpr int R_FLOATS = 6 * 1024;     // dense ROIs: R of a chunk of bins (24 KB),
constexpr int G_STAGE = 48 * 1024;     //   and their output gradient's rows for it (bytes)

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

// A tile range [lo, hi] (each < 2^16) in one int, and the test against it.
__device__ __forceinline__ int pack_range(int lo, int hi) {
  return static_cast<int>(static_cast<unsigned>(lo) | (static_cast<unsigned>(hi) << 16));
}
__device__ __forceinline__ bool in_range(int packed, int t) {
  const unsigned u = static_cast<unsigned>(packed);
  return static_cast<int>(u & 0xffffu) <= t && t <= static_cast<int>(u >> 16);
}

struct Levels {
  void* out[MAX_L];                    // (B, H, W, C) level gradient
  int H[MAX_L], W[MAX_L], moff[MAX_L];
  int nty[MAX_L], ntx[MAX_L], nslab[MAX_L];
  int start[MAX_L + 1];                // first tile of each level; start[L] = total
  int L;
};

// One ROI's record in the tables buffer, at a stride of `rec` bytes:
//   int4 {lo_y, span_y, lo_x, span_x}       footprint in level indices
//   float w[2][e_max]                       entries sorted by (index, bin)
//   uint8 bin[2][e_max]
//   uint8 run[2][rs]                        run[a][i - lo] = first entry of index i
struct Rec {
  int e_max, rs, bytes;
  __device__ const float* w(const unsigned char* r, int a) const {
    return reinterpret_cast<const float*>(r + 16) + a * e_max;
  }
  __device__ const unsigned char* bin(const unsigned char* r, int a) const {
    return r + 16 + 8 * e_max + a * e_max;
  }
  __device__ const unsigned char* run(const unsigned char* r, int a) const {
    return r + 16 + 10 * e_max + a * rs;
  }
};

// Block `key` (image key / L, level key % L) of launch 1's first B·L blocks:
// the ROIs below `act` of that image and level, in ROI order, into
// lists[key][i] for i < counts[key].
__device__ void bucket(const int4* __restrict__ meta, long long act, int K, int B, int L, int key,
                       int* __restrict__ counts, int* __restrict__ lists) {
  __shared__ int s_wc[2][TAB_THREADS / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bb = key / L, ll = key - bb * L;
  int* list = lists + static_cast<size_t>(key) * K;
  const long long live = min(act, static_cast<long long>(K));
  int nf = 0;
  for (int base = 0, r = 0; base < K; base += TAB_THREADS, ++r) {
    const int k = base + tid;
    bool mine = false;
    if (k < live) {
      const int4 mt = meta[k];
      mine = min(max(mt.x, 0), B - 1) == bb && min(max(mt.w, 0), L - 1) == ll;
    }
    const unsigned mm = __ballot_sync(0xffffffffu, mine);
    if (lane == 0) s_wc[r & 1][warp] = __popc(mm);
    __syncthreads();
    int off = nf, tot = nf;
#pragma unroll
    for (int w = 0; w < TAB_THREADS / 32; ++w) {
      const int cw = s_wc[r & 1][w];
      off += w < warp ? cw : 0;
      tot += cw;
    }
    if (mine) list[off + __popc(mm & ((1u << lane) - 1u))] = k;
    nf = tot;
  }
  if (tid == 0) counts[key] = nf;
}

__global__ void __launch_bounds__(TAB_THREADS)
roi_tables_kernel(const Levels lv, const int4* __restrict__ meta, const float* __restrict__ ys,
                  const float* __restrict__ xs, const float4* __restrict__ bounds,
                  const long long* __restrict__ active, int K, int B, int win_h, int win_w,
                  int M, int n, int bf16, int TH, const Rec rc, unsigned char* __restrict__ tabs,
                  int4* __restrict__ fpt, int* __restrict__ counts, int* __restrict__ lists,
                  const void* __restrict__ grad, int C) {
  __shared__ int s_idx[2][MAX_E];        // [axis][bin * 2n + e]
  __shared__ float s_w[2][MAX_E];
  __shared__ int s_cnt[2][MAX_S];
  __shared__ int s_lo[2], s_hi[2];
  __shared__ int s_dense;                // some index reached by more than two entries

  const int k = blockIdx.x, tid = threadIdx.x;
  const long long act = active ? *active : static_cast<long long>(K);
  if (k >= K) {                          // the blocks past the ROIs list them by (image, level)
    bucket(meta, act, K, B, lv.L, k - K, counts, lists);
    return;
  }
  if (k >= act) {
    if (tid == 0) fpt[k] = make_int4(-1, 0, 0, 0);
    return;
  }
  const int S = M * n, ne = 2 * n;
  // whether the ROI's output gradient is all zero (signs ignored), so that
  // the gather can pass it over: rounds of one load a thread, until one
  // sees a nonzero value (16-byte loads where aligned, else the 2-byte
  // halves: of bf16 one each, of f32 the sign bit in the upper one)
  bool nz = false, any = false;
  {
    const size_t bytes = static_cast<size_t>(M) * M * C * (bf16 ? 2 : 4);
    const unsigned char* gk = static_cast<const unsigned char*>(grad) + k * bytes;
    if (((reinterpret_cast<uintptr_t>(gk) | bytes) & 15) == 0) {
      const unsigned mask = bf16 ? 0x7fff7fffu : 0x7fffffffu;
      for (size_t i = tid; i < bytes / 16 + tid; i += TAB_THREADS) {
        if (i < bytes / 16) {
          const uint4 v = reinterpret_cast<const uint4*>(gk)[i];
          nz |= ((v.x | v.y | v.z | v.w) & mask) != 0;
        }
        if ((any = __syncthreads_or(nz))) break;
      }
    } else {
      const unsigned short* h = reinterpret_cast<const unsigned short*>(gk);
      for (size_t i = tid; i < bytes / 2 + tid; i += TAB_THREADS) {
        if (i < bytes / 2) nz |= (h[i] & (bf16 || (i & 1) ? 0x7fffu : 0xffffu)) != 0;
        if ((any = __syncthreads_or(nz))) break;
      }
    }
  }
  const int zero = !any;
  const int4 mt = meta[k];               // (image, oy, ox, level)
  const float4 bd = bounds[k];           // (lo_y, hi_y, lo_x, hi_x) window-local
  const int l = min(max(mt.w, 0), lv.L - 1);
  const int b = min(max(mt.x, 0), B - 1);
  const int H = lv.H[l], W = lv.W[l];
  if (tid < 2) {
    s_lo[tid] = INT_MAX;
    s_hi[tid] = -1;
  }
  if (tid == 0) s_dense = 0;
  __syncthreads();

  // a bin's entries: its n samples' taps merged per level index in sample
  // order, the mean over n, rounded as the forward rounds, zeros dropped
  for (int t = tid; t < 2 * M; t += TAB_THREADS) {
    const int a = t >= M, p = a ? t - M : t;
    const float* coords = (a ? xs : ys) + static_cast<size_t>(k) * S;
    const float lo = a ? bd.z : bd.x, hi = a ? bd.w : bd.y;
    const int win = a ? win_w : win_h, size = a ? W : H;
    const int origin = a ? mt.z : mt.y - lv.moff[l];
    int* ei = &s_idx[a][p * ne];
    float* ew = &s_w[a][p * ne];
    int cnt = 0;
    for (int s = p * n; s < (p + 1) * n; ++s) {
      int ti[2];
      float tw[2];
      hdy::sample_taps(coords[s], lo, hi, win, ti, tw);
      for (int u = 0; u < 2; ++u) {
        if (ti[u] < 0) continue;
        const int li = min(max(origin + ti[u], 0), size - 1);
        int e = 0;
        while (e < cnt && ei[e] != li) ++e;
        if (e == cnt) {
          ei[cnt] = li;
          ew[cnt] = tw[u];
          ++cnt;
        } else {
          ew[e] += tw[u];
        }
      }
    }
    int kept = 0;
    for (int e = 0; e < cnt; ++e) {
      float w = ew[e] / static_cast<float>(n);
      if (bf16) w = hdy::round_bf16(w);
      if (w != 0.f) {
        ei[kept] = ei[e];
        ew[kept] = w;
        ++kept;
      }
    }
    s_cnt[a][p] = kept;
    for (int e = 0; e < kept; ++e) {
      atomicMin(&s_lo[a], ei[e]);
      atomicMax(&s_hi[a], ei[e]);
    }
  }
  __syncthreads();
  if (s_hi[0] < 0 || s_hi[1] < 0) {      // no tap reaches the level
    if (tid == 0) fpt[k] = make_int4(-1, 0, 0, 0);
    return;
  }

  unsigned char* r = tabs + static_cast<size_t>(k) * rc.bytes;
  float* w_out[2] = {reinterpret_cast<float*>(r + 16), reinterpret_cast<float*>(r + 16) + rc.e_max};
  unsigned char* b_out[2] = {r + 16 + 8 * rc.e_max, r + 16 + 9 * rc.e_max};
  unsigned char* run_out[2] = {r + 16 + 10 * rc.e_max, r + 16 + 10 * rc.e_max + rc.rs};
  // each entry's place in its axis' (index, bin) order
  for (int t = tid; t < 2 * M * ne; t += TAB_THREADS) {
    const int a = t >= M * ne, at = a ? t - M * ne : t;
    const int p = at / ne, e = at - p * ne;
    if (e >= s_cnt[a][p]) continue;
    const int i = s_idx[a][at];
    int rank = 0;
    for (int p2 = 0; p2 < M; ++p2)
      for (int e2 = 0; e2 < s_cnt[a][p2]; ++e2) {
        const int i2 = s_idx[a][p2 * ne + e2];
        rank += (i2 < i) || (i2 == i && p2 < p);
      }
    w_out[a][rank] = s_w[a][at];
    b_out[a][rank] = static_cast<unsigned char>(p);
  }
  // the first entry of each footprint index (and one past the last index)
  const int span0 = s_hi[0] - s_lo[0] + 1, span1 = s_hi[1] - s_lo[1] + 1;
  for (int t = tid; t < span0 + span1 + 2; t += TAB_THREADS) {
    const int a = t > span0, j = a ? t - span0 - 1 : t;
    const int i = s_lo[a] + j;
    int c = 0, same = 0;
    for (int p2 = 0; p2 < M; ++p2)
      for (int e2 = 0; e2 < s_cnt[a][p2]; ++e2) {
        c += s_idx[a][p2 * ne + e2] < i;
        same += s_idx[a][p2 * ne + e2] == i;
      }
    run_out[a][j] = static_cast<unsigned char>(c);
    if (same > 2) s_dense = 1;
  }
  __syncthreads();
  if (tid == 0) {
    *reinterpret_cast<int4*>(r) = make_int4(s_lo[0], span0, s_lo[1], span1);
    fpt[k] = make_int4(b * MAX_L + l, pack_range(s_lo[0] / TH, s_hi[0] / TH),
                       pack_range(s_lo[1] / TW, s_hi[1] / TW), s_dense | (zero << 1));
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(NTHREADS, 2)
roi_gather_kernel(const Levels lv, const T* __restrict__ grad,
                  const unsigned char* __restrict__ tabs, const int4* __restrict__ fpt,
                  const int* __restrict__ counts, const int* __restrict__ lists, int K, int C,
                  int M, int TH, int cvs, int lpc_log2, const Rec rc) {
  using VV = hdy::Vec<T, V>;
  using Raw = typename VV::Raw;
  __shared__ int s_k[CHUNK];             // the listed ROIs: index,
  __shared__ char s_dn[CHUNK];           //   dense (1) or sparse (0),
  __shared__ int4 s_fp[CHUNK];           //   footprint (rows lo..hi, cols lo..hi)
  __shared__ int s_wc[2][NWARPS];
  extern __shared__ float4 r_smem4[];    // dense ROIs: R of a chunk of bins at the tile's columns
  __shared__ float s_wx[MAX_S * TW];     //   Wx of the ROI's bins at the tile's columns
  __shared__ float s_rw[MAX_E];          //   the entries of the tile's rows: weight,
  __shared__ int s_rp[MAX_E];            //   bin
  __shared__ int s_rng[5];               //   first / last bin q, first / last bin p, first row entry
  __shared__ float s_wxw[NWARPS][MAX_S * TW];  // sparse ROIs, per warp: Wx as above,
  __shared__ float s_ryw[NWARPS][MAX_E];       //   the warp's rows' entries: weight,
  __shared__ int s_ryp[NWARPS][MAX_E];         //   bin x M

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int unit = blockIdx.x, l = 0;
  while (unit >= lv.start[l + 1]) ++l;
  unit -= lv.start[l];
  const int nslab = lv.nslab[l], ntx = lv.ntx[l], nty = lv.nty[l];
  const int slab = unit % nslab;
  unit /= nslab;
  const int tx = unit % ntx;
  unit /= ntx;
  const int ty = unit % nty, b = unit / nty;
  const int H = lv.H[l], W = lv.W[l];
  const int x0 = tx * TW;
  const int cv = lane & ((1 << lpc_log2) - 1);
  const int y = ty * TH + warp * (32 >> lpc_log2) + (lane >> lpc_log2);
  const int ncv = C / V, c0 = slab * cvs;
  const bool live = cv < min(cvs, ncv - c0) && y < H;
  const int c = (c0 + cv) * V;
  const int key = b * MAX_L + l;
  unsigned char* gs = reinterpret_cast<unsigned char*>(r_smem4);
  float* R = reinterpret_cast<float*>(gs + G_STAGE);
  const int rs = cvs * V;                // floats of a cell's slab in R
  const int grp = lane >> lpc_log2, groups = 32 >> lpc_log2;
  const int cw = min(cvs, ncv - c0);     // channel vectors of this slab

  float acc[TW][V];
#pragma unroll
  for (int j = 0; j < TW; ++j)
#pragma unroll
    for (int i = 0; i < V; ++i) acc[j][i] = 0.f;

  // the ROIs of this tile's image and level (launch 1's list), in rounds of CHUNK
  const int* mine = lists + static_cast<size_t>(b * lv.L + l) * K;
  const int nk = K > 0 ? counts[b * lv.L + l] : 0;
  float* wxw = s_wxw[warp];
  float* ryw = s_ryw[warp];
  int* ryp = s_ryp[warp];
  for (int k0 = 0; k0 < nk; k0 += CHUNK) {
    __syncthreads();                     // the previous round's walk is done
    // those of them whose footprint reaches this tile and whose output
    // gradient is not all zero, in ROI order
    int kk[PER];
    int4 f[PER];
#pragma unroll
    for (int r = 0; r < PER; ++r) {
      const int j = k0 + r * NTHREADS + tid;
      kk[r] = j < nk ? mine[j] : -1;
    }
#pragma unroll
    for (int r = 0; r < PER; ++r) f[r] = kk[r] >= 0 ? fpt[kk[r]] : make_int4(-1, 0, 0, 0);
    int nl = 0;
#pragma unroll
    for (int r = 0; r < PER; ++r) {
      const bool hit =
          f[r].x == key && in_range(f[r].y, ty) && in_range(f[r].z, tx) && !(f[r].w & 2);
      const unsigned m = __ballot_sync(0xffffffffu, hit);
      if (lane == 0) s_wc[r & 1][warp] = __popc(m);
      __syncthreads();
      int off = nl, tot = nl;
#pragma unroll
      for (int w = 0; w < NWARPS; ++w) {
        const int cw = s_wc[r & 1][w];
        off += w < warp ? cw : 0;
        tot += cw;
      }
      if (hit) {
        const int at = off + __popc(m & ((1u << lane) - 1u));
        s_k[at] = kk[r];
        s_dn[at] = static_cast<char>(f[r].w & 1);
      }
      nl = tot;
    }
    __syncthreads();
    for (int i = tid; i < nl; i += NTHREADS) {
      const int4 h = *reinterpret_cast<const int4*>(tabs + static_cast<size_t>(s_k[i]) * rc.bytes);
      s_fp[i] = make_int4(h.x, h.x + h.y - 1, h.z, h.z + h.w - 1);
      // the ROI's record on its way to L1 and its output gradient to L2
      // before the walk reaches them
      const unsigned char* rec = tabs + static_cast<size_t>(s_k[i]) * rc.bytes;
      for (int o = 0; o < rc.bytes; o += 128)
        asm volatile("prefetch.global.L1 [%0];\n" ::"l"(rec + o));
      const T* gk = grad + static_cast<size_t>(s_k[i]) * M * M * C;
      const unsigned long long bytes = static_cast<unsigned long long>(M) * M * C * sizeof(T);
      if (((reinterpret_cast<uintptr_t>(gk) | bytes) & 15) == 0 && bytes < (1ull << 31))
        asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(gk),
                     "r"(static_cast<unsigned>(bytes)) : "memory");
    }
    __syncthreads();

    // the listed ROIs in order.  A dense one (some index reached by more
    // than two entries: small ROIs, many bins a cell) the whole block takes
    // together: its tables at the tile (warps 0 and 1), R of the bins
    // reaching the tile's rows at its columns (a lane group per (bin,
    // column)), then each row's cells.  A sparse one (large ROIs, a cell
    // reached by at most two bins an axis) each warp takes for its rows
    // alone, with no block barrier.
    for (int i = 0; i < nl; ++i) {
      const int4 fp = s_fp[i];
      const int k = s_k[i];
      const unsigned char* r = tabs + static_cast<size_t>(k) * rc.bytes;
      const unsigned char* run_y = rc.run(r, 0);
      if (!s_dn[i]) {
        // a row in the footprint that no entry reaches (a large ROI's
        // samples are pixels apart) has nothing to add
        const bool in = live && y >= fp.x && y <= fp.y && run_y[y - fp.x] < run_y[y - fp.x + 1];
        if (!__any_sync(0xffffffffu, in)) continue;
        // the entries of the tile's columns, [E0, E1) in (index, bin) order:
        // lane j < TW holds the start of column x0 + j's run
        const int xa = max(x0, fp.z), xb = min(x0 + TW - 1, fp.w);
        const unsigned char* run_x = rc.run(r, 1);
        const int E0 = run_x[xa - fp.z], E1 = run_x[xb - fp.z + 1];
        const int xj = min(max(x0 + (lane & (TW - 1)), xa), xb + 1);
        const int ej = run_x[xj - fp.z];
        // and the row entries of the warp's rows, [A0, A1)
        const int wrow = ty * TH + warp * groups;
        const int ya = max(wrow, fp.x), yb = min(min(wrow + groups, H) - 1, fp.y);
        const int A0 = run_y[ya - fp.x], A1 = run_y[yb - fp.x + 1];
        const float* wx_e = rc.w(r, 1);
        const unsigned char* bx_e = rc.bin(r, 1);
        int eq[MAX_E / 32], ecol[MAX_E / 32];
        float ew[MAX_E / 32];
        int qlo = INT_MAX, qhi = -1;
#pragma unroll
        for (int t = 0; t < MAX_E / 32; ++t) {
          const int e = E0 + t * 32 + lane;
          eq[t] = e < E1 ? bx_e[e] : -1;
          ew[t] = e < E1 ? wx_e[e] : 0.f;
          int col = 0;
#pragma unroll
          for (int j = 1; j < TW; ++j) col += __shfl_sync(0xffffffffu, ej, j) <= e;
          ecol[t] = col;
          if (e < E1) {
            qlo = min(qlo, eq[t]);
            qhi = max(qhi, eq[t]);
          }
        }
        qlo = __reduce_min_sync(0xffffffffu, qlo);
        qhi = __reduce_max_sync(0xffffffffu, qhi);
        if (qlo > qhi) continue;
        const int nq = qhi - qlo + 1;
        __syncwarp();                    // the previous run's readers are done
        for (int t = lane; t < nq * TW; t += 32) wxw[t] = 0.f;
        const float* wy_e = rc.w(r, 0);
        const unsigned char* by_e = rc.bin(r, 0);
        for (int a = A0 + lane; a < A1; a += 32) {
          ryw[a - A0] = wy_e[a];
          ryp[a - A0] = by_e[a] * M;
        }
        __syncwarp();
#pragma unroll
        for (int t = 0; t < MAX_E / 32; ++t)
          if (eq[t] >= 0) wxw[(eq[t] - qlo) * TW + ecol[t]] = ew[t];
        __syncwarp();
        if (!in) continue;
        const int a0 = run_y[y - fp.x] - A0, a1 = run_y[y - fp.x + 1] - A0;
        const T* gk = grad + (static_cast<size_t>(k) * M * M + qlo) * C + c;
        // per pair of bins q: G[q] = Σ_p wy · g[p][q] over the row's
        // entries, then each column adds Wx · G
        for (int q0 = 0; q0 < nq; q0 += 2) {
          const bool two = q0 + 1 < nq;
          float G[2][V];
#pragma unroll
          for (int t = 0; t < V; ++t) G[0][t] = G[1][t] = 0.f;
          for (int a = a0; a < a1; ++a) {
            const float wy = ryw[a];
            const T* g0 = gk + static_cast<size_t>(ryp[a] + q0) * C;
            const Raw u0 = *reinterpret_cast<const Raw*>(g0);
            const Raw u1 = *reinterpret_cast<const Raw*>(g0 + (two ? C : 0));
            float v[V];
            VV::unpack(u0, v);
#pragma unroll
            for (int t = 0; t < V; ++t) G[0][t] = fmaf(wy, v[t], G[0][t]);
            VV::unpack(u1, v);
#pragma unroll
            for (int t = 0; t < V; ++t) G[1][t] = fmaf(wy, v[t], G[1][t]);
          }
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            if (u == 1 && !two) break;
#pragma unroll
            for (int j = 0; j < TW; ++j) {
              const float w = wxw[(q0 + u) * TW + j];
              if (w != 0.f)
#pragma unroll
                for (int t = 0; t < V; ++t) acc[j][t] = fmaf(w, G[u][t], acc[j][t]);
            }
          }
        }
        continue;
      }
      const int ya = max(ty * TH, fp.x), yb = min(min(ty * TH + TH, H) - 1, fp.y);
      const int xa = max(x0, fp.z), xb = min(min(x0 + TW, W) - 1, fp.w);
      const int ncol = xb - xa + 1;
      __syncthreads();                   // the previous ROI's readers are done
      if (warp == 0) {
        // the bins reaching the tile's columns, and their weights there:
        // lane j < ncol takes column xa + j's run
        const unsigned char* run_x = rc.run(r, 1);
        const unsigned char* bx_e = rc.bin(r, 1);
        const float* wx_e = rc.w(r, 1);
        int e0 = 0, e1 = 0;
        if (lane < ncol) {
          e0 = run_x[xa - fp.z + lane];
          e1 = run_x[xa - fp.z + lane + 1];
        }
        int qlo = INT_MAX, qhi = -1;
        for (int e = e0; e < e1; ++e) {
          qlo = min(qlo, static_cast<int>(bx_e[e]));
          qhi = max(qhi, static_cast<int>(bx_e[e]));
        }
        qlo = __reduce_min_sync(0xffffffffu, qlo);
        qhi = __reduce_max_sync(0xffffffffu, qhi);
        for (int t = lane; t < (qhi - qlo + 1) * TW; t += 32) s_wx[t] = 0.f;
        __syncwarp();
        for (int e = e0; e < e1; ++e) s_wx[(bx_e[e] - qlo) * TW + lane] = wx_e[e];
        if (lane == 0) {
          s_rng[0] = qlo;
          s_rng[1] = qhi;
        }
      } else if (warp == 1) {
        // the entries of the tile's rows, and the bins they reach
        const unsigned char* by_e = rc.bin(r, 0);
        const float* wy_e = rc.w(r, 0);
        const int A0 = run_y[ya - fp.x], A1 = run_y[yb - fp.x + 1];
        int plo = INT_MAX, phi = -1;
        for (int a = A0 + lane; a < A1; a += 32) {
          const int p = by_e[a];
          s_rp[a - A0] = p;
          s_rw[a - A0] = wy_e[a];
          plo = min(plo, p);
          phi = max(phi, p);
        }
        plo = __reduce_min_sync(0xffffffffu, plo);
        phi = __reduce_max_sync(0xffffffffu, phi);
        if (lane == 0) {
          s_rng[2] = plo;
          s_rng[3] = phi;
          s_rng[4] = A0;
        }
      }
      __syncthreads();
      const int qlo = s_rng[0], nq = s_rng[1] - qlo + 1, pa = s_rng[2], pb = s_rng[3];
      if (nq < 1 || pa > pb) continue;
      const int A0 = s_rng[4];
      // a chunk of bins at a time: its rows of output gradient (bins [p0,
      // p1) x [qlo, qhi], the slab) arrive in shared memory by one round of
      // 16-byte cp.async (the vector path), R is formed, then the rows add it
      const bool staged = V > 1;
      const int row_b = cw * V * static_cast<int>(sizeof(T));
      int pc = max(1, R_FLOATS / (ncol * rs));   // bins of R a chunk holds
      if (staged) pc = min(pc, max(1, G_STAGE / (nq * row_b)));
      for (int p0 = pa; p0 <= pb; p0 += pc) {
        const int p1 = min(pb + 1, p0 + pc);
        __syncthreads();                 // the readers of R or of the staged rows are done
        if (staged) {
          const int per = row_b / 16;
          const unsigned char* g0 = reinterpret_cast<const unsigned char*>(
              grad + (static_cast<size_t>(k) * M * M + static_cast<size_t>(p0) * M + qlo) * C + c0 * V);
          for (int it = tid; it < (p1 - p0) * nq * per; it += NTHREADS) {
            const int rr = it / per, ch = it - rr * per, pi = rr / nq, qi = rr - pi * nq;
            cp_async16(gs + static_cast<size_t>(rr) * row_b + ch * 16,
                       g0 + (static_cast<size_t>(pi) * M + qi) * C * sizeof(T) + ch * 16);
          }
          asm volatile("cp.async.wait_all;\n" ::: "memory");
          __syncthreads();
        }
        // R[p][x] = Σ_q Wx[q][x] · g[p][q]: a lane group per (bin, column),
        // bins with no weight at the column skipped
        for (int pr = warp * groups + grp; pr < (p1 - p0) * ncol; pr += NWARPS * groups) {
          if (cv >= cw) continue;
          const int pi = pr / ncol, jj = pr - pi * ncol;
          float acc_r[V];
#pragma unroll
          for (int t = 0; t < V; ++t) acc_r[t] = 0.f;
          if (staged) {
            const T* gp = reinterpret_cast<const T*>(gs + static_cast<size_t>(pi) * nq * row_b) + cv * V;
            for (int q = 0; q < nq; ++q) {
              const float w = s_wx[q * TW + jj];
              if (w != 0.f) {
                float v[V];
                VV::unpack(*reinterpret_cast<const Raw*>(gp + static_cast<size_t>(q) * cw * V), v);
#pragma unroll
                for (int t = 0; t < V; ++t) acc_r[t] = fmaf(w, v[t], acc_r[t]);
              }
            }
          } else {
            const T* gp =
                grad + (static_cast<size_t>(k) * M * M + static_cast<size_t>(p0 + pi) * M + qlo) * C + c;
            for (int q = 0; q < nq; ++q) {
              const float w = s_wx[q * TW + jj];
              if (w != 0.f) {
                float v[V];
                VV::unpack(*reinterpret_cast<const Raw*>(gp + static_cast<size_t>(q) * C), v);
#pragma unroll
                for (int t = 0; t < V; ++t) acc_r[t] = fmaf(w, v[t], acc_r[t]);
              }
            }
          }
          float* dst = R + (static_cast<size_t>(pr) * rs + cv * V);
#pragma unroll
          for (int t = 0; t < V; ++t) dst[t] = acc_r[t];
        }
        __syncthreads();
        // each row's cells add Σ_p Wy[p][y] · R[p][x] over its entries in the chunk
        if (live && y >= ya && y <= yb) {
          const int a0 = run_y[y - fp.x] - A0, a1 = run_y[y - fp.x + 1] - A0;
          for (int a = a0; a < a1; ++a) {
            const int p = s_rp[a];
            if (p < p0 || p >= p1) continue;
            const float wy = s_rw[a];
            const float* src = R + (static_cast<size_t>(p - p0) * ncol - (xa - x0)) * rs + cv * V;
#pragma unroll
            for (int j = 0; j < TW; ++j) {
              if (x0 + j >= xa && x0 + j <= xb) {
#pragma unroll
                for (int t = 0; t < V; ++t) acc[j][t] = fmaf(wy, src[j * rs + t], acc[j][t]);
              }
            }
          }
        }
      }
    }
  }

  if (!live) return;
  T* o = static_cast<T*>(lv.out[l]) + (static_cast<size_t>(b) * H + y) * W * C + c;
#pragma unroll
  for (int j = 0; j < TW; ++j)
    if (x0 + j < W) *reinterpret_cast<Raw*>(o + static_cast<size_t>(x0 + j) * C) = VV::pack(acc[j]);
}

template <typename T, int V>
int launch(const Levels& lv, int B, const void* grad, const void* meta, const void* ys,
           const void* xs, const void* bounds, const void* active, unsigned char* work, int K,
           int C, int win_h, int win_w, int M, int n, int TH, int cvs, int lpc_log2, const Rec& rc,
           cudaStream_t s) {
  // work: footprints (K int4), list counts (B·L ints), the lists (B·L x K
  // ints), records (K x rc.bytes), each part at a 16-byte multiple
  const int nkey = B * lv.L;
  int4* fpt = reinterpret_cast<int4*>(work);
  int* counts = reinterpret_cast<int*>(work + static_cast<size_t>(K) * sizeof(int4));
  int* lists = counts + (nkey + 3) / 4 * 4;
  unsigned char* tabs =
      reinterpret_cast<unsigned char*>(lists + (static_cast<size_t>(nkey) * K + 3) / 4 * 4);
  if (K > 0 && nkey > 0) {
    roi_tables_kernel<<<K + nkey, TAB_THREADS, 0, s>>>(
        lv, static_cast<const int4*>(meta), static_cast<const float*>(ys),
        static_cast<const float*>(xs), static_cast<const float4*>(bounds),
        static_cast<const long long*>(active), K, B, win_h, win_w, M, n, sizeof(T) == 2, TH, rc,
        tabs, fpt, counts, lists, grad, C);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int units = lv.start[lv.L];
  static int last_device = -1;
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (device != last_device) {
    e = cudaFuncSetAttribute(roi_gather_kernel<T, V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             G_STAGE + R_FLOATS * static_cast<int>(sizeof(float)));
    if (e != cudaSuccess) return static_cast<int>(e);
    last_device = device;
  }
  if (units > 0)
    roi_gather_kernel<T, V><<<units, NTHREADS, G_STAGE + R_FLOATS * sizeof(float), s>>>(
        lv, static_cast<const T*>(grad), tabs, fpt, counts, lists, K, C, M, TH, cvs, lpc_log2, rc);
  return hdy::launch_status();
}

}  // namespace

// table: host array of (L + 1) rows of 8 int64.  Row 0, the plan: tile rows
// TH, channel vectors a slab `cvs`, log2 of the lanes a tile row `lpc`, the
// record stride in bytes, entries an axis `e_max`, run length `rs`, batch B,
// 0.  Rows 1..L, per level: gradient pointer ((B, H, W, C), the maps'
// dtype), H, W, row offset, tiles down, tiles across, slabs, 0.  grad (K, M, M,
// C) in the maps' dtype; meta (K, 4) int32 (image, oy, ox, level); ys/xs (K,
// M*n) f32 window-local; bounds (K, 4) f32 window-local; active: device int64
// count of leading ROIs, or null for all K; work: K x 16 bytes of footprints
// then K records, 16-byte aligned.  dtype: 0 f32, 1 bf16; vec: 1 for
// 16-byte channel vectors (C a multiple of 8 for bf16 or 4 for f32, grad and
// the gradients 16-byte aligned), 0 for single elements.  1 <= L <= 8,
// M*n <= 64; the plan must be the wrapper's (`_bounded_bwd_plan`): checked.
HDY_EXPORT int roi_align_bounded_bwd(const long long* table, int L, const void* grad,
                                     const void* meta, const void* ys, const void* xs,
                                     const void* bounds, const void* active, void* work, int K,
                                     int C, int win_h, int win_w, int M, int n, int dtype, int vec,
                                     int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int V = vec ? (dtype == 1 ? 8 : 4) : 1;
  if (L < 1 || L > MAX_L || M < 1 || n < 1 || M * n > MAX_S || C < 1 || C % V || K < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long* plan = table;
  const int TH = static_cast<int>(plan[0]), cvs = static_cast<int>(plan[1]);
  const int lpc_log2 = static_cast<int>(plan[2]);
  const Rec rc{static_cast<int>(plan[4]), static_cast<int>(plan[5]), static_cast<int>(plan[3])};
  const int ncv = C / V;
  if (lpc_log2 < 0 || lpc_log2 > 5 || cvs < 1 || cvs > (1 << lpc_log2) || cvs > ncv ||
      TH != NWARPS * (32 >> lpc_log2) || rc.e_max != 2 * M * n ||
      rc.bytes < 16 + 10 * rc.e_max + 2 * rc.rs || rc.bytes % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const int B = static_cast<int>(plan[6]);
  if (B < 0) return static_cast<int>(cudaErrorInvalidValue);
  Levels lv{};
  lv.L = L;
  long long units = 0;
  for (int i = 0; i < L; ++i) {
    const long long* row = table + 8 * (i + 1);
    lv.out[i] = reinterpret_cast<void*>(row[0]);
    lv.H[i] = static_cast<int>(row[1]);
    lv.W[i] = static_cast<int>(row[2]);
    lv.moff[i] = static_cast<int>(row[3]);
    lv.nty[i] = static_cast<int>(row[4]);
    lv.ntx[i] = static_cast<int>(row[5]);
    lv.nslab[i] = static_cast<int>(row[6]);
    if (lv.H[i] < 1 || lv.W[i] < 1 || rc.rs < std::max(lv.H[i], lv.W[i]) + 1 ||
        lv.nty[i] != (lv.H[i] + TH - 1) / TH || lv.ntx[i] != (lv.W[i] + TW - 1) / TW ||
        lv.nty[i] > 0xffff || lv.ntx[i] > 0xffff || lv.nslab[i] != (ncv + cvs - 1) / cvs)
      return static_cast<int>(cudaErrorInvalidValue);
    lv.start[i] = static_cast<int>(units);
    units += static_cast<long long>(B) * lv.nty[i] * lv.ntx[i] * lv.nslab[i];
    if (units > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  }
  lv.start[L] = static_cast<int>(units);
  unsigned char* w = static_cast<unsigned char*>(work);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return vec ? launch<__nv_bfloat16, 8>(lv, B, grad, meta, ys, xs, bounds, active, w, K, C, win_h,
                                          win_w, M, n, TH, cvs, lpc_log2, rc, s)
               : launch<__nv_bfloat16, 1>(lv, B, grad, meta, ys, xs, bounds, active, w, K, C, win_h,
                                          win_w, M, n, TH, cvs, lpc_log2, rc, s);
  return vec ? launch<float, 4>(lv, B, grad, meta, ys, xs, bounds, active, w, K, C, win_h, win_w,
                                M, n, TH, cvs, lpc_log2, rc, s)
             : launch<float, 1>(lv, B, grad, meta, ys, xs, bounds, active, w, K, C, win_h, win_w,
                                M, n, TH, cvs, lpc_log2, rc, s);
}
