// Multi-peak heatmap decoding: relu -> 3x3 blur -> 3x3 NMS -> K
// max-and-suppress rounds -> DARK refinement, per (H, W) map.
//
// Replaces the Pallas TPU kernel `_peak_kernel` behind
// `extract_peaks_pallas`
// (constructionsceneposeestimation_tpu/ops/peak_kernel.py:56, call :187).
// Plain version: ops/peak_kernel.extract_peaks_plain.
//
// Per map:
//   x    = relu(map)
//   hb   = [1 2 1]/4 blur of x, edge clamped, rows first, then columns
//   peak = hb >= (3x3 edge-clamped max of hb) ? x : 0   (raw amplitude)
//   K rounds: take the largest peak value, on ties the lowest row, then the
//   lowest column, and suppress it to 0. Once no positive value is left,
//   every round takes pixel (0, 0) with score 0, as the rounds do on an
//   all-zero map.
//   DARK on log(max(hb, eps)) of the 3x3 neighbourhood (indices clamped),
//   accepted only for interior peaks with dxx < 0, dyy < 0, |offset| < 1.
// Output: uv (N, K, 2) = (column, row) + offset, scores (N, K).
//
// What bounds it on an H100: the single read of the maps. At (64 x 71,
// 128, 128) f32 that is 297.8 MB, ~0.089 ms at 3.35 TB/s; the output is
// 0.44 MB and the arithmetic ~20 operations a pixel. To reach that rate
// the card needs ~1 us x 3.35 TB/s ~ 3 MB of loads in flight, ~25 KB per
// SM, and the on-chip work of a map has to hide under the loads of others.
//
// Design: the map is streamed once, through registers.
// - Tasks. A map is cut into strips of 128 columns (32 lanes x 4 adjacent
//   columns) and bands of 64 rows; one warp walks one (strip, band) task
//   row by row. A block owns one map, with one warp per task up to 8 warps
//   (2 at 128^2), so blocks are small and many maps share an SM: the loads
//   of one map overlap the work of the others.
// - Rolling window. Each lane keeps relu'd rows r, r+1 and blurred rows
//   r-1, r of its 4 columns in registers. A step loads row r+2, blurs row
//   r+1 (vertical taps per column, then across) and decides NMS for row r.
//   Column neighbours cross lanes by shuffles. Lanes 0 and 31 also carry
//   the two halo columns each side of the strip; a band reads 2 halo rows
//   each side. Out-of-map rows and columns are loaded edge-clamped, so the
//   blur sees the plain version's clamps, and their blurred values are set
//   to -1 for the NMS max (hb >= 0), which then equals the clamped max.
// - Loads in flight. Each warp keeps kAhead = 2 rows in flight (16-byte
//   loads a lane where W % 4 == 0, scalar otherwise). The launch bounds
//   hold a thread to 85 registers, so 24 warps share an SM: 24 warps x 2
//   rows x 512 B ~ 24 KB per SM. Tried on the H100 while this was built:
//   24 warps with 2 rows in flight ran faster than 16 warps with 4 (128
//   registers), and bands of 64 rows faster than bands of 32 (more halo
//   rows) or 128 (fewer warps).
// - Candidates. NMS survivors with a positive value go, by ballot and
//   popc, into the warp's buffer in shared memory (K + 128 slots). When a
//   row would overflow it, the warp reduces the buffer in place to its top
//   K (selection rounds in the order value desc, flat index asc) and from
//   then on drops any survivor that does not beat the K-th: a constant map,
//   where every pixel survives, costs one reduction per warp.
// - Selection. Each warp sorts its top K; warp 0 merges the sorted lists
//   (one per lane, K rounds of a warp argmax), padding with (0, 0) at
//   score 0. The order is total, so this equals K rounds over the map.
// - DARK. The block loads the 5 x 5 patch of each peak from the map (in
//   L2/L1 by then) into shared memory at once; thread k then recomputes the
//   blurred 3x3 neighbourhood of peak k in the same operation order. Only
//   interior peaks are refined, as the plain version keeps only theirs.
// No shared-memory copy of the map: any H, W >= 3 and any number of maps.
//
// Rounding: the blur uses uncontracted IEEE operations (__fmul_rn,
// __fadd_rn) in the plain version's order, and the pool and selection only
// compare, so hb, the NMS mask, the positions and the scores are bit-equal
// to the plain version. The DARK step too is written out uncontracted in
// the plain version's order; its logf is the CUDA library's.
#include <climits>
#include <stdint.h>

#include "common.cuh"

namespace cspe {
namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kStripCols = 128;  // 32 lanes x 4 columns
constexpr int kBandRows = 64;
constexpr int kMaxWarps = 8;     // a block's warps; its lists merge on one warp
constexpr int kAhead = 2;        // rows in flight per warp
constexpr int kRowCands = kStripCols;  // most survivors one strip row gives
constexpr int kDarkBatch = 32;   // peaks refined at once
constexpr int kMaxK = 512;       // ops/peak_kernel.MAX_PEAKS

// A warp's candidate slots: K plus a row's worth, in whole warps.
constexpr int cand_cap(int k) { return (k + kRowCands + 31) / 32 * 32; }

// A block's dynamic shared memory: each warp's candidates (value, index),
// the selected top K (value, index), the warps' list lengths, the DARK
// patches.
constexpr size_t smem_bytes(int warps, int k) {
  return (size_t)warps * cand_cap(k) * 8 + (size_t)k * 8 + (size_t)warps * 4 +
         kDarkBatch * 25 * 4;
}
// 48,288 bytes at 8 warps and K = 512: no block needs the opt-in attribute.
static_assert(smem_bytes(kMaxWarps, kMaxK) <= kSmemLimit, "peaks: shared memory above 48 KB");

// The order of the rounds: the larger value first, then the lower flat
// index (the lower row, then the lower column).
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ void warp_best(float& v, int& i, int& slot) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, off);
    const int oi = __shfl_xor_sync(kFull, i, off);
    const int os = __shfl_xor_sync(kFull, slot, off);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
      slot = os;
    }
  }
}

// 0.25 a + 0.5 b + 0.25 c, summed left to right, uncontracted.
__device__ __forceinline__ float tap3(float a, float b, float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(0.25f, a), __fmul_rn(0.5f, b)), __fmul_rn(0.25f, c));
}

// One relu'd row of a lane: its 4 columns and its 2 halo columns (lane 0:
// s0 - 2, s0 - 1; lane 31: s0 + 128, s0 + 129; unused on other lanes).
struct Row {
  float c[4];
  float h[2];
};

__device__ __forceinline__ Row load_row(const float* __restrict__ map, int row, int h, int w,
                                        int g0, int hc0, bool halo, bool vec) {
  Row out;
  const float* p = map + (size_t)min(max(row, 0), h - 1) * w;
  if (vec && g0 + 3 < w) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p + g0));
    out.c[0] = q.x;
    out.c[1] = q.y;
    out.c[2] = q.z;
    out.c[3] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) out.c[j] = __ldg(p + min(g0 + j, w - 1));
  }
  out.h[0] = halo ? __ldg(p + min(max(hc0, 0), w - 1)) : 0.0f;
  out.h[1] = halo ? __ldg(p + min(max(hc0 + 1, 0), w - 1)) : 0.0f;
#pragma unroll
  for (int j = 0; j < 4; ++j) out.c[j] = fmaxf(out.c[j], 0.0f);
  out.h[0] = fmaxf(out.h[0], 0.0f);
  out.h[1] = fmaxf(out.h[1], 0.0f);
  return out;
}

// The blurred row between relu'd rows a (above), b, c (below): hb[j] at the
// lane's columns, hbh at its halo column (lane 0: s0 - 1; lane 31: s0 + 128).
// Out-of-map rows and columns give -1 (neutral in the NMS max).
__device__ __forceinline__ void blur_row(const Row& a, const Row& b, const Row& c, int lane,
                                         bool blur, bool row_out, const bool col_out[4],
                                         bool halo_out, float hb[4], float& hbh) {
  float v[4], vh0, vh1;
  if (blur) {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = tap3(a.c[j], b.c[j], c.c[j]);
    vh0 = tap3(a.h[0], b.h[0], c.h[0]);
    vh1 = tap3(a.h[1], b.h[1], c.h[1]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = b.c[j];
    vh0 = b.h[0];
    vh1 = b.h[1];
  }
  float vl = __shfl_up_sync(kFull, v[3], 1);
  float vr = __shfl_down_sync(kFull, v[0], 1);
  if (lane == 0) vl = vh1;   // column s0 - 1 (column 0 itself at the map's edge)
  if (lane == 31) vr = vh0;  // column s0 + 128 (clamped at the map's edge)
  if (blur) {
    hb[0] = tap3(vl, v[0], v[1]);
    hb[1] = tap3(v[0], v[1], v[2]);
    hb[2] = tap3(v[1], v[2], v[3]);
    hb[3] = tap3(v[2], v[3], vr);
    hbh = lane == 0 ? tap3(vh0, vh1, v[0]) : tap3(v[3], vh0, vh1);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) hb[j] = v[j];
    hbh = lane == 0 ? vh1 : vh0;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) hb[j] = (row_out || col_out[j]) ? -1.0f : hb[j];
  hbh = (row_out || halo_out) ? -1.0f : hbh;
}

// In place: the first min(n, k) slots become the buffer's top k, sorted;
// returns min(n, k). Out of line: it runs rarely, and inlined its registers
// would weigh on the streaming loop's occupancy.
__device__ __noinline__ int warp_topk(float* cv, int* ci, int n, int k, int lane) {
  const int m = min(n, k);
  for (int i = 0; i < m; ++i) {
    float bv = -1.0f;
    int bi = INT_MAX;
    int bs = i;
    for (int s = i + lane; s < n; s += 32) {
      const float v = cv[s];
      const int id = ci[s];
      if (better(v, id, bv, bi)) {
        bv = v;
        bi = id;
        bs = s;
      }
    }
    warp_best(bv, bi, bs);
    if (lane == 0) {
      const float tv = cv[i];
      const int ti = ci[i];
      cv[i] = bv;
      ci[i] = bi;
      cv[bs] = tv;
      ci[bs] = ti;
    }
    __syncwarp();
  }
  return m;
}

__global__ void __launch_bounds__(kMaxWarps * 32, 3)
peak_kernel(const float* __restrict__ maps, int h, int w, int k, int blur, float eps,
            int n_strips, int n_bands, int cap, int vec, float* __restrict__ uv,
            float* __restrict__ scores) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n_warps = blockDim.x >> 5;
  float* cand_v = reinterpret_cast<float*>(smem_raw);  // per warp: cap slots
  int* cand_i = reinterpret_cast<int*>(cand_v + n_warps * cap);
  float* sel_v = reinterpret_cast<float*>(cand_i + n_warps * cap);
  int* sel_i = reinterpret_cast<int*>(sel_v + k);
  int* list_len = sel_i + k;
  float* patch = reinterpret_cast<float*>(list_len + n_warps);  // kDarkBatch x 25

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const float* map = maps + (size_t)blockIdx.x * h * w;
  float* cv = cand_v + warp * cap;
  int* ci = cand_i + warp * cap;
  const unsigned lt_mask = (1u << lane) - 1u;
  int n = 0;  // the warp's buffered candidates
  bool have_thr = false;
  float thr_v = 0.0f;
  int thr_i = 0;

  for (int task = warp; task < n_strips * n_bands; task += n_warps) {
    const int s0 = (task / n_bands) * kStripCols;
    const int b0 = (task % n_bands) * kBandRows;
    const int b1 = min(b0 + kBandRows, h);
    const int g0 = s0 + 4 * lane;
    const bool halo = lane == 0 || lane == 31;
    const int hc0 = lane == 0 ? s0 - 2 : s0 + kStripCols;
    const bool halo_out = lane == 0 ? s0 == 0 : s0 + kStripCols >= w;
    bool col_out[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) col_out[j] = g0 + j >= w;

    // Rows b0-2 .. b0+1 give the blurred rows b0-1 and b0; rows b0+2 ..
    // b0+1+kAhead go in flight.
    const Row ra = load_row(map, b0 - 2, h, w, g0, hc0, halo, vec);
    Row x0 = load_row(map, b0 - 1, h, w, g0, hc0, halo, vec);
    Row x1 = load_row(map, b0, h, w, g0, hc0, halo, vec);
    Row x2 = load_row(map, b0 + 1, h, w, g0, hc0, halo, vec);
    Row pf[kAhead];
#pragma unroll
    for (int d = 0; d < kAhead; ++d) pf[d] = load_row(map, b0 + 2 + d, h, w, g0, hc0, halo, vec);
    float h0[4], h1[4], h2[4], hh0, hh1, hh2;
    blur_row(ra, x0, x1, lane, blur, b0 - 1 < 0, col_out, halo_out, h0, hh0);
    blur_row(x0, x1, x2, lane, blur, false, col_out, halo_out, h1, hh1);
    x0 = x1;  // relu'd rows r, r + 1
    x1 = x2;

    for (int r = b0; r < b1; r += kAhead) {
#pragma unroll
      for (int d = 0; d < kAhead; ++d) {
        const int row = r + d;
        if (row < b1) {
          x2 = pf[d];
          if (row + kAhead < b1)
            pf[d] = load_row(map, row + 2 + kAhead, h, w, g0, hc0, halo, vec);
          blur_row(x0, x1, x2, lane, blur, row + 1 >= h, col_out, halo_out, h2, hh2);

          // NMS of row r: the 3x3 max of hb, columns first, then across.
          float m[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) m[j] = fmaxf(fmaxf(h0[j], h1[j]), h2[j]);
          const float mh = fmaxf(fmaxf(hh0, hh1), hh2);
          float ml = __shfl_up_sync(kFull, m[3], 1);
          float mr = __shfl_down_sync(kFull, m[0], 1);
          if (lane == 0) ml = mh;
          if (lane == 31) mr = mh;
          const float mp[4] = {fmaxf(fmaxf(ml, m[0]), m[1]), fmaxf(fmaxf(m[0], m[1]), m[2]),
                               fmaxf(fmaxf(m[1], m[2]), m[3]), fmaxf(fmaxf(m[2], m[3]), mr)};
          bool s[4];
          bool any_s = false;
          const int base = row * w + g0;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[j] = !col_out[j] && x0.c[j] > 0.0f && h1[j] >= mp[j] &&
                   (!have_thr || better(x0.c[j], base + j, thr_v, thr_i));
            any_s |= s[j];
          }
          if (__any_sync(kFull, any_s)) {
            unsigned bal[4];
            int tot = 0;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              bal[j] = __ballot_sync(kFull, s[j]);
              tot += __popc(bal[j]);
            }
            if (n + tot > cap) {
              n = warp_topk(cv, ci, n, k, lane);
              if (n == k) {
                have_thr = true;
                thr_v = cv[k - 1];
                thr_i = ci[k - 1];
              }
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              if (s[j]) {
                const int pos = n + __popc(bal[j] & lt_mask);
                cv[pos] = x0.c[j];
                ci[pos] = base + j;
              }
              n += __popc(bal[j]);
            }
            __syncwarp();
          }

#pragma unroll
          for (int j = 0; j < 4; ++j) {
            h0[j] = h1[j];
            h1[j] = h2[j];
          }
          hh0 = hh1;
          hh1 = hh2;
          x0 = x1;
          x1 = x2;
        }
      }
    }
  }
  n = warp_topk(cv, ci, n, k, lane);
  if (lane == 0) list_len[warp] = n;
  __syncthreads();

  // Warp 0 merges the sorted lists, one per lane; (0, 0) at score 0 pads.
  if (warp == 0) {
    const int len = lane < n_warps ? list_len[lane] : 0;
    const float* lv = cand_v + lane * cap;
    const int* li = cand_i + lane * cap;
    int head = 0;
    for (int round = 0; round < k; ++round) {
      float bv = -1.0f;
      int bi = INT_MAX;
      int src = lane;
      if (head < len) {
        bv = lv[head];
        bi = li[head];
      }
      warp_best(bv, bi, src);
      const bool found = bi != INT_MAX;
      if (found && lane == src) ++head;
      if (lane == 0) {
        sel_v[round] = found ? bv : 0.0f;
        sel_i[round] = found ? bi : 0;
      }
    }
  }
  __syncthreads();

  // DARK, kDarkBatch peaks at a time: the block loads each peak's 5 x 5
  // relu'd patch (rows and columns clamped) into shared memory, then thread
  // kk refines peak kk. Only interior peaks are refined, and there the
  // patch holds every value the blurred 3 x 3 neighbourhood reads.
  for (int base = 0; base < k; base += kDarkBatch) {
    const int nb = min(kDarkBatch, k - base);
    for (int e = tid; e < nb * 25; e += blockDim.x) {
      const int idx = sel_i[base + e / 25];
      const int py = idx / w;
      const int px = idx - py * w;
      const int ry = min(max(py - 2 + (e % 25) / 5, 0), h - 1);
      const int rx = min(max(px - 2 + e % 5, 0), w - 1);
      patch[e] = fmaxf(__ldg(map + (size_t)ry * w + rx), 0.0f);
    }
    __syncthreads();
    if (tid < nb) {
      const int kk = base + tid;
      const int idx = sel_i[kk];
      const int py = idx / w;
      const int px = idx - py * w;
      const bool interior = px > 0 && px < w - 1 && py > 0 && py < h - 1;
      float off_x = 0.0f, off_y = 0.0f;
      bool ok = false;
      if (interior) {
        const float* x = patch + tid * 25;
        float ln[9];
#pragma unroll
        for (int i = 1; i < 4; ++i) {
#pragma unroll
          for (int j = 1; j < 4; ++j) {
            const float hb =
                blur ? tap3(tap3(x[(i - 1) * 5 + j - 1], x[i * 5 + j - 1], x[(i + 1) * 5 + j - 1]),
                            tap3(x[(i - 1) * 5 + j], x[i * 5 + j], x[(i + 1) * 5 + j]),
                            tap3(x[(i - 1) * 5 + j + 1], x[i * 5 + j + 1], x[(i + 1) * 5 + j + 1]))
                     : x[i * 5 + j];
            ln[(i - 1) * 3 + j - 1] = logf(fmaxf(hb, eps));
          }
        }
        const float gx = __fmul_rn(0.5f, __fsub_rn(ln[5], ln[3]));
        const float gy = __fmul_rn(0.5f, __fsub_rn(ln[7], ln[1]));
        const float dxx = __fadd_rn(__fsub_rn(ln[5], __fmul_rn(2.0f, ln[4])), ln[3]);
        const float dyy = __fadd_rn(__fsub_rn(ln[7], __fmul_rn(2.0f, ln[4])), ln[1]);
        const float dxy =
            __fmul_rn(0.25f, __fadd_rn(__fsub_rn(__fsub_rn(ln[8], ln[6]), ln[2]), ln[0]));
        const float det = __fsub_rn(__fmul_rn(dxx, dyy), __fmul_rn(dxy, dxy));
        const float sgn = det > 0.0f ? 1.0f : (det < 0.0f ? -1.0f : 0.0f);
        const float det_safe = fabsf(det) < eps ? __fadd_rn(__fmul_rn(sgn, eps), eps) : det;
        off_x = __fdiv_rn(-__fsub_rn(__fmul_rn(dyy, gx), __fmul_rn(dxy, gy)), det_safe);
        off_y = __fdiv_rn(-__fsub_rn(__fmul_rn(dxx, gy), __fmul_rn(dxy, gx)), det_safe);
        ok = dxx < 0.0f && dyy < 0.0f && fabsf(off_x) < 1.0f && fabsf(off_y) < 1.0f;
      }
      const size_t o = (size_t)blockIdx.x * k + kk;
      uv[2 * o] = __fadd_rn((float)px, ok ? off_x : 0.0f);
      uv[2 * o + 1] = __fadd_rn((float)py, ok ? off_y : 0.0f);
      scores[o] = sel_v[kk];
    }
    __syncthreads();
  }
}

}  // namespace
}  // namespace cspe

// maps (n_maps, h, w) f32 contiguous; uv (n_maps, k, 2) f32, scores
// (n_maps, k) f32. h, w >= 3; 1 <= k <= 512; blur 0 or 1.
CSPE_API int cspe_peaks(const float* maps, int n_maps, int h, int w, int k, int blur,
                        float eps, float* uv, float* scores, void* stream) {
  using namespace cspe;
  const int n_strips = (w + kStripCols - 1) / kStripCols;
  const int n_bands = (h + kBandRows - 1) / kBandRows;
  const int warps = min(n_strips * n_bands, kMaxWarps);
  const int cap = cand_cap(k);
  const size_t smem = smem_bytes(warps, k);
  const int vec = w % 4 == 0 && reinterpret_cast<uintptr_t>(maps) % 16 == 0;
  peak_kernel<<<n_maps, warps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      maps, h, w, k, blur, eps, n_strips, n_bands, cap, vec, uv, scores);
  return static_cast<int>(cudaGetLastError());
}
