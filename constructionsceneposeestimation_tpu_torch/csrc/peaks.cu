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
// Design: one block owns one map and stages it in dynamic shared memory:
// the relu'd map, then the blurred map (2 x 4 H W bytes: 128 KB at 128^2,
// hence the opt-in attribute in the entry point). The blur reads its 3x3
// footprint of x directly, so no third buffer is needed; the NMS then
// overwrites x with the peak map in place (each thread reads x only at its
// own pixels). The K rounds run per warp over the warp's own pixels (warp
// shuffles only, suppression in shared memory), giving each warp its top K
// positive peaks; one warp then takes the top K of those 16 K candidates.
// That equals K rounds over the whole map, because the order (value, then
// flat index) is total and every global top-K peak is in its warp's top K.
// Finally thread k refines peak k.
//
// Rounding: the blur uses uncontracted IEEE operations (__fmul_rn,
// __fadd_rn) in the plain version's order, and the pool and selection only
// compare, so hb, the NMS mask, the positions and the scores are bit-equal
// to the plain version. The DARK step too is written out uncontracted in
// the plain version's order; its logf is the CUDA library's.
//
// What bounds it on an H100: the single read of the maps. At (64 x 71,
// 128, 128) f32 that is 297.8 MB, ~0.089 ms at 3.35 TB/s; the output is
// 0.44 MB and the arithmetic ~20 operations a pixel. One 128 KB block
// fills an SM, so the load of the next map does not overlap this map's
// compute: the kernel stays well above the bound (PERF.md).
#include <climits>
#include <stdint.h>

#include "common.cuh"

namespace cspe {
namespace {

constexpr int kPeakThreads = 512;  // ops/peak_kernel.PEAK_THREADS
constexpr int kPeakWarps = kPeakThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

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

__global__ void __launch_bounds__(kPeakThreads)
peak_kernel(const float* __restrict__ maps, int h, int w, int k, int blur, float eps,
            float* __restrict__ uv, float* __restrict__ scores) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int hw = h * w;
  float* s_x = reinterpret_cast<float*>(smem_raw);  // relu(x), then the peak map
  float* s_hb = s_x + hw;                            // the blurred map
  float* c_val = s_hb + hw;                          // per-warp candidates
  int* c_idx = reinterpret_cast<int*>(c_val + kPeakWarps * k);
  float* sel_val = reinterpret_cast<float*>(c_idx + kPeakWarps * k);
  int* sel_idx = reinterpret_cast<int*>(sel_val + k);

  const int tid = threadIdx.x;
  const float* x = maps + (size_t)blockIdx.x * hw;
  for (int p = tid; p < hw; p += kPeakThreads) s_x[p] = fmaxf(x[p], 0.0f);
  __syncthreads();

  for (int p = tid; p < hw; p += kPeakThreads) {
    if (!blur) {
      s_hb[p] = s_x[p];
      continue;
    }
    const int r = p / w;
    const int c = p - r * w;
    const float* up = s_x + max(r - 1, 0) * w;
    const float* mid = s_x + r * w;
    const float* dn = s_x + min(r + 1, h - 1) * w;
    const int cl = max(c - 1, 0);
    const int cr = min(c + 1, w - 1);
    s_hb[p] = tap3(tap3(up[cl], mid[cl], dn[cl]), tap3(up[c], mid[c], dn[c]),
                   tap3(up[cr], mid[cr], dn[cr]));
  }
  __syncthreads();

  for (int p = tid; p < hw; p += kPeakThreads) {
    const int r = p / w;
    const int c = p - r * w;
    const int cl = max(c - 1, 0);
    const int cr = min(c + 1, w - 1);
    float mp = -1.0f;
    for (int rr = max(r - 1, 0); rr <= min(r + 1, h - 1); ++rr) {
      const float* row = s_hb + rr * w;
      mp = fmaxf(mp, fmaxf(fmaxf(row[cl], row[c]), row[cr]));
    }
    s_x[p] = s_hb[p] >= mp ? s_x[p] : 0.0f;
  }
  __syncthreads();

  // Each warp: its top K positive peaks over the pixels it owns.
  const int warp = tid >> 5;
  const int lane = tid & 31;
  for (int round = 0; round < k; ++round) {
    float bv = -1.0f;
    int bi = INT_MAX;
    int unused = 0;
    for (int p = warp * 32 + lane; p < hw; p += kPeakThreads) {
      const float v = s_x[p];
      if (v > 0.0f && better(v, p, bv, bi)) {
        bv = v;
        bi = p;
      }
    }
    warp_best(bv, bi, unused);
    if (lane == 0) {
      c_val[warp * k + round] = bv;
      c_idx[warp * k + round] = bi;
      if (bi != INT_MAX) s_x[bi] = 0.0f;
    }
    __syncwarp();
    if (bi == INT_MAX) {  // no positive value left in this warp's pixels
      for (int rest = round + 1 + lane; rest < k; rest += 32) {
        c_val[warp * k + rest] = -1.0f;
        c_idx[warp * k + rest] = INT_MAX;
      }
      break;
    }
  }
  __syncthreads();

  // Warp 0: the top K of all warps' candidates, padded with (0, 0) score 0.
  if (warp == 0) {
    const int n_cand = kPeakWarps * k;
    for (int round = 0; round < k; ++round) {
      float bv = -1.0f;
      int bi = INT_MAX;
      int slot = -1;
      for (int s = lane; s < n_cand; s += 32) {
        const float v = c_val[s];
        if (v > 0.0f && better(v, c_idx[s], bv, bi)) {
          bv = v;
          bi = c_idx[s];
          slot = s;
        }
      }
      warp_best(bv, bi, slot);
      if (lane == 0) {
        if (bi == INT_MAX) {
          sel_val[round] = 0.0f;
          sel_idx[round] = 0;
        } else {
          sel_val[round] = bv;
          sel_idx[round] = bi;
          c_val[slot] = -1.0f;
        }
      }
      __syncwarp();
    }
  }
  __syncthreads();

  if (tid < k) {
    const int idx = sel_idx[tid];
    const int py = idx / w;
    const int px = idx - py * w;
    float ln[9];
    for (int dy = 0; dy < 3; ++dy) {
      const int ry = min(max(py + dy - 1, 0), h - 1);
      for (int dx = 0; dx < 3; ++dx) {
        const int rx = min(max(px + dx - 1, 0), w - 1);
        ln[dy * 3 + dx] = logf(fmaxf(s_hb[ry * w + rx], eps));
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
    const float off_x =
        __fdiv_rn(-__fsub_rn(__fmul_rn(dyy, gx), __fmul_rn(dxy, gy)), det_safe);
    const float off_y =
        __fdiv_rn(-__fsub_rn(__fmul_rn(dxx, gy), __fmul_rn(dxy, gx)), det_safe);
    const bool interior = px > 0 && px < w - 1 && py > 0 && py < h - 1;
    const bool sane = dxx < 0.0f && dyy < 0.0f && fabsf(off_x) < 1.0f && fabsf(off_y) < 1.0f;
    const bool ok = interior && sane;
    const size_t o = (size_t)blockIdx.x * k + tid;
    uv[2 * o] = __fadd_rn((float)px, ok ? off_x : 0.0f);
    uv[2 * o + 1] = __fadd_rn((float)py, ok ? off_y : 0.0f);
    scores[o] = sel_val[tid];
  }
}

// ops/peak_kernel.peak_smem_bytes
size_t peak_smem_bytes(int h, int w, int k) {
  return (size_t)8 * h * w + (size_t)8 * (kPeakWarps + 1) * k;
}

}  // namespace
}  // namespace cspe

// maps (n_maps, h, w) f32 contiguous; uv (n_maps, k, 2) f32, scores
// (n_maps, k) f32. h, w >= 3; 1 <= k <= 512; blur 0 or 1.
CSPE_API int cspe_peaks(const float* maps, int n_maps, int h, int w, int k, int blur,
                        float eps, float* uv, float* scores, void* stream) {
  const size_t smem = cspe::peak_smem_bytes(h, w, k);
  cudaError_t err = cudaFuncSetAttribute(
      cspe::peak_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so a later launch does not report it
    return static_cast<int>(err);
  }
  cspe::peak_kernel<<<n_maps, cspe::kPeakThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      maps, h, w, k, blur, eps, uv, scores);
  return static_cast<int>(cudaGetLastError());
}
