// Gaussian keypoint-heatmap targets.
//
// Replaces the Pallas TPU kernel `_heatmap_kernel` behind
// `render_heatmaps_pallas`
// (constructionsceneposeestimation_tpu/ops/heatmap.py:58, wrapper :105).
// Plain version: ops/heatmap.render_heatmaps.
//
// out[b, c, y, x] = max over the visible keypoints k of frame b assigned to
// channel c of exp(-((x - u_k)^2 + (y - v_k)^2) / (2 sigma^2)), with
// (u, v) = uv / stride; 0 where channel c has none.
//
// What bounds it on an H100: the output write. 64 frames x 71 x 128^2 f32
// is 298 MB, 0.089 ms at 3.35 TB/s; the keypoint slots are 0.6 MB and the
// arithmetic a few expf a pixel of the few maps that hold a keypoint. The
// first version of this kernel (one block a map) wrote at ~1.1 TB/s: 4544
// short blocks of 64 KB each, each scanning all of its frame's 680 slots
// again (dependent loads, a shared atomic and two barriers before its
// first store), a runtime % and / a pixel, an IEEE divide a (pixel,
// keypoint) pair, 4-byte stores, and expf evaluated where it is exactly 0.
//
// Design:
// - A block owns one map, channel c of frame b (grid: channels x frames).
//   It scans the frame's N slots once, 4 slots a thread with 16-byte loads
//   where N % 4 == 0, and gathers the visible keypoints of channel c into
//   shared memory behind one shared atomic counter: no dependent loads
//   and one barrier before the first store. Their order is free: max is
//   exact and order-independent.
// - A warp writes a row at a time, 4 consecutive x a lane, as one 16-byte
//   streaming store (__stcs: nothing reads the maps back). The lanes'
//   chunks sit on 16-byte boundaries of the row, so a row whose start is
//   not 16-byte aligned (a width that is not a multiple of 4) writes its
//   ragged ends with scalar stores in the same loop. x and y come from the
//   lane and the warp: no runtime % or /.
// - Exact skip of zero Gaussians: a keypoint is skipped for a row where
//   dy^2 / (2 sigma^2) > kExpZero, dy the row's distance to it. There every
//   pixel's argument is at most -kExpZero (below), and expf is exactly 0.
// - The argument is -(fma(dx, dx, dy^2) * (1 / (2 sigma^2))): no divide a
//   pair. It rounds to within 2 ulp of the plain version's -d2 / (2
//   sigma^2), far inside the 2e-4 the kernel is held to (and at sigma 2,
//   where 1 / 8 is exact, it gave the first version's bits). With dy2 =
//   fl(dy * dy) the sum is at least dy2 and the product at least fl(dy2 *
//   inv) (monotone rounding), so the skip test bounds every pixel of the
//   row, whatever x.
// - The split: one channel a block, 16 warps (grid 71 x 64 = 4544 blocks
//   at 71 channels; 40 registers, 3 blocks and 48 warps an SM). Blocks of
//   2 to 8 channels, tried in an earlier build, wrote slower: a group's
//   block runs for as long as its slowest map, and the last wave's few
//   blocks leave most SMs idle, where many short blocks balance
//   themselves.
// No band guard, no size fallback: every pixel of every map is written,
// for any sigma and any width (128, 192, ...).
//
// Measured on an H100 SXM (NVIDIA H100 80GB HBM3, 700 W) by
// tools/kernel_variants.py, device time a launch at (64, 71, 128, 128) on
// the datagen path's keypoints, two turns each (PERF.md §6): 0.1054 and
// 0.1055 ms, 2.82 TB/s, bit-equal at sigma 2 to the first version of this
// kernel, which took 0.270 and 0.277 ms in the same run. Warps a block 8:
// 0.112 ms, 16: 0.105, 32: 0.118. Also tried in earlier builds and dropped
// with their code as no faster: two or four row bands a map, a block
// each, and a cap of 32 registers.
#include <stdint.h>

#include "common.cuh"

namespace cspe {
namespace {

constexpr int kLanes = 32;
constexpr int kWarps = 16;
// expf(x) is exactly 0 in f32 for x <= -kExpZero: exp(-104) = 2^-150.04 is
// below half the smallest denormal, 2^-149, so it rounds to 0 (CUDA's expf
// scales ex2 of the reduced argument by 2^i in one final rounding; exp on
// the CPU is correctly rounded there). Checked on the CPU by
// tests/test_torch_kernel_identities.py; ops/heatmap.EXP_ZERO.
constexpr float kExpZero = 104.0f;

// Slots i0 .. i0 + 3 of one frame: keep[e] whether the slot is visible
// and on channel c; q[e] its uv.
__device__ __forceinline__ void load_slots(const float* uv, const int* channel,
                                           const uint8_t* visible, int n, int i0, bool vec,
                                           int c, bool* keep, float2* q) {
  if (vec) {
    const int4 ch = *reinterpret_cast<const int4*>(channel + i0);
    const uint32_t v = *reinterpret_cast<const uint32_t*>(visible + i0);
    const int cc[4] = {ch.x, ch.y, ch.z, ch.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) keep[e] = ((v >> (8 * e)) & 0xffu) && cc[e] == c;
    const float4 a = *reinterpret_cast<const float4*>(uv + 2 * i0);
    const float4 d = *reinterpret_cast<const float4*>(uv + 2 * i0 + 4);
    q[0] = make_float2(a.x, a.y);
    q[1] = make_float2(a.z, a.w);
    q[2] = make_float2(d.x, d.y);
    q[3] = make_float2(d.z, d.w);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + e;
      keep[e] = i < n && visible[i] && channel[i] == c;
      if (i < n) q[e] = make_float2(uv[2 * i], uv[2 * i + 1]);
    }
  }
}

__global__ void __launch_bounds__(kLanes * kWarps)
heatmap_kernel(const float* __restrict__ uv, const int* __restrict__ channel,
               const uint8_t* __restrict__ visible, int n_kpts, int n_channels,
               int height, int width, float stride, float two_s2,
               float* __restrict__ out) {
  extern __shared__ __align__(16) float2 s_pts[];  // the map's keypoints
  __shared__ int s_n;
  const int c = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.y * kLanes + threadIdx.x;
  if (tid == 0) s_n = 0;

  // Gather the visible keypoints of channel c.
  const float* uv_b = uv + (size_t)b * n_kpts * 2;
  const int* ch_b = channel + (size_t)b * n_kpts;
  const uint8_t* vis_b = visible + (size_t)b * n_kpts;
  const bool vec = (n_kpts & 3) == 0 && (reinterpret_cast<uintptr_t>(uv_b) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(ch_b) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(vis_b) & 3) == 0;
  __syncthreads();
  for (int i0 = 4 * tid; i0 < n_kpts; i0 += 4 * kLanes * kWarps) {
    bool keep[4];
    float2 q[4];
    load_slots(uv_b, ch_b, vis_b, n_kpts, i0, vec, c, keep, q);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (keep[e]) s_pts[atomicAdd(&s_n, 1)] = make_float2(q[e].x / stride, q[e].y / stride);
  }
  __syncthreads();

  const float inv = 1.0f / two_s2;
  const int lane = threadIdx.x;
  const int n = s_n;
  float* map = out + ((size_t)b * n_channels + c) * height * width;
  for (int y = threadIdx.y; y < height; y += kWarps) {
    float* row = map + (size_t)y * width;
    // The lanes' chunks start on the 16-byte boundaries of the row.
    const int lead = (int)((reinterpret_cast<uintptr_t>(row) >> 2) & 3);
    const float fy = (float)y;
    for (int x0 = 4 * lane - lead; x0 < width; x0 += 4 * kLanes) {
      float m[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int i = 0; i < n; ++i) {
        const float2 q = s_pts[i];
        const float dy = fy - q.y;
        const float dy2 = __fmul_rn(dy, dy);
        if (__fmul_rn(dy2, inv) > kExpZero) continue;  // the same for the whole warp
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float dx = (float)(x0 + e) - q.x;
          m[e] = fmaxf(m[e], expf(-__fmul_rn(__fmaf_rn(dx, dx, dy2), inv)));
        }
      }
      if (x0 >= 0 && x0 + 4 <= width) {
        __stcs(reinterpret_cast<float4*>(row + x0), make_float4(m[0], m[1], m[2], m[3]));
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (x0 + e >= 0 && x0 + e < width) __stcs(row + x0 + e, m[e]);
      }
    }
  }
}

}  // namespace
}  // namespace cspe

// uv (B, N, 2) f32 at full resolution, channel (B, N) int32, visible
// (B, N) u8; out (B, C, H, W) f32. two_s2 = 2 sigma^2 (rounded to f32).
// Returns kErrSharedMemory, launching nothing, if the N slots' shared
// memory and the kernel's static arrays exceed kSmemLimit (~6100 slots).
CSPE_API int cspe_heatmap(const float* uv, const int* channel, const uint8_t* visible,
                          int batch, int n_kpts, int n_channels, int height, int width,
                          float stride, float two_s2, float* out, void* stream) {
  using namespace cspe;
  const dim3 block(kLanes, kWarps);
  const dim3 grid(n_channels, batch);
  const size_t smem = (size_t)n_kpts * sizeof(float2);
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, heatmap_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem + attr.sharedSizeBytes > kSmemLimit) return kErrSharedMemory;
  heatmap_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      uv, channel, visible, n_kpts, n_channels, height, width, stride, two_s2, out);
  return static_cast<int>(cudaGetLastError());
}
