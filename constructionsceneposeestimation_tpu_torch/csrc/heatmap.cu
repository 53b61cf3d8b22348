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
// Design: one block per (channel, frame). The block first compacts the
// frame's visible keypoints of its channel into shared memory (a scan of
// the N slots, no sort), then its threads cover the whole h x w map, each
// taking the max of expf over that short list. The list's only atomic is
// its shared-memory length counter: the order it leaves is free because max
// is exact and order-independent, and one block owns each map, so the
// output needs none. No band, no row window, no size fallback: every pixel
// of every map is evaluated exactly, so any sigma and any width (128, 192,
// ...) take the same path.
//
// What bounds it on an H100: the output write. 64 frames x 71 x 128^2 f32
// is 298 MB (~0.09 ms at 3.35 TB/s); reads are ~13 B per keypoint slot per
// channel, served from L2 after the first channel of a frame, and the
// arithmetic is a few expf per pixel. Threads write consecutive x, so the
// stores coalesce.
#include <stdint.h>

#include "common.cuh"

namespace cspe {
namespace {

__global__ void __launch_bounds__(256)
heatmap_kernel(const float* __restrict__ uv, const int* __restrict__ channel,
               const uint8_t* __restrict__ visible, int n_kpts, int n_channels,
               int height, int width, float stride, float two_s2,
               float* __restrict__ out) {
  extern __shared__ __align__(16) float2 s_pts[];
  __shared__ int s_count;
  const int c = blockIdx.x;
  const int b = blockIdx.y;
  if (threadIdx.x == 0) s_count = 0;
  __syncthreads();
  const size_t base = (size_t)b * n_kpts;
  for (int i = threadIdx.x; i < n_kpts; i += blockDim.x) {
    if (visible[base + i] && channel[base + i] == c) {
      const int k = atomicAdd(&s_count, 1);
      s_pts[k] = make_float2(uv[(base + i) * 2] / stride, uv[(base + i) * 2 + 1] / stride);
    }
  }
  __syncthreads();
  const int n = s_count;
  float* o = out + ((size_t)b * n_channels + c) * height * width;
  for (int p = threadIdx.x; p < height * width; p += blockDim.x) {
    const float x = (float)(p % width);
    const float y = (float)(p / width);
    float m = 0.0f;
    for (int k = 0; k < n; ++k) {
      const float dx = x - s_pts[k].x;
      const float dy = y - s_pts[k].y;
      m = fmaxf(m, expf(-(dx * dx + dy * dy) / two_s2));
    }
    o[p] = m;
  }
}

}  // namespace
}  // namespace cspe

// uv (B, N, 2) f32 at full resolution, channel (B, N) int32, visible
// (B, N) u8; out (B, C, H, W) f32. two_s2 = 2 sigma^2 (rounded to f32).
CSPE_API int cspe_heatmap(const float* uv, const int* channel, const uint8_t* visible,
                          int batch, int n_kpts, int n_channels, int height, int width,
                          float stride, float two_s2, float* out, void* stream) {
  const int threads = 256;
  const dim3 grid(n_channels, batch);
  const size_t smem = (size_t)n_kpts * sizeof(float2);
  cspe::heatmap_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      uv, channel, visible, n_kpts, n_channels, height, width, stride, two_s2, out);
  return static_cast<int>(cudaGetLastError());
}
