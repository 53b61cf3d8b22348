// RGB epilogue: one u8 RGB pixel from the hit distance, the instance map
// and the frame's per-instance table.
//
// Replaces the Pallas TPU kernel `_rgb_kernel` behind `fused_rgb`
// (constructionsceneposeestimation_tpu/render/rgb_kernel.py:51, wrapper
// :169). Plain version: render/rgb_kernel.plain_rgb, the shading tier of
// render/shading.py.
//
// Per pixel: the world ray (exact normalise) and hit point; screen-space
// normals from the differences to the next row and the next column (read
// directly; zero on the last row and column, jnp.diff's append semantics),
// flipped toward the camera; the table row of the hit instance (albedo 3,
// world-to-local rotation 9, instance position 3, class 1), gathered here
// from shared memory instead of materialised as 16 planes; local hit
// coordinates and the procedural patterns; contact AO on ground pixels as
// the min over the (A, 4) footprint table; hash-noise texture; Lambert sun
// plus dome ambient; sky colour on misses; the sqrt-chain gamma; round to
// u8, written straight into the (B, H, W, 3) layout.
//
// What bounds it on an H100: neither side by much. HBM traffic is ~19 B a
// pixel (t of the pixel and its two neighbours mostly from L1/L2, the
// instance id, 3 bytes out: ~0.3 GB for 64 frames at 512^2, ~0.1 ms at
// 3.35 TB/s); arithmetic is ~400 FP32 operations a pixel, dominated by the
// A-row AO loop, three sinf and the square-root chains. The table and the
// AO rows sit in shared memory, so nothing per-instance is re-read from
// HBM.
//
// The formulas are those of render/shading.py. `_hash_noise` takes sinf of
// arguments near 1500, where the last ulps of each backend's sin
// decorrelate the noise: the kernel is held to the plain version with the
// noise off, and statistically with it on.
#include <stdint.h>

#include "common.cuh"

namespace cspe {
namespace {

// Lighting/camera row, per frame (layout: render/rgb_kernel.py docstring).
constexpr int kNPar = 32;

// The ray and the sky colour use uncontracted IEEE operations in the order
// PyTorch's elementwise ops round them, so sky pixels (a function of the
// ray alone) come out bit-equal to the plain version's.
__device__ __forceinline__ void ray_dir(const float* p, float row, float col, float& rx,
                                        float& ry, float& rz) {
  const float x = (col - p[9]) / p[11];
  const float y = (row - p[10]) / p[12];
  rx = __fadd_rn(__fadd_rn(__fmul_rn(p[0], x), __fmul_rn(p[1], y)), p[2]);
  ry = __fadd_rn(__fadd_rn(__fmul_rn(p[3], x), __fmul_rn(p[4], y)), p[5]);
  rz = __fadd_rn(__fadd_rn(__fmul_rn(p[6], x), __fmul_rn(p[7], y)), p[8]);
  const float n =
      sqrtf(__fadd_rn(__fadd_rn(__fmul_rn(rx, rx), __fmul_rn(ry, ry)), __fmul_rn(rz, rz)));
  rx /= n;
  ry /= n;
  rz /= n;
}

// shading._hash_noise: fract(|sin(p . k)| * 43758.5453), k = 7 * (12.9898,
// 78.233, 37.719) rounded to f32 as the JAX reference rounds them.
__device__ __forceinline__ float hash_noise(float x, float y, float z) {
  const float q = sinf(x * (float)(12.9898 * 7.0) + y * (float)(78.233 * 7.0) +
                       z * (float)(37.719 * 7.0));
  return fmodf(fabsf(q * 43758.5453f), 1.0f);
}

// shading._gamma22: x^(1/2.2) by a sqrt chain on the x^(7/16) basis, in
// uncontracted operations (see ray_dir).
__device__ __forceinline__ float gamma22(float c) {
  const float s1 = sqrtf(c);
  const float s2 = sqrtf(s1);
  const float s3 = sqrtf(s2);
  const float a = __fmul_rn(s1, 1.0f / sqrtf(fmaxf(s3, 1e-30f)));
  return __fmul_rn(a, __fsub_rn(__fadd_rn(0.7844735f, __fmul_rn(0.29726508f, s3)),
                                __fmul_rn(0.08179099f, s2)));
}

__device__ __forceinline__ void set3(float* c, float r, float g, float b) {
  c[0] = r;
  c[1] = g;
  c[2] = b;
}

// shading.procedural_albedo, in the owning instance's local frame.
__device__ void procedural_albedo(float* alb, float x, float y, float z, float cls,
                                  float phase, float dirt) {
  const float r_xy = sqrtf(x * x + y * y);
  const bool band = (z > 0.28f && z < 0.40f) || (z > 0.50f && z < 0.58f);
  if (cls == 0.0f && band) set3(alb, 0.92f, 0.92f, 0.92f);
  if (cls == 1.0f && r_xy < 0.45f && z < 3.2f) set3(alb, 0.30f, 0.20f, 0.10f);
  if (cls == 2.0f && sinf(x * 18.0f) * sinf(z * 18.0f) > 0.0f)
    for (int i = 0; i < 3; ++i) alb[i] *= 0.75f;
  if (cls == 4.0f && x > 1.2f && z > 0.6f) set3(alb, 0.35f, 0.38f, 0.40f);
  if (cls == 4.0f && z < 0.55f) {
    const float dirt_mul = 1.0f - 0.5f * dirt;
    for (int i = 0; i < 3; ++i) alb[i] *= dirt_mul;
  }
  if (cls == 5.0f && z > 1.02f && z < 1.48f) set3(alb, 0.85f, 0.95f, 0.05f);
  if (cls == 5.0f && ((z > 1.10f && z < 1.16f) || (z > 1.30f && z < 1.36f)))
    set3(alb, 0.92f, 0.92f, 0.92f);
  if (cls == 8.0f || cls == 9.0f) {
    const float f = floorf(x * 2.0f + phase);
    const float m = f - 2.0f * floorf(f / 2.0f);  // Python-style f % 2
    if (m < 1.0f)
      set3(alb, 0.92f, 0.92f, 0.92f);
    else
      set3(alb, 0.75f, 0.10f, 0.08f);
  }
}

__global__ void __launch_bounds__(256)
rgb_kernel(const float* __restrict__ t, const int* __restrict__ inst,
           const float* __restrict__ table, int n_rows, const float* __restrict__ ao,
           int n_ao, const float* __restrict__ par, int height, int width,
           uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  float* s_par = smem;
  float* s_tab = s_par + kNPar;
  float* s_ao = s_tab + n_rows * 16;

  const int b = blockIdx.y;
  for (int i = threadIdx.x; i < kNPar; i += blockDim.x) s_par[i] = par[b * kNPar + i];
  for (int i = threadIdx.x; i < n_rows * 16; i += blockDim.x)
    s_tab[i] = table[(size_t)b * n_rows * 16 + i];
  for (int i = threadIdx.x; i < n_ao * 4; i += blockDim.x)
    s_ao[i] = ao[(size_t)b * n_ao * 4 + i];
  __syncthreads();

  const int n_pix = height * width;
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= n_pix) return;
  const int row = pix / width;
  const int col = pix - row * width;
  const float* p = s_par;
  const float ox = p[13], oy = p[14], oz = p[15];
  const float* t_b = t + (size_t)b * n_pix;

  float rdx, rdy, rdz;
  ray_dir(p, (float)row, (float)col, rdx, rdy, rdz);
  const float tv = t_b[pix];
  const bool is_hit = isfinite(tv);
  const float ts = is_hit ? tv : 0.0f;
  const float pwx = ox + ts * rdx, pwy = oy + ts * rdy, pwz = oz + ts * rdz;

  // Differences to the next row and column; zero on the last ones.
  float dyx = 0.0f, dyy = 0.0f, dyz = 0.0f, dxx = 0.0f, dxy = 0.0f, dxz = 0.0f;
  if (row + 1 < height) {
    float nx, ny, nz;
    ray_dir(p, (float)(row + 1), (float)col, nx, ny, nz);
    const float tn = t_b[pix + width];
    const float tns = isfinite(tn) ? tn : 0.0f;
    dyx = (ox + tns * nx) - pwx;
    dyy = (oy + tns * ny) - pwy;
    dyz = (oz + tns * nz) - pwz;
  }
  if (col + 1 < width) {
    float ex, ey, ez;
    ray_dir(p, (float)row, (float)(col + 1), ex, ey, ez);
    const float te = t_b[pix + 1];
    const float tes = isfinite(te) ? te : 0.0f;
    dxx = (ox + tes * ex) - pwx;
    dxy = (oy + tes * ey) - pwy;
    dxz = (oz + tes * ez) - pwz;
  }
  // n = d/drow x d/dcol, normalized, flipped toward the camera.
  float nx = dyy * dxz - dyz * dxy;
  float ny = dyz * dxx - dyx * dxz;
  float nz = dyx * dxy - dyy * dxx;
  const float ninv = 1.0f / sqrtf(fmaxf(nx * nx + ny * ny + nz * nz, 1e-18f));
  nx *= ninv;
  ny *= ninv;
  nz *= ninv;
  if (nx * rdx + ny * rdy + nz * rdz > 0.0f) {
    nx = -nx;
    ny = -ny;
    nz = -nz;
  }

  // Table row: instances 0..O-1, ground O, sky O+1.
  const int id = inst[(size_t)b * n_pix + pix];
  const int n_inst = n_rows - 2;
  const float* tab = s_tab + (id >= 0 ? id : n_inst - 1 - id) * 16;
  float alb[3] = {tab[0], tab[1], tab[2]};
  const float dxw = pwx - tab[12], dyw = pwy - tab[13], dzw = pwz - tab[14];
  const float lx = tab[3] * dxw + tab[6] * dyw + tab[9] * dzw;
  const float ly = tab[4] * dxw + tab[7] * dyw + tab[10] * dzw;
  const float lz = tab[5] * dxw + tab[8] * dyw + tab[11] * dzw;
  const float cls = tab[15];
  procedural_albedo(alb, lx, ly, lz, cls, p[24], p[26]);

  // Contact AO on ground pixels.
  float ao_f = 1.0f;
  if (cls == -1.0f) {
    float prox = 1.0f;
    for (int a = 0; a < n_ao; ++a) {
      const float dxa = pwx - s_ao[a * 4 + 0];
      const float dya = pwy - s_ao[a * 4 + 1];
      const float d = sqrtf(dxa * dxa + dya * dya);
      prox = fminf(prox, clampf((d - s_ao[a * 4 + 2]) / 0.6f, 0.0f, 1.0f));
    }
    ao_f = 0.45f + 0.55f * prox;
  }

  // Lambert sun + hemispheric dome ambient; sky gradient on misses.
  const float sun_i = p[19], dome_i = p[20];
  const float tex = 1.0f + 0.15f * p[25] * (hash_noise(pwx, pwy, pwz) - 0.5f) * 2.0f;
  const float ndotl = fmaxf(-(nx * p[16] + ny * p[17] + nz * p[18]), 0.0f);
  const float direct = sun_i * ndotl;
  const float ambient = dome_i * (0.25f + 0.35f * (0.5f * (1.0f + nz))) * ao_f;
  const float sky_base =
      __fmul_rn(__fadd_rn(0.85f, __fmul_rn(0.15f, clampf(rdz, 0.0f, 1.0f))), fmaxf(dome_i, 0.3f));
  uint8_t* o = out + ((size_t)b * n_pix + pix) * 3;
  for (int ch = 0; ch < 3; ++ch) {
    const float dc = p[21 + ch];
    const float color = is_hit ? (alb[ch] * tex) * (direct + ambient * dc) : __fmul_rn(dc, sky_base);
    o[ch] = (uint8_t)rintf(__fmul_rn(gamma22(clampf(color, 0.0f, 1.0f)), 255.0f));
  }
}

}  // namespace
}  // namespace cspe

// t (B, H, W) f32 (+inf on miss/clip), inst (B, H, W) int32, table
// (B, n_rows, 16) f32, ao (B, n_ao, 4) f32, par (B, 32) f32;
// out (B, H, W, 3) u8.
CSPE_API int cspe_rgb(const float* t, const int* inst, const float* table, int n_rows,
                      const float* ao, int n_ao, const float* par, int batch, int height,
                      int width, uint8_t* out, void* stream) {
  const int threads = 256;
  const dim3 grid((height * width + threads - 1) / threads, batch);
  const size_t smem = (size_t)(cspe::kNPar + n_rows * 16 + n_ao * 4) * sizeof(float);
  cspe::rgb_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      t, inst, table, n_rows, ao, n_ao, par, height, width, out);
  return static_cast<int>(cudaGetLastError());
}
