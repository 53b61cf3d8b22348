// RGB epilogue: one u8 RGB pixel from the hit distance, the instance map
// and the frame's per-instance table.
//
// Replaces the Pallas TPU kernel `_rgb_kernel` behind `fused_rgb`
// (constructionsceneposeestimation_tpu/render/rgb_kernel.py:51, wrapper
// :169). Plain version: render/rgb_kernel.plain_rgb, the shading tier of
// render/shading.py.
//
// Per pixel: the world ray (exact normalise) and hit point; screen-space
// normals from the differences to the next row and the next column (zero
// on the last row and column of the frame, jnp.diff's append semantics),
// flipped toward the camera; the table row of the hit instance (albedo 3,
// world-to-local rotation 9, instance position 3, class 1), gathered from
// shared memory; local hit coordinates and the procedural patterns;
// contact AO on ground pixels as the min over the (A, 4) footprint table;
// hash-noise texture; Lambert sun plus dome ambient; sky colour on misses;
// the sqrt-chain gamma; round to u8 in the (B, H, W, 3) layout.
//
// What bounds it on an H100: issued instructions. HBM traffic is ~11 B a
// pixel (t, the instance id, 3 bytes out): 0.18 GB for 64 frames at 512^2,
// ~0.06 ms at 3.35 TB/s. The FP32 work a pixel needs is ~190 operations,
// but an IEEE divide or square root, counted as one of them, is a sequence
// of ~8 instructions with a branch to a slow path, and sinf is ~20. The
// first version of this kernel issued far more than the function needs:
// - three rays a pixel (its own, the one below, the one to the right),
//   each with two divides for the pinhole coordinates, three for the
//   normalise and a square root;
// - fmodf(x, 1), a software loop, in the hash noise;
// - every ground pixel walked all A = 20 contact-AO rows, each a square
//   root and an IEEE divide, though most rows lie beyond their reach;
// - a runtime integer division for the pixel's row, and 3-byte stores.
//
// Design, for the same IEEE operations in the same order a pixel:
// - Tiles. A block of 32 x 8 threads walks kTiles tiles of 32 x 8 pixels
//   down one column of a frame (one warp a tile row), so the table, the AO
//   rows and the parameters are loaded into shared memory once for
//   kTiles * 256 pixels. Rows and columns come from the block and thread
//   indices: no integer division.
// - One ray a pixel. The pinhole coordinates x = (col - cx) / fx of the
//   block's 33 columns and y of its rows are computed once into shared
//   memory (the same IEEE divides, so the same bits). Each pixel of the
//   tile, and of its halo (the row below and the column to the right, 40
//   pixels), builds its normalised ray and hit point once into shared
//   memory; the normal reads the neighbours' hit points from there. That
//   is 296 rays for 256 pixels instead of 768.
// - fract without fmodf: for x >= 0, x - floorf(x) is exact (Sterbenz for
//   x >= 1) and equals fmodf(x, 1.0f) bit for bit.
// - Contact AO, culled and divided once. Each warp (a 32 x 1 row of the
//   tile, the cull cell) takes the xy bounding box of its ground hit
//   points (integer min/max reductions of order-preserving images of the
//   floats: exact) and keeps only the AO rows whose disc of radius
//   (r + 0.6) kAoScale + kAoAbs meets it (warp ballot, in row order); a
//   warp with no ground pixel skips both. A culled row's term
//   clamp((d - r) / 0.6, 0, 1) is exactly 1 on every ground pixel of the
//   cell: the pixel's |dx|, |dy| are at least the
//   box's in f32 (monotone rounding), so d exceeds the widened reach to
//   within a few ulps and (d - r) / 0.6f rounds to more than 1. For the
//   kept rows the pixel takes m = min of (d - r) and then clamp(m / 0.6f,
//   0, 1) once: division by a positive constant and the clamp are
//   monotone, so that equals the min of the per-row terms bit for bit (an
//   empty list gives +inf, so 1). render/rgb_kernel.ao_cull_plain mirrors
//   the test op for op.
// - The u8 output of a tile is staged in shared memory and written with
//   16-byte stores (a 32-pixel row is 96 bytes, 6 x 16) where the frame
//   width is a multiple of 16 and the tile is whole; elsewhere a thread
//   writes its own 3 bytes.
// - Registers. With no launch bounds nvcc gives this kernel 62 registers
//   (four blocks an SM); __launch_bounds__(256, 8) holds it to 32 with no
//   spills: eight blocks, 64 warps an SM, to hide the latency of its
//   divide and square-root sequences.
//
// Measured on an H100 SXM (NVIDIA H100 80GB HBM3, 700 W) by
// tools/kernel_variants.py, device time a launch at 64 x 512^2 on the
// datagen path's inputs, two turns each (PERF.md §6): 0.407 and 0.408 ms,
// bit-equal to the first version of this kernel with the hash noise off
// and on, which took 0.651 and 0.650 ms in the same run. Variants, each
// bit-equal to the kernel: blocks an SM (registers) 1 (88): 0.791 ms,
// 5 (46): 0.440, 6 (40): 0.417, 8 (32): 0.407; no launch bounds (62):
// 0.474; threads only (48): 0.428; tiles a block 1: 0.447, 2: 0.420,
// 4: 0.407, 8: 0.405. Tried in earlier builds and dropped with their code
// as slower or no faster: a 32 x 8 cull cell, loads issued a tile ahead
// (more registers), and a warp vote that skipped an AO row's square root
// where no ground lane lay within reach. Where the time goes, each stage
// timed by its absence: the gamma chains 0.091 ms, the AO cull and walk
// 0.038 ms, the hash noise 0.024 ms; the rest, ~0.25 ms, is the rays,
// normals, table gather, patterns, shading and stores.
//
// The formulas are those of render/shading.py. `_hash_noise` takes sinf of
// arguments near 1500, where the last ulps of each backend's sin
// decorrelate the noise: the kernel is held to the plain version with the
// noise off, and statistically with it on.
#include <limits.h>
#include <stdint.h>

#include "common.cuh"

namespace cspe {
namespace {

// Lighting/camera row, per frame (layout: render/rgb_kernel.py docstring).
constexpr int kNPar = 32;
constexpr int kTileW = 32;                      // render/rgb_kernel.TILE
constexpr int kTileH = 8;
constexpr int kTiles = 4;                       // tiles a block walks, top to bottom
constexpr int kRows = kTileH * kTiles;          // rows a block covers
constexpr int kMinBlocks = 8;                   // blocks an SM: at most 32 registers
// The AO cull widens each row's reach r + 0.6 to (r + 0.6) kAoScale +
// kAoAbs (render/rgb_kernel.AO_SCALE, AO_ABS): far above the few ulps by
// which a pixel's computed distance can fall below the box's.
constexpr float kAoScale = 1.0001f;
constexpr float kAoAbs = 1e-4f;
static_assert(64 + kRows < kTileW * kTileH, "s_y is filled by threads 64 .. 64 + kRows");

// The normalised ray through pinhole coordinates (x, y): uncontracted IEEE
// operations in the order PyTorch's elementwise ops round them, so sky
// pixels (a function of the ray alone) come out bit-equal to the plain
// version's.
__device__ __forceinline__ void ray_dir(const float* p, float x, float y, float& rx, float& ry,
                                        float& rz) {
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
// 78.233, 37.719) rounded to f32 as the JAX reference rounds them. The
// fract of a >= 0 as a - floorf(a): exact, and equal to fmodf(a, 1.0f).
__device__ __forceinline__ float hash_noise(float x, float y, float z) {
  const float q = sinf(x * (float)(12.9898 * 7.0) + y * (float)(78.233 * 7.0) +
                       z * (float)(37.719 * 7.0));
  const float a = fabsf(__fmul_rn(q, 43758.5453f));
  return __fsub_rn(a, floorf(a));
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

// Whether AO row q = (x, y, r, 0) can reach a point of the box [x0, x1] x
// [y0, y1] (empty when x0 > x1): the distance from its centre to the box
// against the widened reach, in uncontracted operations, as
// render/rgb_kernel.ao_cull_plain computes it.
__device__ __forceinline__ bool ao_reaches(float4 q, float4 box) {
  if (box.x > box.y) return false;
  const float dx = fmaxf(fmaxf(__fsub_rn(box.x, q.x), __fsub_rn(q.x, box.y)), 0.0f);
  const float dy = fmaxf(fmaxf(__fsub_rn(box.z, q.y), __fsub_rn(q.y, box.w)), 0.0f);
  const float reach = __fadd_rn(__fmul_rn(__fadd_rn(q.z, 0.6f), kAoScale), kAoAbs);
  return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)) <= __fmul_rn(reach, reach);
}

// A float's bits as an int of the same order, for every float but NaN
// (negative floats get their magnitude bits flipped), and back.
__device__ __forceinline__ int ordered(float f) {
  const int i = __float_as_int(f);
  return i ^ ((i >> 31) & 0x7fffffff);
}

__device__ __forceinline__ float unordered(int i) {
  return __int_as_float(i ^ ((i >> 31) & 0x7fffffff));
}

__global__ void __launch_bounds__(kTileW * kTileH, kMinBlocks)
rgb_kernel(const float* __restrict__ t, const int* __restrict__ inst,
           const float* __restrict__ table, int n_rows, const float* __restrict__ ao,
           int n_ao, const float* __restrict__ par, int height, int width,
           uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  float* s_tab = smem;                                           // (n_rows, 16)
  float4* s_ao = reinterpret_cast<float4*>(s_tab + n_rows * 16);  // (n_ao,)
  __shared__ float s_par[kNPar];
  __shared__ float s_x[kTileW + 1];  // pinhole x of the block's columns and the halo's
  __shared__ float s_y[kRows + 1];   // pinhole y of its rows and the last halo row
  __shared__ float s_p[3][kTileH + 1][kTileW + 1];  // hit points, tile and halo
  __shared__ __align__(16) uint8_t s_out[kTileH][kTileW * 3];

  const int b = blockIdx.z;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTileW + tx;
  const int c0 = blockIdx.x * kTileW;
  const int r0 = blockIdx.y * kRows;
  const int n_pix = height * width;
  for (int i = tid; i < kNPar; i += kTileW * kTileH) s_par[i] = par[b * kNPar + i];
  const float4* tab_g = reinterpret_cast<const float4*>(table + (size_t)b * n_rows * 16);
  for (int i = tid; i < n_rows * 4; i += kTileW * kTileH)
    reinterpret_cast<float4*>(s_tab)[i] = tab_g[i];
  const float4* ao_g = reinterpret_cast<const float4*>(ao + (size_t)b * n_ao * 4);
  for (int i = tid; i < n_ao; i += kTileW * kTileH) s_ao[i] = ao_g[i];
  __syncthreads();
  const float* p = s_par;
  if (tid <= kTileW)
    s_x[tid] = ((float)(c0 + tid) - p[9]) / p[11];
  else if (tid >= 64 && tid <= 64 + kRows)
    s_y[tid - 64] = ((float)(r0 + tid - 64) - p[10]) / p[12];
  __syncthreads();

  const float ox = p[13], oy = p[14], oz = p[15];
  const float* t_b = t + (size_t)b * n_pix;
  const int* inst_b = inst + (size_t)b * n_pix;
  const int n_inst = n_rows - 2;
  const int col = c0 + tx;
  // 16-byte stores where every tile row starts on a 16-byte boundary.
  const bool vec_out = (width & 15) == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0 &&
                       c0 + kTileW <= width;
  const float kPosInf = __int_as_float(0x7f800000);
  // The halo cell this thread builds: threads 0-31 the row below the tile,
  // 32-39 the column to its right.
  const bool halo = tid < kTileW + kTileH;
  const int hi = tid < kTileW ? kTileH : tid - kTileW;  // halo cell in s_p
  const int hj = tid < kTileW ? tid : kTileW;

#pragma unroll 1
  for (int k = 0; k < kTiles; ++k) {
    const int rt = k * kTileH;  // the tile's first row, within the block
    if (r0 + rt >= height) break;
    const int row = r0 + rt + ty;
    const bool in = row < height && col < width;
    const size_t pix = (size_t)row * width + col;

    // The pixel's ray and hit point, then the halo's hit points.
    float rdx = 0.0f, rdy = 0.0f, rdz = 0.0f, tv = kPosInf;
    int id = -2;
    if (in) {
      ray_dir(p, s_x[tx], s_y[rt + ty], rdx, rdy, rdz);
      tv = t_b[pix];
      id = inst_b[pix];
    }
    const bool is_hit = isfinite(tv);
    const float ts = is_hit ? tv : 0.0f;
    const float pwx = ox + ts * rdx, pwy = oy + ts * rdy, pwz = oz + ts * rdz;
    s_p[0][ty][tx] = pwx;
    s_p[1][ty][tx] = pwy;
    s_p[2][ty][tx] = pwz;
    if (halo) {
      const int hr = r0 + rt + hi, hc = c0 + hj;
      if (hr < height && hc < width) {
        float hx, hy, hz;
        ray_dir(p, s_x[hj], s_y[rt + hi], hx, hy, hz);
        const float th = t_b[(size_t)hr * width + hc];
        const float ths = isfinite(th) ? th : 0.0f;
        s_p[0][hi][hj] = ox + ths * hx;
        s_p[1][hi][hj] = oy + ths * hy;
        s_p[2][hi][hj] = oz + ths * hz;
      }
    }

    // Table row: instances 0..O-1, ground O, sky O+1.
    const float* tab = s_tab + (id >= 0 ? id : n_inst - 1 - id) * 16;
    const float cls = tab[15];
    const bool ground = in && cls == -1.0f;
    // The warp's ground bounding box, by integer min/max reductions on
    // order-preserving images of the floats (exact); a warp with no ground
    // pixel skips the box and the AO rows.
    const bool warp_ground = __any_sync(0xffffffffu, ground);
    float4 box = make_float4(kPosInf, -kPosInf, kPosInf, -kPosInf);
    if (warp_ground) {
      const int bx = ordered(pwx), by = ordered(pwy);
      box = make_float4(
          unordered(__reduce_min_sync(0xffffffffu, ground ? bx : INT_MAX)),
          unordered(__reduce_max_sync(0xffffffffu, ground ? bx : INT_MIN)),
          unordered(__reduce_min_sync(0xffffffffu, ground ? by : INT_MAX)),
          unordered(__reduce_max_sync(0xffffffffu, ground ? by : INT_MIN)));
    }
    __syncthreads();  // s_p complete

    // Contact AO: m = min over the warp's kept rows of (d - r), taken by
    // the whole warp (the row mask is uniform), used on ground pixels.
    float m_ao = kPosInf;
    if (warp_ground) {
      for (int a0 = 0; a0 < n_ao; a0 += kTileW) {
        const bool keep = a0 + tx < n_ao && ao_reaches(s_ao[a0 + tx], box);
        for (unsigned mask = __ballot_sync(0xffffffffu, keep); mask; mask &= mask - 1) {
          const float4 q = s_ao[a0 + __ffs(mask) - 1];
          const float dxa = pwx - q.x;
          const float dya = pwy - q.y;
          const float d = sqrtf(dxa * dxa + dya * dya);
          m_ao = fminf(m_ao, d - q.z);
        }
      }
    }

    if (in) {
      // Differences to the next row and column; zero on the frame's last.
      float dyx = 0.0f, dyy = 0.0f, dyz = 0.0f, dxx = 0.0f, dxy = 0.0f, dxz = 0.0f;
      if (row + 1 < height) {
        dyx = s_p[0][ty + 1][tx] - pwx;
        dyy = s_p[1][ty + 1][tx] - pwy;
        dyz = s_p[2][ty + 1][tx] - pwz;
      }
      if (col + 1 < width) {
        dxx = s_p[0][ty][tx + 1] - pwx;
        dxy = s_p[1][ty][tx + 1] - pwy;
        dxz = s_p[2][ty][tx + 1] - pwz;
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

      float alb[3] = {tab[0], tab[1], tab[2]};
      const float dxw = pwx - tab[12], dyw = pwy - tab[13], dzw = pwz - tab[14];
      const float lx = tab[3] * dxw + tab[6] * dyw + tab[9] * dzw;
      const float ly = tab[4] * dxw + tab[7] * dyw + tab[10] * dzw;
      const float lz = tab[5] * dxw + tab[8] * dyw + tab[11] * dzw;
      procedural_albedo(alb, lx, ly, lz, cls, p[24], p[26]);
      const float ao_f = cls == -1.0f ? 0.45f + 0.55f * clampf(m_ao / 0.6f, 0.0f, 1.0f) : 1.0f;

      // Lambert sun + hemispheric dome ambient; sky gradient on misses.
      const float sun_i = p[19], dome_i = p[20];
      const float tex = 1.0f + 0.15f * p[25] * (hash_noise(pwx, pwy, pwz) - 0.5f) * 2.0f;
      const float ndotl = fmaxf(-(nx * p[16] + ny * p[17] + nz * p[18]), 0.0f);
      const float direct = sun_i * ndotl;
      const float ambient = dome_i * (0.25f + 0.35f * (0.5f * (1.0f + nz))) * ao_f;
      const float sky_base = __fmul_rn(__fadd_rn(0.85f, __fmul_rn(0.15f, clampf(rdz, 0.0f, 1.0f))),
                                       fmaxf(dome_i, 0.3f));
      uint8_t rgb[3];
      for (int ch = 0; ch < 3; ++ch) {
        const float dc = p[21 + ch];
        const float color =
            is_hit ? (alb[ch] * tex) * (direct + ambient * dc) : __fmul_rn(dc, sky_base);
        const float c = clampf(color, 0.0f, 1.0f);
        rgb[ch] = (uint8_t)rintf(__fmul_rn(gamma22(c), 255.0f));
      }
      if (vec_out) {
        for (int ch = 0; ch < 3; ++ch) s_out[ty][tx * 3 + ch] = rgb[ch];
      } else {
        uint8_t* o = out + ((size_t)b * n_pix + pix) * 3;
        for (int ch = 0; ch < 3; ++ch) o[ch] = rgb[ch];
      }
    }
    __syncthreads();  // s_out complete; s_p free for the next tile
    if (vec_out && tid < kTileH * 6) {
      const int rr = tid / 6, seg = tid - rr * 6;
      if (r0 + rt + rr < height) {
        uint8_t* o = out + ((size_t)b * n_pix + (size_t)(r0 + rt + rr) * width + c0) * 3;
        *reinterpret_cast<uint4*>(o + seg * 16) =
            *reinterpret_cast<const uint4*>(&s_out[rr][seg * 16]);
      }
    }
  }
}

}  // namespace
}  // namespace cspe

// t (B, H, W) f32 (+inf on miss/clip), inst (B, H, W) int32, table
// (B, n_rows, 16) f32, ao (B, n_ao, 4) f32, par (B, 32) f32;
// out (B, H, W, 3) u8. Returns kErrSharedMemory, launching nothing, if the
// table, the AO rows and the kernel's static arrays exceed kSmemLimit.
CSPE_API int cspe_rgb(const float* t, const int* inst, const float* table, int n_rows,
                      const float* ao, int n_ao, const float* par, int batch, int height,
                      int width, uint8_t* out, void* stream) {
  using namespace cspe;
  const dim3 block(kTileW, kTileH);
  const dim3 grid((width + kTileW - 1) / kTileW, (height + kRows - 1) / kRows, batch);
  const size_t smem = (size_t)(n_rows * 16 + n_ao * 4) * sizeof(float);
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, rgb_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem + attr.sharedSizeBytes > kSmemLimit) return kErrSharedMemory;
  rgb_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      t, inst, table, n_rows, ao, n_ao, par, height, width, out);
  return static_cast<int>(cudaGetLastError());
}
