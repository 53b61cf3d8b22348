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
// The textured variant (the image-texture tier) is this kernel compiled
// with TEX = true; the JAX package shades textured frames in jnp, outside
// its Pallas kernel (annotate.py:276-280), so the variant replaces that
// tier's textures.apply_image_textures, shading.perturb_normal and the
// rough/spec_w term of shading.shade. Plain version: plain_rgb with its
// `texels`. After the procedural patterns a hit pixel takes, by class and
// local coordinates, a texture slot, (u, v) and a weight (the mask ladder
// of render/textures.py; render/rgb_kernel.texture_plan_plain mirrors it),
// samples the dense (13, 128, 128, 4) texel table (textures.dense_table:
// each texel the clipped rank-12 sum, computed once) with one 16-byte load,
// tints, mixes or weaves, and on the leaf crown and the three garments
// samples the *_nr slot (normal offsets and roughness) with a second load,
// issued beside the first. Every hit pixel's normal is then renormalized,
// and where the map applies perturbed in the chart-free tangent frame
// first; the shade adds the Blinn-Phong term (accurate powf) on those
// pixels. Bins are the floor modulo of floor(u * 128) (((i % B) + B) % B),
// as jnp's `%` and torch.remainder: world u is often negative. A pixel of
// mix weight 0 keeps its albedo exactly, so it skips the first load unless
// it is the vest's (weight 0, but its weave needs the sample); a pixel of
// map weight 0 adds an exact 0 and skips the second. Its bound: the same
// device-memory bytes as the untextured kernel (t and instance in, u8
// out) plus the 3.4 MB table once, which then stays in the 50 MB L2; the
// operations of the untextured hit pixel plus the texture work of the hit
// pixels that take it, and on a sky pixel only its ray, sky gradient and
// gamma chains (chip_smoke.py's rgb_variant_bound; bytes-bound at 64 x
// 512^2 since the sky pixels are charged their path, PERF.md §6).
//
// Design of the variant, for the same IEEE operations in the same order a
// pixel as its first build (whose images it gives bit for bit):
// - A sky pixel (t not finite) takes its colour from its ray alone, on a
//   path of its own: no normal, albedo, hash noise, texture or shade, none
//   of which reaches its colour. The hit pixels' path is the untextured
//   kernel's text, so the untextured instantiations are the same machine
//   code as before the variant was redesigned.
// - The mask ladder takes r_xy only on trees and theta (atan2f) only on
//   trunks and garments, the rungs that read them.
// - The default's register cap, __launch_bounds__(256, 8): 32 registers
//   (ptxas: 20 to 40 bytes of spill stores), 64 warps an SM.
// Measured by tools/kernel_variants.py on an H100 SXM (NVIDIA H100 80GB
// HBM3, 700.00 W), device time a launch at 64 x 512^2 on the datagen path's
// inputs, two turns each in one window (PERF.md §6): 0.4488 and 0.4491 ms,
// beside the untextured 0.4107 and 0.4106 and the first build's 0.5990
// (62 registers under a cap of 4 blocks); textured+normal 0.3959 and
// 0.3955 (first build 0.5139, 0.5179), textured+shadow 0.4552 and 0.4554
// (0.6324, 0.6323), textured+normal+shadow 0.3951 and 0.4069 (0.5514,
// 0.5513). Caps, each bit-equal: 4 blocks (62 registers, no spills) 0.5337,
// 5 (48, none) 0.4810, 6 (40, 16 B) 0.4581, 8 0.4490. Each stage by its
// absence: the texture stage 0.063 ms (the texel loads 0.020, theta and
// r_xy 0.002), the renormalize 0.010, powf 0.007 to 0.014; the sky path
// saves 0.048. In the first build the same stages cost 0.09 (loads 0.044,
// theta and r_xy 0.019), 0.015 and 0.012, and its cap ~0.07. Tried and
// dropped with their code as slower: the mask ladder run as soon as the
// table row is known, with both loads issued there as cp.async copies into
// shared memory (8 KB a block) to land during the sync, the AO walk and
// the normal: 0.4650 ms against 0.4517 for plain loads where they are used
// (0.4540 to 0.4613 with the ladder after the sync, after the AO walk or
// before the patterns); at 64 warps an SM the other warps hide the loads,
// and the early ladder only lengthens what a thread holds across the sync.
//
// The tier variants (annotate.render_frame's analytic_normals, sun_shadows
// and procedural_textures=False, which the JAX package shades in jnp,
// annotate.py:276-280) are this kernel compiled with a tier mask TIER
// (render/rgb_kernel.TIERS): kTierNormal reads the pixel's world normal
// from a (B, H, W, 3) plane in place of the screen-space normal, so the
// variant builds no hit points for its neighbours (no s_p, no halo rays);
// kTierShadow reads the pixel's hit distance toward the sun and zeroes the
// direct and specular terms unless it is >= 1e9 (shading.shade's `lit`);
// kTierFlat shades the table's flat albedo: no local coordinates,
// patterns, image textures or contact AO (no ground box, no AO walk), the
// hash noise kept. TEX composes with the first two; a flat variant is
// never textured. Each (TEX, TIER) is its own instantiation, so the default
// one (TIER 0) is the code above, instruction for instruction, at 32
// registers and no spills; TIER = kRuntimeTier reads the mask at run time
// instead (one kernel with uniform branches), which tools/kernel_variants.py
// builds to weigh the two. Measured by it on an H100 SXM (NVIDIA H100 80GB
// HBM3, 700 W), device time a launch at 64 x 512^2, two turns each, the
// images bit-equal: the instantiations took 0.408 and 0.413 ms (default),
// 0.361 (normal), 0.418 (shadow), 0.322 (flat), 0.275 (flat+normal+shadow);
// the runtime-mask kernel (32 registers, no spills) 0.433, 0.371, 0.440,
// 0.360 and 0.311 ms: 3 to 13% slower, so each mask is its own kernel. The
// untextured tier variants keep the default's cap (kMinBlocksTier = 8: 32
// registers, 8 or 16 bytes of spill stores where a normal is read or the
// albedo is flat); a cap of 6 blocks (40 registers, no spills) was no
// faster (0.365 to 0.437 ms).
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
constexpr int kMinBlocksTex = 8;                // the textured variant: at most 32
constexpr int kMinBlocksTier = 8;               // the untextured tier variants
// The texel table's bins a side (render/rgb_kernel.TEX_BINS) and its slots
// (render/textures.TEX).
constexpr int kTexBins = 128;
constexpr double kPi = 3.14159265358979323846;
enum TexSlot {
  kBark = 0, kLeaf = 2, kTwill = 4, kDenim = 5, kGround = 6, kDirt = 7, kCotOx = 8,
  kDenimNr = 9, kCotOxNr = 10, kTwillNr = 11, kLeafNr = 12
};
// The AO cull widens each row's reach r + 0.6 to (r + 0.6) kAoScale +
// kAoAbs (render/rgb_kernel.AO_SCALE, AO_ABS): far above the few ulps by
// which a pixel's computed distance can fall below the box's.
constexpr float kAoScale = 1.0001f;
constexpr float kAoAbs = 1e-4f;
// Tier mask bits (render/rgb_kernel.TIER_*), and the instantiation that
// reads the mask at run time.
constexpr int kTierNormal = 1;
constexpr int kTierShadow = 2;
constexpr int kTierFlat = 4;
constexpr int kTierAll = 7;
constexpr int kRuntimeTier = -1;
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

// The texel index of slot `tex` at (u, v): floor(u * B) and floor(v * B)
// taken modulo B as a floor modulo (u * B is exact, B being a power of two).
__device__ __forceinline__ int texel_index(int tex, float u, float v) {
  int ub = (int)floorf(u * (float)kTexBins);
  int vb = (int)floorf(v * (float)kTexBins);
  ub = ((ub % kTexBins) + kTexBins) % kTexBins;
  vb = ((vb % kTexBins) + kTexBins) % kTexBins;
  return (tex * kTexBins + ub) * kTexBins + vb;
}

// textures.apply_image_textures on one hit pixel: the procedural albedo
// `alb` becomes the textured one; (du, dv, rough, w_nr) are the normal-map
// offsets, roughness and map weight (left at 0 where no map applies). The
// mask ladder (render/rgb_kernel.texture_plan_plain mirrors it) takes r_xy
// only on trees and theta only on trunks and garments, where it reads them;
// both texel loads go out before either is used. The (u, v) arithmetic is
// uncontracted, in PyTorch's order, so a bin edge moves only with the ulps
// of the local coordinates.
__device__ __forceinline__ void image_textures(float* alb, float lx, float ly, float lz, float pwx,
                                               float pwy, float cls, float phase,
                                               const float4* __restrict__ texels, float& du,
                                               float& dv, float& rough, float& w_nr) {
  const auto theta = [&] {
    return __fadd_rn(__fmul_rn(atan2f(ly, lx), (float)(0.5 / kPi)), 0.5f);
  };
  float u = __fadd_rn(__fmul_rn(pwx, (float)(1.0 / 6.0)), phase);
  float v = __fmul_rn(pwy, (float)(1.0 / 6.0));
  int tex = kGround, nr_tex = -1;
  float w = cls == -1.0f ? 0.45f : 0.0f;
  float tint[3] = {1.0f, 1.0f, 1.0f};
  bool vest = false;
  if (cls == 1.0f) {
    const float r_xy = sqrtf(lx * lx + ly * ly);
    if (r_xy < 0.45f && lz < 3.2f) {  // trunk
      u = __fadd_rn(theta(), phase);
      v = __fmul_rn(lz, (float)(1.0 / 2.5));
      tex = kBark;
      w = 0.85f;
    } else {  // crown
      u = __fadd_rn(__fmul_rn(lx, (float)(1.0 / 1.5)), phase);
      v = __fmul_rn(lz, (float)(1.0 / 1.5));
      tex = kLeaf;
      w = 0.5f;
      nr_tex = kLeafNr;
      w_nr = 0.8f;
    }
  } else if (cls == 4.0f && lz < 0.55f) {
    u = __fadd_rn(__fmul_rn(lx, 0.35f), phase);
    v = __fmul_rn(ly, 0.35f);
    tex = kDirt;
    w = 0.5f;
  } else if (cls == 5.0f) {
    if (lz > 1.02f && lz < 1.48f) {
      u = __fadd_rn(__fmul_rn(theta(), 4.0f), phase);
      v = __fmul_rn(lz, 2.0f);
      tex = kTwill;
      nr_tex = kTwillNr;
      w_nr = 1.0f;
      vest = true;
    } else if (lz <= 1.02f) {
      u = __fadd_rn(__fmul_rn(theta(), 2.0f), phase);
      v = __fmul_rn(lz, 1.2f);
      tex = kDenim;
      w = 1.0f;
      nr_tex = kDenimNr;
      w_nr = 1.0f;
      set3(tint, 0.83f, 1.15f, 2.90f);
    } else if (lz >= 1.48f && lz < 1.58f) {
      u = __fadd_rn(__fmul_rn(theta(), 3.0f), phase);
      v = __fmul_rn(lz, 1.6f);
      tex = kCotOx;
      w = 1.0f;
      nr_tex = kCotOxNr;
      w_nr = 1.0f;
      set3(tint, 0.95f, 1.08f, 1.33f);
    }
  }
  // A pixel of mix weight 0 keeps its albedo exactly and samples nothing,
  // unless it is the vest's, whose weave needs the sample.
  if (w == 0.0f && !vest) return;
  const int i = texel_index(tex, u, v);
  const float4 s = __ldg(texels + i);
  const float4 m = nr_tex >= 0 ? __ldg(texels + i + (nr_tex - tex) * kTexBins * kTexBins)
                               : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const float c[3] = {clampf(__fmul_rn(tint[0], s.x), 0.0f, 1.0f),
                      clampf(__fmul_rn(tint[1], s.y), 0.0f, 1.0f),
                      clampf(__fmul_rn(tint[2], s.z), 0.0f, 1.0f)};
  if (vest) {
    const float weave = __fadd_rn(0.6f, __fmul_rn(0.8f, c[0]));
    for (int k = 0; k < 3; ++k) alb[k] = __fmul_rn(alb[k], weave);
  } else {
    for (int k = 0; k < 3; ++k)
      alb[k] = __fadd_rn(__fmul_rn(alb[k], __fsub_rn(1.0f, w)), __fmul_rn(c[k], w));
  }
  if (nr_tex >= 0) {
    du = __fmul_rn(__fsub_rn(__fmul_rn(2.0f, m.x), 1.0f), w_nr);
    dv = __fmul_rn(__fsub_rn(__fmul_rn(2.0f, m.y), 1.0f), w_nr);
    rough = m.z;
  }
}

// shading.perturb_normal with strength 0.6: the chart-free tangent frame
// t1 = normalize(n x up) (+x where n is vertical), t2 = n x t1, then the
// renormalize. Where no map applies (du = dv = 0) the offsets would add
// exact zeros, so only the renormalize runs.
__device__ __forceinline__ void perturb_normal(float& nx, float& ny, float& nz, float du,
                                               float dv, bool mapped) {
  float px = nx, py = ny, pz = nz;
  if (mapped) {
    const float mag = sqrtf(nx * nx + ny * ny);
    const bool deg = mag < 1e-4f;
    const float inv = 1.0f / (deg ? 1.0f : mag);
    const float t1x = deg ? 1.0f : ny * inv;
    const float t1y = deg ? 0.0f : -nx * inv;
    const float t2x = -nz * t1y, t2y = nz * t1x, t2z = nx * t1y - ny * t1x;
    px = nx + 0.6f * (du * t1x + dv * t2x);
    py = ny + 0.6f * (du * t1y + dv * t2y);
    pz = nz + 0.6f * (dv * t2z);
  }
  const float rn = 1.0f / sqrtf(fmaxf(px * px + py * py + pz * pz, 1e-12f));
  nx = px * rn;
  ny = py * rn;
  nz = pz * rn;
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

// Whether tier bit `bit` is set: from the template where it is a mask,
// from the launch's `tier` in the runtime-tier instantiation.
template <int TIER>
__device__ __forceinline__ bool tier_has(int tier, int bit) {
  return ((TIER >= 0 ? TIER : tier) & bit) != 0;
}

template <bool TEX, int TIER>
__global__ void __launch_bounds__(kTileW * kTileH,
                                  TEX ? kMinBlocksTex : TIER == 0 ? kMinBlocks : kMinBlocksTier)
rgb_kernel(const float* __restrict__ t, const int* __restrict__ inst,
           const float* __restrict__ table, int n_rows, const float* __restrict__ ao,
           int n_ao, const float* __restrict__ par, const float4* __restrict__ texels,
           const float* __restrict__ nrm, const float* __restrict__ shadow, int tier,
           int height, int width, uint8_t* __restrict__ out) {
  const bool given_n = tier_has<TIER>(tier, kTierNormal);
  const bool shadowed = tier_has<TIER>(tier, kTierShadow);
  const bool flat = tier_has<TIER>(tier, kTierFlat);
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
    if (!given_n) {
      s_p[0][ty][tx] = pwx;
      s_p[1][ty][tx] = pwy;
      s_p[2][ty][tx] = pwz;
    }
    if (halo && !given_n) {
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
    const bool ground = in && cls == -1.0f && !flat;
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

    if (TEX && in && !is_hit) {
      // The textured variant's sky pixel: only its ray reaches its colour,
      // so it builds no normal, albedo, noise or shade.
      const float sky_base = __fmul_rn(__fadd_rn(0.85f, __fmul_rn(0.15f, clampf(rdz, 0.0f, 1.0f))),
                                       fmaxf(p[20], 0.3f));
      uint8_t* o = vec_out ? &s_out[ty][tx * 3] : out + ((size_t)b * n_pix + pix) * 3;
      for (int ch = 0; ch < 3; ++ch) {
        const float c = clampf(__fmul_rn(p[21 + ch], sky_base), 0.0f, 1.0f);
        o[ch] = (uint8_t)rintf(__fmul_rn(gamma22(c), 255.0f));
      }
    }
    if (in && (!TEX || is_hit)) {
      const size_t px = (size_t)b * n_pix + pix;
      float nx, ny, nz;
      if (given_n) {
        nx = nrm[px * 3];
        ny = nrm[px * 3 + 1];
        nz = nrm[px * 3 + 2];
      } else {
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
        nx = dyy * dxz - dyz * dxy;
        ny = dyz * dxx - dyx * dxz;
        nz = dyx * dxy - dyy * dxx;
        const float ninv = 1.0f / sqrtf(fmaxf(nx * nx + ny * ny + nz * nz, 1e-18f));
        nx *= ninv;
        ny *= ninv;
        nz *= ninv;
        if (nx * rdx + ny * rdy + nz * rdz > 0.0f) {
          nx = -nx;
          ny = -ny;
          nz = -nz;
        }
      }

      float alb[3] = {tab[0], tab[1], tab[2]};
      float w_nr = 0.0f, rough = 0.0f;
      if (!flat) {
        const float dxw = pwx - tab[12], dyw = pwy - tab[13], dzw = pwz - tab[14];
        const float lx = tab[3] * dxw + tab[6] * dyw + tab[9] * dzw;
        const float ly = tab[4] * dxw + tab[7] * dyw + tab[10] * dzw;
        const float lz = tab[5] * dxw + tab[8] * dyw + tab[11] * dzw;
        procedural_albedo(alb, lx, ly, lz, cls, p[24], p[26]);
        if constexpr (TEX) {
          float du = 0.0f, dv = 0.0f;
          image_textures(alb, lx, ly, lz, pwx, pwy, cls, p[24], texels, du, dv, rough, w_nr);
          perturb_normal(nx, ny, nz, du, dv, w_nr != 0.0f);
        }
      }
      const float ao_f =
          !flat && cls == -1.0f ? 0.45f + 0.55f * clampf(m_ao / 0.6f, 0.0f, 1.0f) : 1.0f;
      // The sun-shadow gate: lit where the hit distance toward the sun is >= 1e9.
      const bool lit = !shadowed || shadow[px] >= 1e9f;

      // Lambert sun + hemispheric dome ambient; sky gradient on misses.
      const float sun_i = p[19], dome_i = p[20];
      const float tex = 1.0f + 0.15f * p[25] * (hash_noise(pwx, pwy, pwz) - 0.5f) * 2.0f;
      const float ndotl = fmaxf(-(nx * p[16] + ny * p[17] + nz * p[18]), 0.0f);
      const float direct = lit ? sun_i * ndotl : 0.0f;
      const float ambient = dome_i * (0.25f + 0.35f * (0.5f * (1.0f + nz))) * ao_f;
      const float sky_base = __fmul_rn(__fadd_rn(0.85f, __fmul_rn(0.15f, clampf(rdz, 0.0f, 1.0f))),
                                       fmaxf(dome_i, 0.3f));
      // The roughness specular of the mapped pixels (textured variant).
      float spec = 0.0f;
      if (TEX && w_nr != 0.0f && lit) {
        const float hx = -rdx - p[16], hy = -rdy - p[17], hz = -rdz - p[18];
        const float hn = 1.0f / sqrtf(fmaxf(hx * hx + hy * hy + hz * hz, 1e-12f));
        const float ndoth = fmaxf((nx * hx + ny * hy + nz * hz) * hn, 0.0f);
        const float shin = 2.0f / fmaxf(rough * rough, 0.02f);
        const float gloss = (1.0f - rough) * (1.0f - rough);
        spec = w_nr * gloss * sun_i * powf(ndoth, shin);
      }
      uint8_t rgb[3];
      for (int ch = 0; ch < 3; ++ch) {
        const float dc = p[21 + ch];
        const float color = is_hit ? (alb[ch] * tex) * (direct + ambient * dc) + spec
                                   : __fmul_rn(dc, sky_base);
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

using RgbKernelFn = void (*)(const float*, const int*, const float*, int, const float*, int,
                            const float*, const float4*, const float*, const float*, int, int,
                            int, uint8_t*);

// The instantiation of a (textured, tier) launch; null for a tier out of
// range or a textured flat one.
static RgbKernelFn rgb_variant(bool tex, int tier) {
  using namespace cspe;
  if (tier < 0 || tier > kTierAll || (tex && (tier & kTierFlat))) return nullptr;
  static const RgbKernelFn plain[] = {rgb_kernel<false, 0>, rgb_kernel<false, 1>,
                                      rgb_kernel<false, 2>, rgb_kernel<false, 3>,
                                      rgb_kernel<false, 4>, rgb_kernel<false, 5>,
                                      rgb_kernel<false, 6>, rgb_kernel<false, 7>};
  static const RgbKernelFn textured[] = {rgb_kernel<true, 0>, rgb_kernel<true, 1>,
                                         rgb_kernel<true, 2>, rgb_kernel<true, 3>};
  return tex ? textured[tier] : plain[tier];
}

// t (B, H, W) f32 (+inf on miss/clip), inst (B, H, W) int32, table
// (B, n_rows, 16) f32, ao (B, n_ao, 4) f32, par (B, 32) f32; texels null
// (untextured) or the (13, kTexBins, kTexBins, 4) f32 table (textured);
// normal (B, H, W, 3) f32 where tier has kTierNormal, shadow (B, H, W) f32
// where it has kTierShadow, else null; out (B, H, W, 3) u8. Returns
// kErrArgument for a tier and pointers that do not fit together, and
// kErrSharedMemory if the table, the AO rows and the kernel's static
// arrays exceed kSmemLimit, launching nothing.
CSPE_API int cspe_rgb_tier(const float* t, const int* inst, const float* table, int n_rows,
                           const float* ao, int n_ao, const float* par, const float* texels,
                           const float* normal, const float* shadow, int tier, int batch,
                           int height, int width, uint8_t* out, void* stream) {
  using namespace cspe;
  const RgbKernelFn kernel = rgb_variant(texels != nullptr, tier);
  if (kernel == nullptr || ((tier & kTierNormal) != 0) != (normal != nullptr) ||
      ((tier & kTierShadow) != 0) != (shadow != nullptr))
    return kErrArgument;
  const dim3 block(kTileW, kTileH);
  const dim3 grid((width + kTileW - 1) / kTileW, (height + kRows - 1) / kRows, batch);
  const size_t smem = (size_t)(n_rows * 16 + n_ao * 4) * sizeof(float);
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem + attr.sharedSizeBytes > kSmemLimit) return kErrSharedMemory;
  kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      t, inst, table, n_rows, ao, n_ao, par, reinterpret_cast<const float4*>(texels), normal,
      shadow, tier, height, width, out);
  return static_cast<int>(cudaGetLastError());
}

// The default and textured kernels: cspe_rgb_tier at tier 0.
CSPE_API int cspe_rgb(const float* t, const int* inst, const float* table, int n_rows,
                      const float* ao, int n_ao, const float* par, const float* texels, int batch,
                      int height, int width, uint8_t* out, void* stream) {
  return cspe_rgb_tier(t, inst, table, n_rows, ao, n_ao, par, texels, nullptr, nullptr, 0, batch,
                       height, width, out, stream);
}
