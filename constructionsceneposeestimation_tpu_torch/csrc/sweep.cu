// Pixel-ray x primitive sweep: depth and instance for every pixel of a
// batch of frames, in one packed f32 per pixel.
//
// Replaces the Pallas TPU kernel `kernel` of `make_pixel_sweeper`
// (constructionsceneposeestimation_tpu/render/sweep_kernel.py:107-355).
// Plain version: render/raycast.Raycaster.packed on the pixel rays
// (render/sweep_kernel.plain_pixel_sweep).
//
// Each pixel generates its unit ray from the pixel index (exact normalise:
// t is a depth label) and keeps a running min of t with the instance code
// (inst + 2) in the low 6 mantissa bits (render/raycast._pack). The min is
// taken over positive IEEE floats, so ties resolve exactly as in the plain
// version, and in any order of the primitives. A miss stays raycast.INF =
// 1e10, never IEEE inf.
//
// What bounds it on an H100: arithmetic. A brute-force walk costs every
// pixel all ~76 primitives of 20-100 FP32 operations plus IEEE divides and
// square roots; the only HBM traffic is the 4-byte output (67 MB for 64
// frames at 512^2). Most primitives are small on screen (limbs, cones,
// trunks, fence panels), so most of that walk tests rays that cannot hit.
//
// Design: tile-culled walk.
// - Tiles. The cull works on 32 x 8 pixel tiles, so each output row of a
//   warp is one 128-byte segment; tiles at the right and bottom edges are
//   ragged. A block of 32 x 8 threads walks a column of kTiles = 16 tiles
//   of one frame (grid: tile columns, groups of 16 tile rows, frames), one
//   tile after the other.
// - Cull in the prologue. The block builds its tile's ray cone: the ray
//   through the tile's centre and the largest angle from it to the four
//   corner rays (the rays of a pixel rectangle fill the pyramid of its
//   corner rays, and the angle to a fixed axis is largest at a vertex).
//   Each schedule row has a bounding sphere, centred on its primitive with
//   the radius R that render/sweep_kernel.bounding_radii gives. With the
//   cone angle widened to alpha' = (1 + 1e-3) alpha + 1e-6 rad and the
//   radius to R' = (1 + 1e-3) R, a row is kept if the camera lies within
//   R' of the centre, or if the angle phi to the centre is at most alpha' +
//   asin(R' / d), tested without transcendentals as a.v >= cos(alpha')
//   sqrt(d^2 - R'^2) - sin(alpha') R'. The margins (~7e-5 rad on a 32 x 8
//   tile at 512^2) cover the rounding of the rays and of that cosine test,
//   ~1e-6 rad. A cone wider than pi / 2 keeps every row; the plane is always
//   kept. render/sweep_kernel.tile_cull_plain mirrors this test.
// - Prologue, once a block. Every schedule row's per-(frame, primitive)
//   terms go into shared memory: the origin offset, the rotated local
//   origin, slab numerators and the constant terms of the quadrics, and its
//   bounding ball. Then 5 threads a tile build the tiles' cones, and one
//   thread a (tile, row) pair tests it and appends the kept rows to the
//   tile's list. The prologue is latency (dependent loads of the schedule
//   and the poses, the cones' divides and square roots). Tried on the H100
//   while this was built, a block of one tile spent most of its time
//   there, so a block shares it among 16 tiles.
// - Walk. Threads walk only their tile's list with a switch on its op.
// The cull skips only primitives that no ray of the tile can hit, so the
// packed min equals that of the full walk.
//
// The formulas are the TPU kernel's category specializations with its two
// simplifications against the plain caster: |d| == 1 and capped
// cylinders/cones as the quadric interval intersected with the z-slab.
#include "common.cuh"

namespace cspe {
namespace {

enum Op : int {
  OP_PLANE = 0,     // inv: ground plane
  OP_SPHERE = 1,    // inv
  OP_CYL_INV = 2,   // inv: upright solid capped cylinder
  OP_CONE_INV = 3,  // inv: upright cone frustum with caps
  OP_BOX_AA = 4,    // static fence panel, world axes (x/y swapped if swap)
  OP_BOX_YAW = 5,   // identity-local box on a yaw-only instance
  OP_CAPSULE = 6,   // posed capsule, axial/radial decomposition
  OP_BOX_GEN = 7,   // box in a general frame
  OP_CYL_GEN = 8,   // solid capped cylinder in a general frame
};

constexpr int kTileW = 32;  // render/sweep_kernel.TILE
constexpr int kTileH = 8;
constexpr int kTiles = 16;  // tiles a block walks, one above the other
constexpr float kCullRel = 1e-3f;   // render/sweep_kernel.CULL_REL
constexpr float kCullAbs = 1e-6f;   // render/sweep_kernel.CULL_ABS

// A kept schedule row: op and code, then its terms (per op, below).
struct Entry {
  int op, code, swap, pad;
  float4 a, b, c, d;
};

__device__ __forceinline__ float pack(float t, int code) {
  return __int_as_float((__float_as_int(t) & ~kPayloadMask) | code);
}

__device__ __forceinline__ void merge(float& best, float t, bool ok, int code) {
  const float tt = (ok && t > kEps) ? t : kInf;
  best = fminf(best, pack(tt, code));
}

// Slab interval of one axis from its numerators (-h - o, h - o), folded
// into [enter, exit].
__device__ __forceinline__ void slab(float nlo, float nhi, float rinv, float& enter,
                                     float& exit_, bool first) {
  const float t1 = nlo * rinv;
  const float t2 = nhi * rinv;
  const float lo = fminf(t1, t2);
  const float hi = fmaxf(t1, t2);
  enter = first ? lo : fmaxf(enter, lo);
  exit_ = first ? hi : fminf(exit_, hi);
}

// The unit ray through pixel (col, row); cam as the wrapper lays it out.
__device__ __forceinline__ void pixel_ray(const float* cam, float col, float row, float& dx,
                                          float& dy, float& dz) {
  const float xpin = (col - cam[9]) / cam[11];
  const float ypin = (row - cam[10]) / cam[12];
  dx = cam[0] * xpin + cam[1] * ypin + cam[2];
  dy = cam[3] * xpin + cam[4] * ypin + cam[5];
  dz = cam[6] * xpin + cam[7] * ypin + cam[8];
  const float inv = 1.0f / sqrtf(dx * dx + dy * dy + dz * dz);  // exact, not rsqrtf
  dx *= inv;
  dy *= inv;
  dz *= inv;
}

// Angle between unit a and any v, accurate at small angles.
__device__ __forceinline__ float angle(float ax, float ay, float az, float vx, float vy,
                                      float vz) {
  const float cx = ay * vz - az * vy;
  const float cy = az * vx - ax * vz;
  const float cz = ax * vy - ay * vx;
  return atan2f(sqrtf(cx * cx + cy * cy + cz * cz), ax * vx + ay * vy + az * vz);
}

// Upright or local-frame solid capped cylinder: quadric interval
// intersected with the z-slab.
__device__ __forceinline__ void capped_cylinder(float b2, float c2, float a2, float ra2,
                                                float zlo_n, float zhi_n, float rdz,
                                                float& best, int code) {
  const float disc = b2 * b2 - a2 * c2;
  const float sq = sqrtf(fmaxf(disc, 0.0f));
  const float q_lo = (-b2 - sq) * ra2;
  const float q_hi = (-b2 + sq) * ra2;
  const float tz1 = zlo_n * rdz;
  const float tz2 = zhi_n * rdz;
  const float z_lo = fminf(tz1, tz2);
  const float z_hi = fmaxf(tz1, tz2);
  const bool deg = a2 < kEps;  // ray parallel to the axis
  const float enter = deg ? z_lo : fmaxf(q_lo, z_lo);
  const float exit_ = deg ? z_hi : fminf(q_hi, z_hi);
  const bool ok = ((deg && c2 < 0.0f) || (!deg && disc > 0.0f)) && enter <= exit_ &&
                  exit_ > 0.0f;
  merge(best, enter, ok, code);
}

// The per-(frame, primitive) terms of schedule row (si, sf) posed by ps
// (pos | rot row-major), seen from the camera at (camx, camy, camz).
__device__ Entry make_entry(int4 si, float4 sf, const float* ps, float camx, float camy,
                            float camz) {
  Entry e;
  e.op = si.x;
  e.code = si.z;
  e.swap = e.pad = 0;
  const float ox = camx - ps[0];
  const float oy = camy - ps[1];
  const float oz = camz - ps[2];
  const float z4 = 0.0f;
  e.a = e.b = e.c = e.d = make_float4(z4, z4, z4, z4);
  switch (si.x) {
    case OP_PLANE:
      e.a.z = oz;
      break;
    case OP_SPHERE:  // a: o, |o|^2 - r^2
      e.a = make_float4(ox, oy, oz, ox * ox + oy * oy + oz * oz - sf.x * sf.x);
      break;
    case OP_CYL_INV:  // a: o, c2; b: z-slab numerators
      e.a = make_float4(ox, oy, oz, ox * ox + oy * oy - sf.x * sf.x);
      e.b = make_float4(-sf.y - oz, sf.y - oz, z4, z4);
      break;
    case OP_CONE_INV: {  // a: o, cq; b: k, q, hh; c: cap numerators, rb^2, rt^2
      const float rb = sf.x, rt = sf.y, hh = sf.z;
      const float k = (rt - rb) / (2.0f * hh);
      const float q = rb + k * (oz + hh);
      e.a = make_float4(ox, oy, oz, ox * ox + oy * oy - q * q);
      e.b = make_float4(k, q, hh, z4);
      e.c = make_float4(-hh - oz, hh - oz, rb * rb, rt * rt);
      break;
    }
    case OP_BOX_AA: {  // a, b: slab numerators in local axis order
      const float o_w[3] = {ox, oy, oz};
      float ol[3];
      for (int la = 0; la < 3; ++la) ol[la] = o_w[si.w ? (la == 0 ? 1 : (la == 1 ? 0 : 2)) : la];
      e.swap = si.w;
      e.a = make_float4(-sf.x - ol[0], -sf.y - ol[1], -sf.z - ol[2], z4);
      e.b = make_float4(sf.x - ol[0], sf.y - ol[1], sf.z - ol[2], z4);
      break;
    }
    case OP_BOX_YAW: {  // a: cos, sin of the yaw; b, c: slab numerators
      const float cth = ps[3];  // rot[0][0]
      const float sth = ps[6];  // rot[1][0]
      const float olx = cth * ox + sth * oy;
      const float oly = -sth * ox + cth * oy;
      e.a = make_float4(cth, sth, z4, z4);
      e.b = make_float4(-sf.x - olx, sf.x - olx, -sf.y - oly, sf.y - oly);
      e.c = make_float4(-sf.z - oz, sf.z - oz, z4, z4);
      break;
    }
    case OP_CAPSULE: {  // a: o, o.axis; b: axis, c2; c: hh, the ends' c
      const float r = sf.x, hh = sf.y;
      const float ax0 = ps[5], ax1 = ps[8], ax2 = ps[11];  // rot[:, 2]
      const float oz_ax = ox * ax0 + oy * ax1 + oz * ax2;
      const float oo = ox * ox + oy * oy + oz * oz;
      e.a = make_float4(ox, oy, oz, oz_ax);
      e.b = make_float4(ax0, ax1, ax2, oo - oz_ax * oz_ax - r * r);
      e.c = make_float4(hh, oo - (2.0f * -1.0f) * hh * oz_ax + hh * hh - r * r,
                        oo - (2.0f * 1.0f) * hh * oz_ax + hh * hh - r * r, z4);
      break;
    }
    case OP_BOX_GEN:
    case OP_CYL_GEN: {  // a, b, c: rot column i, local origin i; d: params
      // local = R^T world
      const float r00 = ps[3], r01 = ps[4], r02 = ps[5];
      const float r10 = ps[6], r11 = ps[7], r12 = ps[8];
      const float r20 = ps[9], r21 = ps[10], r22 = ps[11];
      e.a = make_float4(r00, r10, r20, r00 * ox + r10 * oy + r20 * oz);
      e.b = make_float4(r01, r11, r21, r01 * ox + r11 * oy + r21 * oz);
      e.c = make_float4(r02, r12, r22, r02 * ox + r12 * oy + r22 * oz);
      e.d = sf;
      break;
    }
    default:
      break;
  }
  return e;
}

// The packed nearest hit of the unit ray (dx, dy, dz) over the n kept rows
// list[0 .. n) of ents.
__device__ __forceinline__ float walk(const Entry* ents, const short* list, int n, float dx,
                                      float dy, float dz) {
  // Per-ray quantities shared by every primitive (|d|^2 == 1).
  const float a2 = dx * dx + dy * dy;
  const float ra2 = 1.0f / fmaxf(a2, kEps);
  const float rdz = 1.0f / safe_den(dz);
  const float rdx = 1.0f / safe_den(dx);
  const float rdy = 1.0f / safe_den(dy);

  float best = kInf;
  for (int i = 0; i < n; ++i) {
    const Entry& e = ents[list[i]];
    const int code = e.code;
    switch (e.op) {
      case OP_PLANE:
        merge(best, -e.a.z * rdz, fabsf(dz) >= kEps, code);
        break;
      case OP_SPHERE: {
        const float4 a = e.a;
        const float bb = a.x * dx + a.y * dy + a.z * dz;
        const float disc = bb * bb - a.w;
        const float sq = sqrtf(fmaxf(disc, 0.0f));
        merge(best, -bb - sq, disc > 0.0f, code);
        break;
      }
      case OP_CYL_INV: {
        const float4 a = e.a, bz = e.b;
        capped_cylinder(a.x * dx + a.y * dy, a.w, a2, ra2, bz.x, bz.y, rdz, best, code);
        break;
      }
      case OP_CONE_INV: {
        const float4 a = e.a, kq = e.b, cp = e.c;
        const float ox = a.x, oy = a.y, oz = a.z, k = kq.x, q = kq.y, hh = kq.z;
        const float m = k * dz;
        const float aa = a2 - m * m;
        const float bb = ox * dx + oy * dy - q * m;
        const float a_safe = safe_den(aa);
        const float disc = bb * bb - a_safe * a.w;
        const float sq = sqrtf(fmaxf(disc, 0.0f));
        const float ra = 1.0f / a_safe;
        const float t1 = (-bb - sq) * ra;
        const float t2 = (-bb + sq) * ra;
        const float t_lo = fminf(t1, t2);
        const float t_hi = fmaxf(t1, t2);
        const float z_lo = oz + t_lo * dz, z_hi = oz + t_hi * dz;
        const bool ok_lo = disc > 0.0f && fabsf(z_lo) <= hh && q + m * t_lo > 0.0f;
        const bool ok_hi = disc > 0.0f && fabsf(z_hi) <= hh && q + m * t_hi > 0.0f;
        const float t_side = ok_lo ? t_lo : (ok_hi ? t_hi : kInf);
        merge(best, t_side, t_side < kInf, code);
#pragma unroll
        for (int cap = 0; cap < 2; ++cap) {
          const float t_c = (cap ? cp.y : cp.x) * rdz;
          const float xx = ox + t_c * dx;
          const float yy = oy + t_c * dy;
          merge(best, t_c, xx * xx + yy * yy <= (cap ? cp.w : cp.z), code);
        }
        break;
      }
      case OP_BOX_AA: {
        const float4 lo = e.a, hi = e.b;
        const bool swap = e.swap != 0;
        float enter = 0.0f, exit_ = 0.0f;
        slab(lo.x, hi.x, swap ? rdy : rdx, enter, exit_, true);
        slab(lo.y, hi.y, swap ? rdx : rdy, enter, exit_, false);
        slab(lo.z, hi.z, rdz, enter, exit_, false);
        merge(best, enter, exit_ >= enter && exit_ > 0.0f, code);
        break;
      }
      case OP_BOX_YAW: {
        const float4 cs = e.a, xy = e.b, z = e.c;
        const float dlx = cs.x * dx + cs.y * dy;
        const float dly = -cs.y * dx + cs.x * dy;
        float enter = 0.0f, exit_ = 0.0f;
        slab(xy.x, xy.y, 1.0f / safe_den(dlx), enter, exit_, true);
        slab(xy.z, xy.w, 1.0f / safe_den(dly), enter, exit_, false);
        slab(z.x, z.y, rdz, enter, exit_, false);
        merge(best, enter, exit_ >= enter && exit_ > 0.0f, code);
        break;
      }
      case OP_CAPSULE: {
        const float4 o = e.a, ax = e.b, ends = e.c;
        const float oz_ax = o.w, hh = ends.x;
        const float dz_ax = ax.x * dx + ax.y * dy + ax.z * dz;
        const float od = o.x * dx + o.y * dy + o.z * dz;
        const float a2c = 1.0f - dz_ax * dz_ax;
        const float b2c = od - oz_ax * dz_ax;
        const float a2_safe = a2c < kEps ? kEps : a2c;
        const float disc2 = b2c * b2c - a2_safe * ax.w;
        const float sq2 = sqrtf(fmaxf(disc2, 0.0f));
        const float t_side = (-b2c - sq2) / a2_safe;
        const float z_side = oz_ax + t_side * dz_ax;
        merge(best, t_side, disc2 > 0.0f && fabsf(z_side) <= hh && a2c >= kEps, code);
#pragma unroll
        for (int end = 0; end < 2; ++end) {
          const float sign = end ? 1.0f : -1.0f;
          const float bs = od - (sign * hh) * dz_ax;
          const float disc = bs * bs - (end ? ends.z : ends.y);
          const float sq = sqrtf(fmaxf(disc, 0.0f));
          merge(best, -bs - sq, disc > 0.0f, code);
        }
        break;
      }
      case OP_BOX_GEN:
      case OP_CYL_GEN: {
        const float4 c0v = e.a, c1v = e.b, c2v = e.c, p = e.d;
        const float ol[3] = {c0v.w, c1v.w, c2v.w};
        const float dl[3] = {c0v.x * dx + c0v.y * dy + c0v.z * dz,
                             c1v.x * dx + c1v.y * dy + c1v.z * dz,
                             c2v.x * dx + c2v.y * dy + c2v.z * dz};
        if (e.op == OP_BOX_GEN) {
          const float h[3] = {p.x, p.y, p.z};
          float enter = 0.0f, exit_ = 0.0f;
#pragma unroll
          for (int k = 0; k < 3; ++k)
            slab(-h[k] - ol[k], h[k] - ol[k], 1.0f / safe_den(dl[k]), enter, exit_, k == 0);
          merge(best, enter, exit_ >= enter && exit_ > 0.0f, code);
        } else {
          const float a2l = dl[0] * dl[0] + dl[1] * dl[1];
          // a2l itself wherever the quadric is used (a2l >= EPS there).
          capped_cylinder(ol[0] * dl[0] + ol[1] * dl[1], ol[0] * ol[0] + ol[1] * ol[1] - p.x * p.x,
                          a2l, 1.0f / fmaxf(a2l, kEps), -p.y - ol[2], p.y - ol[2],
                          1.0f / safe_den(dl[2]), best, code);
        }
        break;
      }
      default:
        break;
    }
  }
  return best;
}

__global__ void __launch_bounds__(kTileW * kTileH)
sweep_kernel(const float* __restrict__ cam, const float* __restrict__ poses,
             const int4* __restrict__ sched_i, const float4* __restrict__ sched_f,
             const float* __restrict__ radii, int n_sched, int n_prims, int height, int width,
             float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  Entry* s_ent = reinterpret_cast<Entry*>(smem);                // every row's terms
  float4* s_ball = reinterpret_cast<float4*>(s_ent + n_sched);  // centre - camera, R'
  short* s_list = reinterpret_cast<short*>(s_ball + n_sched);   // kept rows, per tile
  __shared__ float s_cam[16];
  __shared__ float s_ray[kTiles][5][3];  // per tile: the centre ray, the corner rays
  __shared__ float s_ang[kTiles][5];
  __shared__ float s_cone[kTiles][5];    // centre ray, cos and sin of the widened angle
  __shared__ int s_n[kTiles];

  const int b = blockIdx.z;
  const int tid = threadIdx.y * kTileW + threadIdx.x;
  const int c0 = blockIdx.x * kTileW;
  const int r0 = blockIdx.y * kTileH * kTiles;
  if (tid < 16) s_cam[tid] = cam[b * 16 + tid];
  if (tid < kTiles) s_n[tid] = 0;
  __syncthreads();

  // Every row's per-(frame, primitive) terms and bounding ball, once for
  // the block's kTiles tiles.
  const float camx = s_cam[13], camy = s_cam[14], camz = s_cam[15];
  for (int s = tid; s < n_sched; s += kTileW * kTileH) {
    const int4 si = sched_i[s];
    const float* ps = poses + ((size_t)b * n_prims + si.y) * 12;
    s_ent[s] = make_entry(si, sched_f[s], ps, camx, camy, camz);
    s_ball[s] = make_float4(ps[0] - camx, ps[1] - camy, ps[2] - camz,
                            si.x == OP_PLANE ? -1.0f : radii[s] * (1.0f + kCullRel));
  }
  // Each tile's cone, on 5 threads a tile at once: the centre ray and the
  // corner rays, then the corners' angles to the centre ray.
  const int t_cone = tid / 5, role = tid % 5;
  if (tid < 5 * kTiles) {
    const float rt0 = (float)(r0 + t_cone * kTileH);
    const float c1 = (float)min(c0 + kTileW - 1, width - 1);
    const float r1 = fminf(rt0 + (kTileH - 1), (float)(height - 1));
    pixel_ray(s_cam, role == 0 ? 0.5f * ((float)c0 + c1) : (role & 1 ? (float)c0 : c1),
              role == 0 ? 0.5f * (rt0 + r1) : (role & 2 ? rt0 : r1), s_ray[t_cone][role][0],
              s_ray[t_cone][role][1], s_ray[t_cone][role][2]);
  }
  __syncthreads();
  if (tid < 5 * kTiles && role > 0) {
    const float* ax = s_ray[t_cone][0];
    const float* v = s_ray[t_cone][role];
    s_ang[t_cone][role] = angle(ax[0], ax[1], ax[2], v[0], v[1], v[2]);
  }
  __syncthreads();
  if (tid < kTiles) {
    // Widened: (1 + kCullRel) alpha + kCullAbs; past pi / 2 keep every row.
    const float* ang = s_ang[tid];
    float alpha = fmaxf(fmaxf(ang[1], ang[2]), fmaxf(ang[3], ang[4]));
    alpha = alpha * (1.0f + kCullRel) + kCullAbs;
    s_cone[tid][0] = s_ray[tid][0][0];
    s_cone[tid][1] = s_ray[tid][0][1];
    s_cone[tid][2] = s_ray[tid][0][2];
    s_cone[tid][3] = alpha < 1.5707963f ? cosf(alpha) : -2.0f;
    s_cone[tid][4] = sinf(alpha);
  }
  __syncthreads();

  // A row is kept if its angle from the axis is within the widened cone
  // angle plus asin(R' / d): the cosine of the angle, a.v / d, at least
  // cos(alpha' + beta'), with sin(beta') = R' / d.
  for (int job = tid; job < kTiles * n_sched; job += kTileW * kTileH) {
    const int t = job / n_sched, s = job - t * n_sched;
    const float4 v = s_ball[s];
    const float rad = v.w;
    const float ca = s_cone[t][3], sa = s_cone[t][4];
    const float d2 = v.x * v.x + v.y * v.y + v.z * v.z;
    const float av = s_cone[t][0] * v.x + s_cone[t][1] * v.y + s_cone[t][2] * v.z;
    const bool keep = rad < 0.0f || ca < -1.0f || d2 <= rad * rad ||
                      av >= ca * sqrtf(d2 - rad * rad) - sa * rad;
    if (keep) s_list[t * n_sched + atomicAdd(&s_n[t], 1)] = (short)s;
  }
  __syncthreads();

  const int col = c0 + threadIdx.x;
  if (col >= width) return;
#pragma unroll 1
  for (int t = 0; t < kTiles; ++t) {
    const int row = r0 + t * kTileH + threadIdx.y;
    if (row >= height) break;
    float dx, dy, dz;
    pixel_ray(s_cam, (float)col, (float)row, dx, dy, dz);
    out[(size_t)b * height * width + (size_t)row * width + col] =
        walk(s_ent, s_list + t * n_sched, s_n[t], dx, dy, dz);
  }
}

}  // namespace
}  // namespace cspe

// cam (B, 16): B row-major 9 | cx cy fx fy | camera xyz. poses (B, P, 12).
// sched_i (S, 4) int32: op, prim row, code, swap. sched_f (S, 4) params.
// radii (S,) f32: each row's bounding radius (any value for the plane).
// out (B, H*W) packed f32. Returns kErrSharedMemory, launching nothing, if
// the rows and the kernel's static arrays exceed kSmemLimit (~370 rows).
CSPE_API int cspe_sweep(const float* cam, const float* poses, const int* sched_i,
                        const float* sched_f, const float* radii, int n_sched, int n_prims,
                        int batch, int height, int width, float* out, void* stream) {
  using namespace cspe;
  const dim3 block(kTileW, kTileH);
  const dim3 grid((width + kTileW - 1) / kTileW,
                  (height + kTileH * kTiles - 1) / (kTileH * kTiles), batch);
  const size_t smem = (size_t)n_sched * (sizeof(Entry) + sizeof(float4) + kTiles * sizeof(short));
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, sweep_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem + attr.sharedSizeBytes > kSmemLimit) return kErrSharedMemory;
  sweep_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      cam, poses, reinterpret_cast<const int4*>(sched_i),
      reinterpret_cast<const float4*>(sched_f), radii, n_sched, n_prims, height, width, out);
  return static_cast<int>(cudaGetLastError());
}

CSPE_API const char* cspe_error_string(int code) {
  if (code == cspe::kErrSharedMemory)
    return "the launch needs more shared memory than a block may take (48 KB)";
  if (code == cspe::kErrArgument)
    return "the entry point's arguments do not fit together";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
