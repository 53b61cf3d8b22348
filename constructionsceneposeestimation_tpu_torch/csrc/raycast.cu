// Analytic ray caster: every ray of a batch against every primitive of a
// table, in one of three modes.
//
// Replaces the JAX caster's jnp sweeps, which XLA fuses on the TPU (they
// are not Pallas kernels), in constructionsceneposeestimation_tpu/render/
// raycast.py: `_sweep_packed_fast` (:542, `cast.fast` :729, the keypoint
// segments of every render), `_sweep` and `_local_normal` (:180, :272,
// `cast` :692, the analytic-normal tier) and `_sweep_packed_multi` (:243,
// `cast_fast_multi_origin` :758, the sun-shadow rays). Plain versions, in
// render/raycast.py: packed_sweep, exact_sweep with Raycaster.plain_cast's
// normal, multi_sweep.
//
// Inputs: the caster's table, a row per primitive (op, primitive, code =
// instance + 2, x/y swap), the world's poses (prim_pos (B, P, 3), prim_rot
// (B, P, 3, 3)) and parameters (P, 4), and for the packed walk's axial
// capsules each (frame, row)'s c_2 . (ray_o - p) and |ray_o - p|^2 from
// render/raycast.axis_sums (sums over three elements, whose order is
// PyTorch's). A block's prologue gathers each row's terms (Slot) from them.
//
// Modes:
// - MODE_PACKED, rays from one origin a frame (ray_o (B, 3)): each row's
//   formula of its transform category (the shared per-ray reciprocals of
//   the transform-free rows, the fence slabs, yaw boxes, capsules by their
//   axis, the generic local frame), and the min of pack(t, code), INF =
//   1e10 (never IEEE inf) on a miss: (B, N) packed f32.
// - MODE_EXACT, the same rays: each row's generic formula in its local
//   frame, the least t with a strict `<` in the table's order (the first
//   row wins a tie, which is argmin's first index within a kind group and
//   the strict `<` across groups), then the winner's local normal, flipped
//   against the local ray, in world axes: t (+inf on a miss), prim (int64,
//   -1), inst (-2) and normal (0 on a miss), as Raycaster.cast returns them.
// - MODE_MULTI, a per-ray origin (ray_o (B, N, 3)): the generic formulas
//   with each ray's own local origin, and the packed min.
//
// Rounding: every value is bit-equal to the plain version's on the card.
// Each operation is an uncontracted IEEE one (__fmul_rn, __fadd_rn,
// __fsub_rn, __fdiv_rn, __fsqrt_rn; nvcc would otherwise contract a*b + c
// into an FMA) in the plain version's order: dots as (a0 b0 + a1 b1) + a2
// b2, 1.0 / x as a correctly rounded reciprocal, clamp_min and minimum as
// fmaxf and fminf in PyTorch's argument order. The per-(frame, primitive)
// reductions of three elements (the capsule's axis . (ray_o - p) and
// |ray_o - p|^2) come from PyTorch, shared by both versions. The
// normal's norms and its flip test are PyTorch's `torch.sum` over three
// elements on the card: its reduction kernel gives a row of three two
// threads (ReduceConfig: block width = last_pow2(3)), one summing
// elements 0 and 2 and the other element 1, then one shuffle, so
// (x0 + x2) + x1; the epilogue sums in that order. The directions need not
// be unit length (the segments run from the camera to each keypoint), so
// no formula assumes |d| == 1.
//
// What bounds it on an H100: FP32 operations. The work the function
// needs is each (ray, row) pair whose ray meets the row's bounding sphere
// (the ground plane always) at its formula's cost (20 to 110 operations,
// IEEE divides and square roots among them), a packed ray's own terms and
// an exact hit's normal; the bytes are the rays in (12 bytes, 24 with an
// origin), the outputs (4 bytes a packed ray, 28 an exact one) and the
// world. A ray meets 1.4 to 4.6 of the default roster's 76 rows, so a walk
// over every row spends nearly all its operations on pairs that miss.
//
// Design: a warp-level bundle cull before each walk.
// - Blocks. A CUDA block of 256 threads owns ranges of one frame's rays
//   (grid: ray ranges x frames, enough ranges to put ~16 blocks on each
//   SM); its prologue gathers the frame's terms and the table (128 bytes a
//   row, ~10 KB for 76 rows) into shared memory, each row's widened
//   bounding radius R' = (1 + kCullRel) R among them (-1 for the plane).
// - Bundles. Each warp takes 32 consecutive rays of the frame. The callers
//   pass coherent runs: a pixel row's 32-pixel strip, the shadow rays of
//   those pixels' hits along one sun direction, keypoint segments instance
//   by instance. With shuffles the warp builds a cone: its apex (the
//   camera, or in MODE_MULTI the mean of the lanes' origins with r_o the
//   largest distance of an origin from it, widened by kCullRel), its axis
//   (the normalised sum of the lanes' unit directions) and its half-angle
//   alpha (the largest angle from the axis), widened as csrc/sweep.cu
//   widens a tile's: (1 + kCullRel) alpha + kCullAbs. A half-line from an
//   origin that meets a ball of radius R' is, moved to the apex, a
//   half-line of the cone that meets the ball of radius R' + r_o about the
//   same centre. A warp keeps every row if the angle reaches pi / 2, or if
//   a lane's direction is zero or not finite, or its origin not finite.
// - Cull. The rows go to the lanes 32 at a time; a lane keeps its row if
//   it is the plane, if the apex lies within R' + r_o of its centre, or if
//   that ball meets the cone (csrc/sweep.cu's test, without
//   transcendentals). One __ballot_sync gives the warp's word of kept rows,
//   which stays in a register (warp-uniform) while the warp walks its set
//   bits in ascending row order, then the next 32 rows: no bitmask array,
//   in registers or in shared memory.
// - Walk. Every lane walks the warp's kept rows, so the switch on the
//   row's op stays uniform and its terms are a broadcast; the table's
//   order is kept, so the exact walk's strict `<` still picks the first
//   row on a tie.
// - Bit-equality. A culled row can only miss: its pair's value in the
//   plain walk is pack(INF, code) (t = INF in MODE_EXACT, which never wins
//   the strict `<`). The packed modes fold each word's culled rows'
//   pack(INF, code) in with one __reduce_min_sync, so the packed min is the
//   plain walk's whatever the cull drops. render/raycast.bundle_cull_plain
//   mirrors the cull on tensors; the walks' plain versions stay brute
//   force.
// MODE_EXACT takes an optional excluded instance a ray (exclude (B, N),
// render/raycast.occlusion_ts): a row of that instance counts as a miss.
// An optional output `kept` receives each warp's words of kept rows.
#include "common.cuh"

namespace cspe {
namespace {

// render/raycast.OP_* (a kind's own number: its generic formula).
enum Op : int {
  OP_PLANE = 0,
  OP_SPHERE = 1,
  OP_BOX = 2,
  OP_CYLINDER = 3,
  OP_CONE = 4,
  OP_CAPSULE = 5,
  OP_INV_PLANE = 8,
  OP_INV_SPHERE = 9,
  OP_INV_CYLINDER = 10,
  OP_INV_CONE = 11,
  OP_AA_BOX = 12,
  OP_YAW_BOX = 13,
  OP_AXIS_CAPSULE = 14,
};

// render/raycast.MODE_*.
enum Mode : int { MODE_PACKED = 0, MODE_EXACT = 1, MODE_MULTI = 2 };

// A row's terms in shared memory, a float4 each: the rotation columns c_i
// = R[:, i], each with the local origin o_i = c_i . (ray_o - p) in .w (0
// with per-ray origins); the parameters; ray_o - p with the capsule's
// c_2 . (ray_o - p); p with |ray_o - p|^2; the yaw box's local origin x, y
// with the widened bounding radius R' in .z.
enum Slot : int { kCol0 = 0, kCol1, kCol2, kParams, kRel, kPos, kYaw, kSlots };
constexpr int kThreads = 256;
constexpr int kFillBlocks = 132 * 16;  // blocks a launch aims for on the H100
constexpr unsigned kFull = 0xffffffffu;
constexpr float kCullRel = 1e-3f;    // render/raycast.CULL_REL (csrc/sweep.cu's)
constexpr float kCullAbs = 1e-6f;    // render/raycast.CULL_ABS
constexpr float kHalfPi = 1.5707963f;

struct V3 {
  float x, y, z;
};

// Uncontracted IEEE operations.
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float quo(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float recip(float a) { return __fdiv_rn(1.0f, a); }
// sqrt(clamp_min(a, 0)).
__device__ __forceinline__ float root(float a) { return __fsqrt_rn(fmaxf(a, 0.0f)); }
__device__ __forceinline__ float dot2(float a0, float a1, float b0, float b1) {
  return add(mul(a0, b0), mul(a1, b1));
}
__device__ __forceinline__ float dot3(float a0, float a1, float a2, float b0, float b1,
                                      float b2) {
  return add(add(mul(a0, b0), mul(a1, b1)), mul(a2, b2));
}
__device__ __forceinline__ float dot3(V3 a, V3 b) { return dot3(a.x, a.y, a.z, b.x, b.y, b.z); }
// c_i . v for the float4 (c_i, o_i) of a row's terms.
__device__ __forceinline__ float dot3(float4 c, V3 v) { return dot3(c.x, c.y, c.z, v.x, v.y, v.z); }
// torch.sum over three elements on the card: (x0 + x2) + x1.
__device__ __forceinline__ float sum3(float x0, float x1, float x2) { return add(add(x0, x2), x1); }
// render/raycast._valid_t.
__device__ __forceinline__ float valid(float t, bool cond) { return cond && t > kEps ? t : kInf; }
__device__ __forceinline__ float sgn(float x) { return (float)((0.0f < x) - (x < 0.0f)); }
__device__ __forceinline__ float pack(float t, int code) {
  return __int_as_float((__float_as_int(t) & ~kPayloadMask) | code);
}

// --- the warp's bundle and its cull (render/raycast.bundle_cull_plain)

// A warp's cone: apex, unit axis, cos and sin of the widened half-angle,
// the origins' spread r_o; `all` keeps every row. The butterfly sums and
// maxima give every lane the same bits.
struct Bundle {
  V3 apex, axis;
  float ca, sa, r_o;
  bool all;
};

template <int kMode>
__device__ __forceinline__ Bundle make_bundle(bool active, V3 o, V3 d) {
  Bundle c;
  const float dd = d.x * d.x + d.y * d.y + d.z * d.z;
  const float nd = sqrtf(dd);
  const bool origin_ok =
      kMode != MODE_MULTI || (isfinite(o.x) && isfinite(o.y) && isfinite(o.z));
  const bool bad = active && !(dd > 0.0f && isfinite(nd) && origin_ok);
  const bool use = active && !bad;
  const V3 u = use ? V3{d.x / nd, d.y / nd, d.z / nd} : V3{0.0f, 0.0f, 0.0f};
  const V3 s = {warp_sum(u.x), warp_sum(u.y), warp_sum(u.z)};
  const float ns = sqrtf(s.x * s.x + s.y * s.y + s.z * s.z);
  c.axis = {s.x / ns, s.y / ns, s.z / ns};
  // The angle from the axis, accurate at small angles (csrc/sweep.cu's).
  const float cx = c.axis.y * u.z - c.axis.z * u.y;
  const float cy = c.axis.z * u.x - c.axis.x * u.z;
  const float cz = c.axis.x * u.y - c.axis.y * u.x;
  const float ang = use ? atan2f(sqrtf(cx * cx + cy * cy + cz * cz),
                                 c.axis.x * u.x + c.axis.y * u.y + c.axis.z * u.z)
                        : 0.0f;
  const float alpha = warp_max(ang) * (1.0f + kCullRel) + kCullAbs;
  c.r_o = 0.0f;
  c.apex = o;
  if (kMode == MODE_MULTI) {
    const float n = (float)__popc(__ballot_sync(kFull, use));
    c.apex = {warp_sum(use ? o.x : 0.0f) / n, warp_sum(use ? o.y : 0.0f) / n,
              warp_sum(use ? o.z : 0.0f) / n};
    const V3 e = {o.x - c.apex.x, o.y - c.apex.y, o.z - c.apex.z};
    c.r_o = warp_max(use ? sqrtf(e.x * e.x + e.y * e.y + e.z * e.z) : 0.0f) * (1.0f + kCullRel);
  }
  c.all = __any_sync(kFull, bad) || !(ns > 0.0f) || !(alpha < kHalfPi) || !isfinite(c.r_o);
  c.ca = cosf(alpha);
  c.sa = sinf(alpha);
  return c;
}

// Whether the bundle keeps the row of terms T: the plane always; else the
// ball of radius R' + r_o about its centre p holding the apex, or meeting
// the cone: the angle from the axis to v = p - apex within alpha' +
// asin(R / |v|), as a.v >= cos(alpha') sqrt(|v|^2 - R^2) - sin(alpha') R.
template <int kMode>
__device__ __forceinline__ bool keeps(const Bundle& c, const float4* T) {
  const float rad = T[kYaw].z;
  if (c.all || rad < 0.0f) return true;
  const V3 v = kMode != MODE_MULTI
                   ? V3{-T[kRel].x, -T[kRel].y, -T[kRel].z}  // p - camera
                   : V3{T[kPos].x - c.apex.x, T[kPos].y - c.apex.y, T[kPos].z - c.apex.z};
  const float r = rad + c.r_o;
  const float d2 = v.x * v.x + v.y * v.y + v.z * v.z;
  const float av = c.axis.x * v.x + c.axis.y * v.y + c.axis.z * v.z;
  return d2 <= r * r || av >= c.ca * sqrtf(d2 - r * r) - c.sa * r;
}

// --- generic formulas in the primitive's local frame (render/raycast._KIND_FNS)

__device__ __forceinline__ float plane_t(V3 o, V3 d) {
  return valid(quo(-o.z, safe_den(d.z)), fabsf(d.z) >= kEps);
}

__device__ __forceinline__ float sphere_t(V3 o, V3 d, float4 p) {
  const float a = dot3(d, d);
  const float b = dot3(o, d);
  const float c = sub(dot3(o, o), mul(p.x, p.x));
  const float a_safe = fmaxf(a, kEps);
  const float disc = sub(mul(b, b), mul(a_safe, c));
  return valid(quo(sub(-b, root(disc)), a_safe), disc > 0.0f);
}

__device__ __forceinline__ float box_t(V3 o, V3 d, float4 p) {
  const float h[3] = {p.x, p.y, p.z};
  const float oo[3] = {o.x, o.y, o.z};
  const float dd[3] = {d.x, d.y, d.z};
  float tmin = 0.0f, tmax = 0.0f;
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    const float inv = recip(safe_den(dd[ax]));
    const float t1 = mul(sub(-h[ax], oo[ax]), inv);
    const float t2 = mul(sub(h[ax], oo[ax]), inv);
    const float lo = fminf(t1, t2);
    const float hi = fmaxf(t1, t2);
    tmin = ax == 0 ? fmaxf(lo, -kInf) : fmaxf(tmin, lo);
    tmax = ax == 0 ? fminf(hi, kInf) : fminf(tmax, hi);
  }
  return valid(tmin, tmax >= tmin && tmax > 0.0f);
}

// The two caps of an upright cylinder or cone at z = -hh, +hh (radii r_lo,
// r_hi), folded into t_best; t_c = num x rdz with a shared reciprocal, or
// num / safe(dz).
template <bool kShared>
__device__ __forceinline__ float caps(float t_best, V3 o, V3 d, float hh, float r_lo, float r_hi,
                                      float rdz) {
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float num = sub(k ? hh : -hh, o.z);
    const float t_c = kShared ? mul(num, rdz) : quo(num, safe_den(d.z));
    const float x = add(o.x, mul(t_c, d.x));
    const float y = add(o.y, mul(t_c, d.y));
    const float rr = k ? r_hi : r_lo;
    t_best = fminf(t_best, valid(t_c, add(mul(x, x), mul(y, y)) <= mul(rr, rr)));
  }
  return t_best;
}

__device__ __forceinline__ float cylinder_t(V3 o, V3 d, float4 p) {
  const float r = p.x, hh = p.y;
  const float a = dot2(d.x, d.y, d.x, d.y);
  const float b = dot2(o.x, o.y, d.x, d.y);
  const float c = sub(dot2(o.x, o.y, o.x, o.y), mul(r, r));
  const float a_safe = a < kEps ? kEps : a;
  const float disc = sub(mul(b, b), mul(a_safe, c));
  const float t_side = quo(sub(-b, root(disc)), a_safe);
  const float z_side = add(o.z, mul(t_side, d.z));
  const float t = valid(t_side, disc > 0.0f && fabsf(z_side) <= hh && a >= kEps);
  return caps<false>(t, o, d, hh, r, r, 0.0f);
}

// Upright cone frustum with caps; kShared: the transform-free category's
// shared reciprocal of dz and |d_xy|^2 (render/raycast._cone_t's rdz, a2).
template <bool kShared>
__device__ __forceinline__ float cone_t(V3 o, V3 d, float4 p, float rdz, float a2) {
  const float rb = p.x, rt = p.y, hh = p.z;
  const float k = quo(sub(rt, rb), mul(2.0f, hh));
  const float q = add(rb, mul(k, add(o.z, hh)));
  const float m = mul(k, d.z);
  const float a = sub(kShared ? a2 : dot2(d.x, d.y, d.x, d.y), mul(m, m));
  const float b = sub(dot2(o.x, o.y, d.x, d.y), mul(q, m));
  const float c = sub(dot2(o.x, o.y, o.x, o.y), mul(q, q));
  const float a_safe = safe_den(a);
  const float disc = sub(mul(b, b), mul(a_safe, c));
  const float sq = root(disc);
  float t1, t2;
  if (kShared) {
    const float ra = recip(a_safe);
    t1 = mul(sub(-b, sq), ra);
    t2 = mul(add(-b, sq), ra);
  } else {
    t1 = quo(sub(-b, sq), a_safe);
    t2 = quo(add(-b, sq), a_safe);
  }
  const float t_lo = fminf(t1, t2);
  const float t_hi = fmaxf(t1, t2);
  const bool ok_lo = disc > 0.0f && fabsf(add(o.z, mul(t_lo, d.z))) <= hh &&
                     add(q, mul(m, t_lo)) > 0.0f;
  const bool ok_hi = disc > 0.0f && fabsf(add(o.z, mul(t_hi, d.z))) <= hh &&
                     add(q, mul(m, t_hi)) > 0.0f;
  const float t_side = ok_lo ? t_lo : (ok_hi ? t_hi : kInf);
  return caps<kShared>(t_side > kEps ? t_side : kInf, o, d, hh, rb, rt, rdz);
}

// Side tube + two end balls.
__device__ __forceinline__ float capsule_t(V3 o, V3 d, float4 p) {
  const float r = p.x, hh = p.y;
  const float a2 = dot2(d.x, d.y, d.x, d.y);
  const float b2 = dot2(o.x, o.y, d.x, d.y);
  const float c2 = sub(dot2(o.x, o.y, o.x, o.y), mul(r, r));
  const float a2_safe = a2 < kEps ? kEps : a2;
  const float disc2 = sub(mul(b2, b2), mul(a2_safe, c2));
  const float t_side = quo(sub(-b2, root(disc2)), a2_safe);
  const float z_side = add(o.z, mul(t_side, d.z));
  float t = valid(t_side, disc2 > 0.0f && fabsf(z_side) <= hh && a2 >= kEps);
  const float a_safe = fmaxf(add(a2, mul(d.z, d.z)), kEps);
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float ocz = sub(o.z, k ? hh : -hh);
    const float bb = add(b2, mul(ocz, d.z));
    const float cc = add(c2, mul(ocz, ocz));
    const float disc = sub(mul(bb, bb), mul(a_safe, cc));
    t = fminf(t, valid(quo(sub(-bb, root(disc)), a_safe), disc > 0.0f));
  }
  return t;
}

__device__ __forceinline__ float generic_t(int op, V3 o, V3 d, float4 p) {
  switch (op) {
    case OP_PLANE:
      return plane_t(o, d);
    case OP_SPHERE:
      return sphere_t(o, d, p);
    case OP_BOX:
      return box_t(o, d, p);
    case OP_CYLINDER:
      return cylinder_t(o, d, p);
    case OP_CONE:
      return cone_t<false>(o, d, p, 0.0f, 0.0f);
    case OP_CAPSULE:
      return capsule_t(o, d, p);
    default:
      return kInf;
  }
}

// A row's shared-origin local origin and the local direction of d.
__device__ __forceinline__ V3 local_origin(const float4* T) {
  return {T[kCol0].w, T[kCol1].w, T[kCol2].w};
}
__device__ __forceinline__ V3 local_dir(const float4* T, V3 d) {
  return {dot3(T[kCol0], d), dot3(T[kCol1], d), dot3(T[kCol2], d)};
}

// --- the packed walk's per-ray terms and its category formulas
// (render/raycast.packed_sweep)

struct RayTerms {
  float rinv[3];  // 1 / safe(d_i)
  float a2, a3;   // |d_xy|^2, |d|^2
  float ra2, ra3;  // 1 / clamp_min(a2, EPS), 1 / clamp_min(a3, EPS)
  float rod;      // ray_o . d
  bool dz_ok;     // |d_z| >= EPS
};

__device__ __forceinline__ RayTerms ray_terms(V3 cam, V3 d) {
  RayTerms r;
  r.rinv[0] = recip(safe_den(d.x));
  r.rinv[1] = recip(safe_den(d.y));
  r.rinv[2] = recip(safe_den(d.z));
  r.a2 = dot2(d.x, d.y, d.x, d.y);
  r.a3 = add(r.a2, mul(d.z, d.z));
  r.ra2 = recip(fmaxf(r.a2, kEps));
  r.ra3 = recip(fmaxf(r.a3, kEps));
  r.rod = dot3(cam, d);
  r.dz_ok = fabsf(d.z) >= kEps;
  return r;
}

__device__ __forceinline__ float packed_row(int op, int swap, const float4* T, V3 d,
                                            const RayTerms& rt) {
  const float4 p = T[kParams];
  const V3 rel = {T[kRel].x, T[kRel].y, T[kRel].z};  // ray_o - p
  switch (op) {
    case OP_INV_PLANE:
      return valid(mul(-rel.z, rt.rinv[2]), rt.dz_ok);
    case OP_INV_SPHERE: {
      const float b = dot3(rel, d);
      const float c = sub(dot3(rel, rel), mul(p.x, p.x));
      const float disc = sub(mul(b, b), mul(fmaxf(rt.a3, kEps), c));
      return valid(mul(sub(-b, root(disc)), rt.ra3), disc > 0.0f);
    }
    case OP_INV_CYLINDER: {
      const float r = p.x, hh = p.y;
      const float b = dot2(rel.x, rel.y, d.x, d.y);
      const float c = sub(dot2(rel.x, rel.y, rel.x, rel.y), mul(r, r));
      const float disc = sub(mul(b, b), mul(fmaxf(rt.a2, kEps), c));
      const float t_side = mul(sub(-b, root(disc)), rt.ra2);
      const float z_side = add(rel.z, mul(t_side, d.z));
      const float t = valid(t_side, disc > 0.0f && fabsf(z_side) <= hh && rt.a2 >= kEps);
      return caps<true>(t, rel, d, hh, r, r, rt.rinv[2]);
    }
    case OP_INV_CONE:
      return cone_t<true>(rel, d, p, rt.rinv[2], rt.a2);
    case OP_AA_BOX: {  // static fence panel: world axes, x/y swapped if swap
      const float r[3] = {rel.x, rel.y, rel.z};
      const float h[3] = {p.x, p.y, p.z};
      float tmin = 0.0f, tmax = 0.0f;
#pragma unroll
      for (int la = 0; la < 3; ++la) {
        const int wa = la == 2 ? 2 : (swap ? 1 - la : la);
        const float t1 = mul(sub(-h[la], r[wa]), rt.rinv[wa]);
        const float t2 = mul(sub(h[la], r[wa]), rt.rinv[wa]);
        const float lo = fminf(t1, t2);
        const float hi = fmaxf(t1, t2);
        tmin = la == 0 ? lo : fmaxf(tmin, lo);
        tmax = la == 0 ? hi : fminf(tmax, hi);
      }
      return valid(tmin, tmax >= tmin && tmax > 0.0f);
    }
    case OP_YAW_BOX: {  // identity-local box on a yaw-only instance
      const float c = T[kCol0].x, s = T[kCol0].y;  // R[0][0], R[1][0]: cos, sin of the yaw
      const V3 o = {T[kYaw].x, T[kYaw].y, rel.z};
      const V3 dl = {add(mul(c, d.x), mul(s, d.y)), add(mul(-s, d.x), mul(c, d.y)), d.z};
      return box_t(o, dl, p);
    }
    case OP_AXIS_CAPSULE: {  // any orientation: axial/radial decomposition
      const float4 ax = T[kCol2];  // c_2, the capsule axis
      const float4 pos = T[kPos];
      const float r = p.x, hh = p.y, oz = T[kRel].w, oo = pos.w;
      const float dz = dot3(ax, d);
      const float od = sub(rt.rod, dot3(pos.x, pos.y, pos.z, d.x, d.y, d.z));
      const float a2 = sub(rt.a3, mul(dz, dz));
      const float b2 = sub(od, mul(oz, dz));
      const float c2 = sub(sub(oo, mul(oz, oz)), mul(r, r));
      const float a2_safe = a2 < kEps ? kEps : a2;
      const float disc2 = sub(mul(b2, b2), mul(a2_safe, c2));
      const float t_side = quo(sub(-b2, root(disc2)), a2_safe);
      const float z_side = add(oz, mul(t_side, dz));
      float t = valid(t_side, disc2 > 0.0f && fabsf(z_side) <= hh && a2 >= kEps);
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const float bs = sub(od, mul(k ? hh : -hh, dz));
        const float cs =
            sub(add(sub(oo, mul(mul(k ? 2.0f : -2.0f, hh), oz)), mul(hh, hh)), mul(r, r));
        const float disc = sub(mul(bs, bs), mul(rt.a3, cs));
        t = fminf(t, valid(mul(sub(-bs, root(disc)), rt.ra3), disc > 0.0f));
      }
      return t;
    }
    default:  // the generic local frame ("gen")
      return generic_t(op, local_origin(T), local_dir(T, d), p);
  }
}

// --- the exact epilogue (render/raycast._local_normal, then world axes)

__device__ __forceinline__ float norm3(float x0, float x1, float x2) {
  return __fsqrt_rn(sum3(mul(x0, x0), mul(x1, x1), mul(x2, x2)));
}

__device__ __forceinline__ V3 scaled(V3 v, float den) {
  return {quo(v.x, den), quo(v.y, den), quo(v.z, den)};
}

__device__ V3 local_normal(int kind, V3 p, V3 dl, float4 prm) {
  const V3 cap = {0.0f, 0.0f, sgn(p.z)};
  // (p_x, p_y, 0) normalised.
  const float rden = fmaxf(norm3(p.x, p.y, 0.0f), kEps);
  const V3 radial = {quo(p.x, rden), quo(p.y, rden), quo(0.0f, rden)};
  V3 n;
  switch (kind) {
    case OP_PLANE:
      n = {0.0f, 0.0f, 1.0f};
      break;
    case OP_SPHERE:
      n = scaled(p, fmaxf(norm3(p.x, p.y, p.z), kEps));
      break;
    case OP_BOX: {
      const float r0 = quo(p.x, fmaxf(prm.x, kEps));
      const float r1 = quo(p.y, fmaxf(prm.y, kEps));
      const float r2 = quo(p.z, fmaxf(prm.z, kEps));
      int ax = 0;  // argmax |rel|, the first index on a tie
      float big = fabsf(r0);
      if (fabsf(r1) > big) {
        ax = 1;
        big = fabsf(r1);
      }
      if (fabsf(r2) > big) ax = 2;
      const float s = sgn(ax == 0 ? r0 : (ax == 1 ? r1 : r2));
      n = {mul(ax == 0 ? 1.0f : 0.0f, s), mul(ax == 1 ? 1.0f : 0.0f, s),
           mul(ax == 2 ? 1.0f : 0.0f, s)};
      break;
    }
    case OP_CYLINDER:
      n = fabsf(p.z) < sub(prm.y, 1e-4f) ? radial : cap;
      break;
    case OP_CONE: {
      const float kslope = quo(sub(prm.y, prm.x), mul(2.0f, fmaxf(prm.z, kEps)));
      const V3 side = {radial.x, radial.y, -kslope};
      const bool on_cap = fabsf(sub(fabsf(p.z), prm.z)) < 1e-4f;
      n = on_cap ? cap : scaled(side, fmaxf(norm3(side.x, side.y, side.z), kEps));
      break;
    }
    default: {  // capsule
      const float hh = prm.y;
      const float seg_z = fminf(fmaxf(p.z, -hh), hh);
      const V3 v = {sub(p.x, 0.0f), sub(p.y, 0.0f), sub(p.z, seg_z)};
      n = scaled(v, fmaxf(norm3(v.x, v.y, v.z), kEps));
      break;
    }
  }
  const bool flip = sum3(mul(n.x, dl.x), mul(n.y, dl.y), mul(n.z, dl.z)) > 0.0f;
  return flip ? V3{-n.x, -n.y, -n.z} : n;
}

// The terms of row `row` of frame b (Slot) from the world's pose of its
// primitive, in render/raycast's plain operations: ray_o - p, c_i . (ray_o
// - p) as (R[0][i] r_0 + R[1][i] r_1) + R[2][i] r_2, the yaw box's (c r_0 +
// s r_1, -s r_0 + c r_1); `sums` (or zeros) the axial capsule's; the
// widened bounding radius.
template <int kMode>
__device__ __forceinline__ void gather_terms(float4* T, int4 row, float radius,
                                             const float* prim_pos, const float* prim_rot,
                                             const float* params, const float* sums, V3 cam) {
  const float* R = prim_rot + (size_t)row.y * 9;  // row-major: R[j][i] = R[3 j + i]
  const V3 pos = {prim_pos[3 * row.y], prim_pos[3 * row.y + 1], prim_pos[3 * row.y + 2]};
  V3 rel = {0.0f, 0.0f, 0.0f};
  if (kMode != MODE_MULTI) rel = {sub(cam.x, pos.x), sub(cam.y, pos.y), sub(cam.z, pos.z)};
#pragma unroll
  for (int i = 0; i < 3; ++i)
    T[kCol0 + i] = {R[i], R[3 + i], R[6 + i],
                    kMode != MODE_MULTI ? dot3(R[i], R[3 + i], R[6 + i], rel.x, rel.y, rel.z)
                                        : 0.0f};
  const float* prm = params + 4 * row.y;
  T[kParams] = {prm[0], prm[1], prm[2], prm[3]};
  T[kRel] = {rel.x, rel.y, rel.z, sums ? sums[0] : 0.0f};
  T[kPos] = {pos.x, pos.y, pos.z, sums ? sums[1] : 0.0f};
  const float c = R[0], s = R[3];
  T[kYaw] = {add(mul(c, rel.x), mul(s, rel.y)), add(mul(-s, rel.x), mul(c, rel.y)),
             radius < 0.0f ? -1.0f : radius * (1.0f + kCullRel), 0.0f};
}

template <int kMode>
__global__ void __launch_bounds__(kThreads)
raycast_kernel(const int4* __restrict__ rows, const float* __restrict__ radii,
               const float* __restrict__ prim_pos, const float* __restrict__ prim_rot,
               const float* __restrict__ params, const float* __restrict__ sums,
               const float* __restrict__ ray_o, const float* __restrict__ ray_d,
               const int* __restrict__ exclude, int n_rows, int n_prims, int n_rays,
               float* __restrict__ out, long long* __restrict__ prim_out,
               int* __restrict__ inst_out, float* __restrict__ normal_out,
               int* __restrict__ kept) {
  extern __shared__ float4 s_terms[];  // n_rows x kSlots
  int4* s_rows = reinterpret_cast<int4*>(s_terms + n_rows * kSlots);
  const int b = blockIdx.y;
  V3 cam = {0.0f, 0.0f, 0.0f};
  if (kMode != MODE_MULTI) cam = {ray_o[3 * b], ray_o[3 * b + 1], ray_o[3 * b + 2]};
  for (int i = threadIdx.x; i < n_rows; i += kThreads) {
    const int4 row = rows[i];
    s_rows[i] = row;
    gather_terms<kMode>(s_terms + i * kSlots, row, radii[i], prim_pos + (size_t)b * n_prims * 3,
                        prim_rot + (size_t)b * n_prims * 9, params,
                        sums ? sums + ((size_t)b * n_rows + i) * 2 : nullptr, cam);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int n_words = (n_rows + 31) >> 5;
  const int n_warps = (n_rays + 31) >> 5;
  const int inf_bits = __float_as_int(kInf);
#pragma unroll 1
  for (int base = blockIdx.x * kThreads + (threadIdx.x & ~31); base < n_rays;
       base += gridDim.x * kThreads) {
    const bool active = base + lane < n_rays;
    const size_t r = (size_t)b * n_rays + (active ? base + lane : base);
    const V3 d = {ray_d[3 * r], ray_d[3 * r + 1], ray_d[3 * r + 2]};
    const V3 ow = kMode == MODE_MULTI ? V3{ray_o[3 * r], ray_o[3 * r + 1], ray_o[3 * r + 2]} : cam;
    const Bundle bundle = make_bundle<kMode>(active, ow, d);
    RayTerms rt;
    if (kMode == MODE_PACKED) rt = ray_terms(cam, d);
    const int ex = kMode == MODE_EXACT && exclude ? exclude[r] : -3;  // -3: no instance
    float best = kInf;
    int win = -1;
#pragma unroll 1
    for (int w = 0; w < n_words; ++w) {
      const int mine = (w << 5) + lane;
      const bool keep = mine < n_rows && keeps<kMode>(bundle, s_terms + mine * kSlots);
      unsigned m = __ballot_sync(kFull, keep);
      if (kept != nullptr && lane == 0) kept[((size_t)b * n_warps + (base >> 5)) * n_words + w] = m;
      if (kMode != MODE_EXACT) {
        // The culled rows' misses, pack(INF, code), as the plain walk has them.
        const int miss = mine < n_rows && !keep ? __float_as_int(pack(kInf, s_rows[mine].z))
                                                : inf_bits;
        best = fminf(best, __int_as_float(__reduce_min_sync(kFull, miss)));
      }
#pragma unroll 1
      while (m != 0) {
        const int s = (w << 5) + __ffs(m) - 1;
        m &= m - 1;
        const int4 row = s_rows[s];
        const float4* T = s_terms + s * kSlots;
        if (kMode == MODE_PACKED) {
          best = fminf(best, pack(packed_row(row.x, row.w, T, d, rt), row.z));
        } else if (kMode == MODE_MULTI) {
          const V3 rel = {sub(ow.x, T[kPos].x), sub(ow.y, T[kPos].y), sub(ow.z, T[kPos].z)};
          const V3 o = {dot3(T[kCol0], rel), dot3(T[kCol1], rel), dot3(T[kCol2], rel)};
          best = fminf(best, pack(generic_t(row.x, o, local_dir(T, d), T[kParams]), row.z));
        } else {
          const float t = generic_t(row.x, local_origin(T), local_dir(T, d), T[kParams]);
          if (t < best && row.z - 2 != ex) {
            best = t;
            win = s;
          }
        }
      }
    }
    if (!active) continue;  // the last range's idle lanes; the warp's last iteration
    if (kMode != MODE_EXACT) {
      out[r] = best;
      continue;
    }
    V3 nw = {0.0f, 0.0f, 0.0f};
    if (win >= 0) {
      const int4 row = s_rows[win];
      const float4* T = s_terms + win * kSlots;
      const V3 ol = local_origin(T);
      const V3 dl = local_dir(T, d);
      const V3 p = {add(ol.x, mul(best, dl.x)), add(ol.y, mul(best, dl.y)),
                    add(ol.z, mul(best, dl.z))};
      const V3 nl = local_normal(row.x, p, dl, T[kParams]);
      // World axes: normal_j = (R[j][0] n_0 + R[j][1] n_1) + R[j][2] n_2.
      const float4 c0 = T[kCol0], c1 = T[kCol1], c2 = T[kCol2];
      nw = {dot3(c0.x, c1.x, c2.x, nl.x, nl.y, nl.z), dot3(c0.y, c1.y, c2.y, nl.x, nl.y, nl.z),
            dot3(c0.z, c1.z, c2.z, nl.x, nl.y, nl.z)};
      prim_out[r] = row.y;
      inst_out[r] = row.z - 2;
      out[r] = best;
    } else {
      prim_out[r] = -1;
      inst_out[r] = -2;
      out[r] = __int_as_float(0x7f800000);  // +inf
    }
    normal_out[3 * r] = nw.x;
    normal_out[3 * r + 1] = nw.y;
    normal_out[3 * r + 2] = nw.z;
  }
}

}  // namespace
}  // namespace cspe

// rows (S, 4) int32: op, primitive, code, swap; radii (S,) f32: each row's
// bounding radius about its primitive's position (render/raycast.row_radii,
// < 0 for the plane). prim_pos (B, P, 3), prim_rot (B, P, 3, 3), params (P,
// 4) f32: the world. sums (B, S, 2) f32 (render/raycast.axis_sums), or null
// where the table has no axial capsule; MODE_PACKED only. ray_o (B, 3), or
// (B, N, 3) in MODE_MULTI; ray_d (B, N, 3). exclude (B, N) int32, an
// instance a ray whose rows count as misses, or null; MODE_EXACT only. out
// (B, N) f32: packed in MODE_PACKED and MODE_MULTI, t in MODE_EXACT, which
// also writes prim (B, N) int64, inst (B, N) int32 and normal (B, N, 3) f32
// (null in the other modes). kept (B, ceil(N / 32), ceil(S / 32)) int32, or
// null: each warp's words of kept rows, bit s % 32 of word s / 32 for row
// s. Returns kErrSharedMemory, launching nothing, if the rows exceed
// kSmemLimit (~380 rows), and kErrArgument for an unknown mode, no radii,
// or outputs, sums or exclusions that do not match it.
CSPE_API int cspe_raycast(int mode, const int* rows, const float* radii, const float* prim_pos,
                          const float* prim_rot, const float* params, const float* sums,
                          const float* ray_o, const float* ray_d, const int* exclude, int n_rows,
                          int n_prims, int batch, int n_rays, float* out, long long* prim,
                          int* inst, float* normal, int* kept, void* stream) {
  using namespace cspe;
  const bool exact_outputs = prim != nullptr && inst != nullptr && normal != nullptr;
  const bool no_outputs = prim == nullptr && inst == nullptr && normal == nullptr;
  if (mode < MODE_PACKED || mode > MODE_MULTI || out == nullptr || radii == nullptr ||
      (mode == MODE_EXACT ? !exact_outputs : !no_outputs) ||
      (sums != nullptr && mode != MODE_PACKED) || (exclude != nullptr && mode != MODE_EXACT))
    return kErrArgument;
  const size_t smem = (size_t)n_rows * (kSlots * sizeof(float4) + sizeof(int4));
  if (smem > kSmemLimit) return kErrSharedMemory;
  if (batch == 0 || n_rays == 0) return 0;
  const int ranges = (n_rays + kThreads - 1) / kThreads;
  const int fill = (kFillBlocks + batch - 1) / batch;
  const dim3 grid(ranges < fill ? ranges : fill, batch);
  const auto* r4 = reinterpret_cast<const int4*>(rows);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CSPE_RAYCAST_LAUNCH(M)                                                                  \
  raycast_kernel<M><<<grid, kThreads, smem, s>>>(r4, radii, prim_pos, prim_rot, params, sums,   \
                                                 ray_o, ray_d, exclude, n_rows, n_prims, n_rays, \
                                                 out, prim, inst, normal, kept)
  if (mode == MODE_PACKED)
    CSPE_RAYCAST_LAUNCH(MODE_PACKED);
  else if (mode == MODE_EXACT)
    CSPE_RAYCAST_LAUNCH(MODE_EXACT);
  else
    CSPE_RAYCAST_LAUNCH(MODE_MULTI);
#undef CSPE_RAYCAST_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
