// Mesh sweep: the hifi tier's culled Möller–Trumbore triangle sweep, one
// packed f32 (t | instance + 2) per ray.
//
// Replaces the jnp loop `tile_fn` of `make_mesh_caster`
// (constructionsceneposeestimation_tpu/render/meshcast.py:307-344), which
// XLA fuses on the TPU into one elementwise block a visited triangle block
// (it is not a Pallas kernel). Plain version:
// render/meshcast.plain_mesh_sweep; the culls' mirrors:
// render/meshcast.patch_cull_plain and segment_cull_plain.
//
// Inputs, from render/meshcast.MeshCaster.mesh_terms: for each (frame,
// block of kTri triangles) ten rows of kTri floats, cr = e2 x e1 (3),
// au = e2 x s (3), qv = s x e1 (3) and tn = e2 . qv, s = o - v0, so that
// with the frame's one origin det = d . cr, u_num = d . au, v_num = d . qv
// and t_num = tn; four rows of each triangle's widened bounding sphere,
// centre - o (3) and radius (-1 for a triangle no ray can pass: cr = 0,
// the padding); each block's AABB, inflated (lo, hi); each block's code
// (its instance + 2).
//
// What it computes, the plain version's function exactly: for each
// (frame, ray group) of render/meshcast.ray_layout (square tiles of the
// pixel grid, contiguous ranges, or all of a frame's rays) the blocks whose
// box some ray of the group meets, by the slab test of
// render/meshcast._aabb_hit_any, bit for bit (an axis-parallel ray passes a
// slab only from inside it); then for each ray of the group the min over
// those blocks of pack(the least t of the block's triangles the ray
// passes, the block's code), raycast.INF = 1e10 (never IEEE inf) where no
// block is visited. A miss thus keeps pack(INF, least visited code), as in
// the plain version. The min is order-independent, so the result does not
// depend on the order of anything: the same call gives the same bits.
//
// What bounds it on an H100: the pairs it tests. A pixel ray meets ~8
// triangles' bounding spheres but its tile's visited blocks hold ~800
// triangles, and a keypoint segment ~80 of its frame's 45568; the bound
// (chip_smoke.py) charges the 22 operations of the division-free test
// below (MESH_PAIR_OPS) only on the (ray, triangle) pairs whose ray meets
// the triangle's sphere, 4 more (MESH_PASS_OPS) on each pair that passes,
// against the bytes read once.
//
// Design:
// - A CUDA block owns a slice of one group's rays and writes each of them
//   once: no atomics on the output. A 32 x 32 pixel tile is one slice,
//   256 threads x 4 rays held in registers (the patch walk). When the
//   groups are too few to fill the card (the keypoint segments: one group
//   of ~700 rays a frame, 32 frames), a slice is 64 rays and 256 threads,
//   a frame over ~11 SMs: either each ray is held by 4 lanes, which split
//   the triangles of a block, and their mins are reduced through shared
//   memory at the end (the split walk, every triangle of every visited
//   block: the yardstick, and small pixel renders), or the segment walk
//   below. The wrapper picks the walk.
// - Box cull. On pixel tiles the block builds its tile's cone from every
//   ray of the tile (axis: the normalised sum of the unit directions;
//   half-angle: the largest angle from it, widened as csrc/sweep.cu widens
//   a tile's, (1 + kCullRel) alpha + kCullAbs; every box kept past pi / 2
//   or for a zero or non-finite direction). A box whose widened bounding
//   sphere the cone cannot meet, and which does not hold the camera, is one
//   that no ray's slab test can pass; the others (every box, for the
//   frame-wide groups of other layouts) take the slab test: each thread
//   loads a ray and its reciprocals once, then tests the boxes no ray has
//   hit yet, 32 a word, whose hits one __reduce_or_sync and one shared
//   atomicOr a warp merge: two barriers in all, not one a box. The marked
//   set is _aabb_hit_any's.
// - Patch walk (32 x 32 pixel tiles). Each warp's rays are compact
//   patches of the tile: 4 x 8 pixels, one ray a lane, four patches a warp
//   in turn (8 x 16 patches, four rays a lane, keep twice the triangles
//   and were slower). Each patch builds its cone with shuffles. For each
//   visited block the spheres are staged in shared memory and the tile's
//   cone keeps words of them (one ballot a word); only the terms of the
//   words it keeps any of are staged. Then each lane tests its sphere of
//   each such word against each of its warp's cones, and one
//   __ballot_sync gives the patch's word of kept triangles
//   (within the tile's), walked in ascending order, two triangles an
//   iteration so that their loads overlap, while it sits in a register:
//   the walk is warp-uniform and every staged triangle read is a
//   broadcast. A culled triangle is one that no ray of the patch passes,
//   so each ray's least t a block, and the output, are the split walk's
//   bit for bit; every visited block still gives pack(tb, code), kept
//   triangles or not. Four cones a warp take 108 registers unbounded, two
//   blocks an SM; the patch kernel is held to three (at most 85, no
//   spills), which hides more of the walk's latency.
// - Segment walk (every layout that is not a pixel grid). A warp holds a
//   set of 32 consecutive rays, one a lane; a set's rays fan out over
//   whole instances, so no cone that holds them culls (it keeps a third
//   of the triangles): each ray is tested alone, and ballots merge the
//   tests. A block holds two sets and eight warps, which take the (set,
//   kept block) items of both from a shared counter as they come free and
//   fold each ray's min into shared memory, so that 32 frames' ~700 sets
//   fill the card and a set that keeps many triangles takes the warps its
//   neighbour leaves. A set keeps a marked block whose widened box sphere
//   (mark_boxes keeps each box's) some ray passes by; in it each word of
//   32 triangles whose sphere, built with shuffles from the triangle
//   spheres, some ray passes by; in such a word lane i
//   tests triangle i's sphere against the set's 32 rays (read from shared
//   memory as broadcasts), and one ballot gives the word's kept
//   triangles, walked as the patch walk walks them but read through L1:
//   the warps of a block walk different blocks. A ray passes by a ball
//   when the ball holds the origin or the ray's unit direction u has u . v
//   > 0 and |u x v| <= r + kCullAbs |v|: the cone of one ray, widened as
//   a tile's. The cross product keeps the distance to a few ulps of |v|;
//   meets()'s cos^2 form, at a zero spread, rounds it by ~sqrt(ulp) |v|.
//   A culled pair is one whose ray misses the triangle's sphere, so it
//   fails the test; each marked block still gives pack(INF, code), the
//   block's least code starting each ray's min, and the output is the
//   split walk's bit for bit.
// - The test a pair is 9 FMAs and ~7 more, with no division: u_num and
//   v_num must have det's sign (one LOP3 of the sign bits), |u_num +
//   v_num| <= |det| and |det| >= EPS. Only a pair that passes takes t =
//   t_num x (1 / det), the plain version's rounding of t, and t > EPS.
//   Against the plain version's u = u_num x (1 / det) >= 0, v >= 0, u + v
//   <= 1 this moves only rays within a few ulps of a triangle's edge (and
//   an exact 0 of the wrong sign), and the dots are summed in another
//   order than the plain version's matrix product: the kernel is held to
//   it by the sweep's tolerances, not bit for bit.
// An optional output `kept` receives each patch's words of kept triangles
// for each visited block, or each set's for each block it walks.
#include "common.cuh"

namespace cspe {
namespace {

constexpr int kTri = 512;     // render/meshcast.KERNEL_TRI_BLOCK
constexpr int kTerms = 10;    // rows a block: cr 3, au 3, qv 3, tn
constexpr int kStride = 12;   // floats a staged triangle: three float4
constexpr int kWords = kTri / 32;  // words of kept triangles a block
constexpr int kSide = 32;     // a patch walk's pixel tile
constexpr int kPatchH = 4, kPatchW = 8;  // a patch's pixels: one ray a lane
constexpr int kPatchWarps = 8;           // warps of a patch walk's block
constexpr int kMine = kSide * kSide / (32 * kPatchWarps);  // patches a warp
constexpr int kPatches = kSide * kSide / (kPatchH * kPatchW);
constexpr int kSet = 32;      // render/meshcast.SET: a segment walk's rays a set, one a lane
constexpr int kSegSets = 2;   // sets a block of the segment walk
constexpr int kSegSplit = 4;  // warps a set's box tests split over
constexpr int kSegThreads = 32 * kSegSets * kSegSplit;
constexpr float kBig = 3e38f;  // render/meshcast._BIG
constexpr float kNear = 1e-12f;  // an axis-parallel ray component
constexpr float kCullRel = 1e-3f;  // render/raycast.CULL_REL
constexpr float kCullAbs = 1e-6f;  // render/raycast.CULL_ABS
constexpr float kBoxAbs = 1e-4f;   // render/meshcast.SPHERE_ABS
constexpr float kSphereRel = 1e-5f;  // render/meshcast.SPHERE_REL
constexpr float kHalfPi = 1.5707963f;
constexpr size_t kStageBytes = sizeof(float) * kTri * kStride + sizeof(float4) * kTri;

// render/meshcast.WALKS.
enum Walk : int { kSplitWalk = 0, kPatchWalk = 1, kSegmentWalk = 2 };

struct Args {
  const float* terms;    // (B, nb, kTerms, kTri)
  const float* spheres;  // (B, nb, 4, kTri)
  const float* lo;       // (B, nb, 3)
  const float* hi;       // (B, nb, 3)
  const int* codes;      // (nb,)
  const float* ray_o;    // (B, 3)
  const float* ray_d;    // (B, n, 3)
  int nb, n, groups, rays, grid_w, side, slices;
  float* out;   // (B, n)
  int* visits;  // (B, groups) or null
  int* kept;    // (B, groups, patches or sets, nb, kWords) or null
};

// Ray r of group g in the frame's ray order (render/meshcast.group_rays).
__device__ __forceinline__ int ray_index(const Args& a, int g, int r) {
  if (a.grid_w > 0) {
    const int tiles_x = a.grid_w / a.side;
    const int ty = g / tiles_x, tx = g - ty * tiles_x;
    const int row = ty * a.side + r / a.side, col = tx * a.side + r % a.side;
    return row * a.grid_w + col;
  }
  return g * a.rays + r;
}

__device__ __forceinline__ float pack(float t, int code) {
  return __int_as_float((__float_as_int(t) & ~kPayloadMask) | code);
}

// d / |d|, zero unless |d| is positive and finite (then `ok`).
__device__ __forceinline__ float3 unit(float x, float y, float z, bool& ok) {
  const float dd = x * x + y * y + z * z;
  const float nd = sqrtf(dd);
  ok = dd > 0.0f && isfinite(nd);
  return ok ? make_float3(x / nd, y / nd, z / nd) : make_float3(0.0f, 0.0f, 0.0f);
}

// The angle between unit a and unit u, accurate at small angles.
__device__ __forceinline__ float angle(float3 a, float3 u) {
  const float cx = a.y * u.z - a.z * u.y, cy = a.z * u.x - a.x * u.z,
              cz = a.x * u.y - a.y * u.x;
  return atan2f(sqrtf(cx * cx + cy * cy + cz * cz), a.x * u.x + a.y * u.y + a.z * u.z);
}

// A cone from the camera: unit axis, cos^2 and sin of the widened
// half-angle; `all` meets every ball.
struct Cone {
  float3 axis;
  float ca2, sa;
  bool all;
};

// A cone's axis: the normalised sum s of its unit directions (not finite
// when s is 0).
__device__ __forceinline__ float3 cone_axis(float3 s) {
  const float ns = sqrtf(s.x * s.x + s.y * s.y + s.z * s.z);
  return make_float3(s.x / ns, s.y / ns, s.z / ns);
}
// The cone about `axis` whose directions' largest angle from it is `ang`;
// `bad`: a direction was zero or not finite.
__device__ __forceinline__ Cone make_cone(float3 axis, float ang, bool bad) {
  Cone c;
  const float alpha = ang * (1.0f + kCullRel) + kCullAbs;
  c.axis = axis;
  c.all = bad || !(isfinite(axis.x) && isfinite(axis.y) && isfinite(axis.z)) ||
          !(alpha < kHalfPi);
  const float ca = cosf(alpha);
  c.ca2 = ca * ca;
  c.sa = sinf(alpha);
  return c;
}

// Whether the cone meets the ball b (centre - apex, radius >= 0): the apex
// inside it, or the angle from the axis to the centre v within alpha +
// asin(r / |v|): a.v + sin(alpha) r >= cos(alpha) sqrt(|v|^2 - r^2),
// squared (csrc/raycast.cu's test without the square root).
__device__ __forceinline__ bool meets(const Cone& c, float4 b) {
  const float d2 = b.x * b.x + b.y * b.y + b.z * b.z, r2 = b.w * b.w;
  const float w = c.axis.x * b.x + c.axis.y * b.y + c.axis.z * b.z + c.sa * b.w;
  return c.all || d2 <= r2 || (w >= 0.0f && w * w >= c.ca2 * (d2 - r2));
}

// The ray of lane `lane` in the j-th patch of warp `warp` of the patch
// walk: tile-local index row * kSide + col. Patch p = j kPatchWarps + warp
// of the tile's, row-major over the tile; its rays row-major, lane `lane`
// in it.
__device__ __forceinline__ int patch_ray(int warp, int lane, int j) {
  constexpr int kCols = kSide / kPatchW;
  const int p = j * kPatchWarps + warp;
  return ((p / kCols) * kPatchH + lane / kPatchW) * kSide + (p % kCols) * kPatchW +
         lane % kPatchW;
}

// The division-free test of one (ray, triangle) pair, folded into tb.
__device__ __forceinline__ void test_pair(float dx, float dy, float dz, float4 p, float4 q,
                                          float4 w, float& tb) {
  // p: cr xyz, au x; q: au yz, qv xy; w: qv z, tn.
  const float det = fmaf(dz, p.z, fmaf(dy, p.y, dx * p.x));
  const float un = fmaf(dz, q.y, fmaf(dy, q.x, dx * p.w));
  const float vn = fmaf(dz, w.x, fmaf(dy, q.w, dx * q.z));
  // u_num and v_num of det's sign, and |u_num + v_num| <= |det|.
  const int sign = (__float_as_int(un) ^ __float_as_int(det)) |
                   (__float_as_int(vn) ^ __float_as_int(det));
  if (sign >= 0 && fabsf(un + vn) <= fabsf(det) && fabsf(det) >= kEps) {
    const float t = w.y * (1.0f / det);
    if (t > kEps) tb = fminf(tb, t);
  }
}

// Shared memory: the stage (kTri x kStride floats, then kTri float4
// spheres), the group's cone, each box that passes it as two float4 (lo -
// o with the inside bits, hi - o), each box's sphere, the marks, the
// passing boxes' numbers,
// the hit words, the tile's words of kept triangles, the block's
// reductions.
struct Smem {
  float4* stage;
  float4* sphere;
  float4* cone;  // the group's cone: axis and cos^2, sin and all
  float4* box;
  float4* bsph;  // each box's widened sphere, centre - o and radius, by block
  int* marked;
  int* cand;
  unsigned* hit;
  unsigned* tile;
  float* red;
  int* count;
};

__device__ __forceinline__ Smem carve(float4* base, int nb) {
  Smem s;
  s.stage = base;
  s.sphere = base + 3 * kTri;
  s.cone = s.sphere + kTri;
  s.box = s.cone + 2;
  s.bsph = s.box + 2 * nb;
  s.marked = reinterpret_cast<int*>(s.bsph + nb);
  s.cand = s.marked + nb;
  s.hit = reinterpret_cast<unsigned*>(s.cand + nb);
  s.tile = s.hit + (nb + 31) / 32;
  s.red = reinterpret_cast<float*>(s.tile + kWords);
  s.count = reinterpret_cast<int*>(s.red + 32);
  return s;
}

size_t smem_bytes(int nb) {
  return kStageBytes + sizeof(float4) * (3 * nb + 2) + 2 * sizeof(int) * nb +
         sizeof(unsigned) * ((nb + 31) / 32 + kWords) + sizeof(float) * 32 + sizeof(int);
}

// Sum (kMax false) or max (kMax true) of every thread's x over the block,
// in a fixed order; every thread gets the result. s.red holds a value a
// warp.
template <int kThreads, bool kMax>
__device__ __forceinline__ float block_reduce(const Smem& s, float x) {
  constexpr int kWarps = kThreads / 32;
  x = kMax ? warp_max(x) : warp_sum(x);
  __syncthreads();  // s.red's previous values are read by every thread
  if ((threadIdx.x & 31) == 0) s.red[threadIdx.x >> 5] = x;
  __syncthreads();
  float r = s.red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r = kMax ? fmaxf(r, s.red[w]) : r + s.red[w];
  return r;
}

// The cone of every ray of group g of frame b.
template <int kThreads>
__device__ __forceinline__ Cone group_cone(const Args& a, const Smem& s, int b, int g) {
  const int tid = threadIdx.x;
  const float* rd = a.ray_d + static_cast<size_t>(b) * a.n * 3;
  float3 sum = make_float3(0.0f, 0.0f, 0.0f);
  bool bad = false;
  for (int r = tid; r < a.rays; r += kThreads) {
    const float* d = rd + 3 * static_cast<size_t>(ray_index(a, g, r));
    bool ok;
    const float3 u = unit(d[0], d[1], d[2], ok);
    bad = bad || !ok;
    sum.x += u.x;
    sum.y += u.y;
    sum.z += u.z;
  }
  const float3 axis = cone_axis(make_float3(block_reduce<kThreads, false>(s, sum.x),
                                            block_reduce<kThreads, false>(s, sum.y),
                                            block_reduce<kThreads, false>(s, sum.z)));
  float ang = 0.0f;
  for (int r = tid; r < a.rays; r += kThreads) {
    const float* d = rd + 3 * static_cast<size_t>(ray_index(a, g, r));
    bool ok;
    const float3 u = unit(d[0], d[1], d[2], ok);
    if (ok) ang = fmaxf(ang, angle(axis, u));
  }
  ang = block_reduce<kThreads, true>(s, ang);
  return make_cone(axis, ang, __syncthreads_or(bad));
}

// The group's cone (pixel tiles; a cone that meets every box for other
// layouts, whose frame-wide groups' cones would keep nearly every box),
// kept in s.cone, then the boxes it can meet, then the slab test of
// those; marks the boxes hit, as _aabb_hit_any.
template <int kThreads>
__device__ __forceinline__ void mark_boxes(const Args& a, const Smem& s, int b, int g,
                                           const float o[3]) {
  const int tid = threadIdx.x;
  const float* rd = a.ray_d + static_cast<size_t>(b) * a.n * 3;
  const Cone cone = a.grid_w > 0 ? group_cone<kThreads>(a, s, b, g)
                                 : Cone{make_float3(0.0f, 0.0f, 0.0f), 0.0f, 1.0f, true};

  // The boxes the cone can meet, in any order: their slab terms go to the
  // next free slot.
  if (tid == 0) {
    *s.count = 0;
    s.cone[0] = make_float4(cone.axis.x, cone.axis.y, cone.axis.z, cone.ca2);
    s.cone[1] = make_float4(cone.sa, cone.all ? 1.0f : 0.0f, 0.0f, 0.0f);
  }
  for (int k = tid; k < (a.nb + 31) / 32; k += kThreads) s.hit[k] = 0u;
  __syncthreads();
  const float* lo = a.lo + static_cast<size_t>(b) * a.nb * 3;
  const float* hi = a.hi + static_cast<size_t>(b) * a.nb * 3;
  for (int k = tid; k < a.nb; k += kThreads) {
    s.marked[k] = 0;
    float l[3], h[3], c[3], e2 = 0.0f;
    int inside = 0;
#pragma unroll
    for (int x = 0; x < 3; ++x) {
      l[x] = lo[3 * k + x];
      h[x] = hi[3 * k + x];
      c[x] = 0.5f * (l[x] + h[x]) - o[x];
      e2 += (h[x] - l[x]) * (h[x] - l[x]);
      inside |= (o[x] >= l[x] && o[x] <= h[x]) << x;
    }
    const float rad = 0.5f * sqrtf(e2) * (1.0f + kCullRel) + kBoxAbs;
    s.bsph[k] = make_float4(c[0], c[1], c[2], rad);
    if (meets(cone, make_float4(c[0], c[1], c[2], rad))) {
      const int slot = atomicAdd(s.count, 1);
      s.cand[slot] = k;
      s.box[2 * slot] = make_float4(l[0] - o[0], l[1] - o[1], l[2] - o[2], __int_as_float(inside));
      s.box[2 * slot + 1] = make_float4(h[0] - o[0], h[1] - o[1], h[2] - o[2], 0.0f);
    }
  }
  __syncthreads();
  const int n_cand = *s.count;

  // The slab test of the passing boxes against every ray of the group,
  // kThreads rays a round, each thread's ray and its reciprocals loaded
  // once; then the boxes no ray has hit yet (the hits only grow, so a stale
  // word costs only a test), 32 a word: bit c of word w is box 32 w + c.
  volatile unsigned* hit = s.hit;
  for (int r0 = 0; r0 < a.rays; r0 += kThreads) {
    const int r = r0 + tid;
    const float* d = rd + 3 * static_cast<size_t>(r < a.rays ? ray_index(a, g, r) : 0);
    float inv[3];
    bool near[3];
#pragma unroll
    for (int x = 0; x < 3; ++x) {
      const float dx = d[x];
      near[x] = fabsf(dx) < kNear;
      inv[x] = 1.0f / (near[x] ? 1.0f : dx);
    }
    for (int c0 = 0; c0 < n_cand; c0 += 32) {
      const int nc = min(32, n_cand - c0);
      // Warp-uniform: lane 0's reading of the word.
      unsigned todo = __shfl_sync(0xffffffffu, ~hit[c0 / 32], 0);
      if (nc < 32) todo &= (1u << nc) - 1u;
      unsigned bits = 0u;
      while (todo != 0u) {
        const int c = __ffs(todo) - 1;
        todo &= todo - 1u;
        const float4 L = s.box[2 * (c0 + c)], H = s.box[2 * (c0 + c) + 1];
        const float lo_o[3] = {L.x, L.y, L.z}, hi_o[3] = {H.x, H.y, H.z};
        const int inside = __float_as_int(L.w);
        float tmn = -kBig, tmx = kBig;
        bool ok = r < a.rays;
#pragma unroll
        for (int x = 0; x < 3; ++x) {
          const float t1 = lo_o[x] * inv[x], t2 = hi_o[x] * inv[x];
          tmn = fmaxf(tmn, near[x] ? -kBig : fminf(t1, t2));
          tmx = fminf(tmx, near[x] ? kBig : fmaxf(t1, t2));
          ok = ok && (!near[x] || ((inside >> x) & 1));
        }
        if (ok && tmn <= tmx && tmx > kEps) bits |= 1u << c;
      }
      bits = __reduce_or_sync(0xffffffffu, bits);
      if ((tid & 31) == 0 && bits != 0u) atomicOr(&s.hit[c0 / 32], bits);
    }
  }
  __syncthreads();
  for (int c = tid; c < n_cand; c += kThreads)
    if ((s.hit[c / 32] >> (c % 32)) & 1u) s.marked[s.cand[c]] = 1;
  __syncthreads();
}

// The split walk: thread (rt, lane) tests rays rt + j kRayThreads of the
// slice against triangles lane, lane + kSplit, ... of every marked block;
// a warp lies in one lane, so it reads one triangle at a time.
template <int kRayThreads, int kRays, int kSplit>
__device__ __forceinline__ void split_walk(const Args& a, const Smem& s, int b, int g, int bg,
                                           int slice) {
  constexpr int kThreads = kRayThreads * kSplit;
  constexpr int kSlice = kRayThreads * kRays;
  const int tid = threadIdx.x;
  const int rt = tid % kRayThreads, lane = tid / kRayThreads;
  const float* rd = a.ray_d + static_cast<size_t>(b) * a.n * 3;
  float dx[kRays], dy[kRays], dz[kRays], best[kRays];
#pragma unroll
  for (int j = 0; j < kRays; ++j) {
    const int r = slice * kSlice + j * kRayThreads + rt;
    const float* d = rd + 3 * static_cast<size_t>(r < a.rays ? ray_index(a, g, r) : 0);
    // A ray beyond the group's end has d = 0: det = 0, it passes nothing.
    dx[j] = r < a.rays ? d[0] : 0.0f;
    dy[j] = r < a.rays ? d[1] : 0.0f;
    dz[j] = r < a.rays ? d[2] : 0.0f;
    best[j] = kInf;
  }
  const float* terms = a.terms + static_cast<size_t>(b) * a.nb * kTerms * kTri;
  int visits = 0;
  for (int k = 0; k < a.nb; ++k) {
    if (!s.marked[k]) continue;
    ++visits;
    __syncthreads();  // the previous block's terms are read by every thread
    const float* src = terms + static_cast<size_t>(k) * kTerms * kTri;
    float* stage = reinterpret_cast<float*>(s.stage);
    for (int i = tid; i < kTri; i += kThreads) {
#pragma unroll
      for (int f = 0; f < kTerms; ++f) stage[i * kStride + f] = src[f * kTri + i];
    }
    __syncthreads();
    float tb[kRays];
#pragma unroll
    for (int j = 0; j < kRays; ++j) tb[j] = kInf;
#pragma unroll 2
    for (int i = lane; i < kTri; i += kSplit) {
      const float4 p = s.stage[3 * i], q = s.stage[3 * i + 1], w = s.stage[3 * i + 2];
#pragma unroll
      for (int j = 0; j < kRays; ++j) test_pair(dx[j], dy[j], dz[j], p, q, w, tb[j]);
    }
    const int code = a.codes[k];
#pragma unroll
    for (int j = 0; j < kRays; ++j) best[j] = fminf(best[j], pack(tb[j], code));
  }
  if constexpr (kSplit > 1) {
    // The lanes' mins of one ray, min-reduced through shared memory.
    float* part = reinterpret_cast<float*>(s.stage);  // kSplit x kSlice floats
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kRays; ++j) part[lane * kSlice + j * kRayThreads + rt] = best[j];
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kRays; ++j)
      for (int l = 1; l < kSplit; ++l)
        best[j] = fminf(best[j], part[l * kSlice + j * kRayThreads + rt]);
  }
  float* out = a.out + static_cast<size_t>(b) * a.n;
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < kRays; ++j) {
      const int r = slice * kSlice + j * kRayThreads + rt;
      if (r < a.rays) out[ray_index(a, g, r)] = best[j];
    }
  }
  if (a.visits != nullptr && slice == 0 && tid == 0) a.visits[bg] = visits;
}

// The patch walk of one 32 x 32 tile (kPatchWarps warps): for each marked
// block, the tile's cone keeps words of triangles by their spheres, and
// only those words are staged; then each of a warp's kMine patches (lane
// `lane` holding its ray m) culls those triangles with its own cone and
// walks the kept ones, two at a time.
__device__ __forceinline__ void patch_walk(const Args& a, const Smem& s, int b, int g, int bg) {
  constexpr int kThreads = 32 * kPatchWarps;
  static_assert(kPatchH * kPatchW == 32 && kMine * kPatchWarps == kPatches,
                "the warps' patches do not tile the tile");
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float* rd = a.ray_d + static_cast<size_t>(b) * a.n * 3;
  float dx[kMine], dy[kMine], dz[kMine], best[kMine];
  float3 u[kMine];
  bool ok[kMine];
#pragma unroll
  for (int m = 0; m < kMine; ++m) {
    const float* d = rd + 3 * static_cast<size_t>(ray_index(a, g, patch_ray(warp, lane, m)));
    dx[m] = d[0];
    dy[m] = d[1];
    dz[m] = d[2];
    best[m] = kInf;
    u[m] = unit(dx[m], dy[m], dz[m], ok[m]);
  }
  // The cones after every ray is loaded: built ray by ray, they spill.
  Cone cone[kMine];
#pragma unroll
  for (int m = 0; m < kMine; ++m) {
    const float3 axis =
        cone_axis(make_float3(warp_sum(u[m].x), warp_sum(u[m].y), warp_sum(u[m].z)));
    const float ang = warp_max(ok[m] ? angle(axis, u[m]) : 0.0f);
    cone[m] = make_cone(axis, ang, __any_sync(0xffffffffu, !ok[m]));
  }

  const float* terms = a.terms + static_cast<size_t>(b) * a.nb * kTerms * kTri;
  const float* spheres = a.spheres + static_cast<size_t>(b) * a.nb * 4 * kTri;
  int visits = 0;
  for (int k = 0; k < a.nb; ++k) {
    if (!s.marked[k]) continue;
    ++visits;
    __syncthreads();  // the previous block's stage is read by every thread
    const float* src = terms + static_cast<size_t>(k) * kTerms * kTri;
    const float* sph = spheres + static_cast<size_t>(k) * 4 * kTri;
    for (int i = tid; i < kTri; i += kThreads)
      s.sphere[i] = make_float4(sph[i], sph[kTri + i], sph[2 * kTri + i], sph[3 * kTri + i]);
    __syncthreads();
    // The tile's words (warp-uniform: thread i's word is i / 32), then the
    // terms of the triangles in words it keeps any of.
    const float4 c0 = s.cone[0], c1 = s.cone[1];
    const Cone tile{make_float3(c0.x, c0.y, c0.z), c0.w, c1.x, c1.y != 0.0f};
    for (int i = tid; i < kTri; i += kThreads) {
      const float4 sp = s.sphere[i];
      const unsigned word = __ballot_sync(0xffffffffu, sp.w >= 0.0f && meets(tile, sp));
      if (lane == 0) s.tile[i / 32] = word;
    }
    __syncthreads();
    float* stage = reinterpret_cast<float*>(s.stage);
    for (int i = tid; i < kTri; i += kThreads) {
      if (s.tile[i / 32] == 0u) continue;
#pragma unroll
      for (int f = 0; f < kTerms; ++f) stage[i * kStride + f] = src[f * kTri + i];
    }
    __syncthreads();
    float tb[kMine];
#pragma unroll
    for (int m = 0; m < kMine; ++m) tb[m] = kInf;
    int* kept = a.kept == nullptr
                    ? nullptr
                    : a.kept + (static_cast<size_t>(bg) * kPatches * a.nb + k) * kWords;
    for (int w = 0; w < kWords; ++w) {
      const unsigned tile_word = s.tile[w];
      if (tile_word == 0u) continue;  // kept stays 0
      const float4 sp = s.sphere[w * 32 + lane];
      const bool in_tile = (tile_word >> lane) & 1u;
#pragma unroll
      for (int m = 0; m < kMine; ++m) {
        unsigned word = __ballot_sync(0xffffffffu, in_tile && meets(cone[m], sp));
        if (kept != nullptr && lane == 0)
          kept[static_cast<size_t>(m * kPatchWarps + warp) * a.nb * kWords + w] =
              static_cast<int>(word);
        // Two triangles an iteration (the second the first again when one
        // is left: the min is idempotent), so that their loads overlap.
        while (word != 0u) {
          const int i = w * 32 + __ffs(word) - 1;
          word &= word - 1u;
          const int i2 = word != 0u ? w * 32 + __ffs(word) - 1 : i;
          word &= word - 1u;
          const float4 p = s.stage[3 * i], q = s.stage[3 * i + 1], v = s.stage[3 * i + 2];
          const float4 p2 = s.stage[3 * i2], q2 = s.stage[3 * i2 + 1], v2 = s.stage[3 * i2 + 2];
          test_pair(dx[m], dy[m], dz[m], p, q, v, tb[m]);
          test_pair(dx[m], dy[m], dz[m], p2, q2, v2, tb[m]);
        }
      }
    }
    const int code = a.codes[k];
#pragma unroll
    for (int m = 0; m < kMine; ++m) best[m] = fminf(best[m], pack(tb[m], code));
  }
  float* out = a.out + static_cast<size_t>(b) * a.n;
#pragma unroll
  for (int m = 0; m < kMine; ++m) out[ray_index(a, g, patch_ray(warp, lane, m))] = best[m];
  if (a.visits != nullptr && tid == 0) a.visits[bg] = visits;
}

// A ball (centre - o, radius >= 0) as one ray's test reads it: inside, o
// lies in it; reach2, the square of its radius widened by the one-ray
// cone's half-angle kCullAbs at its distance.
struct Ball {
  float4 b;
  float reach2;
  bool inside;
};

__device__ __forceinline__ Ball ball(float4 b) {
  const float vv = b.x * b.x + b.y * b.y + b.z * b.z;
  const float reach = b.w + kCullAbs * sqrtf(vv);
  return Ball{b, reach * reach, vv <= b.w * b.w};
}

// Whether the half-line from o along unit u passes within the ball's reach
// of its centre v beyond o: u . v > 0 and |u x v|^2 <= reach2. The cross
// product keeps the distance to a few ulps of |v|; meets()'s cos^2 form
// loses it to cancellation at one ray's zero spread.
__device__ __forceinline__ bool passes_by(float3 u, const Ball& c) {
  const float4 v = c.b;
  const float tc = u.x * v.x + u.y * v.y + u.z * v.z;
  const float cx = u.y * v.z - u.z * v.y, cy = u.z * v.x - u.x * v.z,
              cz = u.x * v.y - u.y * v.x;
  return tc > 0.0f && cx * cx + cy * cy + cz * cz <= c.reach2;
}

// The segment walk: the block holds kSegSets sets of kSet consecutive rays
// of the group, one a lane; warp w first tests, for set w / kSegSplit,
// every kSegSplit-th marked block. A set keeps a marked block whose box
// sphere some ray of the set passes by (render/meshcast._ray_meets). The
// (set, kept block) items of both sets then go to the block's warps as
// they come free (a shared counter), so that a heavy set takes the warps
// its light neighbour leaves. For an item the warp takes the set's rays,
// one a lane; each word of 32 triangles whose sphere (built here from the
// word's triangle spheres, render/meshcast.word_spheres) some ray passes
// by; in such a word, lane i tests triangle i's sphere against the set's
// 32 rays, and one ballot gives the word's kept triangles, which the warp
// walks as the patch walk does, reading each through L1 as a broadcast. A
// set with a non-finite direction keeps every ball. Every marked block
// gives each ray at least pack(INF, code): the least marked code starts
// each ray's min, kept in shared memory, where each item folds its
// block's pack(least t, code) in with one atomicMin of the bits (the
// packed values are positive floats).
__device__ __forceinline__ void segment_walk(const Args& a, const Smem& s, int b, int g, int bg,
                                             int slice) {
  constexpr int kRays = kSegSets * kSet;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int set = warp / kSegSplit, part = warp % kSegSplit;
  const int nbw = (a.nb + 31) / 32;
  float4* units = s.stage;                       // kRays: unit directions
  float4* dirs = units + kRays;                  // kRays: directions
  int* bests = reinterpret_cast<int*>(dirs + kRays);  // kRays: each ray's min, as bits
  unsigned* keep = reinterpret_cast<unsigned*>(bests + kRays);  // kSegSets x nbw
  int* items = reinterpret_cast<int*>(keep + kSegSets * nbw);  // kSegSets x nb: set << 16 | k
  int* least = items + kSegSets * a.nb;  // least code, count, items, next item, wild sets
  const int r = (slice * kSegSets + set) * kSet + lane;
  // Whether the set holds a ray of the group (the last slice's may not).
  const bool set_live = r - lane < a.rays;
  const float* rd = a.ray_d + static_cast<size_t>(b) * a.n * 3;
  const float* d = rd + 3 * static_cast<size_t>(r < a.rays ? ray_index(a, g, r) : 0);
  // A ray beyond the group's end has d = 0: it passes nothing.
  const float dx = r < a.rays ? d[0] : 0.0f, dy = r < a.rays ? d[1] : 0.0f,
              dz = r < a.rays ? d[2] : 0.0f;
  bool ok;
  const float3 u = unit(dx, dy, dz, ok);
  const bool wild = __any_sync(0xffffffffu, !isfinite(dx * dx + dy * dy + dz * dz));
  if (part == 0) {
    units[set * kSet + lane] = make_float4(u.x, u.y, u.z, 0.0f);
    dirs[set * kSet + lane] = make_float4(dx, dy, dz, 0.0f);
  }
  for (int k = tid; k < kSegSets * nbw; k += kSegThreads) keep[k] = 0u;
  if (tid == 0) {
    least[0] = kPayloadMask;
    least[1] = 0;
    least[3] = 0;
    least[4] = 0;
  }
  __syncthreads();
  if (part == 0 && lane == 0 && wild) atomicOr(&least[4], 1 << set);

  // The marked blocks' least code and count; each warp tests every
  // kSegSplit-th marked block's box sphere against its set's rays.
  int code_min = kPayloadMask, count = 0;
  for (int k0 = part * 32; k0 < a.nb; k0 += kSegSplit * 32) {
    const int k = k0 + lane;
    const bool marked = k < a.nb && s.marked[k];
    if (marked && set == 0) {
      code_min = min(code_min, a.codes[k]);
      ++count;
    }
    for (unsigned todo = __ballot_sync(0xffffffffu, marked); todo != 0u; todo &= todo - 1u) {
      const int kk = k0 + __ffs(todo) - 1;
      const Ball box = ball(s.bsph[kk]);
      if (set_live && (box.inside || __any_sync(0xffffffffu, wild || passes_by(u, box))) &&
          lane == 0)
        atomicOr(&keep[set * nbw + kk / 32], 1u << (kk % 32));
    }
  }
  code_min = __reduce_min_sync(0xffffffffu, code_min);
  count = __reduce_add_sync(0xffffffffu, count);
  if (lane == 0 && set == 0) {
    atomicMin(&least[0], code_min);
    atomicAdd(&least[1], count);
  }
  __syncthreads();

  // The items, set by set in ascending block order, listed by warp 0; each
  // ray's min starts at the least marked code's pack(INF, code).
  const float start = least[1] > 0 ? fminf(kInf, pack(kInf, least[0])) : kInf;
  if (tid < kRays) bests[tid] = __float_as_int(start);
  if (warp == 0) {
    int n = 0;
    for (int w = 0; w < kSegSets * nbw; ++w) {
      const unsigned bits = keep[w];
      if ((bits >> lane) & 1u)
        items[n + __popc(bits & ((1u << lane) - 1u))] = (w / nbw) << 16 | ((w % nbw) * 32 + lane);
      n += __popc(bits);
    }
    if (lane == 0) least[2] = n;
  }
  __syncthreads();

  const int n_items = least[2], wild_sets = least[4];
  const int n_sets = (a.rays + kSet - 1) / kSet;
  for (;;) {
    int item = 0;
    if (lane == 0) item = atomicAdd(&least[3], 1);
    item = __shfl_sync(0xffffffffu, item, 0);
    if (item >= n_items) break;
    const int is = items[item] >> 16, k = items[item] & 0xffff;
    const float4* set_units = units + is * kSet;
    const float4 uu = set_units[lane], dd = dirs[is * kSet + lane];
    const float3 ui = make_float3(uu.x, uu.y, uu.z);
    const bool wi = (wild_sets >> is) & 1;
    const size_t blk = static_cast<size_t>(b) * a.nb + k;
    const float* src = a.terms + blk * kTerms * kTri;
    const float* sph = a.spheres + blk * 4 * kTri;
    int* kept = a.kept == nullptr
                    ? nullptr
                    : a.kept + ((static_cast<size_t>(bg) * n_sets + slice * kSegSets + is) *
                                    a.nb + k) * kWords;
    float tb = kInf;
    for (int w = 0; w < kWords; ++w) {
      const int i = w * 32 + lane;
      const float4 sp = make_float4(__ldg(sph + i), __ldg(sph + kTri + i),
                                    __ldg(sph + 2 * kTri + i), __ldg(sph + 3 * kTri + i));
      const bool real = sp.w >= 0.0f;
      const int n_real = __popc(__ballot_sync(0xffffffffu, real));
      if (n_real == 0) continue;  // padding only: kept stays 0
      // The word's sphere: the mean of its real centres, and the largest
      // distance from it plus the triangle's radius, widened.
      const float cx = warp_sum(real ? sp.x : 0.0f) / n_real;
      const float cy = warp_sum(real ? sp.y : 0.0f) / n_real;
      const float cz = warp_sum(real ? sp.z : 0.0f) / n_real;
      const float ex = sp.x - cx, ey = sp.y - cy, ez = sp.z - cz;
      const float gap = real ? sqrtf(ex * ex + ey * ey + ez * ez) + sp.w : 0.0f;
      const Ball word = ball(make_float4(cx, cy, cz, warp_max(gap) * (1.0f + kSphereRel)));
      if (!word.inside && !__any_sync(0xffffffffu, wi || passes_by(ui, word))) continue;
      // Lane i's triangle against the set's rays.
      const Ball tri = ball(sp);
      bool met = wi || tri.inside;
#pragma unroll 8
      for (int j = 0; j < kSet; ++j) {
        const float4 v = set_units[j];
        met = met | passes_by(make_float3(v.x, v.y, v.z), tri);
      }
      unsigned bits = __ballot_sync(0xffffffffu, real && met);
      if (kept != nullptr && lane == 0) kept[w] = static_cast<int>(bits);
      // Two triangles an iteration, as the patch walk.
      while (bits != 0u) {
        const int t1 = w * 32 + __ffs(bits) - 1;
        bits &= bits - 1u;
        const int t2 = bits != 0u ? w * 32 + __ffs(bits) - 1 : t1;
        bits &= bits - 1u;
        const float4 p = make_float4(__ldg(src + t1), __ldg(src + kTri + t1),
                                     __ldg(src + 2 * kTri + t1), __ldg(src + 3 * kTri + t1));
        const float4 q = make_float4(__ldg(src + 4 * kTri + t1), __ldg(src + 5 * kTri + t1),
                                     __ldg(src + 6 * kTri + t1), __ldg(src + 7 * kTri + t1));
        const float4 v = make_float4(__ldg(src + 8 * kTri + t1), __ldg(src + 9 * kTri + t1),
                                     0.0f, 0.0f);
        const float4 p2 = make_float4(__ldg(src + t2), __ldg(src + kTri + t2),
                                      __ldg(src + 2 * kTri + t2), __ldg(src + 3 * kTri + t2));
        const float4 q2 = make_float4(__ldg(src + 4 * kTri + t2), __ldg(src + 5 * kTri + t2),
                                      __ldg(src + 6 * kTri + t2), __ldg(src + 7 * kTri + t2));
        const float4 v2 = make_float4(__ldg(src + 8 * kTri + t2), __ldg(src + 9 * kTri + t2),
                                      0.0f, 0.0f);
        test_pair(dd.x, dd.y, dd.z, p, q, v, tb);
        test_pair(dd.x, dd.y, dd.z, p2, q2, v2, tb);
      }
    }
    // A miss leaves pack(INF, code), never below the start.
    if (tb < kInf) atomicMin(&bests[is * kSet + lane], __float_as_int(pack(tb, a.codes[k])));
  }
  __syncthreads();
  if (part == 0 && r < a.rays) {
    a.out[static_cast<size_t>(b) * a.n + ray_index(a, g, r)] =
        __int_as_float(bests[set * kSet + lane]);
  }
  if (a.visits != nullptr && slice == 0 && tid == 0) a.visits[bg] = least[1];
}

// The split walk of kRayThreads x kRays rays, kSplit lanes a ray.
template <int kRayThreads, int kRays, int kSplit>
__global__ void __launch_bounds__(kRayThreads * kSplit) mesh_sweep_kernel(Args a) {
  extern __shared__ float4 smem4[];
  const Smem s = carve(smem4, a.nb);
  const int slice = blockIdx.x % a.slices;
  const int bg = blockIdx.x / a.slices;  // frame * groups + group
  const int b = bg / a.groups, g = bg - b * a.groups;
  const float o[3] = {a.ray_o[3 * b], a.ray_o[3 * b + 1], a.ray_o[3 * b + 2]};
  mark_boxes<kRayThreads * kSplit>(a, s, b, g, o);
  split_walk<kRayThreads, kRays, kSplit>(a, s, b, g, bg, slice);
}

// The patch walk of a 32 x 32 tile a block. Three blocks an SM (at most
// 85 registers a thread): four cones a warp take 108 registers
// unbounded, which leaves two.
__global__ void __launch_bounds__(32 * kPatchWarps, 3) mesh_sweep_patch_kernel(Args a) {
  extern __shared__ float4 smem4[];
  const Smem s = carve(smem4, a.nb);
  const int bg = blockIdx.x;  // frame * groups + group
  const int b = bg / a.groups, g = bg - b * a.groups;
  const float o[3] = {a.ray_o[3 * b], a.ray_o[3 * b + 1], a.ray_o[3 * b + 2]};
  mark_boxes<32 * kPatchWarps>(a, s, b, g, o);
  patch_walk(a, s, b, g, bg);
}

// The segment walk of kSegSets sets of kSet rays a block, kSegSplit warps a
// set; three blocks an SM (at most 85 registers a thread).
__global__ void __launch_bounds__(kSegThreads, 3) mesh_sweep_segment_kernel(Args a) {
  extern __shared__ float4 smem4[];
  const Smem s = carve(smem4, a.nb);
  const int slice = blockIdx.x % a.slices;
  const int bg = blockIdx.x / a.slices;  // frame * groups + group
  const int b = bg / a.groups, g = bg - b * a.groups;
  const float o[3] = {a.ray_o[3 * b], a.ray_o[3 * b + 1], a.ray_o[3 * b + 2]};
  mark_boxes<kSegThreads>(a, s, b, g, o);
  segment_walk(a, s, b, g, bg, slice);
}

template <int kRayThreads, int kRays, int kSplit>
void launch_split(Args a, int B, size_t smem, cudaStream_t stream) {
  static_assert(kSplit * kRayThreads * kRays <= kTri * kStride, "lanes' mins overflow the stage");
  a.slices = (a.rays + kRayThreads * kRays - 1) / (kRayThreads * kRays);
  const unsigned blocks = static_cast<unsigned>(static_cast<long long>(B) * a.groups * a.slices);
  mesh_sweep_kernel<kRayThreads, kRays, kSplit><<<blocks, kRayThreads * kSplit, smem, stream>>>(a);
}

void launch_segments(Args a, int B, size_t smem, cudaStream_t stream) {
  a.slices = (a.rays + kSegSets * kSet - 1) / (kSegSets * kSet);
  const unsigned blocks = static_cast<unsigned>(static_cast<long long>(B) * a.groups * a.slices);
  mesh_sweep_segment_kernel<<<blocks, kSegThreads, smem, stream>>>(a);
}

void launch_patch(Args a, int B, size_t smem, cudaStream_t stream) {
  a.slices = 1;
  const unsigned blocks = static_cast<unsigned>(static_cast<long long>(B) * a.groups);
  mesh_sweep_patch_kernel<<<blocks, 32 * kPatchWarps, smem, stream>>>(a);
}

}  // namespace
}  // namespace cspe

// terms (B, nb, 10, 512), spheres (B, nb, 4, 512), lo and hi (B, nb, 3),
// codes (nb,) int32, ray_o (B, 3), ray_d (B, n, 3) f32 -> out (B, n)
// packed f32 and, where visits is not null, visits (B, groups) int32: the
// blocks each group visits. grid_w > 0: the groups are side x side tiles
// of a pixel grid grid_w wide; else contiguous ranges of `rays`. walk
// (render/meshcast.WALKS): 0 the split walk, 1 the patch walk of 4 x 8
// patches (32 x 32 tiles only), 2 the segment walk (any layout); where
// kept is not null, kept (B, groups, 32 patches, nb, 16) int32 receives
// each patch's words of kept triangles for each visited block with the
// patch walk, kept (B, groups, ceil(rays / 32) sets, nb, 16) each set's
// for each block it walks with the segment walk.
CSPE_API int cspe_mesh_sweep(const float* terms, const float* spheres, const float* lo,
                             const float* hi, const int* codes, const float* ray_o,
                             const float* ray_d, int B, int nb, int n, int groups, int rays,
                             int grid_w, int side, int walk, float* out, int* visits, int* kept,
                             cudaStream_t stream) {
  using namespace cspe;
  if (B <= 0 || nb < 0 || groups <= 0 || rays <= 0 ||
      static_cast<long long>(groups) * rays != n ||
      (grid_w > 0 && (side <= 0 || rays != side * side || grid_w % side != 0 ||
                      n % grid_w != 0 || (n / grid_w) % side != 0)) ||
      walk < kSplitWalk || walk > kSegmentWalk ||
      (walk == kPatchWalk && (grid_w <= 0 || side != kSide)) ||
      (kept != nullptr && walk == kSplitWalk))
    return kErrArgument;
  const size_t smem = smem_bytes(nb);
  if (smem > kSmemLimit) return kErrSharedMemory;
  // The segment walk's rays, mins, kept blocks, items and counts in the
  // stage.
  if (walk == kSegmentWalk &&
      (2 * sizeof(float4) + sizeof(int)) * kSegSets * kSet +
              sizeof(unsigned) * kSegSets * ((nb + 31) / 32) + sizeof(int) * (kSegSets * nb + 5) >
          kStageBytes)
    return kErrSharedMemory;
  const Args a{terms, spheres, lo, hi, codes, ray_o, ray_d, nb, n, groups, rays, grid_w, side,
               0, out, visits, kept};
  if (walk == kPatchWalk)
    launch_patch(a, B, smem, stream);
  else if (walk == kSegmentWalk)
    launch_segments(a, B, smem, stream);
  else
    launch_split<64, 1, 4>(a, B, smem, stream);
  return static_cast<int>(cudaGetLastError());
}
