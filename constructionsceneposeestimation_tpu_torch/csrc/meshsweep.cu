// Mesh sweep: the hifi tier's culled Möller–Trumbore triangle sweep, one
// packed f32 (t | instance + 2) per ray.
//
// Replaces the jnp loop `tile_fn` of `make_mesh_caster`
// (constructionsceneposeestimation_tpu/render/meshcast.py:307-344), which
// XLA fuses on the TPU into one elementwise block a visited triangle block
// (it is not a Pallas kernel). Plain version:
// render/meshcast.plain_mesh_sweep.
//
// Inputs, from render/meshcast.MeshCaster.mesh_terms: for each (frame,
// block of kTri triangles) ten rows of kTri floats, cr = e2 x e1 (3),
// au = e2 x s (3), qv = s x e1 (3) and tn = e2 . qv, s = o - v0, so that
// with the frame's one origin det = d . cr, u_num = d . au, v_num = d . qv
// and t_num = tn; each block's AABB, inflated (lo, hi); each block's code
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
// What bounds it on an H100: FP32 operations. The bound (chip_smoke.py)
// charges each (ray, triangle) pair of a visited block the 22 operations
// of the division-free test below (MESH_PAIR_OPS), and each pair that
// passes it 4 more (MESH_PASS_OPS: the reciprocal, t, t > EPS, the min);
// the bytes (20 KB of terms a block and frame, 16 bytes a ray) are a few
// percent of it. The plain version's test, with a reciprocal on every
// pair, is 30 operations a pair. The design keeps every pair's
// intermediates in registers (the plain version writes ~20 passes of them
// to device memory), reads each visited block's terms once into shared
// memory, and cuts the instructions a pair, which is what limits it.
//
// Design:
// - A CUDA block owns a slice of one group's rays and writes each of them
//   once: no atomics. A 32 x 32 pixel tile is one slice, 256 threads x 4
//   rays held in registers. When the groups are too few to fill the card
//   (the keypoint segments: one group of ~700 rays a frame, 32 frames), a
//   slice is 64 rays and 256 threads: each ray is held by 4 lanes, which
//   split the triangles of a block, and their mins are reduced through
//   shared memory at the end; a frame spreads over ~11 SMs.
// - Cull: each CUDA block runs the slab test of every box against its
//   whole group (in chunks of its threads; a box already marked is
//   skipped), one __syncthreads_or a box, and marks the boxes hit in shared
//   memory. Every slice of a group marks the same boxes.
// - Walk: for each marked block, its terms are staged into shared memory
//   as kTri x 12 floats, three float4 a triangle that a whole warp reads at
//   once (a broadcast), and each thread tests its rays against its
//   triangles, keeping each ray's least t in a register.
// - The test a pair is 9 FMAs and ~7 more, with no division: u_num and
//   v_num must have det's sign (one LOP3 of the sign bits), |u_num +
//   v_num| <= |det| and |det| >= EPS. Only a pair that passes takes t =
//   t_num x (1 / det), the plain version's rounding of t, and t > EPS.
//   Against the plain version's u = u_num x (1 / det) >= 0, v >= 0, u + v
//   <= 1 this moves only rays within a few ulps of a triangle's edge (and
//   an exact 0 of the wrong sign), and the dots are summed in another
//   order than the plain version's matrix product: the kernel is held to
//   it by the sweep's tolerances, not bit for bit.
#include "common.cuh"

namespace cspe {
namespace {

constexpr int kTri = 512;     // render/meshcast.KERNEL_TRI_BLOCK
constexpr int kTerms = 10;    // rows a block: cr 3, au 3, qv 3, tn
constexpr int kStride = 12;   // floats a staged triangle: three float4
constexpr float kBig = 3e38f;  // render/meshcast._BIG
constexpr float kNear = 1e-12f;  // an axis-parallel ray component
constexpr size_t kStageBytes = sizeof(float) * kTri * kStride;
// CUDA blocks of 1024-ray slices that fill the card: two a streaming
// multiprocessor of the H100 (132).
constexpr long long kFillBlocks = 264;

struct Args {
  const float* terms;  // (B, nb, kTerms, kTri)
  const float* lo;     // (B, nb, 3)
  const float* hi;     // (B, nb, 3)
  const int* codes;    // (nb,)
  const float* ray_o;  // (B, 3)
  const float* ray_d;  // (B, n, 3)
  int nb, n, groups, rays, grid_w, side, slices;
  float* out;   // (B, n)
  int* visits;  // (B, groups) or null
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

template <int kRayThreads, int kRays, int kSplit>
__global__ void __launch_bounds__(kRayThreads * kSplit) mesh_sweep_kernel(Args a) {
  extern __shared__ float4 smem4[];
  float* stage = reinterpret_cast<float*>(smem4);
  int* marked = reinterpret_cast<int*>(stage + kTri * kStride);
  constexpr int kThreads = kRayThreads * kSplit;
  constexpr int kSlice = kRayThreads * kRays;  // rays a CUDA block owns
  const int tid = threadIdx.x;
  const int slice = blockIdx.x % a.slices;
  const int bg = blockIdx.x / a.slices;  // frame * groups + group
  const int b = bg / a.groups, g = bg - b * a.groups;
  const float o[3] = {a.ray_o[3 * b], a.ray_o[3 * b + 1], a.ray_o[3 * b + 2]};
  const float* rd = a.ray_d + static_cast<size_t>(b) * a.n * 3;
  const float* lo = a.lo + static_cast<size_t>(b) * a.nb * 3;
  const float* hi = a.hi + static_cast<size_t>(b) * a.nb * 3;

  for (int k = tid; k < a.nb; k += kThreads) marked[k] = 0;
  __syncthreads();

  // Cull: every box against the whole group, as _aabb_hit_any computes it,
  // kThreads x kRays rays at a time.
  for (int c0 = 0; c0 < a.rays; c0 += kThreads * kRays) {
    float inv[kRays][3];
    bool near[kRays][3], valid[kRays];
#pragma unroll
    for (int j = 0; j < kRays; ++j) {
      const int r = c0 + j * kThreads + tid;
      valid[j] = r < a.rays;
      const float* d = rd + 3 * static_cast<size_t>(valid[j] ? ray_index(a, g, r) : 0);
#pragma unroll
      for (int x = 0; x < 3; ++x) {
        const float dx = d[x];
        near[j][x] = fabsf(dx) < kNear;
        inv[j][x] = 1.0f / (near[j][x] ? 1.0f : dx);
      }
    }
    for (int k = 0; k < a.nb; ++k) {
      if (marked[k]) continue;  // the same for every thread
      float lo_o[3], hi_o[3];
      bool inside[3];
#pragma unroll
      for (int x = 0; x < 3; ++x) {
        const float l = lo[3 * k + x], h = hi[3 * k + x];
        lo_o[x] = l - o[x];
        hi_o[x] = h - o[x];
        inside[x] = o[x] >= l && o[x] <= h;
      }
      bool hit = false;
#pragma unroll
      for (int j = 0; j < kRays; ++j) {
        float tmn = -kBig, tmx = kBig;
        bool ok = valid[j];
#pragma unroll
        for (int x = 0; x < 3; ++x) {
          const float t1 = lo_o[x] * inv[j][x], t2 = hi_o[x] * inv[j][x];
          tmn = fmaxf(tmn, near[j][x] ? -kBig : fminf(t1, t2));
          tmx = fminf(tmx, near[j][x] ? kBig : fmaxf(t1, t2));
          ok = ok && (!near[j][x] || inside[x]);
        }
        hit = hit || (ok && tmn <= tmx && tmx > kEps);
      }
      if (__syncthreads_or(hit) && tid == 0) marked[k] = 1;
    }
    __syncthreads();
  }

  // Walk: thread (rt, lane) tests rays rt + j kRayThreads of the slice
  // against triangles lane, lane + kSplit, ... of every marked block; a
  // warp lies in one lane, so it reads one triangle at a time.
  const int rt = tid % kRayThreads, lane = tid / kRayThreads;
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
    if (!marked[k]) continue;
    ++visits;
    __syncthreads();  // the previous block's terms are read by every thread
    const float* src = terms + static_cast<size_t>(k) * kTerms * kTri;
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
      // p: cr xyz, au x; q: au yz, qv xy; w: qv z, tn.
      const float4 p = smem4[3 * i], q = smem4[3 * i + 1], w = smem4[3 * i + 2];
#pragma unroll
      for (int j = 0; j < kRays; ++j) {
        const float det = fmaf(dz[j], p.z, fmaf(dy[j], p.y, dx[j] * p.x));
        const float un = fmaf(dz[j], q.y, fmaf(dy[j], q.x, dx[j] * p.w));
        const float vn = fmaf(dz[j], w.x, fmaf(dy[j], q.w, dx[j] * q.z));
        // u_num and v_num of det's sign, and |u_num + v_num| <= |det|.
        const int sign = (__float_as_int(un) ^ __float_as_int(det)) |
                         (__float_as_int(vn) ^ __float_as_int(det));
        if (sign >= 0 && fabsf(un + vn) <= fabsf(det) && fabsf(det) >= kEps) {
          const float t = w.y * (1.0f / det);
          if (t > kEps) tb[j] = fminf(tb[j], t);
        }
      }
    }
    const int code = a.codes[k];
#pragma unroll
    for (int j = 0; j < kRays; ++j) best[j] = fminf(best[j], pack(tb[j], code));
  }
  if constexpr (kSplit > 1) {
    // The lanes' mins of one ray, min-reduced through shared memory.
    float* part = stage;  // kSplit x kSlice floats, within the stage
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

template <int kRayThreads, int kRays, int kSplit>
void launch(Args a, int B, size_t smem, cudaStream_t stream) {
  static_assert(kSplit * kRayThreads * kRays <= kTri * kStride, "lanes' mins overflow the stage");
  a.slices = (a.rays + kRayThreads * kRays - 1) / (kRayThreads * kRays);
  const unsigned blocks = static_cast<unsigned>(static_cast<long long>(B) * a.groups * a.slices);
  mesh_sweep_kernel<kRayThreads, kRays, kSplit>
      <<<blocks, kRayThreads * kSplit, smem, stream>>>(a);
}

}  // namespace
}  // namespace cspe

// terms (B, nb, 10, 512), lo and hi (B, nb, 3), codes (nb,) int32, ray_o
// (B, 3), ray_d (B, n, 3) f32 -> out (B, n) packed f32 and, where visits
// is not null, visits (B, groups) int32: the blocks each group visits.
// grid_w > 0: the groups are side x side tiles of a pixel grid grid_w
// wide; else contiguous ranges of `rays`.
CSPE_API int cspe_mesh_sweep(const float* terms, const float* lo, const float* hi,
                             const int* codes, const float* ray_o, const float* ray_d, int B,
                             int nb, int n, int groups, int rays, int grid_w, int side,
                             float* out, int* visits, cudaStream_t stream) {
  using namespace cspe;
  if (B <= 0 || nb < 0 || groups <= 0 || rays <= 0 ||
      static_cast<long long>(groups) * rays != n ||
      (grid_w > 0 && (side <= 0 || rays != side * side || grid_w % side != 0 ||
                      n % grid_w != 0 || (n / grid_w) % side != 0)))
    return kErrArgument;
  const size_t smem = kStageBytes + sizeof(int) * static_cast<size_t>(nb);
  if (smem > kSmemLimit) return kErrSharedMemory;
  const Args a{terms, lo, hi, codes, ray_o, ray_d, nb, n, groups, rays, grid_w, side, 0, out,
               visits};
  if (static_cast<long long>(B) * groups * ((rays + 1023) / 1024) >= kFillBlocks)
    launch<256, 4, 1>(a, B, smem, stream);
  else
    launch<64, 1, 4>(a, B, smem, stream);
  return static_cast<int>(cudaGetLastError());
}
