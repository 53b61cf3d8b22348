// Mesh terms: the hifi tier's per-render triangle terms, block boxes and
// triangle spheres, the inputs csrc/meshsweep.cu reads (a MeshTerms).
//
// Replaces `_world_corners` and the head of `packed` in `make_mesh_caster`
// (constructionsceneposeestimation_tpu/render/meshcast.py:253-305), a jnp
// computation that XLA fuses on the TPU (not a Pallas kernel). Plain
// version: render/meshcast.plain_mesh_terms (MeshCaster.corners, then the
// terms, boxes and spheres), ~130 PyTorch ops a call.
//
// What it computes, for each frame b and block k of kTri triangle slots:
// each slot's three world corners, R v + p for a rigid class (R, p: the
// block's instance's inst_rot, inst_pos) or for the skinned worker the
// two-bone linear blend w_0 (R_0 l_0 + p_0) + w_1 (R_1 l_1 + p_1) (R_j, p_j:
// prim_rot, prim_pos at the instance's bone rows; l_j the vertex in bone
// j's frame); then e1 = c1 - c0, e2 = c2 - c0, s = o - c0 and the ten rows
// cr = e2 x e1, au = e2 x s, qv = s x e1, tn = e2 . qv; the triangle's
// sphere, its centroid minus o and the distance to its farthest corner
// widened to (1 + SPHERE_REL) r + SPHERE_ABS, -1 where cr is exactly 0 (the
// padding); the block's box, the min and max of its slots' corners (the
// padding's included), inflated by 1e-5 of its largest extent.
//
// What bounds it on an H100: its stores, 14 floats a slot, 81.7 MB for a
// 32-frame batch of 89 blocks (0.0244 ms at 3.35 TB/s); its ~150 FP32
// operations a slot take far less, and its tables (at most 785 vertices a
// template, the faces) stay in L2. It replaces the plain version's ~130
// op dispatches a call, whose issue took ~2 ms of host time, by one.
//
// Design: one CUDA block a (block of kTri triangles, frame), one thread a
// slot. The block stages its instance's transform, or the worker's bone
// transforms, in shared memory. Each thread recomputes its face's three
// corners from the vertex tables (each vertex ~6 times, once for each face
// that holds it: cheaper than a second launch and an intermediate tensor),
// then its terms and sphere, and writes element t of each of the 14 rows,
// so that a warp's stores are coalesced. The box is reduced with warp
// shuffles and one pass through shared memory. nvcc contracts the products
// into FMAs and the plain version's corners come from torch.einsum, so the
// kernel is held to the plain version by tolerances (chip_smoke.py's
// [mesh-terms] line), not bit for bit; the box's inflation and the sphere's
// widening are written uncontracted, as the plain version rounds them, and
// a padding slot's corners are one vertex's three times, so its cr is an
// exact 0 and its radius -1 in both.
#include "common.cuh"

namespace cspe {
namespace {

constexpr int kTri = 512;       // render/meshcast.KERNEL_TRI_BLOCK
constexpr int kTermRows = 10;   // render/meshcast.N_TERMS: cr 3, au 3, qv 3, tn
constexpr int kSphereRows = 4;  // centre - o 3, radius
constexpr int kXf = 12;         // a staged transform: R row-major 9, p 3
constexpr int kMaxBones = 32;   // render/meshcast.MAX_BONES
constexpr float kBoxRel = 1e-5f;  // the box's inflation, of its largest extent
// render/meshcast.SPHERE_REL and SPHERE_ABS, as PyTorch rounds 1.0 +
// SPHERE_REL.
constexpr float kSphereScale = static_cast<float>(1.0 + 1e-5);
constexpr float kSphereAbs = 1e-4f;

struct Args {
  const int* blocks;     // (nb, 3): instance, first face row, skinned row or -1
  const int* faces;      // (F, 3) rows of the vertex tables
  const float* verts;    // (V, 3) a rigid class's template vertices
  const float* v_loc;    // (V, 2, 3) a skinned vertex in its two bones' frames
  const float* weights;  // (V, 2)
  const int* bone_ids;   // (V, 2) the bones, columns of bone_rows
  const int* bone_rows;  // (H, n_bones) each skinned instance's primitive rows
  const float* inst_rot;  // (B, n_inst, 3, 3)
  const float* inst_pos;  // (B, n_inst, 3)
  const float* prim_rot;  // (B, n_prims, 3, 3)
  const float* prim_pos;  // (B, n_prims, 3)
  const float* ray_o;     // (B, 3)
  int nb, n_inst, n_prims, n_bones;
  float* terms;    // (B, nb, kTermRows, kTri)
  float* spheres;  // (B, nb, kSphereRows, kTri)
  float* lo;       // (B, nb, 3)
  float* hi;       // (B, nb, 3)
};

__device__ __forceinline__ float3 load3(const float* p) {
  return make_float3(p[0], p[1], p[2]);
}

// R v + p of a staged transform x.
__device__ __forceinline__ float3 apply(const float* x, float3 v) {
  return make_float3(fmaf(x[2], v.z, fmaf(x[1], v.y, x[0] * v.x)) + x[9],
                     fmaf(x[5], v.z, fmaf(x[4], v.y, x[3] * v.x)) + x[10],
                     fmaf(x[8], v.z, fmaf(x[7], v.y, x[6] * v.x)) + x[11]);
}

__device__ __forceinline__ float3 sub(float3 a, float3 b) {
  return make_float3(a.x - b.x, a.y - b.y, a.z - b.z);
}

// a x b, as torch.linalg.cross.
__device__ __forceinline__ float3 cross(float3 a, float3 b) {
  return make_float3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x);
}

__device__ __forceinline__ float norm(float3 a) {
  return sqrtf(a.x * a.x + a.y * a.y + a.z * a.z);
}

// Vertex v's world position: the staged rigid transform xf, or the blend
// over the skinned vertex's two bones (transforms xf[bone]).
__device__ __forceinline__ float3 corner(const Args& a, const float* xf, bool skinned, int v) {
  if (!skinned) return apply(xf, load3(a.verts + 3 * v));
  float3 c = make_float3(0.0f, 0.0f, 0.0f);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int q = 2 * v + j;
    const float3 vj = apply(xf + kXf * a.bone_ids[q], load3(a.v_loc + 3 * q));
    const float w = a.weights[q];
    c = make_float3(fmaf(w, vj.x, c.x), fmaf(w, vj.y, c.y), fmaf(w, vj.z, c.z));
  }
  return c;
}

__global__ void __launch_bounds__(kTri) mesh_terms_kernel(Args a) {
  __shared__ float xf[kMaxBones * kXf];
  __shared__ float part[kTri / 32][6];
  const int k = blockIdx.x, b = blockIdx.y, t = threadIdx.x;
  const int inst = a.blocks[3 * k], face0 = a.blocks[3 * k + 1], skin = a.blocks[3 * k + 2];
  const bool skinned = skin >= 0;
  if (!skinned) {
    const size_t row = static_cast<size_t>(b) * a.n_inst + inst;
    if (t < 9)
      xf[t] = a.inst_rot[9 * row + t];
    else if (t < kXf)
      xf[t] = a.inst_pos[3 * row + t - 9];
  } else {
    for (int i = t; i < a.n_bones * kXf; i += kTri) {
      const int j = i / kXf, e = i - j * kXf;
      const size_t row = static_cast<size_t>(b) * a.n_prims + a.bone_rows[skin * a.n_bones + j];
      xf[i] = e < 9 ? a.prim_rot[9 * row + e] : a.prim_pos[3 * row + e - 9];
    }
  }
  __syncthreads();

  const int* f = a.faces + 3 * (static_cast<size_t>(face0) + t);
  const float3 c0 = corner(a, xf, skinned, f[0]);
  const float3 c1 = corner(a, xf, skinned, f[1]);
  const float3 c2 = corner(a, xf, skinned, f[2]);
  const float3 o = load3(a.ray_o + 3 * b);
  const float3 e1 = sub(c1, c0), e2 = sub(c2, c0), s = sub(o, c0);
  const float3 cr = cross(e2, e1), au = cross(e2, s), qv = cross(s, e1);
  const float tn = e2.x * qv.x + e2.y * qv.y + e2.z * qv.z;
  const size_t slab = static_cast<size_t>(b) * a.nb + k;
  float* out = a.terms + slab * kTermRows * kTri + t;
  const float rows[kTermRows] = {cr.x, cr.y, cr.z, au.x, au.y, au.z, qv.x, qv.y, qv.z, tn};
#pragma unroll
  for (int r = 0; r < kTermRows; ++r) out[r * kTri] = rows[r];

  // The sphere: the centroid, the farthest corner's distance, widened.
  const float3 m = make_float3((c0.x + c1.x + c2.x) / 3.0f, (c0.y + c1.y + c2.y) / 3.0f,
                               (c0.z + c1.z + c2.z) / 3.0f);
  const float r = fmaxf(fmaxf(norm(sub(c0, m)), norm(sub(c1, m))), norm(sub(c2, m)));
  const bool flat = cr.x == 0.0f && cr.y == 0.0f && cr.z == 0.0f;
  float* sph = a.spheres + slab * kSphereRows * kTri + t;
  sph[0] = m.x - o.x;
  sph[kTri] = m.y - o.y;
  sph[2 * kTri] = m.z - o.z;
  sph[3 * kTri] = flat ? -1.0f : __fadd_rn(__fmul_rn(r, kSphereScale), kSphereAbs);

  // The box: min and max over the block's corners, then inflated.
  float v[6] = {fminf(fminf(c0.x, c1.x), c2.x), fminf(fminf(c0.y, c1.y), c2.y),
                fminf(fminf(c0.z, c1.z), c2.z), fmaxf(fmaxf(c0.x, c1.x), c2.x),
                fmaxf(fmaxf(c0.y, c1.y), c2.y), fmaxf(fmaxf(c0.z, c1.z), c2.z)};
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      const float u = __shfl_xor_sync(0xffffffffu, v[i], off);
      v[i] = i < 3 ? fminf(v[i], u) : fmaxf(v[i], u);
    }
  }
  const int warp = t / 32, lane = t % 32;
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < 6; ++i) part[warp][i] = v[i];
  }
  __syncthreads();
  if (warp != 0) return;
  constexpr int kWarps = kTri / 32;
#pragma unroll
  for (int i = 0; i < 6; ++i) v[i] = part[lane % kWarps][i];
#pragma unroll
  for (int off = kWarps / 2; off > 0; off >>= 1) {
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      const float u = __shfl_xor_sync(0xffffffffu, v[i], off);
      v[i] = i < 3 ? fminf(v[i], u) : fmaxf(v[i], u);
    }
  }
  if (lane == 0) {
    const float ext = fmaxf(fmaxf(v[3] - v[0], v[4] - v[1]), v[5] - v[2]);
    const float eps = __fmul_rn(kBoxRel, ext);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      a.lo[3 * slab + i] = __fsub_rn(v[i], eps);
      a.hi[3 * slab + i] = __fadd_rn(v[3 + i], eps);
    }
  }
}

}  // namespace
}  // namespace cspe

// The tables of render/meshcast.TermTables (blocks (nb, 3), faces (F, 3),
// verts (V, 3), v_loc (V, 2, 3), weights (V, 2), bone_ids (V, 2),
// bone_rows (H, n_bones)), the world's inst_rot (B, n_inst, 3, 3),
// inst_pos (B, n_inst, 3), prim_rot (B, n_prims, 3, 3), prim_pos (B,
// n_prims, 3) and ray_o (B, 3) -> terms (B, nb, 10, 512), spheres (B, nb,
// 4, 512), lo and hi (B, nb, 3), f32; the tables' rows lie within the
// world's (render/meshcast.mesh_terms_cuda checks them).
CSPE_API int cspe_mesh_terms(const int* blocks, const int* faces, const float* verts,
                             const float* v_loc, const float* weights, const int* bone_ids,
                             const int* bone_rows, const float* inst_rot, const float* inst_pos,
                             const float* prim_rot, const float* prim_pos, const float* ray_o,
                             int B, int nb, int n_inst, int n_prims, int n_bones, float* terms,
                             float* spheres, float* lo, float* hi, cudaStream_t stream) {
  using namespace cspe;
  if (B <= 0 || B > 65535 || nb <= 0 || n_inst <= 0 || n_prims < 0 || n_bones < 0 ||
      n_bones > kMaxBones)
    return kErrArgument;
  const Args a{blocks,   faces,    verts,    v_loc, weights, bone_ids, bone_rows,
               inst_rot, inst_pos, prim_rot, prim_pos, ray_o, nb,      n_inst,
               n_prims,  n_bones,  terms,    spheres, lo,     hi};
  mesh_terms_kernel<<<dim3(nb, B), kTri, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}
