"""The hifi CAD-mesh tier: a culled Möller–Trumbore triangle sweep, batched
over frames (port of the JAX ``render/meshcast.py``).

The classes whose triangle geometry the reference crate authors (traffic
cone, fence panel, tree; ``data/mesh_templates.npz``) and a skinned worker
(a capsule-shell mesh with two-bone linear-blend weights against the
human's own capsule primitives as bones, ``data/worker_skin.npz``) replace
their analytic proxies for primary and keypoint-segment rays. Both files
are byte copies of the JAX package's.

With one camera origin a frame, each Möller–Trumbore quantity is a dot of
the ray direction with a per-triangle vector: det = d . (e2 x e1), u_num =
d . (e2 x s), v_num = d . (s x e1), t_num = e2 . (s x e1), s = o - v0.
``MeshCaster.mesh_terms`` computes those vectors for every frame and
triangle, and the packed min (``raycast._pack``) of the test yields depth
and instance together.

Culling, as in the JAX sweep: each instance's faces are Morton-sorted and
cut into blocks of ``tri_block`` triangles (padded with degenerate
triangles, which miss), each block with its exact posed AABB inflated by
1e-5 of its extent, so a grazing ray that passes Möller–Trumbore is not
culled by an ulp. Rays go in groups of ``tile`` (``ray_layout``): square
image tiles on the pixel grid (``grid_hw``), contiguous ranges otherwise
(the keypoint segments). Each group visits only the blocks whose box one
of its rays meets.

Kernel: ``csrc/meshsweep.cu`` (``mesh_sweep_cuda``), which replaces the JAX
sweep's ``tile_fn``, a ``jnp`` loop that XLA fuses: a CUDA block a slice of
a group's rays; the group's cone pre-tests the blocks' boxes before their
slab test; on 32 x 32 pixel tiles each warp's compact patch of rays keeps
only the triangles whose bounding sphere its cone meets (the patch walk,
``WALKS``), and walks those in the visited blocks' triangles staged in
shared memory; on the keypoint segments each warp's set of 32 rays keeps
the blocks, words and triangles whose spheres one of its rays passes by
(the segment walk). ``patch_cull_plain`` and ``segment_cull_plain``
mirror the culls on tensors. Plain
version: ``plain_mesh_sweep``, brute force over the visited blocks, where
every (frame, group, block) slab test runs at once, the visited triples
are gathered with one ``nonzero``, and the test runs on fixed-size chunks
of triples as a batched (R, 3) @ (3, 3T) product, each (P, tile,
tri_block), reduced into (B, groups, tile) with ``scatter_reduce(amin)``.
The packed min does not depend on the order of visits, so both give the
JAX sweep's result. ``MeshCaster.packed`` dispatches on the device of the
rays: CUDA tensors launch the kernel, CPU tensors take the plain version.

The sweep's inputs, each render's ``MeshTerms``, come from a second
kernel, ``csrc/meshterms.cu`` (``mesh_terms_cuda``), which replaces the JAX
caster's ``_world_corners`` and the head of its ``packed`` (a ``jnp``
computation XLA fuses): one launch builds every triangle's corners (rigid,
or the worker's two-bone skin), terms and sphere and every block's box
from the static ``TermTables`` (``term_tables``), a thread a triangle slot.
Plain version: ``plain_mesh_terms``, ~130 PyTorch ops.
``MeshCaster.mesh_terms`` dispatches on the device of the origin as
``packed`` does on the rays'.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Dict, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..core import camera as cam_mod
from ..scene import world as world_mod
from ..utils import kernels
from . import raycast
from .sweep_kernel import PixelSweeper

Tensor = torch.Tensor

DATA_DIR = Path(__file__).resolve().parents[1] / "data"
TEMPLATES_NPZ = DATA_DIR / "mesh_templates.npz"
SKIN_NPZ = DATA_DIR / "worker_skin.npz"
DEFAULT_CLASSES = ("trafficcone", "tree", "fence", "human")

_BIG = np.float32(3e38)
# Elements of one (triples, rays, triangles) chunk of the plain triangle
# test and of one chunk of the slab test: 128 MB a f32 intermediate.
MAX_PAIRS = 1 << 25
# csrc/meshsweep.cu: its compile-time block of triangles, and the rows of
# terms a block (cr 3, au 3, qv 3, tn).
KERNEL_TRI_BLOCK = 512
N_TERMS = 10
# The kernel's walks (csrc/meshsweep.cu Walk): "split", a slice of 64 rays
# with 4 lanes a ray over every triangle of each visited block; PATCH,
# the patch walk of a 32 x 32 pixel tile, each warp's patches of
# PATCH_SHAPE (rows, cols) pixels culling the triangles by their spheres;
# or SEGMENTS, sets of SET consecutive rays of a group, one a lane, culling
# blocks, words and triangles by each ray's own test merged over the set.
PATCH = "4x8"
SEGMENTS = "segments"
WALKS = {"split": 0, PATCH: 1, SEGMENTS: 2}
SET = 32
PATCH_SHAPE = (4, 8)
PATCH_SIDE = 32
# Groups of 1024 rays that fill the card: two CUDA blocks a streaming
# multiprocessor of the H100 (132). Fewer take the split walk.
FILL_GROUPS = 264
# The culls' margins: a cone's half-angle widened to (1 + CULL_REL) alpha +
# CULL_ABS rad (the caster's and the pixel sweep's, raycast.CULL_REL and
# CULL_ABS); a triangle's bounding sphere widened as the boxes are,
# SPHERE_REL of its radius, plus SPHERE_ABS m, which holds a hit found
# within a few ulps of an edge; a box's sphere is its half diagonal widened
# by CULL_REL, plus SPHERE_ABS.
SPHERE_REL = 1e-5
SPHERE_ABS = 1e-4
# csrc/meshterms.cu stages a skinned instance's bone transforms in shared
# memory: at most MAX_BONES bones (the worker has 10).
MAX_BONES = 32
WORDS = KERNEL_TRI_BLOCK // 32  # kept words a (patch, block)


def load_skin(path=SKIN_NPZ) -> Dict[str, np.ndarray]:
    """The baked skinned worker: vertices, faces, two bone ids and weights a
    vertex, and each vertex in its two bones' local frames (``v_loc``). A
    bone is one of the human template's own primitives, in template order:
    v_w = sum_j w_j (prim_rot[bone_j] @ v_loc_j + prim_pos[bone_j])."""
    with np.load(path) as z:
        return {k: z[k] for k in ("verts", "faces", "bone_ids", "weights", "v_loc")}


def load_templates(path=TEMPLATES_NPZ) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """{class: (verts (V, 3) f32 in the proxy's local frame, faces (T, 3) i32)}."""
    out = {}
    with np.load(path) as z:
        for key in z.files:
            if key.endswith("_verts"):
                cls = key[:-6]
                out[cls] = (z[f"{cls}_verts"].astype(np.float32),
                            z[f"{cls}_faces"].astype(np.int32))
    return out


def _morton_sort_faces(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Reorder faces along a 3D Morton curve of their centroids so that each
    ``tri_block`` slice is spatially compact -> tight per-block AABBs for the
    tile cull. Pure permutation: the packed-min sweep is order-independent."""
    if len(faces) == 0:
        return faces
    c = verts[faces].mean(1)
    lo, hi = c.min(0), c.max(0)
    q = np.clip((c - lo) / np.maximum(hi - lo, 1e-9) * 1023.0,
                0, 1023).astype(np.uint64)
    key = np.zeros(len(faces), np.uint64)
    for b in range(10):
        for a in range(3):
            key |= ((q[:, a] >> np.uint64(b)) & np.uint64(1)) << np.uint64(3 * b + a)
    return faces[np.argsort(key, kind="stable")]


class MeshClass(NamedTuple):
    """One meshed class: its template and the roster instances it covers."""

    verts: np.ndarray  # (V, 3) f32, the class's local frame
    faces: np.ndarray  # (n_blocks * tri_block, 3) Morton-sorted, padded
    ids: np.ndarray  # (I,) int64 roster instances
    n_blocks: int  # blocks an instance
    n_faces: int  # faces before the padding
    skin: Dict[str, np.ndarray] | None  # the worker's LBS tables and bone rows


class TermTables(NamedTuple):
    """The static tables csrc/meshterms.cu builds each block's corners from
    (``term_tables``): one vertex index space over every class, in class
    order, which the faces index and every vertex table shares."""

    blocks: Tensor  # (n_blocks, 3) int32: instance, first face row, skinned row or -1
    faces: Tensor  # (F, 3) int32 vertex rows, each class's padded faces in turn
    verts: Tensor  # (V, 3) f32 template vertices (a rigid class's local frame)
    v_loc: Tensor  # (V, 2, 3) f32 a skinned vertex in its two bones' frames, else 0
    weights: Tensor  # (V, 2) f32 its two bones' weights, else 0
    bone_ids: Tensor  # (V, 2) int32 its two bones, columns of bone_rows, else 0
    bone_rows: Tensor  # (H, bones) int32 each skinned instance's primitive rows
    inst_rows: int  # instances the world must hold: the largest block instance + 1
    prim_rows: int  # primitives the world must hold: the largest bone row + 1


def term_tables(classes: Sequence[MeshClass], tri_block: int) -> Dict[str, np.ndarray]:
    """``TermTables``' arrays for ``classes``, in ``MeshCaster.corners``'
    block order (class, instance, block), as numpy: block j of instance i
    of a class reads the faces from row first = the class's first row + j
    tri_block on and, for the skinned class, bone_rows[i]."""
    verts, v_loc, weights, bone_ids, faces, blocks = [], [], [], [], [], []
    bone_rows = np.zeros((0, 0), np.int32)
    v0 = f0 = 0
    for c in classes:
        V = len(c.verts)
        verts.append(c.verts)
        skin = c.skin or {"v_loc": np.zeros((V, 2, 3)), "weights": np.zeros((V, 2)),
                          "bone_ids": np.zeros((V, 2))}
        v_loc.append(skin["v_loc"])
        weights.append(skin["weights"])
        bone_ids.append(skin["bone_ids"])
        faces.append(c.faces + v0)
        for i, inst in enumerate(c.ids):
            row = -1 if c.skin is None else i
            blocks += [(inst, f0 + j * tri_block, row) for j in range(c.n_blocks)]
        if c.skin is not None:
            bone_rows = c.skin["bone_rows"]
        v0, f0 = v0 + V, f0 + len(c.faces)
    cat = lambda xs, dtype: np.ascontiguousarray(np.concatenate(xs), dtype)
    return {"blocks": np.asarray(blocks, np.int32), "faces": cat(faces, np.int32),
            "verts": cat(verts, np.float32), "v_loc": cat(v_loc, np.float32),
            "weights": cat(weights, np.float32), "bone_ids": cat(bone_ids, np.int32),
            "bone_rows": np.ascontiguousarray(bone_rows, np.int32)}


def _aabb_hit_any(ray_o: Tensor, ray_d: Tensor, lo: Tensor, hi: Tensor) -> Tensor:
    """Conservative slab test: does ANY ray o + t d (t > EPS) of a group hit
    box i? ray_o (B, 3), ray_d (B, G, N, 3), lo and hi (B, I, 3) -> (B, G, I)
    bool. An axis-parallel ray (|d_a| < 1e-12) passes that axis' slab only
    from inside it."""
    o = ray_o[:, None, None, None, :]  # (B, 1, 1, 1, 3)
    lo_, hi_ = lo[:, None, None], hi[:, None, None]  # (B, 1, 1, I, 3)
    tmn = tmx = ok = None
    for a in range(3):
        d = ray_d[..., a, None]  # (B, G, N, 1)
        near = torch.abs(d) < 1e-12
        inv = 1.0 / torch.where(near, 1.0, d)
        t1 = (lo_[..., a] - o[..., a]) * inv
        t2 = (hi_[..., a] - o[..., a]) * inv
        mn = torch.where(near, -float(_BIG), torch.minimum(t1, t2))
        mx = torch.where(near, float(_BIG), torch.maximum(t1, t2))
        inside = (o[..., a] >= lo_[..., a]) & (o[..., a] <= hi_[..., a])
        ax_ok = ~near | inside
        tmn = mn if tmn is None else torch.maximum(tmn, mn)
        tmx = mx if tmx is None else torch.minimum(tmx, mx)
        ok = ax_ok if ok is None else ok & ax_ok
    return torch.any(ok & (tmn <= tmx) & (tmx > raycast.EPS), dim=2)


class RayLayout(NamedTuple):
    """A frame's N rays in ``groups`` groups of ``rays``: with ``grid_w`` > 0
    square ``side`` x ``side`` tiles of a pixel grid ``grid_w`` wide, in
    row-major order of the tiles; else contiguous ranges."""

    groups: int
    rays: int
    grid_w: int
    side: int


def ray_layout(n: int, tile: int, grid_hw: Tuple[int, int] | None) -> RayLayout:
    """Square image tiles of ``tile`` rays when the ``n`` rays are the
    ``grid_hw`` pixel grid, contiguous ranges of ``tile`` when they divide
    the rays, else one group."""
    side = math.isqrt(tile)
    if grid_hw is not None:
        H, W = grid_hw
        if n == H * W and H % side == 0 and W % side == 0:
            return RayLayout(n // tile, tile, W, side)
    if n > tile and n % tile == 0:
        return RayLayout(n // tile, tile, 0, side)
    return RayLayout(1, n, 0, side)


def group_rays(x: Tensor, lay: RayLayout) -> Tensor:
    """(B, N, ...) -> (B, groups, rays, ...) in ``lay``'s order."""
    B, tail = x.shape[0], x.shape[2:]
    if lay.grid_w:
        s, W = lay.side, lay.grid_w
        return (x.reshape(B, -1, s, W // s, s, *tail).transpose(2, 3)
                .reshape(B, lay.groups, lay.rays, *tail))
    return x.reshape(B, lay.groups, lay.rays, *tail)


def ungroup(x: Tensor, lay: RayLayout) -> Tensor:
    """(B, groups, rays) -> (B, N), the inverse of ``group_rays``."""
    B = x.shape[0]
    if lay.grid_w:
        s, W = lay.side, lay.grid_w
        return x.reshape(B, -1, W // s, s, s).transpose(2, 3).reshape(B, -1)
    return x.reshape(B, -1)


def block_hits(ray_o: Tensor, rays: Tensor, lo: Tensor, hi: Tensor) -> Tensor:
    """(B, G, n_blocks) bool: the blocks whose box a ray of the group
    (``rays`` (B, G, R, 3)) hits, the slab test run on a few frames at a
    time."""
    B, G, R = rays.shape[:3]
    step = max(1, MAX_PAIRS // (G * R * lo.shape[1]))
    return torch.cat([_aabb_hit_any(ray_o[b:b + step], rays[b:b + step], lo[b:b + step],
                                    hi[b:b + step]) for b in range(0, B, step)])


class MeshTerms(NamedTuple):
    """The sweep's inputs for a frame's one origin (``MeshCaster.mesh_terms``)."""

    terms: Tensor  # (B, n_blocks, N_TERMS, T): cr 3, au 3, qv 3, tn
    lo: Tensor  # (B, n_blocks, 3) each block's inflated AABB
    hi: Tensor  # (B, n_blocks, 3)
    spheres: Tensor  # (B, n_blocks, 4, T): centre - origin 3, radius (-1: never passes)
    origin: Tensor  # (B, 3) the origin the terms and spheres were built for


def triangle_spheres(c0: Tensor, c1: Tensor, c2: Tensor, cr: Tensor, ray_o: Tensor) -> Tensor:
    """Each triangle's bounding sphere for the kernel's cull, (B, n_blocks,
    4, T): its centroid minus the frame's origin ``ray_o`` (B, 3), and the
    distance to its farthest corner widened to (1 + SPHERE_REL) r +
    SPHERE_ABS; -1 where cr = e2 x e1 is exactly 0 (the padding), a
    triangle whose det is 0 for every ray, which no ray passes. Corners
    (B, n_blocks, T, 3) and cr as ``mesh_terms`` computes them."""
    c = (c0 + c1 + c2) / 3.0
    r = torch.stack([torch.linalg.norm(x - c, dim=-1) for x in (c0, c1, c2)]).amax(0)
    r = torch.where((cr == 0).all(-1), -1.0, r * (1.0 + SPHERE_REL) + SPHERE_ABS)
    return torch.cat([c - ray_o[:, None, None], r[..., None]], -1).transpose(2, 3).contiguous()


def box_spheres(lo: Tensor, hi: Tensor, ray_o: Tensor) -> Tensor:
    """(B, n_blocks, 4): each box's bounding sphere, as csrc/meshsweep.cu
    builds it: its centre minus ``ray_o`` (B, 3), its half diagonal widened
    to (1 + CULL_REL) h + SPHERE_ABS."""
    c = 0.5 * (lo + hi) - ray_o[:, None]
    h = 0.5 * torch.linalg.norm(hi - lo, dim=-1) * (1.0 + raycast.CULL_REL) + SPHERE_ABS
    return torch.cat([c, h[..., None]], -1)


def _cone(d: Tensor) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """The cone from the camera of the rays d (..., R, 3), as
    csrc/meshsweep.cu builds it: unit axis (..., 3), the normalised sum of
    the unit directions; cos^2 and sin of the half-angle (...), the largest
    angle from the axis widened to (1 + CULL_REL) alpha + CULL_ABS; and
    ``every`` (...), where the cone meets every ball: past pi / 2, or with a
    zero or non-finite direction."""
    dd = torch.sum(d * d, -1)
    nd = torch.sqrt(dd)
    ok = (dd > 0) & torch.isfinite(nd)
    u = torch.where(ok[..., None], d / nd[..., None], 0.0)
    s = u.sum(-2)
    axis = s / torch.sqrt(torch.sum(s * s, -1, keepdim=True))
    cross = torch.linalg.cross(axis[..., None, :].expand_as(u), u, dim=-1)
    ang = torch.atan2(torch.sqrt(torch.sum(cross * cross, -1)),
                      torch.sum(axis[..., None, :] * u, -1))
    alpha = torch.where(ok, ang, 0.0).amax(-1) * (1.0 + raycast.CULL_REL) + raycast.CULL_ABS
    every = (~ok).any(-1) | ~torch.isfinite(axis).all(-1) | ~(alpha < raycast.HALF_PI)
    return axis, torch.cos(alpha) ** 2, torch.sin(alpha), every


def _meets(cone, ball: Tensor) -> Tensor:
    """Whether the cone (``_cone``'s, broadcast against ``ball``'s leading
    dims) meets the ball (..., 4) (centre - camera, radius >= 0): the camera
    inside it, or a.v + sin(alpha) r >= cos(alpha) sqrt(|v|^2 - r^2),
    squared."""
    axis, ca2, sa, every = cone
    v, r = ball[..., :3], ball[..., 3]
    d2, r2 = torch.sum(v * v, -1), r * r
    w = torch.sum(axis * v, -1) + sa * r
    return every | (d2 <= r2) | ((w >= 0) & (w * w >= ca2 * (d2 - r2)))


def patch_cull_plain(lo: Tensor, hi: Tensor, spheres: Tensor, ray_o: Tensor, ray_d: Tensor,
                     lay: RayLayout, walk: str = PATCH) -> Tuple[Tensor, Tensor | None]:
    """csrc/meshsweep.cu's culls on tensors. ``boxes`` (B, groups,
    n_blocks) bool: the blocks whose box sphere (``box_spheres``) the
    group's cone meets, the only ones that take the slab test; every block
    for groups that are not pixel tiles (a frame's keypoint segments,
    whose cone would keep nearly every box). ``kept``
    (B, groups, patches, n_blocks, T) bool for the patch walk (PATCH; None
    for "split"): the triangles with a sphere (``spheres``,
    radius >= 0) that both the tile's cone and the cone of patch p of the
    32 x 32 tile meet (the patches row-major over the tile, their rays
    row-major); the kernel tests only those, in the blocks it visits."""
    rays = group_rays(ray_d, lay)  # (B, G, R, 3)
    axis, ca2, sa, every = _cone(rays)
    group = (axis[:, :, None], ca2[..., None], sa[..., None], every[..., None])
    boxes = _meets(group, box_spheres(lo, hi, ray_o)[:, None])
    if not lay.grid_w:
        boxes = torch.ones_like(boxes)
    if walk == "split":
        return boxes, None
    if not (lay.grid_w and lay.side == PATCH_SIDE):
        raise ValueError(f"mesh sweep: the patch walk takes {PATCH_SIDE} x {PATCH_SIDE} pixel "
                         f"tiles, not {lay}")
    (ph, pw), n = PATCH_SHAPE, PATCH_SIDE
    B, G = rays.shape[:2]
    patches = (rays.reshape(B, G, n // ph, ph, n // pw, pw, 3).transpose(3, 4)
               .reshape(B, G, -1, ph * pw, 3))
    axis, ca2, sa, every = _cone(patches)  # (B, G, P, ...)
    cone = (axis[:, :, :, None], ca2[..., None], sa[..., None], every[..., None])
    sph = spheres.transpose(2, 3)  # (B, n_blocks, T, 4)
    tile = tuple(x[:, :, None] for x in group)  # against (B, 1, 1, T, 4)
    kept = torch.stack([_meets(cone, sph[:, None, None, k]) & _meets(tile, sph[:, None, None, k])
                        & (sph[:, None, None, k, :, 3] >= 0) for k in range(sph.shape[1])], 3)
    return boxes, kept


def word_spheres(spheres: Tensor) -> Tensor:
    """(B, n_blocks, 4, WORDS): a sphere about each word of 32 triangles'
    spheres (``triangle_spheres``), as csrc/meshsweep.cu's segment walk
    builds it: centred on the mean of the word's real centres (radius >=
    0), its radius the largest distance from there plus the triangle's
    radius, widened by SPHERE_REL; -1 for a word of padding only."""
    sph = spheres.unflatten(-1, (WORDS, 32))  # (B, nb, 4, WORDS, 32)
    real = sph[:, :, 3] >= 0  # (B, nb, WORDS, 32)
    n = real.sum(-1)
    c = torch.where(real[:, :, None], sph[:, :, :3], 0.0).sum(-1) / n.clamp_min(1)[:, :, None]
    gap = torch.sqrt(torch.sum((sph[:, :, :3] - c[..., None]) ** 2, 2)) + sph[:, :, 3]
    r = torch.where(real, gap, 0.0).amax(-1) * (1.0 + SPHERE_REL)
    return torch.cat([c, torch.where(n > 0, r, -1.0)[:, :, None]], 2)


def _ray_meets(u: Tensor, ball: Tensor) -> Tensor:
    """Whether the half-lines o + t u (t > 0) along unit directions u (...,
    3) meet the balls (..., 4) (centre - o, radius; a radius < 0 never),
    broadcast together, as csrc/meshsweep.cu's segment walk tests them: o
    inside the ball, or u . v > 0 and |u x v|^2 <= (r + CULL_ABS |v|)^2,
    the cone of one ray widened as the pixel sweep's. The cross product
    keeps the ray's distance from the centre to a few ulps of |v|;
    ``_meets``'s cos^2 form would lose it to cancellation at a cone this
    narrow. A zero u meets only the balls that hold o."""
    v, r = ball[..., :3], ball[..., 3]
    vv = torch.sum(v * v, -1)
    tc = torch.sum(u * v, -1)
    cx = u[..., 1] * v[..., 2] - u[..., 2] * v[..., 1]
    cy = u[..., 2] * v[..., 0] - u[..., 0] * v[..., 2]
    cz = u[..., 0] * v[..., 1] - u[..., 1] * v[..., 0]
    reach = r + raycast.CULL_ABS * torch.sqrt(vv)
    far = (tc > 0) & (cx * cx + cy * cy + cz * cz <= reach * reach)
    return (r >= 0) & ((vv <= r * r) | far)


def segment_cull_plain(lo: Tensor, hi: Tensor, spheres: Tensor, ray_o: Tensor, ray_d: Tensor,
                       lay: RayLayout) -> Tensor:
    """csrc/meshsweep.cu's segment walk cull on tensors: (B, groups, sets,
    n_blocks, T) bool, the triangles that set s of SET consecutive rays of
    each group (the last padded with zero directions) keeps: some ray of
    the set meets (``_ray_meets``) the block's box sphere (``box_spheres``),
    some ray meets the triangle's word sphere (``word_spheres``) and some
    ray meets the triangle's own sphere. A set with a direction whose |d|^2
    is not finite keeps every ball of radius >= 0. The kernel tests only
    the blocks its group visits."""
    rays = group_rays(ray_d, lay)  # (B, G, R, 3)
    B, G, R = rays.shape[:3]
    S = -(-R // SET)
    sets = torch.cat([rays, rays.new_zeros(B, G, S * SET - R, 3)], 2).reshape(B, G, S, SET, 3)
    dd = torch.sum(sets * sets, -1)
    nd = torch.sqrt(dd)
    ok = (dd > 0) & torch.isfinite(nd)
    u = torch.where(ok[..., None], sets / nd[..., None], 0.0)[:, :, :, :, None]  # (..., SET, 1, 3)
    wild = ~torch.isfinite(dd).all(-1)  # (B, G, S)

    def met(balls):  # (B, n, 4) -> (B, G, S, n)
        b = balls[:, None, None, None]
        return _ray_meets(u, b).any(3) | (wild[..., None] & (balls[:, None, None, :, 3] >= 0))

    blocks = met(box_spheres(lo, hi, ray_o))  # (B, G, S, nb)
    words = word_spheres(spheres).transpose(2, 3)  # (B, nb, WORDS, 4)
    sph = spheres.transpose(2, 3)  # (B, nb, T, 4)
    return torch.stack([met(sph[:, k]) & (met(words[:, k]) & blocks[..., k, None])
                        .repeat_interleave(32, -1) for k in range(sph.shape[1])], 3)


def kept_shape(B: int, lay: RayLayout, n_blocks: int) -> Tuple[int, ...]:
    """The shape of ``mesh_sweep_cuda``'s ``kept``: (B, groups, patches or
    sets, n_blocks, WORDS), a patch or set of 32 rays each (the last set
    of the segment walk padded). Pass it zeroed: the kernel writes only
    the blocks each group visits (the segment walk: each set walks)."""
    return (B, lay.groups, -(-lay.rays // SET), n_blocks, WORDS)


def kept_triangles(words: Tensor) -> Tensor:
    """(..., WORDS * 32) bool from kept words (..., WORDS) int32: bit i % 32
    of word i // 32 is triangle i."""
    shift = torch.arange(32, dtype=torch.int32, device=words.device)
    return ((words[..., None] >> shift) & 1).reshape(*words.shape[:-1], -1).bool()


def pair_passes(W: Tensor, rays: Tensor, widen: float = 0.0, tn: Tensor | None = None) -> Tensor:
    """(P, R, T) bool: the pairs of rays (P, R, 3) and triangles of the
    block matrices W (P, 3, 3T) (``block_matrices``) that pass the kernel's
    division-free test: u_num and v_num of det's sign, |u_num + v_num| <=
    |det|, |det| >= EPS; its dots summed in PyTorch's order. With ``widen``
    > 0 also the pairs that pass with each dot moved by ``widen`` ulps of
    its terms' magnitude (det's sum_i |d_i cr_i|, u_num's sum_i |d_i au_i|,
    v_num's sum_i |d_i qv_i|): those the kernel's own rounding may pass.
    With the blocks' t_num ``tn`` (P, T) also t = t_num x (1 / det) > EPS,
    the rest of the kernel's test (widened: t_num moved by ``widen`` ulps
    and det by its own), which drops the triangles behind the origin."""
    T = W.shape[-1] // 3
    det, un, vn = torch.bmm(rays, W).unflatten(-1, (3, T)).unbind(2)
    if not widen:
        bits = det.view(torch.int32)
        sign = (un.view(torch.int32) ^ bits) | (vn.view(torch.int32) ^ bits)
        ok = ((sign >= 0) & (torch.abs(un + vn) <= torch.abs(det))
              & (torch.abs(det) >= raycast.EPS))
        if tn is not None:
            ok &= tn[:, None] * torch.reciprocal(det) > raycast.EPS
        return ok
    tol = torch.bmm(torch.abs(rays), torch.abs(W)).mul_(widen * 2.0 ** -23)
    t_det, t_u, t_v = tol.unflatten(-1, (3, T)).unbind(2)
    sd = torch.where(det < 0, -1.0, 1.0)
    u, v, a = un * sd, vn * sd, det * sd
    ok = (u >= -t_u) & (v >= -t_v)
    ok &= u.add_(v).abs_() <= (t_u + t_v).add_(t_det).add_(a)
    ok &= a >= raycast.EPS - t_det
    if tn is not None:
        t_num = tn[:, None]
        ok &= t_num * sd > raycast.EPS * (a - t_det) - widen * 2.0 ** -23 * torch.abs(t_num)
    return ok


def patch_passes(W: Tensor, rays: Tensor, widen: float = 0.0) -> Tensor:
    """(P, patches, T) bool: for the block matrices W (P, 3, 3T) of P
    visited (frame, tile, block) triples and their 32 x 32 tiles' rays (P,
    1024, 3) (``group_rays`` order), whether some ray of each patch of
    the patch walk passes ``pair_passes(..., widen)`` with the triangle:
    the pairs a patch cull must keep."""
    ok = pair_passes(W, rays, widen)
    (ph, pw), n = PATCH_SHAPE, PATCH_SIDE
    P, T = ok.shape[0], ok.shape[-1]
    return (ok.reshape(P, n // ph, ph, n // pw, pw, T).transpose(2, 3)
            .reshape(P, -1, ph * pw, T).any(2))


def block_matrices(terms: Tensor) -> Tuple[Tensor, Tensor]:
    """``terms`` (B, n_blocks, N_TERMS, T) as one matrix a block, W (B,
    n_blocks, 3, 3T), whose columns are the vectors cr, au and qv of each
    triangle in turn (a ray's (1, 3) @ W gives det | u_num | v_num), and
    t_num (B, n_blocks, T)."""
    B, nb, _, T = terms.shape
    W = terms[:, :, :9].unflatten(2, (3, 3)).transpose(2, 3).reshape(B, nb, 3, 3 * T)
    return W, terms[:, :, 9]


def plain_mesh_sweep(terms: Tensor, lo: Tensor, hi: Tensor, codes: Tensor, ray_o: Tensor,
                     ray_d: Tensor, lay: RayLayout) -> Tensor:
    """Plain version of ``csrc/meshsweep.cu``: the packed min over the
    blocks each group visits, (B, N) packed f32 (t | code), INF where no
    block is visited. ``terms`` (B, n_blocks, N_TERMS, T), ``lo``/``hi``
    (B, n_blocks, 3) as ``MeshCaster.mesh_terms`` gives them, ``codes``
    (n_blocks,) int32, ``ray_o`` (B, 3), ``ray_d`` (B, N, 3)."""
    B, _, _, T = terms.shape
    W, tn = block_matrices(terms)
    rays = group_rays(ray_d, lay)
    G, R = lay.groups, lay.rays
    triples = torch.nonzero(block_hits(ray_o, rays, lo, hi))  # (V, 3): b, g, block
    best = torch.full((B * G, R), raycast.INF, device=ray_d.device)
    step = max(1, MAX_PAIRS // (R * T))
    for c in range(0, triples.shape[0], step):
        b, g, k = triples[c:c + step].unbind(1)
        D = torch.bmm(rays[b, g], W[b, k])  # (P, R, 3T): det | u_num | v_num
        det = D[..., :T]
        inv = torch.where(torch.abs(det) < raycast.EPS, 0.0, torch.reciprocal(det))
        u, v = D[..., T:].unflatten(-1, (2, T)).mul_(inv[:, :, None]).unbind(2)
        t = tn[b, k][:, None, :] * inv
        # inv == 0 (|det| < EPS, the padding too) leaves t = 0, which
        # fails t > EPS.
        ok = (torch.minimum(u, v) >= 0.0) & (u + v <= 1.0) & (t > raycast.EPS)
        t_min = torch.where(ok, t, float(raycast.INF)).amin(dim=2)  # (P, R)
        # A block has one code, and packing a code is monotone in t: the
        # pack of the block's min is the min of its packed values.
        pk = raycast._pack(t_min, codes[k, None])
        best.scatter_reduce_(0, (b * G + g)[:, None].expand(-1, R), pk, "amin")
    return ungroup(best.reshape(B, G, R), lay)


def mesh_walk(B: int, lay: RayLayout) -> str:
    """The kernel's walk for B frames in ``lay`` (``WALKS``): ``SEGMENTS``
    for every layout that is not a pixel grid (the keypoint segments);
    ``PATCH`` on 32 x 32 pixel tiles that fill the card (FILL_GROUPS in
    all); else "split"."""
    if not lay.grid_w:
        return SEGMENTS
    return PATCH if lay.side == PATCH_SIDE and B * lay.groups >= FILL_GROUPS else "split"


def mesh_sweep_cuda(terms: Tensor, lo: Tensor, hi: Tensor, spheres: Tensor, codes: Tensor,
                    ray_o: Tensor, ray_d: Tensor, lay: RayLayout, visits: Tensor | None = None,
                    kept: Tensor | None = None, walk: str | None = None) -> Tensor:
    """Launch csrc/meshsweep.cu: ``plain_mesh_sweep``'s (B, N) packed f32.
    ``walk`` (``WALKS``; default ``mesh_walk``) picks the kernel's walk;
    every walk gives the same bits. With ``visits`` (B, groups) int32, the
    kernel also writes there the blocks each group visits
    (``MeshCaster.visited(...).sum(-1)``); with ``kept`` (``kept_shape``,
    zeroed), the patch walk writes each patch's words of kept triangles for
    each block it visits, the segment walk each set's for each block it
    walks. Raises, before any launch, unless every tensor is a
    contiguous CUDA tensor of its type and shape, the blocks hold
    ``KERNEL_TRI_BLOCK`` triangles, the kernel's compile-time width, and a
    patch walk has 32 x 32 pixel tiles."""
    if terms.dim() != 4 or terms.shape[2:] != (N_TERMS, KERNEL_TRI_BLOCK):
        raise ValueError(f"mesh sweep: terms must be (B, n_blocks, {N_TERMS}, "
                         f"{KERNEL_TRI_BLOCK}): the kernel's tri_block is {KERNEL_TRI_BLOCK}, "
                         f"got {tuple(terms.shape)}")
    B, nb = terms.shape[:2]
    N = ray_d.shape[1] if ray_d.dim() == 3 else -1
    if lay.groups * lay.rays != N:
        raise ValueError(f"mesh sweep: layout {lay} does not cover {N} rays")
    walk = mesh_walk(B, lay) if walk is None else walk
    if walk not in WALKS:
        raise ValueError(f"mesh sweep: walk {walk!r} is not one of {list(WALKS)}")
    if walk == PATCH and not (lay.grid_w and lay.side == PATCH_SIDE):
        raise ValueError(f"mesh sweep: the patch walk takes {PATCH_SIDE} x {PATCH_SIDE} "
                         f"pixel tiles, not {lay}")
    if kept is not None and walk == "split":
        raise ValueError("mesh sweep: kept needs a patch walk or the segment walk")
    specs = [("mesh terms", terms, torch.float32, tuple(terms.shape)),
             ("mesh lo", lo, torch.float32, (B, nb, 3)),
             ("mesh hi", hi, torch.float32, (B, nb, 3)),
             ("mesh spheres", spheres, torch.float32, (B, nb, 4, KERNEL_TRI_BLOCK)),
             ("mesh codes", codes, torch.int32, (nb,)),
             ("mesh ray_o", ray_o, torch.float32, (B, 3)),
             ("mesh ray_d", ray_d, torch.float32, (B, N, 3))]
    if visits is not None:
        specs.append(("mesh visits", visits, torch.int32, (B, lay.groups)))
    if kept is not None:
        specs.append(("mesh kept", kept, torch.int32, kept_shape(B, lay, nb)))
    # Types and shapes first, whatever the device; then device and layout.
    for name, t, dtype, shape in specs:
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {dtype} of shape {shape}, got {t.dtype} of "
                             f"shape {tuple(t.shape)}")
    for name, t, dtype, shape in specs:
        kernels.check_cuda(name, t, dtype, shape)
    out = torch.empty(B, N, dtype=torch.float32, device=ray_d.device)
    kernels.launch("cspe_mesh_sweep", terms, spheres, lo, hi, codes, ray_o, ray_d, B, nb, N,
                   lay.groups, lay.rays, lay.grid_w, lay.side, WALKS[walk], out, visits, kept)
    mesh_sweep_cuda.launches += 1
    return out


mesh_sweep_cuda.launches = 0


def plain_mesh_terms(mesh: "MeshCaster", world, ray_o: Tensor) -> MeshTerms:
    """Plain version of csrc/meshterms.cu (``mesh_terms_cuda``):
    ``mesh``'s ``MeshTerms`` for the origin ``ray_o`` (B, 3), from the
    corners of ``MeshCaster.corners``, in PyTorch ops on any device."""
    plain_mesh_terms.card_calls += int(ray_o.is_cuda)
    c0, c1, c2 = mesh.corners(world)
    e1, e2 = c1 - c0, c2 - c0
    s = ray_o[:, None, None, :] - c0
    cross = lambda a, b: torch.linalg.cross(a, b, dim=-1)
    qv = cross(s, e1)
    tn = torch.sum(e2 * qv, dim=-1)
    cr = cross(e2, e1)
    terms = torch.cat([cr, cross(e2, s), qv, tn[..., None]], dim=-1)
    blk_lo = torch.minimum(torch.minimum(c0, c1), c2).amin(dim=2)
    blk_hi = torch.maximum(torch.maximum(c0, c1), c2).amax(dim=2)
    # The boxes are exact f32 bounds: inflate them, or a ray grazing a
    # silhouette triangle could pass the triangle test yet miss the slab.
    eps = 1e-5 * torch.amax(blk_hi - blk_lo, dim=-1, keepdim=True)
    return MeshTerms(terms.transpose(2, 3).contiguous(), blk_lo - eps, blk_hi + eps,
                     triangle_spheres(c0, c1, c2, cr, ray_o), ray_o)


# Calls on CUDA tensors: 0 wherever the kernel serves.
plain_mesh_terms.card_calls = 0


def mesh_terms_cuda(tables: TermTables, inst_rot: Tensor, inst_pos: Tensor, prim_rot: Tensor,
                    prim_pos: Tensor, ray_o: Tensor, tri_block: int) -> MeshTerms:
    """Launch csrc/meshterms.cu: ``plain_mesh_terms``' ``MeshTerms`` for
    the world's inst_rot (B, I, 3, 3), inst_pos (B, I, 3), prim_rot (B, P,
    3, 3), prim_pos (B, P, 3) and the origin ray_o (B, 3), from ``tables``
    (``MeshCaster``'s, on the card). Raises, before any launch, unless
    ``tri_block`` is ``KERNEL_TRI_BLOCK``, the kernel's compile-time width,
    every tensor is a contiguous CUDA tensor of its type and shape, the
    world holds the tables' instance and primitive rows and a skinned
    instance has at most MAX_BONES bones."""
    if tri_block != KERNEL_TRI_BLOCK:
        raise ValueError(f"mesh terms: the kernel's tri_block is {KERNEL_TRI_BLOCK}, not "
                         f"{tri_block}")
    B = ray_o.shape[0] if ray_o.dim() == 2 else -1
    I = inst_rot.shape[1] if inst_rot.dim() == 4 else -1
    P = prim_rot.shape[1] if prim_rot.dim() == 4 else -1
    if I < tables.inst_rows or P < tables.prim_rows:
        raise ValueError(f"mesh terms: the world holds {I} instances and {P} primitives, the "
                         f"tables read {tables.inst_rows} and {tables.prim_rows}")
    nb, V = tables.blocks.shape[0], tables.verts.shape[0]
    H, bones = tables.bone_rows.shape
    if bones > MAX_BONES:
        raise ValueError(f"mesh terms: {bones} bones an instance, the kernel takes {MAX_BONES}")
    specs = [("terms blocks", tables.blocks, torch.int32, (nb, 3)),
             ("terms faces", tables.faces, torch.int32, (tables.faces.shape[0], 3)),
             ("terms verts", tables.verts, torch.float32, (V, 3)),
             ("terms v_loc", tables.v_loc, torch.float32, (V, 2, 3)),
             ("terms weights", tables.weights, torch.float32, (V, 2)),
             ("terms bone_ids", tables.bone_ids, torch.int32, (V, 2)),
             ("terms bone_rows", tables.bone_rows, torch.int32, (H, bones)),
             ("terms inst_rot", inst_rot, torch.float32, (B, I, 3, 3)),
             ("terms inst_pos", inst_pos, torch.float32, (B, I, 3)),
             ("terms prim_rot", prim_rot, torch.float32, (B, P, 3, 3)),
             ("terms prim_pos", prim_pos, torch.float32, (B, P, 3)),
             ("terms ray_o", ray_o, torch.float32, (B, 3))]
    # Types and shapes first, whatever the device; then device and layout.
    for name, t, dtype, shape in specs:
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {dtype} of shape {shape}, got {t.dtype} of "
                             f"shape {tuple(t.shape)}")
    for name, t, dtype, shape in specs:
        kernels.check_cuda(name, t, dtype, shape)
    new = lambda *shape: torch.empty(B, nb, *shape, dtype=torch.float32, device=ray_o.device)
    terms, spheres = new(N_TERMS, KERNEL_TRI_BLOCK), new(4, KERNEL_TRI_BLOCK)
    lo, hi = new(3), new(3)
    kernels.launch("cspe_mesh_terms", *tables[:7], inst_rot, inst_pos, prim_rot, prim_pos, ray_o,
                   B, nb, I, P, bones, terms, spheres, lo, hi)
    mesh_terms_cuda.launches += 1
    return MeshTerms(terms, lo, hi, spheres, ray_o)


mesh_terms_cuda.launches = 0


def terms_gap(m: MeshTerms, ref: MeshTerms, corners: Tuple[Tensor, Tensor, Tensor]
              ) -> Dict[str, float]:
    """The largest gap between two ``MeshTerms`` of one world and origin,
    each part in units of 2^-23 C D. C is the largest |coordinate| of the
    slot's corners (with the origin's, for the parts that subtract it; of
    the block's slots for its box): the scale both versions round the
    corners at. D is the part's largest derivative by a corner: |e1| + |e2|
    for cr, |e2| + |s| for au, |s| + |e1| for qv, |e2||s| + |e2||e1| +
    |s||e1| for tn, 1 for the sphere's centre and radius and the box. A
    corner moved by a few ulps of C moves each part by a few units. The
    radii are compared where both are >= 0; a gap of 0 is 0 units, at the
    padding's D = 0 too. ``corners`` are ``ref``'s
    (``MeshCaster.corners``)."""
    c0, c1, c2 = corners
    o = ref.origin[:, None, None]
    Cc = torch.stack([c.abs().amax(-1) for c in corners]).amax(0)  # (B, nb, T)
    Co = torch.maximum(Cc, o.abs().amax(-1))
    e1, e2, s = c1 - c0, c2 - c0, o - c0
    n1, n2, ns = (torch.linalg.norm(x, dim=-1) for x in (e1, e2, s))
    units = lambda gap, d: float(torch.where(gap == 0, 0.0, gap / (2.0 ** -23 * d)).amax())
    scale = {"cr": Cc * (n1 + n2), "au": Co * (n2 + ns), "qv": Co * (ns + n1),
             "tn": Co * (n2 * ns + n2 * n1 + ns * n1)}
    out = {}
    for i, (part, d) in enumerate(scale.items()):
        rows = slice(3 * i, 3 * i + 3)
        out[part] = units((m.terms[:, :, rows] - ref.terms[:, :, rows]).abs().amax(2), d)
    out["centre"] = units((m.spheres[:, :, :3] - ref.spheres[:, :, :3]).abs().amax(2), Co)
    real = (m.spheres[:, :, 3] >= 0) & (ref.spheres[:, :, 3] >= 0)
    out["radius"] = units(torch.where(real, m.spheres[:, :, 3] - ref.spheres[:, :, 3], 0.0).abs(),
                          Cc)
    out["box"] = units(torch.maximum((m.lo - ref.lo).abs(), (m.hi - ref.hi).abs()),
                       Cc.amax(-1, keepdim=True))
    return out


class MeshCaster:
    """The culled triangle sweep over every roster instance of a meshed
    class (``make_mesh_caster``). ``packed(world, ray_o (B,
    3), ray_d (B, N, 3)) -> (B, N)`` packed f32 (t | instance + 2), INF where
    no triangle is hit. ``covered_prims`` (P,) bool marks the analytic
    primitives the meshes replace."""

    def __init__(self, roster: world_mod.Roster, classes: Sequence[MeshClass], tri_block: int,
                 tile: int, grid_hw: Tuple[int, int] | None):
        self.classes = classes
        self.tri_block, self.tile, self.grid_hw = tri_block, tile, grid_hw
        meshed = np.concatenate([c.ids for c in classes])
        self.covered_prims = np.isin(np.asarray(roster.prim_inst), meshed)
        self.n_triangles = sum(c.n_faces * len(c.ids) for c in classes)
        # Each block's payload code: its owning instance + 2.
        self.codes = np.concatenate([np.repeat(c.ids + 2, c.n_blocks)
                                     for c in classes]).astype(np.int32)
        self.n_blocks = len(self.codes)
        self.tables = term_tables(classes, tri_block)
        self._dev = {}

    def _on(self, device) -> dict:
        """The static tables as tensors on ``device`` (cached)."""
        key = str(device)
        if key not in self._dev:
            t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)
            tab = self.tables
            self._dev[key] = {
                "codes": t(self.codes),
                "classes": [(t(c.verts), t(c.faces.astype(np.int64)), t(c.ids),
                             None if c.skin is None else {k: t(a) for k, a in c.skin.items()})
                            for c in self.classes],
                "tables": TermTables(**{k: t(a) for k, a in tab.items()},
                                     inst_rows=int(tab["blocks"][:, 0].max()) + 1,
                                     prim_rows=int(tab["bone_rows"].max(initial=-1)) + 1)}
        return self._dev[key]

    def corners(self, world) -> Tuple[Tensor, Tensor, Tensor]:
        """Each triangle's world corners: three (B, n_blocks, tri_block, 3)."""
        B = world["inst_pos"].shape[0]
        cs = ([], [], [])
        for verts, faces, ids, skin in self._on(world["inst_pos"].device)["classes"]:
            if skin is not None:
                # Two-bone LBS against the posed per-primitive transforms:
                # the human's capsules are the bones.
                R_all = world["prim_rot"][:, skin["bone_rows"]]  # (B, I, bones, 3, 3)
                p_all = world["prim_pos"][:, skin["bone_rows"]]  # (B, I, bones, 3)
                vw = 0.0
                for j in range(2):
                    bj = skin["bone_ids"][:, j]  # (V,)
                    vj = (torch.einsum("bivkj,vj->bivk", R_all[:, :, bj], skin["v_loc"][:, j])
                          + p_all[:, :, bj])  # (B, I, V, 3)
                    vw = vw + skin["weights"][:, j][None, None, :, None] * vj
            else:
                vw = (torch.einsum("bikj,vj->bivk", world["inst_rot"][:, ids], verts)
                      + world["inst_pos"][:, ids][:, :, None, :])  # (B, I, V, 3)
            for k in range(3):
                cs[k].append(vw[:, :, faces[:, k]].reshape(B, -1, 3))
        return tuple(torch.cat(c, dim=1).reshape(B, self.n_blocks, self.tri_block, 3)
                     for c in cs)

    def mesh_terms(self, world, ray_o: Tensor) -> MeshTerms:
        """The sweep's inputs in the layout ``csrc/meshsweep.cu`` reads: terms
        (B, n_blocks, N_TERMS, tri_block), for each block rows of tri_block
        floats for cr = e2 x e1 (3; det = d . cr), au = e2 x s (3; u_num =
        d . au), qv = s x e1 (3; v_num = d . qv) and tn = e2 . qv (t_num), s
        = o - v0; each block's inflated AABB, lo and hi (B, n_blocks, 3);
        each triangle's bounding sphere (``triangle_spheres``); and
        ``ray_o`` itself, the origin they hold. A CUDA origin launches
        csrc/meshterms.cu (``mesh_terms_cuda``), a CPU one takes
        ``plain_mesh_terms``."""
        if not ray_o.is_cuda:
            return plain_mesh_terms(self, world, ray_o)
        pose = (world[k].contiguous() for k in ("inst_rot", "inst_pos", "prim_rot", "prim_pos"))
        m = mesh_terms_cuda(self._on(ray_o.device)["tables"], *pose, ray_o.contiguous(),
                            self.tri_block)
        return m._replace(origin=ray_o)

    def layout(self, n: int) -> RayLayout:
        """How ``n`` rays a frame go in groups (``ray_layout``)."""
        return ray_layout(n, self.tile, self.grid_hw)

    def visited(self, world, ray_o: Tensor, ray_d: Tensor) -> Tensor:
        """(B, G, n_blocks) bool: the (frame, ray group, block) triples the
        sweep tests, each ``tile`` rays against ``tri_block`` triangles."""
        m = self.mesh_terms(world, ray_o)
        return block_hits(ray_o, group_rays(ray_d, self.layout(ray_d.shape[1])), m.lo, m.hi)

    def packed(self, world, ray_o: Tensor, ray_d: Tensor) -> Tensor:
        """The sweep of rays from ray_o (B, 3) along ray_d (B, N, 3). A world
        from ``HifiCaster.frame_world`` holds the terms of its render's
        camera (key "mesh_terms"): they are used when ``ray_o`` is the very
        tensor they were built for (``MeshTerms.origin``), as in
        ``annotate.render_frame``, and built anew for any other origin."""
        m = world.get("mesh_terms")
        if m is None or m.origin is not ray_o:
            m = self.mesh_terms(world, ray_o)
        codes, lay = self._on(ray_d.device)["codes"], self.layout(ray_d.shape[1])
        if ray_d.is_cuda:
            return mesh_sweep_cuda(m.terms, m.lo, m.hi, m.spheres, codes, ray_o.contiguous(),
                                   ray_d.contiguous(), lay)
        return plain_mesh_sweep(m.terms, m.lo, m.hi, codes, ray_o, ray_d, lay)


def make_mesh_caster(roster: world_mod.Roster, tri_block: int = 512, tile: int = 1024,
                     grid_hw: Tuple[int, int] | None = None) -> MeshCaster | None:
    """The culled triangle sweep over every roster instance of
    ``DEFAULT_CLASSES`` (the worker: the skinned mesh), or None when the
    roster has none. Every instance's faces are padded to whole blocks of
    ``tri_block``, so a block has one owning instance (the cull's grain).
    ``tri_block`` is the JAX caster's knob and the plain version takes any;
    the kernel's is compiled in, so on the card only ``KERNEL_TRI_BLOCK``
    runs (``mesh_sweep_cuda`` refuses another before a launch). ``tile``
    rays a group, a perfect square: with ``grid_hw=(H, W)`` the pixel rays
    go in square image tiles."""
    if math.isqrt(tile) ** 2 != tile:
        raise ValueError(f"tile={tile} must be a perfect square (square image tiles: "
                         f"th = tw = isqrt(tile))")
    templates = load_templates()
    prim_inst = np.asarray(roster.prim_inst)
    meshed = []
    for cls in DEFAULT_CLASSES:
        ids = np.asarray([i for i, name in enumerate(roster.inst_class_names) if name == cls],
                         np.int64)
        if not len(ids) or (cls != "human" and cls not in templates):
            continue
        if cls == "human":
            skin = load_skin()
            # Bones are the human's own primitive rows, in template order.
            bone_rows = np.stack([np.nonzero(prim_inst == i)[0] for i in ids])
            v, f = skin["verts"], skin["faces"]
            skin_t = {"v_loc": skin["v_loc"], "weights": skin["weights"],
                      "bone_ids": skin["bone_ids"].astype(np.int64), "bone_rows": bone_rows}
        else:
            (v, f), skin_t = templates[cls], None
        f = _morton_sort_faces(np.asarray(v), f)
        nb = -(-len(f) // tri_block)
        # Pad with degenerate [0, 0, 0] triples: zero area -> det 0 -> miss.
        fp = np.concatenate([f, np.zeros((nb * tri_block - len(f), 3), np.int32)])
        meshed.append(MeshClass(np.asarray(v, np.float32), fp, ids, nb, len(f), skin_t))
    if not meshed:
        return None
    return MeshCaster(roster, meshed, tri_block, tile, grid_hw)


class HifiCaster:
    """The composite caster of the hifi tier (``make_hifi_caster`` in the JAX
    package): baked CAD triangles for the meshable classes and the analytic
    sweep for every other primitive, merged by packed min. A drop-in for
    ``raycast.Raycaster`` in ``annotate.render_frame``. ``cast`` (the exact
    caster of ``analytic_normals``) and ``fast_multi_origin`` (the shadow
    rays) are the unfiltered proxy roster's, as in JAX: under
    ``analytic_normals`` pixels and keypoint segments see the proxies, not
    the meshes, and shadows are proxy-shaped. ``tri_block`` as in
    ``make_mesh_caster``: only ``KERNEL_TRI_BLOCK`` runs on the card."""

    def __init__(self, roster: world_mod.Roster, grid_hw: Tuple[int, int] | None = None,
                 tile: int = 1024, tri_block: int = 512):
        self.mesh = make_mesh_caster(roster, tri_block, tile, grid_hw)
        if self.mesh is None:
            raise ValueError(f"the roster has no instance of {DEFAULT_CLASSES} to mesh")
        self.base_mask = ~self.mesh.covered_prims
        self.base = raycast.Raycaster(roster, prim_mask=self.base_mask)
        self.full = raycast.Raycaster(roster)
        self.cast = self.full.cast
        self.fast_multi_origin = self.full.fast_multi_origin

    def frame_world(self, world, cam_pos: Tensor):
        """The world that a render from cam_pos (B, 3) sweeps
        (``annotate.render_frame``): ``world`` with the meshes' terms for
        that camera under "mesh_terms", so that the render's pixel sweep and
        keypoint segments build them once (``MeshCaster.packed`` takes them
        only for rays from that very ``cam_pos`` tensor)."""
        return {**world, "mesh_terms": self.mesh.mesh_terms(world, cam_pos)}

    def packed(self, world, ray_o: Tensor, ray_d: Tensor) -> Tensor:
        return torch.minimum(self.base.packed(world, ray_o, ray_d),
                             self.mesh.packed(world, ray_o, ray_d))

    def fast(self, world, ray_o: Tensor, ray_d: Tensor) -> Dict[str, Tensor]:
        """{t (B, N) with +inf on a miss, inst (B, N): -1 ground, -2 miss}."""
        t, code = raycast._unpack(self.packed(world, ray_o, ray_d))
        hit = t < raycast.INF * 0.99
        return {"t": torch.where(hit, t, torch.full_like(t, float("inf"))),
                "inst": torch.where(hit, code - 2, -2)}


class HifiSweeper:
    """The hifi pixel sweep: the pixel-sweep kernel (or its plain version) on
    the schedule without the meshed primitives, merged by packed min with
    the mesh sweep of ``camera.pixel_rays`` in square image tiles."""

    def __init__(self, roster: world_mod.Roster, intr: cam_mod.Intrinsics, hifi: HifiCaster):
        self.intr, self.mesh = intr, hifi.mesh
        self.base = PixelSweeper(roster, intr, hifi.base, prim_mask=hifi.base_mask)

    def __call__(self, world, cam_pos: Tensor, M: Tensor) -> Tensor:
        dirs = cam_mod.pixel_rays(self.intr, M).reshape(M.shape[0], -1, 3)
        return torch.minimum(self.base(world, cam_pos, M), self.mesh.packed(world, cam_pos, dirs))
