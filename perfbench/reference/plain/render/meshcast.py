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

The plain sweep, ``plain_mesh_sweep``, is brute force over the visited
blocks: every (frame, group, block) slab test runs at once, the visited
triples are gathered with one ``nonzero``, and the test runs on fixed-size
chunks of triples as a batched (R, 3) @ (3, 3T) product, each (P, tile,
tri_block), reduced into (B, groups, tile) with ``scatter_reduce(amin)``.
The packed min does not depend on the order of visits, so it gives the JAX
sweep's result. Its inputs, each render's ``MeshTerms`` (every triangle's
corners, rigid or the worker's two-bone skin, terms and sphere, and every
block's box), come from ``plain_mesh_terms``. ``triangle_spheres``,
``block_hits`` and ``pair_passes`` serve the bound of the port's mesh-sweep
kernel (``harness/roofline.py``).
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Dict, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..core import camera as cam_mod
from ..scene import world as world_mod
from . import raycast
from .sweep_kernel import PixelSweeper

Tensor = torch.Tensor

DATA_DIR = Path(__file__).resolve().parents[1] / "data"  # frozen copies of the port's
TEMPLATES_NPZ = DATA_DIR / "mesh_templates.npz"
SKIN_NPZ = DATA_DIR / "worker_skin.npz"
DEFAULT_CLASSES = ("trafficcone", "tree", "fence", "human")

_BIG = np.float32(3e38)
# Elements of one (triples, rays, triangles) chunk of the plain triangle
# test and of one chunk of the slab test: 128 MB a f32 intermediate.
MAX_PAIRS = 1 << 25
# A triangle's bounding sphere is widened by SPHERE_REL of its radius, plus
# SPHERE_ABS m, which holds a hit found within a few ulps of an edge.
SPHERE_REL = 1e-5
SPHERE_ABS = 1e-4


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

    terms: Tensor  # (B, n_blocks, 10, T): cr 3, au 3, qv 3, tn
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


def block_matrices(terms: Tensor) -> Tuple[Tensor, Tensor]:
    """``terms`` (B, n_blocks, 10, T) as one matrix a block, W (B,
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
    block is visited. ``terms`` (B, n_blocks, 10, T), ``lo``/``hi``
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


def plain_mesh_terms(mesh: "MeshCaster", world, ray_o: Tensor) -> MeshTerms:
    """``mesh``'s ``MeshTerms`` for the origin ``ray_o`` (B, 3), from the
    corners of ``MeshCaster.corners``, in PyTorch ops on any device."""
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
        """The sweep's inputs: terms
        (B, n_blocks, 10, tri_block), for each block rows of tri_block
        floats for cr = e2 x e1 (3; det = d . cr), au = e2 x s (3; u_num =
        d . au), qv = s x e1 (3; v_num = d . qv) and tn = e2 . qv (t_num), s
        = o - v0; each block's inflated AABB, lo and hi (B, n_blocks, 3);
        each triangle's bounding sphere (``triangle_spheres``); and
        ``ray_o`` itself, the origin they hold (``plain_mesh_terms``)."""
        return plain_mesh_terms(self, world, ray_o)

    def layout(self, n: int) -> RayLayout:
        """How ``n`` rays a frame go in groups (``ray_layout``)."""
        return ray_layout(n, self.tile, self.grid_hw)

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
        return plain_mesh_sweep(m.terms, m.lo, m.hi, codes, ray_o, ray_d, lay)


def make_mesh_caster(roster: world_mod.Roster, tri_block: int = 512, tile: int = 1024,
                     grid_hw: Tuple[int, int] | None = None) -> MeshCaster | None:
    """The culled triangle sweep over every roster instance of
    ``DEFAULT_CLASSES`` (the worker: the skinned mesh), or None when the
    roster has none. Every instance's faces are padded to whole blocks of
    ``tri_block``, so a block has one owning instance (the cull's grain).
    ``tri_block`` is the JAX caster's knob; the port's kernel runs only
    512. ``tile``
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
    ``make_mesh_caster``: only 512 runs on the card."""

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
