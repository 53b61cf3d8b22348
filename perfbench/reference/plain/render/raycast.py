"""Analytic ray casting on tensors (port of the casters of the JAX
``render/raycast.py``): the packed sweep, the exact sweep and the packed
sweep of rays with per-ray origins.

Every scene object is a set of closed-form primitives, so a render is a
dense [prims x rays] intersection sweep. The packed sweeps steal the low 6
mantissa bits of t for an id payload (instance + 2), so one min-reduction
yields depth and instance together; IEEE ordering of positive floats makes
the packed min exact (relative depth error <= 2^-18). A miss is ``INF``
(1e10), never IEEE inf, until the methods' ``hit`` masks apply.

* ``Raycaster.packed`` / ``.fast`` (JAX ``cast.fast``): rays from one
  origin a frame, primitives grouped by static transform category
  (``_transform_categories``) so each formula runs on exactly its own
  primitives. All formulas stay valid for unnormalized directions: the
  keypoint-occlusion segments cast raw cam -> keypoint vectors.
* ``Raycaster.cast`` (JAX ``cast``): the generic sweep, every primitive in
  its own local frame, grouped by kind in ``np.unique`` order, ``argmin``
  within a group (the first index wins a tie) and a strict ``<`` across
  groups; then the winner's analytic normal (``_local_normal``).
* ``Raycaster.fast_multi_origin`` (JAX ``cast_fast_multi_origin``): the
  packed sweep of rays with per-ray origins (the sun-shadow rays) over the
  same kind groups.

Each sweep is a walk over a ``SweepTable``, built once per caster: a row
per primitive with its operation (``OP_*``), primitive index, payload code
and fence axis swap, in the plain version's order, and its bounding radius
(``row_radii``). The walk reads each row's pose and parameters from the
world, in (B, g, N) planes a group, the JAX package's f32 operation order
(``packed_sweep``, ``exact_sweep``, ``multi_sweep``). The packed walk takes
the axial capsules' sums over three elements from ``axis_sums``. This
caster is also the plain version of the pixel sweep
(render/sweep_kernel.py). ``needed_rows`` counts the rows each ray's
bounding sphere test keeps: the work a bound of the port's caster kernel
charges (``harness/roofline.py``).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..scene import assets, world as world_mod

Tensor = torch.Tensor

INF = np.float32(1e10)
EPS = 1e-7
EXACT_RAYS = 1 << 20  # rays the plain exact and per-origin sweeps hold at once
_PAYLOAD_BITS = 6
_PAYLOAD_MASK = (1 << _PAYLOAD_BITS) - 1


def _pack(t: Tensor, code) -> Tensor:
    bits = t.contiguous().view(torch.int32)
    return ((bits & ~_PAYLOAD_MASK) | code).view(torch.float32)


def _unpack(packed: Tensor):
    bits = packed.contiguous().view(torch.int32)
    return (bits & ~_PAYLOAD_MASK).view(torch.float32), bits & _PAYLOAD_MASK


def _valid_t(t, cond):
    return torch.where(cond & (t > EPS), t, torch.full_like(t, INF))


def _safe(d):
    return torch.where(torch.abs(d) < EPS, torch.full_like(d, EPS), d)


def _prm(params: Tensor, k: int) -> Tensor:
    """Parameter k of each row of (..., g, 4) parameters, as a (..., g, 1)
    column."""
    return params[..., k, None]


def _plane_t(o, d, params):
    return _valid_t(-o[2] / _safe(d[2]), torch.abs(d[2]) >= EPS)


def _sphere_t(o, d, params):
    r = _prm(params, 0)
    a = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    b = o[0] * d[0] + o[1] * d[1] + o[2] * d[2]
    c = o[0] * o[0] + o[1] * o[1] + o[2] * o[2] - r * r
    a_safe = torch.clamp_min(a, EPS)
    disc = b * b - a_safe * c
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    return _valid_t((-b - sq) / a_safe, disc > 0)


def _box_t(o, d, params):
    tmin = tmax = None
    for ax in range(3):
        h = _prm(params, ax)
        inv = 1.0 / _safe(d[ax])
        t1 = (-h - o[ax]) * inv
        t2 = (h - o[ax]) * inv
        lo, hi = torch.minimum(t1, t2), torch.maximum(t1, t2)
        tmin = torch.clamp_min(lo, -INF) if tmin is None else torch.maximum(tmin, lo)
        tmax = torch.clamp_max(hi, INF) if tmax is None else torch.minimum(tmax, hi)
    return _valid_t(tmin, (tmax >= tmin) & (tmax > 0))


def _cylinder_t(o, d, params):
    r, hh = _prm(params, 0), _prm(params, 1)
    a = d[0] * d[0] + d[1] * d[1]
    b = o[0] * d[0] + o[1] * d[1]
    c = o[0] * o[0] + o[1] * o[1] - r * r
    a_safe = torch.where(a < EPS, torch.full_like(a, EPS), a)
    disc = b * b - a_safe * c
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    t_side = (-b - sq) / a_safe
    z_side = o[2] + t_side * d[2]
    t_best = _valid_t(t_side, (disc > 0) & (torch.abs(z_side) <= hh) & (a >= EPS))
    dz = _safe(d[2])
    for sign in (-1.0, 1.0):
        t_c = (sign * hh - o[2]) / dz
        x = o[0] + t_c * d[0]
        y = o[1] + t_c * d[1]
        t_best = torch.minimum(t_best, _valid_t(t_c, x * x + y * y <= r * r))
    return t_best


def _cone_t(o, d, params, rdz=None, a2=None):
    """Upright cone frustum with caps. ``rdz``/``a2`` are the shared
    per-ray reciprocal of dz and |d_xy|^2 of the transform-free category."""
    rb, rt, hh = _prm(params, 0), _prm(params, 1), _prm(params, 2)
    k = (rt - rb) / (2.0 * hh)
    q = rb + k * (o[2] + hh)
    m = k * d[2]
    a = (d[0] * d[0] + d[1] * d[1] if a2 is None else a2) - m * m
    b = o[0] * d[0] + o[1] * d[1] - q * m
    c = o[0] * o[0] + o[1] * o[1] - q * q
    a_safe = _safe(a)
    disc = b * b - a_safe * c
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    if rdz is None:
        t1, t2 = (-b - sq) / a_safe, (-b + sq) / a_safe
    else:
        ra = 1.0 / a_safe
        t1, t2 = (-b - sq) * ra, (-b + sq) * ra
    t_lo, t_hi = torch.minimum(t1, t2), torch.maximum(t1, t2)

    def side_ok(t):
        z = o[2] + t * d[2]
        rad = q + m * t
        return (disc > 0) & (torch.abs(z) <= hh) & (rad > 0)

    inf = torch.full_like(t_lo, INF)
    t_side = torch.where(side_ok(t_lo), t_lo, torch.where(side_ok(t_hi), t_hi, inf))
    t_best = torch.where(t_side > EPS, t_side, inf)
    for sign, rr in ((-1.0, rb), (1.0, rt)):
        t_c = (sign * hh - o[2]) / _safe(d[2]) if rdz is None else (sign * hh - o[2]) * rdz
        x = o[0] + t_c * d[0]
        y = o[1] + t_c * d[1]
        t_best = torch.minimum(t_best, _valid_t(t_c, x * x + y * y <= rr * rr))
    return t_best


def _capsule_t(o, d, params):
    """Side tube + two end balls (the cap discs lie inside the balls)."""
    r, hh = _prm(params, 0), _prm(params, 1)
    a2 = d[0] * d[0] + d[1] * d[1]
    b2 = o[0] * d[0] + o[1] * d[1]
    c2 = o[0] * o[0] + o[1] * o[1] - r * r
    a2_safe = torch.where(a2 < EPS, torch.full_like(a2, EPS), a2)
    disc2 = b2 * b2 - a2_safe * c2
    sq2 = torch.sqrt(torch.clamp_min(disc2, 0.0))
    t_side = (-b2 - sq2) / a2_safe
    z_side = o[2] + t_side * d[2]
    t_best = _valid_t(t_side, (disc2 > 0) & (torch.abs(z_side) <= hh) & (a2 >= EPS))
    a_safe = torch.clamp_min(a2 + d[2] * d[2], EPS)
    for sign in (-1.0, 1.0):
        ocz = o[2] - sign * hh
        b = b2 + ocz * d[2]
        c = c2 + ocz * ocz
        disc = b * b - a_safe * c
        sq = torch.sqrt(torch.clamp_min(disc, 0.0))
        t_best = torch.minimum(t_best, _valid_t((-b - sq) / a_safe, disc > 0))
    return t_best


_KIND_FNS = {
    assets.PLANE: _plane_t,
    assets.SPHERE: _sphere_t,
    assets.BOX: _box_t,
    assets.CYLINDER: _cylinder_t,
    assets.CONE: _cone_t,
    assets.CAPSULE: _capsule_t,
}


# --- transform-free ("inv") category: per-ray reciprocals shared by every
# primitive of the category.

def _inv_shared(d):
    a2 = d[0] * d[0] + d[1] * d[1]
    a3 = a2 + d[2] * d[2]
    return {"a2": a2, "a3": a3,
            "ra2": 1.0 / torch.clamp_min(a2, EPS),
            "ra3": 1.0 / torch.clamp_min(a3, EPS),
            "rdz": 1.0 / _safe(d[2]),
            "dz_ok": torch.abs(d[2]) >= EPS}


def _plane_t_inv(o, d, params, sh):
    return _valid_t(-o[2] * sh["rdz"], sh["dz_ok"])


def _sphere_t_inv(o, d, params, sh):
    r = _prm(params, 0)
    b = o[0] * d[0] + o[1] * d[1] + o[2] * d[2]
    c = o[0] * o[0] + o[1] * o[1] + o[2] * o[2] - r * r
    disc = b * b - torch.clamp_min(sh["a3"], EPS) * c
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    return _valid_t((-b - sq) * sh["ra3"], disc > 0)


def _cylinder_t_inv(o, d, params, sh):
    r, hh = _prm(params, 0), _prm(params, 1)
    b = o[0] * d[0] + o[1] * d[1]
    c = o[0] * o[0] + o[1] * o[1] - r * r
    disc = b * b - torch.clamp_min(sh["a2"], EPS) * c
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    t_side = (-b - sq) * sh["ra2"]
    z_side = o[2] + t_side * d[2]
    t_best = _valid_t(t_side, (disc > 0) & (torch.abs(z_side) <= hh) & (sh["a2"] >= EPS))
    for sign in (-1.0, 1.0):
        t_c = (sign * hh - o[2]) * sh["rdz"]
        x = o[0] + t_c * d[0]
        y = o[1] + t_c * d[1]
        t_best = torch.minimum(t_best, _valid_t(t_c, x * x + y * y <= r * r))
    return t_best


def _cone_t_inv(o, d, params, sh):
    return _cone_t(o, d, params, rdz=sh["rdz"], a2=sh["a2"])


_KIND_FNS_INV = {
    assets.PLANE: _plane_t_inv,
    assets.SPHERE: _sphere_t_inv,
    assets.CYLINDER: _cylinder_t_inv,
    assets.CONE: _cone_t_inv,
}

# Classes whose world rotation is not guaranteed yaw-only.
_GENERAL_ROT_CLASSES = frozenset({"craneboom", "cranetelescopic", "human"})
CATEGORIES = ("inv", "aa_id", "aa_swap", "yaw", "axis", "gen")


def _transform_categories(roster: world_mod.Roster):
    """Static per-prim transform category, as in the JAX caster:

    * ``inv``  spheres, the ground plane, upright cylinders/cones on
      yaw-only instances: formulas use only z and rotation invariants, so
      world-frame o - pos and d feed them directly;
    * ``aa_id`` / ``aa_swap`` boxes of the static fence panels (yaw 0 or
      90: world components directly, or x/y swapped);
    * ``yaw``  identity-local boxes on yaw-only instances (2D rotation);
    * ``axis`` capsules of any orientation (axial/radial decomposition);
    * ``gen``  everything else (full local-frame transform).

    Returns {cat: [(kind, prim_idx_array), ...]}."""
    kinds = np.asarray(roster.prim_kind)
    prim_inst = np.asarray(roster.prim_inst)
    local_identity = np.abs(np.asarray(roster.prim_rot) - np.eye(3)).max(axis=(1, 2)) < 1e-6
    yaw_only = np.asarray([
        prim_inst[p] >= 0 and roster.inst_class_names[prim_inst[p]] not in _GENERAL_ROT_CLASSES
        for p in range(kinds.shape[0])])
    f0, f1 = roster.fence_slice
    fence_yaw = world_mod.fence_default_yaw_deg(f1 - f0)
    cat = np.empty(kinds.shape[0], dtype=object)
    for p in range(kinds.shape[0]):
        k, inst = kinds[p], prim_inst[p]
        if k == assets.SPHERE or (k == assets.PLANE and inst < 0):
            cat[p] = "inv"
        elif k in (assets.CYLINDER, assets.CONE) and local_identity[p] and yaw_only[p]:
            cat[p] = "inv"
        elif k == assets.BOX and local_identity[p] and f0 <= inst < f1:
            cat[p] = "aa_id" if fence_yaw[inst - f0] == 0.0 else "aa_swap"
        elif k == assets.BOX and local_identity[p] and yaw_only[p]:
            cat[p] = "yaw"
        elif k == assets.CAPSULE:
            cat[p] = "axis"
        else:
            cat[p] = "gen"
    out = {}
    for c in CATEGORIES:
        sel = np.nonzero(cat == c)[0]
        groups = [(int(k), sel[kinds[sel] == k]) for k in np.unique(kinds[sel])]
        out[c] = [(k, idx) for k, idx in groups if idx.size]
    return out


def _kind_groups(roster: world_mod.Roster, prim_mask=None):
    """[(kind, prim_idx_array), ...] in ``np.unique`` order of the kinds,
    keeping only the primitives where ``prim_mask`` holds."""
    kinds = np.asarray(roster.prim_kind)
    keep = np.ones(kinds.shape[0], bool) if prim_mask is None else np.asarray(prim_mask, bool)
    groups = [(int(k), np.nonzero((kinds == k) & keep)[0]) for k in np.unique(kinds)]
    return [(k, idx) for k, idx in groups if idx.size]


def _masked_categories(cats, prim_mask):
    """``cats`` keeping only the primitives where ``prim_mask`` (P,) holds,
    groups left empty dropped."""
    keep = np.asarray(prim_mask, bool)
    return {c: [(k, idx[keep[idx]]) for k, idx in lst if keep[idx].any()]
            for c, lst in cats.items()}


# The operation of a table row (csrc/raycast.cu's ``Op``): a kind's own
# number is its generic formula in the primitive's local frame (the exact
# and per-origin sweeps, and the packed sweep's "gen" category); the packed
# sweep's other categories have their own.
OP_INV = {assets.PLANE: 8, assets.SPHERE: 9, assets.CYLINDER: 10, assets.CONE: 11}
OP_AA_BOX = 12  # "aa_id", and "aa_swap" with the row's swap flag
OP_YAW_BOX = 13
OP_AXIS_CAPSULE = 14
_CATEGORY_OPS = {**{("inv", k): op for k, op in OP_INV.items()},
                 ("aa_id", assets.BOX): OP_AA_BOX, ("aa_swap", assets.BOX): OP_AA_BOX,
                 ("yaw", assets.BOX): OP_YAW_BOX, ("axis", assets.CAPSULE): OP_AXIS_CAPSULE}
# The assets kind of each operation, for the rows' bounding radii.
_OP_KIND = {**{k: k for k in _KIND_FNS}, **{op: k for k, op in OP_INV.items()},
            OP_AA_BOX: assets.BOX, OP_YAW_BOX: assets.BOX, OP_AXIS_CAPSULE: assets.CAPSULE}


def kind_radii(kinds: np.ndarray, params: np.ndarray) -> np.ndarray:
    """(n,) f32: the radius of the bounding sphere about its position of a
    primitive of each kind (``assets`` numbering) with its parameters (n,
    4); every kind is centred there, with half-height hh along its axis.
    -1 for a plane, which a cull always keeps. Widened by 1e-6 relative so
    that the f32 value is not below the exact one."""
    kinds, f = np.asarray(kinds), np.asarray(params, np.float64).reshape(-1, 4)
    rad = np.full(len(kinds), -1.0)
    sph, box = kinds == assets.SPHERE, kinds == assets.BOX
    cyl, cone, cap = kinds == assets.CYLINDER, kinds == assets.CONE, kinds == assets.CAPSULE
    rad[sph] = f[sph, 0]
    rad[cyl] = np.hypot(f[cyl, 0], f[cyl, 1])
    rad[cone] = np.hypot(np.maximum(f[cone, 0], f[cone, 1]), f[cone, 2])
    rad[box] = np.linalg.norm(f[box, :3], axis=1)
    rad[cap] = f[cap, 0] + f[cap, 1]
    return np.where(rad > 0, rad * (1.0 + 1e-6), rad).astype(np.float32)


def row_radii(rows: np.ndarray, prim_params: np.ndarray) -> np.ndarray:
    """(S,) f32: ``kind_radii`` of each table row (``rows`` (S, 4): op,
    primitive, ...) from the kind of its operation and its primitive's
    parameters (``prim_params`` (P, 4))."""
    rows = np.asarray(rows).reshape(-1, 4)
    kinds = np.asarray([_OP_KIND[int(op)] for op in rows[:, 0]], np.int64)
    return kind_radii(kinds, np.asarray(prim_params)[rows[:, 1]])


class SweepTable:
    """The rows a sweep walks: ``rows`` (S, 4) int32 [op, primitive, code
    (inst + 2), x/y swap], ``groups`` [(category, kind, slice of rows),
    ...], each group's rows contiguous, in the plain version's order, and
    ``radii`` (S,) f32, each row's ``row_radii`` from the primitives'
    parameters ``prim_params`` (P, 4). ``on(device)`` and
    ``radii_on(device)`` are ``rows`` and ``radii`` as tensors there
    (cached)."""

    def __init__(self, groups, codes: np.ndarray, prim_params: np.ndarray):
        rows, self.groups = [], []
        for cat, kind, op, idx in groups:
            s = len(rows)
            rows += [[op, int(p), int(codes[p]), int(cat == "aa_swap")] for p in idx]
            self.groups.append((cat, kind, slice(s, len(rows))))
        self.rows = np.asarray(rows, np.int32).reshape(-1, 4)
        self.radii = row_radii(self.rows, prim_params)
        self.ops = frozenset(self.rows[:, 0].tolist())
        self._on = {}

    def _tensor(self, name: str, device) -> Tensor:
        key = (name, str(device))
        if key not in self._on:
            self._on[key] = torch.as_tensor(getattr(self, name), device=device)
        return self._on[key]

    def on(self, device) -> Tensor:
        return self._tensor("rows", device)

    def radii_on(self, device) -> Tensor:
        return self._tensor("radii", device)


def packed_table(cats, codes: np.ndarray, prim_params: np.ndarray) -> SweepTable:
    """The packed sweep's table: categories in ``CATEGORIES`` order, kinds
    in ``np.unique`` order within each, ascending primitive index."""
    groups = []
    for cat in CATEGORIES:
        for kind, idx in cats[cat]:
            op = kind if cat == "gen" else _CATEGORY_OPS.get((cat, kind))
            if op is None:
                raise ValueError(f"no packed-sweep operation for {assets.KIND_NAMES[kind]} in "
                                 f"category {cat!r}")
            groups.append((cat, kind, op, idx))
    return SweepTable(groups, codes, prim_params)


def kind_table(groups, codes: np.ndarray, prim_params: np.ndarray) -> SweepTable:
    """The exact and per-origin sweeps' table: ``_kind_groups`` order, each
    row its kind's generic operation."""
    return SweepTable([("kind", k, k, idx) for k, idx in groups], codes, prim_params)


def axis_sums(table: SweepTable, world, ray_o: Tensor) -> Tensor | None:
    """(B, S, 2) f32: each (frame, row)'s c_2 . (ray_o - p) and |ray_o -
    p|^2 for ray_o (B, 3), the axial capsule's sums over three elements, by
    ``torch.sum``; None where the table has no axial capsule. Both versions
    of the packed walk take them as computed here, so that their order of
    summation is PyTorch's on either device."""
    if OP_AXIS_CAPSULE not in table.ops:
        return None
    prim = table.on(ray_o.device)[:, 1].long()
    rel = ray_o[:, None, :] - world["prim_pos"][:, prim]
    return torch.stack([torch.sum(rel * world["prim_rot"][:, prim, :, 2], -1),
                        torch.sum(rel * rel, -1)], dim=-1)


def _group(table: SweepTable, world, s: slice):
    """The rotations (B, g, 3, 3), positions (B, g, 3) and parameters (g,
    4) of the rows ``s``."""
    prim = table.on(world["prim_pos"].device)[s, 1].long()
    return world["prim_rot"][:, prim], world["prim_pos"][:, prim], world["prim_params"][prim]


def _split(v: Tensor):
    """(B, g, 3) -> its three (B, g, 1) components."""
    return tuple(v[..., j:j + 1] for j in range(3))


def _rotate(rot: Tensor, v, i: int) -> Tensor:
    """Local component i, c_i . v with c_i = R[:, i], of world vectors ``v``
    (three planes) in the frames of ``rot`` (B, g, 3, 3), summed as
    ``(R[0][i] v_0 + R[1][i] v_1) + R[2][i] v_2``."""
    return (rot[..., 0, i, None] * v[0] + rot[..., 1, i, None] * v[1]
            + rot[..., 2, i, None] * v[2])


def packed_sweep(table: SweepTable, world, ray_o: Tensor, ray_d: Tensor,
                 sums: Tensor | None) -> Tensor:
    """Plain packed walk of ``table``: rays from ray_o (B, 3) along ray_d
    (B, N, 3) -> (B, N) packed (t | inst + 2), INF-valued where nothing is
    hit; ``sums`` is ``axis_sums(table, world, ray_o)``. Each group as
    (B, g, N) planes."""
    B, N = ray_d.shape[:2]
    d = d0, d1, d2 = tuple(ray_d[..., i][:, None, :] for i in range(3))  # (B, 1, N)
    codes = table.on(ray_d.device)[:, 2]
    best = torch.full((B, N), INF, device=ray_d.device)
    if OP_AA_BOX in table.ops:
        rinv = tuple(1.0 / _safe(dc) for dc in d)
    if table.ops & set(OP_INV.values()):
        sh = _inv_shared(d)
    if OP_AXIS_CAPSULE in table.ops:
        dd = d0 * d0 + d1 * d1 + d2 * d2  # |d|^2, shared
        rdd = 1.0 / torch.clamp_min(dd, EPS)
        rod = ray_o[:, 0, None, None] * d0 + ray_o[:, 1, None, None] * d1 \
            + ray_o[:, 2, None, None] * d2
    for cat, kind, s in table.groups:
        rot, pos, prm = _group(table, world, s)
        rel = _split(ray_o[:, None, :] - pos)  # ray_o - p, (B, g, 1) each
        if cat in ("aa_id", "aa_swap"):
            perm = (0, 1, 2) if cat == "aa_id" else (1, 0, 2)
            tmin = tmax = None
            for la in range(3):
                wa = perm[la]
                h = _prm(prm, la)
                t1 = (-h - rel[wa]) * rinv[wa]
                t2 = (h - rel[wa]) * rinv[wa]
                lo, hi = torch.minimum(t1, t2), torch.maximum(t1, t2)
                tmin = lo if tmin is None else torch.maximum(tmin, lo)
                tmax = hi if tmax is None else torch.minimum(tmax, hi)
            t = _valid_t(tmin, (tmax >= tmin) & (tmax > 0))
        elif cat == "inv":
            t = _KIND_FNS_INV[kind](rel, d, prm, sh)
        elif cat == "yaw":
            c, sn = rot[..., 0, 0, None], rot[..., 1, 0, None]  # cos, sin of the yaw
            o = (c * rel[0] + sn * rel[1], -sn * rel[0] + c * rel[1], rel[2])
            t = _KIND_FNS[kind](o, (c * d0 + sn * d1, -sn * d0 + c * d1, d2), prm)
        elif cat == "axis":
            ax = tuple(rot[..., j, 2, None] for j in range(3))  # c_2, the capsule axis
            cc = _split(pos)
            oz, oo = sums[:, s, 0, None], sums[:, s, 1, None]
            r, hh = _prm(prm, 0), _prm(prm, 1)
            dz = ax[0] * d0 + ax[1] * d1 + ax[2] * d2
            od = rod - (cc[0] * d0 + cc[1] * d1 + cc[2] * d2)
            a2 = dd - dz * dz
            b2 = od - oz * dz
            c2 = oo - oz * oz - r * r
            a2_safe = torch.where(a2 < EPS, torch.full_like(a2, EPS), a2)
            disc2 = b2 * b2 - a2_safe * c2
            sq2 = torch.sqrt(torch.clamp_min(disc2, 0.0))
            t_side = (-b2 - sq2) / a2_safe
            z_side = oz + t_side * dz
            t = _valid_t(t_side, (disc2 > 0) & (torch.abs(z_side) <= hh) & (a2 >= EPS))
            for sign in (-1.0, 1.0):
                bs = od - (sign * hh) * dz
                cs = oo - (2.0 * sign) * hh * oz + hh * hh - r * r
                disc = bs * bs - dd * cs
                sq = torch.sqrt(torch.clamp_min(disc, 0.0))
                t = torch.minimum(t, _valid_t((-bs - sq) * rdd, disc > 0))
        else:  # gen
            o = tuple(_rotate(rot, rel, i) for i in range(3))
            t = _KIND_FNS[kind](o, tuple(_rotate(rot, d, i) for i in range(3)), prm)
        best = torch.minimum(best, torch.amin(_pack(t, codes[s][None, :, None]), dim=1))
    return best


def exact_sweep(table: SweepTable, world, ray_o: Tensor, ray_d: Tensor,
                exclude_inst: Tensor | None = None):
    """Plain exact walk of ``table`` for rays from ray_o (B, 3) along ray_d
    (B, N, 3): (t (B, N), prim index (B, N) int64), ``INF`` and -1 where
    nothing is hit. ``argmin`` within a kind group (first index on a tie),
    a strict ``<`` across groups. ``exclude_inst`` (B, N) leaves out the
    primitives of each ray's instance."""
    B, N = ray_d.shape[:2]
    dev = ray_d.device
    d = tuple(ray_d[..., i][:, None, :] for i in range(3))  # (B, 1, N)
    rows = table.on(dev)
    t_best = torch.full((B, N), INF, device=dev)
    idx_best = torch.full((B, N), -1, dtype=torch.int64, device=dev)
    for _, kind, s in table.groups:
        rot, pos, prm = _group(table, world, s)
        rel = _split(ray_o[:, None, :] - pos)
        o = tuple(_rotate(rot, rel, i) for i in range(3))
        t = _KIND_FNS[kind](o, tuple(_rotate(rot, d, i) for i in range(3)), prm)
        if exclude_inst is not None:
            same = (rows[s, 2] - 2)[None, :, None] == exclude_inst[:, None, :]
            t = torch.where(same, float(INF), t)
        g_min, g_arg = torch.min(t, dim=1)
        better = g_min < t_best
        t_best = torch.where(better, g_min, t_best)
        idx_best = torch.where(better, rows[s, 1].long()[g_arg], idx_best)
    return t_best, idx_best


def multi_sweep(table: SweepTable, world, ray_o: Tensor, ray_d: Tensor) -> Tensor:
    """Plain packed walk of ``table`` for rays with per-ray origins ray_o
    (B, N, 3) along ray_d (B, N, 3): (B, N) packed (t | inst + 2).
    Origins and directions both become (B, g, N) local planes."""
    o_w = tuple(ray_o[..., i][:, None, :] for i in range(3))  # (B, 1, N)
    d = tuple(ray_d[..., i][:, None, :] for i in range(3))
    codes = table.on(ray_d.device)[:, 2]
    best = torch.full(ray_d.shape[:2], INF, device=ray_d.device)
    for _, kind, s in table.groups:
        rot, pos, prm = _group(table, world, s)
        rel = tuple(o_w[j] - pos[..., j, None] for j in range(3))  # (B, g, N)
        o = tuple(_rotate(rot, rel, i) for i in range(3))
        t = _KIND_FNS[kind](o, tuple(_rotate(rot, d, i) for i in range(3)), prm)
        best = torch.minimum(best, torch.amin(_pack(t, codes[s][None, :, None]), dim=1))
    return best


def needed_rows(table: SweepTable, world, ray_o: Tensor, ray_d: Tensor) -> Tensor:
    """(B, N, S) bool: the half-line of each ray from ray_o (B, 3), or (B,
    N, 3) per ray, along ray_d (B, N, 3) meets the row's bounding sphere
    (``table.radii``; the ground plane always): the (ray, row) pairs any
    cull must keep, the work a walk needs. Directions need not be unit
    length."""
    dev = ray_d.device
    radii = table.radii_on(dev)
    o = ray_o[:, :, None] if ray_o.dim() == 3 else ray_o[:, None, None]
    v = world["prim_pos"][:, table.on(dev)[:, 1].long()][:, None] - o  # (B, N, S, 3)
    dd = torch.sum(ray_d * ray_d, -1, keepdim=True)
    tc = torch.sum(ray_d[:, :, None] * v, -1)
    vv = torch.sum(v * v, -1)
    r2 = radii * radii
    return ((tc > 0) & (vv * dd - tc * tc <= r2 * dd)) | (vv <= r2) | (radii < 0)


def _norm(v: Tensor) -> Tensor:
    return torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))


def _local_normal(kind: Tensor, ol: Tensor, dl: Tensor, t: Tensor, params: Tensor) -> Tensor:
    """Outward local-frame normal (..., 3) at the hit ol + t dl of each
    ray's own primitive (kind (...), params (..., P)), flipped against the
    local ray."""
    p = ol + t[..., None] * dl
    z = torch.zeros_like(p[..., 2])
    n_plane = torch.stack([z, z, torch.ones_like(z)], -1)
    n_sphere = p / torch.clamp_min(_norm(p), EPS)
    rel = p / torch.clamp_min(params[..., :3], EPS)
    ax = torch.argmax(torch.abs(rel), dim=-1, keepdim=True)
    n_box = torch.zeros_like(p).scatter_(-1, ax, 1.0) * torch.sign(torch.gather(rel, -1, ax))
    hh = params[..., 1]
    side = torch.abs(p[..., 2]) < hh - 1e-4
    radial = torch.stack([p[..., 0], p[..., 1], z], -1)
    radial = radial / torch.clamp_min(_norm(radial), EPS)
    cap = torch.stack([z, z, torch.sign(p[..., 2])], -1)
    n_cyl = torch.where(side[..., None], radial, cap)
    seg_z = torch.minimum(torch.maximum(p[..., 2], -hh), hh)
    n_capsule = p - torch.stack([z, z, seg_z], -1)
    n_capsule = n_capsule / torch.clamp_min(_norm(n_capsule), EPS)
    rb, rt, chh = params[..., 0], params[..., 1], params[..., 2]
    kslope = (rt - rb) / (2.0 * torch.clamp_min(chh, EPS))
    n_cone_side = torch.stack([radial[..., 0], radial[..., 1], -kslope], -1)
    n_cone_side = n_cone_side / torch.clamp_min(_norm(n_cone_side), EPS)
    on_cap = torch.abs(torch.abs(p[..., 2]) - chh) < 1e-4
    n_cone = torch.where(on_cap[..., None], cap, n_cone_side)
    k = kind[..., None]
    n = torch.where(k == assets.PLANE, n_plane,
        torch.where(k == assets.SPHERE, n_sphere,
        torch.where(k == assets.BOX, n_box,
        torch.where(k == assets.CYLINDER, n_cyl,
        torch.where(k == assets.CONE, n_cone, n_capsule)))))
    flip = torch.sum(n * dl, dim=-1, keepdim=True) > 0
    return torch.where(flip, -n, n)


def _blocks(n_frames: int, n_rays: int):
    """Ray slices of at most ``EXACT_RAYS`` rays over all frames."""
    step = max(1, EXACT_RAYS // max(n_frames, 1))
    return [slice(s, s + step) for s in range(0, n_rays, step)]


def _hits(packed: Tensor) -> Dict[str, Tensor]:
    """{t (B, N) with +inf on a miss, inst (B, N): -1 ground, -2 miss} of
    a packed sweep."""
    t, code = _unpack(packed)
    hit = t < INF * 0.99
    return {"t": torch.where(hit, t, torch.full_like(t, float("inf"))),
            "inst": torch.where(hit, code, torch.zeros_like(code)) - 2}


class Raycaster:
    """The casters of a fixed roster (``make_raycaster`` in the JAX
    package): ``fast`` / ``packed`` (the packed sweep over the transform
    categories), ``cast`` (the exact sweep with analytic normals) and
    ``fast_multi_origin`` (packed, per-ray origins), each by its plain
    walk (``plain_packed``, ``plain_cast``, ``plain_multi_origin``).
    ``chunk`` bounds the rays a frame sweeps at once in ``plain_packed``;
    ``prim_mask`` (P,) bool keeps only the primitives where it holds (the
    hifi tier leaves out the proxies its meshes replace)."""

    def __init__(self, roster: world_mod.Roster, chunk: int = 65536,
                 prim_mask: np.ndarray | None = None):
        self.roster = roster
        self.cats = _transform_categories(roster)
        self.groups = _kind_groups(roster, prim_mask)
        if prim_mask is not None:
            self.cats = _masked_categories(self.cats, prim_mask)
        self.chunk = chunk
        codes = np.asarray(roster.prim_inst) + 2
        if codes.max() > _PAYLOAD_MASK:
            raise ValueError(f"{codes.max()} instance codes exceed the {_PAYLOAD_BITS}-bit "
                             "payload; split the roster")
        self.prim_codes = codes.astype(np.int32)
        params = np.asarray(roster.prim_params)
        self.packed_table = packed_table(self.cats, self.prim_codes, params)
        self.kind_table = kind_table(self.groups, self.prim_codes, params)

    def frame_world(self, world: Dict[str, Tensor], cam_pos: Tensor) -> Dict[str, Tensor]:
        """The world that a render from cam_pos (B, 3) sweeps
        (``annotate.render_frame``): the analytic caster's needs nothing
        more; ``meshcast.HifiCaster`` adds its meshes' terms for that
        camera."""
        return world

    def packed(self, world: Dict[str, Tensor], ray_o: Tensor, ray_d: Tensor) -> Tensor:
        """(B, N) packed nearest hit of rays from ray_o (B, 3) along ray_d
        (B, N, 3)."""
        return self.plain_packed(world, ray_o, ray_d)

    def plain_packed(self, world: Dict[str, Tensor], ray_o: Tensor, ray_d: Tensor) -> Tensor:
        """``packed`` by its plain version, on any device."""
        sums = axis_sums(self.packed_table, world, ray_o)
        return torch.cat([packed_sweep(self.packed_table, world, ray_o,
                                       ray_d[:, s:s + self.chunk], sums)
                          for s in range(0, ray_d.shape[1], self.chunk)], dim=1)

    def fast(self, world: Dict[str, Tensor], ray_o: Tensor, ray_d: Tensor) -> Dict[str, Tensor]:
        """{t (B, N) with +inf on a miss, inst (B, N): -1 ground, -2 miss}."""
        return _hits(self.packed(world, ray_o, ray_d))

    def cast(self, world: Dict[str, Tensor], ray_o: Tensor, ray_d: Tensor) -> Dict[str, Tensor]:
        """The exact sweep of rays from ray_o (B, 3) along ray_d (B, N, 3):
        {t (B, N) exact, +inf on a miss; prim (B, N), -1 on a miss; inst
        (B, N), -2 on a miss; normal (B, N, 3) world frame, 0 on a miss}."""
        return self.plain_cast(world, ray_o, ray_d)

    def plain_cast(self, world: Dict[str, Tensor], ray_o: Tensor,
                   ray_d: Tensor) -> Dict[str, Tensor]:
        """``cast`` by its plain version, on any device, ``EXACT_RAYS`` rays
        at a time."""
        prim_inst = self.roster.tensor("prim_inst", ray_d.device).long()
        kinds = self.roster.tensor("prim_kind", ray_d.device)
        out = {"t": [], "prim": [], "inst": [], "normal": []}
        for s in _blocks(*ray_d.shape[:2]):
            rd = ray_d[:, s]
            t, idx = exact_sweep(self.kind_table, world, ray_o, rd)
            hit = t < INF
            safe = torch.clamp_min(idx, 0)
            frame = torch.arange(rd.shape[0], device=rd.device)[:, None]
            rot = world["prim_rot"][frame, safe]  # (B, n, 3, 3)
            rel = ray_o[:, None, :] - world["prim_pos"][frame, safe]
            ol = (rot[..., 0, :] * rel[..., 0:1] + rot[..., 1, :] * rel[..., 1:2]
                  + rot[..., 2, :] * rel[..., 2:3])
            dl = (rot[..., 0, :] * rd[..., 0:1] + rot[..., 1, :] * rd[..., 1:2]
                  + rot[..., 2, :] * rd[..., 2:3])
            nl = _local_normal(kinds[safe], ol, dl, t, world["prim_params"][safe])
            normal = (rot[..., :, 0] * nl[..., 0:1] + rot[..., :, 1] * nl[..., 1:2]
                      + rot[..., :, 2] * nl[..., 2:3])
            out["t"].append(torch.where(hit, t, float("inf")))
            out["prim"].append(torch.where(hit, idx, -1))
            out["inst"].append(torch.where(hit, prim_inst[safe], -2).to(torch.int32))
            out["normal"].append(torch.where(hit[..., None], normal, 0.0))
        return {k: torch.cat(v, dim=1) for k, v in out.items()}

    def fast_multi_origin(self, world: Dict[str, Tensor], ray_o: Tensor,
                          ray_d: Tensor) -> Dict[str, Tensor]:
        """Packed sweep of rays with per-ray origins ray_o (B, N, 3) along
        ray_d (B, N, 3) over the kind groups: {t (B, N) with +inf on a
        miss, inst (B, N): -1 ground, -2 miss}."""
        return self.plain_multi_origin(world, ray_o, ray_d)

    def plain_multi_origin(self, world: Dict[str, Tensor], ray_o: Tensor,
                           ray_d: Tensor) -> Dict[str, Tensor]:
        """``fast_multi_origin`` by its plain version, on any device,
        ``EXACT_RAYS`` rays at a time."""
        return _hits(torch.cat([multi_sweep(self.kind_table, world, ray_o[:, s], ray_d[:, s])
                                for s in _blocks(*ray_d.shape[:2])], dim=1))


