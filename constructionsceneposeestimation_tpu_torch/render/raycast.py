"""Packed analytic ray casting on tensors (port of the packed fast caster
of the JAX ``render/raycast.py``).

Every scene object is a set of closed-form primitives, so a render is a
dense [prims x rays] intersection sweep. The fast path steals the low 6
mantissa bits of t for an id payload (instance + 2), so one min-reduction
yields depth and instance together; IEEE ordering of positive floats makes
the packed min exact (relative depth error <= 2^-18).

Primitives are grouped by static transform category
(``_transform_categories``) so each formula runs on exactly its own
primitives, as (B, g, N) planes: frames, primitives of the group, rays.
All formulas stay valid for unnormalized directions: the keypoint-occlusion
segments cast raw cam -> keypoint vectors. This caster is the plain version
of the pixel-sweep kernel (render/sweep_kernel.py) and the caster of the
occlusion segments.

The exact path (``Raycaster.cast``, JAX ``make_raycaster``'s ``cast``) is
the generic sweep: every primitive in its own local frame, grouped by kind
in ``np.unique`` order, ``argmin`` within a group (the first index wins a
tie) and a strict ``<`` across groups; then the winner's analytic normal
(``_local_normal``). ``Raycaster.fast_multi_origin`` is the packed sweep of
rays with per-ray origins (the sun-shadow rays) over the same kind groups.
Both are PyTorch, as in the JAX package (``jnp``, outside any Pallas
kernel), and sweep at most ``EXACT_RAYS`` rays at once, so their
(B, g, rays) planes stay a few hundred MB at any batch.

``occlusion_ts`` is the generic t sweep with a per-ray excluded instance:
the nearest hit of any other instance.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..scene import assets, world as world_mod

Tensor = torch.Tensor

INF = np.float32(1e10)
EPS = 1e-7
EXACT_RAYS = 1 << 20  # rays the exact and the per-origin sweeps hold at once
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
    return params[:, k].reshape(1, -1, 1)


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


def _comp(v: Tensor, i: int) -> Tensor:
    return v[..., i:i + 1]


def _to_local(rot: Tensor, v: Tensor, i: int) -> Tensor:
    """Local component i of world vectors: sum_j rot[..., j, i] v_j, for
    rot (B, g, 3, 3) against v (B, g, N) planes or (B, g, 1) columns given
    as a 3-tuple."""
    return (rot[..., 0, i, None] * v[0] + rot[..., 1, i, None] * v[1]
            + rot[..., 2, i, None] * v[2])


def _sweep_packed_fast(cats, world, prim_codes: Tensor, ray_o: Tensor, ray_d: Tensor) -> Tensor:
    """Packed min over every primitive: ray_o (B, 3), ray_d (B, N, 3) ->
    (B, N) packed (t | inst + 2); INF-valued where nothing is hit."""
    prim_rot, prim_pos, params = world["prim_rot"], world["prim_pos"], world["prim_params"]
    B, N = ray_d.shape[:2]
    d0, d1, d2 = (ray_d[..., i][:, None, :] for i in range(3))  # (B, 1, N)
    best = torch.full((B, N), INF, device=ray_d.device)

    def merge(best, t, idx):
        return torch.minimum(best, torch.amin(_pack(t, prim_codes[idx][None, :, None]), dim=1))

    if cats["aa_id"] or cats["aa_swap"]:
        rinv = tuple(1.0 / _safe(dc) for dc in (d0, d1, d2))
        for cat_name, perm in (("aa_id", (0, 1, 2)), ("aa_swap", (1, 0, 2))):
            for kind, idx in cats[cat_name]:
                rel = ray_o[:, None, :] - prim_pos[:, idx]  # (B, g, 3)
                prm = params[idx]
                tmin = tmax = None
                for la in range(3):
                    wa = perm[la]
                    h = _prm(prm, la)
                    t1 = (-h - _comp(rel, wa)) * rinv[wa]
                    t2 = (h - _comp(rel, wa)) * rinv[wa]
                    lo, hi = torch.minimum(t1, t2), torch.maximum(t1, t2)
                    tmin = lo if tmin is None else torch.maximum(tmin, lo)
                    tmax = hi if tmax is None else torch.minimum(tmax, hi)
                best = merge(best, _valid_t(tmin, (tmax >= tmin) & (tmax > 0)), idx)
    if cats["inv"]:
        sh = _inv_shared((d0, d1, d2))
        for kind, idx in cats["inv"]:
            rel = ray_o[:, None, :] - prim_pos[:, idx]
            o = (_comp(rel, 0), _comp(rel, 1), _comp(rel, 2))
            best = merge(best, _KIND_FNS_INV[kind](o, (d0, d1, d2), params[idx], sh), idx)
    for kind, idx in cats["yaw"]:
        rot = prim_rot[:, idx]
        c = rot[..., 0, 0][..., None]  # cos(yaw)
        s = rot[..., 1, 0][..., None]  # sin(yaw)
        rel = ray_o[:, None, :] - prim_pos[:, idx]
        o = (c * _comp(rel, 0) + s * _comp(rel, 1), -s * _comp(rel, 0) + c * _comp(rel, 1),
             _comp(rel, 2))
        d = (c * d0 + s * d1, -s * d0 + c * d1, d2)
        best = merge(best, _KIND_FNS[kind](o, d, params[idx]), idx)
    if cats["axis"]:
        dd = d0 * d0 + d1 * d1 + d2 * d2  # |d|^2, shared
        rdd = 1.0 / torch.clamp_min(dd, EPS)
        rod = ray_o[:, 0, None, None] * d0 + ray_o[:, 1, None, None] * d1 \
            + ray_o[:, 2, None, None] * d2
        for kind, idx in cats["axis"]:
            ax = prim_rot[:, idx][..., :, 2]  # (B, g, 3) capsule axis
            cc = prim_pos[:, idx]
            rel = ray_o[:, None, :] - cc
            r, hh = _prm(params[idx], 0), _prm(params[idx], 1)
            oz = torch.sum(rel * ax, -1, keepdim=True)
            oo = torch.sum(rel * rel, -1, keepdim=True)
            dz = _comp(ax, 0) * d0 + _comp(ax, 1) * d1 + _comp(ax, 2) * d2
            od = rod - (_comp(cc, 0) * d0 + _comp(cc, 1) * d1 + _comp(cc, 2) * d2)
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
            best = merge(best, t, idx)
    for kind, idx in cats["gen"]:
        rot = prim_rot[:, idx]  # (B, g, 3, 3)
        rel = ray_o[:, None, :] - prim_pos[:, idx]
        rel = tuple(rel[..., j:j + 1] for j in range(3))
        o = tuple(_to_local(rot, rel, i) for i in range(3))
        d = tuple(_to_local(rot, (d0, d1, d2), i) for i in range(3))
        best = merge(best, _KIND_FNS[kind](o, d, params[idx]), idx)
    return best


def _kind_groups(roster: world_mod.Roster, prim_mask=None):
    """[(kind, prim_idx_array), ...] in ``np.unique`` order of the kinds,
    keeping only the primitives where ``prim_mask`` holds."""
    kinds = np.asarray(roster.prim_kind)
    keep = np.ones(kinds.shape[0], bool) if prim_mask is None else np.asarray(prim_mask, bool)
    groups = [(int(k), np.nonzero((kinds == k) & keep)[0]) for k in np.unique(kinds)]
    return [(k, idx) for k, idx in groups if idx.size]


def _sweep(groups, world, ray_o: Tensor, ray_d: Tensor, exclude_inst: Tensor | None = None,
           prim_inst: Tensor | None = None):
    """The generic sweep of rays from ray_o (B, 3) along ray_d (B, N, 3):
    (t (B, N), prim index (B, N), -1 and ``INF`` where nothing is hit).
    Each kind group in its own frames; ``argmin`` within a group (first
    index on a tie), a strict ``<`` across groups. ``exclude_inst`` (B, N)
    leaves out the primitives of each ray's instance."""
    rot, pos, params = world["prim_rot"], world["prim_pos"], world["prim_params"]
    B, N = ray_d.shape[:2]
    dev = ray_d.device
    d = tuple(ray_d[..., i][:, None, :] for i in range(3))  # (B, 1, N)
    t_best = torch.full((B, N), INF, device=dev)
    idx_best = torch.full((B, N), -1, dtype=torch.int64, device=dev)
    for kind, idx in groups:
        r = rot[:, idx]  # (B, g, 3, 3)
        rel = ray_o[:, None, :] - pos[:, idx]  # (B, g, 3)
        rel = tuple(rel[..., j:j + 1] for j in range(3))
        o = tuple(_to_local(r, rel, i) for i in range(3))  # (B, g, 1)
        dl = tuple(_to_local(r, d, i) for i in range(3))  # (B, g, N)
        t = _KIND_FNS[kind](o, dl, params[idx])
        if exclude_inst is not None:
            same = prim_inst[idx][None, :, None] == exclude_inst[:, None, :]
            t = torch.where(same, float(INF), t)
        g_min, g_arg = torch.min(t, dim=1)
        better = g_min < t_best
        t_best = torch.where(better, g_min, t_best)
        idx_best = torch.where(better, torch.as_tensor(idx, device=dev)[g_arg], idx_best)
    return t_best, idx_best


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


def _sweep_packed_multi(groups, world, prim_codes: Tensor, ray_o: Tensor,
                        ray_d: Tensor) -> Tensor:
    """Packed min over the kind groups of rays with per-ray origins:
    ray_o, ray_d (B, N, 3) -> (B, N) packed (t | inst + 2). Origins and
    directions both become (B, g, N) local planes, in the JAX package's
    f32 operation order."""
    rot, pos, params = world["prim_rot"], world["prim_pos"], world["prim_params"]
    o_w = tuple(ray_o[..., i][:, None, :] for i in range(3))  # (B, 1, N)
    d = tuple(ray_d[..., i][:, None, :] for i in range(3))
    best = torch.full(ray_d.shape[:2], INF, device=ray_d.device)
    for kind, idx in groups:
        r = rot[:, idx]
        rel = tuple(o_w[j] - pos[:, idx, j, None] for j in range(3))  # (B, g, N)
        o = tuple(_to_local(r, rel, i) for i in range(3))
        dl = tuple(_to_local(r, d, i) for i in range(3))
        t = _KIND_FNS[kind](o, dl, params[idx])
        best = torch.minimum(best, torch.amin(_pack(t, prim_codes[idx][None, :, None]), dim=1))
    return best


def _blocks(n_frames: int, n_rays: int):
    """Ray slices of at most ``EXACT_RAYS`` rays over all frames."""
    step = max(1, EXACT_RAYS // max(n_frames, 1))
    return [slice(s, s + step) for s in range(0, n_rays, step)]


def _masked_categories(cats, prim_mask):
    """``cats`` keeping only the primitives where ``prim_mask`` (P,) holds,
    groups left empty dropped."""
    keep = np.asarray(prim_mask, bool)
    return {c: [(k, idx[keep[idx]]) for k, idx in lst if keep[idx].any()]
            for c, lst in cats.items()}


class Raycaster:
    """The casters of a fixed roster (``make_raycaster`` in the JAX
    package): ``fast`` (the packed sweep over the transform categories),
    ``cast`` (the exact sweep with analytic normals) and
    ``fast_multi_origin`` (packed, per-ray origins). ``chunk`` bounds the
    rays a frame sweeps at once in ``fast``; ``prim_mask`` (P,) bool keeps
    only the primitives where it holds (the hifi tier leaves out the
    proxies its meshes replace)."""

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

    def packed(self, world: Dict[str, Tensor], ray_o: Tensor, ray_d: Tensor) -> Tensor:
        """(B, N) packed nearest hit of rays from ray_o (B, 3) along ray_d
        (B, N, 3)."""
        codes = torch.as_tensor(self.prim_codes, device=ray_d.device)
        parts = [_sweep_packed_fast(self.cats, world, codes, ray_o, ray_d[:, s:s + self.chunk])
                 for s in range(0, ray_d.shape[1], self.chunk)]
        return torch.cat(parts, dim=1)

    def fast(self, world: Dict[str, Tensor], ray_o: Tensor, ray_d: Tensor) -> Dict[str, Tensor]:
        """{t (B, N) with +inf on a miss, inst (B, N): -1 ground, -2 miss}."""
        t, code = _unpack(self.packed(world, ray_o, ray_d))
        hit = t < INF * 0.99
        return {"t": torch.where(hit, t, torch.full_like(t, float("inf"))),
                "inst": torch.where(hit, code, torch.zeros_like(code)) - 2}

    def cast(self, world: Dict[str, Tensor], ray_o: Tensor, ray_d: Tensor) -> Dict[str, Tensor]:
        """The exact sweep of rays from ray_o (B, 3) along ray_d (B, N, 3):
        {t (B, N) exact, +inf on a miss; prim (B, N), -1 on a miss; inst
        (B, N), -2 on a miss; normal (B, N, 3) world frame, 0 on a miss}."""
        prim_inst = self.roster.tensor("prim_inst", ray_d.device).long()
        kinds = self.roster.tensor("prim_kind", ray_d.device)
        out = {"t": [], "prim": [], "inst": [], "normal": []}
        for s in _blocks(*ray_d.shape[:2]):
            rd = ray_d[:, s]
            t, idx = _sweep(self.groups, world, ray_o, rd)
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
        codes = torch.as_tensor(self.prim_codes, device=ray_d.device)
        packed = torch.cat([_sweep_packed_multi(self.groups, world, codes, ray_o[:, s],
                                                ray_d[:, s])
                            for s in _blocks(*ray_d.shape[:2])], dim=1)
        t, code = _unpack(packed)
        hit = t < INF * 0.99
        return {"t": torch.where(hit, t, torch.full_like(t, float("inf"))),
                "inst": torch.where(hit, code, torch.zeros_like(code)) - 2}


def occlusion_ts(world: Dict[str, Tensor], roster: world_mod.Roster, ray_o: Tensor,
                 ray_d: Tensor, exclude_inst: Tensor) -> Tensor:
    """Nearest hit distance (B, N) of rays from ray_o (B, 3) along ray_d
    (B, N, 3), ignoring the primitives of instance ``exclude_inst`` (B, N)
    of each ray; ``INF`` where nothing else is hit. ``ray_d`` need not be
    unit: pass keypoint - camera, and t is in units of it (a keypoint is
    occluded iff t < 1)."""
    prim_inst = torch.as_tensor(np.asarray(roster.prim_inst), device=ray_d.device)
    return _sweep(_kind_groups(roster), world, ray_o, ray_d, exclude_inst, prim_inst)[0]
