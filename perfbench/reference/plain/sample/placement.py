"""Object-placement domain randomization (port of the JAX
``sample/placement.py``), batched over scene groups.

The reference's invariants hold: placement order crane -> dumpers ->
humans -> cones; sum-of-radii collision against everything already placed;
fence containment with margin; a fixed 80-candidate draw with first-valid
selection and a clamped fallback near the centre (whose ``ok`` flag records
the overlap risk); dumpers try 7 shuffled candidate areas before falling
back to area 0 with a widened range; the crane never yaws.

Sampling is two steps: ``scene_draws`` takes every uniform a scene needs
from one ``torch.Generator`` (on the host), and ``randomize_scene`` runs the
masked rejection logic on tensors of draws stacked over groups (on any
device). Sequence mode's endpoint B (``resample_draws``,
``resample_animated``) re-runs only the animated samplers the same way.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from ..config import RandomizationConfig, SceneConfig
from ..scene import assets, kinematics, world as world_mod

Tensor = torch.Tensor

_INACTIVE_R = -1e9  # placed-slot radius that any candidate clears
_N_AREAS = 7


def scene_draws(gen: torch.Generator, scene_cfg: SceneConfig = SceneConfig(),
                cfg: RandomizationConfig = RandomizationConfig()) -> Dict[str, Tensor]:
    """Every uniform one scene consumes, in a fixed order, in [0, 1). The
    dumper area order is a permutation stored as float (exact small ints)."""
    A = cfg.max_attempts
    nd, nh, nc = scene_cfg.n_dumpers, scene_cfg.n_humans, scene_cfg.n_cones
    r = lambda *s: torch.rand(*s, generator=gen)
    return {
        "crane_joints": r(3),
        "crane_cand": r(A, 2),
        "crane_fb": r(2),
        "dumper_perm": torch.stack([torch.randperm(_N_AREAS, generator=gen)
                                    for _ in range(nd)]).float()
        if nd else torch.zeros(0, _N_AREAS),
        "dumper_cand": r(nd, _N_AREAS + 1, A, 2),
        "dumper_fb": r(nd, _N_AREAS + 1, 2),
        "dumper_yaw": r(nd),
        "human_center": r(nh, 2),
        "human_cand": r(nh, A, 2),
        "human_fb": r(nh, 2),
        "human_yaw": r(nh),
        "human_pose": r(nh, 10),
        "cone_center": r(nc, 2),
        "cone_cand": r(nc, A, 2),
        "cone_fb": r(nc, 2),
        "cone_yaw": r(nc),
    }


def stack_draws(draws: List[Dict[str, Tensor]]) -> Dict[str, Tensor]:
    """Per-group draw dicts -> one dict of (G, ...) tensors."""
    return {k: torch.stack([d[k] for d in draws]) for k in draws[0]}


def _sym(u: Tensor) -> Tensor:
    """[0, 1) -> [-1, 1)."""
    return u * 2.0 - 1.0


def _find_valid_position(u_cand: Tensor, u_fb: Tensor, center: Tensor, half_range,
                         own_radius: Tensor, placed_xy: Tensor, placed_r: Tensor,
                         cfg: RandomizationConfig, margin: float) -> Tuple[Tensor, Tensor]:
    """First valid of the candidates ``center + U(-1, 1) * half_range``,
    else the clamped fallback ``center + U(-1, 1)``. Shapes: u_cand
    (..., A, 2), u_fb (..., 2), center (..., 2), own_radius (...,),
    placed_xy (..., M, 2), placed_r (..., M). Returns (xy (..., 2), ok)."""
    cand = center[..., None, :] + _sym(u_cand) * half_range
    x, y = cand[..., 0], cand[..., 1]
    in_fence = ((x >= cfg.fence_x[0] + margin) & (x <= cfg.fence_x[1] - margin)
                & (y >= cfg.fence_y[0] + margin) & (y <= cfg.fence_y[1] - margin))
    d = torch.linalg.norm(cand[..., :, None, :] - placed_xy[..., None, :, :], dim=-1)
    no_overlap = torch.all(d >= own_radius[..., None, None] + placed_r[..., None, :], dim=-1)
    ok = in_fence & no_overlap
    any_ok = torch.any(ok, dim=-1)
    first = torch.argmax(ok.to(torch.int32), dim=-1)  # first True
    chosen = torch.gather(cand, -2, first[..., None, None].expand(first.shape + (1, 2)))[..., 0, :]
    fb = center + _sym(u_fb)
    fb = torch.stack([torch.clamp(fb[..., 0], cfg.fence_x[0] + margin, cfg.fence_x[1] - margin),
                      torch.clamp(fb[..., 1], cfg.fence_y[0] + margin, cfg.fence_y[1] - margin)],
                     dim=-1)
    return torch.where(any_ok[..., None], chosen, fb), any_ok


def _place_sequential(d, prefix, n, placed_xy, placed_r, slot, radius, half_range,
                      margin, center_range, cfg):
    """Humans or cones, one at a time against everything placed so far."""
    G = placed_xy.shape[0]
    xys, yaws, oks = [], [], []
    rad = torch.full((G,), radius, device=placed_xy.device)
    for i in range(n):
        center = _sym(d[f"{prefix}_center"][:, i]) * center_range
        xy, ok = _find_valid_position(d[f"{prefix}_cand"][:, i], d[f"{prefix}_fb"][:, i],
                                      center, half_range, rad, placed_xy, placed_r, cfg,
                                      margin)
        placed_xy = placed_xy.clone()
        placed_r = placed_r.clone()
        placed_xy[:, slot] = xy
        placed_r[:, slot] = radius
        slot += 1
        xys.append(xy)
        yaws.append(_sym(d[f"{prefix}_yaw"][:, i]) * 180.0)
        oks.append(ok)
    empty = placed_xy.new_zeros((G, 0))
    return (placed_xy, placed_r, slot,
            torch.stack(xys, 1) if n else placed_xy.new_zeros((G, 0, 2)),
            torch.stack(yaws, 1) if n else empty,
            torch.stack(oks, 1) if n else empty.bool())


def randomize_scene(d: Dict[str, Tensor], roster: world_mod.Roster,
                    scene_cfg: SceneConfig = SceneConfig(),
                    cfg: RandomizationConfig = RandomizationConfig(),
                    articulate_crane: bool = False,
                    articulate_humans: bool = True):
    """Draws stacked over G groups (``stack_draws``) -> (ScenePose with
    leading G, diagnostics)."""
    dev = d["crane_cand"].device
    G = d["crane_cand"].shape[0]
    nd, nh, nc = scene_cfg.n_dumpers, scene_cfg.n_humans, scene_cfg.n_cones
    M = 1 + nd + nh + nc
    margin = cfg.fence_margin
    placed_xy = torch.zeros(G, M, 2, device=dev)
    placed_r = torch.full((G, M), _INACTIVE_R, device=dev)

    # Crane.
    low = torch.as_tensor(kinematics.CRANE_JOINT_LOW, device=dev)
    high = torch.as_tensor(kinematics.CRANE_JOINT_HIGH, device=dev)
    if articulate_crane:
        joints = low + d["crane_joints"] * (high - low)
    else:
        joints = torch.as_tensor(kinematics.DEFAULT_CRANE_JOINTS, device=dev).expand(G, 3)
    crane_radius = torch.clamp_min(kinematics.crane_reach_xy(joints) * 0.9, cfg.crane_min_radius)
    crane_xy, crane_ok = _find_valid_position(
        d["crane_cand"], d["crane_fb"], torch.zeros(G, 2, device=dev), cfg.crane_range,
        crane_radius, placed_xy, placed_r, cfg, margin)
    placed_xy[:, 0] = crane_xy
    placed_r[:, 0] = crane_radius
    slot = 1

    # Dumpers: 7 shuffled areas, the first valid one wins, else area 0 with
    # a widened range.
    areas = torch.tensor(cfg.dumper_areas, dtype=torch.float32, device=dev)
    dumper_radius = float(max(cfg.dumper_min_radius, 2.5))
    dumper_xy, dumper_yaw, dumper_oks = [], [], []
    for i in range(nd):
        perm = d["dumper_perm"][:, i].long()  # (G, 7)
        rad = torch.full((G, _N_AREAS), dumper_radius, device=dev)
        area_xy, area_ok = _find_valid_position(
            d["dumper_cand"][:, i, :_N_AREAS], d["dumper_fb"][:, i, :_N_AREAS], areas[perm],
            cfg.dumper_range, rad, placed_xy[:, None].expand(-1, _N_AREAS, -1, -1),
            placed_r[:, None].expand(-1, _N_AREAS, -1), cfg, margin)
        any_area = torch.any(area_ok, dim=-1)
        first = torch.argmax(area_ok.to(torch.int32), dim=-1)
        fb_xy, fb_ok = _find_valid_position(
            d["dumper_cand"][:, i, _N_AREAS], d["dumper_fb"][:, i, _N_AREAS],
            areas[0].expand(G, 2), 3.0, rad[:, 0], placed_xy, placed_r, cfg, margin)
        xy = torch.where(any_area[:, None], area_xy[torch.arange(G, device=dev), first], fb_xy)
        placed_xy = placed_xy.clone()
        placed_r = placed_r.clone()
        placed_xy[:, slot] = xy
        placed_r[:, slot] = dumper_radius
        slot += 1
        dumper_xy.append(xy)
        dumper_yaw.append(_sym(d["dumper_yaw"][:, i]) * 180.0)
        dumper_oks.append(any_area | fb_ok)
    dumper_ok = torch.stack(dumper_oks, 1).all(1) if nd else torch.ones(G, dtype=torch.bool,
                                                                         device=dev)
    if nd:
        dumper_xy, dumper_yaw = torch.stack(dumper_xy, 1), torch.stack(dumper_yaw, 1)

    placed_xy, placed_r, slot, human_xy, human_yaw, human_ok = _place_sequential(
        d, "human", nh, placed_xy, placed_r, slot, cfg.human_radius, cfg.human_range,
        margin, 7.0, cfg)
    placed_xy, placed_r, slot, cone_xy, cone_yaw, cone_ok = _place_sequential(
        d, "cone", nc, placed_xy, placed_r, slot, cfg.cone_radius, cfg.cone_range,
        cfg.cone_fence_margin, cfg.cone_center_range, cfg)

    # Assemble over the roster; trees and fence keep the default layout.
    pos0, yaw0 = world_mod.default_layout(roster, scene_cfg)
    positions = torch.as_tensor(pos0, device=dev).expand(G, -1, -1).clone()
    yaw = torch.as_tensor(yaw0, device=dev).expand(G, -1).clone()
    for (s0, s1), xy, yw, n in ((roster.dumper_slice, dumper_xy, dumper_yaw, nd),
                                (roster.human_slice, human_xy, human_yaw, nh),
                                (roster.cone_slice, cone_xy, cone_yaw, nc)):
        if n:
            positions[:, s0:s1, :2] = xy
            yaw[:, s0:s1] = yw

    human_joints = None
    if nh:
        canonical = torch.as_tensor(assets.CANONICAL_COCO, device=dev)
        if articulate_humans:
            human_joints = kinematics.pose_human_joints(
                canonical, kinematics.sample_human_pose(d["human_pose"]))
        else:
            human_joints = canonical.expand(G, nh, 17, 3).clone()

    pose = world_mod.ScenePose(
        crane_pos=torch.cat([crane_xy, torch.zeros(G, 1, device=dev)], dim=-1),
        crane_yaw_deg=torch.zeros(G, device=dev),  # the crane never yaws
        crane_joints=joints.clone(),
        positions=positions,
        yaw_deg=yaw,
        human_joints=human_joints,
    )
    diag = {"crane_ok": crane_ok, "dumper_ok": dumper_ok, "human_ok": human_ok,
            "cone_ok": cone_ok, "placed_xy": placed_xy, "placed_r": placed_r,
            "crane_radius": crane_radius}
    return pose, diag


def resample_draws(gen: torch.Generator, scene_cfg: SceneConfig = SceneConfig(),
                   cfg: RandomizationConfig = RandomizationConfig()) -> Dict[str, Tensor]:
    """Every uniform ``resample_animated`` consumes, in [0, 1): the crane's
    joints and the humans' placement, yaw and body pose, keyed as in
    ``scene_draws``."""
    A, nh = cfg.max_attempts, scene_cfg.n_humans
    r = lambda *s: torch.rand(*s, generator=gen)
    return {"crane_joints": r(3), "human_center": r(nh, 2), "human_cand": r(nh, A, 2),
            "human_fb": r(nh, 2), "human_yaw": r(nh), "human_pose": r(nh, 10)}


def resample_animated(d: Dict[str, Tensor], roster: world_mod.Roster,
                      scene_cfg: SceneConfig, cfg: RandomizationConfig,
                      base_pose: world_mod.ScenePose, base_diag: Dict[str, Tensor]):
    """Endpoint B of a clip, over G groups: draws ``d`` (``resample_draws``
    stacked) re-sample only the animated degrees of freedom (the crane's
    articulation; the humans' placement, yaw and body pose) and keep the
    base scene's static layout. The humans are placed against the base
    scene's placed obstacles, so an interpolated worker never walks through
    a dumper, cone or the crane. The crane's slot is widened to the larger
    reach of the two articulations, since the boom sweeps between them over
    the clip; the base humans' slots are deactivated first, and each new
    placement takes its slot again, so B's humans avoid one another.
    Returns (ScenePose, {"human_ok": (G, n_humans)}): False marks the
    clamped fallback, which is not clearance-guaranteed."""
    dev = d["crane_joints"].device
    nh = scene_cfg.n_humans
    low = torch.as_tensor(kinematics.CRANE_JOINT_LOW, device=dev)
    high = torch.as_tensor(kinematics.CRANE_JOINT_HIGH, device=dev)
    joints = low + d["crane_joints"] * (high - low)
    positions, yaw = base_pose.positions, base_pose.yaw_deg
    human_joints = base_pose.human_joints
    human_ok = torch.ones(joints.shape[0], nh, dtype=torch.bool, device=dev)
    if nh:
        placed_xy = base_diag["placed_xy"]
        placed_r = base_diag["placed_r"].clone()
        placed_r[:, 0] = torch.maximum(
            base_diag["crane_radius"],
            torch.clamp_min(kinematics.crane_reach_xy(joints) * 0.9, cfg.crane_min_radius))
        h_slot0 = 1 + scene_cfg.n_dumpers
        placed_r[:, h_slot0:h_slot0 + nh] = _INACTIVE_R
        _, _, _, human_xy, human_yaw, human_ok = _place_sequential(
            d, "human", nh, placed_xy, placed_r, h_slot0, cfg.human_radius, cfg.human_range,
            cfg.fence_margin, 7.0, cfg)
        h0, h1 = roster.human_slice
        positions, yaw = positions.clone(), yaw.clone()
        positions[:, h0:h1, :2] = human_xy
        yaw[:, h0:h1] = human_yaw
        human_joints = kinematics.pose_human_joints(
            torch.as_tensor(assets.CANONICAL_COCO, device=dev),
            kinematics.sample_human_pose(d["human_pose"]))
    pose = world_mod.ScenePose(
        crane_pos=base_pose.crane_pos,
        crane_yaw_deg=base_pose.crane_yaw_deg,
        crane_joints=joints,
        positions=positions,
        yaw_deg=yaw,
        human_joints=human_joints,
    )
    return pose, {"human_ok": human_ok}


