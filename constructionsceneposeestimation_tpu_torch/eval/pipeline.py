"""End-to-end evaluation (port of the JAX ``eval/pipeline.py``: the decode,
human and equipment evaluators of ``cmd_train_eval``).

* ``evaluate_decode`` / ``evaluate_decode_associated``: peaks of the
  heatmaps (``ops/decode.extract_peaks``, the peak kernel on the card) ->
  PCK@alpha against the projected GT keypoints. On the GT heatmaps this is
  the decode floor; on model heatmaps it scores the network.
* ``evaluate_human_pck``: the worker's 17 COCO channels, DARK or
  soft-argmax.
* ``evaluate_equipment_6dof`` / ``_multi``: decoded (or GT) keypoints ->
  PnP, RANSAC PnP or the ground-prior solve -> ADD / ADD-0.1d against the
  GT pose from the labels.
* ``evaluate_crane_6dof``: the crane's four parts through the
  FK-constrained joint solve, per-part ADD / ADD-0.1d.
* ``evaluate_model``: the evaluation step of ``cmd_train_eval`` on one
  batch: preprocess, forward, then every evaluator above on the GT and the
  model heatmaps (``evaluate_heatmaps``).

Everything stays on the batch's device; a result is a dict of 0-d tensors.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..config import RandomizationConfig
from ..core import camera as cam_mod
from ..core import rotation
from ..models import pose_net
from ..ops import decode as decode_ops
from ..ops import pnp as pnp_ops
from ..ops import preprocess
from ..scene import assets
from . import metrics

Tensor = torch.Tensor


def decode_heatmaps(heatmaps: Tensor, stride: float, use_dark: bool = True):
    """(B, C, h, w) -> uv at full resolution (B, C, 2), scores (B, C)."""
    fn = decode_ops.dark_decode if use_dark else decode_ops.soft_argmax
    uv, score = fn(heatmaps)
    return uv * stride, score


def _bbox_size(uv: Tensor, visible: Tensor) -> Tensor:
    """The larger side of the visible keypoints' 2D extent (..., K, 2) ->
    (...); 1 where none is visible (nanmax/nanmin with nan_to_num 1)."""
    mx = torch.where(visible[..., None], uv, float("-inf")).amax(-2)
    mn = torch.where(visible[..., None], uv, float("inf")).amin(-2)
    return torch.where(visible.any(-1), (mx - mn).amax(-1), 1.0)


def _channels(roster, device) -> Tensor:
    return roster.tensor("inst_kpt_channel", device).long()  # (O, K), -1 padded


def evaluate_decode(batch, roster, stride: float, alpha: float = 0.5, use_dark: bool = True,
                    score_threshold: float = 0.3, max_peaks: int = 8) -> Dict[str, Tensor]:
    """PCK of the top ``max_peaks`` peaks per channel: each GT keypoint is
    scored against its nearest above-threshold peak of its channel."""
    uv_pk, sc_pk = decode_ops.extract_peaks(batch.heatmaps, max_peaks)  # (B, C, P, ...)
    uv_pk = uv_pk * stride
    ch = _channels(roster, uv_pk.device)
    gt_uv, gt_vis = batch.kpt_uv, batch.kpt_visible  # (B, O, K, 2), (B, O, K)
    B = gt_uv.shape[0]
    ch_flat = ch.reshape(-1)
    pk = uv_pk.index_select(1, ch_flat.clamp_min(0))  # (B, OK, P, 2)
    sc = sc_pk.index_select(1, ch_flat.clamp_min(0))  # (B, OK, P)
    d_all = torch.linalg.norm(pk - gt_uv.reshape(B, -1, 2)[..., None, :], dim=-1)
    d = torch.where(sc >= score_threshold, d_all, float("inf")).amin(-1)
    valid = gt_vis.reshape(B, -1) & (ch_flat >= 0)[None]
    thr = alpha * _bbox_size(gt_uv, gt_vis).repeat_interleave(ch.shape[1], dim=-1)
    correct = (d <= torch.clamp_min(thr, 2.0)) & valid & (sc.amax(-1) >= score_threshold)
    n_eval = torch.sum(valid)
    return {
        "pck": torch.sum(correct) / torch.clamp_min(n_eval, 1),
        "mean_px_error_matched": torch.sum(torch.where(correct, d, 0.0))
        / torch.clamp_min(torch.sum(correct), 1),
        "n_keypoints": n_eval,
    }


def evaluate_decode_associated(batch, roster, stride: float, alpha: float = 0.5,
                               score_threshold: float = 0.3, max_peaks: int = 8,
                               margin: float = 8.0) -> Dict[str, Tensor]:
    """Instance-resolved PCK: peaks routed to owners through ``bbox2d``
    (``ops/decode.associate_peaks``), each GT keypoint scored against the
    peak assigned to its own instance."""
    uv_pk, sc_pk = decode_ops.extract_peaks(batch.heatmaps, max_peaks)
    ch = _channels(roster, uv_pk.device)
    uv, sc = decode_ops.associate_peaks(uv_pk * stride, sc_pk, ch, batch.bbox2d, margin)
    d = torch.linalg.norm(uv - batch.kpt_uv, dim=-1)  # (B, O, K)
    valid = batch.kpt_visible & (ch >= 0)[None]
    matched = sc >= score_threshold
    thr = torch.clamp_min(alpha * _bbox_size(batch.kpt_uv, batch.kpt_visible)[..., None], 2.0)
    correct = (d <= thr) & valid & matched
    n_eval = torch.sum(valid)
    return {
        "pck": torch.sum(correct) / torch.clamp_min(n_eval, 1),
        "recall": torch.sum(matched & valid) / torch.clamp_min(n_eval, 1),
        "mean_px_error_matched": torch.sum(torch.where(correct, d, 0.0))
        / torch.clamp_min(torch.sum(correct), 1),
        "n_keypoints": n_eval,
    }


def evaluate_human_pck(batch, roster, stride: float, heatmaps: Optional[Tensor] = None,
                       alpha: float = 0.5, score_threshold: float = 0.3,
                       use_dark: bool = True) -> Dict[str, Tensor]:
    """PCK@alpha over the worker's 17 COCO keypoints, each dedicated
    channel decoded densely (DARK or soft-argmax) and normalized by the
    worker's projected extent. ``pck_per_kpt`` is in COCO order."""
    h0, h1 = roster.human_slice
    if h1 <= h0:
        raise ValueError("roster has no human instance")
    hms = heatmaps if heatmaps is not None else batch.heatmaps
    dev = hms.device
    ch = _channels(roster, dev)[h0:h1]  # (H, Kmax)
    kpt_valid = roster.tensor("inst_kpt_valid", dev)[h0:h1]
    uv_all, score = decode_heatmaps(hms, stride, use_dark)  # (B, C, 2), (B, C)
    B = uv_all.shape[0]
    H, Kmax = ch.shape
    uv = uv_all.index_select(1, ch.clamp_min(0).reshape(-1)).reshape(B, H, Kmax, 2)
    sc = score.index_select(1, ch.clamp_min(0).reshape(-1)).reshape(B, H, Kmax)
    gt_uv = batch.kpt_uv[:, h0:h1]
    gt_vis = batch.kpt_visible[:, h0:h1]
    valid = gt_vis & kpt_valid[None] & (ch >= 0)[None]
    thr = torch.clamp_min(alpha * _bbox_size(gt_uv, gt_vis)[..., None], 2.0)  # (B, H, 1)
    d = torch.linalg.norm(uv - gt_uv, dim=-1)
    correct = (d <= thr) & valid & (sc >= score_threshold)
    n_per_kpt = torch.sum(valid, (0, 1))
    n_eval = torch.sum(valid)
    return {
        "pck": torch.sum(correct) / torch.clamp_min(n_eval, 1),
        "pck_per_kpt": torch.sum(correct, (0, 1)) / torch.clamp_min(n_per_kpt, 1),
        "n_per_kpt": n_per_kpt,
        "mean_px_error": torch.sum(torch.where(valid, d, 0.0)) / torch.clamp_min(n_eval, 1),
        "n_keypoints": n_eval,
    }


def _in_site(t_cam: Tensor, R_wp: Tensor, cam_pos: Tensor, margin: float = 2.0) -> Tensor:
    """The site-bounds gate of every ground-prior evaluator: equipment lives
    inside the fence (+ ``margin`` m). ``t_cam`` (..., 3) camera-frame
    translation; ``R_wp`` (..., 3, 3) and ``cam_pos`` (..., 3) broadcast."""
    rc = RandomizationConfig()
    t_world = (R_wp @ t_cam[..., None])[..., 0] + cam_pos
    return ((t_world[..., 0] >= rc.fence_x[0] - margin)
            & (t_world[..., 0] <= rc.fence_x[1] + margin)
            & (t_world[..., 1] >= rc.fence_y[0] - margin)
            & (t_world[..., 1] <= rc.fence_y[1] + margin))


def gt_camera_frame_pose(roster, batch, inst_index: int):
    """The GT (R, t) from object-local points to the pinhole camera frame
    for one instance, from the emitted labels: p_cam = R_wp^T (R_obj X +
    t_obj - cam)."""
    pose7 = batch.camera_pose7
    R_wp = rotation.matrix_from_quat_xyzw(pose7[..., 3:])
    cam = pose7[..., :3]
    euler = batch.euler_deg[:, inst_index]
    R_obj = (rotation.matrix_rot_z_degrees(euler[..., 2])
             @ rotation.matrix_rot_y_degrees(euler[..., 1])
             @ rotation.matrix_rot_x_degrees(euler[..., 0]))  # extrinsic xyz
    c_local = torch.as_tensor((roster.inst_aabb_min[inst_index]
                               + roster.inst_aabb_max[inst_index]) / 2.0, device=pose7.device)
    t_obj = batch.center[:, inst_index] - (R_obj @ c_local)
    R_pw = R_wp.transpose(-1, -2)
    return R_pw @ R_obj, (R_pw @ (t_obj - cam)[..., None])[..., 0]


def _template_points(class_name: str, device) -> Tensor:
    return torch.as_tensor(assets.all_templates()[class_name].keypoints, dtype=torch.float32,
                           device=device)


def evaluate_equipment_6dof(batch, roster, intr: cam_mod.Intrinsics, class_name: str = "dumper",
                            stride: float = 4.0, use_gt_keypoints: bool = False,
                            heatmaps: Optional[Tensor] = None, score_threshold: float = 0.3,
                            rmse_gate_px: float = 8.0, inlier_px: float = 10.0,
                            use_ransac: bool = True, ransac_scores: Optional[Tensor] = None,
                            ground_prior: bool = False) -> Dict[str, Tensor]:
    """PnP pose recovery + ADD for the single instance of ``class_name``.
    ``use_gt_keypoints=True`` feeds the projected GT keypoints to the solver
    (the pipeline's error floor); otherwise ``heatmaps`` (default: the GT
    heatmaps) are decoded with DARK. Decoded keypoints go through RANSAC
    unless ``use_ransac=False`` or ``ground_prior``: ``ransac_scores`` (B,
    32, K) are its Gumbel draws, else ``ops/pnp.gumbel`` draws them."""
    idx = [i for i, n in enumerate(roster.inst_class_names) if n == class_name]
    if len(idx) != 1:
        raise ValueError(f"{class_name}: expected exactly one instance; use "
                         "evaluate_equipment_6dof_multi for multi-instance classes")
    o = idx[0]
    dev = batch.kpt_uv.device
    model_pts = _template_points(class_name, dev)
    K = model_pts.shape[0]
    if use_gt_keypoints:
        uv = batch.kpt_uv[:, o, :K]
        w = batch.kpt_visible[:, o, :K].float()
    else:
        hms = heatmaps if heatmaps is not None else batch.heatmaps
        uv_all, score = decode_heatmaps(hms, stride)
        ch = _channels(roster, dev)[o, :K]
        uv = uv_all.index_select(1, ch)
        sc = score.index_select(1, ch)
        w = torch.where(sc >= score_threshold, sc, 0.0)

    x = pnp_ops.normalize_pixels(uv, intr.fx, intr.fy, intr.cx, intr.cy)
    Xb = model_pts.expand(x.shape[0], K, 3)
    px2n = 1.0 / float(intr.fx)
    pose7 = batch.camera_pose7
    R_wp = rotation.matrix_from_quat_xyzw(pose7[..., 3:])
    if ground_prior:
        res = pnp_ops.solve_ground_pose(Xb, x, w, R_wp, pose7[..., :3])
    elif use_ransac and not use_gt_keypoints:
        res = pnp_ops.solve_pnp_ransac(Xb, x, w, ransac_scores,
                                       inlier_thresh=inlier_px * px2n)
    else:
        res = pnp_ops.solve_pnp(Xb, x, w)
    R_gt, t_gt = gt_camera_frame_pose(roster, batch, o)
    add = metrics.add_metric(res.R, res.t, R_gt, t_gt, model_pts)
    dia = metrics.model_diameter(model_pts)
    valid = res.valid & batch.inst_visible[:, o]
    accepted = valid & (res.rmse <= rmse_gate_px * px2n)
    if ground_prior:
        accepted = accepted & _in_site(res.t, R_wp, pose7[..., :3])
    return {
        "add_mean": torch.sum(torch.where(accepted, add, 0.0))
        / torch.clamp_min(torch.sum(accepted), 1),
        "add_0_1d": metrics.add_accuracy(add, dia, accepted),
        "n_valid": torch.sum(valid),
        "n_accepted": torch.sum(accepted),
        "rmse": torch.sum(torch.where(valid, res.rmse, 0.0)) / torch.clamp_min(torch.sum(valid), 1),
    }


def evaluate_equipment_6dof_multi(batch, roster, intr: cam_mod.Intrinsics,
                                  class_name: str = "dumper", stride: float = 4.0,
                                  use_gt_keypoints: bool = False,
                                  heatmaps: Optional[Tensor] = None,
                                  score_threshold: float = 0.3, rmse_gate_px: float = 8.0,
                                  max_peaks: int = 8, margin: float = 8.0) -> Dict[str, Tensor]:
    """Every instance of ``class_name``: peaks -> instances through
    ``bbox2d`` (``ops/decode.associate_peaks``), then a ground-prior solve
    per (frame, instance), aggregated over all of them."""
    idxs = [i for i, n in enumerate(roster.inst_class_names) if n == class_name]
    if not idxs:
        raise ValueError(f"no instances of {class_name}")
    dev = batch.kpt_uv.device
    model_pts = _template_points(class_name, dev)
    K = model_pts.shape[0]
    oi = torch.as_tensor(idxs, device=dev)
    if use_gt_keypoints:
        uv = batch.kpt_uv[:, oi, :K]  # (B, I, K, 2)
        w = batch.kpt_visible[:, oi, :K].float()
    else:
        hms = heatmaps if heatmaps is not None else batch.heatmaps
        uv_pk, sc_pk = decode_ops.extract_peaks(hms, max_peaks)
        uv_all, sc_all = decode_ops.associate_peaks(uv_pk * stride, sc_pk, _channels(roster, dev),
                                                    batch.bbox2d, margin)
        uv = uv_all[:, oi, :K]
        sc = sc_all[:, oi, :K]
        w = torch.where(sc >= score_threshold, sc, 0.0)

    x = pnp_ops.normalize_pixels(uv, intr.fx, intr.fy, intr.cx, intr.cy)
    pose7 = batch.camera_pose7
    R_wp = rotation.matrix_from_quat_xyzw(pose7[..., 3:])
    B, I = x.shape[:2]
    res = pnp_ops.solve_ground_pose(model_pts.expand(B, I, K, 3), x, w,
                                    R_wp[:, None].expand(B, I, 3, 3),
                                    pose7[:, None, :3].expand(B, I, 3))
    px2n = 1.0 / float(intr.fx)
    accepted = (res.valid & (res.rmse <= rmse_gate_px * px2n)
                & _in_site(res.t, R_wp[:, None], pose7[:, None, :3]))  # (B, I)
    adds, gates = [], []
    for col, o in enumerate(idxs):
        R_gt, t_gt = gt_camera_frame_pose(roster, batch, o)
        adds.append(metrics.add_metric(res.R[:, col], res.t[:, col], R_gt, t_gt, model_pts))
        gates.append(accepted[:, col] & batch.inst_visible[:, o])
    add = torch.stack(adds, -1)
    gate = torch.stack(gates, -1)
    dia = metrics.model_diameter(model_pts)
    return {
        "add_mean": torch.sum(torch.where(gate, add, 0.0)) / torch.clamp_min(torch.sum(gate), 1),
        "add_0_1d": metrics.add_accuracy(add, dia, gate),
        "n_instances_evaluated": torch.sum(gate),
        "n_valid": torch.sum(res.valid),
        "n_accepted": torch.sum(accepted),
    }


def crane_solve(batch, roster, intr: cam_mod.Intrinsics, stride: float = 4.0,
                use_gt_keypoints: bool = False, heatmaps: Optional[Tensor] = None,
                score_threshold: float = 0.3) -> pnp_ops.CranePnPResult:
    """The crane solve of every frame of ``evaluate_crane_6dof``: its four
    parts' keypoints (the projected GT ones, or ``heatmaps`` decoded with
    DARK, weighted by score above ``score_threshold``) through
    ``ops/pnp.solve_crane_pose`` with the camera of ``camera_pose7``."""
    s0, s1 = roster.crane_slice
    if s1 - s0 != 4:
        raise ValueError("roster must carry the 4 crane part instances")
    dev = batch.kpt_uv.device
    kpts_local = roster.tensor("inst_kpts", dev)[s0:s1]  # (4, Kmax, 3)
    kpt_valid = roster.tensor("inst_kpt_valid", dev)[s0:s1]  # (4, Kmax)
    if use_gt_keypoints:
        uv = batch.kpt_uv[:, s0:s1]  # (B, 4, Kmax, 2)
        w = (batch.kpt_visible[:, s0:s1] & kpt_valid).float()
    else:
        hms = heatmaps if heatmaps is not None else batch.heatmaps
        uv_all, score = decode_heatmaps(hms, stride)  # (B, C, 2), (B, C)
        ch = _channels(roster, dev)[s0:s1]  # (4, Kmax), -1 pads
        B = uv_all.shape[0]
        uv = uv_all.index_select(1, ch.clamp_min(0).reshape(-1)).reshape(B, 4, ch.shape[1], 2)
        sc = score.index_select(1, ch.clamp_min(0).reshape(-1)).reshape(B, 4, ch.shape[1])
        w = torch.where((sc >= score_threshold) & kpt_valid & (ch >= 0), sc, 0.0)
    x = pnp_ops.normalize_pixels(uv, intr.fx, intr.fy, intr.cx, intr.cy)
    pose7 = batch.camera_pose7
    R_wp = rotation.matrix_from_quat_xyzw(pose7[..., 3:])
    return pnp_ops.solve_crane_pose(kpts_local, x, w, R_wp, pose7[..., :3])


def evaluate_crane_6dof(batch, roster, intr: cam_mod.Intrinsics, stride: float = 4.0,
                        use_gt_keypoints: bool = False, heatmaps: Optional[Tensor] = None,
                        score_threshold: float = 0.3,
                        rmse_gate_px: float = 8.0) -> Dict[str, Tensor]:
    """The articulated crane: an FK-constrained fit of (x, y, column yaw,
    boom pitch, telescopic extension) over all four parts' keypoints at once
    (``ops/pnp.solve_crane_pose``), then per-part ADD / ADD-0.1d on each
    part's box corners against the GT part poses of the labels. Keypoints
    are the projected GT ones or ``heatmaps`` (default: the GT heatmaps)
    decoded with DARK. A frame counts when the solve is valid and passes
    the pixel-calibrated reprojection gate. The camera rotation comes from
    ``camera_pose7``, so the batch must not be ``bug_compatible``."""
    s0, s1 = roster.crane_slice
    part_names = roster.inst_class_names[s0:s1]
    dev = batch.kpt_uv.device
    res = crane_solve(batch, roster, intr, stride, use_gt_keypoints, heatmaps, score_threshold)
    accepted = res.valid & (res.rmse <= rmse_gate_px * (1.0 / float(intr.fx)))
    out: Dict[str, Tensor] = {
        "n_valid": torch.sum(res.valid),
        "n_accepted": torch.sum(accepted),
        "rmse": torch.sum(torch.where(res.valid, res.rmse, 0.0))
        / torch.clamp_min(torch.sum(res.valid), 1),
    }
    adds, add01s = [], []
    for pi, name in enumerate(part_names):
        o = s0 + pi
        model_pts = metrics.aabb_corners(roster.inst_aabb_min[o], roster.inst_aabb_max[o], dev)
        R_gt, t_gt = gt_camera_frame_pose(roster, batch, o)
        add = metrics.add_metric(res.R[:, pi], res.t[:, pi], R_gt, t_gt, model_pts)
        gate = accepted & batch.inst_visible[:, o]
        out[f"add_mean_{name}"] = (torch.sum(torch.where(gate, add, 0.0))
                                   / torch.clamp_min(torch.sum(gate), 1))
        out[f"add_0_1d_{name}"] = metrics.add_accuracy(add, metrics.model_diameter(model_pts),
                                                       gate)
        adds.append(out[f"add_mean_{name}"])
        add01s.append(out[f"add_0_1d_{name}"])
    out["add_mean"] = torch.mean(torch.stack(adds))
    out["add_0_1d"] = torch.mean(torch.stack(add01s))
    return out


def channel_scores(hm: Tensor, class_name: str = "dumper") -> Dict[str, Tensor]:
    """What the model scores a class's channels: the peak of each of its
    maps (B, C_class), as ``cmd_train_eval``'s dumper line reports it."""
    lo, hi = pose_net.class_channel_slices()[class_name]
    s = torch.amax(hm[:, lo:hi], dim=(-1, -2))
    return {"mean": s.mean(), "max": s.max(), "ge_0_3": (s >= 0.3).float().mean(),
            "ge_0_15": (s >= 0.15).float().mean()}


def evaluate_model(model, batch, roster, intr: cam_mod.Intrinsics, stride: float,
                   loss: str = "focal", pnp_threshold: float = 0.15) -> tuple:
    """The evaluation step of ``cmd_train_eval`` on one batch: frames preprocessed at their own size with no augmentation (the
    network's input size is the render size), the network's forward
    under ``torch.inference_mode()`` (bf16 autocast in the body, an f32
    head), its output mapped to heatmaps, then every evaluator on the GT
    heatmaps (the decode floor) and on the model's.

    Returns ({name: {metric: 0-d tensor}}, model heatmaps (B, C, h, w))."""
    with torch.inference_mode():
        images = preprocess.preprocess_frame(batch.rgb, *batch.rgb.shape[1:3], augment=False)
        hm = pose_net.output_to_heatmaps(pose_net.forward(model, images), loss)
    return evaluate_heatmaps(batch, hm, roster, intr, stride, pnp_threshold), hm


def evaluate_heatmaps(batch, hm: Tensor, roster, intr: cam_mod.Intrinsics, stride: float,
                      pnp_threshold: float = 0.15) -> Dict[str, Dict[str, Tensor]]:
    """Every evaluator of ``evaluate_model`` on the GT heatmaps and on the
    model heatmaps ``hm`` (B, C, h, w)."""
    with torch.inference_mode():
        pred = batch._replace(heatmaps=hm)
        out = {
            "decode_floor": evaluate_decode(batch, roster, stride),
            "decode_model": evaluate_decode(pred, roster, stride),
            "assoc_floor": evaluate_decode_associated(batch, roster, stride),
            "assoc_model": evaluate_decode_associated(pred, roster, stride),
        }
        for tag, dark in (("dark", True), ("soft_argmax", False)):
            out[f"human_floor_{tag}"] = evaluate_human_pck(batch, roster, stride, use_dark=dark)
            out[f"human_model_{tag}"] = evaluate_human_pck(batch, roster, stride, heatmaps=hm,
                                                           use_dark=dark)
        out["dumper_gt_kpts"] = evaluate_equipment_6dof(
            batch, roster, intr, "dumper", stride, use_gt_keypoints=True, ground_prior=True)
        out["dumper_model"] = evaluate_equipment_6dof(
            batch, roster, intr, "dumper", stride, heatmaps=hm, score_threshold=pnp_threshold,
            ground_prior=True)
        out["dumper_multi_floor"] = evaluate_equipment_6dof_multi(batch, roster, intr, "dumper",
                                                                  stride)
        out["dumper_multi_model"] = evaluate_equipment_6dof_multi(
            batch, roster, intr, "dumper", stride, heatmaps=hm, score_threshold=pnp_threshold)
        out["dumper_scores"] = channel_scores(hm, "dumper")
        out["crane_gt_kpts"] = evaluate_crane_6dof(batch, roster, intr, stride,
                                                   use_gt_keypoints=True)
        out["crane_model"] = evaluate_crane_6dof(batch, roster, intr, stride, heatmaps=hm,
                                                 score_threshold=pnp_threshold)
    return out
