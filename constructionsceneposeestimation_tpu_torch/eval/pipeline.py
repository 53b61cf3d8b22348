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
* The two-stage path: ``evaluate_crop_6dof`` / ``_multi`` (ROIs from the
  labels or a detector's boxes -> the crop net -> DARK in crop
  coordinates -> the ground-prior solve -> ADD), ``evaluate_detector``
  (one-to-one greedy matching, P/R, AP, the miss split),
  ``crane_part_keypoints`` and ``evaluate_crop_crane_6dof`` (per-part
  crane crops -> the FK-constrained solve).

Everything stays on the batch's device; a result is a dict of 0-d tensors.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..config import RandomizationConfig
from ..core import camera as cam_mod
from ..core import rotation
from ..models import pose_net
from ..ops import crop as crop_ops
from ..ops import decode as decode_ops
from ..ops import detect as detect_ops
from ..ops import pnp as pnp_ops
from ..ops import preprocess
from ..scene import assets
from ..train import crop_loop, detect_loop
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


def crop_images(rgb: Tensor, roi, crop_size: int, half_v: Optional[Tensor] = None) -> Tensor:
    """Frames (B, H, W, 3) u8 and ROIs (B,) or (B, R) -> normalized crops
    (B * R, c, c, 3), not augmented."""
    cu, cv, half = roi
    img = crop_ops.crop_resize(rgb.float() / 255.0, cu, cv, half, crop_size, half_v=half_v)
    return preprocess.normalize(img.reshape(-1, crop_size, crop_size, 3))


def crop_keypoints(model, imgs: Tensor, loss: str):
    """The crop net's DARK keypoints in crop pixels (N, C, 2) and their
    scores (N, C)."""
    hm = pose_net.output_to_heatmaps(pose_net.forward(model, imgs), loss)
    uv, sc = decode_ops.dark_decode(hm)
    return uv * getattr(model, "output_stride", 4), sc


def _masked_mean(x: Tensor, gate: Tensor) -> Tensor:
    return torch.sum(torch.where(gate, x, 0.0)) / torch.clamp_min(torch.sum(gate), 1)


def _iou(a: Tensor, b: Tensor) -> Tensor:
    """IoU of boxes a (..., 4) and b (..., 4) [u0, v0, u1, v1]."""
    iw = torch.clamp_min(torch.minimum(a[..., 2], b[..., 2]) - torch.maximum(a[..., 0], b[..., 0]),
                         0.0)
    ih = torch.clamp_min(torch.minimum(a[..., 3], b[..., 3]) - torch.maximum(a[..., 1], b[..., 1]),
                         0.0)
    inter = iw * ih
    area = lambda x: (torch.clamp_min(x[..., 2] - x[..., 0], 0.0)
                      * torch.clamp_min(x[..., 3] - x[..., 1], 0.0))
    return inter / torch.clamp_min(area(a) + area(b) - inter, 1e-9)


@torch.inference_mode()
def evaluate_crop_6dof(batch, roster, intr: cam_mod.Intrinsics, model, class_name: str = "dumper",
                       crop_size: int = 128, score_threshold: float = 0.3,
                       rmse_gate_px: float = 8.0, loss: str = "focal", min_box_px: float = 6.0,
                       boxes: Optional[Tensor] = None) -> Dict[str, Tensor]:
    """Two-stage equipment 6DoF: one square ROI a frame from the label box
    of the class's first instance (a detector's stand-in) or from ``boxes``
    (B, 4), the crop net, DARK in crop coordinates mapped back to image
    pixels, the ground-prior solve, ADD. Frames whose box is under
    ``min_box_px`` are not detectable. With several instances of the class
    and detector boxes, each frame's box is scored against the GT instance
    it overlaps most (the first on ties)."""
    idxs = [i for i, n in enumerate(roster.inst_class_names) if n == class_name]
    o = idxs[0]
    dev = batch.rgb.device
    model_pts = _template_points(class_name, dev)
    bbox = boxes.float() if boxes is not None else batch.bbox2d[:, o].float()
    sel = None
    if boxes is not None and len(idxs) > 1:
        gtb = batch.bbox2d[:, idxs].float()  # (B, I, 4)
        iou = torch.where(batch.inst_visible[:, idxs], _iou(bbox[:, None], gtb), -1.0)
        sel = torch.argmax(iou, 1)
    roi = crop_ops.square_roi(bbox)
    uv_c, sc = crop_keypoints(model, crop_images(batch.rgb, roi, crop_size), loss)
    uv = crop_ops.crop_to_uv(uv_c, *(x[:, None] for x in roi), crop_size)
    w = torch.where(sc >= score_threshold, sc, 0.0)
    x = pnp_ops.normalize_pixels(uv, intr.fx, intr.fy, intr.cx, intr.cy)
    pose7 = batch.camera_pose7
    R_wp = rotation.matrix_from_quat_xyzw(pose7[..., 3:])
    B = x.shape[0]
    res = pnp_ops.solve_ground_pose(model_pts.expand(B, -1, 3), x, w, R_wp, pose7[..., :3])
    if sel is None:
        R_gt, t_gt = gt_camera_frame_pose(roster, batch, o)
        vis_o = batch.inst_visible[:, o]
    else:
        Rs, ts = zip(*(gt_camera_frame_pose(roster, batch, i) for i in idxs))
        ar = torch.arange(B, device=dev)
        R_gt, t_gt = torch.stack(Rs, 1)[ar, sel], torch.stack(ts, 1)[ar, sel]
        vis_o = batch.inst_visible[:, idxs][ar, sel]
    add = metrics.add_metric(res.R, res.t, R_gt, t_gt, model_pts)
    box_px = torch.maximum(bbox[:, 2] - bbox[:, 0], bbox[:, 3] - bbox[:, 1])
    detectable = vis_o & (box_px >= min_box_px)
    valid = res.valid & detectable
    accepted = (valid & (res.rmse <= rmse_gate_px * (1.0 / float(intr.fx)))
                & _in_site(res.t, R_wp, pose7[..., :3]))
    return {
        "add_mean": _masked_mean(add, accepted),
        "add_0_1d": metrics.add_accuracy(add, metrics.model_diameter(model_pts), accepted),
        "n_detectable": torch.sum(detectable),
        "n_valid": torch.sum(valid),
        "n_accepted": torch.sum(accepted),
        "rmse": _masked_mean(res.rmse, valid),
    }


def match_boxes_to_instances(det_boxes: Tensor, det_scores: Tensor, gt_boxes: Tensor,
                             det_threshold: float = 0.3, min_iou: float = 0.25):
    """Detector boxes (B, D, 4) / scores (B, D) -> GT instance slots (B, I,
    4), one to one by IoU: each instance column in turn takes its
    highest-IoU unclaimed above-threshold detection (the first on ties).
    Returns (boxes (B, I, 4), matched (B, I)); an unmatched slot keeps the
    GT box and is masked out by ``matched``."""
    B, D = det_scores.shape
    iou = _iou(det_boxes[:, :, None], gt_boxes[:, None])  # (B, D, I)
    iou = torch.where((det_scores >= det_threshold)[..., None], iou, 0.0)
    taken = torch.zeros(B, D, dtype=torch.bool, device=det_boxes.device)
    ar = torch.arange(B, device=det_boxes.device)
    out_boxes, out_matched = [], []
    for col in range(gt_boxes.shape[1]):
        col_iou = torch.where(taken, 0.0, iou[..., col])
        best = torch.argmax(col_iou, -1)
        hit = torch.amax(col_iou, -1) >= min_iou
        taken = taken | (torch.nn.functional.one_hot(best, D).bool() & hit[:, None])
        out_boxes.append(torch.where(hit[:, None], det_boxes[ar, best], gt_boxes[:, col]))
        out_matched.append(hit)
    return torch.stack(out_boxes, 1), torch.stack(out_matched, 1)


@torch.inference_mode()
def evaluate_crop_6dof_multi(batch, roster, intr: cam_mod.Intrinsics, model,
                             class_name: str = "dumper", crop_size: int = 128,
                             score_threshold: float = 0.3, rmse_gate_px: float = 8.0,
                             loss: str = "focal", min_box_px: float = 6.0,
                             boxes: Optional[Tensor] = None, box_scores: Optional[Tensor] = None,
                             det_threshold: float = 0.3) -> Dict[str, Tensor]:
    """One ROI per (frame, instance) of the class, each solved and scored on
    its own. ROIs come from the label boxes, or from one detection class's
    decoded boxes (B, D, 4) and scores (B, D), matched one to one to the
    instances (``match_boxes_to_instances``); an unmatched instance is not
    detectable."""
    idxs = [i for i, n in enumerate(roster.inst_class_names) if n == class_name]
    dev = batch.rgb.device
    model_pts = _template_points(class_name, dev)
    K = model_pts.shape[0]
    I = len(idxs)
    bbox = batch.bbox2d[:, idxs].float()  # (B, I, 4)
    det_matched = None
    if boxes is not None:
        if box_scores is None:
            raise ValueError("detector boxes need their scores")
        bbox, det_matched = match_boxes_to_instances(boxes.float(), box_scores, bbox,
                                                     det_threshold)
    roi = crop_ops.square_roi(bbox)  # (B, I) each
    uv_c, sc = crop_keypoints(model, crop_images(batch.rgb, roi, crop_size), loss)
    B = bbox.shape[0]
    uv = crop_ops.crop_to_uv(uv_c.reshape(B, I, K, 2), *(x[..., None] for x in roi), crop_size)
    sc = sc.reshape(B, I, K)
    w = torch.where(sc >= score_threshold, sc, 0.0)
    x = pnp_ops.normalize_pixels(uv, intr.fx, intr.fy, intr.cx, intr.cy)
    pose7 = batch.camera_pose7
    R_wp = rotation.matrix_from_quat_xyzw(pose7[..., 3:])
    res = pnp_ops.solve_ground_pose(model_pts.expand(B, I, K, 3), x, w,
                                    R_wp[:, None].expand(B, I, 3, 3),
                                    pose7[:, None, :3].expand(B, I, 3))
    box_px = torch.maximum(bbox[..., 2] - bbox[..., 0], bbox[..., 3] - bbox[..., 1])
    detectable = batch.inst_visible[:, idxs] & (box_px >= min_box_px)
    if det_matched is not None:
        detectable = detectable & det_matched
    gate = (res.valid & detectable & (res.rmse <= rmse_gate_px * (1.0 / float(intr.fx)))
            & _in_site(res.t, R_wp[:, None], pose7[:, None, :3]))
    add = torch.stack([metrics.add_metric(res.R[:, col], res.t[:, col],
                                          *gt_camera_frame_pose(roster, batch, o), model_pts)
                       for col, o in enumerate(idxs)], -1)
    return {
        "add_mean": _masked_mean(add, gate),
        "add_0_1d": metrics.add_accuracy(add, metrics.model_diameter(model_pts), gate),
        "n_detectable": torch.sum(detectable),
        "n_accepted": torch.sum(gate),
    }


@torch.inference_mode()
def evaluate_detector(batch, roster, model, score_threshold: float = 0.3,
                      iou_thresh: float = 0.5, max_det: int = 8,
                      analysis: bool = False) -> Dict[str, Tensor]:
    """Detection quality against the renderer's boxes (the crane's union
    appended): per class and in total, precision and recall at IoU >=
    ``iou_thresh`` under one-to-one greedy matching in score order
    (duplicates count as false positives), all-point AP per class
    (``ap_<cls>``, their mean ``map``), the best dumper box per frame, and
    the decoded ``boxes`` / ``scores``. ``analysis=True`` splits each
    class's missed GTs (``miss_score_<c>``: a same-class detection
    localizes it; ``miss_cls_<c>``: only another class's does;
    ``miss_loc_<c>``: none does)."""
    imgs = preprocess.normalize(batch.rgb.float() / 255.0)
    pred = pose_net.forward(model, imgs)
    boxes, scores = detect_ops.decode_detections(pred, float(getattr(model, "output_stride", 4)),
                                                 max_det)
    dev = boxes.device
    inst_cls = torch.as_tensor(detect_loop.extended_inst_classes(roster), device=dev)
    gt_boxes, gt_vis = detect_loop.crane_extended_boxes(batch, roster)
    B, O = gt_vis.shape
    D = boxes.shape[2]
    ar_o = torch.arange(O, device=dev)
    out: Dict[str, Tensor] = {}
    tps, fps, gts = [], [], []
    for ci, cname in enumerate(detect_ops.DET_CLASSES):
        det_b, det_s = boxes[:, ci], scores[:, ci]  # (B, D, 4), (B, D): score order
        keep = det_s >= score_threshold
        gsel = (inst_cls == ci)[None] & gt_vis  # (B, O)
        iou = torch.where(gsel[:, None], _iou(det_b[:, :, None], gt_boxes[:, None]), 0.0)
        # One pass in score order serves both the thresholded P/R and the
        # ranked AP: below-threshold detections come after every kept one,
        # so they cannot take a kept detection's GT.
        taken = torch.zeros(B, O, dtype=torch.bool, device=dev)
        taken_kept = torch.zeros_like(taken)
        hits = []
        for d in range(D):
            iou_d = torch.where(taken, 0.0, iou[:, d])
            best = torch.argmax(iou_d, -1)
            hit = torch.amax(iou_d, -1) >= iou_thresh
            claimed = (ar_o == best[:, None]) & hit[:, None]
            taken = taken | claimed
            taken_kept = taken_kept | (claimed & keep[:, d, None])
            hits.append(hit)
        det_hit = torch.stack(hits, 1)  # (B, D)
        n_gt = torch.sum(gsel)
        if analysis:
            missed = gsel & ~taken_kept
            same_loc = torch.amax(iou, 1) >= iou_thresh
            iou_any = _iou(boxes.reshape(B, -1, 4)[:, :, None], gt_boxes[:, None])
            any_loc = torch.amax(iou_any, 1) >= iou_thresh
            n_gt_a = torch.clamp_min(n_gt, 1)
            out[f"miss_score_{cname}"] = torch.sum(missed & same_loc) / n_gt_a
            out[f"miss_cls_{cname}"] = torch.sum(missed & ~same_loc & any_loc) / n_gt_a
            out[f"miss_loc_{cname}"] = torch.sum(missed & ~any_loc) / n_gt_a
        tp = torch.sum(det_hit & keep)
        fp = torch.sum(~det_hit & keep)
        out[f"precision_{cname}"] = tp / torch.clamp_min(tp + fp, 1)
        out[f"recall_{cname}"] = tp / torch.clamp_min(n_gt, 1)
        # All-point AP over every detection of the batch ranked by score
        # (a stable sort, as jnp.argsort).
        order = torch.argsort(-det_s.reshape(-1), stable=True)
        hit_sorted = det_hit.reshape(-1)[order].float()
        prec = torch.cumsum(hit_sorted, 0) / (torch.arange(hit_sorted.shape[0], device=dev) + 1.0)
        out[f"ap_{cname}"] = torch.sum(prec * hit_sorted) / torch.clamp_min(n_gt, 1)
        tps.append(tp)
        fps.append(fp)
        gts.append(n_gt)
    tp, fp, n_gt = (torch.sum(torch.stack(v)) for v in (tps, fps, gts))
    out["precision"] = tp / torch.clamp_min(tp + fp, 1)
    out["recall"] = tp / torch.clamp_min(n_gt, 1)
    out["map"] = torch.mean(torch.stack([out[f"ap_{c}"] for c in detect_ops.DET_CLASSES]))
    di = detect_ops.DET_CLASSES.index("dumper")
    best = torch.argmax(scores[:, di], -1)
    ar = torch.arange(B, device=dev)
    out["dumper_boxes"] = boxes[ar, di, best]
    out["dumper_scores"] = scores[ar, di, best]
    out["boxes"] = boxes
    out["scores"] = scores
    return out


def best_part_boxes(boxes: Tensor, scores: Tensor):
    """Detector outputs (B, C, D, 4) / (B, C, D) -> each frame's best crane
    PART box, ((B, 4, 4), (B, 4)) in the roster's part order (base,
    column, boom, telescopic): the label-free ROIs of the crane's crops."""
    cidx = [detect_ops.DET_CLASSES.index(p) for p in detect_ops.CRANE_PART_CLASSES]
    pb, ps = boxes[:, cidx], scores[:, cidx]  # (B, 4, D, 4), (B, 4, D)
    best = torch.argmax(ps, -1, keepdim=True)
    return (torch.take_along_dim(pb, best[..., None], 2)[:, :, 0],
            torch.take_along_dim(ps, best, 2)[..., 0])


@torch.inference_mode()
def crane_part_keypoints(rgb: Tensor, pboxes: Tensor, part_vis: Tensor, roster, model,
                         crop_size: int = 128, score_threshold: float = 0.3,
                         loss: str = "focal"):
    """Per-part crane ROIs -> the 4 * Kp crop net -> DARK, mapped back to
    image pixels: each part's keypoints from its own crop. ``pboxes`` (B, 4,
    4) in the roster's part order (label boxes or ``best_part_boxes``),
    ``part_vis`` (B, 4) gates a part's weights. The ROIs are the trainer's
    (``rect_roi``, half side >= 24 px). Returns (uv (B, 4, Kp, 2), scores
    (B, 4, Kp), w (B, 4, Kp)) for ``ops/pnp.solve_crane_pose``."""
    s0, Kp = crop_loop.crane_channels(roster)
    kpt_valid = roster.tensor("inst_kpt_valid", rgb.device)[s0:s0 + 4, :Kp]
    B = rgb.shape[0]
    cu, cv, hu, hv = crop_ops.rect_roi(pboxes, min_half=24.0)  # (B, 4)
    uv_c, sc = crop_keypoints(model, crop_images(rgb, (cu, cv, hu), crop_size, half_v=hv), loss)
    p = torch.arange(4, device=rgb.device)
    uv_c = uv_c.reshape(B, 4, 4, Kp, 2)[:, p, p]  # part pi from crop pi
    sc = sc.reshape(B, 4, 4, Kp)[:, p, p]
    uv = crop_ops.crop_to_uv(uv_c, *(x[..., None] for x in (cu, cv, hu)), crop_size,
                             half_v=hv[..., None])
    w = torch.where((sc >= score_threshold) & kpt_valid & part_vis[..., None], sc, 0.0)
    return uv, sc, w


@torch.inference_mode()
def evaluate_crop_crane_6dof(batch, roster, intr: cam_mod.Intrinsics, model,
                             crop_size: int = 128, score_threshold: float = 0.3,
                             rmse_gate_px: float = 8.0, loss: str = "focal",
                             min_box_px: float = 10.0, per_part: bool = False,
                             part_boxes: Optional[Tensor] = None,
                             part_scores: Optional[Tensor] = None,
                             det_threshold: float = 0.3) -> Dict[str, Tensor]:
    """Two-stage crane pose: one ROI around the four parts' union, or with
    ``per_part`` one per part box (``crane_part_keypoints``), the 4 * Kp
    crop net, the FK-constrained joint solve, per-part ADD with its split
    into translation (``t_err_<part>``, m) and rotation
    (``rot_err_deg_<part>``). ``part_boxes`` (B, 4, 4) and ``part_scores``
    (B, 4) replace the label boxes with a detector's (``best_part_boxes``);
    a part scored under ``det_threshold`` then gives no keypoints."""
    s0, Kp = crop_loop.crane_channels(roster)
    dev = batch.rgb.device
    part_names = roster.inst_class_names[s0:s0 + 4]
    kpts_local = roster.tensor("inst_kpts", dev)[s0:s0 + 4, :Kp]
    kpt_valid = roster.tensor("inst_kpt_valid", dev)[s0:s0 + 4, :Kp]
    bbox, any_vis = crop_loop.crane_union_roi(batch, roster)
    B = batch.rgb.shape[0]
    if per_part:
        pboxes = (part_boxes.float() if part_boxes is not None
                  else batch.bbox2d[:, s0:s0 + 4].float())
        part_vis = (part_scores >= det_threshold if part_scores is not None
                    else batch.inst_visible[:, s0:s0 + 4])
        uv, sc, w = crane_part_keypoints(batch.rgb, pboxes, part_vis, roster, model, crop_size,
                                         score_threshold, loss)
    else:
        roi = crop_ops.square_roi(bbox)
        uv_c, sc = crop_keypoints(model, crop_images(batch.rgb, roi, crop_size), loss)
        uv = crop_ops.crop_to_uv(uv_c, *(x[:, None] for x in roi), crop_size).reshape(B, 4, Kp, 2)
        sc = sc.reshape(B, 4, Kp)
        w = torch.where((sc >= score_threshold) & kpt_valid, sc, 0.0)
    x = pnp_ops.normalize_pixels(uv, intr.fx, intr.fy, intr.cx, intr.cy)
    pose7 = batch.camera_pose7
    R_wp = rotation.matrix_from_quat_xyzw(pose7[..., 3:])
    res = pnp_ops.solve_crane_pose(kpts_local, x, w, R_wp, pose7[..., :3])
    box_px = torch.maximum(bbox[:, 2] - bbox[:, 0], bbox[:, 3] - bbox[:, 1])
    detectable = any_vis & (box_px >= min_box_px)
    accepted = res.valid & detectable & (res.rmse <= rmse_gate_px * (1.0 / float(intr.fx)))
    out: Dict[str, Tensor] = {
        "n_detectable": torch.sum(detectable),
        "n_valid": torch.sum(res.valid & detectable),
        "n_accepted": torch.sum(accepted),
        "rmse": _masked_mean(res.rmse, res.valid),
    }
    for pi, name in enumerate(part_names):
        o = s0 + pi
        # ADD over the part's box corners, not its keypoints (axis keypoints
        # under-span a part of revolution and would shrink the 0.1d gate).
        model_pts = metrics.aabb_corners(roster.inst_aabb_min[o], roster.inst_aabb_max[o], dev)
        R_gt, t_gt = gt_camera_frame_pose(roster, batch, o)
        add = metrics.add_metric(res.R[:, pi], res.t[:, pi], R_gt, t_gt, model_pts)
        gate = accepted & batch.inst_visible[:, o]
        out[f"add_mean_{name}"] = _masked_mean(add, gate)
        out[f"add_0_1d_{name}"] = metrics.add_accuracy(add, metrics.model_diameter(model_pts),
                                                       gate)
        out[f"t_err_{name}"] = _masked_mean(torch.linalg.norm(res.t[:, pi] - t_gt, dim=-1), gate)
        tr = torch.einsum("bij,bij->b", res.R[:, pi], R_gt)  # trace(R_est R_gt^T)
        ang = torch.rad2deg(torch.arccos(torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0)))
        out[f"rot_err_deg_{name}"] = _masked_mean(ang, gate)
    out["add_mean"] = torch.mean(torch.stack([out[f"add_mean_{n}"] for n in part_names]))
    out["add_0_1d"] = torch.mean(torch.stack([out[f"add_0_1d_{n}"] for n in part_names]))
    return out
