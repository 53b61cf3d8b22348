"""The annotation pass for a batch of frames (port of ``render_frame`` of
the JAX ``render/annotate.py``).

One packed pixel sweep gives depth and instance; the keypoint-occlusion
segments ride the packed caster from the same camera origin; the RGB
epilogue shades from depth and instance (with ``texels``, the
image-texture tier's table, the RGB kernel's textured variant); labels
(visible set, pixel counts, 2D boxes, 6DoF boxes, keypoints and their
visibility, point-cloud count) derive from poses and the two sweeps. Every
tensor leads with the batch dimension B.

The RGB tiers of the JAX function, each a variant of the RGB kernel:
``analytic_normals`` casts the pixel rays and the keypoint segments
through the exact caster (``caster.cast``: exact t, analytic world
normals), bypassing the pixel sweep as JAX does, and shades with those
normals; ``sun_shadows`` casts one ray a pixel from its hit point (the
camera on a miss) toward the sun (``caster.fast_multi_origin``) and shades
the pixels it hits as shadowed; ``procedural_textures=False`` shades the
flat table albedo (no patterns, image textures or contact AO).

Spans (``utils/profiling.annotate``), inside ``Pipeline.render``'s
``gen.render``: ``gen.render.world`` (the caster's frame world),
``gen.render.sweep`` (the pixel rays through depth, instance and the far
clip), ``gen.render.rgb``, ``gen.render.labels`` (pixel counts, boxes, the
pose record, the point count) and ``gen.render.keypoints``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import camera as cam_mod
from ..core import transforms
from ..scene import world as world_mod
from ..utils.profiling import annotate as span
from . import raycast, rgb_kernel, shading as sh
from .sweep_kernel import PixelSweeper

Tensor = torch.Tensor

GROUP_SURFACE_TOL = 0.5  # metres: own-group first hit still counts as visible


class FrameAnnotations(NamedTuple):
    depth: Tensor  # (B, H, W) pinhole depth; +inf on sky and beyond the far clip
    instance: Tensor  # (B, H, W) int32 instance id, -1 ground, -2 sky
    rgb: Tensor  # (B, H, W, 3) uint8
    camera_pose7: Tensor  # (B, 7) [x y z qx qy qz qw]
    inst_visible: Tensor  # (B, O) bool
    inst_pixel_count: Tensor  # (B, O) int32
    bbox2d: Tensor  # (B, O, 4) int32 [u_min, v_min, u_max, v_max]; -1 if unseen
    center: Tensor  # (B, O, 3)
    size: Tensor  # (B, O, 3)
    euler_deg: Tensor  # (B, O, 3)
    kpt_uv: Tensor  # (B, O, K, 2)
    kpt_depth: Tensor  # (B, O, K)
    kpt_in_image: Tensor  # (B, O, K) bool
    kpt_visible: Tensor  # (B, O, K) bool
    pointcloud_count: Tensor  # (B,) int32


def _pixel_labels(instance: Tensor, O: int):
    """Pixel counts (B, O) and pixel-tight 2D boxes (B, O, 4) [u_min, v_min,
    u_max, v_max] from per-row and per-column instance histograms (the JAX
    pass's row/column presence): histogram bins are (frame, row or column,
    instance), so few pixels share a bin."""
    B, H, W = instance.shape
    dev = instance.device
    code = (instance.long() + 2)  # 0 sky, 1 ground, 2.. instances

    def hist(lines: int, line_idx: Tensor) -> Tensor:
        key = ((torch.arange(B, device=dev)[:, None, None] * lines + line_idx) * (O + 2) + code)
        return torch.bincount(key.reshape(-1), minlength=B * lines * (O + 2)).reshape(
            B, lines, O + 2)[..., 2:]

    rows = hist(H, torch.arange(H, device=dev)[:, None])  # (B, H, O)
    cols = hist(W, torch.arange(W, device=dev)[None, :])  # (B, W, O)
    counts = rows.sum(1)
    big = 1 << 20

    def extent(present: Tensor, n: int):
        idx = torch.arange(n, device=dev)[None, :, None]
        return (torch.where(present, idx, big).amin(1), torch.where(present, idx, -1).amax(1))

    v_min, v_max = extent(rows > 0, H)
    u_min, u_max = extent(cols > 0, W)
    return counts, torch.stack([u_min, v_min, u_max, v_max], dim=-1)


def render_frame(roster: world_mod.Roster, caster: raycast.Raycaster,
                 sweeper: PixelSweeper, world, cam_pos: Tensor, target: Tensor,
                 intr: cam_mod.Intrinsics, lighting: sh.Lighting, shade_rgb: bool = True,
                 kpt_occlusion_tol: float = 0.02, bug_compatible: bool = False,
                 far_clip: float = 250.0, texels: Tensor | None = None,
                 analytic_normals: bool = False, sun_shadows: bool = False,
                 procedural_textures: bool = True) -> FrameAnnotations:
    """Annotate B frames: world (``build_world``), cam_pos/target (B, 3),
    batched ``lighting``; ``texels`` (``textures.dense_table``) textures the
    RGB and nothing else. ``analytic_normals``, ``sun_shadows`` and
    ``procedural_textures`` select the RGB tiers of the module docstring;
    only ``analytic_normals`` reaches the labels (exact t in place of the
    packed sweep's)."""
    B = cam_pos.shape[0]
    H, W = intr.height, intr.width
    dev = cam_pos.device
    O = roster.num_instances

    normal = None
    if not analytic_normals:
        # The pixel sweep and the keypoint segments' below sweep from the
        # camera: the world the caster prepares for it holds what both need
        # (the hifi tier's mesh terms, built once a render).
        with span("gen.render.world"):
            world = caster.frame_world(world, cam_pos)
    with span("gen.render.sweep"):
        M = cam_mod.look_at_matrix(cam_pos, target)
        rd = cam_mod.pixel_rays(intr, M)
        if analytic_normals:
            # The exact caster: t exact (+inf on a miss), instance, world normal.
            px = caster.cast(world, cam_pos, rd.reshape(B, H * W, 3))
            t = px["t"].reshape(B, H, W)
            inst = px["inst"].reshape(B, H, W)
            normal = px["normal"].reshape(B, H, W, 3)
        else:
            # Pixel sweep: packed (t | inst + 2), INF-valued on a miss.
            t_px, code = raycast._unpack(sweeper(world, cam_pos, M))
            hit = t_px < raycast.INF * 0.99
            t = torch.where(hit, t_px, float("inf")).reshape(B, H, W)
            inst = (code - 2).reshape(B, H, W)

        # Depth is distance to the image plane: t * (d . view_forward).
        view_fwd = -M[:, :, 0]
        cosang = torch.sum(rd * view_fwd[:, None, None, :], dim=-1)
        depth = torch.where(torch.isfinite(t), t * cosang, float("inf"))
        # Far clip: geometry beyond the far plane is sky in every modality.
        clipped = depth >= far_clip
        depth = torch.where(clipped, float("inf"), depth)
        instance = torch.where(clipped, -2, inst).to(torch.int32)
        t = torch.where(clipped, float("inf"), t)

    inst_rot, inst_pos = world["inst_rot"], world["inst_pos"]
    with span("gen.render.rgb"):
        if shade_rgb:
            shadow_t = None
            if sun_shadows:
                # One ray a pixel from the hit point (the camera on a miss or
                # beyond the far clip), biased 1e-3 toward the sun.
                t_safe = torch.where(torch.isfinite(t), t, 0.0)[..., None]
                p_hit = cam_pos[:, None, None, :] + t_safe * rd
                sun = -lighting.sun_dir
                origins = p_hit + (sun * 1e-3)[:, None, None, :]
                shadow_t = caster.fast_multi_origin(
                    world, origins.reshape(B, H * W, 3),
                    sun[:, None, :].expand(B, H * W, 3))["t"].reshape(B, H, W).contiguous()
            rgb = rgb_kernel.fused_rgb(
                t.contiguous(), instance.contiguous(),
                rgb_kernel.instance_table(roster, inst_rot, inst_pos),
                rgb_kernel.ao_table(roster, inst_pos),
                rgb_kernel.rgb_params(M, cam_pos, intr, lighting), texels,
                None if normal is None else normal.contiguous(), shadow_t, procedural_textures)
        else:
            rgb = torch.zeros(B, H, W, 3, dtype=torch.uint8, device=dev)

    with span("gen.render.labels"):
        # Visible set, pixel counts, 2D boxes.
        counts, boxes = _pixel_labels(instance, O)
        inst_pixel_count = counts.to(torch.int32)
        inst_visible = inst_pixel_count > 0
        bbox2d = torch.where(inst_visible[..., None], boxes, -1).to(torch.int32)

        # 6DoF box labels through the reference's record path.
        T = transforms.make_transform(inst_rot, inst_pos)
        center, size, euler = transforms.bbox_record_to_pose(
            roster.tensor("inst_aabb_min", dev), roster.tensor("inst_aabb_max", dev),
            torch.swapaxes(T, -1, -2))
        pose7 = cam_mod.camera_pose7_xyzw(cam_pos, target, bug_compatible=bug_compatible)
        points = cam_mod.depth_valid_mask(depth).sum(dim=(1, 2)).to(torch.int32)

    with span("gen.render.keypoints"):
        # Keypoints: project, in-image test, occlusion along cam -> keypoint.
        kpts_w = world_mod.world_keypoints(inst_rot, inst_pos, world["kpts_local"])
        K = kpts_w.shape[2]
        kpt_flat = kpts_w.reshape(B, O * K, 3)
        seg = kpt_flat - cam_pos[:, None, :]
        seg_hit = caster.cast(world, cam_pos, seg) if analytic_normals else caster.fast(
            world, cam_pos, seg)
        t_occ, occ_inst = seg_hit["t"], seg_hit["inst"]
        uv, z = cam_mod.project(kpt_flat, cam_pos, M, intr)
        uv = uv.reshape(B, O, K, 2)
        z = z.reshape(B, O, K)
        in_img = ((z > 0) & (uv[..., 0] >= 0) & (uv[..., 0] < W) & (uv[..., 1] >= 0)
                  & (uv[..., 1] < H) & roster.tensor("inst_kpt_valid", dev))
        # Occluded iff the first surface along the segment is foreign and
        # closer than the keypoint; a first hit in the keypoint's own occlusion
        # group within GROUP_SURFACE_TOL of the keypoint is its own surface.
        grp = roster.tensor("inst_occlusion_group", dev).long()
        own = torch.arange(O, device=dev).repeat_interleave(K)
        beyond = t_occ > (1.0 - kpt_occlusion_tol)
        occ_grp = torch.where(occ_inst >= 0, grp[torch.clamp(occ_inst.long(), 0, O - 1)], -1)
        hit_to_kpt = (1.0 - t_occ) * z.reshape(B, -1)
        own_first = (occ_grp == grp[own]) & (hit_to_kpt <= GROUP_SURFACE_TOL)
        kpt_visible = in_img & (beyond | own_first).reshape(B, O, K)

    return FrameAnnotations(
        depth=depth,
        instance=instance,
        rgb=rgb,
        camera_pose7=pose7,
        inst_visible=inst_visible,
        inst_pixel_count=inst_pixel_count,
        bbox2d=bbox2d,
        center=center,
        size=size,
        euler_deg=euler,
        kpt_uv=uv,
        kpt_depth=z,
        kpt_in_image=in_img,
        kpt_visible=kpt_visible,
        pointcloud_count=points,
    )


def pointcloud_xyzrgb(depth: Tensor, rgb: Tensor, intr: cam_mod.Intrinsics,
                      camera_pose7: Tensor):
    """Depth (B, H, W) and RGB (B, H, W, 3) -> {xyzrgb (B, H*W, 6) f32,
    valid (B, H*W) bool}, through the reference's camera-pose fallback
    back-projection."""
    B = depth.shape[0]
    pts = cam_mod.backproject_depth_reference_quirk(depth, intr, camera_pose7)
    xyzrgb = torch.cat([pts.reshape(B, -1, 3), rgb.reshape(B, -1, 3).float()], dim=-1)
    return {"xyzrgb": xyzrgb, "valid": cam_mod.depth_valid_mask(depth).reshape(B, -1)}
