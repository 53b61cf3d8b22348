"""The consumer of a generated batch, and the numbers that decide
``correct``: the program's outputs against the plain reference's, each
number held to its limit in ``limits/<cell>.json``.
"""

from __future__ import annotations

import math

import torch

F32 = torch.float32
POSE_FIELDS = ("camera_pose7", "center", "size", "euler_deg")
# A pixel's depth is off where it differs by more than this share of the
# reference's depth.
DEPTH_REL = 1e-4


def consume(b) -> torch.Tensor:
    """A f32 device scalar that reads every modality of a batch with a full
    reduction: the port's ``bench.consume`` term by term (14 fields;
    non-finite values count 0, integer and boolean fields are summed as
    f32)."""

    def fin(x):
        return torch.where(torch.isfinite(x), x, 0.0).sum()

    def count(x):
        return x.sum().to(F32)

    return (fin(b.depth) + b.rgb.sum(dtype=F32) + count(b.instance) + b.heatmaps.sum()
            + fin(b.kpt_uv) + count(b.kpt_visible) + count(b.kpt_in_image)
            + fin(b.center) + fin(b.size) + fin(b.euler_deg) + count(b.bbox2d)
            + fin(b.camera_pose7) + count(b.inst_pixel_count) + count(b.pointcloud_count))


def _max(x: torch.Tensor) -> float:
    return float(x.max()) if x.numel() else 0.0


def _finite_gap(p: torch.Tensor, r: torch.Tensor) -> float:
    """The largest |p - r| where both are finite; inf where one side is
    finite and the other not."""
    p, r = p.to(F32), r.to(F32)
    fp, fr = torch.isfinite(p), torch.isfinite(r)
    if not torch.equal(fp, fr):
        return math.inf
    return _max((p - r).abs()[fr])


def rgb_gaps(p: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Each frame's mean |p - r| of (B, H, W, 3) u8 images, in levels.

    The RGB cannot be held pixel by pixel: its hash noise is fract of sin
    of values near 1500 times 43758.5, so an ulp of the argument gives
    another noise value, and the kernel rounds the argument otherwise than
    the plain version on some pixels. A frame's mean gap stays near a level
    or two; a wrong shading, AO, albedo or frame moves it by tens."""
    d = (p.to(torch.int16) - r.to(torch.int16)).abs().to(F32)
    return d.reshape(d.shape[0], -1).mean(1)


def rgb_beyond_noise(p: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                     where: torch.Tensor) -> torch.Tensor:
    """Each frame's share of its pixels, among ``where``, that lie in some
    channel more than a level below ``lo`` or above ``hi``: the reference's
    images with the hash noise at either end (``reference/noise``), between
    which any noise puts a pixel. Held by the worst frame, this sees a fault
    that moves one instance's shading, which the mean over the frames
    dilutes; the noise that ``rgb_gaps`` has to average moves none."""
    p, lo, hi = (x.to(torch.int16) for x in (p, lo, hi))
    out = ((p < lo - 1) | (p > hi + 1)).any(-1) & where
    return out.reshape(out.shape[0], -1).to(F32).mean(1)


def label_terms(p, r) -> dict:
    """Labels off, in pixels or label entries: the pixel and point counts
    by how far they are off, each box corner off by more than a pixel and
    each keypoint flag that differs, as one."""
    d = lambda f: getattr(p, f).long() - getattr(r, f).long()
    return {"pixel_counts": float(d("inst_pixel_count").abs().sum()),
            "point_counts": float(d("pointcloud_count").abs().sum()),
            "box_corners": float((d("bbox2d").abs() > 1).sum()),
            "kpt_flags": float((d("kpt_visible") != 0).sum() + (d("kpt_in_image") != 0).sum())}


def frame_numbers(p, r, rgb_ends) -> dict:
    """The numbers compared on generated frames: ``p`` the program's,
    ``r`` the reference's, two batches of the same frames (every field of
    ``FrameBatch``), and ``rgb_ends`` the reference's (lo, hi) images with
    the hash noise at either end. Shares are of all the values of a field;
    a pixel's depth and RGB count where both sides hit the same instance."""
    if not torch.equal(p.frame_id.cpu(), r.frame_id.cpu()):
        raise ValueError("the program's and the reference's frames differ")
    same = p.instance == r.instance
    # depth off: by over DEPTH_REL of it where both are finite, or finite on one side only
    off = torch.where(torch.isfinite(p.depth) & torch.isfinite(r.depth),
                      (p.depth - r.depth).abs() > DEPTH_REL * r.depth.abs(),
                      torch.isfinite(p.depth) != torch.isfinite(r.depth))
    label_err = sum(label_terms(p, r).values())
    return {
        # scenes and cameras as sampled
        "inputs_gap": max(_finite_gap(getattr(p, f), getattr(r, f)) for f in POSE_FIELDS),
        # the pixel (or mesh) sweep
        "depth_far_share": float((off & same).to(F32).mean()),
        "instance_diff": float((~same).to(F32).mean()),
        # the keypoint caster
        "kpt_uv_gap_px": _finite_gap(p.kpt_uv, r.kpt_uv),
        # the labels: boxes, pixel and point counts, keypoint visibility
        "label_gap": label_err / p.frame_id.shape[0],
        # the heatmaps and the RGB
        "heatmap_gap": _finite_gap(p.heatmaps, r.heatmaps),
        "rgb_mean_gap": float(rgb_gaps(p.rgb, r.rgb).mean()),
        "rgb_beyond_noise": float(rgb_beyond_noise(p.rgb, *rgb_ends, same).max()),
    }


def leaf_gaps(prog: dict, ref: dict, keep=None) -> dict:
    """Each leaf's gap between the program's norm and the reference's, over
    the reference's norm of that leaf or of the median leaf, whichever is
    larger. ``prog`` and ``ref`` map leaf names to tensors; ``keep`` names
    the leaves counted (all where None)."""
    names = [n for n in ref if keep is None or n in keep]
    if not names:
        return {}
    pn = {n: float(torch.linalg.vector_norm(prog[n].to(F32))) for n in names}
    rn = {n: float(torch.linalg.vector_norm(ref[n].to(F32))) for n in names}
    med = sorted(rn.values())[len(names) // 2]
    return {n: abs(pn[n] - rn[n]) / max(rn[n], med, 1e-30) for n in names}


def leaf_diffs(prog: dict, ref: dict) -> dict:
    """Each leaf's norm of the difference between the program's tensor and
    the reference's, over the reference's norm of that leaf or of the median
    leaf, whichever is larger."""
    dn = {n: float(torch.linalg.vector_norm(prog[n].to(F32) - ref[n].to(F32))) for n in ref}
    rn = {n: float(torch.linalg.vector_norm(ref[n].to(F32))) for n in ref}
    med = sorted(rn.values())[len(rn) // 2] if rn else 0.0
    return {n: dn[n] / max(rn[n], med, 1e-30) for n in ref}


def whole_diff(prog: dict, ref: dict) -> float:
    """The norm of the difference between the program's leaves and the
    reference's, all leaves as one vector, over the reference's norm. Unlike
    ``leaf_gaps``, which is second order in an error that is random from
    element to element, this is first order."""
    d = sum(float(torch.linalg.vector_norm(prog[n].to(F32) - ref[n].to(F32))) ** 2 for n in ref)
    r = sum(float(torch.linalg.vector_norm(ref[n].to(F32))) ** 2 for n in ref)
    return math.sqrt(d / max(r, 1e-30))


def leaf_gap(prog: dict, ref: dict, keep=None) -> float:
    """The worst leaf's ``leaf_gaps``."""
    return max(leaf_gaps(prog, ref, keep).values(), default=0.0)


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, checks): every number at or under its limit; a number
    with no limit, or a limit with no number, is not correct."""
    checks = {k: {"value": v, "limit": limits.get(k)} for k, v in numbers.items()}
    ok = bool(limits) and set(limits) <= set(numbers) and all(
        c["limit"] is not None and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
