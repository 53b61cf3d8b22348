"""The least time the card could take for each hand-written kernel call of
a batch: the larger of the bytes its function must move over the memory
rate and its operations over the FP32 rate, counted from the call's own
inputs and the work they need, whatever the kernel culls. The counts are
the port's own (``chip_smoke.py``'s bound arithmetic as of the port's PR
19), copied here so that later changes to the program leave the yardstick
as it is; their helpers are the reference's frozen copies.

``capture(pipe)`` wraps the port's kernel wrappers while a batch runs and
keeps their arguments; ``Bounds.total_ms()`` adds up the bounds of the
first batch's calls, or is None where a kernel ran that has no count here.
"""

from __future__ import annotations

import contextlib
import functools
import importlib

import numpy as np
import torch

# NVIDIA's published H100 SXM peaks at a 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_DENSE_FLOPS = 989e12
# csrc/sweep.cu: a pixel ray's own operations and each primitive kind's
# (plane, sphere, upright cylinder, upright cone, axis-aligned box, yaw box,
# capsule, general box, general cylinder).
SWEEP_RAY_OPS = 43
SWEEP_KIND_OPS = {0: 12, 1: 27, 2: 44, 3: 97, 4: 37, 5: 57, 6: 97, 7: 79, 8: 83}
# csrc/rgb.cu: a hit pixel's work with three rays (the bound charges one),
# a ray, an AO row on a ground pixel, a sky pixel's path.
RGB_PIXEL_OPS = 259
RGB_RAY_OPS = 33
RGB_AO_ROW_OPS = 11
RGB_SKY_OPS = 83
# csrc/heatmap.cu: per (map pixel, visible keypoint of the map's channel).
HEATMAP_KPT_OPS = 9
# csrc/raycast.cu: a needed (ray, row) pair's operations by row kind, a
# generic row's local direction, the merge, a packed ray's own terms.
RAYCAST_ROW_OPS = {0: 10, 1: 30, 2: 45, 3: 69, 4: 99, 5: 72,
                   8: 5, 9: 25, 10: 59, 11: 91, 12: 33, 13: 52, 14: 83}
RAYCAST_LOCAL_OPS = 15
RAYCAST_MERGE_OPS = 3
RAYCAST_RAY_OPS = 28
# csrc/meshsweep.cu: a needed (ray, triangle) pair, and a pair that passes.
MESH_PAIR_OPS = 22
MESH_PASS_OPS = 4
# csrc/meshterms.cu: a corner, rigid or skinned, and a slot's own work.
MESH_TERMS_CORNER_OPS = {"rigid": 18, "skinned": 48}
MESH_TERMS_SLOT_OPS = 108

WRAPPERS = {"sweep": ("render.sweep_kernel", "sweep_cuda"),
            "rgb": ("render.rgb_kernel", "rgb_cuda"),
            "heatmap": ("ops.heatmap", "heatmap_cuda"),
            "raycast_packed": ("render.raycast", "packed_cuda"),
            "raycast_exact": ("render.raycast", "exact_cuda"),
            "raycast_multi": ("render.raycast", "multi_cuda"),
            "mesh_sweep": ("render.meshcast", "mesh_sweep_cuda"),
            "mesh_terms": ("render.meshcast", "mesh_terms_cuda")}
PACKAGE = "constructionsceneposeestimation_tpu_torch"


def bound_ms(nbytes: float, nops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, nops / F32_OPS_PER_S) * 1e3


def sweep_bound(si, sf, world, cam_pos, M, intr, radii) -> float:
    from reference.plain.render import sweep_kernel

    B = cam_pos.shape[0]
    n_px = B * intr.height * intr.width
    kind_ops = torch.tensor([SWEEP_KIND_OPS[k] for k in range(9)],
                            device=si.device)[si[:, 0].long()]
    row_px, _ = sweep_kernel.needed_pairs(si, radii, world, cam_pos, M, intr)
    ops = n_px * SWEEP_RAY_OPS + int((row_px * kind_ops).sum())
    nbytes = (n_px * 4 + B * 16 * 4 + world["prim_pos"].numel() * 4 * 4
              + si.numel() * 4 + sf.numel() * 4 + radii.numel() * 4)
    return bound_ms(nbytes, ops)


def rgb_bound(t, inst, table, ao, par, texels=None, normal=None, shadow_t=None,
              procedural=True) -> float | None:
    """The default variant's bound; None for a textured or tier variant."""
    from reference.plain.render import rgb_kernel

    if texels is not None or normal is not None or shadow_t is not None or not procedural:
        return None
    n_px = t.numel()
    n_hit = int(torch.isfinite(t).sum())
    ops = n_hit * (RGB_PIXEL_OPS - 2 * RGB_RAY_OPS) + (n_px - n_hit) * RGB_SKY_OPS
    ops += int(rgb_kernel.ao_rows_needed(t, inst, ao, par).sum()) * RGB_AO_ROW_OPS
    nbytes = n_px * (4 + 4 + 3) + 4 * (table.numel() + ao.numel() + par.numel())
    return bound_ms(nbytes, ops)


def heatmap_bound(uv, channel, visible, num_channels, height, width, sigma, stride) -> float:
    B = uv.shape[0]
    px = height * width
    nbytes = B * num_channels * px * 4 + uv.numel() * 4 + channel.numel() * 4 + visible.numel()
    return bound_ms(nbytes, int(visible.sum()) * px * HEATMAP_KPT_OPS)


def raycast_packed_bound(table, world, ray_o, ray_d, kept=None) -> float:
    from reference.plain.render import raycast

    meets = torch.zeros(len(table.rows), dtype=torch.int64, device=ray_d.device)
    for b in range(ray_d.shape[0]):
        meets += raycast.needed_rows(table, {"prim_pos": world["prim_pos"][b:b + 1]},
                                     ray_o[b:b + 1], ray_d[b:b + 1])[0].sum(0)
    ops = 0
    for op, n in zip(table.rows[:, 0].tolist(), meets.tolist()):
        pair = RAYCAST_ROW_OPS[op] + RAYCAST_MERGE_OPS + (RAYCAST_LOCAL_OPS if op <= 5 else 0)
        ops += n * pair
    rays = ray_d.shape[0] * ray_d.shape[1]
    ops += rays * RAYCAST_RAY_OPS
    sums = raycast.axis_sums(table, world, ray_o)
    nbytes = ((ray_o.numel() + ray_d.numel()) * 4 + rays * 4 + table.rows.size * 4
              + (world["prim_pos"].numel() + world["prim_rot"].numel()
                 + world["prim_params"].numel()) * 4 + (0 if sums is None else sums.numel() * 4))
    return bound_ms(nbytes, ops)


def mesh_sweep_bound(terms, lo, hi, spheres, codes, ray_o, ray_d, lay, visits=None, kept=None,
                     walk=None) -> float:
    from reference.plain.render import meshcast

    rays = meshcast.group_rays(ray_d, lay)
    triples = torch.nonzero(meshcast.block_hits(ray_o, rays, lo, hi))
    step = max(1, meshcast.MAX_PAIRS // (lay.rays * terms.shape[-1]))
    chunks = [triples[c:c + step].unbind(1) for c in range(0, triples.shape[0], step)]
    W, _ = meshcast.block_matrices(terms)
    sph = spheres.transpose(2, 3)
    needed = passes = 0
    for b, g, k in chunks:
        passes += int(meshcast.pair_passes(W[b, k], rays[b, g]).sum())
        d, s = rays[b, g], sph[b, k]
        v, r = s[..., :3], s[..., 3]
        tc = torch.bmm(d, v.transpose(1, 2))
        dd = torch.sum(d * d, -1)[..., None]
        vv, r2 = torch.sum(v * v, -1)[:, None], (r * r)[:, None]
        meets = ((tc > 0) & (vv * dd - tc * tc <= r2 * dd)) | (vv <= r2)
        needed += int((meets & (r >= 0)[:, None]).sum())
    n_rays = ray_d.shape[0] * ray_d.shape[1]
    nbytes = (terms.numel() + lo.numel() + hi.numel() + codes.numel() + ray_o.numel()
              + ray_d.numel() + n_rays) * 4
    return bound_ms(nbytes, needed * MESH_PAIR_OPS + passes * MESH_PASS_OPS)


def mesh_terms_bound(out, tables, inst_rot, inst_pos, prim_rot, prim_pos, ray_o,
                     tri_block) -> float:
    tab = {k: getattr(tables, k).cpu().numpy()
           for k in ("blocks", "faces", "bone_rows")}
    blocks, faces = tab["blocks"], tab["faces"]
    n = ray_o.shape[0]
    nb, T = out.spheres.shape[1], out.spheres.shape[3]
    rows = blocks[:, 1:2] + np.arange(T)
    rigid = blocks[:, 2] < 0
    rigid_v, skin_v = (np.unique(faces[rows[sel]]) for sel in (rigid, ~rigid))
    skins = np.unique(blocks[~rigid, 2])
    n_bones = tab["bone_rows"].shape[1]
    poses = len(np.unique(blocks[rigid, 0])) + len(np.unique(tab["bone_rows"][skins]))
    reads = (blocks.size + 3 * len(np.unique(rows)) + 3 * len(rigid_v)
             + (6 + 2 + 2) * len(skin_v) + n_bones * len(skins) + n * (3 + 12 * poses))
    nbytes = sum(t.numel() * t.element_size() for t in out[:4]) + 4 * reads
    skinned = int((blocks[:, 2] >= 0).sum()) * T * n
    ops = ((n * nb * T - skinned) * 3 * MESH_TERMS_CORNER_OPS["rigid"]
           + skinned * 3 * MESH_TERMS_CORNER_OPS["skinned"] + n * nb * T * MESH_TERMS_SLOT_OPS)
    return bound_ms(nbytes, ops)


BOUNDS = {"sweep": sweep_bound, "rgb": rgb_bound, "heatmap": heatmap_bound,
          "raycast_packed": raycast_packed_bound, "mesh_sweep": mesh_sweep_bound}


class Bounds:
    """The calls of the first captured batch, and their bounds."""

    def __init__(self):
        self.calls: list = []
        self.on = False

    def total_ms(self) -> float | None:
        """The sum of the calls' bounds; None where a call has no count or
        nothing was captured (the plain paths of a CPU run)."""
        if not self.calls:
            return None
        total = 0.0
        with torch.no_grad():
            for key, args, kwargs, out in self.calls:
                if key == "mesh_terms":
                    b = mesh_terms_bound(out, *args, **kwargs)
                elif key in BOUNDS:
                    b = BOUNDS[key](*args, **kwargs)
                else:
                    b = None
                if b is None:
                    return None
                total += b
        return total


@contextlib.contextmanager
def capture(batches: int = 1):
    """Wrap the port's kernel wrappers; the calls of the first ``batches``
    batches of the block keep their arguments. The block calls
    ``bounds.next_batch()`` before each batch."""
    bounds = Bounds()
    undo = []
    state = {"batch": -1}

    def wrap(key, fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            if 0 <= state["batch"] < batches:
                bounds.calls.append((key, args, kwargs, out))
            return out

        return wrapped

    bounds.next_batch = lambda: state.__setitem__("batch", state["batch"] + 1)
    for key, (mod, name) in WRAPPERS.items():
        m = importlib.import_module(f"{PACKAGE}.{mod}")
        fn = getattr(m, name)
        setattr(m, name, wrap(key, fn))
        undo.append((m, name, fn))
    try:
        yield bounds
    finally:
        for m, name, fn in reversed(undo):
            # the wrapper counted the launches; hand the counts back
            for attr, v in vars(getattr(m, name)).items():
                if attr != "__wrapped__":
                    setattr(fn, attr, v)
            setattr(m, name, fn)
