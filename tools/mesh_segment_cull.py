#!/usr/bin/env python3
"""Count, on the CPU, what the mesh sweep's segment walk culls on the
keypoint segments of ``chip_smoke.py``'s ``[mesh]`` frames.

    python3 tools/mesh_segment_cull.py [--frames 4] [--size 512] [--seed 3000]

Builds the hifi pipeline's frames as ``[mesh]`` builds them (default
``Config()``, ``sample_inputs(seed, range(frames))``) and prints, a segment
or a set of 32 segments: the blocks the group visits; the blocks a
segment's own slab test and its own box-sphere test hit, and their union
over a set; the words whose sphere some ray of the set passes by, within
the set's blocks and without the block level (each lane tests every
triangle of those words); the triangles the set keeps
(``render/meshcast.segment_cull_plain``: the pairs it tests), their mean,
least and most; the
triangles whose sphere a segment passes by (needed) and their union over a
set; and the pairs passing the kernel's test widened by 8 ulps, t > EPS
included, that the cull lost (must be 0). About 10 s at 4 frames. Imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from constructionsceneposeestimation_tpu_torch.config import Config, PipelineConfig  # noqa: E402
from constructionsceneposeestimation_tpu_torch.parallel.pipeline import Pipeline  # noqa: E402
from constructionsceneposeestimation_tpu_torch.render import meshcast as mc  # noqa: E402
from constructionsceneposeestimation_tpu_torch.scene import world as world_mod  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--seed", type=int, default=3000)
    args = ap.parse_args()
    cfg = Config(pipeline=PipelineConfig(render_width=args.size, render_height=args.size))
    pipe = Pipeline(cfg, device="cpu", hifi_mesh=True)
    n = args.frames
    inp = pipe.sample_inputs(args.seed, range(n))
    w = world_mod.build_world(pipe.roster, inp.pose)
    mesh, o = pipe.caster.mesh, inp.cam_pos
    kp = world_mod.world_keypoints(w["inst_rot"], w["inst_pos"], w["kpts_local"])
    seg = (kp.reshape(n, -1, 3) - o[:, None]).contiguous()
    m = mesh.mesh_terms(w, o)
    lay = mesh.layout(seg.shape[1])
    rays = mc.group_rays(seg, lay)
    B, G, R = rays.shape[:3]
    S = -(-R // mc.SET)
    u = rays / torch.linalg.norm(rays, dim=-1, keepdim=True)

    def sets(x):  # (b, g, R, ...) -> (b, g, S, SET, ...), padded with False
        pad = torch.zeros(x.shape[:2] + (S * mc.SET - R,) + x.shape[3:], dtype=x.dtype)
        return torch.cat([x, pad], 2).reshape(*x.shape[:2], S, mc.SET, *x.shape[3:])

    visited = mc.block_hits(o, rays, m.lo, m.hi)  # (B, G, nb)
    slab = torch.stack([mc._aabb_hit_any(o, rays[:, :, r:r + 1], m.lo, m.hi)
                        for r in range(R)], 2)  # (B, G, R, nb)
    box = mc._ray_meets(u[..., None, :], mc.box_spheres(m.lo, m.hi, o)[:, None, None])
    blocks = sets(box).any(3) & visited[:, :, None]  # (B, G, S, nb)
    ws = mc.word_spheres(m.spheres).transpose(2, 3)  # (B, nb, WORDS, 4)
    word = sets(torch.stack([mc._ray_meets(u[..., None, :], ws[:, None, None, k])
                             for k in range(mesh.n_blocks)], 3)).any(3)  # (B, G, S, nb, W)
    kept = (mc.segment_cull_plain(m.lo, m.hi, m.spheres, o, seg, lay)
            & visited[:, :, None, :, None])
    W, tn = mc.block_matrices(m.terms)
    sph = m.spheres.transpose(2, 3)
    need = need_union = lost = passing = 0
    for b in range(B):
        for g in range(G):
            for k in torch.nonzero(visited[b, g])[:, 0].tolist():
                met = mc._ray_meets(u[b, g][:, None], sph[b, k][None])  # (R, T)
                need += int(met.sum())
                need_union += int(sets(met[None, None])[0, 0].any(1).sum())
                wid = mc.pair_passes(W[b, k][None], rays[b, g][None], 8.0, tn[b, k][None])[0]
                passing += int(wid.sum())
                lost += int((wid & ~kept[b, g, :, k].repeat_interleave(mc.SET, 0)[:R]).sum())
    per_set = B * G * S
    print(f"{n} frames at {args.size}^2, {R} segments a frame in {lay}; {mesh.n_blocks} blocks")
    print(f"blocks the group visits: {visited.sum(-1).float().mean().item():.2f}")
    print(f"a segment's own slab test: {slab.sum(-1).float().mean().item():.2f} blocks, union "
          f"over a set {sets(slab).any(3).sum(-1).float().mean().item():.2f}; its own box "
          f"sphere: {box.sum(-1).float().mean().item():.2f}, union "
          f"{sets(box).any(3).sum(-1).float().mean().item():.2f}")
    in_blocks = int((word & blocks[..., None]).sum()) / per_set
    print(f"words a set passes by within its blocks: {in_blocks:.2f} ({32 * in_blocks:.1f} "
          f"triangle spheres a lane tests); without the block level "
          f"{int((word & visited[:, :, None, :, None]).sum()) / per_set:.2f}")
    per = kept.sum((-1, -2)).float()
    print(f"triangles a set keeps (pair tests a segment): {int(kept.sum()) / per_set:.2f}, "
          f"from {per.min().item():.0f} to {per.max().item():.0f}; "
          f"needed a segment {need / (B * G * R):.3f}, their union a set {need_union / per_set:.2f}")
    print(f"pairs passing the test widened by 8 ulps (t > EPS included): {passing}; lost {lost}")
    return 0 if lost == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
