#!/usr/bin/env python3
"""How many table rows the analytic caster kernel's bundle cull keeps, by
its plain mirror, on the CPU or the card.

    python3 tools/raycast_cull_rows.py [--size 512] [--frames 2] [--seed 0]
                                       [--bundle 32 16 8] [--device cpu]

Samples ``--frames`` frames of the default roster at ``--size``², casts
their pixel rays exactly, builds the shadow rays from the hits toward the
sun (the camera where a ray misses, as ``render_frame`` does) and the
keypoint segments, and runs ``render/raycast.bundle_cull_plain`` over the
three ray sets: the pixel rays on the kind table (the ``exact`` mode),
the shadow rays on it (``multi``), the segments on the packed table
(``packed``). For each bundle width of ``--bundle`` (32 is the kernel's
warp; 16 and 8 split each warp into sub-bundles whose kept sets are
joined, a variant the kernel does not have) it prints the rows kept a
warp (the mean over warps), the rows kept a ray (weighted by the rays a
warp holds) beside the rows a ray needs (``raycast.needed_rows``), the
share of warps that keep every row and, for the shadow rays, the share of
warps that mix camera and surface origins with the rows they keep.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--frames", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--bundle", type=int, nargs="+", default=[32])
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args(argv)

    import torch
    from constructionsceneposeestimation_tpu_torch.config import Config, PipelineConfig
    from constructionsceneposeestimation_tpu_torch.core import camera as cam_mod
    from constructionsceneposeestimation_tpu_torch.parallel.pipeline import Pipeline
    from constructionsceneposeestimation_tpu_torch.render import raycast
    from constructionsceneposeestimation_tpu_torch.scene import world as world_mod

    B, res = args.frames, args.size
    pipe = Pipeline(Config(pipeline=PipelineConfig(render_width=res, render_height=res,
                                                   batch_size=B)), device=args.device)
    caster = pipe.caster
    inputs = pipe.sample_inputs(args.seed, range(B))
    world = world_mod.build_world(pipe.roster, inputs.pose)
    cam = inputs.cam_pos.contiguous()
    px = cam_mod.pixel_rays(pipe.intr, cam_mod.look_at_matrix(cam, inputs.target))
    px = px.reshape(B, -1, 3).contiguous()
    t = caster.plain_cast(world, cam, px)["t"]
    sky = ~torch.isfinite(t)
    sun = -inputs.lighting.sun_dir
    shadow_o = (cam[:, None] + torch.where(sky, 0.0, t)[..., None] * px
                + (sun * 1e-3)[:, None]).contiguous()
    shadow_d = sun[:, None].expand_as(px).contiguous()
    kp = world_mod.world_keypoints(world["inst_rot"], world["inst_pos"], world["kpts_local"])
    seg = (kp.reshape(B, -1, 3) - cam[:, None]).contiguous()
    print(f"{B} frames of {res}^2, seed {args.seed}, on {args.device}")
    for mode, table, o, d in (("exact", caster.kind_table, cam, px),
                              ("multi", caster.kind_table, shadow_o, shadow_d),
                              ("packed", caster.packed_table, cam, seg)):
        S, N = len(table.rows), d.shape[1]
        need = float(raycast.needed_rows(table, world, o, d).sum(-1).float().mean())
        radii = table.radii_on(d.device)
        for width in args.bundle:
            if raycast.WARP % width:
                raise SystemExit(f"--bundle {width} does not divide a warp of {raycast.WARP}")
            raycast.WARP = width  # the mirror's bundle width, restored below
            try:
                sub = raycast.bundle_cull_plain(table, radii, world, o, d)
            finally:
                raycast.WARP = 32
            W = -(-N // 32)
            pad = torch.zeros(B, W * (32 // width) - sub.shape[1], S, dtype=torch.bool)
            keep = torch.cat([sub, pad.to(sub.device)], 1).reshape(B, W, -1, S).any(2)
            rows = keep.sum(-1).float()  # (B, W)
            lanes = torch.full((W,), 32.0, device=rows.device)
            lanes[-1] = N - (W - 1) * 32
            line = (f"{mode}, bundles of {width}: {float(rows.mean()):.4f} rows kept a warp, "
                    f"{float((rows * lanes).sum()) / (B * N):.4f} a ray of {S} (needs "
                    f"{need:.4f}); {100 * float((rows == S).float().mean()):.3f}% of the warps "
                    f"keep every row")
            if mode == "multi":
                s_w = raycast._warps(sky, W)
                mixed = s_w.any(2) & ~s_w.all(2)
                line += (f"; {100 * float(mixed.float().mean()):.3f}% mix camera and surface "
                         f"origins and keep {float(rows[mixed].mean()):.2f} rows, the others "
                         f"{float(rows[~mixed].mean()):.2f}")
            print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
