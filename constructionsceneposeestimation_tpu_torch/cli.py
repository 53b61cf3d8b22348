"""Command-line interface of the port (the ``train`` and ``train-eval``
commands of the JAX ``cli.py``).

  python -m constructionsceneposeestimation_tpu_torch.cli train --steps N [--batch B]
      Datagen in the loop -> heatmap-regression training.
  python -m constructionsceneposeestimation_tpu_torch.cli train-eval --steps N ...
      Train (or restore), then evaluate PCK, the human keypoints, the
      dumper's and the crane's ADD on fresh frames with the trained model.

Both run on the card unless ``--device cpu``. The printed lines read as
the JAX package's do. Not yet accepted: ``--data-dir`` (the offline
reader).
"""

from __future__ import annotations

import argparse
import time

import torch


def _run_training(args):
    """Shared train driver: build model and pipeline, restore a checkpoint
    if there is one, run ``--inner`` steps between log lines, save. Returns
    (cfg, model, pipe, state)."""
    from .config import Config, PipelineConfig, TrainConfig
    from .models import pose_net
    from .parallel import pipeline as pipeline_mod
    from .train import loop as train_loop

    cfg = Config(
        pipeline=PipelineConfig(render_width=args.size, render_height=args.size),
        train=TrainConfig(batch_size=args.batch, steps=max(args.steps, 1), loss=args.loss,
                          camera_mix=args.camera_mix),
    )
    model = pose_net.make_model(lite=args.lite, device=args.device, seed=args.seed)
    pipe = pipeline_mod.Pipeline(cfg, device=args.device)
    state = train_loop.create_train_state(cfg, model)
    mgr = None
    if args.ckpt_dir:
        from .train import checkpoint
        mgr = checkpoint.CheckpointManager(args.ckpt_dir, save_every=args.save_every)
        if mgr.latest_step() is not None:
            state = mgr.restore(state)
            print(f"restored checkpoint at step {int(state.step)}")
    done = trained_from = int(state.step)
    if done < args.steps:
        inner = max(1, min(args.inner, args.steps))
        run = train_loop.make_scanned_train_fn(cfg, model, pipe, inner)
        seed = args.seed + 1
        t0 = time.time()
        while done < args.steps:
            state, metrics = run(state, seed, done * args.batch)
            done += inner
            print(f"step {done}: loss={float(metrics['loss']):.5f} "
                  f"({(done - trained_from) * args.batch / (time.time() - t0):.1f} img/s avg)")
            if mgr is not None and mgr.maybe_save(state):
                print(f"checkpointed step {int(state.step)}")
    if done > trained_from and mgr is not None:
        mgr.maybe_save(state, force=True)
        print(f"saved checkpoint at step {int(state.step)} -> {args.ckpt_dir}")
    if mgr is not None:
        mgr.close()
    return cfg, model, pipe, state


def cmd_train(args) -> None:
    _run_training(args)


def cmd_train_eval(args) -> None:
    """Train (or restore), then evaluate PCK and equipment ADD with the
    trained model on ``--eval-frames`` fresh frames of another seed."""
    from .eval import pipeline as eval_pipeline
    from .scene import assets

    cfg, model, pipe, state = _run_training(args)
    model.eval()
    # Held-out frames of another seed; --eval-ladder takes the reference's
    # close-range ladder viewpoints instead of the far DR sampler.
    gen = pipe.make_generate_fn(ladder=args.eval_ladder)
    with torch.no_grad():
        batch = gen(args.seed + 1000, range(args.eval_frames))
    out, _ = eval_pipeline.evaluate_model(model, batch, pipe.roster, pipe.intr,
                                          cfg.pipeline.heatmap_stride, cfg.train.loss,
                                          args.pnp_threshold)
    for line in report_lines(out, assets.COCO_KEYPOINT_NAMES):
        print(line)


def report_lines(out, joint_names):
    """The evaluation lines of ``train-eval`` from ``evaluate_model``'s
    metrics, worded as the JAX command prints them."""
    floor, pck = out["decode_floor"], out["decode_model"]
    lines = [
        f"decode-floor PCK@0.5: {float(floor['pck']):.3f}  (n={int(floor['n_keypoints'])})",
        f"model PCK@0.5:        {float(pck['pck']):.3f}  "
        f"mean matched err {float(pck['mean_px_error_matched']):.2f} px",
        f"assoc decode floor:   {float(out['assoc_floor']['pck']):.3f}  "
        f"model assoc PCK@0.5: {float(out['assoc_model']['pck']):.3f} "
        f"(recall {float(out['assoc_model']['recall']):.3f})",
    ]
    for tag, key in (("DARK", "dark"), ("soft-argmax", "soft_argmax")):
        hfloor, hpck = out[f"human_floor_{key}"], out[f"human_model_{key}"]
        lines.append(f"human PCK@0.5 ({tag}):  floor {float(hfloor['pck']):.3f}  "
                     f"model {float(hpck['pck']):.3f} (n={int(hpck['n_keypoints'])}, "
                     f"err {float(hpck['mean_px_error']):.2f} px)")
        if key == "dark":
            per = [float(v) for v in hpck["pck_per_kpt"][:17]]
            worst = sorted(zip(joint_names, per), key=lambda x: x[1])[:4]
            lines.append("  weakest joints: " + " ".join(f"{n}={v:.2f}" for n, v in worst))
    d = out["dumper_scores"]
    lines.append(f"dumper channel scores: mean {float(d['mean']):.3f} max {float(d['max']):.3f} "
                 f">=0.3: {float(d['ge_0_3']):.2f} >=0.15: {float(d['ge_0_15']):.2f}")
    add_gt, add = out["dumper_gt_kpts"], out["dumper_model"]
    lines.append(f"dumper ADD (GT kpts):    mean {float(add_gt['add_mean']):.3f} m, "
                 f"ADD-0.1d {float(add_gt['add_0_1d']):.3f} "
                 f"(accepted {int(add_gt['n_accepted'])}/{int(add_gt['n_valid'])})")
    lines.append(f"dumper ADD (model kpts): mean {float(add['add_mean']):.3f} m, "
                 f"ADD-0.1d {float(add['add_0_1d']):.3f} "
                 f"(accepted {int(add['n_accepted'])}/{int(add['n_valid'])}, "
                 f"rmse {float(add['rmse']):.4f})")
    for tag, key in (("GT kpts", "crane_gt_kpts"), ("model kpts", "crane_model")):
        cr = out[key]
        parts = " ".join(
            f"{p.replace('crane', '')}={float(cr[f'add_0_1d_{p}']):.2f}"
            for p in ("cranebase", "cranecolumn", "craneboom", "cranetelescopic"))
        lines.append(f"crane ADD ({tag}):  mean {float(cr['add_mean']):.3f} m, "
                     f"ADD-0.1d {float(cr['add_0_1d']):.3f} [{parts}] "
                     f"(accepted {int(cr['n_accepted'])}/{int(cr['n_valid'])})")
    return lines


def _train_flags(p, steps: int, batch: int, inner: int) -> None:
    p.add_argument("--steps", type=int, default=steps)
    p.add_argument("--batch", type=int, default=batch)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--lite", action="store_true")
    p.add_argument("--loss", choices=["mse", "focal"], default="focal",
                   help="heatmap loss (focal = the README headline config)")
    p.add_argument("--camera-mix", type=float, default=0.0,
                   help="P(close-range ladder view) per train frame")
    p.add_argument("--inner", type=int, default=inner, help="train steps between log lines")
    p.add_argument("--ckpt-dir", default=None,
                   help="checkpoint dir (restore if present, save at end)")
    p.add_argument("--save-every", type=int, default=0,
                   help="also checkpoint every N steps mid-run (0 = only at the end)")
    p.add_argument("--device", default="cuda",
                   help="torch device: the card unless 'cpu' is asked for")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="constructionsceneposeestimation_tpu_torch.cli")
    sub = ap.add_subparsers(dest="cmd", required=True)
    t = sub.add_parser("train", help="heatmap-regression training")
    _train_flags(t, steps=100, batch=8, inner=10)
    t.set_defaults(fn=cmd_train)
    te = sub.add_parser("train-eval", help="train then PCK/ADD evaluation")
    _train_flags(te, steps=1000, batch=32, inner=50)
    te.add_argument("--eval-frames", type=int, default=16)
    te.add_argument("--pnp-threshold", type=float, default=0.15)
    te.add_argument("--eval-ladder", action="store_true",
                    help="evaluate on the close-range reference viewpoint ladder")
    te.set_defaults(fn=cmd_train_eval)
    return ap


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
