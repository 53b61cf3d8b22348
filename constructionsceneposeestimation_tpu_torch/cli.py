"""Command-line interface of the port (the ``generate``, ``train`` and
``train-eval`` commands of the JAX ``cli.py``).

  python -m constructionsceneposeestimation_tpu_torch.cli generate --out DIR --frames N
      Batched dataset generation, to the reference's file tree or
      (``--format packed``) to npz shards, resuming where a run stopped.
  python -m constructionsceneposeestimation_tpu_torch.cli train --steps N [--batch B]
      Datagen in the loop (or ``--data-dir`` shards) -> heatmap-regression
      training.
  python -m constructionsceneposeestimation_tpu_torch.cli train-eval --steps N ...
      Train (or restore), then evaluate PCK, the human keypoints, the
      dumper's and the crane's ADD on fresh frames with the trained model.

All run on the card unless ``--device cpu``. The printed lines read as
the JAX package's do. Not yet accepted: ``generate``'s ``--sequence-len``,
``--hifi`` and ``--image-textures``.
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import os
import time

import torch

# generate's flags whose paths are not ported yet.
NOT_PORTED = ("sequence_len", "hifi", "image_textures")


def cmd_generate(args) -> None:
    """Generate ``--frames`` frames in contiguous batches and write them,
    skipping the frames a resume manifest records as done. The host copy
    and the writes of batch i run on a writer thread while batch i+1 is
    generated."""
    from .config import Config, PipelineConfig, SceneConfig
    from .io import dataset_writer, packed, resume
    from .parallel import pipeline as pipeline_mod

    for flag in NOT_PORTED:
        if getattr(args, flag):
            raise SystemExit(f"--{flag.replace('_', '-')} is not ported to the PyTorch "
                             "package yet")
    cfg = Config(
        scene=SceneConfig(n_dumpers=args.n_dumpers, n_humans=args.n_humans),
        pipeline=PipelineConfig(
            render_width=args.width or args.size,
            render_height=args.height or args.size,
            batch_size=args.batch, max_iterations=args.frames, seed=args.seed,
        ))
    pipe = pipeline_mod.Pipeline(cfg, device=args.device)
    gen = pipe.make_generate_fn(ladder=args.ladder,
                                include_heatmaps=args.format == "packed" and args.heatmaps)

    # Pending ids batched into CONTIGUOUS runs: the pipeline's scene-cadence
    # dedup samples one scene per cadence group of the batch's ids, so a
    # batch with interior holes (after a partial resume) would render
    # frames with the wrong scene.
    chunks = resume.pending_chunks(args.out, args.frames, args.batch)
    n_pending = sum(len(c) for c in chunks)
    print(f"generating {n_pending}/{args.frames} frames "
          f"(resume skipped {args.frames - n_pending}, format={args.format})")
    writer = None
    if args.format == "reference":
        writer = dataset_writer.DatasetWriter(cfg, root=args.out, echo_log=args.verbose)
    else:
        packed.save_manifest(args.out, pipe.roster, cfg)
    t0 = time.time()
    done = 0

    def flush(copy, chunk):
        batch = copy.wait()
        if writer is not None:
            writer.write_batch(batch, pipe.roster)
        else:
            packed.save_shard(os.path.join(args.out, f"shard_{chunk[0]:06d}.npz"), batch,
                              pipe.roster)
            resume.record_completed(args.out, [int(f) for f in chunk])

    # Double buffering: batch i's copy is queued on the card and its writes
    # submitted to the writer thread before batch i+1 is generated; the loop
    # waits for batch i's writes only after generating batch i+1.
    inflight = None
    with cf.ThreadPoolExecutor(max_workers=1) as io_thread:
        for ci, chunk in enumerate(chunks):
            # Static batch shape: pad short chunks with repeats of the last
            # id (same id -> same scene group; rewritten files are
            # bit-identical thanks to per-frame determinism).
            ids = (chunk + [chunk[-1]] * (args.batch - len(chunk)))[: args.batch]
            with torch.no_grad():
                copy = pipeline_mod.HostCopy(gen(args.seed, ids))
            if inflight is not None:
                inflight[0].result()
                done += len(inflight[1])
                if args.verbose or ci % 10 == 0:
                    fps = done / max(time.time() - t0, 1e-9)
                    print(f"  {done}/{n_pending} frames ({fps:.1f} fps incl. writes)")
            inflight = (io_thread.submit(flush, copy, chunk), chunk)
        if inflight is not None:
            inflight[0].result()
            done += len(inflight[1])
    if writer is not None:
        print(writer.finish())
    else:
        print(f"done: {done} frames in {time.time() - t0:.1f}s "
              f"({done / max(time.time() - t0, 1e-9):.1f} fps incl. writes)")


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
    if done < args.steps and args.data_dir:
        step_fn = train_loop.make_data_train_step(cfg, model)
        state, done = _offline_train(
            args, state, mgr, done, fields=("rgb", "heatmaps"),
            run_one=lambda st, seed, b: step_fn(st, seed, b["rgb"], b["heatmaps"]))
    elif done < args.steps:
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


def _offline_train(args, state, mgr, done, fields, run_one, roster=None):
    """Shared host loop for --data-dir training: stream reader batches into a
    per-batch step until --steps. Returns (state, done)."""
    from .io import reader

    ds = reader.ShardDataset(args.data_dir)
    missing = [f for f in fields if f not in ds.fields]
    if missing:
        raise SystemExit(
            f"shards under {args.data_dir} lack fields {missing} — write them "
            f"with `generate --format packed"
            + (" --heatmaps" if "heatmaps" in missing else "") + "`")
    ds_hw = ds.field_shape("rgb")[1:3]
    if ds_hw != (args.size, args.size):
        raise SystemExit(
            f"dataset frames are {ds_hw[0]}x{ds_hw[1]} but --size is "
            f"{args.size} — pass --size {ds_hw[0]} to train on this dataset")
    if roster is not None:
        # The shards' instance axis must match the training roster, or the
        # per-instance targets (crane slices, class ids) silently misalign.
        want = list(roster.inst_class_names)
        have = (ds.manifest or {}).get("inst_class_names")
        if have is None and "bbox2d" in ds.fields:
            n = ds.field_shape("bbox2d")[1]
            have = want if n == len(want) else [f"<{n} instances>"]
        if have is not None and list(have) != want:
            raise SystemExit(
                f"dataset instance layout ({len(have)} instances) does not "
                f"match the training scene ({len(want)}: check --n-dumpers/"
                f"--n-humans) — regenerate with matching `generate "
                f"--n-dumpers/--n-humans` flags")
    for flag in ("hifi_mix", "camera_mix"):
        if getattr(args, flag, 0):
            raise SystemExit(
                f"--{flag.replace('_', '-')} configures the on-device "
                f"generator and has no effect with --data-dir — drop one of "
                f"the two flags (the dataset's geometry/cameras are fixed at "
                f"generate time)")
    steps_per_epoch = len(ds) // args.batch
    if steps_per_epoch == 0:
        raise SystemExit(
            f"dataset has {len(ds)} frames < --batch {args.batch}: "
            f"generate more frames or lower --batch")
    need = args.steps - done
    # batches() drops each epoch's remainder, so size epochs by the FLOOR
    # steps-per-epoch (an undercount here silently ends training early).
    epochs = -(-need // steps_per_epoch) + 1
    seed = args.seed + 1
    t0, trained0 = time.time(), done
    for b in ds.batches(args.batch, fields=list(fields), seed=args.seed, epochs=epochs):
        if done >= args.steps:
            break
        state, metrics = run_one(state, seed, b)
        done += 1
        if done % 50 == 0 or done == args.steps:
            print(f"step {done}: loss={float(metrics['loss']):.5f} "
                  f"({(done - trained0) * args.batch / (time.time() - t0):.1f}"
                  f" img/s avg, offline shards)")
        if mgr is not None and mgr.maybe_save(state):
            print(f"checkpointed step {int(state.step)}")
    return state, done


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
    p.add_argument("--data-dir", default=None,
                   help="train from packed npz shards (io/reader) instead of the "
                        "generator: the consumer side of `generate --format packed`")
    p.add_argument("--inner", type=int, default=inner, help="train steps between log lines")
    p.add_argument("--ckpt-dir", default=None,
                   help="checkpoint dir (restore if present, save at end)")
    p.add_argument("--save-every", type=int, default=0,
                   help="also checkpoint every N steps mid-run (0 = only at the end)")
    _device_flag(p)


def _device_flag(p) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device: the card unless 'cpu' is asked for")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="constructionsceneposeestimation_tpu_torch.cli")
    sub = ap.add_subparsers(dest="cmd", required=True)
    g = sub.add_parser("generate", help="batched dataset generation")
    g.add_argument("--out", default="dataset_construction_world2_v3")
    g.add_argument("--frames", type=int, default=41)
    g.add_argument("--batch", type=int, default=8)
    g.add_argument("--size", type=int, default=512)
    g.add_argument("--width", type=int, default=None,
                   help="override width (e.g. 1280 for the reference's 1280x720)")
    g.add_argument("--height", type=int, default=None)
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--ladder", action="store_true",
                   help="use the reference's 41-viewpoint systematic ladder")
    g.add_argument("--format", choices=["reference", "packed"], default="reference",
                   help="reference: exact drop-in text/PNG tree; packed: npz shards")
    g.add_argument("--heatmaps", action="store_true",
                   help="include f16 heatmap targets in packed shards")
    g.add_argument("--sequence-len", type=int, default=0, help="not ported yet")
    g.add_argument("--hifi", action="store_true", help="not ported yet")
    g.add_argument("--image-textures", action="store_true", help="not ported yet")
    g.add_argument("--n-dumpers", type=int, default=1,
                   help="dumpers per scene (match the trainer's scene when writing "
                        "--format packed training data)")
    g.add_argument("--n-humans", type=int, default=1, help="workers per scene")
    g.add_argument("--verbose", action="store_true")
    _device_flag(g)
    g.set_defaults(fn=cmd_generate)
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
