"""Command-line interface of the port (the ``generate``, ``train``,
``train-eval``, ``train-crop``, ``train-detect``, ``infer``, ``seq-eval``
and ``bench`` commands of the JAX ``cli.py``).

  python -m constructionsceneposeestimation_tpu_torch.cli generate --out DIR --frames N
      Batched dataset generation, to the reference's file tree or
      (``--format packed``) to npz shards, resuming where a run stopped;
      ``--sequence-len N`` writes clips, ``--hifi`` the CAD-mesh tier,
      ``--image-textures`` the image-texture tier.
  python -m constructionsceneposeestimation_tpu_torch.cli train --steps N [--batch B]
      Datagen in the loop (or ``--data-dir`` shards) -> heatmap-regression
      training.
  python -m constructionsceneposeestimation_tpu_torch.cli train-eval --steps N ...
      Train (or restore), then evaluate PCK, the human keypoints, the
      dumper's and the crane's ADD on fresh frames with the trained model.
  python -m constructionsceneposeestimation_tpu_torch.cli train-crop --cls dumper ...
      Second-stage crop training around one equipment class, then its
      two-stage 6DoF on fresh frames with the label boxes.
  python -m constructionsceneposeestimation_tpu_torch.cli train-detect ...
      CenterNet detector training and its P/R and mAP; with crop
      checkpoints, the full two-stage path from detector boxes.
  python -m constructionsceneposeestimation_tpu_torch.cli infer --det-ckpt D --crop-ckpt C
      The deployment loop: detector, ROI crops, keypoints, the ground-prior
      and crane solves, one JSON line a frame.
  python -m constructionsceneposeestimation_tpu_torch.cli seq-eval --poses P --sequence-len N
      Temporal metrics of ``infer --sequence-len N`` records.
  python -m constructionsceneposeestimation_tpu_torch.cli bench
      The headline datagen benchmark (``bench.py`` of this package): one
      JSON line of annotated 512x512 frames/s.

All run on the card unless ``--device cpu``. The printed lines read as
the JAX package's do.
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import json
import os
import time

import torch

def cmd_generate(args) -> None:
    """Generate ``--frames`` frames in contiguous batches and write them,
    skipping the frames a resume manifest records as done. The host copy
    and the writes of batch i run on a writer thread while batch i+1 is
    generated."""
    from .config import Config, PipelineConfig, SceneConfig
    from .io import dataset_writer, packed, resume
    from .parallel import pipeline as pipeline_mod

    cfg = Config(
        scene=SceneConfig(n_dumpers=args.n_dumpers, n_humans=args.n_humans),
        pipeline=PipelineConfig(
            render_width=args.width or args.size,
            render_height=args.height or args.size,
            batch_size=args.batch, max_iterations=args.frames, seed=args.seed,
        ))
    pipe = pipeline_mod.Pipeline(cfg, device=args.device, hifi_mesh=args.hifi,
                                 image_textures=args.image_textures)
    want_hms = args.format == "packed" and args.heatmaps
    if args.sequence_len:
        gen = pipe.make_sequence_fn(args.sequence_len, include_heatmaps=want_hms)
    else:
        gen = pipe.make_generate_fn(ladder=args.ladder, include_heatmaps=want_hms)

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
    model = pose_net.make_model(device=args.device, seed=args.seed,
                                backbone=args.backbone.replace("-", "_"))
    pipe = pipeline_mod.Pipeline(cfg, device=args.device)
    mgr = _manager(args)
    state = _restore_latest(mgr, train_loop.create_train_state(cfg, model))
    done = trained_from = int(state.step)
    if done < args.steps and args.data_dir:
        step_fn = train_loop.make_data_train_step(cfg, model)
        state, done = _offline_train(
            args, state, mgr, done, fields=("rgb", "heatmaps"),
            run_one=lambda st, seed, b: step_fn(st, seed, b["rgb"], b["heatmaps"]))
    elif done < args.steps:
        run = train_loop.make_scanned_train_fn(cfg, model, pipe, max(1, min(args.inner,
                                                                            args.steps)))
        state = _train_loop(args, state, mgr, run, lambda done, m, rate: (
            f"step {done}: loss={float(m['loss']):.5f} ({rate:.1f} img/s avg)"))
    _save_final(args, mgr, state, trained_from)
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
        lines.append(f"crane ADD ({tag}):  mean {float(cr['add_mean']):.3f} m, "
                     f"ADD-0.1d {float(cr['add_0_1d']):.3f} [{_parts(cr)}] "
                     f"(accepted {int(cr['n_accepted'])}/{int(cr['n_valid'])})")
    return lines


def _restore_model(directory: str, cfg, model):
    """``model`` with the weights of the latest checkpoint under
    ``directory``, in eval mode."""
    from .train import checkpoint
    from .train import loop as train_loop

    mgr = checkpoint.CheckpointManager(directory, save_every=0)
    state = mgr.restore(train_loop.create_train_state(cfg, model))
    mgr.close()
    return state.model.eval()


def _train_loop(args, state, mgr, run, line):
    """Run ``run`` (``--inner`` steps at a time) until ``--steps``, printing
    ``line(done, metrics, img/s)`` after each and checkpointing as
    ``--save-every`` asks. Returns the state."""
    done = t0_done = int(state.step)
    inner = max(1, min(args.inner, args.steps))
    seed = args.seed + 1
    t0 = time.time()
    while done < args.steps:
        state, metrics = run(state, seed, done * args.batch)
        done += inner
        print(line(done, metrics, (done - t0_done) * args.batch / (time.time() - t0)))
        if mgr is not None and mgr.maybe_save(state):
            print(f"checkpointed step {int(state.step)}")
    return state


def _save_final(args, mgr, state, trained_from: int) -> None:
    """Save the state if this run trained it, as the JAX commands do, and
    close the manager."""
    if mgr is None:
        return
    if int(state.step) > trained_from:
        mgr.maybe_save(state, force=True)
        print(f"saved checkpoint at step {int(state.step)} -> {args.ckpt_dir}")
    mgr.close()


def _manager(args):
    """The ``--ckpt-dir`` checkpoint manager, or None."""
    if not args.ckpt_dir:
        return None
    from .train import checkpoint
    return checkpoint.CheckpointManager(args.ckpt_dir, save_every=args.save_every)


def _restore_latest(mgr, state):
    if mgr is not None and mgr.latest_step() is not None:
        state = mgr.restore(state)
        print(f"restored checkpoint at step {int(state.step)}")
    return state


CRANE_PARTS = ("cranebase", "cranecolumn", "craneboom", "cranetelescopic")


def _parts(out) -> str:
    """A crane evaluator's per-part ADD-0.1d, as the JAX commands print it."""
    return " ".join(f"{p.replace('crane', '')}={float(out[f'add_0_1d_{p}']):.2f}"
                    for p in CRANE_PARTS)


def cmd_train_crop(args) -> None:
    """Second-stage (detect-then-crop) keypoint training for one equipment
    class (``train/crop_loop.py``), then its 6DoF on ``--eval-frames``
    fresh frames of another seed, from the label boxes."""
    from .config import Config, PipelineConfig, SceneConfig, TrainConfig
    from .eval import pipeline as eval_pipeline
    from .parallel import pipeline as pipeline_mod
    from .train import crop_loop

    cfg = Config(scene=SceneConfig(n_dumpers=args.n_dumpers),
                 pipeline=PipelineConfig(render_width=args.size, render_height=args.size),
                 train=TrainConfig(batch_size=args.batch, steps=max(args.steps, 1),
                                   loss=args.loss, camera_mix=args.camera_mix))
    pipe = pipeline_mod.Pipeline(cfg, device=args.device)
    model = crop_loop.make_crop_model(args.cls, lite=args.lite, roster=pipe.roster,
                                      output_stride=args.stride, device=args.device,
                                      seed=args.seed)
    mgr = _manager(args)
    state = _restore_latest(mgr, crop_loop.create_crop_train_state(cfg, model))
    trained_from = int(state.step)
    if trained_from < args.steps:
        run = crop_loop.make_scanned_crop_train_fn(
            cfg, model, pipe, max(1, min(args.inner, args.steps)), args.cls, args.crop,
            per_part=args.per_part)
        state = _train_loop(args, state, mgr, run, lambda done, m, rate: (
            f"step {done}: loss={float(m['loss']):.5f} vis={float(m['n_visible']):.0f}/"
            f"{args.batch} ({rate:.1f} img/s avg)"))
    _save_final(args, mgr, state, trained_from)

    model.eval()
    with torch.no_grad():
        batch = pipe.make_generate_fn(ladder=args.eval_ladder, include_heatmaps=False)(
            args.seed + 1000, range(args.eval_frames))
    if args.cls == "crane":
        out = eval_pipeline.evaluate_crop_crane_6dof(
            batch, pipe.roster, pipe.intr, model, args.crop, score_threshold=args.pnp_threshold,
            loss=args.loss, per_part=args.per_part)
        print(f"crane crop-stage 6DoF: ADD mean {float(out['add_mean']):.3f} m, "
              f"ADD-0.1d {float(out['add_0_1d']):.3f} [{_parts(out)}] "
              f"(accepted {int(out['n_accepted'])}/{int(out['n_valid'])}, "
              f"detectable {int(out['n_detectable'])}/{args.eval_frames})")
        errs = " ".join(f"{p.replace('crane', '')}={float(out[f't_err_{p}']):.2f}m/"
                        f"{float(out[f'rot_err_deg_{p}']):.1f}deg" for p in CRANE_PARTS)
        print(f"  per-part err split (t/rot): [{errs}]")
    else:
        out = eval_pipeline.evaluate_crop_6dof(
            batch, pipe.roster, pipe.intr, model, args.cls, args.crop,
            score_threshold=args.pnp_threshold, loss=args.loss)
        print(f"{args.cls} crop-stage 6DoF: ADD mean {float(out['add_mean']):.3f} m, "
              f"ADD-0.1d {float(out['add_0_1d']):.3f} "
              f"(accepted {int(out['n_accepted'])}/{int(out['n_valid'])}, "
              f"detectable {int(out['n_detectable'])}/{args.eval_frames}, "
              f"rmse {float(out['rmse']):.4f})")


def cmd_train_detect(args) -> None:
    """CenterNet detector training (``train/detect_loop.py``) and its P/R
    and mAP on ``--eval-frames`` fresh frames; with ``--crop-ckpt`` and
    ``--crane-crop-ckpt``, the full two-stage path: detector boxes (not
    labels) -> crop nets -> the ground-prior and crane solves -> ADD."""
    from .config import Config, PipelineConfig, SceneConfig, TrainConfig
    from .eval import pipeline as eval_pipeline
    from .ops import detect as detect_ops
    from .parallel import pipeline as pipeline_mod
    from .train import crop_loop, detect_loop
    from .train import loop as train_loop

    cfg = Config(scene=SceneConfig(n_dumpers=args.n_dumpers, n_humans=args.n_humans),
                 pipeline=PipelineConfig(render_width=args.size, render_height=args.size),
                 train=TrainConfig(batch_size=args.batch, steps=max(args.steps, 1),
                                   loss="focal", camera_mix=args.camera_mix))
    pipe = pipeline_mod.Pipeline(cfg, device=args.device)
    model = detect_loop.make_detect_model(lite=args.lite, output_stride=args.det_stride,
                                          device=args.device, seed=args.seed)
    mgr = _manager(args)
    state = _restore_latest(mgr, train_loop.create_train_state(cfg, model))
    done = trained_from = int(state.step)
    if done < args.steps and args.data_dir:
        step_fn = detect_loop.make_data_detect_train_step(cfg, model, pipe.roster)
        state, done = _offline_train(
            args, state, mgr, done, fields=("rgb", "bbox2d", "inst_visible"),
            run_one=lambda st, seed, b: step_fn(st, seed, b["rgb"], b["bbox2d"],
                                                b["inst_visible"]),
            roster=pipe.roster)
    elif done < args.steps:
        # Mixed-geometry stream: every --hifi-mix-th batch renders the baked
        # CAD meshes (image-textured with --image-textures; the proxy
        # batches stay untextured, as in the JAX command).
        hifi_pipe = (pipeline_mod.Pipeline(cfg, device=args.device, hifi_mesh=True,
                                           image_textures=args.image_textures)
                     if args.hifi_mix else None)
        run = detect_loop.make_scanned_detect_train_fn(
            cfg, model, pipe, max(1, min(args.inner, args.steps)), hifi_pipe=hifi_pipe,
            hifi_every=args.hifi_mix)
        state = _train_loop(args, state, mgr, run, lambda done, m, rate: (
            f"step {done}: loss={float(m['loss']):.5f} ({rate:.1f} img/s avg)"))
    _save_final(args, mgr, state, trained_from)

    model.eval()
    eval_pipe = pipe
    if args.hifi_eval:
        # Sim-to-sim transfer: the model trained on the analytic proxies is
        # evaluated on frames rendered from the CAD meshes.
        eval_pipe = pipeline_mod.Pipeline(cfg, device=args.device, hifi_mesh=True,
                                          image_textures=args.image_textures)
        print("eval frames: hifi CAD-mesh renders (proxy-trained models)")
    with torch.no_grad():
        batch = eval_pipe.make_generate_fn(ladder=args.eval_ladder, include_heatmaps=False)(
            args.seed + 1000, range(args.eval_frames))
    det = eval_pipeline.evaluate_detector(batch, pipe.roster, model, analysis=args.det_analysis)
    pr = lambda c: f"{float(det[f'precision_{c}']):.2f}/{float(det[f'recall_{c}']):.2f}"
    per_cls = " ".join(f"{c}={pr(c)}" for c in ("dumper", "crane", "human", "trafficcone"))
    parts = " ".join(f"{c.replace('crane', '')}={pr(c)}" for c in detect_ops.CRANE_PART_CLASSES)
    print(f"detector P/R @IoU0.5: {float(det['precision']):.3f}/"
          f"{float(det['recall']):.3f}  [{per_cls}]")
    print(f"  crane parts P/R: [{parts}]  mAP@0.5 {float(det['map']):.3f}")
    if args.det_analysis:
        for c in detect_ops.DET_CLASSES:
            ms, mc, ml = (float(det[f"miss_{k}_{c}"]) for k in ("score", "cls", "loc"))
            if ms + mc + ml > 1e-6:
                print(f"  miss split {c}: score {ms:.2f} cls {mc:.2f} "
                      f"loc {ml:.2f}  (recall {float(det[f'recall_{c}']):.2f})")

    if args.crop_ckpt:
        crop_model = _restore_model(args.crop_ckpt, cfg, crop_loop.make_crop_model(
            "dumper", roster=pipe.roster, device=args.device))
        out = eval_pipeline.evaluate_crop_6dof(batch, pipe.roster, pipe.intr, crop_model,
                                               "dumper", args.crop, boxes=det["dumper_boxes"])
        print(f"FULL two-stage dumper 6DoF (detector boxes): "
              f"ADD mean {float(out['add_mean']):.3f} m, "
              f"ADD-0.1d {float(out['add_0_1d']):.3f} "
              f"(accepted {int(out['n_accepted'])}/{int(out['n_valid'])})")
        if args.n_dumpers > 1:
            di = detect_ops.DET_CLASSES.index("dumper")
            mout = eval_pipeline.evaluate_crop_6dof_multi(
                batch, pipe.roster, pipe.intr, crop_model, "dumper", args.crop,
                boxes=det["boxes"][:, di], box_scores=det["scores"][:, di])
            print(f"FULL two-stage multi-dumper 6DoF (detector boxes, "
                  f"{args.n_dumpers} instances): "
                  f"ADD mean {float(mout['add_mean']):.3f} m, "
                  f"ADD-0.1d {float(mout['add_0_1d']):.3f} "
                  f"(accepted {int(mout['n_accepted'])}/"
                  f"{int(mout['n_detectable'])} detectable)")

    if args.crane_crop_ckpt:
        crane_crop = args.crane_crop or args.crop
        crane_model = _restore_model(args.crane_crop_ckpt, cfg, crop_loop.make_crop_model(
            "crane", roster=pipe.roster, output_stride=args.crane_stride, device=args.device))
        pb, ps = eval_pipeline.best_part_boxes(det["boxes"], det["scores"])
        cout = eval_pipeline.evaluate_crop_crane_6dof(
            batch, pipe.roster, pipe.intr, crane_model, crane_crop, per_part=True,
            part_boxes=pb, part_scores=ps)
        print(f"FULL two-stage crane 6DoF (detector part boxes): "
              f"ADD mean {float(cout['add_mean']):.3f} m, "
              f"ADD-0.1d {float(cout['add_0_1d']):.3f} [{_parts(cout)}] "
              f"(accepted {int(cout['n_accepted'])}/{int(cout['n_valid'])})")


def make_infer_fn(det_model, crop_model, crop_size: int, intr, roster, max_det: int = 4,
                  crane_model=None, crane_crop: int | None = None, det_threshold: float = 0.3):
    """``infer(rgb, camera_pose7) -> dict``: frames (B, H, W, 3) u8 and their
    camera poses (B, 7) -> every class's decoded boxes (B, C, max_det, 4)
    and scores; each dumper detection slot's crop, DARK keypoints (score >=
    0.15) and ground-prior solve (``dumper_R``, ``_t``, ``_rmse``,
    ``_valid``, (B, max_det, ...)); with ``crane_model``, the best crane part
    boxes, their per-part crops and the FK-constrained joint solve
    (``crane_part_boxes``, ``_scores``, ``crane_R``, ``_t``, ``_rmse``,
    ``_valid``). No label is read."""
    from .core import rotation
    from .eval import pipeline as eval_pipeline
    from .models import pose_net
    from .ops import crop as crop_ops, detect as det_ops, pnp as pnp_ops, preprocess
    from .scene import assets
    from .train import crop_loop

    tpl = assets.all_templates()["dumper"]
    di = det_ops.DET_CLASSES.index("dumper")

    @torch.inference_mode()
    def infer(rgb, camera_pose7):
        dev = rgb.device
        pred = pose_net.forward(det_model, preprocess.normalize(rgb.float() / 255.0))
        boxes, scores = det_ops.decode_detections(
            pred, float(getattr(det_model, "output_stride", 4)), max_det)
        R_wp = rotation.matrix_from_quat_xyzw(camera_pose7[..., 3:])
        cam = camera_pose7[..., :3]
        B, D = boxes.shape[0], max_det
        # Dumper: every detection slot gets its own crop and ground solve.
        roi = crop_ops.square_roi(boxes[:, di])  # (B, D) each
        uv_c, sc = eval_pipeline.crop_keypoints(
            crop_model, eval_pipeline.crop_images(rgb, roi, crop_size), "focal")
        K = uv_c.shape[1]
        uv = crop_ops.crop_to_uv(uv_c.reshape(B, D, K, 2), *(x[..., None] for x in roi),
                                 crop_size)
        sc = sc.reshape(B, D, K)
        x = pnp_ops.normalize_pixels(uv, intr.fx, intr.fy, intr.cx, intr.cy)
        model_pts = torch.as_tensor(tpl.keypoints, dtype=torch.float32, device=dev)
        dres = pnp_ops.solve_ground_pose(model_pts.expand(B, D, K, 3), x,
                                         torch.where(sc >= 0.15, sc, 0.0),
                                         R_wp[:, None].expand(B, D, 3, 3),
                                         cam[:, None].expand(B, D, 3))
        out = {"boxes": boxes, "scores": scores, "dumper_R": dres.R, "dumper_t": dres.t,
               "dumper_rmse": dres.rmse, "dumper_valid": dres.valid}
        if crane_model is not None:
            pb, ps = eval_pipeline.best_part_boxes(boxes, scores)
            cuv, _, cw = eval_pipeline.crane_part_keypoints(
                rgb, pb, ps >= det_threshold, roster, crane_model,
                crop_size=crane_crop or crop_size)
            s0, Kp = crop_loop.crane_channels(roster)
            cres = pnp_ops.solve_crane_pose(
                roster.tensor("inst_kpts", dev)[s0:s0 + 4, :Kp],
                pnp_ops.normalize_pixels(cuv, intr.fx, intr.fy, intr.cx, intr.cy), cw, R_wp,
                cam)
            out.update({"crane_part_boxes": pb, "crane_part_scores": ps, "crane_R": cres.R,
                        "crane_t": cres.t, "crane_rmse": cres.rmse, "crane_valid": cres.valid})
        return out

    return infer


def frame_record(o, i: int, frame_id: int, camera_pose7, det_threshold: float, px2n: float):
    """The JSON record of frame ``i`` of an ``infer`` batch ``o`` (numpy):
    every above-threshold detection of the plain classes, the dumper's with
    its pose (``pose_accepted`` at a reprojection RMSE of at most 8 px), and
    one articulated crane record with its parts when any part is detected."""
    from .ops import detect as det_ops

    dets = []
    for ci, cname in enumerate(det_ops.DET_CLASSES):
        if cname in det_ops.CRANE_PART_CLASSES or cname == "crane":
            continue  # the crane is one articulated record
        for d in range(o["scores"].shape[2]):
            s = float(o["scores"][i, ci, d])
            if s < det_threshold:
                continue
            rec = {"class": cname, "score": s, "bbox2d": o["boxes"][i, ci, d].tolist()}
            if cname == "dumper":
                rec.update({
                    "pose_accepted": (bool(o["dumper_valid"][i, d])
                                      and float(o["dumper_rmse"][i, d]) <= 8.0 * px2n),
                    "R_cam": o["dumper_R"][i, d].tolist(),
                    "t_cam": o["dumper_t"][i, d].tolist(),
                    "reproj_rmse_px": float(o["dumper_rmse"][i, d]) / px2n,
                })
            dets.append(rec)
    if "crane_valid" in o and bool((o["crane_part_scores"][i] >= det_threshold).any()):
        dets.append({
            "class": "crane",
            "pose_accepted": (bool(o["crane_valid"][i])
                              and float(o["crane_rmse"][i]) <= 8.0 * px2n),
            "reproj_rmse_px": float(o["crane_rmse"][i]) / px2n,
            "parts": [{"name": CRANE_PARTS[pi],
                       "score": float(o["crane_part_scores"][i, pi]),
                       "bbox2d": o["crane_part_boxes"][i, pi].tolist(),
                       "R_cam": o["crane_R"][i, pi].tolist(),
                       "t_cam": o["crane_t"][i, pi].tolist()} for pi in range(4)],
        })
    return {"frame_id": int(frame_id), "camera_pose7": [float(v) for v in camera_pose7],
            "detections": dets}


def cmd_infer(args) -> None:
    """The serving path on freshly generated frames: detector -> ROI crops
    -> keypoints -> the ground-prior and crane solves, one JSON record a
    frame to ``--out``. No label is read. The last batch is padded to the
    batch shape; only real frame ids are written. ``--track`` assigns track
    ids and smooths accepted poses (``eval/tracking.py``), starting afresh
    at each clip of ``--sequence-len``; ``--hifi`` renders the frames from
    the CAD meshes."""
    from .config import Config, PipelineConfig
    from .parallel import pipeline as pipeline_mod
    from .train import crop_loop, detect_loop

    cfg = Config(pipeline=PipelineConfig(render_width=args.size, render_height=args.size))
    pipe = pipeline_mod.Pipeline(cfg, device=args.device, hifi_mesh=args.hifi)
    det_model = _restore_model(args.det_ckpt, cfg, detect_loop.make_detect_model(
        output_stride=args.det_stride, device=args.device))
    crop_model = _restore_model(args.crop_ckpt, cfg, crop_loop.make_crop_model(
        "dumper", roster=pipe.roster, device=args.device))
    crane_model = None
    if args.crane_crop_ckpt:
        crane_model = _restore_model(args.crane_crop_ckpt, cfg, crop_loop.make_crop_model(
            "crane", roster=pipe.roster, output_stride=args.crane_stride, device=args.device))
    infer = make_infer_fn(det_model, crop_model, args.crop, pipe.intr, pipe.roster,
                          args.max_det, crane_model, args.crane_crop, args.det_threshold)
    if args.sequence_len:
        gen = pipe.make_sequence_fn(args.sequence_len, include_heatmaps=False)
    else:
        gen = pipe.make_generate_fn(ladder=args.ladder, include_heatmaps=False)
    px2n = 1.0 / float(pipe.intr.fx)
    tracker = None
    if args.track:
        from .eval import tracking
        tracker = tracking.Tracker(smooth=args.smooth)
    n_out = n_det = 0
    with open(args.out, "w") as f:
        for lo in range(0, args.frames, args.batch):
            with torch.no_grad():
                batch = gen(args.seed, range(lo, lo + args.batch))
            o = {k: v.cpu().numpy() for k, v in infer(batch.rgb, batch.camera_pose7).items()}
            cam7 = batch.camera_pose7.cpu().numpy()
            for i in range(min(args.frames - lo, args.batch)):
                rec = frame_record(o, i, lo + i, cam7[i], args.det_threshold, px2n)
                if tracker is not None:
                    if args.sequence_len and (lo + i) % args.sequence_len == 0:
                        tracker.reset()  # clips are independent
                    tracker.update(rec["detections"], rec["camera_pose7"])
                n_det += len(rec["detections"])
                f.write(json.dumps(rec) + "\n")
                n_out += 1
    print(f"wrote {n_out} frame records ({n_det} detections) -> {args.out}")


def cmd_seq_eval(args) -> None:
    """Temporal quality of ``infer --sequence-len N`` records: mean
    inter-frame world-frame pose delta of tracked objects, rotation delta,
    and detection identity stability (``eval/sequence_metrics.py``)."""
    import math

    from .eval import sequence_metrics as seq_metrics

    records = seq_metrics.load_records(args.poses)
    out = seq_metrics.sequence_metrics(records, args.sequence_len, fps=args.fps)
    print(f"sequence eval ({int(out['n_clips'])} clips x "
          f"{args.sequence_len} frames, {int(out['n_frames'])} frames):")
    disp = ("" if math.isnan(out.get("id_stability_std", float("nan")))
            else f" +- {out['id_stability_std']:.3f} across clips "
                 f"(worst clip {out['id_stability_min_clip']:.3f})")
    print(f"  id stability:       {out['id_stability']:.3f}{disp} "
          f"(adjacent-frame detection matches)")
    print(f"  pose track rate:    {out['pose_track_rate']:.3f} "
          f"(accepted poses matched to the next frame)")
    print(f"  mean |dt| world:    {out['mean_t_delta_m']:.3f} m/frame "
          f"(p95 {out['p95_t_delta_m']:.3f})")
    print(f"  mean |dR| world:    {out['mean_r_delta_deg']:.2f} deg/frame")
    if "id_switch_rate" in out:
        print(f"  id switch rate:     {out['id_switch_rate']:.3f} "
              f"(IoU-matched pairs whose --track ids differ)")
    if "mean_speed_mps" in out:
        print(f"  implied speed:      {out['mean_speed_mps']:.2f} m/s @ "
              f"{args.fps} fps")


def cmd_bench(args) -> dict:
    """The headline benchmark; returns ``bench.run``'s result."""
    from . import bench
    return bench.main(device=args.device)


def _train_flags(p, steps: int, batch: int, inner: int) -> None:
    p.add_argument("--steps", type=int, default=steps)
    p.add_argument("--batch", type=int, default=batch)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--backbone", choices=["heatmap", "lite", "hrnet-w48"], default="heatmap",
                   help="the pose backbone: the full-width HeatmapBackbone, its lite variant, "
                        "or HRNet-W48 (BatchNorm: batch statistics in training, running ones "
                        "in evaluation)")
    p.add_argument("--lite", dest="backbone", action="store_const", const="lite",
                   help="the same as --backbone lite")
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
    g.add_argument("--sequence-len", type=int, default=0,
                   help="N>0: temporally coherent N-frame clips (crane and worker "
                        "animation, a camera flight) instead of i.i.d. frames")
    g.add_argument("--hifi", action="store_true",
                   help="render cones, fences, trees and the worker from baked CAD "
                        "triangle meshes (render/meshcast.py) instead of the analytic "
                        "proxies: mesh-faithful silhouettes, slower")
    g.add_argument("--image-textures", action="store_true",
                   help="sample the reference's real texture images (bark, leaf, garment "
                        "fabrics; render/textures.py) on top of the procedural patterns")
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
    tc = sub.add_parser("train-crop", help="two-stage (detect-then-crop) equipment training")
    tc.add_argument("--steps", type=int, default=8000)
    tc.add_argument("--batch", type=int, default=32)
    tc.add_argument("--size", type=int, default=512,
                    help="full-image render size the ROIs are cut from")
    tc.add_argument("--crop", type=int, default=128)
    tc.add_argument("--cls", default="dumper")
    tc.add_argument("--seed", type=int, default=0)
    tc.add_argument("--lite", action="store_true")
    tc.add_argument("--loss", choices=["mse", "focal"], default="focal")
    tc.add_argument("--inner", type=int, default=50, help="train steps between log lines")
    tc.add_argument("--eval-frames", type=int, default=64)
    tc.add_argument("--pnp-threshold", type=float, default=0.15)
    tc.add_argument("--ckpt-dir", default=None)
    tc.add_argument("--eval-ladder", action="store_true")
    tc.add_argument("--camera-mix", type=float, default=0.0,
                    help="P(close-range ladder view) per train frame")
    tc.add_argument("--stride", type=int, default=4, choices=[2, 4],
                    help="crop-net output stride (2 = double heatmap res)")
    tc.add_argument("--per-part", action="store_true",
                    help="crane only: one ROI per part (4 crops/frame) instead of the "
                         "machine union box")
    tc.add_argument("--n-dumpers", type=int, default=1,
                    help="train/eval scenes with N dumpers (multi-instance)")
    tc.add_argument("--save-every", type=int, default=0,
                    help="also checkpoint every N steps mid-run (0 = only at the end)")
    _device_flag(tc)
    tc.set_defaults(fn=cmd_train_crop)
    td = sub.add_parser("train-detect", help="CenterNet detector training + two-stage eval")
    td.add_argument("--steps", type=int, default=8000)
    td.add_argument("--batch", type=int, default=32)
    td.add_argument("--size", type=int, default=512)
    td.add_argument("--crop", type=int, default=128)
    td.add_argument("--seed", type=int, default=0)
    td.add_argument("--lite", action="store_true")
    td.add_argument("--inner", type=int, default=50, help="train steps between log lines")
    td.add_argument("--eval-frames", type=int, default=64)
    td.add_argument("--ckpt-dir", default=None)
    td.add_argument("--save-every", type=int, default=0,
                    help="also checkpoint every N steps mid-run (0 = only at the end)")
    td.add_argument("--crop-ckpt", default=None,
                    help="crop-stage checkpoint: run the full detector->crop->PnP path")
    td.add_argument("--crane-crop-ckpt", default=None,
                    help="per-part crane crop checkpoint: report the full "
                         "detector-part-boxes -> FK-solve crane path")
    td.add_argument("--det-stride", type=int, default=4, choices=[2, 4],
                    help="detector output stride: 2 doubles map resolution")
    td.add_argument("--crane-stride", type=int, default=4, choices=[2, 4],
                    help="output stride the crane crop ckpt was trained at")
    td.add_argument("--crane-crop", type=int, default=None,
                    help="crop size the crane crop ckpt was trained at (default: --crop)")
    td.add_argument("--n-humans", type=int, default=1,
                    help="workers per training/eval scene")
    td.add_argument("--n-dumpers", type=int, default=1,
                    help="train/eval scenes with N dumpers; with --crop-ckpt also reports "
                         "the multi-instance two-stage path")
    td.add_argument("--data-dir", default=None,
                    help="train from packed npz shards (io/reader) instead of the generator")
    td.add_argument("--eval-ladder", action="store_true")
    td.add_argument("--camera-mix", type=float, default=0.0)
    td.add_argument("--hifi-mix", type=int, default=0,
                    help="render every k-th training batch with the hifi CAD-mesh sweep "
                         "(0 = proxies only): mixed-geometry training for sim-to-sim "
                         "transfer")
    td.add_argument("--image-textures", action="store_true",
                    help="with --hifi-mix/--hifi-eval: texture those hifi frames with the "
                         "reference's real texture images (render/textures.py)")
    td.add_argument("--hifi-eval", action="store_true",
                    help="evaluate on hifi CAD-mesh renders (the sim-to-sim transfer gap of "
                         "proxy-trained models)")
    td.add_argument("--det-analysis", action="store_true",
                    help="oracle-IoU miss diagnosis per class: split missed GTs into "
                         "score / classification / localization misses")
    _device_flag(td)
    td.set_defaults(fn=cmd_train_detect)
    inf = sub.add_parser("infer", help="deployment inference: detector -> crop -> 6DoF pose "
                                       "JSON lines")
    inf.add_argument("--det-ckpt", required=True)
    inf.add_argument("--det-stride", type=int, default=4, choices=[2, 4],
                     help="must match the det-ckpt's training stride")
    inf.add_argument("--crop-ckpt", required=True)
    inf.add_argument("--crane-crop-ckpt", default=None,
                     help="per-part crane crop checkpoint: adds articulated crane records "
                          "(FK joint solve) to the output")
    inf.add_argument("--out", default="poses.jsonl")
    inf.add_argument("--frames", type=int, default=32)
    inf.add_argument("--batch", type=int, default=16)
    inf.add_argument("--size", type=int, default=512)
    inf.add_argument("--crop", type=int, default=128)
    inf.add_argument("--seed", type=int, default=0)
    inf.add_argument("--ladder", action="store_true")
    inf.add_argument("--det-threshold", type=float, default=0.3)
    inf.add_argument("--max-det", type=int, default=4,
                     help="detection slots per class (each dumper slot pays a crop+solve)")
    inf.add_argument("--sequence-len", type=int, default=0,
                     help="run on temporally coherent clips of this length (pairs with "
                          "seq-eval)")
    inf.add_argument("--crane-stride", type=int, default=4, choices=[2, 4],
                     help="output stride the crane crop ckpt was trained at")
    inf.add_argument("--crane-crop", type=int, default=None,
                     help="crop size the crane crop ckpt was trained at (default: --crop)")
    inf.add_argument("--track", action="store_true",
                     help="assign track_ids across frames (greedy same-class IoU) and "
                          "EMA-smooth accepted poses in the world frame (eval/tracking.py); "
                          "tracks reset per clip")
    inf.add_argument("--smooth", type=float, default=0.5,
                     help="EMA keep-fraction for --track pose smoothing (0 = ids only)")
    inf.add_argument("--hifi", action="store_true",
                     help="run the detector on hifi CAD-mesh renders (sim-to-sim transfer: "
                          "the models are trained on proxies)")
    _device_flag(inf)
    inf.set_defaults(fn=cmd_infer)
    se = sub.add_parser("seq-eval", help="temporal metrics over infer JSONL from "
                                         "sequence-mode clips")
    se.add_argument("--poses", required=True, help="infer --out JSONL path")
    se.add_argument("--sequence-len", type=int, default=30)
    se.add_argument("--fps", type=float, default=None,
                    help="clip frame rate for implied-speed reporting")
    se.set_defaults(fn=cmd_seq_eval)
    b = sub.add_parser("bench", help="headline benchmark: annotated 512x512 datagen frames/s")
    _device_flag(b)
    b.set_defaults(fn=cmd_bench)
    return ap


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
