#!/usr/bin/env python3
"""The readings that a cell's limits are set from, in one process: the
program against the plain reference on each of ``--seeds`` (the lower
reading of every compared number is their largest), and the control
against the reference on each of ``--control-seeds`` (its smallest is the
upper reading). A generate cell's control is the reference with its
matrix products in TF32 and its RGB pass in bfloat16
(``reference/precision.py``); a training cell's the reference with its
body in fp8, and, beside it, the faults a training step can have, planted
in the reference put in the program's place, and on several cards in the
program on every rank (``--faults``). A cell of several cards runs one rank
a card, this process rank 0.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,... \\
        --control-seeds 7,8,9 [--faults] [--out FILE]

Each generate seed runs as many batches of the cell's own size as a run
keeps frames, one frame drawn from each; each training seed its first steps.
Prints one JSON object, and writes it to ``--out`` where given.
"""

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

from harness import manifest, session  # noqa: E402

LIMIT_S = 3000.0  # the life of a calibration's ranks on several cards


def generate_readings(cell, seeds, control_seeds, device):
    import torch

    from harness import compare, generate

    stream = generate.Stream(cell, device)
    out = {"program": {}, "control": {}, "labels": {}}
    for seed in seeds + [s for s in control_seeds if s not in seeds]:
        sample = generate.Sample(seed, cell.mix["check_frames"], stream.B)
        for _ in range(cell.mix["check_frames"]):
            stream.batch(seed, sample.offer)
        prog = sample.batch_of()
        ids = prog.frame_id.tolist()
        ref, lo, hi = generate.reference_frames(cell, seed, ids, device, noise_ends=True)
        if seed in seeds:
            out["program"][seed] = compare.frame_numbers(prog, ref, (lo, hi))
            out["labels"][f"program {seed}"] = compare.label_terms(prog, ref)
        if seed in control_seeds:
            ctl = generate.reference_frames(cell, seed, ids, device, control=True)
            out["control"][seed] = compare.frame_numbers(ctl, ref, (lo, hi))
            out["labels"][f"control {seed}"] = compare.label_terms(ctl, ref)
        print(f"[calibrate] seed {seed}: {out['program'].get(seed)} control "
              f"{out['control'].get(seed)}", file=sys.stderr, flush=True)
        del prog, ref
        torch.cuda.empty_cache()
    return out


def worst_leaves(prog, ref, n=4):
    """The leaves of the largest gaps of the first gradient and of the
    change, with the reference's norm of each, for the look at a reading."""
    import torch

    from harness import compare

    out = {}
    for key, keep, fn in (("grads", None, compare.leaf_gaps),
                          ("grads_diff", None, lambda p, r, _: compare.leaf_diffs(p, r)),
                          ("change", ref["moved"], compare.leaf_gaps)):
        field = key.split("_")[0]
        gaps = fn(prog[field], ref[field], keep)
        top = sorted(gaps, key=lambda k: -gaps[k])[:n]
        out[key] = [[k, gaps[k], float(torch.linalg.vector_norm(ref[field][k]))] for k in top]
    return out


def training_readings(group, cell, seeds, control_seeds, faults, device):
    """Every rank runs the program's first steps on each seed (a cell of
    several cards on each of its ranks, ``group``); rank 0 runs the
    reference and returns the readings, the other ranks None. With
    ``faults``, each control seed also reads the faults planted in the
    reference (half the batch, one frame altered) and, on several cards,
    those planted in the program (``harness/faults``: the gradients not
    averaged over the ranks, every rank training rank 0's rows)."""
    import torch

    from harness import faults as program_faults, ranks, training
    from reference import training as ref_training

    planted = ("no_sync", "one_shard") if faults and group.world > 1 else ()
    out = {"program": {}, "control": {}, "half": {}, "altered": {}, "leaves": {},
           **{k: {} for k in planted}}
    pipe = None
    for seed in seeds + [s for s in control_seeds if s not in seeds]:
        ref = None
        runs = [("program", None)] + [(k, program_faults.FAULTS[k]) for k in planted
                                      if seed in control_seeds]
        for kind, plant in runs:
            group.barrier()
            with ranks.planted(plant):
                t = training.Trainer(cell, seed, device, pipe, sharded=group.world > 1)
                pipe = t.pipe
                kept = t.check_steps(cell.mix["check_steps"], group)
            del t
            if group.rank:
                continue
            if ref is None:
                ref = ref_training.steps(cell, seed, kept["ids"], device)
            out[kind][seed] = training.train_numbers(kept, ref)
            out["leaves"][f"{kind} {seed}"] = worst_leaves(kept, ref)
            if kind == "program" and seed in control_seeds:
                kinds = {"control": {"control": True}}
                if faults:
                    kinds.update(half={"fault": "half"}, altered={"fault": "altered"})
                for k, kw in kinds.items():
                    other = ref_training.steps(cell, seed, kept["ids"], device, **kw)
                    out[k][seed] = training.train_numbers(other, ref)
                    out["leaves"][f"{k} {seed}"] = worst_leaves(other, ref)
                    del other
            del kept
            torch.cuda.empty_cache()
        if group.rank == 0:
            print(f"[calibrate] seed {seed}: " + json.dumps(
                {k: v.get(seed) for k, v in out.items() if k != "leaves"}),
                file=sys.stderr, flush=True)
        del ref
    return out if group.rank == 0 else None


def _follow_readings(group, cell, seeds, control_seeds, faults):
    """Ranks 1 to n-1 of a calibration on several cards."""
    training_readings(group, cell, seeds, control_seeds, faults, group.device)


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    session.set_environment()
    import torch

    from harness import ranks

    cell = manifest.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"calibrate: needs {cell.chips} CUDA card(s)", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = [int(s) for s in args.control_seeds.split(",") if s]
    t0 = time.time()
    if cell.mix["kind"] == "train" and cell.chips > 1:
        with ranks.Ranks(cell.chips, "cuda", _follow_readings,
                         (cell, seeds, control, args.faults), LIMIT_S) as held:
            group = held.group()
            res = training_readings(group, cell, seeds, control, args.faults, device)
            group.close()
            held.join(120.0)
    elif cell.mix["kind"] == "train":
        res = training_readings(ranks.Solo(), cell, seeds, control, args.faults, device)
    else:
        res = generate_readings(cell, seeds, control, device)
    res = {"workload": args.workload, "seconds": time.time() - t0,
           "device": session.device_info(torch, device), **res}
    for kind in [k for k in res if isinstance(res[k], dict)
                 and k not in ("device", "leaves", "labels")]:
        vals = list(res[kind].values())
        if vals:
            res[f"{kind}_max"] = {k: max(v[k] for v in vals) for k in vals[0]}
            res[f"{kind}_min"] = {k: min(v[k] for v in vals) for k in vals[0]}
    text = json.dumps(res, indent=1)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
