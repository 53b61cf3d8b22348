#!/usr/bin/env python3
"""Drive the PyTorch port's paths once on one NVIDIA GPU: datagen, evaluation,
training (``train-eval``), dataset writing (``generate``, ``train-eval
--data-dir``), the two-stage deployment path (``train-crop``,
``train-detect``, ``infer``), clips (``--sequence-len``, ``seq-eval``), the
hifi CAD-mesh tier (``--hifi``, ``--hifi-mix``, ``--hifi-eval``), the
image-texture tier (``--image-textures``, the RGB kernel's textured
variant), ``render_frame``'s analytic-normal, sun-shadow and flat-albedo
tiers (the RGB kernel's tier variants), the analytic caster's kernel
(``csrc/raycast.cu``: the keypoint segments of every render, the exact
caster and the shadow sweep), multi-GPU data parallelism (sharded generate
and the DDP and FSDP training steps, on this one card) and the headline
benchmark (``cli bench``).

    python3 chip_smoke.py

Run from the root of a checkout. Phases, each reported on its own line:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. build the CUDA kernels of ``constructionsceneposeestimation_tpu_torch/csrc``;
   ``[draws]``: the replay kernel (``csrc/draws.cu``) bit-equal to the host
   loop it replays (``sample/replay.host_draws``) at 512 frames and at the
   training step's 32 frames with coins, once a ``sample_inputs``, its
   time beside that loop's and its bounds (bytes, the seeding chain);
3. each datagen kernel against its plain PyTorch version on the card, at
   the main path's shapes (512^2, batches of 64 frames), with the stated
   tolerances; the tile-culled sweep must also be bit-equal to the same
   kernel with every row kept (radii of 1e15); a ``[sweep]`` line gives
   the rows kept per 32 x 8 tile (the
   plain mirror of the kernel's cull) and the sweep's two bounds: the
   (ray, row) pairs these inputs need (rays that meet a row's bounding
   sphere, the plane always) and the brute-force walk of every row; the
   RGB kernel, with the noise off, must also keep |d| <= 1 u8 on all but
   1e-3 of the ground pixels within an AO row's reach, where a row its
   cull wrongly dropped would show; an
   ``[rgb]`` line the ground-pixel share, the contact-AO rows kept per
   32 x 1 cull cell (the plain mirror of the kernel's cull), the rows within
   reach per ground pixel and the RGB kernel's two bounds (one ray a pixel
   and the rows within reach, or three rays and every row); a
   ``[heatmap]`` line the visible keypoints per frame and the share of
   maps that hold one;
4. the datagen path: ``Pipeline(...).make_generate_fn()`` for 3 batches of
   64 contiguous frames; every kernel's launch count must rise in every
   batch; fields, labels and ``quality_stats`` are checked, a repeat with
   the same seed must be bit-equal, and a small batch must agree with the
   plain (CPU) path;
5. the peak kernel against its plain version at (64, 71, 128, 128), K = 8,
   on the GT heatmaps, the full-width network's heatmaps, a noisy map
   with negative values, constant, plateau (flat-topped), all-negative and
   all-zero maps, and at (3, 5, 37, 61), (2, 71, 192, 192) and
   (1, 3, 300, 517): scores bit-equal, uv within 1e-3 heatmap px; a
   ``[peaks]`` line gives the NMS survivors per map of the GT and model
   maps;
6. the evaluation path (``eval/pipeline.evaluate_model``: preprocess, the
   full-width ``HeatmapBackbone`` under bf16 autocast, focal heatmaps, every
   evaluator on the GT and the model heatmaps) on 2 fresh batches of 64
   frames at 512^2; the peak kernel must launch at least twice per batch;
   shapes, finiteness, the decode floor (PCK > 0.5), the dumper's ADD and
   the crane's (ADD-0.1d >= 0.95, median per-frame ADD < 0.1 m) with GT
   keypoints are checked, and the dumper through RANSAC on the model heatmaps runs; then
   the card against the plain CPU path on 4 frames at 128^2 with an f32
   forward (the model heatmaps to 1e-3; the evaluators' counts equal on
   the same heatmaps, with GT + 0.1 x the network's as the model's; a crane
   frame that differs is printed with both RMSEs beside the gate);
7. the training path: ``cli.main(["train-eval", ...])`` in-process, 20
   steps of 32 x 512^2 on the full-width backbone, focal, camera-mix 0.3,
   then its evaluation of 32 fresh frames; every step's loss must be
   finite, the three datagen kernels must launch once a step and once for
   the evaluation batch, the peak kernel at least twice, and every line
   of the JAX command must be printed; a fixed batch trained 30 steps with
   warmup 5 must end below half its first loss; a checkpoint round trip
   must restore the parameters, the AdamW state and the schedule bit for
   bit; one step on the card against the plain CPU path (4 x 128^2, f32
   body, the same batch and augment draws): loss to 1e-3 relative, each
   gradient to 1e-2 of its norm;
8. ``[generate]``, in a temporary directory removed at the end: the fastio
   route and the output's filesystem; ``cli.main(["generate", ...,
   "--format", "packed", "--heatmaps"])`` for 160 frames of 512^2 in
   batches of 64 (3 shards, the last padded from 32 to 64): the three
   datagen kernels must launch 3 times, every shard array must be
   bit-equal to ``make_generate_fn`` on the same padded ids and the
   manifest must list frames 0-159; a second run must find nothing
   pending and launch nothing; with frames 64-127 dropped from the
   manifest a third run must regenerate that chunk only, bit-equal; the
   reference tree of 16 frames in batches of 8 must be complete (label
   keys in the reference order, ``pointcloud_count`` rows plus a header,
   (512, 512) int32 masks, the summary's count); ``train-eval --data-dir``
   on the shards, 20 steps of 32 x 512^2, full width, focal, then 32
   evaluation frames: every loss finite, the datagen kernels launched
   exactly once (the evaluation batch), the peak kernel at least twice,
   every line of the JAX command printed; one data step on the card
   against the plain CPU path (4 shard rows of 128^2, f32 body, the same
   augment draws): loss to 1e-3 relative, gradients to 1e-2 of their
   norm; frames/s incl. writes of both formats and the data step's img/s
   with its share waiting on the reader;
9. ``[two-stage]``, in a temporary directory removed at the end: the port's
   ``train-crop`` in-process at the runs of record's widths (the dumper:
   32 x 512^2 frames a step, crop 128, stride 4, focal; the crane:
   ``--per-part --stride 2 --crop 192``, 4 crops a frame), 20 steps each
   with a checkpoint, then ``train-detect --det-stride 2 --n-dumpers 2
   --n-humans 3 --det-analysis`` with both crop checkpoints (20 steps of
   32 x 512^2, 64 evaluation frames), then ``infer --det-stride 2
   --crane-stride 2 --crane-crop 192 --track`` on 32 frames in batches of
   16; every loss finite, the sweep and RGB kernels launched once a step
   (or infer batch) and once for each evaluation batch, the heatmap kernel
   once a crop step (the crop targets), every line of the JAX commands
   printed, 32 records in the JAX key order; the heatmap kernel against
   its plain version on the crop targets the two crop steps give it,
   (32, 10, 32, 32) at stride 4 and (128, 28, 96, 96) at stride 2, within
   2e-4; the card against the plain CPU path on 4 frames of 128^2 with an
   f32 body: one crop step and one detector step (loss to 1e-3 relative,
   each gradient to 1e-2 of its norm) and the infer function (boxes and
   scores to 1e-3, the same detections kept); timing by CUDA events: the
   dumper, crane and detector steps (ms, img/s), infer frames/s, the
   heatmap kernel at the crop shapes beside its bound;
10. ``[sequence]``, in the same directory: ``generate --sequence-len 30
   --format packed --heatmaps`` of 60 frames (2 clips) in batches of 32
   (sweep, RGB and heatmaps once a batch; every shard bit-equal to
   ``make_sequence_fn`` on the same padded ids and to a repeat), within each
   clip the static poses and the light bit-equal frame to frame and the
   camera and crane joints moving a frame at most 1.5 / 29 of their move
   over the clip (at most 30 deg of orbit, 4 m, 1 m); ``infer
   --sequence-len 30 --track`` on the two-stage checkpoints (60 frames),
   then ``seq-eval --sequence-len 30 --fps 30`` on its records: every line
   of the JAX command, finite where the metric is defined; sequence
   generate beside i.i.d. generate (CUDA events, in turns); ``[hifi]``: the
   sweep kernel on the masked schedule against its plain version (the
   ``[sweep]`` thresholds, tile cull bit-equal), 4 x 128^2 hifi frames card
   against CPU (depth and instance) with center, size and euler bit-equal
   to the proxy render, ``generate --hifi`` of 32 frames (bit-equal to
   direct hifi generate), ``train-detect`` with the two-stage detector's
   arguments plus ``--hifi-mix 4 --hifi-eval`` (20 steps; hifi batches at
   steps 0, 4, 8, 12, 16 and for the evaluation), ``infer --hifi`` of 32
   frames, the mesh sweep kernel (``csrc/meshsweep.cu``) launched twice a
   hifi batch on each; ``[mesh-terms]`` lines for the mesh terms kernel
   (``csrc/meshterms.cu``) on the ``[mesh]`` frames: its registers and
   spills (none), its terms, boxes and spheres against
   ``plain_mesh_terms`` on the same world and origin (each part within
   ``MESH_TERMS_UNITS`` units of ``meshcast.terms_gap``; cr = 0 and radius
   -1 on the same slots bit for bit; two calls bit-equal), the mesh sweep
   kernel over its terms against the same kernel over the plain terms
   (pixels: the ``[sweep]`` bars; segments: the same without the edge
   test), its device time by the profiler and by CUDA events beside its
   bound (the stores), its wrapper's call, the plain version's time and
   launches a call, ``HifiCaster.frame_world``'s host issue and
   CUDA-event times and ``MeshCaster.packed`` with its terms built in the
   call, with the kernel's terms and with the plain ones in turns; every
   ``[mesh]`` check below runs on the kernel's terms; ``[mesh]`` lines for
   the triangle sweep on 32 x
   512^2, pixels and segments: the kernel's registers (at most 80) and
   spills (none), the kernel against ``plain_mesh_sweep`` on the same
   terms and rays (pixels: the ``[sweep]`` bars; segments: the same
   without the edge test), its visit counts equal to ``visited()``, two
   calls and every walk bit-equal; the boxes the tile cone keeps (all the
   visited among them); the patch walk's triangles kept a pixel ray and
   the segment walk's a segment beside those visited and needed, no pair
   that passes the widened test lost, kept sets equal to
   ``patch_cull_plain``'s and ``segment_cull_plain``'s on > 0.99; the
   default walk's device time beside the split walk's in one window; its
   device time,
   its wrapper's call and ``MeshCaster.packed`` beside the plain version's
   time and launches, the bound (each needed pair's 22 operations of the
   kernel's division-free test, 4 more on each pair that passes it; the
   visited pairs' and the plain test's 30 a pair beside) and the brute
   force; the hifi frames' ``kpt_visible`` with the kernel
   against the plain sweep (>= 0.99); the mesh sweep's share of a hifi
   batch, and the detector step with hifi batches beside the proxy step;
   after ``[bench]``, the kernel's launches on every hifi path (> 0, the
   ``--hifi-eval`` evaluation and the textured hifi paths included) and on
   no other, the terms kernel's half of them on every path (once a hifi
   render) and ``plain_mesh_terms`` never on the card;
11. ``[textures]``, in the same directory: the RGB kernel's textured
   variant against its plain version on 64 x 512² frames, proxy and hifi,
   hash noise off and on (noise off: mean |d| < 0.5 u8, |d| > 1 on < 2% of
   the values, sky exact, |d| > 1 on <= 1e-3 of the ground pixels within
   an AO row's reach, |d| > 2 on at most 1e-3 more of the values than the
   untextured kernel against its plain version on the same inputs: texel
   bin flips; noise on: the [rgb] statistics); its time beside the
   untextured kernel's, its bound on the pixels that the kernel's plan
   (``rgb_kernel.texture_plan_plain``) sends through the texture stage, its
   registers and spill stores (ptxas); textured generate's fields
   bit-equal to untextured generate's but the RGB; a procedural | textured
   PNG through ``utils/viz.save_png``; textured and untextured generate in
   turns; ``generate --image-textures --format packed --heatmaps`` (64
   frames), ``--hifi`` (32) and ``--sequence-len 30`` (60), every shard
   bit-equal to direct textured generate; ``train-detect`` with the
   [hifi] arguments and ``--image-textures`` (hifi batches and the
   evaluation textured, the proxy batches not); the textured variant
   launched once a textured batch and on no untextured path;
12. ``[analytic]``: the exact caster (``Raycaster.cast``) on 64 x 512^2
   pixel rays and the shadow sweep (``fast_multi_origin``) from its hit
   points (ms a batch, peak memory, the lit share of the hit pixels); each
   tier variant of the RGB kernel (normal, shadow, flat, their
   combinations, textured where not flat) against its plain version on
   those inputs, noise off (the [textures] bars against the default
   kernel's |d| > 2 share; a shadow variant changes only pixels both
   versions see shadowed) and on; a flat variant given the texel table
   equals it without; ``render_frame`` in each of the ten tier
   combinations at 64 x 512^2 (one launch of its variant, no pixel sweep
   under analytic normals; labels
   bit-equal to the default render where the tier is RGB-only, instance
   on >= 0.9995 of the pixels and depth to the sweep's tolerances under
   analytic normals), each combination card against CPU at 4 x 128^2,
   ``Pipeline(procedural_textures=False)``'s generate (sweep, flat variant
   and heatmaps once; labels bit-equal to the default), the hifi caster
   equal to the proxy caster under analytic normals and shadows; each
   variant's device time beside the default kernel's in one window, plain
   time, bound and registers; the default instantiation at 32 registers
   and no spills; no tier variant launched on an earlier path;
12b. ``[raycast]``: ``csrc/raycast.cu``'s registers and spills; its three
   modes against the plain walks (``render/raycast.packed_sweep``,
   ``exact_sweep`` with ``plain_cast``'s normal, ``multi_sweep``) on the
   card on the same inputs: the exact cast of 64 x 512^2 pixel rays (t,
   prim and inst bit-equal, normals within 1e-6, their bit-equal share
   printed), the shadow rays from its hits (every packed value
   bit-equal), the packed sweep of those pixel rays, of the keypoint
   segments of a 512-frame ``bench`` batch (and their exact cast) and of
   both on the hifi tier's masked ``base`` roster (bit-equal); the
   exclusion of ``occlusion_ts`` (pixel rays past their first instance,
   segments past their own, the masked roster's: t bit-equal); each
   mode's bundle cull (no needed (ray, row) pair dropped, its kept sets
   against ``raycast.bundle_cull_plain``'s, rows kept a ray beside those
   needed, the warps keeping every row, the shadow warps mixing sky and
   surface origins); a duplicated primitive resolving to the first index in the kernel and
   the plain version, and ``torch.min``'s tie rule on the card; the card
   against the CPU at 4 x 128^2 (the CPU tests' tolerances); each mode's
   device time, its wrapper's call and the plain version beside its bound
   (the (ray, row) pairs the rays need, each its row's
   ``RAYCAST_ROW_OPS``) and the brute-force bound of every pair; the launches of one segment sweep, kernel and
   plain, and of a 64-frame generate batch; after ``[bench]``, the packed
   mode launched once a render on every path (as the pixel sweep, or the
   exact mode under analytic normals), the exact and per-origin modes on
   the analytic paths only, no plain walk on the card;
13. ``[distributed]``: ``tools/check_sharded_step.py --dryrun`` under
   ``torch.distributed.run``, 2 ranks on cuda:0 over gloo, then 1 rank over
   NCCL: the dry run's FSDP step and its sharded generate at 256² bit-equal
   to the per-chunk single-device rows, and the DDP and FSDP steps (focal)
   against the single-process step on the same global batch (each loss to
   1e-5 relative, the parameters after 2 steps to 1e-5 on 99% of the weights
   and all within 2 lr); a failing rank fails the phase;
14. ``[bench]``: the port's ``bench`` command in-process at the JAX
   benchmark's shape (a warm-up chain of 4 steps, then 4 timed steps of
   512 x 512^2): one JSON line with the JAX keys, a finite positive value
   and ``vs_baseline`` = round(value / 0.15, 1); the sweep, RGB and
   heatmap kernels and the replay kernel launched 8 times (once a generate
   call), the peak kernel and every variant never; frames/s by CUDA events and by the host
   clock, ms a step, peak memory; the three kernels on one batch of 512 x
   512^2 against their plain versions run in chunks of 64 (the bars of
   [sweep], [rgb] with noise off and [heatmap]); at the same shape the
   host ms of sampling a batch and of issuing a step, one step under
   ``torch.profiler`` (device time, launches, busy share) and one under
   ``set_sync_debug_mode("warn")``; a ``Stopwatch`` report of a 64-frame
   generate chained on the card;
15. timing: generate frames/s, the forward and the evaluation step with
   CUDA events; the training step's ms and img/s, its split between
   datagen, forward+backward and the optimizer, its device-busy share and
   launches (torch.profiler) and its peak memory; each kernel's device time
   from torch.profiler (beside its wrapper's call time by CUDA events)
   against its plain version and its bound (the peak kernel on the GT and
   on the model heatmaps), and the heatmap kernel's write rate.

Prints the kernels' JSON line (the RGB row with its textured variant's
``textured_*`` numbers and launches; ``ms`` the device time, ``call_ms`` the
wrapper's call by CUDA events, ``launches`` those of the two-stage,
sequence and hifi paths, ``train_crop`` (both crop runs), ``train_detect``,
``infer``, ``generate_sequence``, ``infer_sequence``, ``generate_hifi``,
``train_detect_hifi``, ``infer_hifi``, the textured and the analytic paths and
``bench``, and
``launches_by_path`` each path's; the heatmap kernel's entry also holds its
times at the crop shapes; one entry for each RGB tier variant, named
``rgb_epilogue/<variant>``, with its launches on the [analytic] paths; the
``mesh_sweep`` entry for a hifi batch's pixel and segment calls, with its
launches by path; the ``mesh_terms`` entry for a hifi render's terms, its
``ms`` by the profiler and ``ms_by`` the profiler and CUDA events, with
its launches by path and ``frame_world``'s and ``packed``'s times with
the kernel's and the plain terms; the ``raycast_packed``, ``raycast_exact`` and
``raycast_multi`` entries, each with its ``jnp_loop`` and launches by
path), then the card line, then as the
last line ``{"ok": true, "device": {...}}``. Exits non-zero, with no result
line, on any failure or when no GPU is present. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
B = 64
RES = 512
SEED = 0
K_PEAKS = 8
# The training slice: the stage-1 run of record (RESULTS_MANIFEST.md:31) at
# 32 frames of 512^2 a step, cut to 20 steps.
TRAIN_B = 32
TRAIN_STEPS = 20
# The generate slice: the command's defaults (JAX cli.py:832-864) at the
# datagen batch, 160 frames = 3 chunks, the last padded from 32 to 64; the
# reference tree at 16 frames in batches of 8.
GEN_FRAMES = 160
REF_FRAMES, REF_B = 16, 8
# The two-stage slice: the runs of record (RESULTS_MANIFEST.md:34-40) at 32
# frames of 512^2 a step, cut to 20 steps; infer on 32 frames in batches of
# 16 (the command's defaults).
CROP_ARGS = ("--crop", "128")
CRANE_ARGS = ("--cls", "crane", "--per-part", "--stride", "2", "--crop", "192")
DETECT_ARGS = ("--det-stride", "2", "--n-dumpers", "2", "--n-humans", "3", "--det-analysis",
               "--crane-stride", "2", "--crane-crop", "192")
INFER_FRAMES, INFER_B = 32, 16
INFER_ARGS = ("--det-stride", "2", "--crane-stride", "2", "--crane-crop", "192")
# The clips slice: the run of record's clips of 30 (RESULTS_MANIFEST.md:40,
# `infer --sequence-len 30 --frames 600`), cut to 2 clips: generate in
# batches of 32 (the first straddles the clips), infer in the command's 16.
SEQ_LEN, SEQ_FRAMES, SEQ_B = 30, 60, 32
# The hifi slice: `generate --hifi` and `infer --hifi` on 32 frames, and the
# detector's run of record (`train-detect ... --hifi-mix 4 --hifi-eval`).
HIFI_FRAMES, HIFI_MIX = 32, 4
# The image-texture slice: `generate --image-textures` of 64 frames (one
# batch), `--hifi --image-textures` of 32 and `--sequence-len 30
# --image-textures` of 60 (the [hifi] and [sequence] slices' sizes), and
# train-detect with the [hifi] slice's arguments plus --image-textures.
TEX_FRAMES = 64
TEXTURED = "rgb_textured"
# csrc/rgb.cu's textured variant, operations beyond the untextured pixel's:
# on every hit pixel the ground's u and v 3, the class compares 6 and the
# renormalize 12; r_xy 3 on a tree pixel and theta 3 on a trunk or garment
# pixel, the rungs that read them (rgb_kernel.texture_plan_plain); on a
# pixel that samples (mix weight > 0, or the vest) the (u, v) select 3,
# the bins and the texel's address 11, tint and clamp 6, the mix 12; on a
# pixel with a normal map the second address 11, du and dv 6, the tangent
# frame 12 and perturbation 12, the specular 25 and its add 3.
RGB_TEX_HIT_OPS = 21
RGB_TEX_R_XY_OPS = 3
RGB_TEX_THETA_OPS = 3
RGB_TEX_SAMPLE_OPS = 32
RGB_TEX_MAP_OPS = 69
# [distributed]: tools/check_sharded_step.py under torch.distributed.run,
# on this one card.
DIST_TIMEOUT = 300
DIST_CASES = {"gloo": "ddp-focal,fsdp-focal", "nccl": "ddp-focal,fsdp-focal"}
# Operations the mesh sweep needs on one (ray, triangle) pair of a visited
# block, by the division-free test of csrc/meshsweep.cu: three 3-term dots
# (det, u_num, v_num) 15, u_num + v_num 1, the sign test (u_num's and
# v_num's sign against det's: one three-input logic op and its compare) 2,
# |u_num + v_num| <= |det| and |det| >= EPS 2, and the two ands that join
# the three tests 2. A pair that passes (mesh_pair_passes counts them) also
# needs the reciprocal, t, t > EPS and the min: 4. The bound leaves out the
# slab tests of the cull and the pack of each block's min, so it stays a
# least time. The plain version's test (render/meshcast.plain_mesh_sweep:
# the reciprocal and its guard 3, t, u and v 3, four compares and two ands
# 6, the select and the min 2 on every pair) is 30 a pair; its bound is
# printed beside, labelled.
MESH_PAIR_OPS = 22
MESH_PASS_OPS = 4
MESH_PLAIN_PAIR_OPS = 30
# csrc/meshsweep.cu's instantiations, by walk (render/meshcast.WALKS), as
# kernels.ptxas_report names them.
MESH_INSTANTIATIONS = {"split": "mesh_sweep_kernel<64, 1, 4>",
                       "4x8": "mesh_sweep_patch_kernel",
                       "segments": "mesh_sweep_segment_kernel"}
# Registers a thread each instantiation may take: three blocks of 256
# threads an SM.
MESH_MAX_REGISTERS = 80
# The mesh sweep's cull check: every pair that passes the division-free
# test widened by MESH_WIDEN_ULPS ulps of its dots' terms (which the
# kernel's own rounding may pass) must be kept; the kept sets are held
# against the mirror's on the first MESH_MIRROR_FRAMES frames, and the
# kernel writes them MESH_KEPT_FRAMES frames a call.
MESH_WIDEN_ULPS = 8.0
MESH_MIRROR_FRAMES = 4
MESH_KEPT_FRAMES = 4
# The mesh sweep kernel (csrc/meshsweep.cu) replaces the JAX sweep's
# `tile_fn`, a jnp loop that XLA fuses (not a Pallas kernel); its launches
# count under this key, on the paths that render hifi batches.
MESH = "mesh_sweep"
MESH_JNP_LOOP = "constructionsceneposeestimation_tpu/render/meshcast.py:307-344"
HIFI_PATHS = ("generate_hifi", "train_detect_hifi", "hifi_eval", "infer_hifi",
              "generate_hifi_textured", "train_detect_textured")
# The mesh terms kernel (csrc/meshterms.cu) replaces the JAX caster's
# `_world_corners` and the head of its `packed`, a jnp computation XLA
# fuses (not a Pallas kernel): every render's triangle terms, block boxes
# and triangle spheres. Its launches count under MESH_TERMS, the plain
# version's calls on the card under PLAIN_TERMS (0 on every path).
MESH_TERMS = "mesh_terms"
PLAIN_TERMS = "plain_mesh_terms_on_card"
MESH_TERMS_JNP = "constructionsceneposeestimation_tpu/render/meshcast.py:253-305"
# The kernel against plain_mesh_terms: each part within MESH_TERMS_UNITS
# units of meshcast.terms_gap (2^-23 x the corners' scale x the part's
# derivative by a corner). Both round each corner to a few ulps of its
# scale, einsum and FMA chains in other orders; the plain version is within
# ~1.6 units of a float64 reference on tests/test_torch_mesh_terms.py's
# scenes.
MESH_TERMS_UNITS = 8.0
# Operations csrc/meshterms.cu does a slot, counted from the source (an FMA
# as two): a rigid corner R v + p 18, a skinned corner's two bones and
# blend 48, three corners a slot; then e1, e2, s 9, three cross products
# 27, tn 5, the sphere 49 (centroid 9, three distances 27, max 2, the cr
# test 5, widen and select 3, centre - o 3) and the box 18 (the slot's
# min and max 12, its share of the block's reduction 6).
MESH_TERMS_CORNER_OPS = {"rigid": 18, "skinned": 48}
MESH_TERMS_SLOT_OPS = 108
# The analytic caster's kernel (csrc/raycast.cu) in its three modes, each
# the kernel of a jnp sweep of the JAX caster (not a Pallas kernel); their
# launches count under these keys, the profiler names their instantiations
# by RAYCAST_KERNEL. PLAIN_CASTER counts the plain walks
# (render/raycast.packed_sweep, exact_sweep, multi_sweep) run on the card
# within a path: 0 on every path.
RAYCAST_PACKED, RAYCAST_EXACT, RAYCAST_MULTI = "raycast_packed", "raycast_exact", "raycast_multi"
RAYCAST_MODES = (RAYCAST_PACKED, RAYCAST_EXACT, RAYCAST_MULTI)
RAYCAST_KERNEL = {RAYCAST_PACKED: "raycast_kernel<0>", RAYCAST_EXACT: "raycast_kernel<1>",
                  RAYCAST_MULTI: "raycast_kernel<2>"}
RAYCAST_JNP_LOOP = {
    RAYCAST_PACKED: "constructionsceneposeestimation_tpu/render/raycast.py:542-653 "
                    "(_sweep_packed_fast)",
    RAYCAST_EXACT: "constructionsceneposeestimation_tpu/render/raycast.py:180-198, 272-324 "
                   "(_sweep, _local_normal)",
    RAYCAST_MULTI: "constructionsceneposeestimation_tpu/render/raycast.py:243-254 "
                   "(_sweep_packed_multi)",
}
PLAIN_CASTER = "raycast_plain_on_card"
# Operations csrc/raycast.cu does on one (ray, row) pair, by the row's op
# (render/raycast.OP_*), counted from the source (each add, multiply,
# compare, and, min/max, select, abs, divide and square root as one): the
# generic local-frame formulas of plane, sphere, box, cylinder, cone and
# capsule, then the packed walk's transform-free plane, sphere, cylinder
# and cone, fence slab box, yaw box and axial capsule. A generic row also
# needs its local direction (three dots, RAYCAST_LOCAL_OPS), and in the
# per-origin mode its local origin (three differences and dots,
# RAYCAST_ORIGIN_OPS); every pair ends in a pack and a min, or a compare
# and two selects (RAYCAST_MERGE_OPS). A packed ray needs its reciprocals
# and dots once (RAYCAST_RAY_OPS), an exact hit its normal, in world axes
# (RAYCAST_NORMAL_OPS).
RAYCAST_ROW_OPS = {0: 10, 1: 30, 2: 45, 3: 69, 4: 99, 5: 72,
                   8: 5, 9: 25, 10: 59, 11: 91, 12: 33, 13: 52, 14: 83}
RAYCAST_LOCAL_OPS = 15
RAYCAST_ORIGIN_OPS = 18
RAYCAST_MERGE_OPS = 3
RAYCAST_RAY_OPS = 28
RAYCAST_NORMAL_OPS = 60
# The replay kernel (csrc/draws.cu) replaces no Pallas kernel: the JAX
# package folds jax.random keys on the accelerator, where the port's host
# path draws from CPU generators, whose streams the kernel replays. Timed at
# the i.i.d. cells' shape (512 frames, 52 scene groups). Its bound is
# latency: a stream's seeding is DRAWS_CHAIN dependent steps, each a shift,
# an xor and a multiply-add (DRAWS_STEP_CYCLES cycles of the SM clock, an
# estimate), beside the bytes it moves.
DRAWS = "draws"
DRAWS_REPLACES = ("constructionsceneposeestimation_tpu/parallel/pipeline.py (jax.random "
                  "folds of the scene and frame keys, on the accelerator)")
DRAWS_FRAMES = 512
DRAWS_CHAIN = 623
DRAWS_STEP_CYCLES = 12
# The line heads `train-eval` prints after training (the JAX cli.py:262-331).
TRAIN_EVAL_LINES = (
    "decode-floor PCK@0.5:", "model PCK@0.5:", "assoc decode floor:",
    "human PCK@0.5 (DARK):", "  weakest joints:", "human PCK@0.5 (soft-argmax):",
    "dumper channel scores:", "dumper ADD (GT kpts):", "dumper ADD (model kpts):",
    "crane ADD (GT kpts):", "crane ADD (model kpts):")
# The JAX tiers each RGB variant shades on the card (jnp, outside the Pallas
# kernel, annotate.py:276-280), by the variant's first part.
JNP_TIERS = {
    "normal": "constructionsceneposeestimation_tpu/render/annotate.py:217-219",
    "shadow": "constructionsceneposeestimation_tpu/render/annotate.py:374-385",
    "flat": "constructionsceneposeestimation_tpu/render/annotate.py:251-252",
    "textured": "constructionsceneposeestimation_tpu/render/annotate.py:326-337",
}
REPLACES = {
    "pixel_sweep": "constructionsceneposeestimation_tpu/render/sweep_kernel.py:107",
    "rgb_epilogue": "constructionsceneposeestimation_tpu/render/rgb_kernel.py:51",
    "heatmap_targets": "constructionsceneposeestimation_tpu/ops/heatmap.py:58",
    "peak_decode": "constructionsceneposeestimation_tpu/ops/peak_kernel.py:56",
    MESH: "constructionsceneposeestimation_tpu/render/meshcast.py:307",
    MESH_TERMS: "constructionsceneposeestimation_tpu/render/meshcast.py:253",
    RAYCAST_PACKED: "constructionsceneposeestimation_tpu/render/raycast.py:542",
    RAYCAST_EXACT: "constructionsceneposeestimation_tpu/render/raycast.py:180",
    RAYCAST_MULTI: "constructionsceneposeestimation_tpu/render/raycast.py:243",
}
SOURCES = {
    "pixel_sweep": "constructionsceneposeestimation_tpu_torch/csrc/sweep.cu",
    "rgb_epilogue": "constructionsceneposeestimation_tpu_torch/csrc/rgb.cu",
    "heatmap_targets": "constructionsceneposeestimation_tpu_torch/csrc/heatmap.cu",
    "peak_decode": "constructionsceneposeestimation_tpu_torch/csrc/peaks.cu",
    MESH: "constructionsceneposeestimation_tpu_torch/csrc/meshsweep.cu",
    MESH_TERMS: "constructionsceneposeestimation_tpu_torch/csrc/meshterms.cu",
    **dict.fromkeys(RAYCAST_MODES, "constructionsceneposeestimation_tpu_torch/csrc/raycast.cu"),
}
# The least time the card could take: the larger of the bytes the function
# must move (each input read once, each output written once) over the
# memory rate, and its operations over the FP32 rate outside the tensor
# cores (NVIDIA's published H100 SXM peaks, at a 700 W power limit).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# Operations a pixel-ray needs for each primitive kind of the sweep's
# schedule, and for the ray itself, counted from csrc/sweep.cu (each add,
# multiply, compare, min/max, select, divide and square root as one):
# plane, sphere, upright cylinder, upright cone, axis-aligned box, yaw box,
# capsule, general box, general cylinder.
SWEEP_RAY_OPS = 43
SWEEP_KIND_OPS = {0: 12, 1: 27, 2: 44, 3: 97, 4: 37, 5: 57, 6: 97, 7: 79, 8: 83}
# csrc/rgb.cu: operations a pixel outside the contact-AO loop counted with
# three rays a pixel (its own and its two neighbours': normal, local frame,
# patterns, hash noise, shading, three gamma chains), and per AO row on a
# ground pixel. One ray and hit point (pinhole coordinates 4, ray 12,
# normalise 9, finite test and select 2, hit point 6) is 33 of them: the
# function needs it once a pixel, the neighbours' being their own work, so
# the bound charges 259 - 2 x 33 a hit pixel and, on a ground pixel, the AO
# rows it lies within reach of (render/rgb_kernel.ao_rows_needed). The count
# of every AO row on every ground pixel with three rays stands beside it.
RGB_PIXEL_OPS = 259
RGB_RAY_OPS = 33
RGB_AO_ROW_OPS = 11
# A sky pixel (t not finite) needs only its ray direction (pinhole
# coordinates 4, ray 12, normalise 9), the finite test 1, the sky gradient
# (clamp 2, scale and offset 2, the dome's floor and product 2) and three
# channels of product 1, clamp 2, gamma chain 12, scale and round 2; every
# RGB bound charges a sky pixel that.
RGB_SKY_OPS = 83
# csrc/rgb.cu's tier variants against the default pixel: a given normal
# skips the screen-space normal (6 differences, the cross product 9, its
# normalise 8 and scale 3, the camera test 6 and flip 3); a flat albedo
# skips the local frame (18), procedural_albedo's tests, selects and
# overrides (62) and the AO factor (5); the shadow gate adds a compare and
# a select.
RGB_SCREEN_NORMAL_OPS = 35
RGB_PROCEDURAL_OPS = 85
RGB_SHADOW_OPS = 2
# [analytic]: the hifi check's frames, and the card against the CPU on 4
# frames of 128^2.
ANALYTIC_HIFI_FRAMES = 4
SMALL_RES = 128
# csrc/heatmap.cu: per (pixel, visible keypoint of the map's channel).
HEATMAP_KPT_OPS = 9
# csrc/peaks.cu, per pixel: relu 1, separable blur 10, separable 3x3 max 4,
# compare and select 2, one compare per selection round.
PEAK_PIXEL_OPS = 17


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


def cuda_ms(fn, iters=5, warmup=2):
    """Mean milliseconds per call, CUDA events around ``iters`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# The kernels' profiler keys that device_ms_window timed by CUDA events.
EVENTS_TIMED = set()


def device_ms(fn, key, iters=10):
    """Mean device milliseconds per launch of the kernels whose name holds
    ``key``, from torch.profiler over ``iters`` calls after a warm-up
    (``device_ms_window``)."""
    return device_ms_window([(fn, key)], iters)[0]


def device_ms_window(calls, iters=10):
    """Mean device milliseconds per launch of each ``(fn, key)`` of
    ``calls``, the kernels whose name holds ``key``, from torch.profiler
    over ``iters`` calls of each, taken in turns in one window after a
    warm-up: the kernel's own time, without its wrapper's host work, which
    exceeds a 0.2 ms kernel and would hide it from CUDA events around the
    calls. The window is the profiler's active step after a warm-up step of
    the same calls (``schedule(warmup=1, active=1)``): without one, the
    profiler has dropped records of the launches early in a window on the
    H100. Each mean is over the launches it recorded, and a shortfall is
    printed with the kernel names it did record; a window in which it
    recorded none of a key is profiled again, up to 3 times, and then that
    kernel is timed by CUDA events around its calls instead, which is
    printed."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    out = [None] * len(calls)
    for attempt in range(3):
        for fn, _ in calls:
            fn()
        torch.cuda.synchronize()
        kept = []
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p: kept.append(p.key_averages())) as prof:
            for _ in range(2):
                for _ in range(iters):
                    for fn, _ in calls:
                        fn()
                torch.cuda.synchronize()
                prof.step()
        check(len(kept) == 1, f"the profiler closed {len(kept)} active windows, not 1")
        averages = [e for e in kept[0] if e.device_type == torch.autograd.DeviceType.CUDA]
        for i, (_, key) in enumerate(calls):
            if out[i] is not None:
                continue
            evs = [e for e in averages if key in e.key]
            seen = sum(e.count for e in evs)
            check(seen <= iters, f"profiler saw {key} launched {seen} times in {iters} calls")
            if seen < iters:
                names = {e.key[:90]: e.count for e in averages}
                phase("time", f"profiler recorded {seen} of {iters} {key} launches (window "
                      f"{attempt + 1} of 3); the kernels it recorded: {names}")
            if seen:
                out[i] = sum(e.self_device_time_total for e in evs) / 1000.0 / seen
        if all(v is not None for v in out):
            return out
    for i, (fn, key) in enumerate(calls):
        if out[i] is None:
            out[i] = cuda_ms(fn, iters=iters)
            EVENTS_TIMED.add(key)
            phase("time", f"{key}: timed by CUDA events around {iters} calls instead: "
                  f"{out[i]:.4f} ms, the wrapper's host work included")
    return out


def sweep_agreement(tag, packed_k, packed_p):
    """The sweep kernel's packed output (B, H*W) against its plain
    version's, RES x RES frames: printed and held. Returns (t, code) of
    both and the same-instance hit mask."""
    import torch
    from constructionsceneposeestimation_tpu_torch.render import raycast
    tk, ck = raycast._unpack(packed_k)
    tp, cp = raycast._unpack(packed_p)
    torch.cuda.synchronize()
    n = tk.shape[0]
    hk, hp = tk < raycast.INF * 0.99, tp < raycast.INF * 0.99
    both = hk & hp
    same = both & (ck == cp)
    rel_all = torch.abs(tk - tp) / tp
    rel = rel_all[both]
    rel_same = rel_all[same]
    hit_agree = (hk == hp).float().mean().item()
    inst_agree = (ck[both] == cp[both]).float().mean().item()
    frac_1e5 = (rel > 1e-5).float().mean().item()
    # The TPU kernel's own test bounds the max at 2e-4 on ~1e5 pixels. Over
    # ~1e7 hit pixels a few dozen grazing rays (disc ~ 0 on a quadric, or a
    # flip to the surface behind) exceed it, so the bound is held on all but
    # 1e-5 of the hit pixels; those exceeding it are reported with whether
    # they sit on an instance or depth edge (> 1% jump to a 4-neighbour).
    big = both & (rel_all > 2e-4)
    tg = torch.where(hp, tp, raycast.INF).reshape(n, RES, RES)
    cg = cp.reshape(n, RES, RES)
    edge = torch.zeros_like(cg, dtype=torch.bool)
    for dim in (1, 2):
        for s in (1, -1):
            edge |= ((torch.roll(cg, s, dim) != cg)
                     | (torch.abs(torch.roll(tg, s, dim) - tg) > 0.01 * tg))
    off_edge = big & ~edge.reshape(n, -1)
    for b_i, p_i in torch.nonzero(off_edge).tolist()[:5]:
        phase(tag, f"off-edge frame {b_i} px {divmod(p_i, RES)}: kernel t "
              f"{tk[b_i, p_i].item()} code {ck[b_i, p_i].item()}, plain t "
              f"{tp[b_i, p_i].item()} code {cp[b_i, p_i].item()}")
    frac_big = int(big.sum()) / int(both.sum())
    phase(tag, f"hit agree {hit_agree:.6f} (> 0.9995), inst agree {inst_agree:.6f} "
          f"(> 0.999), rel > 1e-5 on {frac_1e5:.5f} (< 0.005) of {int(both.sum())} hit "
          f"pixels; rel > 2e-4 on {int(big.sum())} pixels ({frac_big:.2e} < 1e-5): "
          f"{int((big & (ck != cp)).sum())} instance flips, {int(off_edge.sum())} off an edge; "
          f"max rel {rel.max().item():.3e}, {rel_same.max().item():.3e} on same-instance hits")
    check(hit_agree > 0.9995 and frac_big < 1e-5 and frac_1e5 < 0.005 and inst_agree > 0.999,
          f"{tag}: sweep kernel disagrees with its plain version")
    return tk, ck, tp, cp, same


def segment_agreement(tag, packed_k, packed_p):
    """The mesh sweep kernel's packed output on keypoint segments (B, N)
    against its plain version's: ``sweep_agreement``'s bars on hits,
    instances and t, without its edge test (the rays are not a grid).
    Returns (t, code) of both and the same-instance hit mask."""
    import torch
    from constructionsceneposeestimation_tpu_torch.render import raycast
    tk, ck = raycast._unpack(packed_k)
    tp, cp = raycast._unpack(packed_p)
    hk, hp = tk < raycast.INF * 0.99, tp < raycast.INF * 0.99
    both = hk & hp
    rel = (torch.abs(tk - tp) / tp)[both]
    n = max(int(both.sum()), 1)
    hit_agree = (hk == hp).float().mean().item()
    inst_agree = 1.0 - int((ck[both] != cp[both]).sum()) / n
    frac_1e5, frac_big = int((rel > 1e-5).sum()) / n, int((rel > 2e-4).sum()) / n
    phase(tag, f"segments: hit agree {hit_agree:.6f} (> 0.9995), inst agree {inst_agree:.6f} "
          f"(> 0.999), rel > 1e-5 on {frac_1e5:.5f} (< 0.005) and rel > 2e-4 on {frac_big:.2e} "
          f"(< 1e-5) of {int(both.sum())} hit rays")
    check(hit_agree > 0.9995 and inst_agree > 0.999 and frac_1e5 < 0.005 and frac_big < 1e-5,
          f"{tag}: the segments' sweep kernel disagrees with its plain version")
    return tk, ck, tp, cp, both & (ck == cp)


def mesh_triples(m, ray_o, ray_d, lay):
    """The visited (frame, group, block) triples of the mesh sweep (V, 3),
    in chunks of ``plain_mesh_sweep``'s size: [(b, g, k), ...]."""
    import torch
    from constructionsceneposeestimation_tpu_torch.render import meshcast
    rays = meshcast.group_rays(ray_d, lay)
    triples = torch.nonzero(meshcast.block_hits(ray_o, rays, m.lo, m.hi))
    step = max(1, meshcast.MAX_PAIRS // (lay.rays * m.terms.shape[-1]))
    return rays, [triples[c:c + step].unbind(1) for c in range(0, triples.shape[0], step)]


def mesh_pair_passes(m, ray_o, ray_d, lay) -> int:
    """The (ray, triangle) pairs of the visited blocks that pass the mesh
    sweep kernel's division-free test (u_num and v_num of det's sign,
    |u_num + v_num| <= |det|, |det| >= EPS): the pairs that take its
    reciprocal, t and min. The test in PyTorch (``meshcast.pair_passes``),
    chunked as ``plain_mesh_sweep`` chunks its own; its dots are summed in
    the plain version's order, so a pair within an ulp of an edge may count
    otherwise than in the kernel."""
    from constructionsceneposeestimation_tpu_torch.render import meshcast
    W, _ = meshcast.block_matrices(m.terms)
    rays, chunks = mesh_triples(m, ray_o, ray_d, lay)
    return sum(int(meshcast.pair_passes(W[b, k], rays[b, g]).sum()) for b, g, k in chunks)


def mesh_needed_pairs(m, ray_o, ray_d, lay) -> int:
    """The (ray, triangle) pairs of the visited blocks whose ray (a
    half-line from the frame's origin) meets the triangle's bounding sphere
    (``m.spheres``, as ``mesh_terms`` widens them; a padding triangle
    never): the pairs any cull must still test, the work the mesh sweep's
    bound charges. Chunked as ``mesh_pair_passes``."""
    import torch
    rays, chunks = mesh_triples(m, ray_o, ray_d, lay)
    sph = m.spheres.transpose(2, 3)  # (B, nb, T, 4)
    needed = 0
    for b, g, k in chunks:
        d, s = rays[b, g], sph[b, k]  # (P, R, 3), (P, T, 4)
        v, r = s[..., :3], s[..., 3]
        tc = torch.bmm(d, v.transpose(1, 2))  # (P, R, T)
        dd = torch.sum(d * d, -1)[..., None]
        vv, r2 = torch.sum(v * v, -1)[:, None], (r * r)[:, None]
        meets = ((tc > 0) & (vv * dd - tc * tc <= r2 * dd)) | (vv <= r2)
        needed += int((meets & (r >= 0)[:, None]).sum())
    return needed


def mesh_cull_report(m, codes, ray_o, ray_d, lay) -> dict:
    """The mesh sweep kernel's patch cull (``meshcast.PATCH``) on the pixel
    rays: its ``kept`` words, MESH_KEPT_FRAMES frames a call, as
    triangles kept a ray (``kept``: the (ray, triangle) pairs it tests);
    the (patch, triangle) pairs of the visited blocks where some ray of
    the patch passes the test widened by MESH_WIDEN_ULPS (``widened``) and
    those of them the patch did not keep (``lost``, which must be 0); on the first
    MESH_MIRROR_FRAMES frames, the share of (visited triple, patch) rows
    whose kept set equals ``patch_cull_plain``'s (``mirror_agree`` of
    ``mirror_rows``)."""
    import torch
    from constructionsceneposeestimation_tpu_torch.render import meshcast
    ph, pw = meshcast.PATCH_SHAPE
    res = {"kept": 0, "widened": 0, "lost": 0, "mirror_agree": 0, "mirror_rows": 0}
    for f0 in range(0, ray_d.shape[0], MESH_KEPT_FRAMES):
        sl = slice(f0, f0 + MESH_KEPT_FRAMES)
        sub, o, d = meshcast.MeshTerms(*(t[sl] for t in m)), ray_o[sl], ray_d[sl]
        kept = torch.zeros(meshcast.kept_shape(d.shape[0], lay, m.lo.shape[1]),
                           dtype=torch.int32, device=d.device)
        meshcast.mesh_sweep_cuda(sub.terms, sub.lo, sub.hi, sub.spheres, codes, o, d, lay,
                                 kept=kept, walk=meshcast.PATCH)
        mirror = (meshcast.patch_cull_plain(sub.lo, sub.hi, sub.spheres, o, d, lay)[1]
                  if f0 < MESH_MIRROR_FRAMES else None)
        W, _ = meshcast.block_matrices(sub.terms)
        rays, chunks = mesh_triples(sub, o, d, lay)
        for b, g, k in chunks:
            mine = meshcast.kept_triangles(kept[b, g, :, k])  # (V, patches, T)
            need = meshcast.patch_passes(W[b, k], rays[b, g], MESH_WIDEN_ULPS)
            res["kept"] += int(mine.sum()) * ph * pw
            res["widened"] += int(need.sum())
            lost = torch.nonzero(need & ~mine)
            res["lost"] += lost.shape[0]
            for v, p, i in lost[:4].tolist():
                res.setdefault("lost_pairs", []).append(
                    {"frame": f0 + int(b[v]), **mesh_lost_pair(
                        sub, W, rays, int(b[v]), int(g[v]), int(k[v]), p, i)})
            if mirror is not None:
                res["mirror_agree"] += int((mirror[b, g, :, k] == mine).all(-1).sum())
                res["mirror_rows"] += mine.shape[0] * mine.shape[1]
        del kept, mirror
    res["mirror_agree"] /= max(res["mirror_rows"], 1)
    return res


def mesh_segment_cull_report(m, codes, ray_o, ray_d, lay) -> dict:
    """The mesh sweep kernel's segment walk cull (``meshcast.SEGMENTS``) on
    the keypoint segments: its ``kept`` words of one call, as the
    (segment, triangle) pairs it tests (``kept``: each set's kept
    triangles times its rays) and the (set, block) pairs with a kept
    triangle (``blocks``); the (segment, triangle) pairs of the visited
    blocks that pass the test widened by MESH_WIDEN_ULPS, t > EPS included
    (``widened``), and those whose triangle the segment's set did not keep
    (``lost``, which must be 0); on the first MESH_MIRROR_FRAMES frames,
    the share of (visited triple, set) rows whose kept set equals
    ``segment_cull_plain``'s (``mirror_agree`` of ``mirror_rows``)."""
    import torch
    from constructionsceneposeestimation_tpu_torch.render import meshcast
    dev, F = ray_d.device, MESH_MIRROR_FRAMES
    kept = torch.zeros(meshcast.kept_shape(ray_d.shape[0], lay, m.lo.shape[1]),
                       dtype=torch.int32, device=dev)
    meshcast.mesh_sweep_cuda(m.terms, m.lo, m.hi, m.spheres, codes, ray_o, ray_d, lay, kept=kept,
                             walk=meshcast.SEGMENTS)
    S = kept.shape[2]
    live = (lay.rays - meshcast.SET * torch.arange(S, device=dev)).clamp(max=meshcast.SET)
    set_of = torch.arange(lay.rays, device=dev) // meshcast.SET
    mirror = meshcast.segment_cull_plain(m.lo[:F], m.hi[:F], m.spheres[:F], ray_o[:F],
                                         ray_d[:F], lay)
    W, tn = meshcast.block_matrices(m.terms)
    rays, chunks = mesh_triples(m, ray_o, ray_d, lay)
    res = {"kept": 0, "blocks": int((kept != 0).any(-1).sum()), "sets": kept[:, :, :, 0, 0].numel(),
           "widened": 0, "lost": 0, "mirror_agree": 0, "mirror_rows": 0}
    for b, g, k in chunks:
        mine = meshcast.kept_triangles(kept[b, g, :, k])  # (V, sets, T)
        res["kept"] += int((mine.sum(-1) * live).sum())
        need = meshcast.pair_passes(W[b, k], rays[b, g], MESH_WIDEN_ULPS, tn[b, k])  # (V, R, T)
        res["widened"] += int(need.sum())
        lost = torch.nonzero(need & ~mine[:, set_of])
        res["lost"] += lost.shape[0]
        for v, r, i in lost[:4].tolist():
            res.setdefault("lost_pairs", []).append(
                {"frame": int(b[v]), "block": int(k[v]), "ray": r, "triangle": i})
        first = b < F
        res["mirror_agree"] += int((mirror[b[first], g[first], :, k[first]]
                                    == mine[first]).all(-1).sum())
        res["mirror_rows"] += int(first.sum()) * S
        del mine, need
    res["mirror_agree"] /= max(res["mirror_rows"], 1)
    return res


def mesh_lost_pair(m, W, rays, b, g, k, p, i) -> dict:
    """A (patch, triangle) pair that the patch cull dropped although a ray
    of the patch passes the widened test: tile g, block k, patch p,
    triangle i of frame b of ``m`` (W, rays: ``block_matrices`` and
    ``group_rays`` of it); for the first such ray, det beside EPS and its
    widened tolerance, the barycentrics u_num / det and v_num / det, and
    the ray's distance from the sphere's centre over its radius."""
    import torch
    from constructionsceneposeestimation_tpu_torch.render import meshcast
    ph, pw = meshcast.PATCH_SHAPE
    side, T = meshcast.PATCH_SIDE, W.shape[-1] // 3
    Wk, d_all = W[b, k], rays[b, g]
    ok = meshcast.pair_passes(Wk[None], d_all[None], MESH_WIDEN_ULPS)[0, :, i]
    rows = (p // (side // pw)) * ph + torch.arange(ph)
    cols = (p % (side // pw)) * pw + torch.arange(pw)
    in_patch = (rows[:, None] * side + cols[None]).reshape(-1).to(d_all.device)
    r = int(in_patch[ok[in_patch]][0])
    d = d_all[r]
    det, un, vn = (d @ Wk).unflatten(-1, (3, T))[:, i].tolist()
    t_det = float((torch.abs(d) @ torch.abs(Wk))[i]) * MESH_WIDEN_ULPS * 2.0 ** -23
    c, rad = m.spheres[b, k, :3, i], float(m.spheres[b, k, 3, i])
    tc = float(d @ c) / float(d @ d)
    return {"tile": g, "block": k, "patch": p, "triangle": i, "ray": r, "det": det,
            "t_det": t_det, "u": un / det, "v": vn / det, "t_along": tc,
            "miss_over_radius": float(torch.linalg.norm(c - tc * d)) / rad}


def bound(nbytes: float, nops: float):
    """(bound_ms, bound_by) of a function that moves ``nbytes`` and does
    ``nops`` operations."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


class _Tee(io.TextIOBase):
    """Standard output that also keeps what was written."""

    def __init__(self, out):
        self.out, self.kept = out, io.StringIO()

    def write(self, text):
        self.kept.write(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()


def drive_cli(argv):
    """The port's CLI in-process, as a user calls it; its output is echoed
    and returned as lines."""
    from constructionsceneposeestimation_tpu_torch import cli
    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        cli.main(argv)
    return tee.kept.getvalue().splitlines()


def tensors_equal(a, b) -> bool:
    """Two nested dicts of tensors and numbers, equal bit for bit."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(tensors_equal(a[k], b[k]) for k in a)
    if hasattr(a, "shape"):
        import torch
        return bool(torch.equal(a, b))
    return a == b


def crane_frame_add(ev, batch, roster, intr, stride):
    """The crane solve on GT keypoints, frame by frame: the median over the
    accepted frames of the mean ADD of the parts in view, and the frames
    beyond 1 m with their keypoints in view per part."""
    import torch
    from constructionsceneposeestimation_tpu_torch.eval import metrics
    res = ev.crane_solve(batch, roster, intr, stride, use_gt_keypoints=True)
    s0, s1 = roster.crane_slice
    accepted = res.valid & (res.rmse <= 8.0 * (1.0 / float(intr.fx)))
    adds, seen = [], []
    for pi in range(4):
        o = s0 + pi
        pts = metrics.aabb_corners(roster.inst_aabb_min[o], roster.inst_aabb_max[o],
                                   batch.kpt_uv.device)
        R_gt, t_gt = ev.gt_camera_frame_pose(roster, batch, o)
        adds.append(metrics.add_metric(res.R[:, pi], res.t[:, pi], R_gt, t_gt, pts))
        seen.append(batch.inst_visible[:, o])
    adds, seen = torch.stack(adds, -1), torch.stack(seen, -1).float()
    frame_add = (adds * seen).sum(-1) / seen.sum(-1).clamp_min(1)
    keep = accepted & (seen.sum(-1) > 0)
    n_vis = batch.kpt_visible[:, s0:s1].sum(-1)
    far = [(int(batch.frame_id[f]), round(float(frame_add[f]), 2), n_vis[f].tolist())
           for f in torch.nonzero(keep & (frame_add > 1.0)).flatten()]
    return float(frame_add[keep].median()), far


def crane_frames_differ(ev, group, g_dev, g_cpu, hm, pipe, stride):
    """Print each frame whose crane solve is valid or accepted on one side
    only, with both RMSEs beside the gate."""
    kw = (dict(use_gt_keypoints=True) if group == "crane_gt_kpts"
          else dict(heatmaps=hm, score_threshold=0.15))
    res_c = ev.crane_solve(g_cpu, pipe.roster, pipe.intr, stride, **kw)
    if "heatmaps" in kw:
        kw["heatmaps"] = hm.to(g_dev.heatmaps.device)
    res_d = ev.crane_solve(g_dev, pipe.roster, pipe.intr, stride, **kw)
    gate = 8.0 / float(pipe.intr.fx)
    for f in range(res_c.valid.shape[0]):
        vd, vc = bool(res_d.valid[f]), bool(res_c.valid[f])
        rd, rc = float(res_d.rmse[f]), float(res_c.rmse[f])
        if vd != vc or (rd <= gate) != (rc <= gate):
            phase("eval", f"{group} frame {f}: valid card {vd} CPU {vc}; rmse card {rd:.6g} "
                  f"CPU {rc:.6g}, gate {gate:.6g}")


def train_timing(dev, card):
    """The stage-1 training step (32 x 512^2, full width, focal, camera-mix
    0.3) on the card: ms a step and img/s by CUDA events (the min and the
    mean of 6 steps after 3 of warm-up), the split between datagen (generate
    and the augment draws), forward+backward and the optimizer (CUDA events
    between the three, summed over the same steps), the device's busy share
    of 3 steps under torch.profiler, and the peak memory of a step."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from constructionsceneposeestimation_tpu_torch.config import (Config, PipelineConfig,
                                                                  TrainConfig)
    from constructionsceneposeestimation_tpu_torch.models import pose_net
    from constructionsceneposeestimation_tpu_torch.parallel.pipeline import Pipeline
    from constructionsceneposeestimation_tpu_torch.train import loop as train_loop

    cfg = Config(pipeline=PipelineConfig(render_width=RES, render_height=RES),
                 train=TrainConfig(batch_size=TRAIN_B, steps=32000, loss="focal",
                                   camera_mix=0.3))
    state = train_loop.create_train_state(cfg, pose_net.make_model(device=dev))
    step = train_loop.make_train_step(cfg, state.model, Pipeline(cfg, device=dev))
    bs = step.train_on_batch
    frame = [0]

    def fids():
        frame[0] += TRAIN_B
        return range(frame[0] - TRAIN_B, frame[0])

    for _ in range(3):
        state, _ = step(state, SEED + 1, fids())
    torch.cuda.synchronize()
    split = {"datagen": 0.0, "forward_backward": 0.0, "optimizer": 0.0}
    steps_ms = []
    for _ in range(6):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        batch, draws = step.generate(SEED + 1, fids())
        ev[1].record()
        loss = bs.forward_backward(state, batch, draws)
        ev[2].record()
        bs.update(state)
        ev[3].record()
        torch.cuda.synchronize()
        check(math.isfinite(loss.item()), "timed training step: loss not finite")
        for k, (a, b) in zip(split, ((0, 1), (1, 2), (2, 3))):
            split[k] += ev[a].elapsed_time(ev[b]) / 6
        steps_ms.append(ev[0].elapsed_time(ev[3]))
    best, mean = min(steps_ms), sum(steps_ms) / len(steps_ms)
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 1e9
    state, _ = step(state, SEED + 1, fids())
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            state, _ = step(state, SEED + 1, fids())
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    launches = sum(e.count for e in kern) / 3
    phase("time", f"training step {TRAIN_B} x {RES}^2 (generate, augment, full-width forward "
          f"and backward, focal, AdamW): steps {[round(x, 3) for x in steps_ms]} ms; min "
          f"{best:.3f} ms = {TRAIN_B * 1000.0 / best:.1f} img/s, mean {mean:.3f} ms = "
          f"{TRAIN_B * 1000.0 / mean:.1f} img/s on {card}")
    phase("time", "training step split (mean of 6, CUDA events): " + ", ".join(
        f"{k} {v:.3f} ms ({100 * v / sum(split.values()):.1f}%)" for k, v in split.items())
        + f" on {card}")
    phase("time", f"training step under torch.profiler: 3 steps in {wall_ms:.1f} ms wall, "
          f"device busy {busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}% of wall; the "
          f"profiler slows the host), {launches:.0f} kernel launches a step; peak memory "
          f"{peak_gb:.2f} GB (torch.cuda.max_memory_allocated; {base_gb:.2f} GB held before "
          f"the step, the model, its AdamW state and the earlier phases' tensors) on {card}")


def shard_arrays(path):
    """Every array of an npz shard."""
    import numpy as np
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def host_fields(batch):
    """A card ``FrameBatch`` as ``save_shard`` stores it: numpy, heatmaps f16."""
    import numpy as np
    out = {k: v.cpu().numpy() for k, v in batch._asdict().items() if k != "kpt_in_image"}
    out["heatmaps"] = out["heatmaps"].astype(np.float16)
    return out


def caster_wrappers():
    """The analytic caster's kernel wrappers, by launch-count key."""
    from constructionsceneposeestimation_tpu_torch.render import raycast
    return {RAYCAST_PACKED: raycast.packed_cuda, RAYCAST_EXACT: raycast.exact_cuda,
            RAYCAST_MULTI: raycast.multi_cuda}


def plain_walks():
    """The caster's plain walks, whose ``card_calls`` count their calls on
    the card."""
    from constructionsceneposeestimation_tpu_torch.render import raycast
    return raycast.packed_sweep, raycast.exact_sweep, raycast.multi_sweep


def reset(counters):
    """Set every kernel wrapper's launch counts to 0, the mesh sweep's and
    terms', the caster's and the plain caster walks' and terms' too."""
    from constructionsceneposeestimation_tpu_torch.render import meshcast
    for fn in [*counters.values(), *caster_wrappers().values()]:
        fn.launches = 0
    rgb = counters["rgb_epilogue"]
    rgb.textured_launches = 0
    rgb.tier_launches = dict.fromkeys(rgb.tier_launches, 0)
    meshcast.mesh_sweep_cuda.launches = meshcast.mesh_terms_cuda.launches = 0
    meshcast.plain_mesh_terms.card_calls = 0
    for fn in plain_walks():
        fn.card_calls = 0


def read(counters):
    """Every kernel wrapper's launch count, the RGB kernel's textured
    launches (``TEXTURED``) and those of each tier variant
    (``tier_key``), which its ``launches`` do not include, the mesh
    sweep's (``MESH``) and terms' (``MESH_TERMS``), which launch on the
    hifi paths only, the plain terms run on the card (``PLAIN_TERMS``), the
    caster's three modes (``RAYCAST_MODES``) and the plain caster walks run
    on the card (``PLAIN_CASTER``)."""
    from constructionsceneposeestimation_tpu_torch.render import meshcast
    rgb = counters["rgb_epilogue"]
    return {**{k: fn.launches for k, fn in counters.items()},
            TEXTURED: rgb.textured_launches,
            **{tier_key(v): n for v, n in rgb.tier_launches.items()},
            MESH: meshcast.mesh_sweep_cuda.launches,
            MESH_TERMS: meshcast.mesh_terms_cuda.launches,
            PLAIN_TERMS: meshcast.plain_mesh_terms.card_calls,
            **{k: fn.launches for k, fn in caster_wrappers().items()},
            PLAIN_CASTER: sum(fn.card_calls for fn in plain_walks())}


def tier_key(variant):
    """The launch-count key of an RGB tier variant (``rgb_kernel.VARIANTS``)."""
    return f"rgb_epilogue/{variant}"


def generate_phase(dev, card, counters, datagen, work):
    """The port's ``generate`` at 512^2: packed shards with heatmaps (bit-equal
    to direct generate on the same padded ids), resume, and the reference
    tree. Returns the packed run's launches and its directory."""
    import numpy as np
    import torch
    from constructionsceneposeestimation_tpu_torch.config import Config, PipelineConfig
    from constructionsceneposeestimation_tpu_torch.io import native, resume, schema
    from constructionsceneposeestimation_tpu_torch.parallel.pipeline import Pipeline

    df = subprocess.run(["df", "-T", str(work)], capture_output=True, text=True).stdout
    fs = " ".join(df.splitlines()[-1].split()[:2]) if df else "df -T failed"
    phase("generate", f"output under {work}, filesystem {fs} (df -T); fastio: {native.route()}")

    out = work / "packed"
    argv = ["generate", "--device", dev.type, "--size", str(RES), "--batch", str(B), "--frames",
            str(GEN_FRAMES), "--format", "packed", "--heatmaps", "--seed", str(SEED),
            "--out", str(out)]
    chunks = [list(range(lo, min(lo + B, GEN_FRAMES))) for lo in range(0, GEN_FRAMES, B)]
    shards = [f"shard_{c[0]:06d}.npz" for c in chunks]
    reset(counters)
    t0 = time.perf_counter()
    lines = drive_cli(argv)
    packed_s = time.perf_counter() - t0
    gen_launches = read(counters)
    check(lines[0] == f"generating {GEN_FRAMES}/{GEN_FRAMES} frames (resume skipped 0, "
          "format=packed)" and lines[-1].startswith(f"done: {GEN_FRAMES} frames in "),
          f"generate printed {lines}")
    done_line = lines[-1]
    check(all(gen_launches[k] == len(chunks) for k in datagen)
          and gen_launches["peak_decode"] == 0,
          f"generate --format packed: launches {gen_launches}, want {len(chunks)} a kernel")
    check(sorted(p.name for p in out.glob("shard_*.npz")) == shards, "shard files")
    check(resume.load_manifest(str(out)) == set(range(GEN_FRAMES)), "resume manifest")
    # Direct generate on the same padded ids: every array bit-equal.
    cfg = Config(pipeline=PipelineConfig(render_width=RES, render_height=RES, batch_size=B,
                                         max_iterations=GEN_FRAMES, seed=SEED))
    gen = Pipeline(cfg, device=dev).make_generate_fn()
    direct = []
    for name, c in zip(shards, chunks):
        with torch.no_grad():
            want = host_fields(gen(SEED, c + [c[-1]] * (B - len(c))))
        got = shard_arrays(out / name)
        check(got.keys() == want.keys() and all(got[k].dtype == v.dtype
                                                and np.array_equal(got[k], v)
                                                for k, v in want.items()),
              f"{name} differs from make_generate_fn on the same ids")
        direct.append(want)
    size_mb = sum((out / s).stat().st_size for s in shards) / 1e6
    phase("generate", f"--format packed --heatmaps: {GEN_FRAMES} frames in {' '.join(shards)} "
          f"({size_mb:.1f} MB; the last holds {len(chunks[-1])} frames and "
          f"{B - len(chunks[-1])} repeats of frame {chunks[-1][-1]}); launches {gen_launches}; "
          f"every array bit-equal to make_generate_fn on the same padded ids; manifest "
          f"0-{GEN_FRAMES - 1}")

    # Resume: nothing pending, then one chunk dropped from the manifest.
    reset(counters)
    lines = drive_cli(argv)
    again = read(counters)
    check(lines[0] == f"generating 0/{GEN_FRAMES} frames (resume skipped {GEN_FRAMES}, "
          "format=packed)" and not any(again.values()), f"second run: {lines[0]}, {again}")
    stamps = {s: (out / s).stat().st_mtime_ns for s in shards}
    (out / shards[1]).unlink()
    Path(resume.manifest_path(str(out))).write_text(json.dumps(
        {"completed_ranges": [[0, B], [2 * B, GEN_FRAMES]]}))
    reset(counters)
    lines = drive_cli(argv)
    third = read(counters)
    got = shard_arrays(out / shards[1])
    same = got.keys() == direct[1].keys() and all(np.array_equal(got[k], v)
                                                 for k, v in direct[1].items())
    kept = all((out / s).stat().st_mtime_ns == stamps[s] for s in (shards[0], shards[2]))
    check(lines[0] == f"generating {B}/{GEN_FRAMES} frames (resume skipped {GEN_FRAMES - B}, "
          "format=packed)" and all(third[k] == 1 for k in datagen) and same and kept
          and resume.load_manifest(str(out)) == set(range(GEN_FRAMES)),
          f"resume of frames {B}-{2 * B - 1}: {lines[0]}, launches {third}, bit-equal {same}, "
          f"other shards untouched {kept}")
    phase("generate", f"second run: 0/{GEN_FRAMES} pending, no launch; frames {B}-{2 * B - 1} "
          f"dropped from the manifest: a third run regenerated that chunk only (launches "
          f"{third}), bit-equal, the other shards untouched")

    # The reference tree.
    ref_out = work / "reference"
    t0 = time.perf_counter()
    lines = drive_cli(["generate", "--device", dev.type, "--size", str(RES), "--batch", str(REF_B),
                       "--frames", str(REF_FRAMES), "--format", "reference", "--seed",
                       str(SEED), "--out", str(ref_out)])
    ref_s = time.perf_counter() - t0
    summary = json.loads((ref_out / "logs" / "generation_summary.json").read_text())
    stats = summary["statistics"]
    check(stats["total_frames_attempted"] == stats["successful_frames"] == REF_FRAMES
          and [f["frame_id"] for f in summary["frame_logs"]] == list(range(REF_FRAMES)),
          f"summary: {stats}")
    keys = list(schema.label_dict(0, [0.0] * 7, {}, [], 1, 1))
    n_bytes, n_points = 0, 0
    for log in summary["frame_logs"]:
        fid = log["frame_id"]
        files = [ref_out / "rgb" / f"rgb_{fid:06d}.png",
                 ref_out / "depth" / f"depth_{fid:06d}.csv",
                 ref_out / "depth" / f"depth_{fid:06d}.png",
                 ref_out / "pointcloud" / f"pointcloud_{fid:06d}.txt",
                 ref_out / "labels" / f"label_{fid:06d}.json",
                 ref_out / "labels" / f"instance_mask_{fid:06d}.npy"]
        check(all(f.is_file() for f in files), f"frame {fid}: a file is missing")
        n_bytes += sum(f.stat().st_size for f in files)
        label = json.loads(files[4].read_text())
        check(list(label) == keys and label["frame_id"] == fid, f"label {fid}: {list(label)}")
        with open(files[3], "rb") as f:
            rows = sum(1 for _ in f)
        n_points += log["pointcloud"]["points"]
        check(rows == log["pointcloud"]["points"] + 1,
              f"pointcloud {fid}: {rows} lines for {log['pointcloud']['points']} points")
        mask = np.load(files[5])
        check(mask.shape == (RES, RES) and mask.dtype == np.int32, f"mask {fid}")
    phase("generate", f"--format reference: {REF_FRAMES} frames at {RES}^2 in batches of "
          f"{REF_B}: every file of the tree ({n_bytes / 1e6:.1f} MB), label keys in the "
          f"reference order, {n_points} point-cloud rows (pointcloud_count + a header each), "
          f"masks ({RES}, {RES}) int32, the summary counts {stats['total_frames_attempted']}")
    phase("time", f"generate --format packed --heatmaps, {GEN_FRAMES} frames of {RES}^2 in "
          f"batches of {B}: {GEN_FRAMES / packed_s:.1f} frames/s incl. writes ({packed_s:.3f} s "
          f"for the command; its line: '{done_line}'); --format reference, {REF_FRAMES} frames "
          f"in batches of {REF_B}: {REF_FRAMES / ref_s:.1f} frames/s incl. writes ({ref_s:.3f} "
          f"s); filesystem {fs}; on {card}")
    return gen_launches, out


def data_dir_phase(dev, card, counters, datagen, shards, work):
    """``train-eval --data-dir`` on the packed shards (20 steps of 32 x 512^2,
    full width, focal, then 32 fresh evaluation frames), one data step on
    the card against the CPU, and the data step's timing. Returns the
    launches of ``train-eval --data-dir``."""
    import torch
    from constructionsceneposeestimation_tpu_torch.config import (Config, PipelineConfig,
                                                                  TrainConfig)
    from constructionsceneposeestimation_tpu_torch.io import reader
    from constructionsceneposeestimation_tpu_torch.models import pose_net
    from constructionsceneposeestimation_tpu_torch.ops import preprocess
    from constructionsceneposeestimation_tpu_torch.train import loop as train_loop

    # Every step's loss: the CLI prints every 50th; the step the CLI builds
    # is wrapped to keep each.
    losses, make_step = [], train_loop.make_data_train_step

    def recording(cfg, model):
        step = make_step(cfg, model)

        def run(state, seed, rgb, heatmaps):
            state, m = step(state, seed, rgb, heatmaps)
            losses.append(m["loss"])
            return state, m
        return run

    train_loop.make_data_train_step = recording
    reset(counters)
    try:
        lines = drive_cli(["train-eval", "--device", dev.type, "--size", str(RES), "--batch",
                           str(TRAIN_B), "--steps", str(TRAIN_STEPS), "--data-dir", str(shards),
                           "--eval-frames", str(TRAIN_B), "--pnp-threshold", "0.15", "--seed",
                           str(SEED)])
    finally:
        train_loop.make_data_train_step = make_step
    launches = read(counters)
    losses = torch.stack(losses).tolist() if losses else []
    phase("generate", f"train-eval --data-dir, {TRAIN_STEPS} steps of {TRAIN_B} x {RES}^2 read "
          f"from the shards, full-width HeatmapBackbone (bf16 body), focal, then {TRAIN_B} eval "
          f"frames; launches {launches}; losses {[round(v, 4) for v in losses]}")
    check(len(losses) == TRAIN_STEPS and all(math.isfinite(v) for v in losses),
          "train-eval --data-dir: a step's loss is missing or not finite")
    check(all(launches[k] == 1 for k in datagen),
          f"train-eval --data-dir: the datagen kernels must launch for the eval batch only: "
          f"{launches}")
    check(launches["peak_decode"] >= 2, "train-eval --data-dir: the peak kernel did not launch")
    steps = [ln for ln in lines if ln.startswith("step ")]
    check(len(steps) == 1 and steps[0].startswith(f"step {TRAIN_STEPS}: loss=")
          and steps[0].endswith(" img/s avg, offline shards)"), f"step lines {steps}")
    missing = [p for p in TRAIN_EVAL_LINES if not any(ln.startswith(p) for ln in lines)]
    check(not missing, f"train-eval --data-dir did not print: {missing}")

    # One data step on the card against the plain CPU path: shard rows at
    # 128^2, the same augment draws, the full-width backbone in f32.
    small = work / "small"
    drive_cli(["generate", "--device", dev.type, "--size", "128", "--batch", "4", "--frames", "4",
               "--format", "packed", "--heatmaps", "--seed", str(SEED), "--out", str(small)])
    rows = next(reader.ShardDataset(str(small)).batches(4, fields=["rgb", "heatmaps"], seed=SEED))
    scfg = Config(pipeline=PipelineConfig(render_width=128, render_height=128),
                  train=TrainConfig(batch_size=4, loss="focal"))
    d_host = preprocess.augment_draws(SEED + 1, range(4), 128, 128, "cpu")
    grads, step_loss = {}, {}
    for tag, where in (("card", dev), ("cpu", torch.device("cpu"))):
        state = train_loop.create_train_state(
            scfg, pose_net.make_model(device=where, dtype=torch.float32))
        step = train_loop.make_data_train_step(scfg, state.model)
        step.draws = lambda seed, s, b, where=where: preprocess.AugmentDraws(
            *(v.to(where) for v in d_host))
        state, m = step(state, SEED + 1, rows["rgb"], rows["heatmaps"])
        step_loss[tag] = m["loss"].item()
        grads[tag] = {n: p.grad.detach().cpu() for n, p in state.model.named_parameters()}
    loss_rel = abs(step_loss["card"] - step_loss["cpu"]) / abs(step_loss["cpu"])
    grad_rel = max((torch.linalg.norm(grads["card"][n] - g) /
                    torch.clamp_min(torch.linalg.norm(g), 1e-30)).item()
                   for n, g in grads["cpu"].items())
    phase("generate", f"one data step, card vs plain CPU path (4 shard rows of 128^2, f16 "
          f"heatmaps, f32 body): loss {step_loss['card']:.6f} vs {step_loss['cpu']:.6f}, "
          f"relative {loss_rel:.2e} (< 1e-3); worst gradient |d| / |g| {grad_rel:.2e} (< 1e-2)")
    check(loss_rel < 1e-3 and grad_rel < 1e-2, "data step: card vs CPU")
    del grads

    # The data step's time at 32 x 512^2: the wait on the reader (the next
    # batch: a shard read ahead on its thread, then the rows shuffled) and
    # the step (to the card, augment draws, forward, backward, AdamW), by
    # the host clock with the loss read each step.
    tcfg = Config(pipeline=PipelineConfig(render_width=RES, render_height=RES),
                  train=TrainConfig(batch_size=TRAIN_B, steps=32000, loss="focal"))
    state = train_loop.create_train_state(tcfg, pose_net.make_model(device=dev))
    step = train_loop.make_data_train_step(tcfg, state.model)
    batches = reader.ShardDataset(str(shards)).batches(TRAIN_B, fields=["rgb", "heatmaps"],
                                                       seed=SEED, epochs=4)
    wait = total = 0.0
    for i in range(11):
        t0 = time.perf_counter()
        b = next(batches)
        t1 = time.perf_counter()
        state, m = step(state, SEED + 1, b["rgb"], b["heatmaps"])
        check(math.isfinite(m["loss"].item()), "timed data step: loss not finite")
        if i >= 3:  # 3 steps of warm-up
            wait += t1 - t0
            total += time.perf_counter() - t0
    batches.close()
    ms = total * 1000.0 / 8
    phase("time", f"data step {TRAIN_B} x {RES}^2 from the shards (read, to the card, augment, "
          f"full-width forward and backward, focal, AdamW): {ms:.3f} ms a step = "
          f"{TRAIN_B * 1000.0 / ms:.1f} img/s (mean of 8 after 3 of warm-up, host clock); "
          f"waiting on the reader {100.0 * wait / total:.1f}% of it; on {card}")
    return launches


def finite_step_losses(lines, steps, tag):
    """The losses of the ``step N: loss=...`` lines, one a step, all finite."""
    losses = [float(ln.split("loss=")[1].split()[0]) for ln in lines if ln.startswith("step ")]
    check(len(losses) == steps and all(math.isfinite(v) for v in losses),
          f"{tag}: {len(losses)} step lines, losses {losses}")
    return losses


def crop_heatmap_inputs(dev, per_part):
    """The heatmap kernel's arguments as one crop step gives them: a crop
    step's batch (32 x 512^2) cut into the dumper's crops (crop 128, stride
    4) or the crane's per-part crops (crop 192, stride 2)."""
    from constructionsceneposeestimation_tpu_torch.config import (Config, PipelineConfig,
                                                                  TrainConfig)
    from constructionsceneposeestimation_tpu_torch.ops import heatmap as hm
    from constructionsceneposeestimation_tpu_torch.parallel.pipeline import Pipeline
    from constructionsceneposeestimation_tpu_torch.train import crop_loop

    cfg = Config(pipeline=PipelineConfig(render_width=RES, render_height=RES),
                 train=TrainConfig(batch_size=TRAIN_B))
    cls, size, stride = ("crane", 192, 2) if per_part else ("dumper", 128, 4)
    model = crop_loop.make_crop_model(cls, roster=Pipeline(cfg, device="cpu").roster,
                                      output_stride=stride, device=dev)
    step = crop_loop.CropTrainStep(cfg, model, Pipeline(cfg, device=dev), cls, size,
                                   per_part=per_part)
    seen, plain_heatmaps = [], hm.heatmaps
    hm.heatmaps = lambda *a: seen.append(a) or plain_heatmaps(*a)
    try:
        step.generate(SEED + 5, range(TRAIN_B))
    finally:
        hm.heatmaps = plain_heatmaps
    check(len(seen) == 1, f"a crop step called the heatmaps {len(seen)} times")
    return seen[0]


def card_vs_cpu_two_stage(dev):
    """One crop step, one detector step and the infer function on the card
    against the plain CPU path: 4 ladder frames of 128^2 (two show the
    dumper, whose crops carry the loss), full-width nets in
    f32 (the same seeded weights), the same crop and augment draws."""
    import torch
    from constructionsceneposeestimation_tpu_torch import cli
    from constructionsceneposeestimation_tpu_torch.config import (Config, PipelineConfig,
                                                                  TrainConfig)
    from constructionsceneposeestimation_tpu_torch.ops import preprocess
    from constructionsceneposeestimation_tpu_torch.parallel.pipeline import FrameBatch, Pipeline
    from constructionsceneposeestimation_tpu_torch.train import crop_loop, detect_loop
    from constructionsceneposeestimation_tpu_torch.train import loop as train_loop

    cfg = Config(pipeline=PipelineConfig(render_width=128, render_height=128),
                 train=TrainConfig(batch_size=4, loss="focal"))
    host_pipe = Pipeline(cfg, device="cpu")
    ids = range(4, 8)  # ladder views 4 and 5 show the dumper at 128^2
    g_host = host_pipe.make_generate_fn(ladder=True, include_heatmaps=False)(SEED, ids)
    crops_host = crop_loop.crop_draws(SEED, ids, 1, 128, "cpu")
    aug_host = preprocess.augment_draws(SEED, ids, 128, 128, "cpu")
    f32 = dict(dtype=torch.float32)
    out = {}
    for tag, where in (("card", dev), ("cpu", torch.device("cpu"))):
        batch = FrameBatch(*(v.to(where) for v in g_host))
        to = lambda x: type(x)(*(v.to(where) for v in x))
        # One crop step (the dumper, crop 128, stride 4).
        model = crop_loop.make_crop_model("dumper", device=where, **f32)
        state = crop_loop.create_crop_train_state(cfg, model)
        step = crop_loop.CropTrainStep(cfg, model, Pipeline(cfg, device=where), "dumper", 128)
        images, targets, w = step.crops(batch, crop_loop.CropDraws(
            crops_host.jitter.to(where), to(crops_host.augment)))
        check(float(w.sum()) > 0, "card vs CPU crop step: no dumper in view")
        crop_loss = step.forward_backward(state, images, targets, w).item()
        crop_grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
        # One detector step (stride 2).
        det = detect_loop.make_detect_model(output_stride=2, device=where, **f32)
        dstate = train_loop.create_train_state(cfg, det)
        det_loss = detect_loop.DetectBatchStep(cfg, det, host_pipe.roster).forward_backward(
            dstate, batch.rgb, batch, to(aug_host)).item()
        det_grads = {n: p.grad.detach().cpu() for n, p in det.named_parameters()}
        # The infer function on the same nets (the crane's per-part crops at
        # stride 2, crop 192).
        crane = crop_loop.make_crop_model("crane", roster=host_pipe.roster, output_stride=2,
                                          device=where, **f32)
        infer = cli.make_infer_fn(det.eval(), model.eval(), 128, host_pipe.intr,
                                  host_pipe.roster, 4, crane.eval(), 192, 0.3)
        o = {k: v.cpu() for k, v in infer(batch.rgb, batch.camera_pose7).items()}
        out[tag] = (crop_loss, crop_grads, det_loss, det_grads, o)
    rel = lambda a, b: abs(a - b) / abs(b)
    worst = lambda ga, gb: max((torch.linalg.norm(ga[n] - g) / torch.clamp_min(
        torch.linalg.norm(g), 1e-30)).item() for n, g in gb.items())
    (cl_d, cg_d, dl_d, dg_d, o_d), (cl_c, cg_c, dl_c, dg_c, o_c) = out["card"], out["cpu"]
    kept_d, kept_c = o_d["scores"] >= 0.3, o_c["scores"] >= 0.3
    box_err = torch.abs(o_d["boxes"] - o_c["boxes"]).max().item()
    score_err = torch.abs(o_d["scores"] - o_c["scores"]).max().item()
    phase("two-stage", f"card vs plain CPU path (4 x 128^2, f32 body): crop step loss "
          f"{cl_d:.6f} vs {cl_c:.6f}, relative {rel(cl_d, cl_c):.2e} (< 1e-3), worst gradient "
          f"|d| / |g| {worst(cg_d, cg_c):.2e} (< 1e-2); detector step loss {dl_d:.6f} vs "
          f"{dl_c:.6f}, relative {rel(dl_d, dl_c):.2e}, worst gradient {worst(dg_d, dg_c):.2e}; "
          f"infer boxes max |d| {box_err:.2e} px, scores {score_err:.2e} (< 1e-3), kept "
          f"{int(kept_d.sum())} vs {int(kept_c.sum())} detections, the same: "
          f"{bool(torch.equal(kept_d, kept_c))}")
    check(rel(cl_d, cl_c) < 1e-3 and worst(cg_d, cg_c) < 1e-2, "crop step: card vs CPU")
    check(rel(dl_d, dl_c) < 1e-3 and worst(dg_d, dg_c) < 1e-2, "detector step: card vs CPU")
    check(box_err < 1e-3 and score_err < 1e-3 and torch.equal(kept_d, kept_c),
          "infer function: card vs CPU")


def step_timing(card, step, state, parts, tag):
    """ms a step (CUDA events around generate + crops + train, 5 steps after
    3 of warm-up): min and mean, with img/s."""
    import torch
    frame = [0]

    def fids():
        frame[0] += TRAIN_B
        return range(frame[0] - TRAIN_B, frame[0])

    for _ in range(3):
        state, _ = step(state, SEED + 1, fids())
    steps_ms = []
    for _ in range(5):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        state, m = step(state, SEED + 1, fids())
        e1.record()
        torch.cuda.synchronize()
        check(math.isfinite(m["loss"].item()), f"{tag}: timed step's loss not finite")
        steps_ms.append(e0.elapsed_time(e1))
    best, mean = min(steps_ms), sum(steps_ms) / len(steps_ms)
    phase("time", f"{tag}, {TRAIN_B} x {RES}^2 frames a step{parts}: steps "
          f"{[round(x, 3) for x in steps_ms]} ms; min {best:.3f} ms = "
          f"{TRAIN_B * 1000.0 / best:.1f} img/s, mean {mean:.3f} ms = "
          f"{TRAIN_B * 1000.0 / mean:.1f} img/s on {card}")
    return state


def two_stage_timing(dev, card):
    """The crop, crane and detector steps and the infer function timed on
    the card at the runs of record's widths."""
    import torch
    from constructionsceneposeestimation_tpu_torch import cli
    from constructionsceneposeestimation_tpu_torch.config import (Config, PipelineConfig,
                                                                  SceneConfig, TrainConfig)
    from constructionsceneposeestimation_tpu_torch.parallel.pipeline import Pipeline
    from constructionsceneposeestimation_tpu_torch.train import crop_loop, detect_loop
    from constructionsceneposeestimation_tpu_torch.train import loop as train_loop

    cfg = Config(pipeline=PipelineConfig(render_width=RES, render_height=RES),
                 train=TrainConfig(batch_size=TRAIN_B, steps=8000, loss="focal"))
    pipe = Pipeline(cfg, device=dev)
    crop_model = crop_loop.make_crop_model("dumper", device=dev)
    step_timing(card, crop_loop.CropTrainStep(cfg, crop_model, pipe, "dumper", 128),
                crop_loop.create_crop_train_state(cfg, crop_model), ", dumper crops of 128^2",
                "crop step (generate, crops, targets, augment, full-width forward and backward, "
                "focal, AdamW)")
    crane = crop_loop.make_crop_model("crane", roster=pipe.roster, output_stride=2, device=dev)
    step_timing(card, crop_loop.CropTrainStep(cfg, crane, pipe, "crane", 192, per_part=True),
                crop_loop.create_crop_train_state(cfg, crane),
                f", {4 * TRAIN_B} per-part crane crops of 192^2 at stride 2", "crane crop step")
    dcfg = Config(scene=SceneConfig(n_dumpers=2, n_humans=3),
                  pipeline=PipelineConfig(render_width=RES, render_height=RES),
                  train=TrainConfig(batch_size=TRAIN_B, steps=8000, loss="focal"))
    det = detect_loop.make_detect_model(output_stride=2, device=dev)
    step_timing(card, detect_loop.make_detect_train_step(dcfg, det, Pipeline(dcfg, device=dev)),
                train_loop.create_train_state(dcfg, det), ", stride-2 maps of 256^2, "
                "2 dumpers, 3 workers", "detector step (generate, augment, full-width forward "
                "and backward, targets, focal + L1, AdamW)")
    crane.eval()
    infer = cli.make_infer_fn(det.eval(), crop_model.eval(), 128, pipe.intr, pipe.roster, 4,
                              crane, 192, 0.3)
    batch = pipe.make_generate_fn(include_heatmaps=False)(SEED + 2000, range(INFER_B))
    ms = cuda_ms(lambda: infer(batch.rgb, batch.camera_pose7), iters=5, warmup=2)
    phase("time", f"infer function, {INFER_B} x {RES}^2 (detector, 4 dumper crops and 4 crane "
          f"part crops a frame, DARK, ground and crane solves): {ms:.3f} ms = "
          f"{INFER_B * 1000.0 / ms:.1f} frames/s on {card}")


def two_stage_phase(dev, card, counters, work):
    """``train-crop`` (dumper, crane per part), ``train-detect`` with both
    crop checkpoints and ``infer`` through the CLI at the runs of record's
    widths, then the heatmap kernel at the crop shapes and the card against
    the CPU. Returns the launches per path and the heatmap kernel's times
    at the crop shapes."""
    import json as json_mod
    import torch
    from constructionsceneposeestimation_tpu_torch.ops import heatmap as hm

    base = ["--device", dev.type, "--size", str(RES), "--batch", str(TRAIN_B), "--steps",
            str(TRAIN_STEPS), "--inner", "1", "--seed", str(SEED)]
    ck = {k: str(work / k) for k in ("dumper", "crane", "det")}
    launches = {}
    runs = {"dumper": [*CROP_ARGS], "crane": [*CRANE_ARGS]}
    for name, extra in runs.items():
        reset(counters)
        lines = drive_cli(["train-crop", *base, *extra, "--ckpt-dir", ck[name]])
        torch.cuda.synchronize()
        launches[name] = read(counters)
        losses = finite_step_losses(lines, TRAIN_STEPS, f"train-crop {name}")
        phase("two-stage", f"train-crop {' '.join(extra)}: {TRAIN_STEPS} steps of {TRAIN_B} x "
              f"{RES}^2 frames, full-width HeatmapBackbone (bf16 body), focal, then 64 eval "
              f"frames; launches {launches[name]}; losses {[round(v, 4) for v in losses]}")
        check(all(launches[name][k] == TRAIN_STEPS + 1 for k in ("pixel_sweep", "rgb_epilogue"))
              and launches[name]["heatmap_targets"] == TRAIN_STEPS
              and launches[name]["peak_decode"] == 0,
              f"train-crop {name}: want the sweep and RGB once a step and once for the eval "
              f"batch, the heatmaps once a step: {launches[name]}")
        heads = [f"saved checkpoint at step {TRAIN_STEPS} -> {ck[name]}",
                 f"{'crane' if name == 'crane' else 'dumper'} crop-stage 6DoF: ADD mean "]
        if name == "crane":
            heads.append("  per-part err split (t/rot): [")
        missing = [h for h in heads if not any(ln.startswith(h) for ln in lines)]
        check(not missing, f"train-crop {name} did not print: {missing}")
    reset(counters)
    lines = drive_cli(["train-detect", *base, *DETECT_ARGS, "--crop-ckpt", ck["dumper"],
                       "--crane-crop-ckpt", ck["crane"], "--eval-frames", "64", "--ckpt-dir",
                       ck["det"]])
    torch.cuda.synchronize()
    launches["detect"] = read(counters)
    losses = finite_step_losses(lines, TRAIN_STEPS, "train-detect")
    phase("two-stage", f"train-detect {' '.join(DETECT_ARGS)}: {TRAIN_STEPS} steps of "
          f"{TRAIN_B} x {RES}^2, 64 eval frames; launches {launches['detect']}; losses "
          f"{[round(v, 4) for v in losses]}")
    check(all(launches["detect"][k] == TRAIN_STEPS + 1 for k in ("pixel_sweep", "rgb_epilogue"))
          and launches["detect"]["heatmap_targets"] == 0
          and launches["detect"]["peak_decode"] == 0,
          f"train-detect: want the sweep and RGB once a step and once for the eval batch: "
          f"{launches['detect']}")
    heads = ["detector P/R @IoU0.5: ", "  crane parts P/R: [", "  miss split ",
             "FULL two-stage dumper 6DoF (detector boxes): ",
             "FULL two-stage multi-dumper 6DoF (detector boxes, 2 instances): ",
             "FULL two-stage crane 6DoF (detector part boxes): "]
    missing = [h for h in heads if not any(ln.startswith(h) for ln in lines)]
    check(not missing, f"train-detect did not print: {missing}")
    check(any(" mAP@0.5 " in ln for ln in lines), "train-detect did not print mAP")

    poses = work / "poses.jsonl"
    reset(counters)
    t0 = time.perf_counter()
    lines = drive_cli(["infer", "--device", dev.type, "--size", str(RES), "--frames",
                       str(INFER_FRAMES), "--batch", str(INFER_B), "--det-ckpt", ck["det"],
                       "--det-stride", "2", "--crop-ckpt", ck["dumper"], "--crane-crop-ckpt",
                       ck["crane"], "--crane-stride", "2", "--crane-crop", "192", "--track",
                       "--seed", str(SEED), "--out", str(poses)])
    torch.cuda.synchronize()
    infer_s = time.perf_counter() - t0
    launches["infer"] = read(counters)
    records = [json_mod.loads(ln) for ln in poses.read_text().splitlines()]
    n_det = sum(len(r["detections"]) for r in records)
    check(len(records) == INFER_FRAMES
          and [r["frame_id"] for r in records] == list(range(INFER_FRAMES))
          and all(list(r) == ["frame_id", "camera_pose7", "detections"] for r in records)
          and lines == [f"wrote {INFER_FRAMES} frame records ({n_det} detections) -> {poses}"],
          f"infer wrote {len(records)} records; printed {lines}")
    heads = {"crane": ["class", "pose_accepted", "reproj_rmse_px", "parts"],
             "dumper": ["class", "score", "bbox2d", "pose_accepted", "R_cam", "t_cam",
                        "reproj_rmse_px", "track_id"]}
    for d in (d for r in records for d in r["detections"]):
        want = heads.get(d["class"], ["class", "score", "bbox2d", "track_id"])
        check(list(d)[:len(want)] == want and "track_id" in d,
              f"infer record keys {list(d)} for {d['class']}")
    kinds = sorted({d["class"] for r in records for d in r["detections"]})
    phase("two-stage", f"infer --det-stride 2 --crane-stride 2 --crane-crop 192 --track, "
          f"{INFER_FRAMES} frames in batches of {INFER_B}: {len(records)} records, {n_det} "
          f"detections ({', '.join(kinds) or 'none'}), keys in the JAX order; launches "
          f"{launches['infer']}; the command in {infer_s:.3f} s (host clock, the checkpoints' "
          f"loads included)")
    check(all(launches["infer"][k] == INFER_FRAMES // INFER_B
              for k in ("pixel_sweep", "rgb_epilogue"))
          and launches["infer"]["heatmap_targets"] == 0 and launches["infer"]["peak_decode"] == 0,
          f"infer: want the sweep and RGB once a batch: {launches['infer']}")

    # The heatmap kernel at the crop shapes the two crop steps give it.
    crop_hm = []
    for per_part in (False, True):
        args = crop_heatmap_inputs(dev, per_part)
        uv, ch, vis, C, h, w, sigma, stride = args
        shape = (uv.shape[0], C, h, w)
        want = ((TRAIN_B, 10, 32, 32), 4.0) if not per_part else ((4 * TRAIN_B, 28, 96, 96), 2.0)
        check((shape, stride) == want and sigma == 1.5, f"crop targets {shape} stride {stride}")
        err = torch.abs(hm.heatmap_cuda(*args) - hm.render_heatmaps(*args)).max().item()
        torch.cuda.synchronize()
        out_bytes = uv.shape[0] * C * h * w * 4
        nbytes = out_bytes + uv.numel() * 4 + ch.numel() * 4 + vis.numel()
        r = {"shape": list(shape), "stride": stride, "max_abs_err": err,
             "ms": device_ms(lambda: hm.heatmap_cuda(*args), "heatmap_kernel", iters=20),
             "call_ms": cuda_ms(lambda: hm.heatmap_cuda(*args), iters=20),
             "plain_ms": cuda_ms(lambda: hm.render_heatmaps(*args), iters=3),
             "bound_ms": bound(nbytes, int(vis.sum()) * h * w * HEATMAP_KPT_OPS)[0],
             "visible": int(vis.sum())}
        crop_hm.append(r)
        phase("heatmap", f"crop targets {tuple(shape)} stride {stride} sigma {sigma}: max |d| "
              f"{err:.2e} (< 2e-4); {r['visible']} visible keypoints of {vis.numel()}; kernel "
              f"{r['ms']:.4f} ms (call {r['call_ms']:.4f} ms), plain {r['plain_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms (bytes over 3.35 TB/s) on {card}")
        check(err < 2e-4, f"heatmap kernel disagrees at the crop shape {shape}")
    card_vs_cpu_two_stage(dev)
    two_stage_timing(dev, card)
    total = {k: launches["dumper"][k] + launches["crane"][k] for k in launches["dumper"]}
    return {"train_crop": total, "train_detect": launches["detect"],
            "infer": launches["infer"]}, crop_hm


def consume(fb):
    """A device scalar that reads every field of a ``FrameBatch``."""
    import torch
    return sum(v.float().sum() if v.dtype != torch.float32
               else torch.nan_to_num(v, posinf=0.0).sum() for v in fb)


def region_ms(fn, start, n=B):
    """CUDA events around ``fn(SEED, frames start..start+n)`` consumed."""
    import torch
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    total = consume(fn(SEED, range(start, start + n)))
    e1.record()
    torch.cuda.synchronize()
    check(bool(torch.isfinite(total)), "consumed total not finite")
    return e0.elapsed_time(e1)


def wrapped_deg(a):
    """Angles in degrees wrapped to [-180, 180)."""
    return (a + 180.0) % 360.0 - 180.0


def sequence_phase(dev, card, counters, datagen, work, ck):
    """``generate --sequence-len 30`` (packed, heatmaps; 2 clips), its clips'
    coherence, ``infer --sequence-len 30 --track`` on the two-stage
    checkpoints ``ck``, ``seq-eval`` on its records, and sequence generate
    beside i.i.d. generate. Returns the launches per path."""
    import numpy as np
    import torch
    from constructionsceneposeestimation_tpu_torch.config import Config, PipelineConfig
    from constructionsceneposeestimation_tpu_torch.eval import sequence_metrics
    from constructionsceneposeestimation_tpu_torch.parallel.pipeline import Pipeline

    launches = {}
    out = work / "clips"
    chunks = [list(range(lo, min(lo + SEQ_B, SEQ_FRAMES))) for lo in range(0, SEQ_FRAMES, SEQ_B)]
    reset(counters)
    lines = drive_cli(["generate", "--device", dev.type, "--size", str(RES), "--batch", str(SEQ_B),
                       "--frames", str(SEQ_FRAMES), "--sequence-len", str(SEQ_LEN), "--format",
                       "packed", "--heatmaps", "--seed", str(SEED), "--out", str(out)])
    launches["generate_sequence"] = read(counters)
    check(lines[0] == f"generating {SEQ_FRAMES}/{SEQ_FRAMES} frames (resume skipped 0, "
          "format=packed)" and lines[-1].startswith(f"done: {SEQ_FRAMES} frames in "),
          f"generate --sequence-len printed {lines}")
    check(all(launches["generate_sequence"][k] == len(chunks) for k in datagen)
          and launches["generate_sequence"]["peak_decode"] == 0,
          f"generate --sequence-len: launches {launches['generate_sequence']}, want "
          f"{len(chunks)} a kernel")
    cfg = Config(pipeline=PipelineConfig(render_width=RES, render_height=RES, batch_size=SEQ_B,
                                         max_iterations=SEQ_FRAMES, seed=SEED))
    pipe = Pipeline(cfg, device=dev)
    gen = pipe.make_sequence_fn(SEQ_LEN)
    for c in chunks:
        ids = c + [c[-1]] * (SEQ_B - len(c))
        with torch.no_grad():
            want, again = host_fields(gen(SEED, ids)), host_fields(gen(SEED, ids))
        got = shard_arrays(out / f"shard_{c[0]:06d}.npz")
        check(got.keys() == want.keys() and all(np.array_equal(got[k], v) and
                                                np.array_equal(again[k], v)
                                                for k, v in want.items()),
              f"clip shard {c[0]}: not bit-equal to make_sequence_fn, or a repeat differs")
    phase("sequence", f"generate --sequence-len {SEQ_LEN} --format packed --heatmaps: "
          f"{SEQ_FRAMES} frames ({SEQ_FRAMES // SEQ_LEN} clips) in batches of {SEQ_B}; launches "
          f"{launches['generate_sequence']}; every shard bit-equal to make_sequence_fn on the "
          f"same padded ids, and to a repeat with the same seed")

    # Within a clip: the statics and the light bit-equal frame to frame; the
    # camera and the crane's joints move, a frame at most 1.5 / (L - 1) of
    # their move over the clip (smoothstep's steepest slope), and over the
    # clip at most 30 deg of orbit, 4 m of distance and 1 m of height.
    inp = pipe.sample_sequence_inputs(SEED, range(SEQ_FRAMES), SEQ_LEN)
    h0, h1 = pipe.roster.human_slice
    statics = np.ones(pipe.roster.num_instances, bool)
    statics[:4] = False  # the crane's parts
    statics[h0:h1] = False
    slope = 1.5 / (SEQ_LEN - 1)
    worst = {"orbit": 0.0, "distance": 0.0, "height": 0.0, "joints": 0.0}
    for clip in range(SEQ_FRAMES // SEQ_LEN):
        rows = list(range(clip * SEQ_LEN, (clip + 1) * SEQ_LEN))
        pos = inp.pose.positions[rows][:, statics]
        yaw = inp.pose.yaw_deg[rows][:, statics]
        lit_same = all(bool((getattr(inp.lighting, f)[rows] == getattr(inp.lighting, f)[rows[0]])
                            .all()) for f in inp.lighting._fields)
        check(bool((pos == pos[0]).all()) and bool((yaw == yaw[0]).all()) and lit_same,
              f"clip {clip}: a static pose or the light changed within the clip")
        cam = inp.cam_pos[rows].double().cpu().numpy()
        ang = np.degrees(np.arctan2(cam[:, 1], cam[:, 0]))
        r, h = np.linalg.norm(cam[:, :2], axis=1), cam[:, 2]
        moves = {"orbit": (wrapped_deg(np.diff(ang)), wrapped_deg(ang[-1] - ang[0]), 30.0),
                 "distance": (np.diff(r), r[-1] - r[0], 4.0),
                 "height": (np.diff(h), h[-1] - h[0], 1.0)}
        j = inp.pose.crane_joints[rows].double().cpu().numpy()
        dj = np.diff(j, axis=0)
        dj[:, 0] = wrapped_deg(dj[:, 0])
        total_j = j[-1] - j[0]
        total_j[0] = wrapped_deg(total_j[0])
        check(np.abs(dj).sum() > 0 and np.abs(np.diff(cam, axis=0)).sum() > 0,
              f"clip {clip}: the camera or the crane does not move")
        check(bool((np.abs(dj) <= np.abs(total_j) * slope + 1e-4).all()),
              f"clip {clip}: a crane joint moved {np.abs(dj).max(0)} in a frame of a clip move "
              f"of {total_j}")
        worst["joints"] = max(worst["joints"], float((np.abs(dj) / np.maximum(
            np.abs(total_j), 1e-9)).max()))
        for k, (step, total, lim) in moves.items():
            check(abs(total) <= lim + 1e-3 and bool((np.abs(step) <= lim * slope + 1e-3).all()),
                  f"clip {clip}: {k} moved {total} over the clip, {np.abs(step).max()} in a frame")
            worst[k] = max(worst[k], float(np.abs(step).max()))
    phase("sequence", f"within each clip the static poses and the light are bit-equal frame to "
          f"frame; largest move a frame: orbit {worst['orbit']:.4f} deg (<= "
          f"{30 * slope:.4f}), distance {worst['distance']:.4f} m (<= {4 * slope:.4f}), height "
          f"{worst['height']:.4f} m (<= {slope:.4f}), crane joints {worst['joints']:.4f} of "
          f"their clip move (<= {slope:.4f})")

    # infer on the clips with the two-stage checkpoints, then seq-eval.
    poses = work / "clips.jsonl"
    reset(counters)
    t0 = time.perf_counter()
    lines = drive_cli(["infer", "--device", dev.type, "--size", str(RES), "--frames",
                       str(SEQ_FRAMES), "--batch", str(INFER_B), "--det-ckpt", ck["det"],
                       "--crop-ckpt", ck["dumper"], "--crane-crop-ckpt", ck["crane"], *INFER_ARGS,
                       "--sequence-len", str(SEQ_LEN), "--track", "--seed", str(SEED), "--out",
                       str(poses)])
    torch.cuda.synchronize()
    infer_s = time.perf_counter() - t0
    launches["infer_sequence"] = read(counters)
    records = sequence_metrics.load_records(str(poses))
    n_batches = -(-SEQ_FRAMES // INFER_B)
    check([r["frame_id"] for r in records] == list(range(SEQ_FRAMES))
          and len(lines) == 1 and lines[0].startswith(f"wrote {SEQ_FRAMES} frame records"),
          f"infer --sequence-len: {len(records)} records, printed {lines}")
    check(all(launches["infer_sequence"][k] == n_batches for k in ("pixel_sweep", "rgb_epilogue"))
          and launches["infer_sequence"]["heatmap_targets"] == 0
          and launches["infer_sequence"]["peak_decode"] == 0,
          f"infer --sequence-len: want the sweep and RGB once a batch: "
          f"{launches['infer_sequence']}")
    lines = drive_cli(["seq-eval", "--poses", str(poses), "--sequence-len", str(SEQ_LEN), "--fps",
                       "30"])
    m = sequence_metrics.sequence_metrics(records, SEQ_LEN, fps=30.0)
    heads = [f"sequence eval ({SEQ_FRAMES // SEQ_LEN} clips x {SEQ_LEN} frames, {SEQ_FRAMES} "
             "frames):", "  id stability:       ", "  pose track rate:    ",
             "  mean |dt| world:    ", "  mean |dR| world:    "]
    heads += ["  id switch rate:     "] * ("id_switch_rate" in m) + ["  implied speed:      "]
    check(len(lines) == len(heads) and all(ln.startswith(hd) for ln, hd in zip(lines, heads)),
          f"seq-eval printed {lines}")
    # Each metric is defined where its denominator is not empty: the rates
    # always; the deltas and the speed when an accepted pose was matched in
    # the next frame; the spread across clips with two clips, the worst
    # clip with one, that hold detections before their last frame.
    moved = m["pose_track_rate"] > 0
    by_id = {r["frame_id"]: r for r in records}
    clips_seen = sum(any(by_id[f]["detections"] for f in range(g, g + SEQ_LEN - 1))
                     for g in range(0, SEQ_FRAMES, SEQ_LEN))
    defined = {"id_stability": True, "pose_track_rate": True, "mean_t_delta_m": moved,
               "mean_r_delta_deg": moved,
               "p95_t_delta_m": moved, "mean_speed_mps": moved,
               "id_stability_std": clips_seen > 1, "id_stability_min_clip": clips_seen > 0}
    check(all(math.isfinite(m[k]) == d for k, d in defined.items()), f"seq-eval metrics {m}")
    n_det = sum(len(r["detections"]) for r in records)
    phase("sequence", f"infer {' '.join(INFER_ARGS)} --sequence-len {SEQ_LEN} --track, "
          f"{SEQ_FRAMES} frames in batches of {INFER_B}: {n_det} detections; launches "
          f"{launches['infer_sequence']}; the command in {infer_s:.3f} s (host clock, "
          f"checkpoint loads included); seq-eval printed every line: "
          + " | ".join(ln.strip() for ln in lines))

    # Sequence generate beside i.i.d. generate: 64 x 512^2 with heatmaps,
    # CUDA events, in turns (i.i.d., clips, clips, i.i.d.) after a warm-up.
    tpipe = Pipeline(Config(pipeline=PipelineConfig(render_width=RES, render_height=RES)),
                     device=dev)
    fns = {"iid": tpipe.make_generate_fn(), "clips": tpipe.make_sequence_fn(SEQ_LEN)}
    times = {k: [] for k in fns}
    for k in fns:
        region_ms(fns[k], 0)
    for r, k in enumerate(("iid", "clips", "clips", "iid") * 2):
        times[k].append(region_ms(fns[k], B * (r + 2)))
    best = {k: min(v) for k, v in times.items()}
    phase("time", f"generate {B} x {RES}^2 with heatmaps, in turns: i.i.d. {times['iid']} ms, "
          f"clips of {SEQ_LEN} {times['clips']} ms; min {best['iid']:.3f} ms = "
          f"{B * 1000.0 / best['iid']:.1f} frames/s i.i.d., {best['clips']:.3f} ms = "
          f"{B * 1000.0 / best['clips']:.1f} frames/s clips, on {card}")
    return launches


def events_device_ms(fn, iters=20):
    """(ms a call, host ms to issue them all): CUDA events around ``iters``
    calls of ``fn`` queued behind ~20 ms of ``torch.cuda._sleep``, so that
    the card runs the calls back to back however long the host takes to
    issue each (``cuda_ms`` times that host work when it exceeds the
    kernel's); the issue must end well within the sleep."""
    import torch
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(40_000_000)
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    issue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    check(issue_ms < 10.0, f"the host took {issue_ms:.3f} ms to issue {iters} calls: the events "
          f"would time the host")
    return start.elapsed_time(end) / iters, issue_ms


def mesh_terms_bytes(tab, m, n):
    """Bytes csrc/meshterms.cu must move for ``n`` frames: its stores
    (``m``'s terms, spheres, lo and hi) and each element it reads, once.
    From ``tab`` (``MeshCaster.tables``): the block rows; the face rows the
    blocks start; the template vertices their rigid faces name; the skin's
    v_loc, weights and bone_ids rows their skinned faces name; the bone_rows
    rows of the skinned blocks; and, each frame, the origin, the rigid
    blocks' instances' inst_rot and inst_pos and those bone rows' prim_rot
    and prim_pos. Unread elements (other rows, a rigid vertex's zero skin)
    count nothing."""
    import numpy as np
    blocks, faces = tab["blocks"], tab["faces"]
    T = m.spheres.shape[3]
    rows = blocks[:, 1:2] + np.arange(T)
    rigid = blocks[:, 2] < 0
    rigid_v, skin_v = (np.unique(faces[rows[sel]]) for sel in (rigid, ~rigid))
    skins = np.unique(blocks[~rigid, 2])
    n_bones = tab["bone_rows"].shape[1]
    poses = len(np.unique(blocks[rigid, 0])) + len(np.unique(tab["bone_rows"][skins]))
    reads = (blocks.size + 3 * len(np.unique(rows)) + 3 * len(rigid_v)
             + (6 + 2 + 2) * len(skin_v) + n_bones * len(skins) + n * (3 + 12 * poses))
    return sum(t.numel() * t.element_size() for t in m[:4]) + 4 * reads


def mesh_terms_report(card, hifi, w, o, rays, m):
    """[mesh-terms]: csrc/meshterms.cu, whose terms ``m`` (``hifi.mesh.
    mesh_terms(w, o)``) the [mesh] checks run on, against ``plain_mesh_terms``
    on the same world and origin: each part within MESH_TERMS_UNITS units
    of ``meshcast.terms_gap``, cr = 0 and radius -1 on the same slots bit
    for bit, two calls bit-equal; the mesh sweep kernel over each on
    ``rays`` ((name, (B, N, 3)) pairs: the pixels at ``sweep_agreement``'s
    bars, the segments at ``segment_agreement``'s); the kernel's device
    time by the profiler and by CUDA events beside its bound, its
    wrapper's call, the plain version's time and launches a call;
    ``HifiCaster.frame_world``'s host issue and CUDA-event times and
    ``MeshCaster.packed`` with its terms built in the call, with the
    kernel's terms and with the plain version's, in turns. Returns the
    kernels line's numbers."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from constructionsceneposeestimation_tpu_torch.render import meshcast
    from constructionsceneposeestimation_tpu_torch.utils import kernels
    mesh = hifi.mesh
    report = kernels.ptxas_report("meshterms.cu")
    phase("mesh-terms", f"csrc/meshterms.cu, registers and spill bytes (ptxas): {report}")
    check(set(report) == {"mesh_terms_kernel"}
          and report["mesh_terms_kernel"]["spill_bytes"] == 0,
          f"mesh terms: the kernel is missing or spills: {report}")
    tables = mesh._on(o.device)["tables"]
    pose = [w[k].contiguous() for k in ("inst_rot", "inst_pos", "prim_rot", "prim_pos")]
    k_fn = lambda: meshcast.mesh_terms_cuda(tables, *pose, o, mesh.tri_block)
    p_fn = lambda: meshcast.plain_mesh_terms(mesh, w, o)
    ref, again = p_fn(), k_fn()
    gap = meshcast.terms_gap(m, ref, mesh.corners(w))
    flat, want = ((x.terms[:, :, :3] == 0).all(2) for x in (m, ref))
    radius, want_r = m.spheres[:, :, 3], ref.spheres[:, :, 3]
    exact = (torch.equal(flat, want) and torch.equal(radius[want], want_r[want])
             and bool((radius[~want] > 0).all()))
    same = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(m[:4], again[:4]))
    err = max(float((a - b).abs().max()) for a, b in zip(m[:4], ref[:4]))
    n, nb, T = m.spheres.shape[0], m.spheres.shape[1], m.spheres.shape[3]
    phase("mesh-terms", f"kernel against plain_mesh_terms, {n} frames x {nb} blocks x {T} slots: "
          f"terms_gap (units of 2^-23 x the corners' scale x the part's derivative) "
          f"{ {k: round(v, 3) for k, v in gap.items()} } (<= {MESH_TERMS_UNITS}); cr = 0 and "
          f"radius -1 on the same {int(want.sum())} slots bit for bit, every other radius > 0: "
          f"{exact}; two calls bit-equal: {same}; max |d| {err:.3e}")
    check(max(gap.values()) <= MESH_TERMS_UNITS and exact and same,
          "mesh terms: the kernel disagrees with plain_mesh_terms")
    phase("mesh-terms", "the mesh sweep kernel over the kernel's terms against the same kernel "
          "over plain_mesh_terms', pixels then segments:")
    codes = mesh._on(o.device)["codes"]
    for name, d in rays:
        lay = mesh.layout(d.shape[1])
        k, p = (meshcast.mesh_sweep_cuda(x.terms, x.lo, x.hi, x.spheres, codes, o, d, lay)
                for x in (m, ref))
        (sweep_agreement if name == "pixels" else segment_agreement)("mesh-terms", k, p)
    del ref, again, k, p

    ms = device_ms(k_fn, "mesh_terms_kernel")
    events_ms, issue_ms = events_device_ms(k_fn)
    call_ms, plain_ms = cuda_ms(k_fn, iters=20), cuda_ms(p_fn, iters=5)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        p_fn()
        torch.cuda.synchronize()
    plain_launches = sum(e.count for e in prof.key_averages()
                         if e.device_type == torch.autograd.DeviceType.CUDA)
    nbytes = mesh_terms_bytes(mesh.tables, m, n)
    skinned = int((mesh.tables["blocks"][:, 2] >= 0).sum()) * T * n
    ops = ((n * nb * T - skinned) * 3 * MESH_TERMS_CORNER_OPS["rigid"]
           + skinned * 3 * MESH_TERMS_CORNER_OPS["skinned"] + n * nb * T * MESH_TERMS_SLOT_OPS)
    b_ms, b_by = bound(nbytes, ops)
    phase("mesh-terms", f"kernel {ms:.4f} ms (profiler device time), {events_ms:.4f} ms by CUDA "
          f"events (20 launches queued behind a sleep, issued in {issue_ms:.3f} ms); the "
          f"wrapper's call {call_ms:.4f} ms by CUDA events; bound {b_ms:.4f} ms ({b_by}: "
          f"{nbytes / 1e6:.1f} MB at 3.35 TB/s, {ops / 1e9:.3f} GFLOP at 67 TFLOP/s), "
          f"{100 * b_ms / ms:.1f}% of the kernel's profiler time, {100 * b_ms / events_ms:.1f}% "
          f"by events; plain_mesh_terms {plain_ms:.4f} ms by CUDA events in {plain_launches} "
          f"launches a call; on {card}")

    # Before and after: the plain terms in place of the kernel, in turns.
    terms_fn = meshcast.MeshCaster.mesh_terms

    def timed(kind, fn, iters=10):
        """(min host ms to issue ``fn``, CUDA-event ms a call) with the
        kernel's or the plain version's terms."""
        if kind == "plain":
            meshcast.MeshCaster.mesh_terms = meshcast.plain_mesh_terms
        try:
            fn()
            torch.cuda.synchronize()
            host = []
            for _ in range(iters):
                t0 = time.perf_counter()
                fn()
                host.append((time.perf_counter() - t0) * 1e3)
                torch.cuda.synchronize()
            return min(host), cuda_ms(fn, iters=iters)
        finally:
            meshcast.MeshCaster.mesh_terms = terms_fn

    calls = {"frame_world": ("HifiCaster.frame_world", lambda: hifi.frame_world(w, o)),
             **{f"packed_{name}": (f"MeshCaster.packed on the {name}, its terms built in the "
                                   f"call", lambda d=d: mesh.packed(w, o, d)) for name, d in rays}}
    times = {c: {"kernel": [], "plain": []} for c in calls}
    for c, (label, fn) in calls.items():
        for kind in ("kernel", "plain", "plain", "kernel"):
            times[c][kind].append(timed(kind, fn))
        t = times[c]
        phase("mesh-terms", f"{label}, in turns (kernel, plain, plain, kernel): host issue ms "
              f"kernel {[round(h, 4) for h, _ in t['kernel']]}, plain "
              f"{[round(h, 4) for h, _ in t['plain']]}; CUDA events ms kernel "
              f"{[round(e, 4) for _, e in t['kernel']]}, plain "
              f"{[round(e, 4) for _, e in t['plain']]}; on {card}")
    best = {c: {k: {"host_ms": min(h for h, _ in v), "events_ms": min(e for _, e in v)}
                for k, v in t.items()} for c, t in times.items()}
    return {"max_abs_err": err, "ms": ms, "ms_by": {"profiler": ms, "events": events_ms},
            "call_ms": call_ms, "plain_ms": plain_ms, "plain_launches": plain_launches,
            "bound": (b_ms, b_by), "terms_gap": gap,
            "registers": report["mesh_terms_kernel"]["registers"], **best}


def hifi_phase(dev, card, counters, datagen, work, ck, scene):
    """The hifi CAD-mesh tier: the sweep kernel on the masked schedule
    against its plain version on ``scene`` (the main path's world,
    cameras, M, intrinsics), a hifi batch card against CPU and its labels
    against the proxy's, ``generate --hifi``, ``train-detect --hifi-mix 4
    --hifi-eval``, ``infer --hifi``, then the mesh sweep's and the hifi
    steps' times. Returns the launches per path."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from constructionsceneposeestimation_tpu_torch.config import (Config, PipelineConfig,
                                                                  SceneConfig, TrainConfig)
    from constructionsceneposeestimation_tpu_torch.core import camera as cam_mod
    from constructionsceneposeestimation_tpu_torch.parallel.pipeline import Pipeline
    from constructionsceneposeestimation_tpu_torch.render import meshcast, sweep_kernel
    from constructionsceneposeestimation_tpu_torch.scene import world as world_mod
    from constructionsceneposeestimation_tpu_torch.train import detect_loop
    from constructionsceneposeestimation_tpu_torch.train import loop as train_loop
    from constructionsceneposeestimation_tpu_torch.utils import kernels

    launches = {}
    world, cam, M, intr = scene
    cfg = Config(pipeline=PipelineConfig(render_width=RES, render_height=RES, batch_size=B))
    hpipe = Pipeline(cfg, device=dev, hifi_mesh=True)
    base = hpipe.sweeper.base
    si, sf, radii = base.schedule(dev)
    k_fn = lambda: sweep_kernel.sweep_cuda(si, sf, world, cam, M, intr, radii)
    packed = k_fn()
    full = sweep_kernel.sweep_cuda(si, sf, world, cam, M, intr, torch.full_like(radii, 1e15))
    cull_exact = bool(torch.equal(packed.view(torch.int32), full.view(torch.int32)))
    check(cull_exact, "hifi: the masked sweep's tile cull changed the result")
    sweep_agreement("hifi", packed,
                    sweep_kernel.plain_pixel_sweep(base.caster, world, cam, M, intr))
    del packed, full
    masked_ms = device_ms(k_fn, "sweep_kernel")
    phase("hifi", f"sweep kernel on the masked schedule ({si.shape[0]} of "
          f"{len(hpipe.roster.prim_inst)} rows; the meshed cones, fences, trees and worker "
          f"left out), {B} x {RES}^2: tile-culled bit-equal to every row kept: {cull_exact}; "
          f"held to the [sweep] thresholds above; kernel {masked_ms:.4f} ms on {card}")

    # A hifi batch: card against CPU, and its labels against the proxy's.
    small = Config(pipeline=PipelineConfig(render_width=128, render_height=128, batch_size=4))
    ids = range(10, 14)
    g_dev = Pipeline(small, device=dev, hifi_mesh=True).make_generate_fn()(SEED, ids)
    g_cpu = Pipeline(small, device="cpu", hifi_mesh=True).make_generate_fn()(SEED, ids)
    proxy = Pipeline(small, device=dev).make_generate_fn()(SEED, ids)
    fd, fc = g_dev.depth.cpu(), g_cpu.depth
    fin = torch.isfinite(fd) & torch.isfinite(fc)
    rel = (torch.abs(fd - fc) / fc)[fin]
    agree = {"depth_finite": (torch.isfinite(fd) == torch.isfinite(fc)).float().mean().item(),
             "instance": (g_dev.instance.cpu() == g_cpu.instance).float().mean().item(),
             "rel > 1e-5": (rel > 1e-5).float().mean().item(),
             "rel > 2e-4": (rel > 2e-4).float().mean().item()}
    labels = all(torch.equal(getattr(g_dev, f), getattr(proxy, f))
                 for f in ("center", "size", "euler_deg"))
    differs = not torch.equal(g_dev.instance, proxy.instance)
    phase("hifi", "4 x 128^2 hifi frames, card vs plain CPU path: " + ", ".join(
        f"{k} {v:.6f}" for k, v in agree.items()) + f" (> 0.9995, > 0.999, < 0.005, <= 1e-4); "
          f"center, size, euler bit-equal to the proxy render: {labels}; silhouettes differ "
          f"from it: {differs}")
    check(agree["depth_finite"] > 0.9995 and agree["instance"] > 0.999
          and agree["rel > 1e-5"] < 0.005 and agree["rel > 2e-4"] <= 1e-4 and labels and differs,
          "hifi frame: card vs CPU, or its labels against the proxy render")

    # generate --hifi, packed with heatmaps: bit-equal to direct hifi generate.
    out = work / "hifi"
    reset(counters)
    lines = drive_cli(["generate", "--device", dev.type, "--size", str(RES), "--batch",
                       str(HIFI_FRAMES), "--frames", str(HIFI_FRAMES), "--hifi", "--format",
                       "packed", "--heatmaps", "--seed", str(SEED), "--out", str(out)])
    launches["generate_hifi"] = read(counters)
    gcfg = Config(pipeline=PipelineConfig(render_width=RES, render_height=RES,
                                          batch_size=HIFI_FRAMES, max_iterations=HIFI_FRAMES,
                                          seed=SEED))
    with torch.no_grad():
        want = host_fields(Pipeline(gcfg, device=dev, hifi_mesh=True).make_generate_fn()(
            SEED, range(HIFI_FRAMES)))
    got = shard_arrays(out / "shard_000000.npz")
    check(lines[-1].startswith(f"done: {HIFI_FRAMES} frames in ")
          and got.keys() == want.keys() and all(np.array_equal(got[k], v)
                                                for k, v in want.items())
          and all(launches["generate_hifi"][k] == 1 for k in datagen)
          and launches["generate_hifi"][MESH] == 2,
          f"generate --hifi: {lines}, launches {launches['generate_hifi']}, or its shard is not "
          f"bit-equal to direct hifi generate")
    phase("hifi", f"generate --hifi --format packed --heatmaps, {HIFI_FRAMES} frames: shard "
          f"bit-equal to direct hifi generate; launches {launches['generate_hifi']}")

    # train-detect with the two-stage detector's arguments, --hifi-mix 4
    # --hifi-eval: the hifi sweep renders steps 0, 4, 8, 12, 16 and the
    # evaluation batch.
    # The mesh sweep's launches in the training steps' hifi batches are
    # counted apart, so that the evaluation's show.
    sweeper_call, gen_step = meshcast.HifiSweeper.__call__, detect_loop.DetectTrainStep.generate
    hifi_calls, hifi_steps, mesh_in_steps, terms_in_steps = [0], [], [0], [0]

    def counting(self, *a):
        hifi_calls[0] += 1
        return sweeper_call(self, *a)

    def recording(self, seed, frame_ids, step):
        before, mesh_before = hifi_calls[0], meshcast.mesh_sweep_cuda.launches
        terms_before = meshcast.mesh_terms_cuda.launches
        out = gen_step(self, seed, frame_ids, step)
        if hifi_calls[0] > before:
            hifi_steps.append(step)
            mesh_in_steps[0] += meshcast.mesh_sweep_cuda.launches - mesh_before
            terms_in_steps[0] += meshcast.mesh_terms_cuda.launches - terms_before
        return out

    meshcast.HifiSweeper.__call__, detect_loop.DetectTrainStep.generate = counting, recording
    reset(counters)
    try:
        lines = drive_cli(["train-detect", "--device", dev.type, "--size", str(RES), "--batch",
                           str(TRAIN_B), "--steps", str(TRAIN_STEPS), "--inner", "1", "--seed",
                           str(SEED), *DETECT_ARGS, "--crop-ckpt", ck["dumper"],
                           "--crane-crop-ckpt", ck["crane"], "--eval-frames", "64",
                           "--hifi-mix", str(HIFI_MIX), "--hifi-eval"])
    finally:
        meshcast.HifiSweeper.__call__, detect_loop.DetectTrainStep.generate = (sweeper_call,
                                                                               gen_step)
    torch.cuda.synchronize()
    launches["train_detect_hifi"] = read(counters)
    losses = finite_step_losses(lines, TRAIN_STEPS, "train-detect --hifi-mix")
    want_steps = list(range(0, TRAIN_STEPS, HIFI_MIX))
    evl = "eval frames: hifi CAD-mesh renders (proxy-trained models)"
    heads = [evl, "detector P/R @IoU0.5: ", "  crane parts P/R: [",
             "FULL two-stage dumper 6DoF (detector boxes): ",
             "FULL two-stage crane 6DoF (detector part boxes): "]
    missing = [h for h in heads if not any(ln.startswith(h) for ln in lines)]
    check(hifi_steps == want_steps and hifi_calls[0] == len(want_steps) + 1 and not missing
          and lines.index(evl) < min(i for i, ln in enumerate(lines)
                                     if ln.startswith("detector P/R")),
          f"train-detect --hifi-mix {HIFI_MIX} --hifi-eval: hifi steps {hifi_steps}, hifi "
          f"batches {hifi_calls[0]}, missing lines {missing}")
    # Each hifi batch sweeps its pixels and its keypoint segments.
    eval_mesh = launches["train_detect_hifi"][MESH] - mesh_in_steps[0]
    eval_terms = launches["train_detect_hifi"][MESH_TERMS] - terms_in_steps[0]
    check(all(launches["train_detect_hifi"][k] == TRAIN_STEPS + 1
              for k in ("pixel_sweep", "rgb_epilogue"))
          and launches["train_detect_hifi"]["heatmap_targets"] == 0
          and launches["train_detect_hifi"][MESH] == 2 * hifi_calls[0] and eval_mesh == 2,
          f"train-detect --hifi-mix: launches {launches['train_detect_hifi']}, mesh sweep "
          f"{mesh_in_steps[0]} in the steps")
    phase("hifi", f"train-detect {' '.join(DETECT_ARGS)} --hifi-mix {HIFI_MIX} --hifi-eval: "
          f"{TRAIN_STEPS} steps of {TRAIN_B} x {RES}^2, hifi batches at steps {hifi_steps} and "
          f"the 64 evaluation frames; launches {launches['train_detect_hifi']}; losses "
          f"{[round(v, 4) for v in losses]}")

    poses = work / "hifi.jsonl"
    reset(counters)
    lines = drive_cli(["infer", "--device", dev.type, "--size", str(RES), "--frames",
                       str(HIFI_FRAMES), "--batch", str(INFER_B), "--det-ckpt", ck["det"],
                       "--crop-ckpt", ck["dumper"], "--crane-crop-ckpt", ck["crane"], *INFER_ARGS,
                       "--hifi", "--track", "--seed", str(SEED), "--out", str(poses)])
    torch.cuda.synchronize()
    launches["infer_hifi"] = read(counters)
    records = [json.loads(ln) for ln in poses.read_text().splitlines()]
    check([r["frame_id"] for r in records] == list(range(HIFI_FRAMES))
          and all(launches["infer_hifi"][k] == HIFI_FRAMES // INFER_B
                  for k in ("pixel_sweep", "rgb_epilogue"))
          and launches["infer_hifi"][MESH] == 2 * HIFI_FRAMES // INFER_B,
          f"infer --hifi: {len(records)} records, launches {launches['infer_hifi']}")
    phase("hifi", f"infer --hifi --track, {HIFI_FRAMES} frames in batches of {INFER_B}: "
          f"{sum(len(r['detections']) for r in records)} detections; launches "
          f"{launches['infer_hifi']}")

    # The mesh sweep on 32 x 512^2 hifi frames, pixel rays (square tiles)
    # and keypoint segments (one group a frame): csrc/meshsweep.cu against
    # plain_mesh_sweep on the same terms and rays (pixels: the [sweep] bars;
    # segments, not a grid: the same bars without the edge test), its visits
    # equal to visited(), two calls bit-equal, every walk bit-equal to the
    # split walk (every triangle of each visited block); the culls
    # (mesh_cull_report, mesh_segment_cull_report): the boxes the cone
    # pre-test keeps beside the visits, the triangles each patch or set of
    # segments keeps, no widened-passing pair lost;
    # the kernel's device time against its bound, the needed (ray,
    # triangle) pairs (mesh_needed_pairs) x MESH_PAIR_OPS and the pairs
    # that pass x MESH_PASS_OPS at the FP32 rate against the terms' and
    # rays' bytes, with the visited pairs' bound (the JAX function's grain),
    # the plain test's MESH_PLAIN_PAIR_OPS a visited pair and the
    # brute-force count of every ray against every triangle printed beside;
    # the default walk's and the split walk's times in one window; the plain version's
    # time and launches a call; MeshCaster.packed (the terms and the
    # kernel) by CUDA events.
    n = HIFI_FRAMES
    inp = hpipe.sample_inputs(SEED + 3000, range(n))
    w = world_mod.build_world(hpipe.roster, inp.pose)
    Mh = cam_mod.look_at_matrix(inp.cam_pos, inp.target)
    mesh = hpipe.caster.mesh
    o = inp.cam_pos.contiguous()
    px = cam_mod.pixel_rays(intr, Mh).reshape(n, -1, 3)
    kp = world_mod.world_keypoints(w["inst_rot"], w["inst_pos"], w["kpts_local"])
    seg = (kp.reshape(n, -1, 3) - inp.cam_pos[:, None]).contiguous()
    report = kernels.ptxas_report("meshsweep.cu")
    phase("mesh", f"csrc/meshsweep.cu, registers and spill bytes (ptxas): {report}")
    check(set(report) == set(MESH_INSTANTIATIONS.values())
          and all(r["spill_bytes"] == 0 and r["registers"] <= MESH_MAX_REGISTERS
                  for r in report.values()),
          f"mesh sweep: an instantiation is missing, spills or takes more than "
          f"{MESH_MAX_REGISTERS} registers: {report}")
    before = meshcast.mesh_terms_cuda.launches, meshcast.plain_mesh_terms.card_calls
    m = mesh.mesh_terms(w, o)
    check((meshcast.mesh_terms_cuda.launches, meshcast.plain_mesh_terms.card_calls)
          == (before[0] + 1, before[1]), "MeshCaster.mesh_terms on the card: not one launch of "
          "the terms kernel")
    terms_r = mesh_terms_report(card, hpipe.caster, w, o, (("pixels", px), ("segments", seg)), m)
    codes = mesh._on(dev)["codes"]
    mesh_r = {}
    for name, d in (("pixels", px), ("segments", seg)):
        lay = mesh.layout(d.shape[1])
        walk = meshcast.mesh_walk(n, lay)
        k_fn = lambda d=d, lay=lay, walk=None: meshcast.mesh_sweep_cuda(
            m.terms, m.lo, m.hi, m.spheres, codes, o, d, lay, walk=walk)
        p_fn = lambda d=d, lay=lay: meshcast.plain_mesh_sweep(m.terms, m.lo, m.hi, codes, o, d,
                                                              lay)
        visits = torch.full((n, lay.groups), -1, dtype=torch.int32, device=dev)
        out = meshcast.mesh_sweep_cuda(m.terms, m.lo, m.hi, m.spheres, codes, o, d, lay, visits)
        again, plain = k_fn(), p_fn()
        tiles = lay.grid_w and lay.side == meshcast.PATCH_SIDE
        walks = [v for v in meshcast.WALKS if v != meshcast.PATCH or tiles]
        same_walks = {v: torch.equal(out.view(torch.int32), k_fn(walk=v).view(torch.int32))
                      for v in walks}
        visited = mesh.visited(w, o, d)
        boxes, _ = meshcast.patch_cull_plain(m.lo, m.hi, m.spheres, o, d, lay, "split")
        torch.cuda.synchronize()
        bit_equal = torch.equal(out.view(torch.int32), again.view(torch.int32))
        visits_equal = torch.equal(visits, visited.sum(-1).int())
        pre_ok = not bool((visited & ~boxes).any())
        phase("mesh", f"{name}, {n} x {RES}^2, {d.shape[1]} rays a frame in {lay.groups} "
              f"group(s) of {lay.rays}, the {walk} walk: two calls bit-equal: {bit_equal}; "
              f"visits equal to visited(): {visits_equal}; bit-equal to the walks {same_walks}; "
              f"(frame, group, box) triples the cone pre-test keeps (the mirror) "
              f"{int(boxes.sum())} of {boxes.numel()}, all the {int(visited.sum())} visited "
              f"among them: {pre_ok}")
        check(bit_equal and visits_equal and all(same_walks.values()) and pre_ok,
              f"mesh sweep {name}: two calls differ, its visits differ from visited(), a walk "
              f"differs from the split walk, or the box pre-test's mirror dropped a visited box")
        agreement = sweep_agreement if name == "pixels" else segment_agreement
        tk, ck, tp, cp, same = agreement("mesh", out, plain)
        err = torch.abs(tk - tp)[same].max().item()
        del out, again, plain, tk, ck, tp, cp, same
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            p_fn()
            torch.cuda.synchronize()
        kern = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        rays = n * d.shape[1]
        pairs = int(visited.sum()) * lay.rays * mesh.tri_block
        passes = mesh_pair_passes(m, o, d, lay)
        needed = mesh_needed_pairs(m, o, d, lay)
        nbytes = (m.terms.numel() + m.lo.numel() + m.hi.numel() + codes.numel() + o.numel()
                  + d.numel() + rays) * 4
        ops = needed * MESH_PAIR_OPS + passes * MESH_PASS_OPS
        r = mesh_r[name] = {
            "ms": device_ms(k_fn, "mesh_sweep"), "call_ms": cuda_ms(k_fn),
            "packed_ms": cuda_ms(lambda d=d: mesh.packed(w, o, d), iters=10, warmup=2),
            "plain_ms": cuda_ms(p_fn, iters=2, warmup=1),
            "plain_launches": sum(e.count for e in kern),
            "plain_device_ms": sum(e.self_device_time_total for e in kern) / 1e3,
            "max_abs_err": err, "walk": walk, "visits": int(visited.sum()),
            "boxes_pretest": int(boxes.sum()), "pairs": pairs, "needed": needed,
            "passes": passes, "brute": rays * mesh.n_triangles, "bytes": nbytes, "ops": ops,
            "bound": bound(nbytes, ops),
            "visited_bound": bound(nbytes, pairs * MESH_PAIR_OPS + passes * MESH_PASS_OPS),
            "plain_test_bound_ms": bound(nbytes, pairs * MESH_PLAIN_PAIR_OPS)[0]}
        if walk != "split":
            timed = ["split", walk]
            r["walk_ms"] = dict(zip(timed, device_ms_window(
                [(lambda v=v: k_fn(walk=v), MESH_INSTANTIATIONS[v]) for v in timed])))
            r["cull"] = (mesh_cull_report if walk == meshcast.PATCH
                         else mesh_segment_cull_report)(m, codes, o, d, lay)
        phase("mesh", f"{name}, {n} x {RES}^2: kernel {r['ms']:.4f} ms (device time; the "
              f"wrapper's call {r['call_ms']:.4f} ms, MeshCaster.packed with its terms "
              f"{r['packed_ms']:.4f} ms, CUDA events) in 1 launch; plain {r['plain_ms']:.3f} ms "
              f"(device time {r['plain_device_ms']:.3f} ms in {r['plain_launches']} launches); "
              f"{r['visits']} (frame, ray group, block) visits = {pairs:.4e} (ray, triangle) "
              f"pairs, {pairs / rays:.2f} a ray; needed pairs (the ray meets the triangle's "
              f"sphere) {needed} = {needed / rays:.3f} a ray; {passes} pairs pass the test; "
              f"brute force {r['brute']:.4e}; bound {r['bound'][0]:.4f} ms ({r['bound'][1]}: "
              f"{MESH_PAIR_OPS} a needed pair and {MESH_PASS_OPS} more a passing pair at 67 "
              f"TFLOP/s, {nbytes / 1e6:.1f} MB at 3.35 TB/s), {100 * r['bound'][0] / r['ms']:.2f}% "
              f"of the kernel; the visited pairs' bound (the JAX function's grain) "
              f"{r['visited_bound'][0]:.4f} ms ({r['visited_bound'][1]}), "
              f"{100 * r['visited_bound'][0] / r['ms']:.1f}%; the plain test's bound "
              f"({MESH_PLAIN_PAIR_OPS} a visited pair) {r['plain_test_bound_ms']:.4f} ms; "
              f"brute-force bound {bound(0.0, r['brute'] * MESH_PAIR_OPS)[0]:.4f} ms; on {card}")
        if walk != "split":
            phase("mesh", f"{name}: device time of each walk in one window (every walk "
                  f"bit-equal): " + ", ".join(f"{v} {t:.4f} ms" for v, t in r["walk_ms"].items())
                  + f"; the {walk} walk is the default; on {card}")
            c = r["cull"]
        if walk == meshcast.SEGMENTS:
            phase("mesh", f"{name}, the segment walk's cull: triangles tested a segment "
                  f"{c['kept'] / rays:.3f} (visited {pairs / rays:.2f}, needed "
                  f"{needed / rays:.3f}); (set, block) pairs with a kept triangle "
                  f"{c['blocks'] / c['sets']:.3f} a set of {r['visits'] / n:.2f} visited blocks "
                  f"a frame; (segment, triangle) pairs passing the test widened by "
                  f"{MESH_WIDEN_ULPS} ulps, t > EPS included, {c['widened']}, lost by the cull "
                  f"{c['lost']} (must be 0); the (visited block, set) kept sets equal to the "
                  f"mirror's (segment_cull_plain) on {c['mirror_agree']:.6f} of "
                  f"{c['mirror_rows']} on the first {MESH_MIRROR_FRAMES} frames (> 0.99)")
            if c["lost"]:
                phase("mesh", f"{name}, the segment cull's first lost pairs: {c['lost_pairs']}")
            check(c["lost"] == 0 and c["mirror_agree"] > 0.99,
                  f"mesh sweep {name}: the segment cull lost {c['lost']} widened-passing pairs, "
                  f"or its kept sets differ from the mirror's ({c['mirror_agree']:.6f})")
        if walk == meshcast.PATCH:
            phase("mesh", f"{name}, the {walk} patch cull: triangles kept a ray "
                  f"{c['kept'] / rays:.3f} (visited {pairs / rays:.2f}, needed "
                  f"{needed / rays:.3f}); (patch, triangle) pairs with a ray passing the test "
                  f"widened by {MESH_WIDEN_ULPS} ulps {c['widened']}, lost by the cull on the "
                  f"{n} frames {c['lost']} (must be 0); the (visited block, patch) kept sets "
                  f"equal to the mirror's (patch_cull_plain) on {c['mirror_agree']:.6f} of "
                  f"{c['mirror_rows']} on the first {MESH_MIRROR_FRAMES} frames (> 0.99)")
            if c["lost"]:
                phase("mesh", f"{name}, the {walk} patch cull's first lost pairs: "
                      f"{c['lost_pairs']}")
            check(c["lost"] == 0 and c["mirror_agree"] > 0.99,
                  f"mesh sweep {name}: the cull lost {c['lost']} widened-passing pairs, "
                  f"or its kept sets differ from the mirror's ({c['mirror_agree']:.6f})")

    # The hifi frames' labels with the kernel against those with the plain
    # sweep on the card: kpt_visible, which the segments decide, on >= 0.99
    # (tests/test_torch_cuda.py's bar of a hifi batch against the CPU).
    packed_fn = meshcast.MeshCaster.packed

    def plain_packed(self, world, ray_o, ray_d):
        t = self.mesh_terms(world, ray_o)
        return meshcast.plain_mesh_sweep(t.terms, t.lo, t.hi, self._on(ray_d.device)["codes"],
                                         ray_o.contiguous(), ray_d.contiguous(),
                                         self.layout(ray_d.shape[1]))

    hgen = hpipe.make_generate_fn()
    with torch.no_grad():
        fk = hgen(SEED + 3000, range(n))
        meshcast.MeshCaster.packed = plain_packed
        try:
            fp = hgen(SEED + 3000, range(n))
        finally:
            meshcast.MeshCaster.packed = packed_fn
    agree = {f: (getattr(fk, f) == getattr(fp, f)).float().mean().item()
             for f in ("kpt_visible", "instance")}
    phase("mesh", f"hifi generate {n} x {RES}^2, the kernel against the plain sweep: "
          f"kpt_visible agree {agree['kpt_visible']:.6f} (>= 0.99), instance "
          f"{agree['instance']:.6f}")
    check(agree["kpt_visible"] >= 0.99, "hifi frames: kpt_visible with the mesh sweep kernel")
    del fk, fp
    pgen = Pipeline(cfg, device=dev).make_generate_fn()
    region_ms(hgen, 0, n)
    region_ms(pgen, 0, n)
    turns = {"hifi": [], "proxy": []}
    for r, k in enumerate(("hifi", "proxy", "proxy", "hifi")):
        turns[k].append(region_ms(hgen if k == "hifi" else pgen, n * (r + 1), n))
    hifi_ms = min(turns["hifi"])
    mesh_ms = mesh_r["pixels"]["packed_ms"] + mesh_r["segments"]["packed_ms"]
    phase("time", f"generate {n} x {RES}^2 with heatmaps, in turns: hifi {turns['hifi']} ms, "
          f"proxy {turns['proxy']} ms; min {hifi_ms:.3f} ms = {n * 1000.0 / hifi_ms:.1f} "
          f"frames/s hifi, {min(turns['proxy']):.3f} ms proxy; the mesh sweep's "
          f"{mesh_ms:.3f} ms (MeshCaster.packed, pixels and segments) is "
          f"{100 * mesh_ms / hifi_ms:.1f}% of the hifi batch; on {card}")

    # The detector step (the run of record's scene) with every batch hifi,
    # beside the proxy step.
    dcfg = Config(scene=SceneConfig(n_dumpers=2, n_humans=3),
                  pipeline=PipelineConfig(render_width=RES, render_height=RES),
                  train=TrainConfig(batch_size=TRAIN_B, steps=8000, loss="focal"))
    for tag, hifi in (("proxy", None), ("hifi", Pipeline(dcfg, device=dev, hifi_mesh=True))):
        det = detect_loop.make_detect_model(output_stride=2, device=dev)
        step_timing(card, detect_loop.make_detect_train_step(
            dcfg, det, Pipeline(dcfg, device=dev), hifi_pipe=hifi, hifi_every=1),
                    train_loop.create_train_state(dcfg, det), ", stride-2 maps, 2 dumpers, "
                    "3 workers", f"detector step, {tag} batches")
    # The kernels line's entry: a hifi batch's two calls, pixels and segments.
    bytes_, ops, pairs, passes = (sum(r[k] for r in mesh_r.values())
                                  for k in ("bytes", "ops", "pairs", "passes"))
    total = {k: sum(r[k] for r in mesh_r.values())
             for k in ("ms", "call_ms", "plain_ms", "packed_ms")}
    return launches, {**total, "max_abs_err": max(r["max_abs_err"] for r in mesh_r.values()),
                      "bound": bound(bytes_, ops), "hifi_eval": eval_mesh,
                      "hifi_eval_terms": eval_terms, "terms": terms_r,
                      "visited_bound_ms": bound(bytes_, pairs * MESH_PAIR_OPS
                                                + passes * MESH_PASS_OPS)[0],
                      "plain_test_bound_ms": bound(bytes_, pairs * MESH_PLAIN_PAIR_OPS)[0],
                      "instantiations": {v: {"kernel": k, **report[k]}
                                         for v, k in MESH_INSTANTIATIONS.items()},
                      "hifi_batch_ms": hifi_ms, **{k: {f: r[f] for f in (
                          "ms", "call_ms", "packed_ms", "plain_ms", "plain_launches", "walk",
                          "visits", "boxes_pretest", "pairs", "needed", "passes", "walk_ms",
                          "cull") if f in r} for k, r in mesh_r.items()}}


def textured_rgb_inputs(pipe, sweeper, world, inputs, M):
    """The RGB kernel's inputs for ``sweeper``'s pixel sweep (the far clip
    applied, as the annotation pass builds them): t, instance, table, AO."""
    import torch
    from constructionsceneposeestimation_tpu_torch.core import camera as cam_mod
    from constructionsceneposeestimation_tpu_torch.render import raycast, rgb_kernel
    n = inputs.cam_pos.shape[0]
    t, code = raycast._unpack(sweeper(world, inputs.cam_pos, M))
    t = torch.where(t < raycast.INF * 0.99, t, float("inf")).reshape(n, RES, RES)
    inst = (code - 2).reshape(n, RES, RES)
    depth = t * torch.sum(cam_mod.pixel_rays(pipe.intr, M) * (-M[:, :, 0])[:, None, None, :], -1)
    clipped = depth >= pipe.cfg.camera.clipping[1]
    t = torch.where(clipped, float("inf"), t).contiguous()
    inst = torch.where(clipped, -2, inst).to(torch.int32).contiguous()
    return (t, inst, rgb_kernel.instance_table(pipe.roster, world["inst_rot"], world["inst_pos"]),
            rgb_kernel.ao_table(pipe.roster, world["inst_pos"]))


def texture_stage_pixels(t, inst, table, par):
    """(hit, sampled, mapped, r_xy, theta) (B, H, W) masks of the texture
    stage: hit pixels, those that sample the texel table (mix weight > 0,
    or the vest), those with a normal map, and those whose ladder takes
    r_xy and theta, from the textured kernel's plan
    (``rgb_kernel.texture_plan_plain``)."""
    import torch
    from constructionsceneposeestimation_tpu_torch.render import rgb_kernel
    plan = rgb_kernel.texture_plan_plain(t, inst, table, par)
    return (torch.isfinite(t), plan.slot >= 0, plan.w_nr > 0, plan.takes_r_xy,
            plan.takes_theta)


def rgb_variant_bound(variant, t, inst, table, ao, par, texels=None, normal=None,
                      shadow_t=None):
    """(bound_ms, bound_by, operations, bytes) of a variant of csrc/rgb.cu
    ("textured" or one of ``rgb_kernel.VARIANTS``) on these inputs: the
    default work as [rgb] charges it (the sky path on a sky pixel; one ray
    a hit pixel, the AO rows within reach of each ground pixel) less the
    screen-space normal where a normal is given and the local frame,
    patterns and AO where the albedo is flat, plus the shadow gate and the
    texture stage on the hit pixels that take them; the bytes of t, the
    instance id and the u8 out, the tables, 12 bytes a pixel of normals and
    4 of shadow_t where read, and the texel table once."""
    import torch
    from constructionsceneposeestimation_tpu_torch.render import rgb_kernel
    parts = variant.split("+")
    n_px = t.numel()
    n_hit = int(torch.isfinite(t).sum())
    flat = "flat" in parts
    ops = rgb_default_ops(t, inst, ao, par, ao_rows=not flat)
    if flat:
        ops -= n_hit * RGB_PROCEDURAL_OPS
    nbytes = n_px * (4 + 4 + 3) + 4 * (table.numel() + ao.numel() + par.numel())
    if "normal" in parts:
        ops -= n_hit * RGB_SCREEN_NORMAL_OPS
        nbytes += 12 * n_px
    if "shadow" in parts:
        ops += n_hit * RGB_SHADOW_OPS
        nbytes += 4 * n_px
    if "textured" in parts:
        hit, sampled, mapped, r_xy, theta = texture_stage_pixels(t, inst, table, par)
        ops += (n_hit * RGB_TEX_HIT_OPS + int(r_xy.sum()) * RGB_TEX_R_XY_OPS
                + int(theta.sum()) * RGB_TEX_THETA_OPS + int(sampled.sum()) * RGB_TEX_SAMPLE_OPS
                + int(mapped.sum()) * RGB_TEX_MAP_OPS)
        nbytes += 4 * texels.numel()
    return (*bound(nbytes, ops), ops, nbytes)


def rgb_default_ops(t, inst, ao, par, ao_rows=True):
    """Operations of the default RGB kernel's function on these inputs: the
    sky path on each sky pixel, one ray and the untextured pixel's work on
    each hit pixel and, with ``ao_rows``, the AO rows within reach of each
    ground pixel (``rgb_kernel.ao_rows_needed``)."""
    import torch
    from constructionsceneposeestimation_tpu_torch.render import rgb_kernel
    n_hit = int(torch.isfinite(t).sum())
    ops = n_hit * (RGB_PIXEL_OPS - 2 * RGB_RAY_OPS) + (t.numel() - n_hit) * RGB_SKY_OPS
    if ao_rows:
        ops += int(rgb_kernel.ao_rows_needed(t, inst, ao, par).sum()) * RGB_AO_ROW_OPS
    return ops


def textures_phase(dev, card, counters, datagen, work, ck):
    """The image-texture tier at 512^2: the RGB kernel's textured variant
    against its plain version on 64 frames, proxy and hifi, hash noise off
    and on (noise off: mean |d| < 0.5 u8, |d| > 1 on < 2% of the values, sky
    exact, |d| > 1 on <= 1e-3 of the ground pixels within an AO row's reach,
    and |d| > 2 on at most 1e-3 more of the values than the untextured
    kernel against its plain version on the same inputs: bin flips; noise
    on: means within 1.0, standard deviations within 2.0); labels bit-equal
    to the untextured generate; textured and untextured generate in turns;
    the kernel's device time against its bound; `generate --image-textures`
    (packed with heatmaps, `--hifi`, `--sequence-len 30`) bit-equal to
    direct generate; `train-detect` with the [hifi] phase's arguments and
    `--image-textures`; a procedural | textured PNG through `utils/viz`.
    Returns (launches per path, the textured variant's numbers)."""
    import struct

    import numpy as np
    import torch
    from constructionsceneposeestimation_tpu_torch.config import Config, PipelineConfig
    from constructionsceneposeestimation_tpu_torch.core import camera as cam_mod
    from constructionsceneposeestimation_tpu_torch.parallel.pipeline import Pipeline
    from constructionsceneposeestimation_tpu_torch.render import meshcast, rgb_kernel
    from constructionsceneposeestimation_tpu_torch.scene import world as world_mod
    from constructionsceneposeestimation_tpu_torch.train import detect_loop
    from constructionsceneposeestimation_tpu_torch.utils import kernels, viz

    launches = {}
    cfg = Config(pipeline=PipelineConfig(render_width=RES, render_height=RES, batch_size=B))
    pipe = Pipeline(cfg, device=dev)
    tpipe = Pipeline(cfg, device=dev, image_textures=True)
    texels = tpipe.texels()
    inputs = pipe.sample_inputs(SEED, range(B))
    world = world_mod.build_world(pipe.roster, inputs.pose)
    M = cam_mod.look_at_matrix(inputs.cam_pos, inputs.target)
    lit_off = inputs.lighting._replace(tex_strength=torch.zeros_like(inputs.lighting.tex_strength))
    par_off = rgb_kernel.rgb_params(M, inputs.cam_pos, pipe.intr, lit_off)
    par_on = rgb_kernel.rgb_params(M, inputs.cam_pos, pipe.intr, inputs.lighting)
    sweepers = {"proxy": pipe.sweeper,
                "hifi": Pipeline(cfg, device=dev, hifi_mesh=True).sweeper}
    err = 0.0
    for geometry, sweeper in sweepers.items():
        t, inst, table, ao = textured_rgb_inputs(pipe, sweeper, world, inputs, M)
        reach = rgb_kernel.ao_rows_needed(t, inst, ao, par_off) > 0
        for noise, par in ((False, par_off), (True, par_on)):
            rk = rgb_kernel.rgb_cuda(t, inst, table, ao, par, texels).float()
            rp = rgb_kernel.plain_rgb(t, inst, table, ao, par, texels).float()
            torch.cuda.synchronize()
            if noise:
                dm = abs(rk.mean().item() - rp.mean().item())
                ds = abs(rk.std().item() - rp.std().item())
                phase("textures", f"{geometry}, noise on: |mean diff| {dm:.4f} (< 1.0), |std "
                      f"diff| {ds:.4f} (< 2.0)")
                check(dm < 1.0 and ds < 2.0,
                      f"textured rgb kernel statistics disagree ({geometry}, noise on)")
                continue
            d = torch.abs(rk - rp)
            base = torch.abs(rgb_kernel.rgb_cuda(t, inst, table, ao, par).float()
                             - rgb_kernel.plain_rgb(t, inst, table, ao, par).float())
            sky = (inst == -2)[..., None].expand_as(d)
            far, far0 = (d > 2).float().mean().item(), (base > 2).float().mean().item()
            d_reach = d.amax(-1)[reach]
            stats = {"mean |d|": d.mean().item(), "|d| > 1": (d > 1).float().mean().item(),
                     "|d| > 2": far, "untextured |d| > 2": far0,
                     "|d| > 1 within AO reach": (d_reach > 1).float().mean().item()}
            sky_exact = bool(torch.equal(rk[sky], rp[sky]))
            phase("textures", f"{geometry}, noise off, {B} x {RES}^2: " + ", ".join(
                f"{k} {v:.5f}" for k, v in stats.items()) + f", max |d| {d.max().item():.0f}; sky "
                  f"exact {sky_exact} (< 0.5, < 0.02, <= untextured + 1e-3, <= 1e-3)")
            check(stats["mean |d|"] < 0.5 and stats["|d| > 1"] < 0.02 and sky_exact
                  and far <= far0 + 1e-3 and stats["|d| > 1 within AO reach"] <= 1e-3,
                  f"textured rgb kernel disagrees with its plain version ({geometry}, noise off)")
            err = max(err, d.max().item())
            del base, d, d_reach
    # The proxy inputs again, for the timing and the bound.
    t, inst, table, ao = textured_rgb_inputs(pipe, pipe.sweeper, world, inputs, M)
    k_fn = lambda: rgb_kernel.rgb_cuda(t, inst, table, ao, par_on, texels)
    p_fn = lambda: rgb_kernel.plain_rgb(t, inst, table, ao, par_on, texels)
    # The bound charges the untextured work (as [rgb] does: the sky path on
    # a sky pixel) plus the texture stage's, on the pixels this run's data
    # sends through it.
    hit, sampled, mapped, r_xy, theta = texture_stage_pixels(t, inst, table, par_on)
    n_px = B * RES * RES
    tex_bound = rgb_variant_bound("textured", t, inst, table, ao, par_on, texels)
    regs = kernels.ptxas_report("rgb.cu")["rgb_kernel<true, 0>"]
    result = {"max_abs_err": err, "ms": device_ms(k_fn, "rgb_kernel<true, 0>"),
              "call_ms": cuda_ms(k_fn), "plain_ms": cuda_ms(p_fn, iters=2, warmup=1),
              "bound_ms": tex_bound[0], "bound_by": tex_bound[1], **regs}
    untex_ms = device_ms(lambda: rgb_kernel.rgb_cuda(t, inst, table, ao, par_on),
                         "rgb_kernel<false, 0>")
    phase("textures", f"textured RGB kernel, {B} x {RES}^2: {result['ms']:.4f} ms device time "
          f"(call {result['call_ms']:.4f} ms; untextured {untex_ms:.4f} ms in the same window), "
          f"plain {result['plain_ms']:.4f} ms; pixels hit {int(hit.sum()) / n_px:.4f}, sampling "
          f"{int(sampled.sum()) / n_px:.4f}, normal-mapped {int(mapped.sum()) / n_px:.4f}, taking "
          f"r_xy {int(r_xy.sum()) / n_px:.4f}, theta {int(theta.sum()) / n_px:.4f}; bound "
          f"{tex_bound[0]:.4f} ms ({tex_bound[1]}: {tex_bound[2]:.4e} operations, "
          f"{tex_bound[3] / 1e6:.1f} MB); roofline share {100 * tex_bound[0] / result['ms']:.1f}%; "
          f"{regs['registers']} registers, {regs['spill_bytes']} bytes of spill stores (ptxas) "
          f"on {card}")
    del t, inst, table, ao, hit, sampled, mapped, r_xy, theta

    # Labels bit-equal to the untextured render of the same frames; the
    # textured variant launches once, the untextured RGB kernel not at all.
    gen, tgen = pipe.make_generate_fn(), tpipe.make_generate_fn()
    with torch.no_grad():
        plain_b = gen(SEED, range(B))
        reset(counters)
        tex_b = tgen(SEED, range(B))
        torch.cuda.synchronize()
    launches["generate_textured"] = read(counters)
    same = [f for f in tex_b._fields if f != "rgb"
            and torch.equal(getattr(tex_b, f), getattr(plain_b, f))]
    changed = (torch.abs(tex_b.rgb.float() - plain_b.rgb.float()).amax(-1) > 2).float().mean()
    phase("textures", f"textured generate, {B} x {RES}^2: fields bit-equal to the untextured "
          f"generate: {len(same)} of {len(tex_b._fields) - 1} (all but rgb); rgb changed by > 2 "
          f"u8 on {changed.item():.4f} of the pixels; launches {launches['generate_textured']}")
    check(len(same) == len(tex_b._fields) - 1 and changed.item() > 0.1,
          "textured generate: a label differs from the untextured generate, or the rgb did not "
          "change")
    check(launches["generate_textured"][TEXTURED] == 1
          and launches["generate_textured"]["rgb_epilogue"] == 0
          and all(launches["generate_textured"][k] == 1 for k in ("pixel_sweep",
                                                                   "heatmap_targets")),
          f"textured generate: launches {launches['generate_textured']}")
    frame = np.concatenate([plain_b.rgb[0].cpu().numpy(), tex_b.rgb[0].cpu().numpy()], axis=1)
    png = work / "procedural_textured.png"
    viz.save_png(str(png), frame)
    data = png.read_bytes()
    size = struct.unpack(">II", data[16:24])
    phase("textures", f"procedural | textured frame 0 through utils/viz.save_png: {len(data)} "
          f"bytes, {size[0]} x {size[1]} ({viz.__name__})")
    check(data[:8] == b"\x89PNG\r\n\x1a\n" and size == (2 * RES, RES) and len(data) > 10000,
          "the comparison PNG")
    del plain_b, tex_b

    # Textured and untextured generate in turns.
    region_ms(tgen, 0)
    region_ms(gen, 0)
    turns = {"textured": [], "untextured": []}
    for r, k in enumerate(("textured", "untextured", "untextured", "textured")):
        turns[k].append(region_ms(tgen if k == "textured" else gen, B * (r + 1)))
    best = {k: min(v) for k, v in turns.items()}
    phase("time", f"generate {B} x {RES}^2 with heatmaps, in turns: textured {turns['textured']} "
          f"ms, untextured {turns['untextured']} ms; min {best['textured']:.3f} ms = "
          f"{B * 1000.0 / best['textured']:.1f} frames/s textured, {best['untextured']:.3f} ms = "
          f"{B * 1000.0 / best['untextured']:.1f} frames/s untextured on {card}")

    # generate --image-textures: packed with heatmaps, --hifi, --sequence-len.
    runs = {
        "generate_textured_cli": (["--batch", str(TEX_FRAMES), "--frames", str(TEX_FRAMES),
                                   "--heatmaps"], TEX_FRAMES, dict()),
        "generate_hifi_textured": (["--batch", str(HIFI_FRAMES), "--frames", str(HIFI_FRAMES),
                                    "--hifi", "--heatmaps"], HIFI_FRAMES, dict(hifi_mesh=True)),
        "generate_sequence_textured": (["--batch", str(SEQ_B), "--frames", str(SEQ_FRAMES),
                                        "--sequence-len", str(SEQ_LEN), "--heatmaps"], SEQ_B,
                                       dict()),
    }
    for path, (argv, batch, kw) in runs.items():
        out = work / path
        frames = int(argv[argv.index("--frames") + 1])
        reset(counters)
        lines = drive_cli(["generate", "--device", dev.type, "--size", str(RES), "--image-textures",
                           "--format", "packed", "--seed", str(SEED), "--out", str(out), *argv])
        launches[path] = read(counters)
        gcfg = Config(pipeline=PipelineConfig(render_width=RES, render_height=RES,
                                              batch_size=batch, max_iterations=frames, seed=SEED))
        gp = Pipeline(gcfg, device=dev, image_textures=True, **kw)
        g = gp.make_sequence_fn(SEQ_LEN) if "--sequence-len" in argv else gp.make_generate_fn()
        chunks = [list(range(lo, min(lo + batch, frames))) for lo in range(0, frames, batch)]
        for c in chunks:
            ids = c + [c[-1]] * (batch - len(c))
            with torch.no_grad():
                want = host_fields(g(SEED, ids))
            got = shard_arrays(out / f"shard_{c[0]:06d}.npz")
            check(got.keys() == want.keys() and all(np.array_equal(got[k], v)
                                                    for k, v in want.items()),
                  f"{path}: shard {c[0]} is not bit-equal to direct textured generate")
        want_l = {**dict.fromkeys(read(counters), 0), TEXTURED: len(chunks),
                  "pixel_sweep": len(chunks), "heatmap_targets": len(chunks),
                  RAYCAST_PACKED: len(chunks),
                  MESH: 2 * len(chunks) if "--hifi" in argv else 0,
                  MESH_TERMS: len(chunks) if "--hifi" in argv else 0}
        check(lines[-1].startswith(f"done: {frames} frames in ") and launches[path] == want_l,
              f"{path}: {lines[-1:]}, launches {launches[path]}, want {want_l}")
        phase("textures", f"generate --image-textures {' '.join(argv)} --format packed: {frames} "
              f"frames, {len(chunks)} shard(s) bit-equal to direct textured generate; launches "
              f"{launches[path]}")

    # train-detect with the [hifi] phase's arguments and --image-textures:
    # the hifi batches (steps 0, 4, 8, 12, 16) and the evaluation frames
    # textured, the proxy batches not, as in the JAX command.
    sweeper_call = meshcast.HifiSweeper.__call__
    hifi_calls = [0]

    def counting(self, *a):
        hifi_calls[0] += 1
        return sweeper_call(self, *a)

    meshcast.HifiSweeper.__call__ = counting
    reset(counters)
    try:
        lines = drive_cli(["train-detect", "--device", dev.type, "--size", str(RES), "--batch",
                           str(TRAIN_B), "--steps", str(TRAIN_STEPS), "--inner", "1", "--seed",
                           str(SEED), *DETECT_ARGS, "--crop-ckpt", ck["dumper"],
                           "--crane-crop-ckpt", ck["crane"], "--eval-frames", "64",
                           "--hifi-mix", str(HIFI_MIX), "--hifi-eval", "--image-textures"])
    finally:
        meshcast.HifiSweeper.__call__ = sweeper_call
    torch.cuda.synchronize()
    launches["train_detect_textured"] = read(counters)
    losses = finite_step_losses(lines, TRAIN_STEPS, "train-detect --image-textures")
    n_hifi = len(range(0, TRAIN_STEPS, HIFI_MIX))
    heads = ["eval frames: hifi CAD-mesh renders (proxy-trained models)", "detector P/R @IoU0.5: ",
             "  crane parts P/R: [", "FULL two-stage dumper 6DoF (detector boxes): ",
             "FULL two-stage crane 6DoF (detector part boxes): "]
    missing = [h for h in heads if not any(ln.startswith(h) for ln in lines)]
    got_l = launches["train_detect_textured"]
    check(not missing and hifi_calls[0] == n_hifi + 1 and got_l[TEXTURED] == n_hifi + 1
          and got_l["rgb_epilogue"] == TRAIN_STEPS - n_hifi
          and got_l["pixel_sweep"] == TRAIN_STEPS + 1 and got_l[MESH] == 2 * hifi_calls[0],
          f"train-detect --image-textures: missing lines {missing}, hifi batches "
          f"{hifi_calls[0]}, launches {got_l}")
    phase("textures", f"train-detect {' '.join(DETECT_ARGS)} --hifi-mix {HIFI_MIX} --hifi-eval "
          f"--image-textures: {TRAIN_STEPS} steps of {TRAIN_B} x {RES}^2, {n_hifi} hifi textured "
          f"batches and the textured evaluation; launches {got_l}; losses "
          f"{[round(v, 4) for v in losses]}")
    return launches, result


def rgb_tier_args(variant, texels, normal, shadow_t):
    """The keyword arguments of ``rgb_cuda`` / ``plain_rgb`` for an RGB
    variant (``rgb_kernel.VARIANTS``)."""
    parts = variant.split("+")
    return dict(texels=texels if "textured" in parts else None,
                normal=normal if "normal" in parts else None,
                shadow_t=shadow_t if "shadow" in parts else None,
                procedural="flat" not in parts)


def render_tier_args(variant, texels):
    """The keyword arguments of ``render_frame`` whose RGB is the variant
    ``variant`` (``rgb_kernel.VARIANTS``)."""
    parts = variant.split("+")
    return dict(analytic_normals="normal" in parts, sun_shadows="shadow" in parts,
                procedural_textures="flat" not in parts,
                texels=texels if "textured" in parts else None)


def kernel_key(variant):
    """The profiler's name of an RGB variant's instantiation."""
    from constructionsceneposeestimation_tpu_torch.render import rgb_kernel
    parts = variant.split("+")
    tier = rgb_kernel.tier_mask("normal" in parts or None, "shadow" in parts or None,
                                "flat" not in parts)
    return f"rgb_kernel<{'true' if 'textured' in parts else 'false'}, {tier}>"


def to_device(x, dev):
    """A NamedTuple of tensors (or None) moved to ``dev``."""
    import torch
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if x is None:
        return None
    return type(x)(*(to_device(v, dev) for v in x))


def labels_agree(a, b):
    """Card against CPU labels of one render (tests/test_torch_pipeline.py's
    tolerances): the finite masks and instance maps on > 0.999 of the
    pixels, depth to 3e-4 where both are finite, boxes and keypoints to
    1e-4 m and 1e-3 px (1e-5 relative), visibility on >= 0.99."""
    import torch
    da, db = a.depth.cpu(), b.depth
    fin = torch.isfinite(da) & torch.isfinite(db)
    stats = {
        "finite": (torch.isfinite(da) == torch.isfinite(db)).float().mean().item(),
        "instance": (a.instance.cpu() == b.instance).float().mean().item(),
        "depth_rel": (torch.abs(da - db) / db)[fin].max().item(),
        "center": torch.abs(a.center.cpu() - b.center).max().item(),
        "kpt_uv": (torch.abs(a.kpt_uv.cpu() - b.kpt_uv)
                   / (1e-3 + 1e-5 * torch.abs(b.kpt_uv))).max().item(),
        "kpt_visible": (a.kpt_visible.cpu() == b.kpt_visible).float().mean().item()}
    ok = (stats["finite"] > 0.999 and stats["instance"] > 0.999 and stats["depth_rel"] < 3e-4
          and stats["center"] < 1e-4 and stats["kpt_uv"] <= 1.0 and stats["kpt_visible"] >= 0.99)
    return ok, stats


def analytic_phase(dev, card, counters):
    """The last RGB tiers of ``render_frame`` at 512^2: the exact caster on
    the pixel rays and the shadow sweep from its hit points (ms a batch,
    peak memory); each tier variant of the RGB kernel against its plain
    version on those inputs, hash noise off (mean |d| < 0.5 u8, |d| > 1 on
    < 2% of the values, sky exact, |d| > 1 on <= 1e-3 of the ground pixels
    within an AO row's reach where there is AO, |d| > 2 on at most 1e-3
    more of the values than the default kernel against its plain version on
    the same inputs; a shadow variant changes only pixels both versions see
    shadowed) and on (means within 1.0, standard deviations within 2.0);
    ``render_frame`` in each tier combination, textured where not flat,
    each through its variant (labels bit-equal to the default render
    where the tier is RGB-only; under analytic_normals instance on >=
    0.9995 of the pixels and depth to the packed sweep's tolerances), the
    card against the CPU at 4 x 128^2, ``Pipeline(procedural_textures=
    False)``'s generate, the hifi caster equal to the proxy caster under
    analytic_normals and sun_shadows, and each variant's device time
    beside the default kernel's in one window. Returns (launches per path,
    the variants' numbers)."""
    import torch
    from constructionsceneposeestimation_tpu_torch.config import Config, PipelineConfig
    from constructionsceneposeestimation_tpu_torch.core import camera as cam_mod
    from constructionsceneposeestimation_tpu_torch.parallel.pipeline import Pipeline
    from constructionsceneposeestimation_tpu_torch.render import (annotate, meshcast,
                                                                  rgb_kernel, textures)
    from constructionsceneposeestimation_tpu_torch.scene import world as world_mod
    from constructionsceneposeestimation_tpu_torch.utils import kernels

    launches = {}
    cfg = Config(pipeline=PipelineConfig(render_width=RES, render_height=RES, batch_size=B))
    pipe = Pipeline(cfg, device=dev)
    roster, caster, far = pipe.roster, pipe.caster, cfg.camera.clipping[1]
    inputs = pipe.sample_inputs(SEED, range(B))
    world = world_mod.build_world(roster, inputs.pose)
    M = cam_mod.look_at_matrix(inputs.cam_pos, inputs.target)
    rd = cam_mod.pixel_rays(pipe.intr, M)

    # The exact caster on the pixel rays, then the shadow sweep from its hit
    # points, as render_frame calls them: ms a batch (CUDA events, 3 calls
    # after one), peak memory above what the phase held before.
    def peak_of(fn):
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        return out, torch.cuda.max_memory_allocated() - held

    exact = lambda: caster.cast(world, inputs.cam_pos, rd.reshape(B, -1, 3))
    hit, cast_peak = peak_of(exact)
    cast_ms = cuda_ms(exact, iters=3, warmup=1)
    t = hit["t"].reshape(B, RES, RES)
    clipped = t * torch.sum(rd * (-M[:, :, 0])[:, None, None, :], -1) >= far
    t = torch.where(clipped, float("inf"), t).contiguous()
    inst = torch.where(clipped, -2, hit["inst"].reshape(B, RES, RES)).to(torch.int32).contiguous()
    normal = hit["normal"].reshape(B, RES, RES, 3).contiguous()
    del hit, clipped
    sun = -inputs.lighting.sun_dir
    origins = (inputs.cam_pos[:, None, None] + torch.where(torch.isfinite(t), t, 0.0)[..., None]
               * rd + (sun * 1e-3)[:, None, None]).reshape(B, -1, 3)
    dirs = sun[:, None].expand(B, RES * RES, 3)
    shadow_fn = lambda: caster.fast_multi_origin(world, origins, dirs)
    sh, shadow_peak = peak_of(shadow_fn)
    shadow_ms = cuda_ms(shadow_fn, iters=3, warmup=1)
    shadow_t = sh["t"].reshape(B, RES, RES).contiguous()
    del sh, origins
    is_hit = torch.isfinite(t)
    unlit = (shadow_t < 1e9) & is_hit
    lit_share = 1.0 - int(unlit.sum()) / int(is_hit.sum())
    casters = {"cast_ms": cast_ms, "cast_peak_gib": cast_peak / 2 ** 30,
               "shadow_ms": shadow_ms, "shadow_peak_gib": shadow_peak / 2 ** 30,
               "rays": B * RES * RES, "lit_share": lit_share}
    phase("analytic", f"exact caster (Raycaster.cast: csrc/raycast.cu), {B} x "
          f"{RES}^2 pixel rays: {cast_ms:.3f} ms a batch (CUDA events), peak "
          f"{casters['cast_peak_gib']:.2f} GiB above the inputs; shadow sweep "
          f"(fast_multi_origin) from its hit points: {shadow_ms:.3f} ms, peak "
          f"{casters['shadow_peak_gib']:.2f} GiB; hit pixels {int(is_hit.sum()) / t.numel():.4f}, "
          f"lit share of the hit pixels {lit_share:.4f}; on {card}")
    check(0.02 < lit_share < 0.98, f"lit share {lit_share}: the shadow rays see all or nothing")

    # Each tier variant of the RGB kernel against its plain version.
    table = rgb_kernel.instance_table(roster, world["inst_rot"], world["inst_pos"])
    ao = rgb_kernel.ao_table(roster, world["inst_pos"])
    lit_off = inputs.lighting._replace(tex_strength=torch.zeros_like(inputs.lighting.tex_strength))
    par_off = rgb_kernel.rgb_params(M, inputs.cam_pos, pipe.intr, lit_off)
    par_on = rgb_kernel.rgb_params(M, inputs.cam_pos, pipe.intr, inputs.lighting)
    texels = textures.dense_table(textures.load_factors()).to(dev)
    reach = rgb_kernel.ao_rows_needed(t, inst, ao, par_off) > 0
    sky = (inst == -2)[..., None].expand(B, RES, RES, 3)
    base_far = (torch.abs(rgb_kernel.rgb_cuda(t, inst, table, ao, par_off).float()
                          - rgb_kernel.plain_rgb(t, inst, table, ao, par_off).float())
                > 2).float().mean().item()
    variants = {}
    for v in rgb_kernel.VARIANTS:
        kw = rgb_tier_args(v, texels, normal, shadow_t)
        rk = rgb_kernel.rgb_cuda(t, inst, table, ao, par_off, **kw).float()
        rp = rgb_kernel.plain_rgb(t, inst, table, ao, par_off, **kw).float()
        d = torch.abs(rk - rp)
        stats = {"mean |d|": d.mean().item(), "|d| > 1": (d > 1).float().mean().item(),
                 "|d| > 2": (d > 2).float().mean().item()}
        ok = (stats["mean |d|"] < 0.5 and stats["|d| > 1"] < 0.02
              and stats["|d| > 2"] <= base_far + 1e-3 and bool(torch.equal(rk[sky], rp[sky])))
        if "flat" not in v:
            stats["|d| > 1 within AO reach"] = (d.amax(-1)[reach] > 1).float().mean().item()
            ok = ok and stats["|d| > 1 within AO reach"] <= 1e-3
        gate = ""
        if "shadow" in v:
            # The gate: both versions read the same shadow_t, so each changes
            # only the pixels it shadows against its own unshadowed image.
            kw0 = dict(kw, shadow_t=None)
            moved = [((x != y).any(-1) & ~unlit).sum().item()
                     for x, y in ((rk, rgb_kernel.rgb_cuda(t, inst, table, ao, par_off, **kw0)),
                                  (rp, rgb_kernel.plain_rgb(t, inst, table, ao, par_off, **kw0)))]
            gate = f"; lit pixels changed by the gate: kernel {moved[0]}, plain {moved[1]} (0)"
            ok = ok and moved == [0, 0]
        phase("analytic", f"rgb {v}, noise off, {B} x {RES}^2: " + ", ".join(
            f"{k} {x:.5f}" for k, x in stats.items()) + f" (default kernel |d| > 2 {base_far:.5f})"
              f", max |d| {d.max().item():.0f}{gate} (< 0.5, < 0.02, <= default + 1e-3, "
              f"<= 1e-3, sky exact)")
        check(ok, f"rgb variant {v} disagrees with its plain version (noise off)")
        variants[v] = {"max_abs_err": d.max().item()}
        del rk, rp, d
        rk = rgb_kernel.rgb_cuda(t, inst, table, ao, par_on, **kw).float()
        rp = rgb_kernel.plain_rgb(t, inst, table, ao, par_on, **kw).float()
        dm, ds = abs(rk.mean().item() - rp.mean().item()), abs(rk.std().item() - rp.std().item())
        phase("analytic", f"rgb {v}, noise on: |mean diff| {dm:.4f} (< 1.0), |std diff| "
              f"{ds:.4f} (< 2.0)")
        check(dm < 1.0 and ds < 2.0, f"rgb variant {v} statistics disagree (noise on)")
        del rk, rp
    # The flat variants ignore the texel table, as JAX's flat tier does.
    kw = rgb_tier_args("flat+shadow", texels, normal, shadow_t)
    same = torch.equal(rgb_kernel.rgb_cuda(t, inst, table, ao, par_off, **kw),
                       rgb_kernel.rgb_cuda(t, inst, table, ao, par_off, **dict(kw, texels=texels)))
    phase("analytic", f"rgb flat+shadow with the texel table given equals it without: {same}")
    check(same, "a flat variant read the texel table")

    # render_frame in each tier combination, each through its variant:
    # launches, labels, RGB.
    rf = lambda **kw: annotate.render_frame(
        roster, caster, pipe.sweeper, world, inputs.cam_pos, inputs.target, pipe.intr,
        inputs.lighting, far_clip=far, **kw)
    tiers = {v: render_tier_args(v, texels) for v in rgb_kernel.VARIANTS}
    default = rf()
    times = {"default": cuda_ms(lambda: rf(), iters=2, warmup=0)}
    zero = dict.fromkeys(read(counters), 0)
    for name, kw in tiers.items():
        reset(counters)
        out = rf(**kw)
        torch.cuda.synchronize()
        launches[f"render_{name}"] = got = read(counters)
        an = kw["analytic_normals"]
        want = dict(zero, **{tier_key(name): 1, "pixel_sweep": 0 if an else 1,
                             RAYCAST_PACKED: 0 if an else 1, RAYCAST_EXACT: 2 if an else 0,
                             RAYCAST_MULTI: int(kw["sun_shadows"])})
        check(got == want, f"render_frame {name}: launches {got}, want {want}")
        times[name] = cuda_ms(lambda: rf(**kw), iters=1, warmup=0)
        changed = (torch.abs(out.rgb.float() - default.rgb.float()).amax(-1) > 2).float().mean()
        if kw["analytic_normals"]:
            inst_agree = (out.instance == default.instance).float().mean().item()
            both = torch.isfinite(out.depth) & torch.isfinite(default.depth)
            rel = (torch.abs(out.depth - default.depth) / out.depth)[both]
            finite = (torch.isfinite(out.depth) == torch.isfinite(default.depth)).float().mean()
            stats = {"instance": inst_agree, "finite": finite.item(),
                     "rel > 2^-18": (rel > 2.0 ** -18).float().mean().item(),
                     "rel > 1e-5": (rel > 1e-5).float().mean().item(),
                     "rel > 2e-4": (rel > 2e-4).float().mean().item(),
                     "max rel": rel.max().item()}
            msg = ("against the packed sweep: " + ", ".join(f"{k} {x:.3g}" for k, x in
                                                           stats.items())
                   + " (instance >= 0.9995, finite > 0.9995, rel > 1e-5 < 0.005, rel > 2e-4 "
                     "< 1e-5)")
            ok = (inst_agree >= 0.9995 and stats["finite"] > 0.9995 and stats["rel > 1e-5"] < 0.005
                  and stats["rel > 2e-4"] < 1e-5)
        else:
            same = [f for f in out._fields if f != "rgb"
                    and torch.equal(getattr(out, f), getattr(default, f))]
            msg = f"labels bit-equal to the default render: {len(same)} of {len(out._fields) - 1}"
            ok = len(same) == len(out._fields) - 1
        phase("analytic", f"render_frame {name}, {B} x {RES}^2: {msg}; rgb changed by > 2 u8 on "
              f"{changed.item():.4f} of the pixels; launches "
              f"{ {k: n for k, n in got.items() if n} }; {times[name]:.1f} ms (default "
              f"{times['default']:.1f} ms, CUDA events)")
        check(ok and changed.item() > 1e-3, f"render_frame {name}: {msg}, changed {changed}")
        del out
    del default

    # The card against the plain CPU path, 4 x 128^2, each tier, noise off.
    small = Config(pipeline=PipelineConfig(render_width=SMALL_RES, render_height=SMALL_RES,
                                           batch_size=4))
    sp = {where: Pipeline(small, device=where) for where in ("cpu", dev)}
    inp_c = sp["cpu"].sample_inputs(SEED, range(10, 14))
    lit_c = inp_c.lighting._replace(tex_strength=torch.zeros(4))
    rows = []
    for name in tiers:
        outs = {}
        for where, p in sp.items():
            inp = to_device(inp_c, p.device)
            outs[where] = annotate.render_frame(
                roster, p.caster, p.sweeper, world_mod.build_world(roster, inp.pose),
                inp.cam_pos, inp.target, p.intr, to_device(lit_c, p.device), far_clip=far,
                **render_tier_args(name, texels.to(p.device)))
        a, b = outs[dev], outs["cpu"]
        ok, stats = labels_agree(a, b)
        d = torch.abs(a.rgb.cpu().float() - b.rgb.float())
        same_inst = (a.instance.cpu() == b.instance)[..., None].expand_as(d)
        stats.update({"rgb mean |d|": d.mean().item(),
                      "rgb |d| > 1": (d > 1).float().mean().item()})
        ok = ok and stats["rgb mean |d|"] < 0.5 and stats["rgb |d| > 1"] < 0.02
        rows.append(f"{name}: " + ", ".join(f"{k} {x:.3g}" for k, x in stats.items()))
        check(ok, f"render_frame {name}: card vs CPU {stats}; where the instance agrees, rgb "
                  f"max |d| {d[same_inst].max().item()}")
    phase("analytic", f"card vs plain CPU path, {4} x {SMALL_RES}^2, noise off: " + "; ".join(rows)
          + " (finite, instance > 0.999, depth_rel < 3e-4, center < 1e-4, kpt_uv <= 1 of its "
            "tolerance, kpt_visible >= 0.99, rgb mean |d| < 0.5, |d| > 1 < 0.02)")

    # Pipeline(procedural_textures=False): one generate batch with heatmaps.
    fpipe = Pipeline(cfg, device=dev, procedural_textures=False)
    with torch.no_grad():
        plain_b = pipe.make_generate_fn()(SEED, range(B))
        reset(counters)
        flat_b = fpipe.make_generate_fn()(SEED, range(B))
        torch.cuda.synchronize()
    launches["generate_flat"] = got = read(counters)
    want = dict(zero, **{tier_key("flat"): 1, "pixel_sweep": 1, "heatmap_targets": 1,
                         RAYCAST_PACKED: 1})
    same = [f for f in flat_b._fields if f != "rgb"
            and torch.equal(getattr(flat_b, f), getattr(plain_b, f))]
    phase("analytic", f"Pipeline(procedural_textures=False) generate, {B} x {RES}^2 with "
          f"heatmaps: fields bit-equal to the default generate: {len(same)} of "
          f"{len(flat_b._fields) - 1} (all but rgb); launches {got}")
    check(got == want and len(same) == len(flat_b._fields) - 1,
          f"flat generate: launches {got}, want {want}; equal fields {same}")
    del plain_b, flat_b

    # The hifi caster under analytic_normals and sun_shadows is the proxy
    # roster's, as in JAX: RGB and labels equal the proxy caster's.
    n = ANALYTIC_HIFI_FRAMES
    hifi = meshcast.HifiCaster(roster, grid_hw=(RES, RES))
    inp = pipe.sample_inputs(SEED, range(n))
    w4 = world_mod.build_world(roster, inp.pose)
    outs = [annotate.render_frame(roster, c, pipe.sweeper, w4, inp.cam_pos, inp.target,
                                  pipe.intr, inp.lighting, far_clip=far, analytic_normals=True,
                                  sun_shadows=True) for c in (hifi, caster)]
    same = [f for f in outs[0]._fields if torch.equal(getattr(outs[0], f), getattr(outs[1], f))]
    phase("analytic", f"hifi caster, {n} x {RES}^2, analytic_normals and sun_shadows: fields "
          f"equal to the proxy caster's {len(same)} of {len(outs[0]._fields)} (rgb and labels)")
    check(len(same) == len(outs[0]._fields), f"hifi analytic render differs from the proxy's: "
          f"equal {same}")
    del outs

    # Device times: each variant beside the default kernel in one window,
    # its plain version, its bound; the registers of every instantiation.
    regs = kernels.ptxas_report("rgb.cu")
    default_fn = lambda: rgb_kernel.rgb_cuda(t, inst, table, ao, par_on)
    for v in rgb_kernel.VARIANTS:
        kw = rgb_tier_args(v, texels, normal, shadow_t)
        k_fn = lambda: rgb_kernel.rgb_cuda(t, inst, table, ao, par_on, **kw)
        ms, default_ms = device_ms_window([(k_fn, kernel_key(v)),
                                           (default_fn, "rgb_kernel<false, 0>")])
        b_ms, b_by, ops, nbytes = rgb_variant_bound(v, t, inst, table, ao, par_on, texels,
                                                    kw["normal"], kw["shadow_t"])
        r = regs[kernel_key(v)]
        variants[v].update(ms=ms, default_ms=default_ms, call_ms=cuda_ms(k_fn),
                           plain_ms=cuda_ms(lambda: rgb_kernel.plain_rgb(
                               t, inst, table, ao, par_on, **kw), iters=2, warmup=1),
                           bound_ms=b_ms, bound_by=b_by, registers=r["registers"],
                           spill_bytes=r["spill_bytes"])
        phase("time", f"rgb {v}: kernel {ms:.4f} ms device time (default kernel {default_ms:.4f} "
              f"ms in the same window; call {variants[v]['call_ms']:.4f} ms), plain "
              f"{variants[v]['plain_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}: {ops:.4e} "
              f"operations, {nbytes / 1e6:.1f} MB; roofline share {100 * b_ms / ms:.1f}%), "
              f"{r['registers']} registers, {r['spill_bytes']} bytes of spill stores; "
              f"{B} x {RES}^2 on {card}")
    d0 = regs["rgb_kernel<false, 0>"]
    phase("analytic", f"registers a thread (spill stores): " + ", ".join(
        f"{k} {x['registers']} ({x['spill_bytes']} B)" for k, x in sorted(regs.items())))
    check(d0 == {"registers": 32, "spill_bytes": 0},
          f"the default RGB kernel left 32 registers and no spills: {d0}")
    return launches, variants, casters


def row_meets(table, world, ray_o, ray_d):
    """(S,) int64: for each row of ``table`` (a ``raycast.SweepTable``) the
    rays of ray_d (B, N, 3), from ray_o (B, 3) or per ray (B, N, 3), whose
    half-line meets the row's bounding sphere (``raycast.needed_rows``, on
    ``table.radii``): the pairs a walk needs, whatever it culls. Frame by
    frame on the card."""
    import torch
    from constructionsceneposeestimation_tpu_torch.render import raycast
    meets = torch.zeros(len(table.rows), dtype=torch.int64, device=ray_d.device)
    for b in range(ray_d.shape[0]):
        meets += raycast.needed_rows(table, {"prim_pos": world["prim_pos"][b:b + 1]},
                                     ray_o[b:b + 1], ray_d[b:b + 1])[0].sum(0)
    return meets


def cull_report(tag, wrapper, table, world, ray_o, ray_d, sky=None):
    """The kernel's bundle cull on one call of ``wrapper`` (a caster
    wrapper, its ``kept`` output filled): every warp must keep each row that
    one of its rays needs (``raycast.needed_rows``); its kept sets against
    ``raycast.bundle_cull_plain``'s (equal on > 0.99 of the warps: the
    mirror's sums and transcendentals round otherwise at the margins); rows
    kept a ray, beside those a ray needs; the share of warps that keep
    every row, and with ``sky`` (B, N) bool, of the warps that mix rays
    from the camera (sky pixels) with rays from surfaces. Printed;
    returns the numbers and whether the cull held."""
    import torch
    from constructionsceneposeestimation_tpu_torch.render import raycast
    B, N = ray_d.shape[:2]
    S = len(table.rows)
    kept = raycast.kept_buffer(table, ray_d)
    wrapper(table, world, ray_o, ray_d, kept=kept)
    keep = raycast.kept_rows(kept, S)  # (B, W, S)
    W = keep.shape[1]
    lanes = torch.full((W,), raycast.WARP, device=ray_d.device)
    lanes[-1] = N - (W - 1) * raycast.WARP
    radii = table.radii_on(ray_d.device)
    missing = needed = same = 0
    for b in range(B):
        wb = {"prim_pos": world["prim_pos"][b:b + 1]}
        ro = ray_o[b:b + 1]
        rd = ray_d[b:b + 1]
        need = raycast.needed_rows(table, wb, ro, rd)
        needed += int(need.sum())
        need_w = raycast._warps(need, W).any(2)[0]  # (W, S)
        missing += int((need_w & ~keep[b]).sum())
        same += int((raycast.bundle_cull_plain(table, radii, wb, ro, rd)[0] == keep[b])
                    .all(-1).sum())
    rows = keep.sum(-1)  # (B, W)
    kept_a_ray = float((rows * lanes).sum()) / (B * N)
    every = float((rows == S).float().mean())
    r = {"rows_kept_a_ray": kept_a_ray, "rows_needed_a_ray": needed / (B * N),
         "warps_keeping_every_row": every, "cull_equal_to_mirror": same / (B * W),
         "needed_rows_dropped": missing}
    line = (f"{tag}: bundle cull keeps {kept_a_ray:.3f} rows a ray of {S} (needs "
            f"{r['rows_needed_a_ray']:.3f}); {100 * every:.3f}% of the {B * W} warps keep every "
            f"row")
    if sky is not None:
        s_w = raycast._warps(sky, W)
        mixed = s_w.any(2) & ~s_w.all(2)
        r["mixed_warps"] = float(mixed.float().mean())
        r["rows_kept_mixed_warp"] = float(rows[mixed].float().mean()) if mixed.any() else 0.0
        r["rows_kept_other_warp"] = float(rows[~mixed].float().mean())
        line += (f"; {100 * r['mixed_warps']:.3f}% of the warps mix camera and surface origins "
                 f"and keep {r['rows_kept_mixed_warp']:.2f} rows, the others "
                 f"{r['rows_kept_other_warp']:.2f}")
    phase("raycast", line + f"; needed (ray, row) pairs the cull dropped: {missing} (0); kept "
          f"sets equal to raycast.bundle_cull_plain's on {r['cull_equal_to_mirror']:.6f} of the "
          f"warps (> 0.99)")
    return r, missing == 0 and r["cull_equal_to_mirror"] > 0.99


def raycast_bound(table, meets, n_rays, nbytes, mode, hits=0):
    """(bound_ms, bound_by, operations, brute-force bound_ms) of
    csrc/raycast.cu's function of ``table`` over ``n_rays`` rays in
    ``mode`` (``RAYCAST_MODES``), moving ``nbytes``: each needed (ray, row)
    pair (``meets`` (S,), from ``row_meets``) its row's RAYCAST_ROW_OPS, a
    generic row its local direction (and origin per ray), the merge; a
    packed ray its shared terms, an exact hit its normal. The brute-force
    bound charges every (ray, row) pair, as this walk tests them."""
    ops = brute = 0
    for op, n in zip(table.rows[:, 0].tolist(), meets.tolist()):
        pair = RAYCAST_ROW_OPS[op] + RAYCAST_MERGE_OPS
        if op <= 5:
            pair += RAYCAST_LOCAL_OPS + (RAYCAST_ORIGIN_OPS if mode == RAYCAST_MULTI else 0)
        ops += n * pair
        brute += n_rays * pair
    own = (n_rays * RAYCAST_RAY_OPS if mode == RAYCAST_PACKED else 0) + hits * RAYCAST_NORMAL_OPS
    return (*bound(nbytes, ops + own), ops + own, bound(nbytes, brute + own)[0])


def packed_equal(tag, k, p):
    """Two (B, N) f32 sweeps (packed, or t), bit for bit: printed; returns
    the share of values that differ."""
    import torch
    differ = (k.view(torch.int32) != p.view(torch.int32)).float().mean().item()
    phase("raycast", f"{tag}: {k.numel()} values, bit-equal to the plain version on "
          f"{1.0 - differ:.6f} (all)")
    return differ


def exact_equal(tag, k, p):
    """Two exact casts (``Raycaster.cast``'s dicts): t, prim and inst bit for
    bit, the normal's bit-equal share and max |d| on the hits; printed.
    Returns (every t, prim and inst equal, normal max |d|)."""
    import torch
    same = {f: bool(torch.equal(k[f].view(torch.int32) if f == "t" else k[f],
                                p[f].view(torch.int32) if f == "t" else p[f]))
            for f in ("t", "prim", "inst")}
    hit = torch.isfinite(p["t"])
    dn = torch.abs(k["normal"] - p["normal"]).amax(-1)
    share = (dn[hit] == 0).float().mean().item()
    err = dn.max().item()
    phase("raycast", f"{tag}: {hit.numel()} rays, {int(hit.sum())} hits; bit-equal to the plain "
          f"version: t {same['t']}, prim {same['prim']}, inst {same['inst']}; normal bit-equal "
          f"on {share:.6f} of the hits, max |d| {err:.3e} (<= 1e-6)")
    return all(same.values()), err


def plain_multi_packed(caster, world, ray_o, ray_d):
    """``Raycaster.plain_multi_origin``'s packed values: the plain
    per-origin walk, ``EXACT_RAYS`` rays at a time."""
    import torch
    from constructionsceneposeestimation_tpu_torch.render import raycast
    return torch.cat([raycast.multi_sweep(caster.kind_table, world, ray_o[:, s], ray_d[:, s])
                      for s in raycast._blocks(*ray_d.shape[:2])], dim=1)


def casts_agree(tag, a, b, n_px):
    """Card against CPU casts ({t, inst[, prim, normal]}) of rays whose
    first ``n_px`` a frame are pixel rays and the rest keypoint segments:
    hits and instances on > 0.999 of the pixel rays and > 0.99 of the
    segments, t to rtol 3e-4 on the same share of the common hits; normals
    within 1e-5 on > 0.98 of the common pixel hits and 1e-2 on all (the
    tolerances of tests/test_torch_raycast.py and test_torch_analytic.py).
    Returns the stats and whether they hold."""
    import torch
    stats, ok = {}, True
    for part, sl, bar in (("pixels", slice(0, n_px), 0.999), ("segments", slice(n_px, None), 0.99)):
        ta, tb = a["t"][:, sl].cpu(), b["t"][:, sl]
        if ta.numel() == 0:
            continue
        ha, hb = torch.isfinite(ta), torch.isfinite(tb)
        both = ha & hb
        hit = (ha == hb).float().mean().item()
        close = (torch.abs(ta - tb) <= 3e-4 * torch.abs(tb))[both].float().mean().item()
        inst = (a["inst"][:, sl].cpu() == b["inst"][:, sl])[both].float().mean().item()
        stats.update({f"{part} hit": hit, f"{part} t": close, f"{part} inst": inst})
        ok = ok and hit > bar and close > bar and inst > bar
        if "normal" in a and part == "pixels":
            dn = torch.abs(a["normal"][:, sl].cpu() - b["normal"][:, sl]).amax(-1)[both]
            stats["normal > 1e-5"] = (dn > 1e-5).float().mean().item()
            stats["normal max"] = dn.max().item()
            ok = ok and stats["normal > 1e-5"] < 0.02 and stats["normal max"] < 1e-2
    phase("raycast", f"card vs CPU, {tag}: " + ", ".join(f"{k} {v:.6g}" for k, v in stats.items()))
    return ok


def raycast_phase(dev, card):
    """``[raycast]``: csrc/raycast.cu in its three modes against the plain
    walks on the card, on the same inputs: its instantiations' registers,
    none spilling; the exact cast of 64 x 512^2
    pixel rays (t, prim and inst bit-equal, normals within 1e-6), the
    shadow rays from its hits toward the sun (every packed value
    bit-equal), the packed sweep of those pixel rays, of the keypoint
    segments of a 512-frame ``bench`` batch (and their exact cast) and of
    both on the hifi tier's masked ``base`` roster; the exclusion
    (``occlusion_ts``: the pixel rays past their first instance, the
    segments past their own, t bit-equal, one exact launch each; the
    masked roster's too); the bundle cull of each mode and of the masked
    segments (``cull_report``: no needed row dropped, the mirror's sets,
    rows kept a ray beside those needed, warps keeping every row, the
    shadow warps mixing sky and surface); a duplicated primitive
    resolving to the first index in the kernel and in the plain version
    (and ``torch.min``'s own tie rule); the card against the CPU at 4 x
    128^2; each mode's device time, its wrapper's call and the plain
    version, beside its bound of the needed (ray, row) pairs and the
    brute-force bound; the launches of one segment sweep, kernel and plain, and of a 64-frame
    generate batch. Returns the kernels line's numbers of each mode."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    from constructionsceneposeestimation_tpu_torch.config import Config, PipelineConfig
    from constructionsceneposeestimation_tpu_torch.core import camera as cam_mod
    from constructionsceneposeestimation_tpu_torch.parallel.pipeline import Pipeline
    from constructionsceneposeestimation_tpu_torch.render import meshcast, raycast
    from constructionsceneposeestimation_tpu_torch.scene import assets, world as world_mod
    from constructionsceneposeestimation_tpu_torch.utils import kernels

    regs = kernels.ptxas_report("raycast.cu")
    phase("raycast", f"csrc/raycast.cu, registers and spill bytes (ptxas): {regs}")
    check(set(regs) == set(RAYCAST_KERNEL.values())
          and all(r["spill_bytes"] == 0 for r in regs.values()),
          f"raycast.cu: an instantiation missing or spilling: {regs}")
    cfg = Config(pipeline=PipelineConfig(render_width=RES, render_height=RES, batch_size=B))
    pipe = Pipeline(cfg, device=dev)
    roster, caster = pipe.roster, pipe.caster
    base = meshcast.HifiCaster(roster, grid_hw=(RES, RES)).base
    inputs = pipe.sample_inputs(SEED, range(B))
    world = world_mod.build_world(roster, inputs.pose)
    cam = inputs.cam_pos.contiguous()
    px = cam_mod.pixel_rays(pipe.intr, cam_mod.look_at_matrix(cam, inputs.target))
    px = px.reshape(B, -1, 3).contiguous()
    ok, errs = True, {}

    # The exact cast of the pixel rays, then the shadow rays from its hits
    # as render_frame builds them.
    k, p = caster.cast(world, cam, px), caster.plain_cast(world, cam, px)
    same, errs[RAYCAST_EXACT] = exact_equal(f"exact, {B} x {RES}^2 pixel rays", k, p)
    ok = ok and same and errs[RAYCAST_EXACT] <= 1e-6
    hits = int(torch.isfinite(p["t"]).sum())
    sky = ~torch.isfinite(p["t"])
    first_inst = p["inst"]
    sun = -inputs.lighting.sun_dir
    shadow_o = (cam[:, None] + torch.where(torch.isfinite(p["t"]), p["t"], 0.0)[..., None] * px
                + (sun * 1e-3)[:, None]).contiguous()
    shadow_d = sun[:, None].expand(B, RES * RES, 3).contiguous()
    del k, p
    culls = {}
    culls[RAYCAST_EXACT], held = cull_report(f"exact, {B} x {RES}^2 pixel rays", raycast.exact_cuda,
                                             caster.kind_table, world, cam, px)
    ok = ok and held
    # The exclusion (occlusion_ts): each pixel ray past the instance it
    # hits first, against the plain exact walk with the same exclusion.
    before = raycast.exact_cuda.launches
    k = raycast.occlusion_ts(world, roster, cam, px, first_inst)
    p = torch.cat([raycast.exact_sweep(caster.kind_table, world, cam, px[:, sl], first_inst[:, sl])[0]
                   for sl in raycast._blocks(B, RES * RES)], dim=1)
    ok = ok and packed_equal(f"exclusion (occlusion_ts), {B} x {RES}^2 pixel rays past their "
                             f"first instance, t", k, p) == 0
    ok = ok and raycast.exact_cuda.launches == before + 1
    del k, p
    k = raycast.multi_cuda(caster.kind_table, world, shadow_o, shadow_d)
    ok = ok and packed_equal(f"multi, {B} x {RES}^2 shadow rays", k,
                             plain_multi_packed(caster, world, shadow_o, shadow_d)) == 0
    culls[RAYCAST_MULTI], held = cull_report(f"multi, {B} x {RES}^2 shadow rays",
                                             raycast.multi_cuda, caster.kind_table, world,
                                             shadow_o, shadow_d, sky)
    ok = ok and held
    lit = (raycast._unpack(k)[0] >= raycast.INF * 0.99).float().mean().item()
    ok = ok and packed_equal(f"packed, {B} x {RES}^2 pixel rays", caster.packed(world, cam, px),
                             caster.plain_packed(world, cam, px)) == 0
    ok = ok and packed_equal(f"packed, masked hifi base roster ({len(base.packed_table.rows)} of "
                             f"{roster.num_prims} rows), {B} x {RES}^2 pixel rays",
                             base.packed(world, cam, px), base.plain_packed(world, cam, px)) == 0
    del k

    # The keypoint segments of a bench batch.
    n = 512
    big = Pipeline(Config(pipeline=PipelineConfig(render_width=RES, render_height=RES,
                                                  batch_size=n)), device=dev)
    inp = big.sample_inputs(500, range(n))
    w = world_mod.build_world(roster, inp.pose)
    scam = inp.cam_pos.contiguous()
    kp = world_mod.world_keypoints(w["inst_rot"], w["inst_pos"], w["kpts_local"])
    seg = (kp.reshape(n, -1, 3) - scam[:, None]).contiguous()
    ok = ok and packed_equal(f"packed, {n} frames x {seg.shape[1]} keypoint segments",
                             caster.packed(w, scam, seg), caster.plain_packed(w, scam, seg)) == 0
    ok = ok and packed_equal(f"packed, masked hifi base roster, {n} x {seg.shape[1]} segments",
                             base.packed(w, scam, seg), base.plain_packed(w, scam, seg)) == 0
    same, err = exact_equal(f"exact, {n} x {seg.shape[1]} segments", caster.cast(w, scam, seg),
                            caster.plain_cast(w, scam, seg))
    ok = ok and same and err <= 1e-6
    errs[RAYCAST_EXACT] = max(errs[RAYCAST_EXACT], err)
    errs[RAYCAST_PACKED] = errs[RAYCAST_MULTI] = 0.0
    culls[RAYCAST_PACKED], held = cull_report(f"packed, {n} x {seg.shape[1]} segments",
                                              raycast.packed_cuda, caster.packed_table, w, scam,
                                              seg)
    ok = ok and held
    _, held = cull_report(f"packed, masked hifi base roster, {n} x {seg.shape[1]} segments",
                          raycast.packed_cuda, base.packed_table, w, scam, seg)
    ok = ok and held
    # The exclusion on the segments (each past its own instance, as the
    # keypoint occlusion test casts them) and on the masked roster.
    own = (torch.arange(seg.shape[1], device=dev) // kp.shape[2]).to(torch.int32).expand(n, -1)
    own = own.contiguous()
    before = raycast.exact_cuda.launches
    ok = ok and packed_equal(f"exclusion (occlusion_ts), {n} x {seg.shape[1]} segments past "
                             f"their own instance, t", raycast.occlusion_ts(w, roster, scam, seg, own),
                             raycast.exact_sweep(caster.kind_table, w, scam, seg, own)[0]) == 0
    ok = ok and raycast.exact_cuda.launches == before + 1
    t_plain = raycast.exact_sweep(base.kind_table, w, scam, seg, own)[0]
    ok = ok and packed_equal(f"exclusion, masked hifi base roster, {n} x {seg.shape[1]} segments, "
                             f"t", raycast.exact_cuda(base.kind_table, w, scam, seg, own)["t"],
                             torch.where(t_plain < raycast.INF, t_plain, float("inf"))) == 0
    check(ok, "raycast: a kernel mode disagrees with its plain version on the card")

    # A duplicated primitive: the last box made the first box's twin. The
    # exact cast must name the first wherever either is hit.
    boxes = [i for i, kd in enumerate(roster.prim_kind) if kd == assets.BOX]
    i, j = boxes[0], boxes[-1]
    wd = {key: v.clone() for key, v in world.items()}
    for key in ("prim_rot", "prim_pos"):
        wd[key][:, j] = wd[key][:, i]
    wd["prim_params"][j] = wd["prim_params"][i]
    g = torch.Generator(device=dev).manual_seed(SEED)
    aim = wd["prim_pos"][:, i, None] + torch.rand(B, 4096, 3, device=dev, generator=g) * 2 - 1
    dd = (aim - cam[:, None]).contiguous()
    kd, pd = caster.cast(wd, cam, dd)["prim"], caster.plain_cast(wd, cam, dd)["prim"]
    tie_v, tie_i = torch.min(torch.tensor([[[1.0, 2.0], [1.0, 0.5], [2.0, 0.5]]], device=dev),
                             dim=1)
    # PyTorch's order of summation over three elements on the card, which
    # the kernel's normal mirrors: (x0 + x2) + x1.
    x = torch.rand(1 << 20, 3, device=dev, generator=g) * torch.tensor([1.0, 1e-3, 1e3],
                                                                       device=dev)
    s3 = torch.sum(x, -1)
    orders = {"(x0 + x1) + x2": bool(torch.equal(s3, (x[:, 0] + x[:, 1]) + x[:, 2])),
              "(x0 + x2) + x1": bool(torch.equal(s3, (x[:, 0] + x[:, 2]) + x[:, 1]))}
    phase("raycast", f"torch.sum over rows of three on the card, 2^20 rows, equal to: {orders}")
    check(orders["(x0 + x2) + x1"], "torch.sum's order over three elements is not the kernel's")
    phase("raycast", f"duplicated primitive (box {j} made box {i}'s twin), {B} x 4096 rays at "
          f"it: kernel names box {i} on {(kd == i).float().mean().item():.4f}, box {j} on "
          f"{int((kd == j).sum())} rays; plain version {(pd == i).float().mean().item():.4f}, "
          f"{int((pd == j).sum())}; equal {bool(torch.equal(kd, pd))}; torch.min(dim=1) on the "
          f"card on ties: indices {tie_i.tolist()} of values {tie_v.tolist()} (first: [[0, 1]])")
    check(bool(torch.equal(kd, pd)) and not bool((kd == j).any()) and bool((kd == i).any())
          and tie_i.tolist() == [[0, 1]], "raycast: a tie did not resolve to the first index")
    del wd, kd, pd, dd, aim

    # The card against the CPU, 4 x 128^2: pixel rays then segments.
    small = Config(pipeline=PipelineConfig(render_width=SMALL_RES, render_height=SMALL_RES,
                                           batch_size=4))
    sp = Pipeline(small, device="cpu")
    inp_c = sp.sample_inputs(SEED, range(10, 14))
    w_c = world_mod.build_world(roster, inp_c.pose)
    px_c = cam_mod.pixel_rays(sp.intr, cam_mod.look_at_matrix(inp_c.cam_pos, inp_c.target))
    kp_c = world_mod.world_keypoints(w_c["inst_rot"], w_c["inst_pos"], w_c["kpts_local"])
    rays_c = torch.cat([px_c.reshape(4, -1, 3), kp_c.reshape(4, -1, 3) - inp_c.cam_pos[:, None]],
                       dim=1).contiguous()
    n_px = SMALL_RES * SMALL_RES
    w_d = {key: v.to(dev) for key, v in w_c.items()}
    cam_c, cam_d, rays_d = inp_c.cam_pos, inp_c.cam_pos.to(dev), rays_c.to(dev)
    cpu = raycast.Raycaster(roster)
    e_cpu = cpu.cast(w_c, cam_c, rays_c)
    ok = casts_agree("fast", caster.fast(w_d, cam_d, rays_d), cpu.fast(w_c, cam_c, rays_c), n_px)
    ok = casts_agree("cast", caster.cast(w_d, cam_d, rays_d), e_cpu, n_px) and ok
    so_c = (cam_c[:, None] + torch.where(torch.isfinite(e_cpu["t"]), e_cpu["t"], 0.0)[..., None]
            * rays_c + 1e-3 * torch.tensor([0.3, 0.2, 0.93])).contiguous()
    sd_c = torch.tensor([0.3, 0.2, 0.93]).expand_as(rays_c).contiguous()
    ok = casts_agree("fast_multi_origin", caster.fast_multi_origin(w_d, so_c.to(dev), sd_c.to(dev)),
                     cpu.fast_multi_origin(w_c, so_c, sd_c), n_px) and ok
    check(ok, "raycast: the card disagrees with the CPU")

    # Times: device time, the wrapper's call and the plain version, beside
    # the bound of the (ray, row) pairs these rays need and of brute force.
    calls = {
        RAYCAST_PACKED: (caster.packed_table, w, scam, seg,
                         lambda: raycast.packed_cuda(caster.packed_table, w, scam, seg),
                         lambda: caster.plain_packed(w, scam, seg), 4, 0),
        RAYCAST_EXACT: (caster.kind_table, world, cam, px,
                        lambda: raycast.exact_cuda(caster.kind_table, world, cam, px),
                        lambda: caster.plain_cast(world, cam, px), 4 + 8 + 4 + 12, hits),
        RAYCAST_MULTI: (caster.kind_table, world, shadow_o, shadow_d,
                        lambda: raycast.multi_cuda(caster.kind_table, world, shadow_o, shadow_d),
                        lambda: caster.plain_multi_origin(world, shadow_o, shadow_d), 4, 0),
    }
    results = {}
    for mode, (table, wm, ro, rd, k_fn, p_fn, out_bytes, n_hits) in calls.items():
        rays = rd.shape[0] * rd.shape[1]
        sums = raycast.axis_sums(table, wm, ro) if mode == RAYCAST_PACKED else None
        nbytes = ((ro.numel() + rd.numel()) * 4 + rays * out_bytes + table.rows.size * 4
                  + (wm["prim_pos"].numel() + wm["prim_rot"].numel()
                     + wm["prim_params"].numel()) * 4 + (0 if sums is None else sums.numel() * 4))
        meets = row_meets(table, wm, ro, rd)
        b_ms, b_by, ops, brute_ms = raycast_bound(table, meets, rays, nbytes, mode, n_hits)
        ms = device_ms(k_fn, RAYCAST_KERNEL[mode])
        r = {"max_abs_err": errs[mode], "ms": ms,
             "ms_by": "cuda_events" if RAYCAST_KERNEL[mode] in EVENTS_TIMED else "profiler",
             "call_ms": cuda_ms(k_fn), "plain_ms": cuda_ms(p_fn, iters=2, warmup=1),
             "bound": (b_ms, b_by), "brute_force_bound_ms": brute_ms, "rays": rays,
             "pairs": rays * len(table.rows), "pairs_needed": int(meets.sum()),
             "registers": regs[RAYCAST_KERNEL[mode]]["registers"],
             "spill_bytes": regs[RAYCAST_KERNEL[mode]]["spill_bytes"], **culls[mode]}
        results[mode] = r
        phase("time", f"{mode}: kernel {r['ms']:.4f} ms (by {r['ms_by']}; the wrapper's call "
              f"{r['call_ms']:.4f} ms, CUDA events), plain {r['plain_ms']:.3f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}: {ops:.4e} operations, {nbytes / 1e6:.1f} MB; "
              f"{r['pairs_needed']:.4e} of the {r['pairs']:.4e} (ray, row) pairs needed, "
              f"{r['pairs_needed'] / rays:.2f} rows a ray; roofline share "
              f"{100 * b_ms / r['ms']:.1f}%), brute-force bound {brute_ms:.4f} ms "
              f"({100 * brute_ms / r['ms']:.1f}%), {r['registers']} registers, "
              f"{r['spill_bytes']} bytes of spill stores; on {card}")
    phase("raycast", f"lit share of the {B} x {RES}^2 shadow rays {lit:.4f}")

    # Launches of one segment sweep, kernel path and plain, and of a
    # 64-frame generate batch: in each of two windows of 3 calls after a
    # warm-up step, the larger (the profiler drops some records).
    counts = {}
    for name, fn in (("segments, Raycaster.packed", lambda: caster.packed(w, scam, seg)),
                     ("segments, plain_packed", lambda: caster.plain_packed(w, scam, seg)),
                     (f"generate {B} x {RES}^2", lambda: pipe.make_generate_fn()(SEED, range(B)))):
        totals = []
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=2),
                     on_trace_ready=lambda p: totals.append(sum(
                         e.count for e in p.key_averages()
                         if e.device_type == torch.autograd.DeviceType.CUDA))) as prof:
            for _ in range(4):
                for _ in range(3):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        check(len(totals) == 2, f"{name}: {len(totals)} profiled windows, not 2")
        counts[name] = max(totals) / 3
        phase("raycast", f"{name}: {totals} launches in two windows of 3 calls")
    phase("raycast", "CUDA launches (torch.profiler): " + ", ".join(
        f"{k} {v}" for k, v in counts.items()) + f" on {card}")
    results[RAYCAST_PACKED]["segment_call_launches"] = counts["segments, Raycaster.packed"]
    results[RAYCAST_PACKED]["segment_plain_launches"] = counts["segments, plain_packed"]
    results[RAYCAST_PACKED]["generate_batch_launches"] = counts[f"generate {B} x {RES}^2"]
    return results


def distributed_phase(card):
    """``tools/check_sharded_step.py`` under ``torch.distributed.run`` on this
    card: 2 ranks on cuda:0 over gloo (the dry run: its FSDP step and the
    sharded generate bit-equal to the per-chunk single-device rows; DDP and
    FSDP steps, focal, against the single-process step), then 1 rank over
    NCCL (the same). Each step: its loss to 1e-5 relative, the parameters
    after 2 steps to 1e-5 on 99% of the weights and all within 2 lr. A rank
    that fails fails the phase. Returns the per-case records."""
    import os
    import signal
    import socket

    import torch
    torch.cuda.empty_cache()
    records = []
    for n, backend in ((2, "gloo"), (1, "nccl")):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", str(n),
               "--master_addr", "localhost", "--master_port", str(port),
               str(ROOT / "tools" / "check_sharded_step.py"), "--device", "cuda:0", "--backend",
               backend, "--dryrun", "--cases", DIST_CASES[backend]]
        t0 = time.time()
        proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True, start_new_session=True)
        try:
            out, _ = proc.communicate(timeout=DIST_TIMEOUT)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
            raise SmokeFailure(f"[distributed] {n} rank(s) over {backend}: no end in "
                               f"{DIST_TIMEOUT} s")
        lines = out.splitlines()
        recs = [json.loads(ln) for ln in lines if ln.startswith("{")]
        cases = [r for r in recs if "case" in r]
        dry = [ln for ln in lines if ln.startswith("dryrun_multigpu(")]
        for ln in dry:
            phase("distributed", f"{n} rank(s) over {backend} on cuda:0: {ln}")
        for r in cases:
            phase("distributed", f"{n} rank(s) over {backend}: {r['case']} rank {r['rank']}: "
                  f"loss rel {r['loss_rel']}, params max |d| {r['param_max_abs']:.3e}, > 1e-5 on "
                  f"{r['param_share_over_1e-5']:.5f} of {r['n_params']} (<= 1e-5 rel, <= 0.01, "
                  f"<= 2e-3): ok {r['ok']}")
        want = len(DIST_CASES[backend].split(",")) * n
        ok = (proc.returncode == 0 and len(cases) == want and all(r["ok"] for r in cases)
              and len(dry) == 2 and "bit-identical" in dry[1])
        if not ok:
            print("\n".join(lines[-60:]), file=sys.stderr, flush=True)
        check(ok, f"[distributed] {n} rank(s) over {backend}: exit {proc.returncode}, "
              f"{len(cases)} of {want} case records")
        phase("distributed", f"{n} rank(s) over {backend}: passed in {time.time() - t0:.1f} s "
              f"(torch.distributed.run, workers' start included) on {card}")
        records += cases
    return records


def bench_kernels_vs_plain(pipe, gen, dev, card, chunk=B):
    """The sweep, RGB and heatmap kernels on one batch at ``bench``'s shape
    (``pipe``'s batch of 512 x 512^2), each held against its plain version
    run on the same inputs in chunks of ``chunk`` frames, to the bars of
    the [sweep], [rgb] (hash noise off) and [heatmap] phases. The inputs
    are built as in those phases; the heatmaps' come from one generate
    call at this batch."""
    import torch
    from constructionsceneposeestimation_tpu_torch.core import camera as cam_mod
    from constructionsceneposeestimation_tpu_torch.ops import heatmap as hm
    from constructionsceneposeestimation_tpu_torch.render import raycast, rgb_kernel, sweep_kernel
    from constructionsceneposeestimation_tpu_torch.scene import world as world_mod

    n, intr = pipe.cfg.pipeline.batch_size, pipe.intr
    check(intr.height == intr.width == RES, f"bench frames are not {RES}^2")
    ids = list(range(n))
    parts = [slice(i, i + chunk) for i in range(0, n, chunk)]
    inputs = pipe.sample_inputs(500, ids)
    world = world_mod.build_world(pipe.roster, inputs.pose)
    M = cam_mod.look_at_matrix(inputs.cam_pos, inputs.target)
    batched = ("prim_rot", "prim_pos", "inst_rot", "inst_pos", "kpts_local")

    def part(sl):
        return {k: v[sl] if k in batched else v for k, v in world.items()}

    si, sf, radii = pipe.sweeper.schedule(dev)
    packed = sweep_kernel.sweep_cuda(si, sf, world, inputs.cam_pos, M, intr, radii)
    plain = torch.cat([sweep_kernel.plain_pixel_sweep(pipe.caster, part(sl), inputs.cam_pos[sl],
                                                      M[sl], intr) for sl in parts])
    tk, ck, tp, cp, same = sweep_agreement("bench", packed, plain)
    sweep_err = torch.abs(tk - tp)[same].max().item()
    del packed, plain, tk, ck, same

    t = torch.where(tp < raycast.INF * 0.99, tp, float("inf")).reshape(n, RES, RES)
    inst = (cp - 2).reshape(n, RES, RES)
    del tp, cp
    rd = cam_mod.pixel_rays(intr, M)
    clipped = (t * torch.sum(rd * (-M[:, :, 0])[:, None, None, :], dim=-1)
               >= pipe.cfg.camera.clipping[1])
    del rd
    t = torch.where(clipped, float("inf"), t).contiguous()
    inst = torch.where(clipped, -2, inst).to(torch.int32).contiguous()
    table = rgb_kernel.instance_table(pipe.roster, world["inst_rot"], world["inst_pos"])
    ao = rgb_kernel.ao_table(pipe.roster, world["inst_pos"])
    lit = inputs.lighting._replace(tex_strength=torch.zeros_like(inputs.lighting.tex_strength))
    par = rgb_kernel.rgb_params(M, inputs.cam_pos, intr, lit)
    rk = rgb_kernel.rgb_cuda(t, inst, table, ao, par)
    rp = torch.cat([rgb_kernel.plain_rgb(t[sl], inst[sl], table[sl], ao[sl], par[sl])
                    for sl in parts])
    sky = inst == -2
    sky_exact = bool(torch.equal(rk[sky], rp[sky]))
    d = torch.abs(rk.float() - rp.float())
    mean_d, over_1, rgb_err = d.mean().item(), (d > 1).float().mean().item(), d.max().item()
    del rk, rp, d, t, inst, sky
    phase("bench", f"rgb kernel at {n} x {RES}^2 against the plain version in chunks of "
          f"{chunk}, noise off: mean |d| {mean_d:.4f} u8 (< 0.5), |d| > 1 on {over_1:.5f} "
          f"(< 0.02), sky exact {sky_exact}, max |d| {rgb_err:.0f}")
    check(mean_d < 0.5 and over_1 < 0.02 and sky_exact,
          f"rgb kernel disagrees with its plain version at {n} frames (noise off)")

    fb = gen(600, ids)
    kc = pipe.roster.tensor("inst_kpt_channel", dev).reshape(1, -1).expand(n, -1)
    uv = fb.kpt_uv.reshape(n, -1, 2).contiguous()
    vis = (fb.kpt_visible.reshape(n, -1) & (kc >= 0)).contiguous()
    ch = torch.clamp_min(kc, 0).to(torch.int32).contiguous()
    del fb
    stride = pipe.cfg.pipeline.heatmap_stride
    rest = (pipe.num_channels, RES // stride, RES // stride, pipe.cfg.pipeline.heatmap_sigma,
            stride)
    hk = hm.heatmap_cuda(uv, ch, vis, *rest)
    hm_err = max(torch.abs(hk[sl] - hm.render_heatmaps(uv[sl], ch[sl], vis[sl], *rest)).max()
                 .item() for sl in parts)
    phase("bench", f"heatmap kernel at {tuple(hk.shape)} against the plain version in chunks "
          f"of {chunk}: max |d| {hm_err:.2e} (< 2e-4); sweep max |d| on same-instance hits "
          f"{sweep_err:.3e} on {card}")
    check(hm_err < 2e-4, f"heatmap kernel disagrees with its plain version at {n} frames")


def draws_phase(dev, card):
    """``[draws]``: the replay kernel (csrc/draws.cu) at the i.i.d. cells'
    shape (512 frames, 52 scene groups) and the training step's (32 frames
    and their camera-mix coins): its registers and spills (ptxas), its
    tensors bit-equal to the host loop's (``replay.host_draws``) at two
    seeds and ids beyond 10^6, one launch a ``sample_inputs``, its device
    time (profiler; CUDA events behind a sleep) and its wrapper's call,
    ``Pipeline._replayed_draws`` and ``sample_inputs`` beside the host loop
    they replaced (``_host_draws``, the CPU path's), host ms from an idle
    card, and its bounds: the bytes it moves, and the seeding chain.
    Returns the kernel's row of the kernels' JSON line."""
    import torch
    from constructionsceneposeestimation_tpu_torch.config import Config
    from constructionsceneposeestimation_tpu_torch.parallel.pipeline import Pipeline
    from constructionsceneposeestimation_tpu_torch.sample import replay
    from constructionsceneposeestimation_tpu_torch.utils import kernels

    regs = kernels.ptxas_report("draws.cu")
    phase("draws", f"csrc/draws.cu, registers and spill bytes (ptxas): {regs}")
    check(regs and all(r.get("spill_bytes", 0) == 0 for r in regs.values()),
          f"draws kernel: {regs}")
    pipe = Pipeline(Config(), device=dev)
    lay, cfg = pipe.word_layout, pipe.cfg
    cad = cfg.randomization.cadence_frames

    def batch(fids):
        groups = sorted({f // cad for f in fids})
        gidx = [groups.index(f // cad) for f in fids]
        table = [v for row in lay.table for v in row]
        ids = torch.tensor(table + fids + groups, dtype=torch.int32, device=dev)
        return groups, gidx, ids.split([len(table), len(fids), len(groups)])

    cases = []
    for n, coins, first in ((DRAWS_FRAMES, False, 0), (DRAWS_FRAMES, False, 10**6 + 3),
                            (32, True, 3205)):
        fids = list(range(first, first + n))
        groups, _, (table, fid, gid) = batch(fids)
        for seed in (SEED, 2**40 + 7):
            out = replay.replay_cuda(lay, seed, table, fid, gid, coins)
            host = replay.host_draws(seed, fids, groups, cad, cfg.scene, cfg.randomization,
                                     coins)
            same = list(out) == list(host) and all(torch.equal(out[k].cpu(), v)
                                                   for k, v in host.items())
            check(same, f"draws: the kernel differs from the host loop ({n} frames from "
                  f"{first}, seed {seed}, coins {coins})")
            cases.append(f"{n} frames from {first} ({len(groups)} groups{', coins' if coins else ''}) "
                         f"at seed {seed}")
    before = replay.replay_cuda.launches
    for s in range(3):
        pipe.sample_inputs(s, range(DRAWS_FRAMES))
    launched = replay.replay_cuda.launches - before
    phase("draws", f"bit-equal to the host loop (replay.host_draws): {'; '.join(cases)}; "
          f"launches in 3 sample_inputs calls: {launched}")
    check(launched == 3, f"draws: {launched} launches in 3 sample_inputs calls")

    fids = list(range(DRAWS_FRAMES))
    groups, gidx, (table, fid, gid) = batch(fids)
    call = lambda: replay.replay_cuda(lay, SEED, table, fid, gid, False)
    ms = device_ms(call, "draws_kernel", iters=20)
    events_ms, _ = events_device_ms(call, iters=20)
    call_ms = cuda_ms(call, iters=20)

    def host_ms(fn, reps=5):
        out = []
        for s in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(100 + s)
            out.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        return sorted(out)[reps // 2]

    replayed = host_ms(lambda s: pipe._replayed_draws(s, fids, groups, gidx, None, False))
    loop = host_ms(lambda s: pipe._host_draws(s, fids, groups, gidx, None, False))
    sample = host_ms(lambda s: pipe.sample_inputs(s, fids))
    nbytes = 4 * (len(groups) * lay.floats + len(fids) * replay.FRAME_WORDS
                  + len(lay.table) * replay.SEG_COLS + len(fids) + len(groups))
    bytes_ms = bound(nbytes, 0)[0]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True)
    mhz = float(smi.stdout.split()[0]) if smi.returncode == 0 else float("nan")
    chain_ms = DRAWS_CHAIN * DRAWS_STEP_CYCLES / (mhz * 1e3)
    phase("time", f"{DRAWS}: kernel {ms:.4f} ms (profiler device time; {events_ms:.4f} ms by CUDA "
          f"events behind a sleep; the wrapper's call {call_ms:.4f} ms) for {len(groups)} scene "
          f"groups ({lay.words} words each) and {len(fids)} frames ({replay.FRAME_WORDS} words); "
          f"host ms from an idle card, median of 5: the card's draws (ids, copy, launch) "
          f"{replayed:.3f}, the host loop they replaced {loop:.3f}, sample_inputs {sample:.3f}; "
          f"bounds: bytes {bytes_ms:.6f} ms ({nbytes} B), the seeding chain {chain_ms:.4f} ms "
          f"({DRAWS_CHAIN} steps x {DRAWS_STEP_CYCLES} cycles at {mhz:.0f} MHz, an estimate): "
          f"{100 * chain_ms / ms:.1f}% of the chain's floor, on {card}")
    return {"name": DRAWS, "route": "cuda",
            "source": "constructionsceneposeestimation_tpu_torch/csrc/draws.cu",
            "replaces": DRAWS_REPLACES, "ms": ms, "events_ms": events_ms, "call_ms": call_ms,
            "plain_ms": loop, "replayed_draws_ms": replayed, "sample_inputs_ms": sample,
            "bound_ms": max(bytes_ms, chain_ms), "bound_by": "the seeding chain (latency)",
            "bytes_bound_ms": bytes_ms, "registers": regs, "library_ms": None}


def bench_phase(dev, card, counters, datagen):
    """``[bench]``: the port's ``bench`` command in-process through the CLI's
    parser, at the JAX benchmark's shape (a warm-up chain of 4 steps, then
    4 timed steps of 512 x 512^2): its one JSON line (metric, unit, a finite
    positive value, ``vs_baseline`` = round(value / 0.15, 1)), the sweep,
    RGB and heatmap kernels launched once a generate call (8) and nothing
    else; frames/s by CUDA events and by the host clock, ms a step and the
    peak memory. Then, at the same shape: ``Pipeline.sample_inputs``'s host
    ms and the host ms to issue a whole step, one step under
    ``torch.profiler`` (device time, launches, the device's busy share, the
    kernels that take most), one step under
    ``torch.cuda.set_sync_debug_mode("warn")`` (each synchronising call and
    where), and a ``Stopwatch`` over a 64-frame generate chained on the
    card. Between them the three kernels, at the command's shape, against
    their plain versions (``bench_kernels_vs_plain``). Returns the
    command's launches."""
    import warnings

    import torch
    from torch.profiler import ProfilerActivity, profile
    from constructionsceneposeestimation_tpu_torch import bench, cli
    from constructionsceneposeestimation_tpu_torch.config import Config, PipelineConfig
    from constructionsceneposeestimation_tpu_torch.parallel.pipeline import Pipeline
    from constructionsceneposeestimation_tpu_torch.sample import replay
    from constructionsceneposeestimation_tpu_torch.utils import profiling

    args = cli.build_parser().parse_args(["bench"])
    torch.cuda.synchronize()
    held_gb = torch.cuda.memory_allocated() / 1e9
    out = io.StringIO()
    reset(counters)
    draws_before = replay.replay_cuda.launches
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        res = args.fn(args)
    wall_s = time.perf_counter() - t0
    got = read(counters)
    draws = replay.replay_cuda.launches - draws_before
    lines = out.getvalue().splitlines()
    phase("bench", f"`cli bench` printed {len(lines)} line(s): {' | '.join(lines)}")
    check(len(lines) == 1, "bench printed other than one line")
    rec = json.loads(lines[0])
    check(list(rec) == ["metric", "value", "unit", "vs_baseline"]
          and rec["metric"] == bench.METRIC and rec["unit"] == "frames/s",
          f"bench line: {rec}")
    check(isinstance(rec["value"], float) and math.isfinite(rec["value"]) and rec["value"] > 0,
          f"bench value {rec['value']}")
    check(rec["vs_baseline"] == round(rec["value"] / bench.REFERENCE_FPS, 1),
          f"vs_baseline {rec['vs_baseline']} != round({rec['value']} / 0.15, 1)")
    calls = 2 * bench.STEPS
    once = (*datagen, RAYCAST_PACKED)
    stray = {k: c for k, c in got.items() if k not in once and c}
    phase("bench", f"launches over {calls} generate calls (warm-up and timed): "
          f"{ {k: got[k] for k in once} }, {DRAWS} {draws}; other kernels and variants: "
          f"{stray or 'none'}")
    check(draws == calls, f"bench: the replay kernel launched {draws} times in {calls} calls")
    check(all(got[k] == calls for k in once),
          f"bench: a datagen kernel did not launch once a generate call: {got}")
    check(not stray, f"bench launched another kernel or variant: {stray}")
    n, steps = res["batch"], res["steps"]
    check((n, steps, res["size"]) == (bench.BATCH, bench.STEPS, bench.SIZE),
          f"bench ran {n} x {res['size']}^2, {steps} steps")
    check(math.isfinite(res["total"]), "bench: the chain's scalar is not finite")
    phase("bench", f"{steps} chained steps of {n} x {bench.SIZE}^2: {res['ms']:.3f} ms by CUDA "
          f"events = {res['ms'] / steps:.3f} ms a step = {res['fps']:.1f} frames/s; host clock "
          f"{res['host_ms']:.3f} ms = {n * steps * 1000.0 / res['host_ms']:.1f} frames/s; peak "
          f"memory {res['peak_bytes'] / 1e9:.2f} GB (torch.cuda.max_memory_allocated over both "
          f"chains; {held_gb:.2f} GB held before by earlier phases); the command "
          f"{wall_s:.1f} s in all on {card}")

    cfg = Config(pipeline=PipelineConfig(render_width=bench.SIZE, render_height=bench.SIZE,
                                         batch_size=n))
    pipe = Pipeline(cfg, device=dev)
    gen = pipe.make_generate_fn()
    bench_kernels_vs_plain(pipe, gen, dev, card)
    ids = list(range(n))
    sample_ms, issue_ms = [], []
    for s in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.sample_inputs(100 + s, ids)
        torch.cuda.synchronize()
        sample_ms.append((time.perf_counter() - t0) * 1e3)
    for s in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        total = bench.consume(gen(200 + s, ids))
        issue_ms.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    phase("bench", f"host ms for sampling one batch of {n} (Pipeline.sample_inputs, "
          f"synchronised): {[round(x, 3) for x in sample_ms]}; host ms to issue one whole "
          f"step (generate and consume, from an idle card): {[round(x, 3) for x in issue_ms]} "
          f"on {card}")

    for s in range(2):  # the first cycle pays the profiler's start-up
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            total = bench.consume(gen(300 + s, ids))
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    step_ms = res["ms"] / steps
    ours = {name: sum(e.self_device_time_total for e in kern if name in e.key) / 1e3
            for name in ("sweep_kernel", "rgb_kernel<false, 0>", "heatmap_kernel")}
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]
    phase("bench", f"one step of {n} x {bench.SIZE}^2 under torch.profiler (second cycle): "
          f"{wall_ms:.1f} ms wall, device busy {busy_ms:.3f} ms = {100 * busy_ms / step_ms:.1f}% "
          f"of the chained step's {step_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}% of the "
          f"profiled wall), {sum(e.count for e in kern)} kernel launches; the datagen kernels "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in ours.items()) + "; most device time: "
          + "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3:.3f} ms x {e.count}"
                      for e in top) + f" on {card}")
    check(math.isfinite(float(total)), "profiled bench step: total not finite")

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            total = bench.consume(gen(400, ids))
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    where = {}
    for w in caught:
        if str(w.message).startswith("called a synchronizing"):
            key = f"{Path(w.filename).parent.name}/{Path(w.filename).name}:{w.lineno}"
            where[key] = where.get(key, 0) + 1
    phase("bench", f"one step under set_sync_debug_mode('warn'): {sum(where.values())} "
          f"synchronising call(s)" + (": " + ", ".join(f"{k} x{c}" for k, c in where.items())
                                      if where else ""))
    del total, pipe, gen

    small = Config(pipeline=PipelineConfig(render_width=RES, render_height=RES, batch_size=B))
    gen64 = Pipeline(small, device=dev).make_generate_fn()
    sw = profiling.Stopwatch()
    ms = sw.measure(f"generate {B} x {RES}^2, consumed", lambda acc: acc + bench.consume(
        gen64(SEED, range(B))) * 1e-12, n=4)
    check(math.isfinite(ms) and ms > 0, f"Stopwatch: {ms} ms")
    phase("bench", f"Stopwatch report (chained_ms, 4 steps after a warm-up, CUDA events) on "
          f"{card}: {sw.report()}")
    return got


def main() -> int:
    if not (ROOT / "constructionsceneposeestimation_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout; the port's package is missing", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; needs an NVIDIA GPU",
              file=sys.stderr)
        return 3

    from constructionsceneposeestimation_tpu_torch.config import Config, PipelineConfig
    from constructionsceneposeestimation_tpu_torch.eval import pipeline as ev
    from constructionsceneposeestimation_tpu_torch.models import pose_net
    from constructionsceneposeestimation_tpu_torch.ops import heatmap as hm
    from constructionsceneposeestimation_tpu_torch.ops import peak_kernel, preprocess
    from constructionsceneposeestimation_tpu_torch.parallel.pipeline import (
        FrameBatch, Pipeline, quality_stats)
    from constructionsceneposeestimation_tpu_torch.render import (annotate, raycast,
                                                                  rgb_kernel, sweep_kernel)
    from constructionsceneposeestimation_tpu_torch.core import camera as cam_mod
    from constructionsceneposeestimation_tpu_torch.scene import world as world_mod
    from constructionsceneposeestimation_tpu_torch.utils import kernels

    # 1. The card.
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    phase("card", f"{card} | torch {torch.__version__} | CUDA {torch.version.cuda} | "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    dev = torch.device("cuda", 0)

    # 2. Build.
    t0 = time.time()
    lib_path = kernels.build(verbose=True)
    kernels.library()
    phase("build", f"{lib_path.name} in {time.time() - t0:.1f} s")
    # 2b. [draws]: the replay kernel against the host loop, and its time.
    draws_row = draws_phase(dev, card)

    cfg = Config(pipeline=PipelineConfig(render_width=RES, render_height=RES, batch_size=B))
    pipe = Pipeline(cfg, device=dev)
    intr = pipe.intr
    fids = list(range(B))
    inputs = pipe.sample_inputs(SEED, fids)
    world = world_mod.build_world(pipe.roster, inputs.pose)
    M = cam_mod.look_at_matrix(inputs.cam_pos, inputs.target)
    results = {}

    # 3a. Pixel sweep vs the packed caster on pixel_rays.
    si, sf, radii = pipe.sweeper.schedule(dev)
    k_fn = lambda: sweep_kernel.sweep_cuda(si, sf, world, inputs.cam_pos, M, intr, radii)
    p_fn = lambda: sweep_kernel.plain_pixel_sweep(pipe.caster, world, inputs.cam_pos, M, intr)
    packed = k_fn()
    # With radii beyond any distance every tile keeps every row: the tile
    # cull must leave every bit of the packed min as the full walk has it.
    full = sweep_kernel.sweep_cuda(si, sf, world, inputs.cam_pos, M, intr,
                                   torch.full_like(radii, 1e15))
    cull_exact = bool(torch.equal(packed.view(torch.int32), full.view(torch.int32)))
    phase("sweep", f"tile-culled kernel bit-equal to the kernel with every row kept: "
          f"{cull_exact}")
    check(cull_exact, "the sweep's tile cull changed the result")
    tk, ck, tp, cp, same = sweep_agreement("sweep", packed, p_fn())
    hp = tp < raycast.INF * 0.99
    del packed, full
    # The bound charges the (ray, row) pairs these inputs need: each ray
    # its own cost plus, for every schedule row whose bounding sphere it
    # meets (the plane always), that row's kind. The brute-force walk's
    # count (every ray x every row) stands beside it.
    n_px = B * RES * RES
    kind_ops = torch.tensor([SWEEP_KIND_OPS[k] for k in range(9)], device=dev)[si[:, 0].long()]
    row_px, px_rows = sweep_kernel.needed_pairs(si, radii, world, inputs.cam_pos, M, intr)
    sweep_ops = n_px * SWEEP_RAY_OPS + int((row_px * kind_ops).sum())
    brute_ops = n_px * (SWEEP_RAY_OPS + int(kind_ops.sum()))
    sweep_bytes = (n_px * 4 + B * 16 * 4 + world["prim_pos"].numel() * 4 * 4
                   + si.numel() * 4 + sf.numel() * 4 + radii.numel() * 4)
    kept = sweep_kernel.tile_cull_plain(si, radii, world, inputs.cam_pos, M, intr).sum(-1).float()
    phase("sweep", f"rows kept per {sweep_kernel.TILE[0]} x {sweep_kernel.TILE[1]} tile (plain "
          f"mirror of the cull): mean {kept.mean().item():.2f}, max {int(kept.max())} of "
          f"{si.shape[0]}; rows met per ray: mean {px_rows.float().mean().item():.3f}, max "
          f"{int(px_rows.max())}; bound of the needed pairs {bound(sweep_bytes, sweep_ops)[0]:.4f}"
          f" ms ({sweep_ops:.4e} operations), brute-force bound "
          f"{bound(sweep_bytes, brute_ops)[0]:.4f} ms ({brute_ops:.4e} operations)")
    results["pixel_sweep"] = {"max_abs_err": torch.abs(tk - tp)[same].max().item(),
                              "ms": device_ms(k_fn, "sweep_kernel"), "call_ms": cuda_ms(k_fn),
                              "plain_ms": cuda_ms(p_fn, iters=2, warmup=1),
                              "bound": bound(sweep_bytes, sweep_ops)}
    del row_px, px_rows, kept

    # 3b. RGB epilogue vs the shading tier, noise off and on. Inputs as the
    # annotation pass builds them (far clip included).
    t = torch.where(hp, tp, float("inf")).reshape(B, RES, RES)
    inst = (cp - 2).reshape(B, RES, RES)
    rd = cam_mod.pixel_rays(intr, M)
    depth = t * torch.sum(rd * (-M[:, :, 0])[:, None, None, :], dim=-1)
    clipped = depth >= cfg.camera.clipping[1]
    t = torch.where(clipped, float("inf"), t).contiguous()
    inst = torch.where(clipped, -2, inst).to(torch.int32).contiguous()
    table = rgb_kernel.instance_table(pipe.roster, world["inst_rot"], world["inst_pos"])
    ao = rgb_kernel.ao_table(pipe.roster, world["inst_pos"])
    sky = inst == -2
    ground = inst == -1
    # The AO rows each ground pixel lies within reach of (the hit points do
    # not depend on the lighting): a row the kernel's cull wrongly dropped
    # would show on these pixels.
    needed = rgb_kernel.ao_rows_needed(t, inst, ao, rgb_kernel.rgb_params(
        M, inputs.cam_pos, intr, inputs.lighting))
    reach = needed > 0
    rgb_err = None
    for noise in (False, True):
        lit = inputs.lighting if noise else inputs.lighting._replace(
            tex_strength=torch.zeros_like(inputs.lighting.tex_strength))
        par = rgb_kernel.rgb_params(M, inputs.cam_pos, intr, lit)
        k_fn = lambda: rgb_kernel.rgb_cuda(t, inst, table, ao, par)
        p_fn = lambda: rgb_kernel.plain_rgb(t, inst, table, ao, par)
        rk, rp = k_fn().float(), p_fn().float()
        torch.cuda.synchronize()
        if noise:
            dm = abs(rk.mean().item() - rp.mean().item())
            ds = abs(rk.std().item() - rp.std().item())
            phase("rgb", f"noise on: |mean diff| {dm:.4f} (< 1.0), |std diff| {ds:.4f} (< 2.0)")
            check(dm < 1.0 and ds < 2.0, "rgb kernel statistics disagree (noise on)")
            rgb_bytes = (n_px * (4 + 4 + 3)
                         + 4 * (table.numel() + ao.numel() + par.numel()))
            n_ground = int(ground.sum())
            rgb_ops = rgb_default_ops(t, inst, ao, par)
            old_ops = n_px * RGB_PIXEL_OPS + n_ground * ao.shape[1] * RGB_AO_ROW_OPS
            kept = rgb_kernel.ao_cull_plain(t, inst, ao, par)  # (B, H, cells_x, A)
            cw = rgb_kernel.TILE[0]
            has_ground = ground.reshape(B, RES, RES // cw, cw).any(-1)
            kept_n = kept.sum(-1)[has_ground].float()
            need_g = needed[ground].float()
            phase("rgb", f"ground pixels {n_ground / n_px:.4f} of {n_px}; AO rows kept per "
                  f"{cw} x 1 cell with ground (plain mirror of the cull): mean "
                  f"{kept_n.mean().item():.3f}, max {int(kept_n.max())} of {ao.shape[1]} "
                  f"({int(has_ground.sum())} of {has_ground.numel()} cells); rows within reach "
                  f"per ground pixel: mean {need_g.mean().item():.3f}, max {int(need_g.max())}; "
                  f"bound of the needed work {bound(rgb_bytes, rgb_ops)[0]:.4f} ms "
                  f"({rgb_ops:.4e} operations), of every row on every ground pixel with three "
                  f"rays {bound(rgb_bytes, old_ops)[0]:.4f} ms ({old_ops:.4e} operations)")
            del needed, reach, kept
            results["rgb_epilogue"] = {"max_abs_err": rgb_err,
                                       "ms": device_ms(k_fn, "rgb_kernel<false, 0>"),
                                       "call_ms": cuda_ms(k_fn),
                                       "plain_ms": cuda_ms(p_fn, iters=2, warmup=1),
                                       "bound": bound(rgb_bytes, rgb_ops),
                                       "bound_all_rows_ms": bound(rgb_bytes, old_ops)[0]}
        else:
            d = torch.abs(rk - rp)
            sky_exact = bool(torch.equal(rk[sky], rp[sky]))
            d_reach = d.amax(-1)[reach]
            far_reach = (d_reach > 1).float().mean().item()
            phase("rgb", f"noise off: mean |d| {d.mean().item():.4f} u8 (< 0.5), |d| > 1 on "
                  f"{(d > 1).float().mean().item():.5f} (< 0.02), sky exact {sky_exact}; on the "
                  f"{d_reach.numel()} ground pixels within an AO row's reach: mean |d| "
                  f"{d_reach.mean().item():.4f} u8, |d| > 1 on {far_reach:.5f} (<= 1e-3)")
            check(d.mean().item() < 0.5 and (d > 1).float().mean().item() < 0.02 and sky_exact,
                  "rgb kernel disagrees with its plain version (noise off)")
            check(d_reach.numel() > 0 and far_reach <= 1e-3,
                  "rgb kernel disagrees with its plain version within the AO rows' reach")
            rgb_err = d.max().item()

    # 3c. Heatmap targets: the main path's keypoints, then the 768^2-input
    # shape (192^2 maps) and a sigma sweep at widths 128 and 192.
    ann = annotate.render_frame(pipe.roster, pipe.caster, pipe.sweeper, world, inputs.cam_pos,
                                inputs.target, intr, inputs.lighting)
    kc = pipe.roster.tensor("inst_kpt_channel", dev).reshape(1, -1).expand(B, -1)
    uv = ann.kpt_uv.reshape(B, -1, 2).contiguous()
    vis = (ann.kpt_visible.reshape(B, -1) & (kc >= 0)).contiguous()
    ch = torch.clamp_min(kc, 0).to(torch.int32).contiguous()
    C = pipe.num_channels
    worst = 0.0
    for scale, sigma in ((1.0, 2.0), (1.0, 1.7), (1.0, 2.7), (1.5, 2.0), (1.5, 1.7), (1.5, 2.7)):
        n = B if scale == 1.0 else 4  # 71 x 192^2 maps: 4 frames keep the plain version small
        w = int(RES * scale) // 4
        args = ((uv[:n] * scale).contiguous(), ch[:n], vis[:n], C, w, w, sigma, 4)
        err = torch.abs(hm.heatmap_cuda(*args) - hm.render_heatmaps(*args)).max().item()
        torch.cuda.synchronize()
        phase("heatmap", f"({n}, {C}, {w}, {w}) sigma {sigma}: max |d| {err:.2e} (< 2e-4)")
        check(err < 2e-4, f"heatmap kernel disagrees at width {w}, sigma {sigma}")
        worst = max(worst, err)
    args = (uv, ch, vis, C, RES // 4, RES // 4, cfg.pipeline.heatmap_sigma, 4)
    hm_px = (RES // 4) ** 2
    hm_out = B * C * hm_px * 4
    hm_bytes = hm_out + uv.numel() * 4 + ch.numel() * 4 + vis.numel()
    per_frame = vis.sum(1).float()
    filled = torch.zeros(B, C, device=dev).scatter_reduce(1, ch.long(), vis.float(), "amax")
    phase("heatmap", f"visible keypoints per frame: mean {per_frame.mean().item():.2f}, max "
          f"{int(per_frame.max())} of {vis.shape[1]} slots; maps holding a keypoint "
          f"{filled.mean().item():.4f} of {B * C}")
    results["heatmap_targets"] = {
        "max_abs_err": worst, "ms": device_ms(lambda: hm.heatmap_cuda(*args), "heatmap_kernel"),
        "call_ms": cuda_ms(lambda: hm.heatmap_cuda(*args)),
        "plain_ms": cuda_ms(lambda: hm.render_heatmaps(*args), iters=2, warmup=1),
        "bound": bound(hm_bytes, int(vis.sum()) * hm_px * HEATMAP_KPT_OPS)}
    del ann, rd, depth, table, ao, t, inst, tk, tp, ck, cp

    # 4. The main path.
    gen = pipe.make_generate_fn()
    counters = {"pixel_sweep": sweep_kernel.sweep_cuda, "rgb_epilogue": rgb_kernel.rgb_cuda,
                "heatmap_targets": hm.heatmap_cuda, "peak_decode": peak_kernel.peaks_cuda}
    datagen = ("pixel_sweep", "rgb_epilogue", "heatmap_targets")
    reset(counters)
    batches = []
    for i in range(3):
        before = read(counters)
        batches.append(gen(SEED, range(i * B, (i + 1) * B)))
        torch.cuda.synchronize()
        rose = {k: counters[k].launches - before[k] for k in datagen}
        check(all(v > 0 for v in rose.values()), f"batch {i}: a kernel did not launch: {rose}")
    launches = {k: counters[k].launches for k in datagen}
    gen_read = read(counters)
    phase("main", f"3 batches of {B} frames at {RES}^2; launches {launches}")
    check(read(counters)[TEXTURED] == 0, "untextured generate launched the textured variant")

    O = pipe.roster.num_instances
    K = pipe.roster.inst_kpts.shape[1]
    h = RES // cfg.pipeline.heatmap_stride
    expect = {
        "frame_id": ((B,), torch.int32), "rgb": ((B, RES, RES, 3), torch.uint8),
        "depth": ((B, RES, RES), torch.float32), "instance": ((B, RES, RES), torch.int32),
        "camera_pose7": ((B, 7), torch.float32), "inst_visible": ((B, O), torch.bool),
        "inst_pixel_count": ((B, O), torch.int32), "bbox2d": ((B, O, 4), torch.int32),
        "center": ((B, O, 3), torch.float32), "size": ((B, O, 3), torch.float32),
        "euler_deg": ((B, O, 3), torch.float32), "kpt_uv": ((B, O, K, 2), torch.float32),
        "kpt_visible": ((B, O, K), torch.bool), "kpt_in_image": ((B, O, K), torch.bool),
        "heatmaps": ((B, C, h, h), torch.float32), "pointcloud_count": ((B,), torch.int32),
    }
    check(list(expect) == list(FrameBatch._fields), "FrameBatch fields changed")
    for bi, batch in enumerate(batches):
        for name, (shape, dtype) in expect.items():
            v = getattr(batch, name)
            check(tuple(v.shape) == shape and v.dtype == dtype and v.device == dev,
                  f"batch {bi} {name}: {tuple(v.shape)} {v.dtype} {v.device}")
        for name in ("camera_pose7", "center", "size", "euler_deg", "kpt_uv", "heatmaps"):
            check(bool(torch.isfinite(getattr(batch, name)).all()), f"{name} not finite")
        check(not bool(torch.isnan(batch.depth).any()), "depth has NaN")
        check(bool((batch.depth[torch.isfinite(batch.depth)] > 0).all()), "depth <= 0")
        check(bool(((batch.heatmaps >= 0) & (batch.heatmaps <= 1)).all()), "heatmap range")
        check(bool(torch.equal(batch.inst_visible, batch.inst_pixel_count > 0)),
              "visible set != pixel counts")
        check(bool(torch.equal(batch.frame_id.cpu(),
                               torch.arange(bi * B, (bi + 1) * B, dtype=torch.int32))),
              "frame ids")
    stats = {k: int(v) for k, v in quality_stats(batches[0], cfg.quality.min_pointcloud_points)
             .items()}
    phase("main", f"quality_stats batch 0: {stats}")
    check(stats["total_frames"] == B and stats["labels_valid"] == B
          and stats["pointcloud_valid"] == B, "quality_stats: empty frames")
    again = gen(SEED, range(0, B))
    same = all(torch.equal(a, b) for a, b in zip(batches[0], again))
    phase("main", f"repeat with the same seed bit-equal: {same}")
    check(same, "generate is not deterministic")

    # Device path vs the plain (CPU) path on a small batch.
    small = Config(pipeline=PipelineConfig(render_width=128, render_height=128, batch_size=4))
    g_dev = Pipeline(small, device=dev).make_generate_fn()(SEED, range(10, 14))
    g_cpu = Pipeline(small, device="cpu").make_generate_fn()(SEED, range(10, 14))
    fd, fc = g_dev.depth.cpu(), g_cpu.depth
    fin = torch.isfinite(fd) & torch.isfinite(fc)
    agree = {
        "depth_finite": (torch.isfinite(fd) == torch.isfinite(fc)).float().mean().item(),
        "depth_rel": (torch.abs(fd - fc) / fc)[fin].max().item(),
        "instance": (g_dev.instance.cpu() == g_cpu.instance).float().mean().item(),
        "kpt_uv": torch.abs(g_dev.kpt_uv.cpu() - g_cpu.kpt_uv).max().item(),
        "center": torch.abs(g_dev.center.cpu() - g_cpu.center).max().item(),
        "kpt_visible": (g_dev.kpt_visible.cpu() == g_cpu.kpt_visible).float().mean().item(),
        "heatmaps": torch.abs(g_dev.heatmaps.cpu() - g_cpu.heatmaps).max().item(),
        "rgb_mean": abs(g_dev.rgb.float().mean().item() - g_cpu.rgb.float().mean().item()),
    }
    phase("main", "device vs plain CPU path (4 x 128^2): " +
          ", ".join(f"{k} {v:.3g}" for k, v in agree.items()))
    check(agree["depth_finite"] > 0.999 and agree["depth_rel"] < 3e-4
          and agree["instance"] > 0.999 and agree["kpt_uv"] < 1e-3 and agree["center"] < 1e-4
          and agree["kpt_visible"] >= 0.99 and agree["heatmaps"] < 2e-4
          and agree["rgb_mean"] < 1.0, "device path disagrees with the plain CPU path")

    # 5. The peak kernel against its plain version at the evaluation path's
    # shapes: the GT heatmaps, the full-width network's heatmaps, a noisy map
    # with negative values, the adversarial maps (every pixel an NMS
    # survivor, flat tops, nothing positive), odd shapes and maps of several
    # 128-column strips.
    model = pose_net.make_model(device=dev)
    with torch.inference_mode():
        images = preprocess.preprocess_frame(batches[0].rgb, RES, RES)
        hm_model = pose_net.output_to_heatmaps(pose_net.forward(model, images), "focal")
    gen_noise = torch.Generator(device=dev).manual_seed(SEED)
    gt_hm = batches[0].heatmaps
    for name, x in (("GT", gt_hm), ("model", hm_model)):
        surv = peak_kernel.nms_survivors(x).float()
        phase("peaks", f"NMS survivors per map, {name} heatmaps {tuple(x.shape)}: mean "
              f"{surv.mean().item():.2f}, max {int(surv.max())}")

    def resized(shape):  # GT blobs resized, plus noise with negative values
        x = torch.nn.functional.interpolate(gt_hm[:shape[0], :shape[1]], size=shape[2:],
                                            mode="bilinear", align_corners=False)
        return (x + 0.02 * torch.randn(x.shape, generator=gen_noise, device=dev)).contiguous()

    peak_inputs = {
        "GT heatmaps": gt_hm,
        "model heatmaps": hm_model,
        "noisy": (gt_hm + 0.05 * torch.randn(gt_hm.shape, generator=gen_noise,
                                              device=dev)).contiguous(),
        "constant": torch.full_like(gt_hm, 0.7),
        "plateau": torch.clamp_max(2.0 * gt_hm, 1.0),
        "all-negative": -0.01 - torch.rand(gt_hm.shape, generator=gen_noise, device=dev),
        "all-zero": torch.zeros_like(gt_hm),
        "odd (3, 5, 37, 61)": torch.randn(3, 5, 37, 61, generator=gen_noise, device=dev),
        "(2, 71, 192, 192)": resized((2, C, 192, 192)),
        "(1, 3, 300, 517)": resized((1, 3, 300, 517)),
    }
    peak_err = 0.0
    for name, x in peak_inputs.items():
        uv_k, sc_k = peak_kernel.peaks_cuda(x, K_PEAKS)
        uv_p, sc_p = peak_kernel.extract_peaks_plain(x, K_PEAKS)
        torch.cuda.synchronize()
        scores_equal = bool(torch.equal(sc_k, sc_p))
        d = torch.abs(uv_k - uv_p).max().item()
        pos = sc_p > 0
        uv_bits = bool(torch.equal(uv_k[pos], uv_p[pos]))
        phase("peaks", f"{name} {tuple(x.shape)}: scores bit-equal {scores_equal}, "
              f"{int(pos.sum())} positive peaks, max |uv diff| {d:.3e} px (<= 1e-3), "
              f"uv bit-equal where score > 0 {uv_bits}, everywhere "
              f"{bool(torch.equal(uv_k, uv_p))}")
        check(scores_equal and d <= 1e-3, f"peak kernel disagrees with its plain version: {name}")
        peak_err = max(peak_err, d)
    N_maps = gt_hm.shape[0] * gt_hm.shape[1]
    peak_px = N_maps * gt_hm.shape[2] * gt_hm.shape[3]
    results["peak_decode"] = {
        "max_abs_err": peak_err,
        "ms": device_ms(lambda: peak_kernel.peaks_cuda(gt_hm, K_PEAKS), "peak_kernel", iters=20),
        "call_ms": cuda_ms(lambda: peak_kernel.peaks_cuda(gt_hm, K_PEAKS), iters=20),
        "plain_ms": cuda_ms(lambda: peak_kernel.extract_peaks_plain(gt_hm, K_PEAKS), iters=3),
        "bound": bound(peak_px * 4 + N_maps * K_PEAKS * 3 * 4,
                       peak_px * (PEAK_PIXEL_OPS + K_PEAKS))}
    peak_model_ms = device_ms(lambda: peak_kernel.peaks_cuda(hm_model, K_PEAKS), "peak_kernel",
                              iters=20)
    del images, hm_model, peak_inputs

    # 6. The evaluation path: fresh frames, preprocess, the full-width
    # network (bf16 body, f32 head), focal heatmaps, every evaluator on the
    # GT and the model heatmaps.
    stride = cfg.pipeline.heatmap_stride
    eval_seed = SEED + 1000
    reset(counters)
    for i in range(2):
        before = read(counters)
        batch = gen(eval_seed, range(i * B, (i + 1) * B))
        out, hm_pred = ev.evaluate_model(model, batch, pipe.roster, intr, stride, "focal",
                                         pnp_threshold=0.15)
        torch.cuda.synchronize()
        rose = {k: fn.launches - before[k] for k, fn in counters.items()}
        check(rose["peak_decode"] >= 2 and all(v > 0 for v in rose.values()),
              f"eval batch {i}: a kernel did not launch: {rose}")
        check(tuple(hm_pred.shape) == (B, C, h, h) and hm_pred.dtype == torch.float32
              and bool(torch.isfinite(hm_pred).all()), "model heatmaps: shape or finiteness")
        for group, metrics in out.items():
            for k, v in metrics.items():
                check(v.device == dev and bool(torch.isfinite(v).all()), f"{group}.{k} not finite")
            phase("eval", f"batch {i} {group}: " + ", ".join(
                f"{k} {v.item():.4f}" if v.numel() == 1 else f"{k} (mean) {v.float().mean():.4f}"
                for k, v in metrics.items()))
        floor = out["decode_floor"]
        check(float(floor["pck"]) > 0.5 and int(floor["n_keypoints"]) > 0,
              f"decode floor PCK {float(floor['pck']):.4f} <= 0.5")
        # GT keypoints through the ground-prior solve: on a far frame with
        # 3-4 visible corners the solve can settle in a wrong depth basin,
        # as the JAX package's does on the same inputs (frame 25 of the
        # first batch; tests/test_torch_pnp.py holds both there), so one
        # such frame in 20 may miss 0.1d.
        gt = out["dumper_gt_kpts"]
        if int(gt["n_valid"]) > 0:
            check(float(gt["add_0_1d"]) >= 0.95 and float(gt["add_mean"]) < 0.2,
                  f"dumper ADD with GT keypoints: {float(gt['add_0_1d'])}, "
                  f"{float(gt['add_mean'])} m")
        # The crane's joint solve on GT keypoints pins every part (the JAX
        # run of record: ADD-0.1d 1.000, mean 0.019 m on 11 frames). A frame
        # whose visible keypoints are only the boom's and the telescopic's
        # (near-collinear) leaves the root unobservable, and the solve, the
        # JAX one alike, can settle hundreds of metres away (frame 80 of
        # this seed; tests/test_torch_crane.py holds both there): one such
        # frame moves the mean by metres, so the typical frame's ADD is held
        # by the median.
        cr = out["crane_gt_kpts"]
        med, far = crane_frame_add(ev, batch, pipe.roster, intr, stride)
        phase("eval", f"batch {i} crane GT keypoints: median per-frame ADD {med:.4f} m "
              f"(< 0.1); frames beyond 1 m: {far or 'none'}")
        check(int(cr["n_accepted"]) > 0 and float(cr["add_0_1d"]) >= 0.95 and med < 0.1,
              f"crane ADD with GT keypoints: ADD-0.1d {float(cr['add_0_1d'])}, median "
              f"{med} m, accepted {int(cr['n_accepted'])}")
        # The dumper through RANSAC PnP on the model heatmaps, to its end.
        rs = ev.evaluate_equipment_6dof(batch, pipe.roster, intr, "dumper", stride,
                                        heatmaps=hm_pred, score_threshold=0.15)
        check(all(bool(torch.isfinite(v).all()) for v in rs.values()), "RANSAC row not finite")
        phase("eval", f"batch {i} dumper_ransac_model: " +
              ", ".join(f"{k} {v.item():.4f}" for k, v in rs.items()))
    eval_launches = read(counters)
    phase("eval", f"2 batches of {B} frames at {RES}^2; launches {eval_launches}")

    # The card against the plain CPU path: the same FrameBatch and the same
    # weights, the forward in f32, held to 1e-3. The evaluators' counts are
    # then held equal on the same heatmaps on both sides, with a stand-in
    # for a trained network's as the model heatmaps: the GT heatmaps plus a
    # tenth of the random network's. The random network's own keypoints are
    # noise the ground-prior solve cannot fit; its cheirality test (mean
    # camera-frame depth > 0) then sits near 0, and on the H100 the card's
    # solve and the CPU's decided one such frame differently on identical
    # heatmaps.
    g_cpu = FrameBatch(*(v.cpu() for v in g_dev))
    m_dev = pose_net.make_model(device=dev, dtype=torch.float32)
    m_cpu = pose_net.make_model(device="cpu", dtype=torch.float32)
    small_pipe = Pipeline(small, device="cpu")
    out_e2e, hm_d = ev.evaluate_model(m_dev, g_dev, small_pipe.roster, small_pipe.intr, stride)
    out_net, hm_c = ev.evaluate_model(m_cpu, g_cpu, small_pipe.roster, small_pipe.intr, stride)
    hm_err = torch.abs(hm_d.cpu() - hm_c).max().item()
    moved = [f"{g}.{k} {v.tolist()} vs {out_net[g][k].tolist()}" for g, m in out_e2e.items()
             for k, v in m.items()
             if k.startswith("n_") and not torch.equal(v.cpu(), out_net[g][k])]
    phase("eval", f"card vs plain CPU path (4 x 128^2, f32 forward): model heatmaps max |d| "
          f"{hm_err:.2e} (< 1e-3); counts that differ on the random network's heatmaps: "
          f"{moved or 'none'}")
    check(hm_err < 1e-3, "model heatmaps: card vs CPU")
    stand_in = g_cpu.heatmaps + 0.1 * hm_c
    out_d = ev.evaluate_heatmaps(g_dev, stand_in.to(dev), small_pipe.roster, small_pipe.intr,
                                 stride)
    out_c = ev.evaluate_heatmaps(g_cpu, stand_in, small_pipe.roster, small_pipe.intr, stride)
    dens = {"pck": "n_keypoints", "recall": "n_keypoints", "pck_per_kpt": "n_per_kpt",
            "add_0_1d": "n_accepted"}
    worst_ratio = 0.0
    for group in out_c:
        mc, md = out_c[group], {k: v.cpu() for k, v in out_d[group].items()}
        for k in mc:
            if k.startswith("n_"):
                if group.startswith("crane") and not torch.equal(md[k], mc[k]):
                    crane_frames_differ(ev, group, g_dev, g_cpu, stand_in, small_pipe, stride)
                check(torch.equal(md[k], mc[k]), f"card vs CPU: {group}.{k} {md[k]} != {mc[k]}")
            elif k in dens:
                den = "n_instances_evaluated" if "multi" in group and k == "add_0_1d" else dens[k]
                tol = 1.0 / torch.clamp_min(mc[den].float(), 1) + 1e-6
                dr = torch.abs(md[k] - mc[k])
                check(bool((dr <= tol).all()), f"card vs CPU: {group}.{k} {md[k]} vs {mc[k]}")
                worst_ratio = max(worst_ratio, dr.max().item())
    phase("eval", f"card vs plain CPU evaluators on the same heatmaps (GT + 0.1 x the network's "
          f"as the model's): counts equal, worst ratio diff {worst_ratio:.4f} (<= one count "
          f"over its denominator)")
    del m_dev, m_cpu

    # 7. The training path (this slice's main path): the port's
    # `train-eval` in-process at the stage-1 configuration, then a fixed
    # batch trained to half its first loss, one step on the card against
    # the plain CPU path, and a checkpoint round trip.
    reset(counters)
    lines = drive_cli(["train-eval", "--device", "cuda", "--size", str(RES), "--batch",
                       str(TRAIN_B), "--steps", str(TRAIN_STEPS), "--inner", "1",
                       "--camera-mix", "0.3", "--eval-frames", str(TRAIN_B),
                       "--pnp-threshold", "0.15", "--seed", str(SEED)])
    torch.cuda.synchronize()
    train_launches = read(counters)
    step_losses = [float(ln.split("loss=")[1].split()[0]) for ln in lines
                   if ln.startswith("step ")]
    phase("train", f"train-eval, {TRAIN_STEPS} steps of {TRAIN_B} x {RES}^2, full-width "
          f"HeatmapBackbone (bf16 body), focal, camera-mix 0.3, then {TRAIN_B} eval frames; "
          f"launches {train_launches}; losses {step_losses}")
    check(len(step_losses) == TRAIN_STEPS and all(math.isfinite(v) for v in step_losses),
          "train-eval: a step's loss is missing or not finite")
    check(all(train_launches[k] == TRAIN_STEPS + 1 for k in datagen),
          f"train-eval: a datagen kernel did not launch once a step and once for the "
          f"eval batch: {train_launches}")
    check(train_launches["peak_decode"] >= 2, "train-eval: the peak kernel did not launch")
    missing = [p for p in TRAIN_EVAL_LINES if not any(ln.startswith(p) for ln in lines)]
    check(not missing, f"train-eval did not print: {missing}")
    launches = {k: {"generate": launches.get(k), "eval": eval_launches[k],
                    "train_eval": train_launches[k]} for k in counters}

    from constructionsceneposeestimation_tpu_torch.config import TrainConfig
    from constructionsceneposeestimation_tpu_torch.train import checkpoint
    from constructionsceneposeestimation_tpu_torch.train import loop as train_loop

    fcfg = Config(pipeline=PipelineConfig(render_width=RES, render_height=RES),
                  train=TrainConfig(batch_size=TRAIN_B, steps=30, warmup_steps=5, loss="focal",
                                    camera_mix=0.3))
    tpipe = Pipeline(fcfg, device=dev)
    state = train_loop.create_train_state(fcfg, pose_net.make_model(device=dev))
    tstep = train_loop.make_train_step(fcfg, state.model, tpipe)
    fixed = tstep.generate(SEED + 7, range(TRAIN_B))
    fixed_losses = []
    for _ in range(30):
        state, m = tstep.train_on_batch(state, *fixed)
        fixed_losses.append(m["loss"])
    fixed_losses = torch.stack(fixed_losses).tolist()
    phase("train", f"one fixed batch of {TRAIN_B} x {RES}^2, 30 steps, warmup 5: losses "
          f"{[round(v, 4) for v in fixed_losses]}; last / first "
          f"{fixed_losses[-1] / fixed_losses[0]:.4f} (< 0.5)")
    check(fixed_losses[-1] < 0.5 * fixed_losses[0], "the fixed batch's loss did not halve")

    ck_dir = ROOT / "build" / "smoke_checkpoint"
    shutil.rmtree(ck_dir, ignore_errors=True)
    mgr = checkpoint.CheckpointManager(str(ck_dir), save_every=0)
    check(mgr.maybe_save(state, force=True), "checkpoint not written")
    restored = mgr.restore(train_loop.create_train_state(
        fcfg, pose_net.make_model(device=dev, seed=1)))
    same = (restored.step == state.step
            and restored.scheduler.last_epoch == state.scheduler.last_epoch
            and all(torch.equal(a, b) for a, b in zip(restored.model.state_dict().values(),
                                                     state.model.state_dict().values()))
            and tensors_equal(restored.optimizer.state_dict()["state"],
                              state.optimizer.state_dict()["state"]))
    shutil.rmtree(ck_dir, ignore_errors=True)
    phase("train", f"checkpoint round trip on the card (step {state.step}): parameters, "
          f"AdamW moments and counts, schedule bit-equal: {same}")
    check(same, "checkpoint round trip is not bit-equal")
    del state, restored, fixed, tstep

    # One step on the card against the plain CPU path: the same weights, the
    # same batch and augment draws, the full-width backbone in f32 at 4 x 128^2.
    scfg = Config(pipeline=PipelineConfig(render_width=128, render_height=128),
                  train=TrainConfig(batch_size=4, loss="focal"))
    g_host = Pipeline(scfg, device="cpu").make_generate_fn(camera_mix=0.3)(SEED, range(20, 24))
    d_host = preprocess.augment_draws(SEED, range(20, 24), 128, 128, "cpu")
    grads, step_loss = {}, {}
    for where in (dev, torch.device("cpu")):
        st = train_loop.create_train_state(scfg, pose_net.make_model(device=where,
                                                                     dtype=torch.float32))
        bs = train_loop.BatchStep(scfg, tpipe.roster)
        step_loss[where.type] = bs.forward_backward(
            st, FrameBatch(*(v.to(where) for v in g_host)),
            preprocess.AugmentDraws(*(v.to(where) for v in d_host))).item()
        grads[where.type] = {n: p.grad.detach().cpu() for n, p in st.model.named_parameters()}
    loss_rel = abs(step_loss["cuda"] - step_loss["cpu"]) / abs(step_loss["cpu"])
    grad_rel = max((torch.linalg.norm(grads["cuda"][n] - g) /
                    torch.clamp_min(torch.linalg.norm(g), 1e-30)).item()
                   for n, g in grads["cpu"].items())
    phase("train", f"one step, card vs plain CPU path (4 x 128^2, f32 body): loss "
          f"{step_loss['cuda']:.6f} vs {step_loss['cpu']:.6f}, relative {loss_rel:.2e} (< 1e-3); "
          f"worst gradient |d| / |g| {grad_rel:.2e} (< 1e-2) over {len(grads['cpu'])} tensors")
    check(loss_rel < 1e-3 and grad_rel < 1e-2, "training step: card vs CPU")
    del grads

    # 8. [generate]: the generate command to shards and to the reference
    # tree, resume, then train-eval --data-dir on the shards, in a temporary
    # directory (under TMPDIR) that is removed at the end.
    work = Path(tempfile.mkdtemp(prefix="cspe_smoke_generate_"))
    try:
        gen_cli_launches, shards = generate_phase(dev, card, counters, datagen, work)
        data_dir_launches = data_dir_phase(dev, card, counters, datagen, shards, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for k in counters:
        launches[k]["generate_cli"] = gen_cli_launches[k]
        launches[k]["train_data_dir"] = data_dir_launches[k]

    # 9. [two-stage]: train-crop, train-detect and infer through the CLI,
    # their checkpoints and records in a temporary directory removed at the
    # end, then the heatmap kernel at the crop shapes, the card against the
    # CPU and the steps' timing.
    # 10. [sequence] and [hifi]: clips and the CAD-mesh tier through the
    # commands, the infer and train-detect runs on the two-stage checkpoints.
    work = Path(tempfile.mkdtemp(prefix="cspe_smoke_two_stage_"))
    ck = {k: str(work / k) for k in ("dumper", "crane", "det")}
    try:
        two_stage_launches, crop_hm = two_stage_phase(dev, card, counters, work)
        two_stage_launches.update(sequence_phase(dev, card, counters, datagen, work, ck))
        hifi_launches, mesh_result = hifi_phase(dev, card, counters, datagen, work, ck,
                                                (world, inputs.cam_pos, M, intr))
        two_stage_launches.update(hifi_launches)
        # 11. [textures]: the image-texture tier, on the same checkpoints.
        tex_launches, results["rgb_epilogue"]["textured"] = textures_phase(
            dev, card, counters, datagen, work, ck)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    # The textured variant launches on the textured paths only.
    untextured = {"eval": eval_launches, "train_eval": train_launches,
                  "generate_cli": gen_cli_launches, "train_data_dir": data_dir_launches,
                  **two_stage_launches}
    stray = {p: c[TEXTURED] for p, c in untextured.items() if c[TEXTURED]}
    phase("textures", f"textured launches on the {len(untextured)} untextured paths: "
          f"{stray or 'none'}")
    check(not stray, f"the textured variant launched on an untextured path: {stray}")
    two_stage_launches.update(tex_launches)

    # 12. [analytic]: render_frame's analytic-normal, sun-shadow and flat
    # tiers, the casters they need and the RGB kernel's tier variants.
    an_launches, tier_results, casters = analytic_phase(dev, card, counters)
    earlier = {"eval": eval_launches, "train_eval": train_launches,
               "generate_cli": gen_cli_launches, "train_data_dir": data_dir_launches,
               **two_stage_launches}
    stray = {p: {k: n for k, n in c.items() if k.startswith("rgb_epilogue/") and n}
             for p, c in earlier.items()}
    stray = {p: c for p, c in stray.items() if c}
    phase("analytic", f"tier-variant launches on the {len(earlier)} earlier paths: "
          f"{stray or 'none'}")
    check(not stray, f"an RGB tier variant launched on an earlier path: {stray}")
    two_stage_launches.update(an_launches)
    # 12b. [raycast]: the analytic caster's kernel against its plain walks.
    raycast_results = raycast_phase(dev, card)
    for k in counters:
        for path, counts in two_stage_launches.items():
            launches[k][path] = counts[k]
    textured_by_path = {p: c[TEXTURED] for p, c in tex_launches.items()}
    results["heatmap_targets"]["crop_shapes"] = crop_hm

    # 13. [distributed]: the sharded generate and training steps, 2 ranks on
    # this card over gloo, then 1 over NCCL.
    distributed_phase(card)

    # 14. [bench]: the headline command at the JAX benchmark's shape.
    bench_launches = bench_phase(dev, card, counters, datagen)
    for k in counters:
        launches[k]["bench"] = bench_launches[k]

    # The mesh sweep kernel launched on every hifi path, and on no other.
    all_paths = {"eval": eval_launches, "train_eval": train_launches,
                 "generate_cli": gen_cli_launches, "train_data_dir": data_dir_launches,
                 **two_stage_launches, "bench": bench_launches}
    mesh_by_path = {p: c[MESH] for p, c in all_paths.items()}
    mesh_by_path["hifi_eval"] = mesh_result.pop("hifi_eval")
    stray = {p: c for p, c in mesh_by_path.items() if p not in HIFI_PATHS and c}
    unlaunched = [p for p in HIFI_PATHS if not mesh_by_path[p] > 0]
    phase("mesh", f"mesh sweep launches on the hifi paths "
          f"{ {p: mesh_by_path[p] for p in HIFI_PATHS} }; on the {len(mesh_by_path) - len(HIFI_PATHS)}"
          f" other paths: {stray or 'none'}")
    check(not stray and not unlaunched, f"mesh sweep launches: none on {unlaunched}, stray "
          f"{stray}")
    # The terms kernel once a hifi render (half the mesh sweep's launches) on
    # every path, the plain terms never on the card.
    terms_by_path = {p: c[MESH_TERMS] for p, c in all_paths.items()}
    terms_by_path["hifi_eval"] = mesh_result.pop("hifi_eval_terms")
    plain_terms = {p: c[PLAIN_TERMS] for p, c in all_paths.items() if c[PLAIN_TERMS]}
    odd = {p: (n, mesh_by_path[p]) for p, n in terms_by_path.items() if 2 * n != mesh_by_path[p]}
    phase("mesh-terms", f"terms kernel launches on the hifi paths "
          f"{ {p: terms_by_path[p] for p in HIFI_PATHS} }, half the mesh sweep's on all "
          f"{len(terms_by_path)} paths: {not odd}; plain_mesh_terms on the card: "
          f"{plain_terms or 'none'}")
    check(not odd and not plain_terms, f"mesh terms launches: (terms, mesh sweep) {odd}, "
          f"plain_mesh_terms on the card {plain_terms}")

    # The caster's packed mode launched once a render on every path (as the
    # pixel sweep, or the exact mode under analytic normals), the exact and
    # per-origin modes only on the analytic tiers, the plain walks nowhere.
    by_path = {"generate": gen_read, "eval": eval_launches, "train_eval": train_launches,
               "generate_cli": gen_cli_launches, "train_data_dir": data_dir_launches,
               **two_stage_launches, "bench": bench_launches}
    caster_by_path = {m: {p: c[m] for p, c in by_path.items()} for m in RAYCAST_MODES}
    odd = {p: {k: c[k] for k in ("pixel_sweep", *RAYCAST_MODES, PLAIN_CASTER)}
           for p, c in by_path.items()
           if c[RAYCAST_PACKED] != c["pixel_sweep"] or c[PLAIN_CASTER]
           or not (c[RAYCAST_PACKED] or c[RAYCAST_EXACT])
           or ((c[RAYCAST_EXACT] or c[RAYCAST_MULTI]) and p not in an_launches)}
    phase("raycast", f"launches on the {len(by_path)} paths: packed "
          f"{caster_by_path[RAYCAST_PACKED]}; exact {caster_by_path[RAYCAST_EXACT]}; multi "
          f"{caster_by_path[RAYCAST_MULTI]}; plain walks on the card: "
          f"{sum(c[PLAIN_CASTER] for c in by_path.values())}")
    check(not odd, f"raycast launches: the packed mode not once a render, a plain walk on the "
          f"card, or the exact or per-origin mode off the analytic paths: {odd}")

    # 15. Timing: generate frames/s (every field consumed), min of 4 regions.
    region_ms(gen, B * 10)  # the warm-up
    regions = [region_ms(gen, B * (11 + r)) for r in range(4)]
    best = min(regions)
    phase("time", f"generate {B} x {RES}^2, all modalities: regions "
          f"{[round(x, 3) for x in regions]} ms; min {best:.3f} ms = "
          f"{B * 1000.0 / best:.1f} frames/s on {card}")
    with torch.inference_mode():
        images = preprocess.preprocess_frame(batch.rgb, RES, RES)
        fwd_ms = cuda_ms(lambda: pose_net.forward(model, images), iters=5)
    del images
    regions = []
    for r in range(4):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out, _ = ev.evaluate_model(model, batch, pipe.roster, intr, stride, "focal",
                                   pnp_threshold=0.15)
        total = sum(v.float().sum() for m in out.values() for v in m.values())
        e1.record()
        torch.cuda.synchronize()
        check(bool(torch.isfinite(total)), "evaluation step: total not finite")
        if r > 0:  # region 0 is the warm-up
            regions.append(e0.elapsed_time(e1))
    best = min(regions)
    phase("time", f"forward, full-width HeatmapBackbone, bf16, {B} x {RES}^2: {fwd_ms:.3f} ms "
          f"on {card}")
    phase("time", f"evaluation step {B} x {RES}^2 (preprocess, forward, every evaluator on GT "
          f"and model heatmaps): regions {[round(x, 3) for x in regions]} ms; min "
          f"{best:.3f} ms = {B * 1000.0 / best:.1f} frames/s on {card}")
    train_timing(dev, card)
    phase("time", f"peak_decode on the model heatmaps: kernel {peak_model_ms:.4f} ms at "
          f"(64 x 71, 128, 128), K = {K_PEAKS}, on {card}")
    hm_ms = results["heatmap_targets"]["ms"]
    phase("heatmap", f"heatmap_targets writes {hm_out / 1e6:.1f} MB: {hm_out / hm_ms / 1e9:.3f} "
          f"TB/s by its device time ({hm_out / HBM_BYTES_PER_S * 1e3:.4f} ms at the card's "
          f"3.35 TB/s) on {card}")
    rgb_r = results["rgb_epilogue"]
    all_rows_ms = rgb_r.pop("bound_all_rows_ms")
    phase("time", f"rgb_epilogue against the bound of every AO row on every ground pixel with "
          f"three rays, {all_rows_ms:.4f} ms: {100 * all_rows_ms / rgb_r['ms']:.1f}% of it, on "
          f"{card}")
    for name, r in results.items():
        r["bound_ms"], r["bound_by"] = r.pop("bound")
        phase("time", f"{name}: kernel {r['ms']:.4f} ms (device time; the wrapper's call "
              f"{r['call_ms']:.4f} ms by CUDA events), plain {r['plain_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}; roofline share "
              f"{100 * r['bound_ms'] / r['ms']:.1f}%) at the main path's shapes on {card}")
    tex = results["rgb_epilogue"].pop("textured")
    phase("time", f"rgb_epilogue, textured variant: kernel {tex['ms']:.4f} ms (call "
          f"{tex['call_ms']:.4f} ms), plain {tex['plain_ms']:.4f} ms, bound {tex['bound_ms']:.4f} "
          f"ms ({tex['bound_by']}; roofline share {100 * tex['bound_ms'] / tex['ms']:.1f}%), "
          f"launches {textured_by_path} on {card}")
    results["rgb_epilogue"].update({f"textured_{k}": v for k, v in tex.items()},
                                   textured_launches=sum(textured_by_path.values()),
                                   textured_launches_by_path=textured_by_path)

    phase("time", f"exact caster {casters['cast_ms']:.3f} ms a batch of {B} x {RES}^2 pixel rays "
          f"(peak {casters['cast_peak_gib']:.2f} GiB), shadow sweep {casters['shadow_ms']:.3f} ms "
          f"(peak {casters['shadow_peak_gib']:.2f} GiB), csrc/raycast.cu, on {card}")
    for v, r in tier_results.items():
        phase("time", f"rgb_epilogue, {v} variant: kernel {r['ms']:.4f} ms beside the default "
              f"{r['default_ms']:.4f} ms in one window, plain {r['plain_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}; roofline share "
              f"{100 * r['bound_ms'] / r['ms']:.1f}%), launches "
              f"{ {p: c[tier_key(v)] for p, c in an_launches.items()} } on {card}")
    mesh_result["bound_ms"], mesh_result["bound_by"] = mesh_result.pop("bound")
    phase("time", f"{MESH}: kernel {mesh_result['ms']:.4f} ms a hifi batch of {HIFI_FRAMES} x "
          f"{RES}^2, pixels and segments (device time; the wrapper's calls "
          f"{mesh_result['call_ms']:.4f} ms, MeshCaster.packed {mesh_result['packed_ms']:.4f} ms "
          f"by CUDA events), plain {mesh_result['plain_ms']:.4f} ms, bound "
          f"{mesh_result['bound_ms']:.4f} ms ({mesh_result['bound_by']}, the needed pairs; "
          f"roofline share {100 * mesh_result['bound_ms'] / mesh_result['ms']:.2f}%; the "
          f"visited pairs' bound {mesh_result['visited_bound_ms']:.4f} ms, "
          f"{100 * mesh_result['visited_bound_ms'] / mesh_result['ms']:.1f}%; the plain test's "
          f"bound {mesh_result['plain_test_bound_ms']:.4f} ms), launches {mesh_by_path} on "
          f"{card}")
    terms_result = mesh_result.pop("terms")
    terms_result["bound_ms"], terms_result["bound_by"] = terms_result.pop("bound")
    phase("time", f"{MESH_TERMS}: kernel {terms_result['ms']:.4f} ms a hifi render of "
          f"{HIFI_FRAMES} x {RES}^2 (profiler device time; "
          f"{terms_result['ms_by']['events']:.4f} ms by CUDA events; the wrapper's call "
          f"{terms_result['call_ms']:.4f} ms), plain {terms_result['plain_ms']:.4f} ms in "
          f"{terms_result['plain_launches']} launches, bound {terms_result['bound_ms']:.4f} ms "
          f"({terms_result['bound_by']}; roofline share "
          f"{100 * terms_result['bound_ms'] / terms_result['ms']:.1f}%); HifiCaster.frame_world "
          f"{terms_result['frame_world']['kernel']} with the kernel, "
          f"{terms_result['frame_world']['plain']} with the plain terms; launches "
          f"{terms_by_path} on {card}")
    paths = ("train_crop", "train_detect", "infer", "generate_sequence", "infer_sequence",
             "generate_hifi", "train_detect_hifi", "infer_hifi", *textured_by_path, *an_launches,
             "bench")
    kernels_line = {"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
         "launches": sum(launches[name][p] for p in paths),
         "launches_by_path": launches[name],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "call_ms": r["call_ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
         "library_ms": None, **{k: v for k, v in r.items() if k == "crop_shapes"
                                 or k.startswith("textured_")}}
        for name, r in results.items()] + [
        {"name": tier_key(v), "route": "cuda", "source": SOURCES["rgb_epilogue"],
         "replaces": REPLACES["rgb_epilogue"], "jnp_tier": JNP_TIERS[v.split("+")[0]],
         "launches": sum(c[tier_key(v)] for c in an_launches.values()),
         "launches_by_path": {p: c[tier_key(v)] for p, c in an_launches.items()},
         "library_ms": None, **r}
        for v, r in tier_results.items()] + [
        {"name": MESH, "route": "cuda", "source": SOURCES[MESH], "replaces": REPLACES[MESH],
         "jnp_loop": MESH_JNP_LOOP, "launches": sum(mesh_by_path[p] for p in HIFI_PATHS
                                                    if p != "hifi_eval"),
         "launches_by_path": mesh_by_path, "library_ms": None, **mesh_result}] + [
        {"name": MESH_TERMS, "route": "cuda", "source": SOURCES[MESH_TERMS],
         "replaces": REPLACES[MESH_TERMS], "jnp_loop": MESH_TERMS_JNP,
         "launches": sum(terms_by_path[p] for p in HIFI_PATHS if p != "hifi_eval"),
         "launches_by_path": terms_by_path, "library_ms": None, **terms_result}] + [
        {"name": m, "route": "cuda", "source": SOURCES[m], "replaces": REPLACES[m],
         "jnp_loop": RAYCAST_JNP_LOOP[m], "launches": sum(caster_by_path[m].values()),
         "launches_by_path": caster_by_path[m], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
         "call_ms": r["call_ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
         "bound_by": r["bound"][1], "library_ms": None,
         **{k: v for k, v in r.items() if k not in ("max_abs_err", "ms", "call_ms", "plain_ms",
                                                      "bound")}}
        for m, r in raycast_results.items()] + [draws_row]}
    print(json.dumps(kernels_line), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
