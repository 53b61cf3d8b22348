#!/usr/bin/env python3
"""Time variants of the RGB, heatmap and mesh sweep kernels on one GPU, and
hold another build of the kernels against this one bit for bit.

    python3 tools/kernel_variants.py [--against CSRC_DIR] [--only NAME,...]
                                     [--kernels rgb,heatmap,mesh] [--iters 20]
                                     [--out build/kernel_variants.json]

Builds ``csrc/`` as it stands ("this"), each variant of ``VARIANTS`` (a copy
of ``csrc/`` with a few lines of text replaced: the tiles a block and the
launch bounds of ``csrc/rgb.cu``, its stages taken out one at a time to time
each by its absence, the warps a block of ``csrc/heatmap.cu``, the sets a
block and the warps a set of ``csrc/meshsweep.cu``'s segment walk; the
textured variant's stages and register cap), and ``--against``, a
directory of other sources with some of the same C entry points (an
earlier ``csrc/``), each into a library of its own under
``build/kernel_variants/``. On the datagen path's inputs (64 frames at
512^2, built as ``chip_smoke.py`` builds them; for the RGB kernel's
untextured tier variants also the exact caster's normals and the sun-shadow
rays' t, as ``annotate.render_frame`` builds them; for its textured
variant the dense texel table, as ``chip_smoke.py``'s ``[textures]`` phase
builds it, and the hifi sweeper's t and instance on the same frames) and the
mesh sweep's (32
hifi frames at 512^2, pixel rays in 32 x 32 tiles and keypoint segments,
built as ``chip_smoke.py``'s ``[mesh]`` phase builds them) it then:

- holds each library's RGB images (hash noise off and on, and each tier
  variant with the noise on; the textured variant in its four
  instantiations, tiers 0 to 3, noise off and on, on the proxy and the
  hifi inputs), heatmaps and mesh sweeps (each walk of
  ``MESH_WALKS``) against this build's: bit-equal or not; for RGB the
  pixels that differ, split into sky, ground and objects, and the max |d|
  in u8 levels; for heatmaps the max |d|; for the mesh sweep the rays that
  differ; and, with ``--against``, whether each library's kernels are the
  same machine code as ``--against``'s (``cuobjdump -sass``) or not;
- times each library's ``rgb_kernel`` (the default and, where the library
  has ``cspe_rgb_tier``, each tier variant; the textured variant in its
  four instantiations on the proxy inputs), ``heatmap_kernel`` and mesh
  sweep (the patch walk on the pixels, the split and segment walks on the
  segments) by ``torch.profiler`` device time over ``--iters`` launches,
  in turns: this, the others, the others again in reverse, this. A
  library is held and timed on the entry points and walks it has (an
  earlier ``cspe_mesh_sweep`` refuses a walk it lacks).

``--kernels`` names the kernels held and timed (all three by default).
Prints a line for each comparison and time, with the card's name and power
limit and each kernel's registers and spills (``ptxas -v``), and writes them to
``--out`` as JSON. Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import difflib
import json
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from constructionsceneposeestimation_tpu_torch.utils import kernels  # noqa: E402

B, RES, SEED = 64, 512, 0
TEX = ("const float tex = 1.0f + 0.15f * p[25] * (hash_noise(pwx, pwy, pwz) - 0.5f) * 2.0f;")
BOUNDS = ("__launch_bounds__(kTileW * kTileH,\n"
          "                                  TEX ? kMinBlocksTex : TIER == 0 ? kMinBlocks : "
          "kMinBlocksTier)")
# The untextured tier masks timed (render/rgb_kernel.TIERS), by name.
TIERS = {"default": 0, "normal": 1, "shadow": 2, "normal+shadow": 3, "flat": 4,
         "flat+shadow": 6, "flat+normal+shadow": 7}
# The source of each kernel the tool holds and times (--kernels); a library
# holds only those of the run, and has the entry points of those alone.
SOURCES = {"rgb": "rgb.cu", "heatmap": "heatmap.cu", "mesh": "meshsweep.cu"}
# The textured variant's instantiations (tiers 0 to 3), by name.
TEX_TIERS = {"textured": 0, "textured+normal": 1, "textured+shadow": 2,
             "textured+normal+shadow": 3}
# The mesh sweep's [mesh] inputs: frames and the sample seed.
MESH_B, MESH_SEED = 32, 3000
# The walks held and timed on each kind of mesh ray (render/meshcast.WALKS),
# and the name of each walk's kernel as torch.profiler records it.
MESH_WALKS = {"pixels": ("4x8",), "segments": ("split", "segments")}
MESH_KERNELS = {"split": "mesh_sweep_kernel<", "4x8": "mesh_sweep_patch_kernel",
                "segments": "mesh_sweep_segment_kernel"}
SEG_BOUNDS = "__launch_bounds__(kSegThreads, 3) mesh_sweep_segment_kernel"
# Texts of csrc/rgb.cu's textured variant that its variants replace.
TEXEL = "__ldg(texels + i)"
NR_TEXEL = "__ldg(texels + i + (nr_tex - tex) * kTexBins * kTexBins)"
CONST_TEXEL = "make_float4(0.5f, 0.5f, 0.5f, 0.0f)"
THETA = "return __fadd_rn(__fmul_rn(atan2f(ly, lx), (float)(0.5 / kPi)), 0.5f);"
R_XY = "const float r_xy = sqrtf(lx * lx + ly * ly);"
RENORM = "const float rn = 1.0f / sqrtf(fmaxf(px * px + py * py + pz * pz, 1e-12f));"
TEX_STAGE = "image_textures(alb, lx, ly, lz, pwx, pwy, cls, p[24], texels, du, dv, rough, w_nr);"
TEX_BOUND = "constexpr int kMinBlocksTex = 8;"
# The gamma chain and rounding of a pixel's colour, on the hit pixels' path
# and on a textured variant's sky path.
GAMMA = "gamma22(c), 255.0f));"
GAMMA_SITES = ("clampf(color, 0.0f, 1.0f);\n        rgb[ch] = (uint8_t)rintf(__fmul_rn(",
               "0.0f, 1.0f);\n        o[ch] = (uint8_t)rintf(__fmul_rn(")
# name: [(source, text, replacement)]; every text must occur once.
VARIANTS = {
    **{f"rgb_tiles{n}": [("rgb.cu", "constexpr int kTiles = 4;", f"constexpr int kTiles = {n};")]
       for n in (1, 2, 8)},
    "rgb_bounds_none": [("rgb.cu", BOUNDS, "")],
    "rgb_bounds_threads": [("rgb.cu", BOUNDS, "__launch_bounds__(kTileW * kTileH)")],
    **{f"rgb_blocks{n}": [("rgb.cu", "constexpr int kMinBlocks = 8;",
                           f"constexpr int kMinBlocks = {n};")] for n in (1, 5, 6)},
    "rgb_no_gamma": [("rgb.cu", site + GAMMA, site + "c, 255.0f));") for site in GAMMA_SITES],
    "rgb_no_noise": [("rgb.cu", TEX, "const float tex = 1.0f;")],
    "rgb_no_ao": [("rgb.cu", "for (int a0 = 0; a0 < n_ao; a0 += kTileW)",
                   "for (int a0 = 0; a0 < 0; a0 += kTileW)")],
    # One kernel that reads the tier mask at run time (uniform branches)
    # in place of an instantiation a mask; and the tier variants' register
    # cap at 7 or 6 blocks an SM (36, 40 registers) in place of 8.
    "rgb_runtime_tiers": [("rgb.cu", "  return tex ? textured[tier] : plain[tier];",
                           "  return tex ? rgb_kernel<true, kRuntimeTier> : "
                           "rgb_kernel<false, kRuntimeTier>;")],
    **{f"rgb_tier_blocks{n}": [("rgb.cu", "constexpr int kMinBlocksTier = 8;",
                                f"constexpr int kMinBlocksTier = {n};")] for n in (6, 7)},
    # The textured variant's stages, each taken out to time it by its
    # absence: both texel loads (a constant texel), the mask ladder's theta
    # and r_xy, the renormalize of the normal, the specular powf, the whole
    # texture stage (the renormalize kept), the sky pixels' own path (they
    # take the hit pixels' path); and its register cap at 4, 5 or 6 blocks
    # an SM (64, 48, 40 registers) in place of 8.
    "rgb_tex_no_texel": [("rgb.cu", TEXEL, CONST_TEXEL), ("rgb.cu", NR_TEXEL, CONST_TEXEL)],
    "rgb_tex_no_theta": [("rgb.cu", THETA, "return __fmul_rn(ly, 0.1f);"),
                         ("rgb.cu", R_XY, "const float r_xy = fabsf(lx) + fabsf(ly);")],
    "rgb_tex_no_renorm": [("rgb.cu", RENORM, "const float rn = 1.0f;")],
    "rgb_tex_no_pow": [("rgb.cu", "powf(ndoth, shin)", "__fmul_rn(ndoth, shin)")],
    "rgb_tex_no_stage": [("rgb.cu", TEX_STAGE, "")],
    "rgb_tex_no_sky_path": [("rgb.cu", "if (TEX && in && !is_hit) {", "if (false) {"),
                            ("rgb.cu", "if (in && (!TEX || is_hit)) {", "if (in) {")],
    **{f"rgb_tex_blocks{n}": [("rgb.cu", TEX_BOUND, f"constexpr int kMinBlocksTex = {n};")]
       for n in (4, 5, 6)},
    **{f"hm_warps{n}": [("heatmap.cu", "constexpr int kWarps = 16;",
                         f"constexpr int kWarps = {n};")] for n in (8, 32)},
    # The segment walk with 2 or 8 warps sharing a set in place of 4, or
    # one set a block in place of 2 (a block's threads change with both;
    # 512 threads take one block's register bound, 85 a thread).
    "mesh_seg_split2": [("meshsweep.cu", "constexpr int kSegSplit = 4;",
                         "constexpr int kSegSplit = 2;")],
    "mesh_seg_split8": [("meshsweep.cu", "constexpr int kSegSplit = 4;",
                         "constexpr int kSegSplit = 8;"),
                        ("meshsweep.cu", SEG_BOUNDS,
                         SEG_BOUNDS.replace("3)", "1)"))],
    "mesh_seg_sets1": [("meshsweep.cu", "constexpr int kSegSets = 2;",
                        "constexpr int kSegSets = 1;")],
    # The segment walk's pair tests, then all its walk but the box phase
    # and the blocks' box spheres, taken out (their outputs differ).
    "mesh_seg_no_pairs": [("meshsweep.cu", "      while (bits != 0u) {",
                           "      while (bits != 0u && bits == 0u) {")],
    "mesh_seg_no_walk": [("meshsweep.cu", "    if (item >= n_items) break;",
                          "    if (item >= 0) break;")],
}


def build(name: str, csrc: Path, edits, sources):
    """Copy ``csrc`` to build/kernel_variants/<name>/, apply ``edits`` and
    compile its ``sources`` into one library with the package's nvcc
    flags. Returns the library's path and ptxas's report."""
    work = ROOT / "build" / "kernel_variants" / name
    shutil.rmtree(work, ignore_errors=True)
    shutil.copytree(csrc, work)
    for src, old, new in edits:
        f = work / src
        text = f.read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: {src} holds {text.count(old)} copies of {old!r}")
        f.write_text(text.replace(old, new))
    lib = work / "lib.so"
    cmd = [kernels.nvcc(), *kernels.ARCH_FLAGS, *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-shared",
           "-o", str(lib), *(str(work / f) for f in sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{name}: nvcc failed\n{proc.stdout}{proc.stderr}")
    return lib, proc.stdout + proc.stderr


def sass(path: Path) -> dict:
    """{kernel: its machine code as ``cuobjdump -sass`` lists it} of the
    library at ``path``; the addresses are a function's own, so two builds
    of the same code give the same text."""
    cuobjdump = Path(kernels.nvcc()).parent / "cuobjdump"
    proc = subprocess.run([str(cuobjdump), "-sass", str(path)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"cuobjdump failed on {path}: {proc.stderr}")
    out, name = {}, None
    for line in proc.stdout.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = kernels.kernel_name(m.group(1))
            out[name] = []
        elif name is not None and line.strip():
            out[name].append(line.strip())
    return {k: "\n".join(v) for k, v in out.items()}


def sass_match(a: str, b) -> str:
    """"same" where two kernels' machine code is the same text, else
    "differs" and the lines that do."""
    if a == b:
        return "same"
    if b is None:
        return "absent"
    x, y = a.splitlines(), b.splitlines()
    n = sum(1 for d in difflib.unified_diff(y, x, n=0, lineterm="")
            if d[:1] in "+-" and d[:3] not in ("+++", "---"))
    return f"differs ({n} lines of {len(y)})"


def load(path: Path):
    """The library at ``path``, with the entry points it has typed (an
    earlier build may lack the newer ones)."""
    lib = ctypes.CDLL(str(path))
    for entry, argtypes in kernels.SIGNATURES.items():
        if hasattr(lib, entry):
            getattr(lib, entry).argtypes = argtypes
            getattr(lib, entry).restype = ctypes.c_int
    return lib


def call(lib, entry, *args):
    import torch
    conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    err = getattr(lib, entry)(*conv, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry} returned {err}")


def device_ms(fn, key, iters):
    """Mean device milliseconds per launch of the kernels whose name holds
    ``key``, from torch.profiler over ``iters`` calls after a warm-up."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA and key in e.key]
    seen = sum(e.count for e in evs)
    if not 0 < seen <= iters:
        raise RuntimeError(f"profiler saw {key} launched {seen} times in {iters} calls")
    return sum(e.self_device_time_total for e in evs) / 1000.0 / seen


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--against", help="a directory of CUDA sources with the same entry points")
    ap.add_argument("--only", help="comma-separated names of VARIANTS to build (default all)")
    ap.add_argument("--kernels", default="rgb,heatmap,mesh",
                    help="comma-separated kernels to hold and time: rgb, heatmap, mesh")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--out", default="build/kernel_variants.json")
    args = ap.parse_args()
    kinds_run = set(args.kernels.split(","))
    srcs = sorted(SOURCES[k] for k in kinds_run)
    import torch

    if not torch.cuda.is_available():
        print("kernel_variants: needs a CUDA device", file=sys.stderr)
        return 3
    from constructionsceneposeestimation_tpu_torch.config import Config, PipelineConfig
    from constructionsceneposeestimation_tpu_torch.core import camera as cam_mod
    from constructionsceneposeestimation_tpu_torch.parallel.pipeline import Pipeline
    from constructionsceneposeestimation_tpu_torch.render import (annotate, meshcast, raycast,
                                                                 rgb_kernel, textures)
    from constructionsceneposeestimation_tpu_torch.scene import world as world_mod

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    print(f"card: {card} | torch {torch.__version__} | CUDA {torch.version.cuda}", flush=True)

    names = [n for n in args.only.split(",") if n] if args.only is not None else list(VARIANTS)
    builds = {"this": (kernels.CSRC, []), **{n: (kernels.CSRC, VARIANTS[n]) for n in names}}
    if args.against:
        builds["against"] = (Path(args.against).resolve(), [])
    with ThreadPoolExecutor(max_workers=8) as pool:
        built = dict(zip(builds, pool.map(lambda kv: build(kv[0], *kv[1], srcs),
                                          builds.items())))
    libs = {name: load(p) for name, (p, _) in built.items()}
    regs = {name: kernels.parse_ptxas(r) for name, (_, r) in built.items()}
    print(f"built {len(libs)} libraries; registers a thread: {json.dumps(regs)}", flush=True)
    # Each library's machine code against --against's, kernel by kernel.
    sass_same = {}
    if args.against:
        theirs = sass(built["against"][0])
        for name, (path, _) in built.items():
            if name == "against":
                continue
            mine = sass(path)
            sass_same[name] = {k: sass_match(mine[k], theirs.get(k)) for k in sorted(mine)}
            print(f"[sass] {name} vs against, each kernel's machine code: "
                  f"{json.dumps(sass_same[name])}", flush=True)

    # The datagen kernels' inputs, as chip_smoke.py builds them.
    dev = torch.device("cuda", 0)
    cfg = Config(pipeline=PipelineConfig(render_width=RES, render_height=RES, batch_size=B))
    pipe = Pipeline(cfg, device=dev)
    hpipe = Pipeline(cfg, device=dev, hifi_mesh=True)
    intr = pipe.intr
    inputs = pipe.sample_inputs(SEED, list(range(B)))
    world = world_mod.build_world(pipe.roster, inputs.pose)
    M = cam_mod.look_at_matrix(inputs.cam_pos, inputs.target)

    def pixels(sweeper):
        """The RGB kernel's t and instance from ``sweeper``'s pixel sweep,
        the far clip applied."""
        t, code = raycast._unpack(sweeper(world, inputs.cam_pos, M))
        t = torch.where(t < raycast.INF * 0.99, t, float("inf")).reshape(B, RES, RES)
        inst = (code - 2).reshape(B, RES, RES)
        depth = t * torch.sum(cam_mod.pixel_rays(intr, M) * (-M[:, :, 0])[:, None, None, :], -1)
        clipped = depth >= cfg.camera.clipping[1]
        return (torch.where(clipped, float("inf"), t).contiguous(),
                torch.where(clipped, -2, inst).to(torch.int32).contiguous())

    # The proxy geometry's pixels, and the hifi tier's on the same frames
    # (held for the textured variant, as chip_smoke.py's [textures] does).
    geoms = {"proxy": pixels(pipe.sweeper), "hifi": pixels(hpipe.sweeper)}
    t, inst = geoms["proxy"]
    table = rgb_kernel.instance_table(pipe.roster, world["inst_rot"], world["inst_pos"])
    ao = rgb_kernel.ao_table(pipe.roster, world["inst_pos"])
    texels = textures.dense_table(textures.load_factors()).to(dev)
    lit_off = inputs.lighting._replace(tex_strength=torch.zeros_like(inputs.lighting.tex_strength))
    pars = {"noise off": rgb_kernel.rgb_params(M, inputs.cam_pos, intr, lit_off),
            "noise on": rgb_kernel.rgb_params(M, inputs.cam_pos, intr, inputs.lighting)}
    ann = annotate.render_frame(pipe.roster, pipe.caster, pipe.sweeper, world, inputs.cam_pos,
                                inputs.target, intr, inputs.lighting, shade_rgb=False)
    kc = pipe.roster.tensor("inst_kpt_channel", dev).reshape(1, -1).expand(B, -1)
    uv = ann.kpt_uv.reshape(B, -1, 2).contiguous()
    vis = (ann.kpt_visible.reshape(B, -1) & (kc >= 0)).contiguous().view(torch.uint8)
    ch = torch.clamp_min(kc, 0).to(torch.int32).contiguous()
    C, h = pipe.num_channels, RES // cfg.pipeline.heatmap_stride
    two_s2 = float(torch.tensor(2.0 * cfg.pipeline.heatmap_sigma ** 2, dtype=torch.float32))

    # The tier variants' planes: the exact caster's normals and the
    # sun-shadow rays' t from these hit points.
    rd = cam_mod.pixel_rays(intr, M)
    normal = pipe.caster.cast(world, inputs.cam_pos, rd.reshape(B, -1, 3))["normal"]
    normal = normal.reshape(B, RES, RES, 3).contiguous()
    sun = -inputs.lighting.sun_dir
    p_hit = (inputs.cam_pos[:, None, None] + torch.where(torch.isfinite(t), t, 0.0)[..., None] * rd
             + (sun * 1e-3)[:, None, None])
    shadow = pipe.caster.fast_multi_origin(world, p_hit.reshape(B, -1, 3),
                                           sun[:, None].expand(B, RES * RES, 3))["t"]
    shadow = shadow.reshape(B, RES, RES).contiguous()
    del rd, p_hit

    # The mesh sweep's inputs.
    hin = hpipe.sample_inputs(MESH_SEED, range(MESH_B))
    hw = world_mod.build_world(hpipe.roster, hin.pose)
    mesh, o = hpipe.caster.mesh, hin.cam_pos.contiguous()
    hM = cam_mod.look_at_matrix(hin.cam_pos, hin.target)
    hkp = world_mod.world_keypoints(hw["inst_rot"], hw["inst_pos"], hw["kpts_local"])
    rays = {"pixels": cam_mod.pixel_rays(intr, hM).reshape(MESH_B, -1, 3).contiguous(),
            "segments": (hkp.reshape(MESH_B, -1, 3) - o[:, None]).contiguous()}
    m = mesh.mesh_terms(hw, o)
    codes = mesh._on(dev)["codes"]

    def rgb(lib, par, tier=0, tex=False, geom="proxy"):
        """One image of ``lib``'s RGB kernel: tier ``tier``, textured where
        ``tex``, on geometry ``geom``'s pixels."""
        gt, gi = geoms[geom]
        out = torch.empty(B, RES, RES, 3, dtype=torch.uint8, device=dev)
        tx = texels if tex else None
        if tier == 0:
            call(lib, "cspe_rgb", gt, gi, table, table.shape[1], ao, ao.shape[1], par, tx, B,
                 RES, RES, out)
        else:
            call(lib, "cspe_rgb_tier", gt, gi, table, table.shape[1], ao, ao.shape[1], par, tx,
                 normal if tier & 1 else None, shadow if tier & 2 else None, tier, B, RES, RES,
                 out)
        return out

    def tiers(lib):
        """{name: (tier, textured)} of the RGB instantiations ``lib`` has."""
        if "rgb" not in kinds_run or not hasattr(lib, "cspe_rgb"):
            return {}
        if not hasattr(lib, "cspe_rgb_tier"):
            return {"default": (0, False)}
        return {**{n: (tier, False) for n, tier in TIERS.items()},
                **{n: (tier, True) for n, tier in TEX_TIERS.items()}}

    def sweep(lib, d, walk):
        lay = mesh.layout(d.shape[1])
        out = torch.empty(d.shape[:2], dtype=torch.float32, device=dev)
        call(lib, "cspe_mesh_sweep", m.terms, m.spheres, m.lo, m.hi, codes, o, d, MESH_B,
             m.lo.shape[1], d.shape[1], lay.groups, lay.rays, lay.grid_w, lay.side,
             meshcast.WALKS[walk], out, None, None)
        return out

    def walks(lib):
        """The (kind, walk) pairs the library's cspe_mesh_sweep takes."""
        if "mesh" not in kinds_run or not hasattr(lib, "cspe_mesh_sweep"):
            return []
        out = []
        for kind, ws in MESH_WALKS.items():
            for walk in ws:
                try:
                    sweep(lib, rays[kind], walk)
                except RuntimeError:  # an earlier build without this walk
                    continue
                out.append((kind, walk))
        return out

    def heat(lib):
        out = torch.empty(B, C, h, h, dtype=torch.float32, device=dev)
        call(lib, "cspe_heatmap", uv, ch, vis, B, uv.shape[1], C, h, h,
             float(cfg.pipeline.heatmap_stride), two_s2, out)
        return out

    report = {"card": card, "registers": regs, "sass_same": sass_same, "compare": {}, "ms": {}}
    kinds = {g: {"sky": gi == -2, "ground": gi == -1, "objects": gi >= 0}
             for g, (_, gi) in geoms.items()}
    ref = {}
    ref_hm = heat(libs["this"]) if "heatmap" in kinds_run else None
    ref_mesh = {(k, v): sweep(libs["this"], rays[k], v) for k, v in walks(libs["this"])}
    for name, lib in libs.items():
        if name == "this":
            continue
        res = {}
        cases = [(k, p, 0, False, "proxy") for k, p in pars.items() if tiers(lib)] + [
            (f"{n}, noise on", pars["noise on"], tier, False, "proxy")
            for n, (tier, tex) in tiers(lib).items() if tier and not tex] + [
            (f"{n}, {g}, {k}", p, tier, True, g) for n, (tier, tex) in tiers(lib).items() if tex
            for g in geoms for k, p in pars.items()]
        for k, p, tier, tex, g in cases:
            if k not in ref:
                ref[k] = rgb(libs["this"], p, tier, tex, g)
            img = rgb(lib, p, tier, tex, g)
            diff = (img != ref[k]).any(-1)
            n = int(diff.sum())
            res[f"rgb {k}"] = {
                "bit_equal": n == 0, "pixels_differ": n, "of": diff.numel(),
                "max_abs_u8": int((img.int() - ref[k].int()).abs().max()),
                **{f"on {kk}": int((diff & m).sum()) for kk, m in kinds[g].items()}}
        if "heatmap" in kinds_run and hasattr(lib, "cspe_heatmap"):
            hm = heat(lib)
            res["heatmaps"] = {"bit_equal": bool(torch.equal(hm, ref_hm)),
                               "max_abs": float((hm - ref_hm).abs().max())}
        for k, v in walks(lib):
            differ = int((sweep(lib, rays[k], v).view(torch.int32)
                          != ref_mesh[k, v].view(torch.int32)).sum())
            res[f"mesh sweep {k}, {v} walk"] = {"bit_equal": differ == 0, "rays_differ": differ,
                                                "of": ref_mesh[k, v].numel()}
        torch.cuda.synchronize()
        report["compare"][name] = res
        for k, r in res.items():
            print(f"[compare] {name} vs this, {k}: {json.dumps(r)}", flush=True)

    order = list(libs)
    for name in order + order[1:][::-1] + order[:1]:
        lib = libs[name]
        r = report["ms"].setdefault(name, {})
        for tn, (tier, tex) in tiers(lib).items():
            key = "rgb_kernel" if tn == "default" else f"rgb_kernel {tn}"
            r.setdefault(key, []).append(device_ms(
                lambda: rgb(lib, pars["noise on"], tier, tex), "rgb_kernel", args.iters))
        if "heatmap" in kinds_run and hasattr(lib, "cspe_heatmap"):
            r.setdefault("heatmap_kernel", []).append(
                device_ms(lambda: heat(lib), "heatmap_kernel", args.iters))
        for k, v in walks(lib):
            r.setdefault(f"mesh sweep {k}, {v} walk", []).append(
                device_ms(lambda: sweep(lib, rays[k], v), MESH_KERNELS[v], args.iters))
    for name, r in report["ms"].items():
        print(f"[time] {name}: " + "; ".join(f"{k} {', '.join(f'{x:.4f}' for x in v)} ms"
                                             for k, v in r.items())
              + f" (device time a launch; RGB 64 x 512^2, heatmaps 71 x 128^2, mesh sweep "
              f"{MESH_B} x 512^2 hifi; {card})", flush=True)
    out = ROOT / args.out
    out.parent.mkdir(parents=True, exist_ok=True)
    report["builds"] = {name: {"csrc": str(b[0]), "edits": b[1]} for name, b in builds.items()}
    out.write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
