"""The batched datagen step (port of ``Pipeline.make_generate_fn`` of the
JAX ``parallel/pipeline.py``).

``generate(seed, frame_ids)`` samples scene placements on the reference's
10-frame cadence (one scene per group of ``cadence`` consecutive frames,
sampled once per batch and gathered: the scene-cadence dedup), a camera
and a light per frame, then renders and annotates every frame and rasterizes
the heatmap targets, all with the batch dimension written out.

Cameras: the DR sampler; with ``ladder=True`` the reference's 41-entry
systematic ladder (frame f takes entry f % 41); with ``camera_mix=p`` (the
training stream) a per-frame coin picks the ladder entry with probability
p, else the DR camera.

Sequence mode (``make_sequence_fn``): frame f belongs to clip f //
seq_len at time fraction (f % seq_len) / (seq_len - 1); each clip present
in the batch samples its two endpoint scenes, camera flight and light once
(``sample/sequence.py``), and every frame interpolates its own.

The hifi tier (``hifi_mesh=True``): baked CAD triangles replace the
proxies of the cones, fences, trees and the worker (``render/meshcast.py``)
in the pixel sweep, as the pixel-sweep kernel on the schedule without them
merged with the triangle sweep, and in the keypoint segments.

The image-texture tier (``image_textures=True``): the RGB of every frame
goes through the RGB kernel's textured variant with the texel table of
``render/textures.py`` (built on the host at construction, moved to the
device with the first batch); the labels are the untextured render's. It
composes with the hifi tier and with clips.

``procedural_textures=False`` shades the flat table albedo (no patterns,
image textures or contact AO: the RGB kernel's flat variant), as the JAX
``Pipeline`` field does; the labels are unchanged.

Multi-GPU (``make_sharded_generate``): each rank of a ``torch.distributed``
group generates its contiguous rows of the frame ids; a frame depends
only on (seed, frame id) and its scene group, so this adds no
communication. ``gather_rows`` brings every rank's rows to every rank in
frame order, for checks.

Random numbers: each scene group and each frame has its own CPU
``torch.Generator`` stream (utils/prng.py), so a frame's scene, camera and
light do not depend on the batch it falls in; in sequence mode each clip
has three. The camera-mix coin has a stream of its own, so the mix leaves
every other draw as it was. On the CPU the few thousand uniforms a batch
consumes are drawn on the host and moved to the device in one copy. On the
card the i.i.d. path uploads only the batch's frame and group ids and
``csrc/draws.cu`` replays the same streams there, bit for bit
(``sample/replay.py``); clips still draw on the host. The sampling
arithmetic then runs on the device.

Spans (``utils/profiling.annotate``; free with no profiler active): a batch
is ``gen.batch``; its sampling ``gen.sample``, split into the draws
(``gen.sample.draws``: the host loops, or on the card the replay kernel's
launch, ``gen.sample.draws.replay``; both hold the one copy,
``gen.sample.upload``) and the device arithmetic (``gen.sample.scene``); its
render ``gen.render``, split into ``render_frame``'s stages
(``render/annotate.py``) and ``gen.render.heatmaps``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Sequence

import torch

from ..config import Config
from ..core import camera as cam_mod
from ..ops import heatmap as heatmap_ops
from ..render import annotate, meshcast, raycast, shading, textures
from ..render.sweep_kernel import PixelSweeper
from ..sample import camera_sampler, lighting as lighting_mod, placement
from ..sample import replay, sequence as seq_mod
from ..scene import assets, world as world_mod
from ..utils import prng
from ..utils.profiling import annotate as span
from . import mesh as mesh_mod

Tensor = torch.Tensor


class FrameBatch(NamedTuple):
    """Everything the writers need, per frame (leading batch dim)."""

    frame_id: Tensor  # (B,) int32
    rgb: Tensor  # (B, H, W, 3) uint8
    depth: Tensor  # (B, H, W) f32 (inf on sky)
    instance: Tensor  # (B, H, W) int32
    camera_pose7: Tensor  # (B, 7)
    inst_visible: Tensor  # (B, O) bool
    inst_pixel_count: Tensor  # (B, O) int32
    bbox2d: Tensor  # (B, O, 4) int32
    center: Tensor  # (B, O, 3)
    size: Tensor  # (B, O, 3)
    euler_deg: Tensor  # (B, O, 3)
    kpt_uv: Tensor  # (B, O, K, 2)
    kpt_visible: Tensor  # (B, O, K) bool
    kpt_in_image: Tensor  # (B, O, K) bool
    heatmaps: Tensor  # (B, C, h, w) f32
    pointcloud_count: Tensor  # (B,) int32


class FrameInputs(NamedTuple):
    """The sampled inputs of a batch: scene, camera and light per frame, and
    from ``sample_inputs`` the frame ids on the pipeline's device."""

    pose: world_mod.ScenePose
    cam_pos: Tensor  # (B, 3)
    target: Tensor  # (B, 3)
    lighting: shading.Lighting
    frame_id: Tensor | None = None  # (B,) int32


@dataclasses.dataclass
class Pipeline:
    """The generate step for a fixed ``Config`` on one ``device``: the card
    unless the caller passes ``device="cpu"``. Nothing touches the device
    until the first batch, which raises where there is no card.
    ``hifi_mesh=True`` renders the baked CAD meshes of the hifi tier; the
    labels stay the templates'. ``image_textures=True`` shades the RGB with
    the image-texture tier, ``procedural_textures=False`` with the flat
    albedo."""

    cfg: Config
    device: str | torch.device = "cuda"
    hifi_mesh: bool = False
    image_textures: bool = False
    procedural_textures: bool = True

    def __post_init__(self):
        # Geometry is f32: no TF32 in matmuls or convolutions.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.device = torch.device(self.device)
        pc = self.cfg.pipeline
        self.roster = world_mod.make_roster(self.cfg.scene)
        self.intr = cam_mod.intrinsics_from_apertures(
            self.cfg.camera.focal_length, self.cfg.camera.horizontal_aperture,
            pc.render_width, pc.render_height)
        if self.hifi_mesh:
            self.caster = meshcast.HifiCaster(self.roster,
                                              grid_hw=(pc.render_height, pc.render_width))
            self.sweeper = meshcast.HifiSweeper(self.roster, self.intr, self.caster)
        else:
            self.caster = raycast.Raycaster(self.roster)
            self.sweeper = PixelSweeper(self.roster, self.intr, self.caster)
        self.hm_w = pc.render_width // pc.heatmap_stride
        self.hm_h = pc.render_height // pc.heatmap_stride
        self.num_channels = assets.NUM_KEYPOINT_CHANNELS
        self._texels = (textures.dense_table(textures.load_factors())
                        if self.image_textures else None)
        self.word_layout = replay.word_layout(self.cfg.scene, self.cfg.randomization)

    def texels(self) -> Tensor | None:
        """The texel table on the pipeline's device (moved there at the
        first call), or None without the image-texture tier."""
        if self._texels is not None and self._texels.device != self.device:
            self._texels = self._texels.to(self.device)
        return self._texels

    def ladder(self):
        """The systematic ladder: (cam_pos (N, 3), target (N, 3)) on the
        CPU, N = ``max_iterations``, drawn from the pipeline seed."""
        pc = self.cfg.pipeline
        return camera_sampler.systematic_camera_positions(
            pc.max_iterations, prng.generator(pc.seed, prng.LADDER_STREAM))

    def sample_inputs(self, seed: int, frame_ids: Sequence[int], ladder=None,
                      camera_mix: float | None = None) -> FrameInputs:
        """Scenes (one per cadence group present), cameras and lights.
        ``ladder`` (cam_pos, target) replaces the DR cameras, or with
        ``camera_mix`` a frame's coin chooses between the two. On the card the
        draws are replayed there (``sample/replay.py``), on the CPU drawn by
        the host loop; both give the same bits."""
        with span("gen.sample"):
            cfg = self.cfg
            coins = ladder is not None and camera_mix is not None
            with span("gen.sample.draws"):
                fids = [int(f) for f in frame_ids]
                cadence = cfg.randomization.cadence_frames
                groups = sorted({f // cadence for f in fids})
                at = {g: i for i, g in enumerate(groups)}
                gidx = [at[f // cadence] for f in fids]
                draws = self._replayed_draws if self.device.type == "cuda" else self._host_draws
                dev = draws(seed, fids, groups, gidx, ladder, coins)

            with span("gen.sample.scene"):
                poses, _ = placement.randomize_scene(dev, self.roster, cfg.scene,
                                                     cfg.randomization, articulate_crane=True)
                n_cam = camera_sampler.CAMERA_DRAWS
                cam_pos, target = camera_sampler.cameras_from_draws(dev["frame"][:, :n_cam],
                                                                    cfg.camera)
                if ladder is not None:
                    use = (dev["coin"] < camera_mix) if coins else None
                    cam_pos, target = camera_sampler.mix_cameras(
                        use, dev["ladder_cam"], dev["ladder_tgt"], cam_pos, target)
                lit = lighting_mod.lighting_from_draws(dev["frame"][:, n_cam:], cfg.lighting)
                return FrameInputs(poses.index(dev["gidx"].long()), cam_pos, target, lit,
                                   dev["frame_id"])

    def _host_draws(self, seed: int, fids, groups, gidx, ladder,
                    coins: bool) -> Dict[str, Tensor]:
        """The host's draws (``replay.host_draws``), with the ladder entries
        (f % n) gathered on the host, moved to the device in one copy."""
        cfg = self.cfg
        host = replay.host_draws(seed, fids, groups, cfg.randomization.cadence_frames,
                                 cfg.scene, cfg.randomization, coins)
        host["gidx"] = torch.tensor(gidx, dtype=torch.float32)
        if ladder is not None:
            n = ladder[0].shape[0]
            idx = torch.tensor([f % n for f in fids])
            host["ladder_cam"], host["ladder_tgt"] = ladder[0][idx], ladder[1][idx]
        dev = _to_device(host, self.device)
        dev["frame_id"] = torch.tensor(fids, dtype=torch.int32, device=self.device)
        return dev

    def _replayed_draws(self, seed: int, fids, groups, gidx, ladder,
                        coins: bool) -> Dict[str, Tensor]:
        """The card's draws: one copy of the word layout and the ids from
        pinned memory (no synchronise), then the replay kernel; the ladder
        entries (f % n) are gathered on the card."""
        table = [v for row in self.word_layout.table for v in row]
        B, G = len(fids), len(groups)
        with span("gen.sample.upload"):
            ids = torch.tensor(table + fids + groups + gidx, dtype=torch.int32).pin_memory()
            ids = ids.to(self.device, non_blocking=True)
        table, frame_id, group_id, gidx = ids.split([len(table), B, G, B])
        with span("gen.sample.draws.replay"):
            dev = replay.replay_cuda(self.word_layout, seed, table, frame_id, group_id, coins)
        dev.update(frame_id=frame_id, gidx=gidx)
        if ladder is not None:
            idx = torch.remainder(frame_id, ladder[0].shape[0])
            dev["ladder_cam"] = ladder[0].to(self.device).index_select(0, idx)
            dev["ladder_tgt"] = ladder[1].to(self.device).index_select(0, idx)
        return dev

    def sample_sequence_inputs(self, seed: int, frame_ids: Sequence[int],
                               seq_len: int) -> FrameInputs:
        """Clip frames' inputs: each clip present in ``frame_ids`` samples its
        endpoint scenes, camera flight and light once, from its own streams
        (``prng.clip_generator``); each frame interpolates its clip's
        endpoints and flight at t = (f % seq_len) / max(seq_len - 1, 1)."""
        with span("gen.sample"):
            cfg = self.cfg
            with span("gen.sample.draws"):
                fids = [int(f) for f in frame_ids]
                clips = sorted({f // seq_len for f in fids})
                draws_a, draws_b, cams, lights = [], [], [], []
                for c in clips:
                    gen = prng.clip_generator(seed, c, prng.CLIP_ENDPOINTS)
                    draws_a.append(placement.scene_draws(gen, cfg.scene, cfg.randomization))
                    draws_b.append(placement.resample_draws(gen, cfg.scene, cfg.randomization))
                    gen = prng.clip_generator(seed, c, prng.CLIP_CAMERA)
                    cams.append(torch.cat([camera_sampler.camera_draws(gen, 1)[0],
                                           torch.rand(5, generator=gen)]))
                    lights.append(lighting_mod.lighting_draws(
                        prng.clip_generator(seed, c, prng.CLIP_LIGHT), 1)[0])
                host = {f"{end}{k}": v for end, d in (("a.", draws_a), ("b.", draws_b))
                        for k, v in placement.stack_draws(d).items()}
                host.update(cam=torch.stack(cams), light=torch.stack(lights),
                            cidx=torch.tensor([clips.index(f // seq_len) for f in fids],
                                              dtype=torch.float32),
                            t=torch.tensor([f % seq_len for f in fids], dtype=torch.float32)
                            / max(seq_len - 1, 1))
            dev = _to_device(host, self.device)
            with span("gen.sample.scene"):
                end = lambda e: {k[2:]: v for k, v in dev.items() if k.startswith(e)}
                pa, pb = seq_mod.sequence_endpoints(end("a."), end("b."), self.roster,
                                                    cfg.scene, cfg.randomization)
                cidx, t = dev["cidx"].long(), dev["t"]
                pose = seq_mod.interpolate_pose(pa.index(cidx), pb.index(cidx), t, self.roster)
                n_cam = camera_sampler.CAMERA_DRAWS
                cam = dev["cam"][cidx]
                cam0, tgt0 = camera_sampler.cameras_from_draws(cam[:, :n_cam], cfg.camera)
                cam_pos, target = seq_mod.sequence_camera(cam0, tgt0, cam[:, n_cam:] * 2.0 - 1.0,
                                                          t, cfg.camera)
                lit = lighting_mod.lighting_from_draws(dev["light"][cidx], cfg.lighting)
                return FrameInputs(pose, cam_pos, target, lit)

    def render(self, frame_ids: Tensor, inputs: FrameInputs,
               include_heatmaps: bool = True) -> FrameBatch:
        with span("gen.render"):
            cfg = self.cfg
            pc = cfg.pipeline
            with span("gen.render.world"):
                world = world_mod.build_world(self.roster, inputs.pose)
            ann = annotate.render_frame(
                self.roster, self.caster, self.sweeper, world, inputs.cam_pos, inputs.target,
                self.intr, inputs.lighting, shade_rgb=pc.write_rgb,
                bug_compatible=pc.bug_compatible_schema, far_clip=cfg.camera.clipping[1],
                texels=self.texels(), procedural_textures=self.procedural_textures)
            B = frame_ids.shape[0]
            with span("gen.render.heatmaps"):
                if include_heatmaps:
                    hms = heatmap_ops.frame_heatmaps(
                        ann.kpt_uv, ann.kpt_visible,
                        self.roster.tensor("inst_kpt_channel", self.device), self.num_channels,
                        self.hm_h, self.hm_w, pc.heatmap_sigma, pc.heatmap_stride)
                else:
                    hms = torch.zeros(B, 0, self.hm_h, self.hm_w, device=self.device)
            return FrameBatch(
                frame_id=frame_ids, rgb=ann.rgb, depth=ann.depth, instance=ann.instance,
                camera_pose7=ann.camera_pose7, inst_visible=ann.inst_visible,
                inst_pixel_count=ann.inst_pixel_count, bbox2d=ann.bbox2d, center=ann.center,
                size=ann.size, euler_deg=ann.euler_deg, kpt_uv=ann.kpt_uv,
                kpt_visible=ann.kpt_visible, kpt_in_image=ann.kpt_in_image, heatmaps=hms,
                pointcloud_count=ann.pointcloud_count)

    def make_generate_fn(self, ladder: bool = False, include_heatmaps: bool = True,
                         camera_mix: float | None = None):
        """``generate(seed: int, frame_ids) -> FrameBatch``.

        ``ladder=True`` takes the systematic ladder's cameras; ``camera_mix``
        (training streams) a per-frame Bernoulli(p) choice of the ladder
        over the DR sampler. ``include_heatmaps=False`` (the dataset-writing
        path) returns a zero-channel heatmap array instead of rasterizing
        targets."""
        cams = self.ladder() if ladder or camera_mix is not None else None

        def generate(seed: int, frame_ids: Sequence[int]) -> FrameBatch:
            nonlocal cams
            with span("gen.batch"):
                if cams is not None and cams[0].device != self.device:
                    cams = tuple(c.to(self.device) for c in cams)  # once, at the first batch
                inputs = self.sample_inputs(seed, frame_ids, cams, camera_mix)
                return self.render(inputs.frame_id, inputs, include_heatmaps)

        return generate

    def make_sequence_fn(self, seq_len: int = 30, include_heatmaps: bool = True):
        """``generate(seed: int, frame_ids) -> FrameBatch`` of temporally
        coherent clips (``sample_sequence_inputs``): the contract of
        ``make_generate_fn``, so every writer and evaluator takes clips as
        they are."""

        def generate(seed: int, frame_ids: Sequence[int]) -> FrameBatch:
            with span("gen.batch"):
                fids = torch.as_tensor([int(f) for f in frame_ids], dtype=torch.int32)
                inputs = self.sample_sequence_inputs(seed, fids.tolist(), seq_len)
                return self.render(fids.to(self.device), inputs, include_heatmaps)

        return generate


    def make_sharded_generate(self, mesh=None, ladder: bool = False):
        """``(generate, mesh)``: ``generate(seed, frame_ids)`` returns this
        rank's contiguous rows of the batch (``mesh.batch_sharding``), on the
        ``data`` mesh (``mesh.make_mesh()`` by default); ``mesh.gather_rows``
        assembles the whole batch where a caller needs it."""
        mesh = mesh or mesh_mod.make_mesh(device_type=self.device.type)
        gen = self.make_generate_fn(ladder=ladder)

        def generate(seed: int, frame_ids: Sequence[int]) -> FrameBatch:
            ids = [int(f) for f in frame_ids]
            return gen(seed, [ids[i] for i in mesh_mod.batch_sharding(mesh, len(ids))])

        return generate, mesh


class HostCopy:
    """A ``FrameBatch`` on its way to the host, for the writers.

    On the card every field is copied into pinned host memory on a stream
    of its own, which first waits on an event recorded where the batch's
    work ends. So the copy of batch i is queued before batch i+1 is
    generated and runs beside it, where a copy on the generating stream
    would wait for batch i+1's kernels. ``wait()`` blocks on that copy's
    event only and returns the batch as numpy views of the pinned buffers.
    A batch on the CPU is its own host copy (numpy views)."""

    def __init__(self, batch: FrameBatch):
        self._done = None
        if batch.frame_id.device.type != "cuda":
            self._host = list(batch)
            return
        dev = batch.frame_id.device
        made = torch.cuda.Event()
        made.record(torch.cuda.current_stream(dev))
        stream = torch.cuda.Stream(dev)
        stream.wait_event(made)
        self._host = []
        with torch.cuda.stream(stream):
            for v in batch:
                h = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                h.copy_(v, non_blocking=True)
                v.record_stream(stream)  # not reused by the allocator before the copy ends
                self._host.append(h)
        self._done = torch.cuda.Event()
        self._done.record(stream)

    def wait(self) -> FrameBatch:
        if self._done is not None:
            self._done.synchronize()
        return FrameBatch(*(v.numpy() for v in self._host))


def _to_device(host: Dict[str, Tensor], device: torch.device) -> Dict[str, Tensor]:
    """Move a dict of float tensors to ``device`` in one copy."""
    with span("gen.sample.upload"):
        flat = torch.cat([v.reshape(-1) for v in host.values()]).to(device)
        out, i = {}, 0
        for k, v in host.items():
            out[k] = flat[i:i + v.numel()].reshape(v.shape)
            i += v.numel()
        return out


def quality_stats(batch: FrameBatch, min_points: int) -> Dict[str, Tensor]:
    """The DataQualityLogger counters: modality validity, object counts,
    point-cloud sufficiency."""
    pc_valid = batch.pointcloud_count >= min_points
    n_obj = torch.sum(batch.inst_visible, dim=-1)
    return {
        "total_frames": torch.tensor(batch.frame_id.shape[0]),
        "pointcloud_valid": torch.sum(pc_valid),
        "pointcloud_insufficient": torch.sum((batch.pointcloud_count > 0) & ~pc_valid),
        "pointcloud_empty": torch.sum(batch.pointcloud_count == 0),
        "labels_valid": torch.sum(n_obj > 0),
        "labels_empty": torch.sum(n_obj == 0),
        "objects_total": torch.sum(n_obj),
    }
