"""Sequence mode of the port (``sample/sequence.py``,
``placement.resample_animated``, ``Pipeline.make_sequence_fn``) held against
the JAX package on the same numbers, and its own invariants.

JAX runs only where the numbers are its own: the endpoints of one clip
sampled by the JAX ``sample_sequence_endpoints`` (one jit), handed to both
``interpolate_pose``; JAX's A camera and its 5 perturbation uniforms,
handed to both ``sequence_camera``. The math is f32 on both sides and held
to 1e-6 (relative, and absolute near 0). The port's frames come from its
CPU generate at 64^2."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from constructionsceneposeestimation_tpu.config import Config as JConfig
from constructionsceneposeestimation_tpu.sample import camera_sampler as jcs
from constructionsceneposeestimation_tpu.sample import sequence as jseq
from constructionsceneposeestimation_tpu.scene import world as jworld
from constructionsceneposeestimation_tpu_torch import convert
from constructionsceneposeestimation_tpu_torch.config import (Config, PipelineConfig,
                                                              RandomizationConfig, SceneConfig)
from constructionsceneposeestimation_tpu_torch.parallel.pipeline import Pipeline
from constructionsceneposeestimation_tpu_torch.sample import placement, sequence
from constructionsceneposeestimation_tpu_torch.scene import kinematics, world
from constructionsceneposeestimation_tpu_torch.utils import prng

torch.set_num_threads(2)
JCFG = JConfig()
TOL = dict(rtol=1e-6, atol=1e-6)
T = np.linspace(0.0, 1.0, 7, dtype=np.float32)


def test_smoothstep_and_lerp_angle_match_jax():
    rng = np.random.default_rng(0)
    t = rng.uniform(-0.5, 1.5, 64).astype(np.float32)
    np.testing.assert_allclose(sequence.smoothstep(torch.as_tensor(t)).numpy(),
                               np.asarray(jseq.smoothstep(jnp.asarray(t))), **TOL)
    a, b = (rng.uniform(-540.0, 540.0, 64).astype(np.float32) for _ in range(2))
    s = rng.uniform(0.0, 1.0, 64).astype(np.float32)
    got = sequence.lerp_angle_deg(*(torch.as_tensor(x) for x in (a, b, s))).numpy()
    np.testing.assert_allclose(got, np.asarray(jseq.lerp_angle_deg(a, b, s)), **TOL)
    # The shortest way round: 170 -> -170 passes through 180.
    mid = sequence.lerp_angle_deg(torch.tensor(170.0), torch.tensor(-170.0), torch.tensor(0.5))
    assert float(mid) == 180.0


@pytest.mark.parametrize("seed", [3, 11])
def test_interpolate_pose_matches_jax_on_jax_endpoints(seed):
    """Endpoints from the JAX sampler, through ``convert.scene_pose``; the
    pose at 7 time fractions on both sides."""
    jroster = jworld.make_roster(JCFG.scene)
    pa, pb = jax.jit(lambda k: jseq.sample_sequence_endpoints(
        k, jroster, JCFG.scene, JCFG.randomization))(jax.random.PRNGKey(seed))
    want = jax.vmap(lambda t: jseq.interpolate_pose(pa, pb, t, jroster))(jnp.asarray(T))
    roster = world.make_roster(SceneConfig())
    idx = torch.zeros(len(T), dtype=torch.long)
    got = sequence.interpolate_pose(convert.scene_pose(pa, batched=False).index(idx),
                                    convert.scene_pose(pb, batched=False).index(idx),
                                    torch.as_tensor(T), roster)
    for f in world.ScenePose._fields:
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   err_msg=f, **TOL)
    # The ends are the endpoints' animated degrees of freedom.
    np.testing.assert_allclose(got.crane_joints[-1, 1:].numpy(),
                               np.asarray(pb.crane_joints)[1:], **TOL)


def test_sequence_camera_matches_jax():
    """JAX's A camera and 5 uniforms (its key split as ``sequence_camera``
    splits it) handed to the port: the flight at 7 time fractions."""
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        ka, kd = jax.random.split(key)
        cams, tgts = jcs.sample_camera_batch(ka, 1, JCFG.camera)
        delta = jax.random.uniform(kd, (5,), minval=-1.0, maxval=1.0)
        want = jax.vmap(lambda t: jseq.sequence_camera(key, t, JCFG.camera))(jnp.asarray(T))
        n = len(T)
        rep = lambda x: torch.as_tensor(np.array(x)).expand(n, -1)
        got = sequence.sequence_camera(rep(cams), rep(tgts), rep(delta[None]),
                                       torch.as_tensor(T), Config().camera)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_resample_animated_keeps_statics_and_clears_them():
    """Mirrors tests/test_sequence.py on the port's sampler: endpoint B keeps
    every non-human instance of A; its crane joints lie within their limits;
    each accepted B (and A) worker clears every active static slot (crane,
    dumpers, cones) by the sum of radii, the crane's widened to B's reach."""
    scene_cfg = SceneConfig(n_cones=6, n_trees=2, n_fence_panels=8, n_humans=2, n_dumpers=2)
    cfg = RandomizationConfig()
    roster = world.make_roster(scene_cfg)
    h0, h1 = roster.human_slice
    gens = range(8)
    da_draws = placement.stack_draws([placement.scene_draws(
        prng.clip_generator(0, g, prng.CLIP_ENDPOINTS), scene_cfg, cfg) for g in gens])
    db_draws = placement.stack_draws([placement.resample_draws(
        prng.clip_generator(0, g, prng.CLIP_ENDPOINTS + 100), scene_cfg, cfg) for g in gens])
    pa, da = placement.randomize_scene(da_draws, roster, scene_cfg, cfg, articulate_crane=True)
    pb, db = placement.resample_animated(db_draws, roster, scene_cfg, cfg, pa, da)
    others = np.ones(roster.num_instances, bool)
    others[h0:h1] = False
    for f in ("positions", "yaw_deg"):
        assert torch.equal(getattr(pb, f)[:, others], getattr(pa, f)[:, others]), f
    assert torch.equal(pb.crane_pos, pa.crane_pos)
    assert torch.equal(pb.crane_yaw_deg, pa.crane_yaw_deg)
    lo = torch.as_tensor(kinematics.CRANE_JOINT_LOW)
    hi = torch.as_tensor(kinematics.CRANE_JOINT_HIGH)
    assert bool(((pb.crane_joints >= lo) & (pb.crane_joints <= hi)).all())
    assert not torch.equal(pb.crane_joints, pa.crane_joints)
    assert not torch.equal(pb.positions[:, h0:h1], pa.positions[:, h0:h1])

    h_slot0 = 1 + scene_cfg.n_dumpers
    crane_b = torch.maximum(da["crane_radius"], torch.clamp_min(
        kinematics.crane_reach_xy(pb.crane_joints) * 0.9, cfg.crane_min_radius))
    n_checked = 0
    for g in gens:
        placed_xy = da["placed_xy"][g].numpy()
        static = da["placed_r"][g].numpy() > 0
        static[h_slot0:h_slot0 + scene_cfg.n_humans] = False
        for pose, ok, crane_r in ((pa, da["human_ok"][g], da["crane_radius"][g]),
                                  (pb, db["human_ok"][g], crane_b[g])):
            radius = da["placed_r"][g].numpy().copy()
            radius[0] = float(crane_r)
            hxy = pose.positions[g, h0:h1, :2].numpy()[ok.numpy()]
            n_checked += hxy.shape[0]
            d = np.linalg.norm(hxy[:, None] - placed_xy[None, static], axis=-1)
            assert (d >= radius[None, static] + cfg.human_radius - 1e-4).all(), (g, d)
    assert n_checked >= 16


CFG = Config(pipeline=PipelineConfig(render_width=64, render_height=64))


@pytest.fixture(scope="module")
def pipe():
    return Pipeline(CFG, device="cpu")


def test_clip_inputs_are_framewise_and_coherent(pipe):
    """Clips of 4: frames 2-9 in one batch (a batch straddling three clips)
    give the same inputs as each frame alone; within a clip the statics and
    the light are bit-equal frame to frame while the camera and the crane
    move, by no more than the flight's bounds; a new clip re-samples."""
    L = 4
    fids = list(range(2, 10))
    batch = pipe.sample_sequence_inputs(7, fids, L)
    for i, f in enumerate(fids):
        one = pipe.sample_sequence_inputs(7, [f], L)
        for name, a, b in (("cam", batch.cam_pos[i], one.cam_pos[0]),
                           ("target", batch.target[i], one.target[0]),
                           *((f"pose.{k}", getattr(batch.pose, k)[i], getattr(one.pose, k)[0])
                             for k in world.ScenePose._fields),
                           *((f"light.{k}", getattr(batch.lighting, k)[i],
                              getattr(one.lighting, k)[0]) for k in batch.lighting._fields)):
            assert torch.equal(a, b), (f, name)
    again = pipe.sample_sequence_inputs(7, fids, L)
    assert all(torch.equal(a, b) for a, b in zip(batch.cam_pos, again.cam_pos))
    roster = pipe.roster
    h0, h1 = roster.human_slice
    statics = np.ones(roster.num_instances, bool)
    statics[h0:h1] = False
    statics[:4] = False  # the crane's parts
    clip = {2: [0, 1], 3: [2, 3, 4, 5], 4: [6, 7]}
    for c, rows in clip.items():
        for r in rows[1:]:
            assert torch.equal(batch.pose.positions[r, statics], batch.pose.positions[rows[0],
                                                                                   statics])
            for k in batch.lighting._fields:
                assert torch.equal(getattr(batch.lighting, k)[r],
                                   getattr(batch.lighting, k)[rows[0]]), k
    # Over clip 1 (frames 4-7, t = 0 .. 1) the camera moves, within its
    # bounds: 30 deg of orbit, 4 m of distance and 1 m of height.
    rows = clip[3]
    cam = batch.cam_pos[rows].numpy()
    assert np.abs(np.diff(cam, axis=0)).max() > 1e-3
    ang = np.degrees(np.arctan2(cam[:, 1], cam[:, 0]))
    assert abs((ang[-1] - ang[0] + 180.0) % 360.0 - 180.0) <= 30.0 + 1e-3
    r = np.linalg.norm(cam[:, :2], axis=1)
    assert abs(r[-1] - r[0]) <= 4.0 + 1e-4 and abs(cam[-1, 2] - cam[0, 2]) <= 1.0 + 1e-4
    joints = batch.pose.crane_joints[rows]
    assert not torch.equal(joints[0], joints[-1])
    # A new clip re-samples the statics.
    assert not torch.equal(batch.pose.positions[clip[3][0], statics],
                           batch.pose.positions[clip[4][0], statics])


def test_sequence_generate_deterministic_and_framewise(pipe):
    """``make_sequence_fn`` (clips of 3): the same frames from the same seed,
    whatever batch they are generated in."""
    gen = pipe.make_sequence_fn(3, include_heatmaps=True)
    with torch.no_grad():
        full = gen(2, range(0, 4))
        tail = gen(2, range(2, 6))
    for f in full._fields:
        if f != "frame_id":
            assert torch.equal(getattr(full, f)[2:], getattr(tail, f)[:2]), f
    assert full.heatmaps.shape == (4, 71, 16, 16)
    assert torch.equal(full.frame_id, torch.arange(4, dtype=torch.int32))
