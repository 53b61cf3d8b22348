"""The port's samplers: the reference's placement invariants (ported from
tests/test_samplers.py), the ladder's deterministic geometry against the
JAX package, the DR camera and lighting ranges, and group independence of
the batched placement."""

import numpy as np
import pytest
import torch

import jax

from constructionsceneposeestimation_tpu.sample import camera_sampler as jcs
from constructionsceneposeestimation_tpu_torch.config import (CameraConfig, LightingConfig,
                                                              RandomizationConfig, SceneConfig)
from constructionsceneposeestimation_tpu_torch.sample import camera_sampler, lighting, placement
from constructionsceneposeestimation_tpu_torch.scene import world
from constructionsceneposeestimation_tpu_torch.utils import prng

torch.set_num_threads(2)
SCFG = SceneConfig(n_cones=6, n_trees=2, n_fence_panels=8)
RCFG = RandomizationConfig()


def _scenes(scfg, seeds):
    roster = world.make_roster(scfg)
    gens = [prng.generator(s, prng.SCENE_STREAM, 0) for s in seeds]
    pose, diag = placement.sample_scenes(gens, roster, scfg, RCFG, articulate_crane=False)
    return roster, pose, diag


@pytest.mark.parametrize("scfg", [SCFG, SceneConfig()])
def test_placement_invariants(scfg):
    _, _, diag = _scenes(scfg, range(16))
    all_ok_count = 0
    for g in range(16):
        placed_xy = diag["placed_xy"][g].numpy()
        placed_r = diag["placed_r"][g].numpy()
        active = placed_r > 0
        xy, r = placed_xy[active], placed_r[active]
        assert active.sum() == 1 + scfg.n_dumpers + scfg.n_humans + scfg.n_cones
        # Fence containment for every placed object (loosest margin, 0.5 m).
        assert np.all(xy[:, 0] >= RCFG.fence_x[0] + 0.5 - 1e-5)
        assert np.all(xy[:, 0] <= RCFG.fence_x[1] - 0.5 + 1e-5)
        assert np.all(xy[:, 1] >= RCFG.fence_y[0] + 0.5 - 1e-5)
        assert np.all(xy[:, 1] <= RCFG.fence_y[1] - 0.5 + 1e-5)
        all_ok = (bool(diag["crane_ok"][g]) and bool(diag["dumper_ok"][g])
                  and bool(diag["human_ok"][g].all()) and bool(diag["cone_ok"][g].all()))
        if all_ok:  # sum-of-radii holds pairwise when nothing fell back
            all_ok_count += 1
            d = np.linalg.norm(xy[:, None] - xy[None, :], axis=-1)
            np.fill_diagonal(d, 1e9)
            assert np.all(d >= r[:, None] + r[None, :] - 1e-4), f"overlap in group {g}"
    assert all_ok_count > 0


def test_placement_crane_first_and_unrotated():
    _, pose, diag = _scenes(SCFG, range(8))
    assert torch.all(pose.crane_yaw_deg == 0.0)
    assert torch.all(diag["crane_radius"] >= 6.0)
    assert torch.all(torch.abs(pose.crane_pos[:, :2]) <= 4.0 + 1e-4)
    assert torch.all(pose.crane_pos[:, 2] == 0.0)
    assert torch.equal(diag["placed_xy"][:, 0], pose.crane_pos[:, :2])


def test_placement_updates_scene_pose_rows():
    roster, pose, _ = _scenes(SCFG, range(4))
    default = world.default_pose(roster, SCFG, batch=4)
    for s0, s1 in (roster.tree_slice, roster.fence_slice):
        assert torch.equal(pose.positions[:, s0:s1], default.positions[:, s0:s1])
        assert torch.equal(pose.yaw_deg[:, s0:s1], default.yaw_deg[:, s0:s1])
    c0, c1 = roster.cone_slice
    assert not torch.allclose(pose.positions[:, c0:c1, :2], default.positions[:, c0:c1, :2])
    assert torch.all(pose.positions[:, c0:c1, 2] == 0.0)
    assert torch.all(torch.abs(pose.yaw_deg[:, c0:c1]) <= 180.0)
    assert pose.human_joints.shape == (4, SCFG.n_humans, 17, 3)


def test_placement_articulates_crane_within_limits():
    roster = world.make_roster(SceneConfig())
    gens = [prng.generator(1, prng.SCENE_STREAM, g) for g in range(6)]
    pose, _ = placement.sample_scenes(gens, roster, articulate_crane=True)
    j = pose.crane_joints.numpy()
    from constructionsceneposeestimation_tpu_torch.scene import kinematics
    assert np.all(j >= kinematics.CRANE_JOINT_LOW) and np.all(j <= kinematics.CRANE_JOINT_HIGH)
    assert len(np.unique(j[:, 1])) == 6


def test_placement_groups_are_independent():
    """A group's scene does not depend on the other groups it is batched
    with: the basis of batch-independent frames."""
    roster = world.make_roster(SceneConfig())
    gens = lambda ids: [prng.generator(4, prng.SCENE_STREAM, g) for g in ids]
    together, _ = placement.sample_scenes(gens([3, 4, 5, 6]), roster)
    alone, _ = placement.sample_scenes(gens([5]), roster)
    for a, b in zip(together, alone):
        assert torch.equal(a[2:3], b)


def test_ladder_deterministic_geometry_matches_reference():
    cam, tgt = camera_sampler.systematic_camera_positions(41, prng.generator(0))
    jcam_pos, jtgt = jcs.systematic_camera_positions(41, jax.random.PRNGKey(0))
    # Key positions and rings are deterministic: exact to f32 rounding.
    np.testing.assert_allclose(cam.numpy(), np.asarray(jcam_pos), atol=1e-5)
    np.testing.assert_allclose(tgt.numpy()[:30], np.asarray(jtgt)[:30], atol=1e-6)
    np.testing.assert_allclose(cam[:, 2].numpy(), tgt[:, 2].numpy())  # level aim
    ring_tgt = tgt.numpy()[30:, :2]
    near = np.linalg.norm(ring_tgt - camera_sampler.DUMPER_CENTER, axis=1) <= 2 * np.sqrt(2) + 1e-5
    assert np.all(near | np.all(ring_tgt == 0.0, axis=1))


def test_ladder_random_fill_within_bounds():
    cam, _ = camera_sampler.systematic_camera_positions(80, prng.generator(2))
    cam = cam.numpy()[70:]
    d = np.linalg.norm(cam[:, :2] - camera_sampler.DUMPER_CENTER, axis=1)
    in_box = (cam[:, 0] >= -10) & (cam[:, 0] <= 8) & (cam[:, 1] >= -10) & (cam[:, 1] <= 10)
    assert np.all((d <= 12.0 + 1e-4) | in_box)
    a = camera_sampler.systematic_camera_positions(80, prng.generator(7))
    b = camera_sampler.systematic_camera_positions(80, prng.generator(7))
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_dr_camera_ranges():
    cfg = CameraConfig()
    cam, tgt = camera_sampler.sample_camera_batch(prng.generator(3), 256, cfg)
    r = torch.linalg.norm(cam[:, :2], dim=1)
    assert torch.all((r >= cfg.distance_range[0] - 1e-4) & (r <= cfg.distance_range[1] + 1e-4))
    assert torch.all((cam[:, 2] >= cfg.height_range[0]) & (cam[:, 2] <= cfg.height_range[1]))
    assert torch.equal(cam[:, 2], tgt[:, 2])
    assert torch.all(torch.abs(tgt[:, :2]) <= 3.0)
    ang = torch.rad2deg(torch.atan2(cam[:, 1], cam[:, 0])) % 360
    assert ang.min() < 30 and ang.max() > 330  # covers the full circle


def test_lighting_sampler():
    cfg = LightingConfig()
    lit = lighting.sample_lighting(prng.generator(0), 64, cfg)
    np.testing.assert_allclose(torch.linalg.norm(lit.sun_dir, dim=1).numpy(), 1.0, atol=1e-5)
    assert torch.all(lit.sun_dir[:, 2] < 0)  # shines downward
    elev = torch.rad2deg(torch.asin(-lit.sun_dir[:, 2]))
    assert torch.all((elev >= 20 - 1e-3) & (elev <= 70 + 1e-3))
    for v in (lit.sun_intensity, lit.dome_intensity):
        assert torch.all((v >= 0.7 - 1e-6) & (v <= 1.3 + 1e-6))
    assert torch.all((lit.tex_strength >= 0.5) & (lit.tex_strength <= 1.5))
    assert torch.all((lit.dirt >= 0.0) & (lit.dirt <= 0.8))
    assert torch.all((lit.tex_phase >= 0.0) & (lit.tex_phase < 1.0))
    assert torch.equal(lit.dome_color[0], torch.tensor(cfg.dome_color))
