"""The port's geometry (core/), articulation, world assembly and random
streams, and the public helpers of core/, scene/kinematics and the camera
sampler's retry nudge, held against the JAX package on the same numpy
inputs.

Tolerances: both sides compute in float32 from the same inputs; what
differs is the order of sums and transcendental implementations, so
elementwise results agree to a few ulp (1e-5 absolute at unit scale,
1e-4 m at the 25 m yard scale, 1e-3 px for projections)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from constructionsceneposeestimation_tpu.config import SceneConfig as JSceneConfig
from constructionsceneposeestimation_tpu.config import RandomizationConfig as JRandCfg
from constructionsceneposeestimation_tpu.core import camera as jcam
from constructionsceneposeestimation_tpu.core import rotation as jrot
from constructionsceneposeestimation_tpu.core import transforms as jtf
from constructionsceneposeestimation_tpu.sample import camera_sampler as jcs
from constructionsceneposeestimation_tpu.sample import placement as jpl
from constructionsceneposeestimation_tpu.scene import kinematics as jkin
from constructionsceneposeestimation_tpu.scene import world as jworld
from constructionsceneposeestimation_tpu_torch import convert
from constructionsceneposeestimation_tpu_torch.config import SceneConfig
from constructionsceneposeestimation_tpu_torch.core import camera, rotation, transforms
from constructionsceneposeestimation_tpu_torch.sample import camera_sampler
from constructionsceneposeestimation_tpu_torch.scene import assets, kinematics, world
from constructionsceneposeestimation_tpu_torch.utils import prng

torch.set_num_threads(2)
T = lambda a: torch.as_tensor(np.array(a, np.float32))


def _rotations(n, seed):
    rng = np.random.RandomState(seed)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return np.asarray(jrot.matrix_from_quat_wxyz(jnp.asarray(q)))


def test_rotation_quaternion_and_euler():
    R = _rotations(64, 0)
    np.testing.assert_allclose(rotation.quat_wxyz_from_matrix(T(R)).numpy(),
                               np.asarray(jrot.quat_wxyz_from_matrix(R)), atol=1e-6)
    np.testing.assert_allclose(rotation.quat_xyzw_from_matrix(T(R)).numpy(),
                               np.asarray(jrot.quat_xyzw_from_matrix(R)), atol=1e-6)
    # asin/atan2 near +-90 deg amplify ulps: 1e-3 deg.
    np.testing.assert_allclose(rotation.euler_xyz_degrees_from_matrix(T(R)).numpy(),
                               np.asarray(jrot.euler_xyz_degrees_from_matrix(R)), atol=1e-3)
    gimbal = np.asarray(jrot.matrix_rot_y_degrees(jnp.float32(90.0)))[None]
    np.testing.assert_allclose(rotation.euler_xyz_degrees_from_matrix(T(gimbal)).numpy(),
                               np.asarray(jrot.euler_xyz_degrees_from_matrix(gimbal)), atol=1e-3)


@pytest.mark.parametrize("axis", ["x", "y", "z"])
def test_rotation_axis_matrices(axis):
    deg = np.linspace(-180, 180, 37).astype(np.float32)
    mine = getattr(rotation, f"matrix_rot_{axis}_degrees")(T(deg)).numpy()
    ref = np.asarray(getattr(jrot, f"matrix_rot_{axis}_degrees")(jnp.asarray(deg)))
    np.testing.assert_allclose(mine, ref, atol=1e-6)


def test_orthonormalize():
    rng = np.random.RandomState(1)
    M = _rotations(32, 2) * rng.uniform(0.3, 3.0, (32, 1, 3)).astype(np.float32)
    M = M + 0.05 * rng.normal(size=M.shape).astype(np.float32)
    mine = rotation.orthonormalize(T(M)).numpy()
    np.testing.assert_allclose(mine, np.asarray(jrot.orthonormalize(M)), atol=1e-5)
    np.testing.assert_allclose(mine @ np.swapaxes(mine, -1, -2), np.broadcast_to(np.eye(3), M.shape),
                               atol=1e-5)


def test_intrinsics_exact():
    for w, h in ((512, 512), (64, 64), (256, 192), (1280, 720)):
        mine = camera.intrinsics_from_apertures(12.0, 25.0, w, h)
        ref = jcam.intrinsics_from_apertures(12.0, 25.0, w, h)
        for f in ("fx", "fy", "cx", "cy"):
            assert np.float32(getattr(mine, f)) == np.float32(getattr(ref, f)), (w, h, f)
        assert (mine.width, mine.height) == (ref.width, ref.height)


def _cameras():
    rng = np.random.RandomState(3)
    cam = rng.uniform(-20, 20, (16, 3)).astype(np.float32)
    cam[:, 2] = rng.uniform(1.5, 8, 16)
    tgt = rng.uniform(-3, 3, (16, 3)).astype(np.float32)
    cam[0] = [0.0, 0.0, 25.0]  # straight down: the +X fallback frame
    tgt[0] = [0.0, 0.0, 0.0]
    return cam, tgt


def test_camera_frames_and_pose7():
    cam, tgt = _cameras()
    np.testing.assert_allclose(camera.look_at_matrix(T(cam), T(tgt)).numpy(),
                               np.asarray(jcam.look_at_matrix(cam, tgt)), atol=1e-6)
    for bug in (False, True):
        np.testing.assert_allclose(
            camera.camera_pose7_xyzw(T(cam), T(tgt), bug_compatible=bug).numpy(),
            np.asarray(jcam.camera_pose7_xyzw(cam, tgt, bug_compatible=bug)), atol=1e-5)
    M = np.asarray(jcam.look_at_matrix(cam, tgt))
    assert np.all(np.linalg.det(M) < 0)  # the reference's det=-1 frame


def test_camera_project_and_rays():
    cam, tgt = _cameras()
    intr_m = camera.intrinsics_from_apertures(12.0, 25.0, 64, 48)
    intr_r = jcam.intrinsics_from_apertures(12.0, 25.0, 64, 48)
    M = np.asarray(jcam.look_at_matrix(cam, tgt))
    pts = np.random.RandomState(4).uniform(-10, 10, (16, 50, 3)).astype(np.float32)
    uv, z = camera.project(T(pts), T(cam), T(M), intr_m)
    for i in range(len(cam)):
        uv_r, z_r = jcam.project(pts[i], cam[i], M[i], intr_r)
        np.testing.assert_allclose(z[i].numpy(), np.asarray(z_r), atol=1e-4)
        front = np.asarray(z_r) > 0.5
        np.testing.assert_allclose(uv[i].numpy()[front], np.asarray(uv_r)[front], atol=1e-3)
    rays = camera.pixel_rays(intr_m, T(M[:3])).numpy()
    for i in range(3):
        _, d_r = jcam.pixel_rays(intr_r, cam[i], M[i])
        np.testing.assert_allclose(rays[i], np.asarray(d_r), atol=1e-6)
    depth = T([[np.inf, 0.0, 10.0, 249.9, 250.0, -1.0]])
    np.testing.assert_array_equal(camera.depth_valid_mask(depth).numpy(),
                                  np.asarray(jcam.depth_valid_mask(depth.numpy())))


def test_transforms_bbox_record():
    R = _rotations(8, 5)
    t = np.random.RandomState(6).uniform(-10, 10, (8, 3)).astype(np.float32)
    Tm = transforms.make_transform(T(R), T(t)).numpy()
    np.testing.assert_array_equal(Tm, np.asarray(jtf.make_transform(R, t)))
    lo = np.random.RandomState(7).uniform(-2, 0, (8, 3)).astype(np.float32)
    hi = lo + np.random.RandomState(8).uniform(0.1, 4, (8, 3)).astype(np.float32)
    Trow = np.swapaxes(Tm, -1, -2)
    got = transforms.bbox_record_to_pose(T(lo), T(hi), T(Trow))
    ref = jtf.bbox_record_to_pose(lo, hi, Trow)
    for g, r, tol in zip(got, ref, (1e-4, 1e-4, 1e-2)):  # centre, size (m); euler (deg)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=tol)


def test_kinematics():
    rng = np.random.RandomState(9)
    joints = rng.uniform(kinematics.CRANE_JOINT_LOW, kinematics.CRANE_JOINT_HIGH,
                         (12, 3)).astype(np.float32)
    mine, ref = kinematics.crane_fk(T(joints)), jkin.crane_fk(jnp.asarray(joints))
    assert list(mine) == list(ref) == list(kinematics.CRANE_PART_ORDER)
    for part in ref:
        for a, b in zip(mine[part], ref[part]):
            np.testing.assert_allclose(a.numpy(), np.asarray(np.broadcast_to(b, a.shape)),
                                       atol=1e-5)
    np.testing.assert_allclose(kinematics.crane_reach_xy(T(joints)).numpy(),
                               np.asarray(jkin.crane_reach_xy(joints)), atol=1e-5)
    u = rng.uniform(size=(6, 10)).astype(np.float32)
    ang = kinematics.sample_human_pose(T(u)).numpy()
    assert np.all(ang >= kinematics.HUMAN_POSE_LOW) and np.all(ang <= kinematics.HUMAN_POSE_HIGH)
    posed = kinematics.pose_human_joints(T(assets.CANONICAL_COCO), T(ang))
    for i in range(len(ang)):
        ref_j = jkin.pose_human_joints(jnp.asarray(assets.CANONICAL_COCO), jnp.asarray(ang[i]))
        np.testing.assert_allclose(posed[i].numpy(), np.asarray(ref_j), atol=1e-5)
        rots, offs = kinematics.human_capsule_transforms(posed[i:i + 1])
        r_rot, r_off = jkin.human_capsule_transforms(ref_j)
        np.testing.assert_allclose(rots[0].numpy(), np.asarray(r_rot), atol=1e-5)
        np.testing.assert_allclose(offs[0].numpy(), np.asarray(r_off), atol=1e-5)


@pytest.fixture(scope="module")
def sampled_poses():
    scfg = JSceneConfig()
    roster = jworld.make_roster(scfg)
    fn = jax.jit(jax.vmap(lambda k: jpl.randomize_scene(
        k, roster, scfg, JRandCfg(), articulate_crane=True)[0]))
    return roster, fn(jax.random.split(jax.random.PRNGKey(5), 3))


def test_build_world_and_keypoints(sampled_poses):
    jroster, poses = sampled_poses
    roster = world.make_roster(SceneConfig())
    mine = world.build_world(roster, convert.scene_pose(poses))
    for i in range(3):
        pose_i = jax.tree_util.tree_map(lambda x: x[i], poses)
        ref = jworld.build_world(jroster, pose_i)
        for k in ("prim_rot", "prim_pos", "inst_rot", "inst_pos", "kpts_local"):
            np.testing.assert_allclose(mine[k][i].numpy(), np.asarray(ref[k]), atol=1e-5,
                                       err_msg=k)
        kw = world.world_keypoints(mine["inst_rot"][i:i + 1], mine["inst_pos"][i:i + 1],
                                   mine["kpts_local"][i:i + 1])
        ref_kw = jworld.world_keypoints(jroster, ref["inst_rot"], ref["inst_pos"], ref["kpts_local"])
        np.testing.assert_allclose(kw[0].numpy(), np.asarray(ref_kw), atol=1e-4)
    np.testing.assert_array_equal(mine["prim_params"].numpy(), jroster.prim_params)


def test_default_pose_world_matches():
    roster, jroster = world.make_roster(SceneConfig()), jworld.make_roster(JSceneConfig())
    mine = world.build_world(roster, world.default_pose(roster, SceneConfig(), batch=2))
    ref = jworld.build_world(jroster, jworld.default_pose(jroster, JSceneConfig()))
    for k in ("prim_rot", "prim_pos", "inst_rot", "inst_pos"):
        np.testing.assert_allclose(mine[k][1].numpy(), np.asarray(ref[k]), atol=1e-5, err_msg=k)
    np.testing.assert_array_equal(world.fence_default_yaw_deg(20), jworld.fence_default_yaw_deg(20))


def test_prng_streams_deterministic_and_distinct():
    a = torch.rand(8, generator=prng.frame_generator(7, 123))
    b = torch.rand(8, generator=prng.frame_generator(7, 123))
    assert torch.equal(a, b)
    assert not torch.equal(a, torch.rand(8, generator=prng.frame_generator(7, 124)))
    assert not torch.equal(a, torch.rand(8, generator=prng.frame_generator(8, 123)))
    # Scene stream: one generator per cadence group.
    g = lambda f: torch.rand(4, generator=prng.scene_generator(3, f, 10))
    assert torch.equal(g(20), g(29)) and not torch.equal(g(29), g(30))
    assert not torch.equal(torch.rand(4, generator=prng.generator(3, prng.SCENE_STREAM, 5)),
                           torch.rand(4, generator=prng.generator(3, prng.FRAME_STREAM, 5)))


# The public helpers, each against its JAX function to f32 rounding.
def _unit_quats(n, seed):
    q = np.random.RandomState(seed).normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def test_quat_mul_and_rotate_vec():
    a, b = _unit_quats(32, 10), _unit_quats(32, 11)
    v = np.random.RandomState(12).uniform(-5, 5, (32, 3)).astype(np.float32)
    np.testing.assert_allclose(rotation.quat_mul_wxyz(T(a), T(b)).numpy(),
                               np.asarray(jrot.quat_mul_wxyz(a, b)), atol=1e-5)
    np.testing.assert_allclose(rotation.rotate_vec_wxyz(T(a), T(v)).numpy(),
                               np.asarray(jrot.rotate_vec_wxyz(a, v)), atol=1e-5)
    # One quaternion over many vectors.
    np.testing.assert_allclose(rotation.rotate_vec_wxyz(T(a[0]), T(v)).numpy(),
                               np.asarray(jrot.rotate_vec_wxyz(a[0], v)), atol=1e-5)


def test_reference_quat_and_pinhole_to_world():
    cam, tgt = _cameras()
    np.testing.assert_allclose(camera.reference_camera_quat_wxyz(T(cam), T(tgt)).numpy(),
                               np.asarray(jcam.reference_camera_quat_wxyz(cam, tgt)), atol=1e-5)
    R = np.asarray(jcam.world_from_pinhole_matrix(cam, tgt))
    M = np.asarray(jcam.look_at_matrix(cam, tgt))
    pin = np.random.RandomState(13).uniform(-5, 5, (16, 40, 3)).astype(np.float32)
    got = camera.pinhole_to_world(T(pin), T(cam), T(M)).numpy()
    np.testing.assert_allclose(got, np.asarray(jcam.pinhole_to_world(pin, cam, M)), atol=1e-5)
    np.testing.assert_allclose(
        camera.world_to_pinhole(T(got), T(cam), T(M)).numpy(), pin, atol=1e-4)
    assert np.all(np.linalg.det(R) > 0)


def test_backproject_depth():
    cam, tgt = _cameras()
    intr_m = camera.intrinsics_from_apertures(12.0, 25.0, 32, 24)
    intr_r = jcam.intrinsics_from_apertures(12.0, 25.0, 32, 24)
    M = np.asarray(jcam.look_at_matrix(cam, tgt))[:4]
    depth = np.random.RandomState(14).uniform(0.5, 5.0, (4, 24, 32)).astype(np.float32)
    got = camera.backproject_depth(T(depth), intr_m, T(cam[:4]), T(M)).numpy()
    assert got.shape == (4, 24, 32, 3)
    for i in range(4):
        ref = jcam.backproject_depth(depth[i], intr_r, cam[i], M[i])
        np.testing.assert_allclose(got[i], np.asarray(ref), atol=1e-5)
        one = camera.backproject_depth(T(depth[i]), intr_m, T(cam[i]), T(M[i])).numpy()
        np.testing.assert_allclose(one, got[i], atol=1e-6)
    # The points lie at their pixels, at their depth.
    pts = got.reshape(4, -1, 3)
    uv, z = camera.project(T(pts), T(cam[:4]), T(M), intr_m)
    np.testing.assert_allclose(z.numpy(), depth.reshape(4, -1), rtol=1e-5)
    u, v = np.meshgrid(np.arange(32), np.arange(24))
    np.testing.assert_allclose(uv.numpy()[0, :, 0], u.reshape(-1), atol=1e-3)
    np.testing.assert_allclose(uv.numpy()[0, :, 1], v.reshape(-1), atol=1e-3)


def test_transform_points_aabb_and_radius():
    R = _rotations(8, 15)
    rng = np.random.RandomState(16)
    t = rng.uniform(-5, 5, (8, 3)).astype(np.float32)
    scale = rng.uniform(0.5, 2.0, (8, 3)).astype(np.float32)
    Tm = transforms.make_transform(T(R), T(t), T(scale)).numpy()
    np.testing.assert_allclose(Tm, np.asarray(jtf.make_transform(R, t, scale)), atol=1e-6)
    # Without scale, the existing callers' result: bit-equal to JAX.
    np.testing.assert_array_equal(transforms.make_transform(T(R), T(t)).numpy(),
                                  np.asarray(jtf.make_transform(R, t)))
    pts = rng.uniform(-3, 3, (8, 20, 3)).astype(np.float32)
    np.testing.assert_allclose(transforms.transform_points(T(Tm), T(pts)).numpy(),
                               np.asarray(jtf.transform_points(Tm, pts)), atol=1e-5)
    lo = rng.uniform(-2, 0, (8, 3)).astype(np.float32)
    hi = lo + rng.uniform(0.1, 3, (8, 3)).astype(np.float32)
    for a, b in zip(transforms.world_aabb_of_local_aabb(T(lo), T(hi), T(Tm)),
                    jtf.world_aabb_of_local_aabb(lo, hi, Tm)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    for minimum in (1.0, 3.0):
        np.testing.assert_allclose(
            transforms.collision_radius_xy(T(lo), T(hi), T(Tm), minimum).numpy(),
            np.asarray(jtf.collision_radius_xy(lo, hi, Tm, minimum)), atol=1e-5)


def test_human_joint_positions():
    rng = np.random.RandomState(17)
    yaw = rng.uniform(-180, 180, 6).astype(np.float32)
    pos = rng.uniform(-8, 8, (6, 3)).astype(np.float32)
    got = kinematics.human_joint_positions(T(assets.CANONICAL_COCO), T(yaw), T(pos)).numpy()
    ref = jkin.human_joint_positions(jnp.asarray(assets.CANONICAL_COCO), yaw, pos)
    assert got.shape == (6, 17, 3)
    np.testing.assert_allclose(got, np.asarray(ref), atol=1e-5)


def test_retry_jitter():
    cam, _ = _cameras()
    key = jax.random.PRNGKey(18)
    u = np.asarray(jax.random.uniform(key, cam.shape))  # the draws JAX's nudge takes
    np.testing.assert_allclose(camera_sampler.jitter_from_draws(T(u), T(cam)).numpy(),
                               np.asarray(jcs.retry_jitter(key, cam)), atol=1e-5)
    a = camera_sampler.retry_jitter(prng.generator(3, 9), T(cam))
    b = camera_sampler.retry_jitter(prng.generator(3, 9), T(cam))
    assert torch.equal(a, b)
    d = (a - T(cam)).numpy()
    assert np.all(np.abs(d[:, :2]) <= 2.0) and np.all(np.abs(d[:, 2]) <= 1.0)
    assert np.abs(d[:, 2]).max() > 0.0
