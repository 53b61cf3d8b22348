"""The port's PnP solvers (``ops/pnp.py``) and metrics against the JAX
package, on the cases of ``tests/test_ops.py`` (numpy inputs from the same
seeds). R and t to 1e-4 (both f32, with the matmuls at full precision;
the DLT starts come from two LAPACK eigensolvers and Gauss-Newton pulls
both to the same minimum), ``valid`` exact. RANSAC waits with its port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as Rot

from constructionsceneposeestimation_tpu.core import camera as jcam
from constructionsceneposeestimation_tpu.core import rotation as jrot
from constructionsceneposeestimation_tpu.eval import metrics as jmetrics
from constructionsceneposeestimation_tpu.ops import pnp as jpnp
from constructionsceneposeestimation_tpu_torch.core import rotation
from constructionsceneposeestimation_tpu_torch.eval import metrics
from constructionsceneposeestimation_tpu_torch.ops import pnp

torch.set_num_threads(2)
T = torch.as_tensor


def _random_pose(rng):
    R = Rot.random(random_state=rng.randint(1 << 30)).as_matrix().astype(np.float32)
    t = np.array([rng.uniform(-1, 1), rng.uniform(-1, 1), rng.uniform(4, 10)], np.float32)
    return R, t


def _projected(rng, n):
    X = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    R, t = _random_pose(rng)
    p = X @ R.T + t
    return X, (p[:, :2] / p[:, 2:3]).astype(np.float32), R, t


def _pnp_cases():
    """(X, x, w) of test_pnp_exact_recovery, test_pnp_noisy_and_weighted,
    the five of test_pnp_batched_vmap and test_pnp_insufficient_points."""
    cases = []
    rng = np.random.RandomState(1)
    X, x, _, _ = _projected(rng, 10)
    cases.append((X, x, np.ones(10, np.float32)))
    rng = np.random.RandomState(2)
    X, x, _, _ = _projected(rng, 17)
    x = x + rng.normal(0, 0.002, x.shape).astype(np.float32)
    x[0] += 0.5
    x[1] -= 0.5
    w = np.ones(17, np.float32)
    w[:2] = 0.0
    cases.append((X, x, w))
    rng = np.random.RandomState(3)
    for _ in range(5):
        X, x, _, _ = _projected(rng, 8)
        cases.append((X, x, np.ones(8, np.float32)))
    cases.append((np.zeros((8, 3), np.float32), np.zeros((8, 2), np.float32),
                  np.zeros(8, np.float32)))
    return cases


def _assert_result(got, ref, tol=1e-4):
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_allclose(got.R.numpy(), np.asarray(ref.R), atol=tol, rtol=0)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), atol=tol, rtol=0)


@pytest.mark.parametrize("case", range(8))
def test_solve_pnp_matches_jax(case):
    X, x, w = _pnp_cases()[case]
    got = pnp.solve_pnp(T(X), T(x), T(w))
    _assert_result(got, jpnp.solve_pnp(jnp.asarray(X), jnp.asarray(x), jnp.asarray(w)))
    np.testing.assert_allclose(got.rmse.numpy(), np.asarray(
        jpnp.solve_pnp(jnp.asarray(X), jnp.asarray(x), jnp.asarray(w)).rmse), atol=1e-6)


def test_solve_pnp_batched():
    """One call over a batch dim against the JAX solver vmapped."""
    X, x, w = (np.stack(a) for a in zip(*_pnp_cases()[2:7]))
    got = pnp.solve_pnp(T(X), T(x), T(w))
    _assert_result(got, jax.vmap(jpnp.solve_pnp)(jnp.asarray(X), jnp.asarray(x), jnp.asarray(w)))


def _ground_cases():
    """test_ground_pose_recovery's three trials (clean, then noisy), plus
    one with too few weighted points."""
    rng = np.random.RandomState(7)
    X = np.array([[1.5, 1.1, 0.45], [1.5, -1.1, 0.45], [-1.5, 1.1, 0.45],
                  [-1.5, -1.1, 0.45], [2.25, 1.05, 2.2], [2.25, -1.05, 2.2],
                  [-2.1, 1.05, 1.9], [-2.1, -1.05, 1.9]], np.float32)
    cam_pos = np.array([20.0, 5.0, 2.5], np.float32)
    R_wp = np.asarray(jcam.world_from_pinhole_matrix(jnp.asarray(cam_pos),
                                                     jnp.asarray([0.0, 0.0, 1.0])))
    cases = []
    for trial in range(3):
        yaw = rng.uniform(-np.pi, np.pi)
        txy = rng.uniform(-5, 5, 2)
        c, s = np.cos(yaw), np.sin(yaw)
        Rz = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
        p_cam = (X @ Rz.T + np.array([txy[0], txy[1], 0.0], np.float32) - cam_pos) @ R_wp
        x2d = (p_cam[:, :2] / p_cam[:, 2:3]).astype(np.float32)
        noise = rng.normal(0, 0.002, x2d.shape).astype(np.float32) if trial else 0
        cases.append((X, (x2d + noise).astype(np.float32), np.ones(8, np.float32), R_wp,
                      cam_pos, p_cam))
    w = np.zeros(8, np.float32)
    w[:2] = 1.0
    cases.append((X, cases[1][1], w, R_wp, cam_pos, None))
    return cases


@pytest.mark.parametrize("case", range(4))
def test_solve_ground_pose_matches_jax(case):
    X, x, w, R_wp, cam_pos, p_cam = _ground_cases()[case]
    got = pnp.solve_ground_pose(T(X), T(x), T(w), T(R_wp), T(cam_pos))
    ref = jpnp.solve_ground_pose(*(jnp.asarray(a) for a in (X, x, w, R_wp, cam_pos)))
    _assert_result(got, ref)
    np.testing.assert_allclose(got.rmse.numpy(), np.asarray(ref.rmse), atol=1e-6)
    if case == 0:  # clean projections: the pose itself
        rec = got.R.numpy() @ X.T + got.t.numpy()[:, None]
        np.testing.assert_allclose(rec.T, p_cam, atol=0.02)


def test_solve_ground_pose_batched():
    """Leading dims (2, 3) in one call against the JAX solver vmapped."""
    cases = _ground_cases()[:3]
    X, x, w, R_wp, cam_pos = (np.stack([np.stack([c[i]] * 2) for c in cases], 1)
                              for i in range(5))
    got = pnp.solve_ground_pose(*(T(a) for a in (X, x, w, R_wp, cam_pos)))
    ref = jax.vmap(jax.vmap(jpnp.solve_ground_pose))(
        *(jnp.asarray(a) for a in (X, x, w, R_wp, cam_pos)))
    assert got.R.shape == (2, 3, 3, 3)
    _assert_result(got, ref)


def test_normalize_pixels_and_quaternions():
    rng = np.random.RandomState(4)
    uv = rng.uniform(0, 512, (3, 5, 2)).astype(np.float32)
    np.testing.assert_allclose(
        pnp.normalize_pixels(T(uv), 600.0, 610.0, 256.0, 250.0).numpy(),
        np.asarray(jpnp.normalize_pixels(jnp.asarray(uv), 600.0, 610.0, 256.0, 250.0)),
        atol=1e-7)
    q = rng.randn(6, 4).astype(np.float32)
    np.testing.assert_allclose(rotation.matrix_from_quat_xyzw(T(q)).numpy(),
                               np.asarray(jrot.matrix_from_quat_xyzw(jnp.asarray(q))),
                               atol=1e-6)
    w = rng.randn(4, 3).astype(np.float32)
    np.testing.assert_allclose(pnp._exp_so3(T(w)).numpy(),
                               np.asarray(jpnp._exp_so3(jnp.asarray(w))), atol=1e-6)


def test_metrics_match_jax():
    rng = np.random.RandomState(5)
    gt = rng.uniform(0, 50, (2, 4, 2)).astype(np.float32)
    pred = gt + rng.normal(0, 4, gt.shape).astype(np.float32)
    vis = rng.rand(2, 4) > 0.3
    bbox = rng.uniform(5, 30, (2, 2)).astype(np.float32)
    assert float(metrics.pck(T(pred), T(gt), T(vis), T(bbox))) == float(
        jmetrics.pck(jnp.asarray(pred), jnp.asarray(gt), jnp.asarray(vis), jnp.asarray(bbox)))
    X = rng.uniform(-1, 1, (30, 3)).astype(np.float32)
    (R1, t1), (R2, t2) = _random_pose(rng), _random_pose(rng)
    add = metrics.add_metric(T(R1), T(t1), T(R2), T(t2), T(X))
    np.testing.assert_allclose(float(add), float(jmetrics.add_metric(
        jnp.asarray(R1), jnp.asarray(t1), jnp.asarray(R2), jnp.asarray(t2), jnp.asarray(X))),
        rtol=1e-6)
    dia = metrics.model_diameter(T(X))
    np.testing.assert_allclose(float(dia), float(jmetrics.model_diameter(jnp.asarray(X))),
                               rtol=1e-6)
    adds = np.array([0.05, 0.5, 0.2], np.float32)
    valid = np.array([True, True, False])
    assert float(metrics.add_accuracy(T(adds), dia, T(valid))) == float(
        jmetrics.add_accuracy(jnp.asarray(adds), jnp.asarray(float(dia)), jnp.asarray(valid)))
    np.testing.assert_array_equal(
        metrics.aabb_corners([-1.0, -2.0, 0.0], [1.0, 2.0, 3.0]).numpy(),
        np.asarray(jmetrics.aabb_corners([-1.0, -2.0, 0.0], [1.0, 2.0, 3.0])))


def test_equipment_pose_matches_jax():
    """pose_net.equipment_pose: the dumper's decoded channels (B, C, 2) and
    scores, gated at 0.3, through batched PnP."""
    from constructionsceneposeestimation_tpu.models import pose_net as jpose_net
    from constructionsceneposeestimation_tpu_torch.models import pose_net
    from constructionsceneposeestimation_tpu_torch.scene import assets

    lo, hi = pose_net.class_channel_slices()["dumper"]
    X = assets.all_templates()["dumper"].keypoints.astype(np.float32)
    rng = np.random.RandomState(8)
    uv = rng.uniform(0, 512, (2, 71, 2)).astype(np.float32)
    sc = rng.uniform(0, 0.2, (2, 71)).astype(np.float32)
    for b in range(2):
        R, t = _random_pose(rng)
        t[2] += 10.0
        p = X @ R.T + t
        uv[b, lo:hi] = p[:, :2] / p[:, 2:3] * 400.0 + 256.0
        sc[b, lo:hi] = rng.uniform(0.5, 1.0, hi - lo)
    got = pose_net.equipment_pose("dumper", T(uv), T(sc), 400.0, 400.0, 256.0, 256.0)
    ref = jpose_net.equipment_pose("dumper", jnp.asarray(uv), jnp.asarray(sc), 400.0, 400.0,
                                   256.0, 256.0)
    _assert_result(got, ref)
    assert got.valid.all()


def test_ground_pose_far_frame_matches_jax():
    """A far frame (~36 m) with 4 visible dumper corners at their exact
    projections, from the evaluation path's first 512^2 batch on the card
    (eval seed stream, frame 25): the ground-prior solve settles in a wrong
    depth basin, in both packages alike, so the port reproduces the
    reference there too."""
    from constructionsceneposeestimation_tpu.eval import metrics as jmetrics_
    from constructionsceneposeestimation_tpu_torch.scene import assets

    X = assets.all_templates()["dumper"].keypoints.astype(np.float32)
    x = np.array([[-0.10456512123346329, 0.07617685198783875],
                  [-0.15837855637073517, 0.07412632554769516],
                  [-0.061928797513246536, 0.0705762505531311],
                  [-0.11295012384653091, 0.06881257146596909],
                  [-0.11757681518793106, 0.025410082191228867],
                  [-0.16964693367481232, 0.024744000285863876],
                  [-0.05531882494688034, 0.03075997345149517],
                  [-0.10351502150297165, 0.03003627248108387],
                  [-0.13104777038097382, 0.02454991266131401],
                  [-0.09746459126472473, 0.03136632591485977]], np.float32)
    w = np.array([0, 0, 0, 0, 1, 1, 1, 0, 1, 0], np.float32)
    R_wp = np.array([[-0.8927955627441406, 2.9802322387695312e-08, 0.45046180486679077],
                     [-0.45046180486679077, 0.0, -0.8927956819534302],
                     [2.9802322387695312e-08, -1.0, 1.1920928955078125e-07]], np.float32)
    cam = np.array([-14.794951438903809, 25.45534896850586, 3.050912618637085], np.float32)
    R_gt = np.array([[-0.4293123483657837, 0.9031559228897095, 2.9802322387695312e-08],
                     [-7.018176040318735e-10, -2.9794056999321583e-08, -1.0],
                     [-0.903156042098999, -0.4293123483657837, 1.1920928955078125e-07]],
                    np.float32)
    t_gt = np.array([-3.9196736812591553, 3.050913095474243, 35.97003936767578], np.float32)
    got = pnp.solve_ground_pose(T(X), T(x), T(w), T(R_wp), T(cam))
    ref = jpnp.solve_ground_pose(*(jnp.asarray(a) for a in (X, x, w, R_wp, cam)))
    _assert_result(got, ref)
    add = float(metrics.add_metric(got.R, got.t, T(R_gt), T(t_gt), T(X)))
    add_ref = float(jmetrics_.add_metric(ref.R, ref.t, jnp.asarray(R_gt), jnp.asarray(t_gt),
                                         jnp.asarray(X)))
    assert abs(add - add_ref) < 1e-3
    assert add > 0.1 * float(metrics.model_diameter(T(X)))  # the wrong basin, in both
