"""The crane's FK-constrained solve and RANSAC PnP against the JAX package
(counterpart of the JAX ``tests/test_eval_pipeline.py:69-133`` and
``tests/test_ops.py:175-210``): ``solve_crane_pose`` on the JAX test's
synthetic crane and on the GT keypoints of a JAX-generated ``FrameBatch``;
``evaluate_crane_6dof``; ``solve_pnp_ransac`` and the RANSAC branch of
``evaluate_equipment_6dof`` on the Gumbel draws JAX makes from the same
keys, handed to the port.

Tolerances (f32 solves on both sides): ``valid`` and every count equal;
the 5 joint parameters and each part's R and t to 1e-3; RANSAC's best
hypothesis and inlier set equal, its R and t to 1e-4; ADD and RMSE to
1e-3. The analytic LM Jacobian against ``torch.func.jacfwd`` to 1e-6 of
its largest entry."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from constructionsceneposeestimation_tpu.config import Config as JConfig
from constructionsceneposeestimation_tpu.config import PipelineConfig as JPipelineConfig
from constructionsceneposeestimation_tpu.config import SceneConfig as JSceneConfig
from constructionsceneposeestimation_tpu.core import camera as jcam
from constructionsceneposeestimation_tpu.core import rotation as jrot
from constructionsceneposeestimation_tpu.eval import pipeline as jeval
from constructionsceneposeestimation_tpu.ops import pnp as jpnp
from constructionsceneposeestimation_tpu.parallel import pipeline as jpipeline
from constructionsceneposeestimation_tpu.scene import kinematics as jkin
from constructionsceneposeestimation_tpu_torch import convert
from constructionsceneposeestimation_tpu_torch.config import Config, PipelineConfig, SceneConfig
from constructionsceneposeestimation_tpu_torch.core import camera
from constructionsceneposeestimation_tpu_torch.eval import pipeline as ev
from constructionsceneposeestimation_tpu_torch.ops import pnp
from constructionsceneposeestimation_tpu_torch.parallel.pipeline import Pipeline
from constructionsceneposeestimation_tpu_torch.scene import world

torch.set_num_threads(2)
RES, B = 64, 4
SCENE = dict(n_cones=2, n_trees=1, n_fence_panels=4)
JCFG = JConfig(scene=JSceneConfig(**SCENE),
               pipeline=JPipelineConfig(render_width=RES, render_height=RES))


def T(x):
    return torch.as_tensor(np.array(x, np.float32))


@pytest.fixture(scope="module")
def setup():
    pipe = jpipeline.Pipeline(JCFG)
    jb = jax.jit(pipe.make_generate_fn())(jax.random.PRNGKey(2), jnp.arange(B))
    roster = world.make_roster(SceneConfig(**SCENE))
    intr = camera.intrinsics_from_apertures(12.0, 25.0, RES, RES)
    return pipe, jb, convert.frame_batch(jb), roster, intr


def _synthetic(root, joints, cam_pos, target, res=512, hide=()):
    """The JAX test's synthetic crane: FK keypoints projected by a camera;
    ``hide`` parts get zero weight."""
    roster = jpipeline.Pipeline(JCFG).roster
    s0, s1 = roster.crane_slice
    kl = jnp.asarray(roster.inst_kpts[s0:s1])
    fk = jkin.crane_fk(jnp.asarray(joints))
    R = jnp.stack([fk[p][0] for p in jkin.CRANE_PART_ORDER])
    t = jnp.stack([fk[p][1] for p in jkin.CRANE_PART_ORDER])
    p_w = jnp.einsum("pij,pkj->pki", R, kl) + (t + jnp.asarray(root))[:, None]
    cam_pos, target = jnp.asarray(cam_pos), jnp.asarray(target)
    M = jcam.look_at_matrix(cam_pos, target)
    intr = jcam.intrinsics_from_apertures(12.0, 25.0, res, res)
    uv, _ = jcam.project(p_w.reshape(-1, 3), cam_pos, M, intr)
    x = jpnp.normalize_pixels(uv.reshape(4, -1, 2), intr.fx, intr.fy, intr.cx, intr.cy)
    w = np.asarray(roster.inst_kpt_valid[s0:s1], np.float32)
    w[list(hide)] = 0.0
    return kl, x, jnp.asarray(w), jcam.world_from_pinhole_matrix(cam_pos, target), cam_pos


def _check_crane(ref, got):
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_allclose(got.params.numpy(), np.asarray(ref.params), atol=1e-3)
    np.testing.assert_allclose(got.R.numpy(), np.asarray(ref.R), atol=1e-3)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), atol=1e-3)
    np.testing.assert_allclose(got.rmse.numpy(), np.asarray(ref.rmse), atol=1e-3)


@pytest.mark.parametrize("case", [
    dict(root=[1.5, -2.0, 0.0], joints=[35.0, 55.0, 1.4], cam_pos=[14.0, -9.0, 3.0],
         target=[0.0, 0.0, 2.0]),
    dict(root=[-3.0, 4.0, 0.0], joints=[-120.0, 20.0, 0.3], cam_pos=[-20.0, 15.0, 5.0],
         target=[1.0, -1.0, 1.5]),
    dict(root=[0.5, 0.5, 0.0], joints=[80.0, 70.0, 1.9], cam_pos=[5.0, 22.0, 2.5],
         target=[0.0, 0.0, 3.0], hide=(0, 1)),
])
def test_solve_crane_pose_synthetic_matches_jax(case):
    kl, x, w, R_wp, cam = _synthetic(**case)
    ref = jax.jit(jpnp.solve_crane_pose)(kl, x, w, R_wp, cam)
    got = pnp.solve_crane_pose(T(kl), T(x), T(w), T(R_wp), T(cam))
    _check_crane(ref, got)
    if not case.get("hide"):
        assert bool(got.valid) and float(got.rmse) < 1e-3
        np.testing.assert_allclose(got.params[:2].numpy(), case["root"][:2], atol=0.05)


def test_crane_jacobian_matches_jacfwd():
    kl, x, w, R_wp, cam = _synthetic([1.5, -2.0, 0.0], [35.0, 55.0, 1.4], [14.0, -9.0, 3.0],
                                     [0.0, 0.0, 2.0])
    obs = (T(kl), T(x)[None], T(w)[None], T(R_wp)[None], T(cam)[None])
    params = torch.tensor([[1.0, -1.5, 0.7, 0.9, 1.2], [2.0, 1.0, -2.0, 0.3, 0.1],
                           [-4.0, 3.0, 3.0, 1.4, 2.4]])
    _, _, J = pnp._crane_residuals(params, *obs, jacobian=True)
    for i in range(params.shape[0]):
        ref = torch.func.jacfwd(lambda p: pnp._crane_residuals(p[None], *obs)[0][0])(params[i])
        assert (J[i] - ref).abs().max() <= 1e-6 * ref.abs().max()


def test_solve_crane_pose_on_gt_keypoints_matches_jax(setup):
    pipe, jb, tb, roster, intr = setup
    s0, s1 = roster.crane_slice
    kv = np.asarray(roster.inst_kpt_valid[s0:s1])
    w = (np.asarray(jb.kpt_visible[:, s0:s1]) & kv).astype(np.float32)
    x = jpnp.normalize_pixels(jb.kpt_uv[:, s0:s1], intr.fx, intr.fy, intr.cx, intr.cy)
    R_wp = jrot.matrix_from_quat_xyzw(jb.camera_pose7[:, 3:])
    kl = jnp.asarray(pipe.roster.inst_kpts[s0:s1])
    ref = jax.jit(jax.vmap(lambda a, b, c, d: jpnp.solve_crane_pose(kl, a, b, c, d)))(
        x, jnp.asarray(w), R_wp, jb.camera_pose7[:, :3])
    got = ev.crane_solve(tb, roster, intr, use_gt_keypoints=True)
    assert int(np.sum(np.asarray(ref.valid))) >= 2
    _check_crane(ref, got)


def _check_metrics(got, ref, atol=1e-3):
    assert got.keys() == ref.keys()
    for k, r in ref.items():
        g, r = got[k].numpy(), np.asarray(r)
        if k.startswith("n_"):
            np.testing.assert_array_equal(g, r, err_msg=k)
        else:
            np.testing.assert_allclose(g, r, atol=atol, err_msg=k)


@pytest.mark.parametrize("gt", [True, False])
def test_evaluate_crane_6dof_matches_jax(setup, gt):
    pipe, jb, tb, roster, intr = setup
    ref = jax.jit(lambda b: jeval.evaluate_crane_6dof(b, pipe.roster, pipe.intr,
                                                      use_gt_keypoints=gt))(jb)
    got = ev.evaluate_crane_6dof(tb, roster, intr, use_gt_keypoints=gt)
    if gt:
        assert int(got["n_accepted"]) >= 2
    _check_metrics(got, ref)


def test_crane_wrong_basin_is_the_references():
    """Frame 80 of seed 1000 at 512^2 shows only 3 boom and 5 telescopic
    keypoints (near-collinear): the root is unobservable and the solve
    settles hundreds of metres away with a low residual, the JAX solve at
    the same place, so a card run's mean crane ADD can be metres."""
    cfg = Config(pipeline=PipelineConfig(render_width=512, render_height=512))
    tpipe = Pipeline(cfg, device="cpu")
    b = tpipe.make_generate_fn()(1000, [80])
    r = tpipe.roster
    s0, s1 = r.crane_slice
    w = (b.kpt_visible[:, s0:s1] & r.tensor("inst_kpt_valid", "cpu")[s0:s1]).float()
    assert w.sum(-1).tolist() == [[0.0, 0.0, 3.0, 5.0]]
    got = ev.crane_solve(b, r, tpipe.intr, use_gt_keypoints=True)
    x = pnp.normalize_pixels(b.kpt_uv[:, s0:s1], tpipe.intr.fx, tpipe.intr.fy, tpipe.intr.cx,
                             tpipe.intr.cy)
    R_wp = jrot.matrix_from_quat_xyzw(jnp.asarray(b.camera_pose7[:, 3:].numpy()))
    ref = jax.jit(jax.vmap(lambda a, c, d, e: jpnp.solve_crane_pose(
        jnp.asarray(r.inst_kpts[s0:s1]), a, c, d, e)))(
        jnp.asarray(x.numpy()), jnp.asarray(w.numpy()), R_wp,
        jnp.asarray(b.camera_pose7[:, :3].numpy()))
    assert bool(got.valid[0]) and float(torch.linalg.norm(got.params[0, :2])) > 100.0
    _check_crane(ref, got)


def _ransac_case(seed, n=14):
    rng = np.random.RandomState(seed)
    X = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    ang = rng.uniform(-0.5, 0.5, 3)
    from scipy.spatial.transform import Rotation
    R = Rotation.from_rotvec(ang).as_matrix().astype(np.float32)
    t = np.array([rng.uniform(-0.5, 0.5), rng.uniform(-0.5, 0.5), rng.uniform(4, 8)], np.float32)
    p = X @ R.T + t
    x = (p[:, :2] / p[:, 2:3]).astype(np.float32)
    x[0] = x[1] + 0.3  # gross outliers at full weight
    x[5] += np.asarray([0.4, -0.2], np.float32)
    x[9] -= np.asarray([0.25, 0.35], np.float32)
    w = np.ones(n, np.float32)
    w[3] = 0.0  # one point unusable
    return X, x, w


@jax.jit
def _jax_consensus(X, x, w, g):
    """The JAX function's hypotheses and their inliers (ops/pnp.py:497-513),
    from its own pieces."""
    gm = jnp.where(w[None] > 0, g, -jnp.inf)
    _, sub = jax.lax.top_k(gm, 6)
    Rh, th = jax.vmap(lambda i: jpnp.dlt_init(X[i], x[i], jnp.ones(6)))(sub)
    proj, pc = jpnp._project(Rh, th, jnp.broadcast_to(X, (g.shape[0],) + X.shape))
    return ((jnp.linalg.norm(proj - x[None], axis=-1) <= 0.01) & (w[None] > 0)
            & (pc[..., 2] > 0))


@pytest.mark.parametrize("seed", [5, 6, 7])
def test_solve_pnp_ransac_matches_jax_on_the_same_draws(seed):
    X, x, w = _ransac_case(seed)
    key = jax.random.PRNGKey(seed)
    ref = jax.jit(jpnp.solve_pnp_ransac)(key, jnp.asarray(X), jnp.asarray(x), jnp.asarray(w))
    g = jax.random.gumbel(key, (32, X.shape[0]))  # 14 points, 3 outliers, 1 unusable
    inl = _jax_consensus(jnp.asarray(X), jnp.asarray(x), jnp.asarray(w), g)
    best = int(jnp.argmax(jnp.sum(inl, -1)))
    got_best, got_inl = pnp.ransac_consensus(T(X), T(x), T(w), T(g))
    assert int(got_best) == best
    np.testing.assert_array_equal(got_inl.numpy(), np.asarray(inl[best]))
    assert int(got_inl.sum()) >= 6  # a consensus: the refine runs on it
    got = pnp.solve_pnp_ransac(T(X), T(x), T(w), scores=T(g))
    assert bool(got.valid) == bool(ref.valid)
    np.testing.assert_allclose(got.R.numpy(), np.asarray(ref.R), atol=1e-4)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), atol=1e-4)


def test_ransac_branch_of_evaluate_equipment_matches_jax(setup):
    """Decoded GT heatmaps through RANSAC PnP: JAX splits PRNGKey(0) into a
    key a frame; the port gets each key's Gumbel draws. The counts are
    equal. Frame by frame, the consensus sets are equal; where it holds
    more than 6 points R and t agree to 1e-3. A frame with just 6 usable
    keypoints is a minimal DLT, whose f32 eigen-solve is ill-conditioned
    on both sides: Gauss-Newton's 8 steps then leave the two solves apart
    (t by up to 0.13 m here, on frame 0), so those frames are held by
    their consensus, validity and gate alone."""
    pipe, jb, tb, roster, intr = setup
    ref = jax.jit(lambda b: jeval.evaluate_equipment_6dof(b, pipe.roster, pipe.intr, "dumper",
                                                          4.0))(jb)
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    scores = torch.stack([T(jax.random.gumbel(k, (32, 10))) for k in keys])  # 10 corners
    got = ev.evaluate_equipment_6dof(tb, roster, intr, "dumper", 4.0, ransac_scores=scores)
    for k in ("n_valid", "n_accepted"):
        assert int(got[k]) == int(ref[k]), k

    o = roster.inst_class_names.index("dumper")
    uv, sc = ev.decode_heatmaps(tb.heatmaps, 4.0)
    ch = roster.tensor("inst_kpt_channel", "cpu")[o, :10].long()
    w = torch.where(sc[:, ch] >= 0.3, sc[:, ch], 0.0)
    x = pnp.normalize_pixels(uv[:, ch], intr.fx, intr.fy, intr.cx, intr.cy)
    X = ev._template_points("dumper", "cpu")
    thr = 10.0 * (1.0 / float(intr.fx))
    ransac = jax.jit(lambda k, a, b, c: jpnp.solve_pnp_ransac(k, a, b, c, inlier_thresh=thr))
    for f in range(B):
        r = ransac(keys[f], jnp.asarray(X.numpy()), jnp.asarray(x[f].numpy()),
                   jnp.asarray(w[f].numpy()))
        g = pnp.solve_pnp_ransac(X, x[f], w[f], scores=scores[f], inlier_thresh=thr)
        assert bool(g.valid) == bool(r.valid)
        assert (float(g.rmse) <= 8 * (1.0 / float(intr.fx))) == (float(r.rmse) <= 8 * (
            1.0 / float(intr.fx)))
        if int((w[f] > 0).sum()) > 6:
            np.testing.assert_allclose(g.R.numpy(), np.asarray(r.R), atol=1e-3)
            np.testing.assert_allclose(g.t.numpy(), np.asarray(r.t), atol=1e-3)
