"""The port's evaluators (``eval/pipeline.py``) and the evaluation step as a
whole against the JAX package, on one JAX-generated ``FrameBatch`` handed
to both through ``convert.frame_batch`` (the 128^2 configuration of
``tests/test_eval_pipeline.py``: close-range ladder views, 2-px heatmaps).

Tolerances: integer counts exact and ratios of counts equal, ADD and RMSE
to 1e-3 m (f32 solves on both sides), pixel errors to 1e-3 px. The step as
a whole: the port's model heatmaps against flax's to 1e-4 on the same
weights (f32), and the evaluators on those heatmaps within one count over
each ratio's denominator, since a peak near a score threshold may fall on
either side of it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from constructionsceneposeestimation_tpu.config import Config as JConfig
from constructionsceneposeestimation_tpu.config import PipelineConfig as JPipelineConfig
from constructionsceneposeestimation_tpu.config import SceneConfig as JSceneConfig
from constructionsceneposeestimation_tpu.eval import pipeline as jeval
from constructionsceneposeestimation_tpu.models import backbone as jbackbone
from constructionsceneposeestimation_tpu.models import pose_net as jpose_net
from constructionsceneposeestimation_tpu.ops import preprocess as jpre
from constructionsceneposeestimation_tpu.parallel import pipeline as jpipeline
from constructionsceneposeestimation_tpu_torch import convert
from constructionsceneposeestimation_tpu_torch.config import SceneConfig
from constructionsceneposeestimation_tpu_torch.core import camera
from constructionsceneposeestimation_tpu_torch.eval import pipeline as ev
from constructionsceneposeestimation_tpu_torch.models import backbone
from constructionsceneposeestimation_tpu_torch.scene import world

torch.set_num_threads(2)
RES, STRIDE = 128, 2
JCFG = JConfig(scene=JSceneConfig(n_cones=2, n_trees=1, n_fence_panels=4),
               pipeline=JPipelineConfig(render_width=RES, render_height=RES,
                                        heatmap_stride=STRIDE, heatmap_sigma=1.5))


@pytest.fixture(scope="module")
def setup():
    pipe = jpipeline.Pipeline(JCFG)
    jbatch = jax.jit(pipe.make_generate_fn(ladder=True))(jax.random.PRNGKey(0), jnp.arange(4))
    roster = world.make_roster(SceneConfig(n_cones=2, n_trees=1, n_fence_panels=4))
    intr = camera.intrinsics_from_apertures(12.0, 25.0, RES, RES)
    assert (intr.fx, intr.cx) == (float(pipe.intr.fx), float(pipe.intr.cx))
    return pipe, jbatch, convert.frame_batch(jbatch), roster, intr, {}


def _jit(fn, *static, **kw):
    """``fn(batch, *static, **kw)`` (and ``heatmaps=hm`` when given) under
    ``jax.jit``, the batch and the heatmaps traced: one compile instead of
    one per operation."""
    return jax.jit(lambda b, hm=None: fn(b, *static, **kw) if hm is None
                   else fn(b, *static, heatmaps=hm, **kw))


def _floor(setup, name):
    """The JAX package's evaluators on the GT heatmaps, computed once."""
    pipe, jb, _, _, _, cache = setup
    r, i = pipe.roster, pipe.intr
    fns = {
        "decode_floor": _jit(jeval.evaluate_decode, r, STRIDE),
        "assoc_floor": _jit(jeval.evaluate_decode_associated, r, STRIDE),
        "human_floor_dark": _jit(jeval.evaluate_human_pck, r, STRIDE),
        "human_floor_soft_argmax": _jit(jeval.evaluate_human_pck, r, STRIDE, use_dark=False),
        "dumper_gt_kpts": _jit(jeval.evaluate_equipment_6dof, r, i, "dumper", STRIDE,
                               use_gt_keypoints=True, ground_prior=True),
        "dumper_multi_floor": _jit(jeval.evaluate_equipment_6dof_multi, r, i, "dumper", STRIDE),
    }
    if name not in cache:
        cache[name] = fns[name](jb)
    return cache[name]


def _check(got, ref, counts_equal=True, denominators=None):
    assert got.keys() == ref.keys()
    for k, r in ref.items():
        g, r = got[k].numpy(), np.asarray(r)
        assert g.shape == r.shape, k
        if k.startswith("n_"):
            np.testing.assert_array_equal(g, r, err_msg=k)
        elif k in ("pck", "recall", "add_0_1d", "pck_per_kpt") and counts_equal:
            np.testing.assert_array_equal(g, r, err_msg=k)
        elif k in ("pck", "recall", "add_0_1d", "pck_per_kpt"):
            n = np.maximum(np.asarray(ref[denominators[k]]), 1)
            assert (np.abs(g - r) <= 1.0 / n + 1e-7).all(), (k, g, r)
        elif k.startswith("add") or k == "rmse":
            np.testing.assert_allclose(g, r, atol=1e-3, rtol=0, err_msg=k)
        else:
            np.testing.assert_allclose(g, r, atol=1e-3, rtol=1e-5, err_msg=k)


def test_decode_evaluators_match_jax(setup):
    _, _, tb, roster, _, _ = setup
    got = ev.evaluate_decode(tb, roster, STRIDE)
    _check(got, _floor(setup, "decode_floor"))
    assert float(got["pck"]) > 0.5  # the decode floor, as the JAX test holds it
    _check(ev.evaluate_decode_associated(tb, roster, STRIDE), _floor(setup, "assoc_floor"))
    for tag, dark in (("dark", True), ("soft_argmax", False)):
        _check(ev.evaluate_human_pck(tb, roster, STRIDE, use_dark=dark),
               _floor(setup, f"human_floor_{tag}"))


@pytest.mark.parametrize("kw", [
    dict(use_gt_keypoints=True, ground_prior=True),
    dict(ground_prior=True),
    dict(use_gt_keypoints=True),
    dict(use_ransac=False),
])
def test_equipment_6dof_matches_jax(setup, kw):
    pipe, jb, tb, roster, intr, _ = setup
    got = ev.evaluate_equipment_6dof(tb, roster, intr, "dumper", STRIDE, **kw)
    if kw == dict(use_gt_keypoints=True, ground_prior=True):
        ref = _floor(setup, "dumper_gt_kpts")
    else:
        ref = _jit(jeval.evaluate_equipment_6dof, pipe.roster, pipe.intr, "dumper", STRIDE,
                   **kw)(jb)
    _check(got, ref)
    if kw.get("use_gt_keypoints") and int(got["n_valid"]) > 0:
        assert float(got["add_0_1d"]) == 1.0 and float(got["add_mean"]) < 0.2


def test_equipment_6dof_ransac_waits(setup):
    """The RANSAC branch, which waited for its port, on the decoded GT
    heatmaps with the Gumbel draws of JAX's keys (a split of PRNGKey(0), a
    key a frame): its counts equal JAX's (tests/test_torch_crane.py holds
    the solves frame by frame)."""
    pipe, jb, tb, roster, intr, _ = setup
    ref = _jit(jeval.evaluate_equipment_6dof, pipe.roster, pipe.intr, "dumper", STRIDE)(jb)
    keys = jax.random.split(jax.random.PRNGKey(0), tb.rgb.shape[0])
    scores = torch.stack([torch.as_tensor(np.asarray(jax.random.gumbel(k, (32, 10))))
                          for k in keys])
    got = ev.evaluate_equipment_6dof(tb, roster, intr, "dumper", STRIDE, ransac_scores=scores)
    assert got.keys() == ref.keys()
    for k in ("n_valid", "n_accepted"):
        assert int(got[k]) == int(ref[k]), k
    assert all(bool(torch.isfinite(v)) for v in got.values())


@pytest.mark.parametrize("gt_kpts", [True, False])
def test_equipment_6dof_multi_matches_jax(setup, gt_kpts):
    pipe, jb, tb, roster, intr, _ = setup
    got = ev.evaluate_equipment_6dof_multi(tb, roster, intr, "dumper", STRIDE,
                                           use_gt_keypoints=gt_kpts)
    _check(got, _jit(jeval.evaluate_equipment_6dof_multi, pipe.roster, pipe.intr, "dumper",
                     STRIDE, use_gt_keypoints=True)(jb)
           if gt_kpts else _floor(setup, "dumper_multi_floor"))


def test_gt_camera_frame_pose_matches_jax(setup):
    pipe, jb, tb, roster, _, _ = setup
    for o in (0, 4, 5):
        R, t = ev.gt_camera_frame_pose(roster, tb, o)
        Rj, tj = jeval.gt_camera_frame_pose(pipe.roster, jb, o)
        np.testing.assert_allclose(R.numpy(), np.asarray(Rj), atol=1e-5)
        np.testing.assert_allclose(t.numpy(), np.asarray(tj), atol=1e-4)


def test_evaluation_step_matches_jax(setup):
    """Preprocess, forward, focal heatmaps, every evaluator: the port's
    ``evaluate_model`` against the same steps of the JAX package, on a
    narrow stride-2 backbone (the 2-px heatmaps of this configuration) with
    flax's weights."""
    pipe, jb, tb, roster, intr, _ = setup
    kw = dict(stage_features=(16, 32, 32, 64), deconv_features=32, output_stride=STRIDE)
    jm = jbackbone.HeatmapBackbone(num_channels=71, dtype=jnp.float32, **kw)
    params = jax.jit(jm.init)(jax.random.PRNGKey(4), jnp.zeros((1, RES, RES, 3)))
    tm = backbone.HeatmapBackbone(71, dtype=torch.float32, **kw)
    tm.load_state_dict(convert.pose_net_params(params, tm))
    got, hm = ev.evaluate_model(tm.eval(), tb, roster, intr, STRIDE)

    @jax.jit
    def jax_heatmaps(params, rgb):
        images = jax.vmap(lambda f: jpre.preprocess_frame(None, f, RES, RES, augment=False))(rgb)
        return jpose_net.output_to_heatmaps(jpose_net.forward(jm, params, images), "focal")

    jhm = jax_heatmaps(params, jb.rgb)
    assert hm.shape == tb.heatmaps.shape
    np.testing.assert_allclose(hm.numpy(), np.asarray(jhm), atol=1e-4, rtol=0)

    jpred = jb._replace(heatmaps=jhm)
    r, i = pipe.roster, pipe.intr
    ref = {
        "decode_model": _jit(jeval.evaluate_decode, r, STRIDE)(jpred),
        "assoc_model": _jit(jeval.evaluate_decode_associated, r, STRIDE)(jpred),
        "human_model_dark": _jit(jeval.evaluate_human_pck, r, STRIDE)(jb, jhm),
        "human_model_soft_argmax": _jit(jeval.evaluate_human_pck, r, STRIDE,
                                        use_dark=False)(jb, jhm),
        "dumper_model": _jit(jeval.evaluate_equipment_6dof, r, i, "dumper", STRIDE,
                             score_threshold=0.15, ground_prior=True)(jb, jhm),
        "dumper_multi_model": _jit(jeval.evaluate_equipment_6dof_multi, r, i, "dumper", STRIDE,
                                   score_threshold=0.15)(jb, jhm),
    }
    for name in ("decode_floor", "assoc_floor", "human_floor_dark", "human_floor_soft_argmax",
                 "dumper_gt_kpts", "dumper_multi_floor"):
        ref[name] = _floor(setup, name)
    # The crane rows and the dumper's channel scores, as the JAX cmd_train_eval
    # computes them (cli.py:293-299, :318-331).
    ref["crane_gt_kpts"] = _jit(jeval.evaluate_crane_6dof, r, i, STRIDE,
                                use_gt_keypoints=True)(jb)
    ref["crane_model"] = _jit(jeval.evaluate_crane_6dof, r, i, STRIDE,
                              score_threshold=0.15)(jb, jhm)
    lo, hi = jpose_net.class_channel_slices()["dumper"]
    d = jnp.max(jhm[:, lo:hi], axis=(-1, -2))
    ref["dumper_scores"] = {"mean": d.mean(), "max": d.max(), "ge_0_3": (d >= 0.3).mean(),
                            "ge_0_15": (d >= 0.15).mean()}
    assert got.keys() == ref.keys()
    dens = {"pck": "n_keypoints", "recall": "n_keypoints", "pck_per_kpt": "n_per_kpt",
            "add_0_1d": "n_accepted"}
    for name in ref:
        if "model" in name:
            d = dict(dens, add_0_1d="n_instances_evaluated") if "multi" in name else dens
            _check({k: v for k, v in got[name].items() if not k.startswith(("add_m", "mean"))},
                   {k: v for k, v in ref[name].items() if not k.startswith(("add_m", "mean"))},
                   counts_equal=False, denominators=d)
        else:
            _check(got[name], ref[name])
