"""The port's deployment function (``cli.make_infer_fn``) against the same
composition of the JAX package's public functions that the JAX
``cmd_infer`` closure runs (``constructionsceneposeestimation_tpu/cli.py``
lines 655-711, written out below), on narrow networks with flax's f32
weights, and the records ``cli.frame_record`` writes.

Frames: 4 ladder frames of 64^2 (the port's CPU generate; both packages
take them as the same numpy arrays). Tolerances: decoded boxes 1e-3 px and
scores 1e-5 (the networks agree to ~1e-5), validity exact; on every slot
whose solve is valid, the rotations 1e-3, the RMSEs (the solves'
objective) 1e-6, and the translations 5e-3 m or 1e-3 of their length: the
random networks' keypoints leave the solves' minima flat along the depth,
where the two f32 solves part by up to 2e-3 m on these frames
(``ROADMAP.md`` §3, f32 conditioning)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from constructionsceneposeestimation_tpu.core import camera as jcam
from constructionsceneposeestimation_tpu.core import rotation as jrot
from constructionsceneposeestimation_tpu.eval import pipeline as jeval
from constructionsceneposeestimation_tpu.models import backbone as jbackbone
from constructionsceneposeestimation_tpu.models import pose_net as jpose_net
from constructionsceneposeestimation_tpu.ops import crop as jcrop
from constructionsceneposeestimation_tpu.ops import decode as jdecode
from constructionsceneposeestimation_tpu.ops import detect as jdetect
from constructionsceneposeestimation_tpu.ops import pnp as jpnp
from constructionsceneposeestimation_tpu.ops import preprocess as jpre
from constructionsceneposeestimation_tpu.scene import assets as jassets
from constructionsceneposeestimation_tpu.scene import world as jworld
from constructionsceneposeestimation_tpu.config import SceneConfig as JSceneConfig
from constructionsceneposeestimation_tpu.train import crop_loop as jcrop_loop
from constructionsceneposeestimation_tpu_torch import cli, convert
from constructionsceneposeestimation_tpu_torch.config import Config, PipelineConfig, SceneConfig
from constructionsceneposeestimation_tpu_torch.models import backbone
from constructionsceneposeestimation_tpu_torch.parallel.pipeline import Pipeline

torch.set_num_threads(2)
RES, B, CROP, MAX_DET, THR = 64, 4, 32, 4, 0.3
SCENE = dict(n_cones=2, n_trees=1, n_fence_panels=4)
NARROW = dict(stage_features=(16, 32, 32, 64), deconv_features=32)
NETS = {"det": (14, 2), "crop": (10, 4), "crane": (28, 2)}  # channels, stride


@pytest.fixture(scope="module")
def setup():
    pipe = Pipeline(Config(scene=SceneConfig(**SCENE),
                           pipeline=PipelineConfig(render_width=RES, render_height=RES)),
                    device="cpu")
    batch = pipe.make_generate_fn(ladder=True, include_heatmaps=False)(0, range(B))
    jnets, nets = {}, {}
    for i, (name, (ch, stride)) in enumerate(NETS.items()):
        jm = jbackbone.HeatmapBackbone(num_channels=ch, output_stride=stride, dtype=jnp.float32,
                                       **NARROW)
        size = RES if name == "det" else CROP
        params = jax.jit(jm.init)(jax.random.PRNGKey(10 + i), jnp.zeros((1, size, size, 3)))
        tm = backbone.HeatmapBackbone(ch, output_stride=stride, dtype=torch.float32, **NARROW)
        tm.load_state_dict(convert.pose_net_params(params, tm))
        jnets[name], nets[name] = (jm, params), tm.eval()
    return pipe, batch, jnets, nets, jworld.make_roster(JSceneConfig(**SCENE))


def _jax_infer(jnets, roster, intr, crane: bool):
    """The JAX ``cmd_infer`` closure (cli.py:656-714) on these networks."""
    det_model, det_params = jnets["det"]
    crop_model, crop_params = jnets["crop"]
    crane_model, crane_params = jnets["crane"]
    model_pts = jnp.asarray(jassets.all_templates()["dumper"].keypoints)

    def infer(rgb, camera_pose7):
        imgs = jax.vmap(lambda r: jpre.normalize(r.astype(jnp.float32) / 255.0))(rgb)
        pred = jpose_net.forward(det_model, det_params, imgs)
        stride = getattr(det_model, "output_stride", 4)
        boxes, scores = jax.vmap(lambda p: jdetect.decode_detections(
            p, float(stride), MAX_DET))(pred)
        R_wp = jrot.matrix_from_quat_xyzw(camera_pose7[..., 3:])
        cam = camera_pose7[..., :3]
        n = rgb.shape[0]
        di = jdetect.DET_CLASSES.index("dumper")
        dboxes = boxes[:, di]
        cu, cv, half = jcrop.square_roi(dboxes)
        crops = jax.vmap(lambda r, cs, vs, hs: jax.vmap(
            lambda c1, v1, h1: jpre.normalize(jcrop.crop_resize(
                r.astype(jnp.float32) / 255.0, c1, v1, h1, CROP)))(cs, vs, hs))(rgb, cu, cv, half)
        hm = jpose_net.output_to_heatmaps(
            jpose_net.forward(crop_model, crop_params,
                              crops.reshape((n * MAX_DET,) + crops.shape[2:])), "focal")
        cstride = getattr(crop_model, "output_stride", 4)
        uv_c, sc = jdecode.dark_decode(hm)
        K = uv_c.shape[1]
        uv_c = uv_c.reshape(n, MAX_DET, K, 2)
        sc = sc.reshape(n, MAX_DET, K)
        uv = jcrop.crop_to_uv(uv_c * cstride, cu[..., None], cv[..., None], half[..., None],
                              CROP)
        w = jnp.where(sc >= 0.15, sc, 0.0)
        x = jpnp.normalize_pixels(uv, intr.fx, intr.fy, intr.cx, intr.cy)
        Xb = jnp.broadcast_to(model_pts, (MAX_DET,) + model_pts.shape)
        dres = jax.vmap(lambda xx, ww, Rw, cp: jax.vmap(
            lambda X, xi, wi: jpnp.solve_ground_pose(X, xi, wi, Rw, cp))(Xb, xx, ww))(
                x, w, R_wp, cam)
        out = {"boxes": boxes, "scores": scores, "dumper_R": dres.R, "dumper_t": dres.t,
               "dumper_rmse": dres.rmse, "dumper_valid": dres.valid}
        if crane:
            pb, ps = jeval.best_part_boxes(boxes, scores)
            cuv, csc, cw = jeval.crane_part_keypoints(rgb, pb, ps >= THR, roster, crane_model,
                                                      crane_params, crop_size=CROP)
            s0, Kp = jcrop_loop.crane_channels(roster)
            kpts_local = jnp.asarray(roster.inst_kpts[s0:s0 + 4, :Kp])
            cx = jpnp.normalize_pixels(cuv, intr.fx, intr.fy, intr.cx, intr.cy)
            cres = jax.vmap(lambda xx, ww, Rw, cp: jpnp.solve_crane_pose(
                kpts_local, xx, ww, Rw, cp))(cx, cw, R_wp, cam)
            out.update({"crane_part_boxes": pb, "crane_part_scores": ps, "crane_R": cres.R,
                        "crane_t": cres.t, "crane_rmse": cres.rmse, "crane_valid": cres.valid})
        return out

    return infer


@pytest.fixture(scope="module")
def outputs(setup):
    pipe, batch, jnets, nets, jroster = setup
    jintr = jcam.intrinsics_from_apertures(12.0, 25.0, RES, RES)
    assert float(jintr.fx) == float(pipe.intr.fx)
    ref = jax.jit(_jax_infer(jnets, jroster, jintr, True))(jnp.asarray(batch.rgb.numpy()),
                                                          jnp.asarray(batch.camera_pose7.numpy()))
    infer = cli.make_infer_fn(nets["det"], nets["crop"], CROP, pipe.intr, pipe.roster, MAX_DET,
                              nets["crane"], CROP, THR)
    got = infer(batch.rgb, batch.camera_pose7)
    return {k: v.numpy() for k, v in got.items()}, {k: np.asarray(v) for k, v in ref.items()}


def test_infer_fn_matches_jax(outputs):
    got, ref = outputs
    assert set(got) == set(ref)  # jit returns the dict's keys sorted
    np.testing.assert_allclose(got["scores"], ref["scores"], atol=1e-5)
    np.testing.assert_allclose(got["boxes"], ref["boxes"], atol=1e-3)
    np.testing.assert_allclose(got["crane_part_scores"], ref["crane_part_scores"], atol=1e-5)
    np.testing.assert_allclose(got["crane_part_boxes"], ref["crane_part_boxes"], atol=1e-3)
    assert (got["scores"] >= THR).sum() > 0  # detections to write
    for who in ("dumper", "crane"):
        np.testing.assert_array_equal(got[f"{who}_valid"], ref[f"{who}_valid"])
        ok = ref[f"{who}_valid"]
        assert ok.any(), who
        np.testing.assert_allclose(got[f"{who}_R"][ok], ref[f"{who}_R"][ok], atol=1e-3)
        np.testing.assert_allclose(got[f"{who}_rmse"][ok], ref[f"{who}_rmse"][ok], atol=1e-6)
        t, t_ref = got[f"{who}_t"][ok], ref[f"{who}_t"][ok]
        d = np.linalg.norm(t - t_ref, axis=-1)
        assert (d <= np.maximum(5e-3, 1e-3 * np.linalg.norm(t_ref, axis=-1))).all(), d


def test_infer_fn_without_crane_model(setup, outputs):
    """No crane network: the dumper's outputs only, the same values."""
    pipe, batch, _, nets, _ = setup
    got = cli.make_infer_fn(nets["det"], nets["crop"], CROP, pipe.intr, pipe.roster,
                            MAX_DET)(batch.rgb, batch.camera_pose7)
    assert list(got) == ["boxes", "scores", "dumper_R", "dumper_t", "dumper_rmse",
                         "dumper_valid"]
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), outputs[0][k])


def test_frame_record_format(outputs):
    """The JAX command's record: key order, the plain classes' detections
    above the threshold, the dumper's pose fields with ``pose_accepted`` at
    RMSE <= 8 px, one crane record with four named parts."""
    o, _ = outputs
    px2n = 1.0 / 40.0
    cam7 = np.arange(7, dtype=np.float32)
    for i in range(B):
        rec = cli.frame_record(o, i, 100 + i, cam7, THR, px2n)
        assert list(rec) == ["frame_id", "camera_pose7", "detections"]
        assert rec["frame_id"] == 100 + i and rec["camera_pose7"] == list(range(7))
        json.dumps(rec)
        plain = [d for d in rec["detections"] if d["class"] != "crane"]
        want = sum(int((o["scores"][i, ci] >= THR).sum()) for ci in range(5))
        assert len(plain) == want
        for d in plain:
            keys = ["class", "score", "bbox2d"]
            if d["class"] == "dumper":
                keys += ["pose_accepted", "R_cam", "t_cam", "reproj_rmse_px"]
            assert list(d) == keys and d["score"] >= THR
        crane = [d for d in rec["detections"] if d["class"] == "crane"]
        assert len(crane) == int((o["crane_part_scores"][i] >= THR).any())
        for d in crane:
            assert list(d) == ["class", "pose_accepted", "reproj_rmse_px", "parts"]
            assert d["pose_accepted"] == (bool(o["crane_valid"][i])
                                          and float(o["crane_rmse"][i]) <= 8.0 * px2n)
            assert [p["name"] for p in d["parts"]] == list(cli.CRANE_PARTS)
            assert list(d["parts"][0]) == ["name", "score", "bbox2d", "R_cam", "t_cam"]
