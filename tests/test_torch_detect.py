"""The detector and the two-stage evaluators of the port (``ops/detect.py``,
``ops/decode._topk_iterative``, ``train/detect_loop.py``, the crop,
detector and crane-crop evaluators of ``eval/pipeline.py``) against the JAX
package's, on one batch of 64^2 ladder frames of a two-dumper scene (the
port's CPU generate; both packages take it as the same numpy arrays).

The evaluators run on stand-in networks that return the same fixed logits
on both sides (a detector's from the GT targets plus noise, crop nets'
with a bump at each keypoint's crop position), so the comparison holds the
evaluators, not two networks' rounding near a threshold; the networks
themselves are held by ``tests/test_torch_models.py``.

Tolerances: ``_topk_iterative`` and every index and count exact; targets
1e-6; the detection loss and its gradient 1e-5 relative; decoded boxes
1e-4 px, scores 1e-6; the detector's training step (flax's f32 weights,
optax's state, JAX's augment draws handed in): the loss 1e-5 relative at
each of 3 steps, the parameters after them 1e-5 on 99% of the weights and
within two steps' lr on the rest (``tests/test_torch_crop.py`` says why);
the evaluators' ratios 1e-6, ADD, RMSE and translation errors 1e-3 m
(those of ``tests/test_torch_eval.py``) or 1e-3 relative where a part's
solve lands metres off (the f32 conditioning of ``ROADMAP.md`` §3),
rotation errors 0.05 degrees."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from constructionsceneposeestimation_tpu.config import Config as JConfig
from constructionsceneposeestimation_tpu.config import PipelineConfig as JPipelineConfig
from constructionsceneposeestimation_tpu.config import SceneConfig as JSceneConfig
from constructionsceneposeestimation_tpu.config import TrainConfig as JTrainConfig
from constructionsceneposeestimation_tpu.core import camera as jcam
from constructionsceneposeestimation_tpu.eval import pipeline as jeval
from constructionsceneposeestimation_tpu.models import backbone as jbackbone
from constructionsceneposeestimation_tpu.ops import decode as jdecode
from constructionsceneposeestimation_tpu.ops import detect as jdetect
from constructionsceneposeestimation_tpu.parallel import pipeline as jpipeline
from constructionsceneposeestimation_tpu.scene import world as jworld
from constructionsceneposeestimation_tpu.train import detect_loop as jdetect_loop
from constructionsceneposeestimation_tpu.train import loop as jloop
from constructionsceneposeestimation_tpu_torch import convert
from constructionsceneposeestimation_tpu_torch.config import Config, PipelineConfig, SceneConfig
from constructionsceneposeestimation_tpu_torch.config import TrainConfig
from constructionsceneposeestimation_tpu_torch.core import camera
from constructionsceneposeestimation_tpu_torch.eval import pipeline as ev
from constructionsceneposeestimation_tpu_torch.models import backbone
from constructionsceneposeestimation_tpu_torch.ops import crop, decode, detect, preprocess
from constructionsceneposeestimation_tpu_torch.parallel.pipeline import Pipeline
from constructionsceneposeestimation_tpu_torch.train import crop_loop, detect_loop

torch.set_num_threads(2)
RES, B = 64, 4
SCENE = dict(n_cones=2, n_trees=1, n_fence_panels=4, n_dumpers=2)
CFG = Config(scene=SceneConfig(**SCENE), pipeline=PipelineConfig(render_width=RES,
                                                                 render_height=RES),
             train=TrainConfig(batch_size=B, steps=10, warmup_steps=2, loss="focal"))
JCFG = JConfig(scene=JSceneConfig(**SCENE),
               pipeline=JPipelineConfig(render_width=RES, render_height=RES),
               train=JTrainConfig(batch_size=B, steps=10, warmup_steps=2, loss="focal"))
C = len(detect.DET_CLASSES)


@pytest.fixture(scope="module")
def frames():
    """(port batch, JAX batch, port roster, JAX roster)."""
    pipe = Pipeline(CFG, device="cpu")
    batch = pipe.make_generate_fn(ladder=True, include_heatmaps=False)(0, range(B))
    jb = jpipeline.FrameBatch(*(jnp.asarray(v.numpy()) for v in batch))
    return batch, jb, pipe.roster, jworld.make_roster(JCFG.scene)


def _n(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _rows(case):
    rng = np.random.RandomState(len(case))
    x = rng.uniform(0, 1, (4, 60)).astype(np.float32)
    if case == "tied":
        x[:, [3, 17, 40]] = 1.5  # three equal maxima
        x[:, [5, 50]] = 1.2
    elif case == "plateau":
        x = np.round(x * 3) / 3  # four levels, each held by many entries
    elif case == "all zero":
        x[:] = 0.0
    elif case == "fewer than k":
        x[:] = 0.0
        x[:, [9, 33, 2]] = [0.7, 0.7, 0.2]
    return x


@pytest.mark.parametrize("case", ["tied", "plateau", "all zero", "fewer than k"])
def test_topk_iterative_matches_jax(case):
    """k = 8 rounds: values and indices exact; ties take the first index and
    a row with fewer than k non-zero entries repeats index 0 with 0."""
    x = _rows(case)
    vals, idx = decode._topk_iterative(torch.as_tensor(x), 8)
    jvals, jidx = jdecode._topk_iterative(jnp.asarray(x), 8)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    if case in ("all zero", "fewer than k"):
        assert (idx[:, 3:] == 0).all() and (vals[:, 3:] == 0).all()


def test_det_classes_and_extended_boxes_match_jax(frames):
    batch, jb, roster, jroster = frames
    assert detect.DET_CLASSES == jdetect.DET_CLASSES
    assert detect.CRANE_PART_CLASSES == jdetect.CRANE_PART_CLASSES
    assert detect.CLASS_LOSS_WEIGHTS == jdetect.CLASS_LOSS_WEIGHTS
    np.testing.assert_array_equal(detect_loop.extended_inst_classes(roster),
                                  np.asarray(jdetect_loop.extended_inst_classes(jroster)))
    got = detect_loop.crane_extended_boxes(batch, roster)
    ref = jdetect_loop.crane_extended_boxes(jb, jroster)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(_n(g), np.asarray(r))


def _targets(batch, roster, stride):
    bbox, vis = detect_loop.crane_extended_boxes(batch, roster)
    cls = torch.as_tensor(detect_loop.extended_inst_classes(roster))
    return detect.build_targets(bbox, vis, cls, RES // stride, RES // stride, float(stride))


@pytest.mark.parametrize("stride", [2, 4])
def test_targets_and_detection_loss_match_jax(frames, stride):
    batch, jb, roster, jroster = frames
    h = RES // stride
    got = _targets(batch, roster, stride)
    jbox, jvis = jdetect_loop.crane_extended_boxes(jb, jroster)
    jcls = jdetect_loop.extended_inst_classes(jroster)
    ref = jax.vmap(lambda b, v: jdetect.build_targets(b, v, jcls, h, h, float(stride)))(jbox, jvis)
    for name, g, r in zip(("center", "size", "offset", "pos_uv", "pos_mask"), got, ref):
        if name in ("pos_uv", "pos_mask"):
            np.testing.assert_array_equal(_n(g), np.asarray(r), err_msg=name)
        else:
            np.testing.assert_allclose(_n(g), np.asarray(r), rtol=1e-6, atol=1e-6, err_msg=name)
    assert got[0].max() > 0.9 and int(got[4].sum()) > 3

    pred = np.random.RandomState(stride).randn(B, C + 4, h, h).astype(np.float32) * 2.0
    cls_w = jnp.asarray(jdetect.CLASS_LOSS_WEIGHTS, jnp.float32)

    def jloss(p):
        per, aux = jax.vmap(lambda q, *t: jdetect.detection_loss(q, *t, class_weights=cls_w))(
            p, *ref)
        return jnp.mean(per), (per, aux)

    (_, (jper, jaux)), jgrad = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(pred))
    p = torch.tensor(pred, requires_grad=True)
    per, aux = detect.detection_loss(p, *got,
                                     class_weights=torch.as_tensor(detect.CLASS_LOSS_WEIGHTS))
    torch.mean(per).backward()
    np.testing.assert_allclose(per.detach().numpy(), np.asarray(jper), rtol=1e-5)
    for k in ("hm", "size_l1", "off_l1"):
        np.testing.assert_allclose(aux[k].detach().numpy(), np.asarray(jaux[k]), rtol=1e-5,
                                   err_msg=k)
    g = np.asarray(jgrad)
    np.testing.assert_allclose(p.grad.numpy(), g, rtol=1e-5, atol=1e-5 * np.abs(g).max())


def _det_logits(batch, roster, stride, seed=0):
    """Detector outputs (B, C + 4, h, w) that find the frames' objects: the
    centre logits of the GT targets plus noise, the size and offset maps
    the targets' at the centres and noise elsewhere."""
    center, size, offset, pos_uv, mask = (_n(x) for x in _targets(batch, roster, stride))
    rng = np.random.RandomState(seed)
    h = RES // stride
    c = np.clip(center * 0.95, 1e-3, None)
    out = np.empty((B, C + 4, h, h), np.float32)
    out[:, :C] = np.log(c / (1 - c)) + 0.5 * rng.randn(B, C, h, h)
    out[:, C:] = rng.uniform(0, 3, (B, 4, h, h))
    for b in range(B):
        for o in np.nonzero(mask[b])[0]:
            u, v = pos_uv[b, o]
            out[b, C:C + 2, v, u] = size[b, o] + 0.1 * rng.randn(2)
            out[b, C + 2:, v, u] = offset[b, o]
    return out


@pytest.mark.parametrize("stride", [2, 4])
def test_decode_detections_matches_jax(frames, stride):
    batch, _, roster, _ = frames
    pred = _det_logits(batch, roster, stride)
    boxes, scores = detect.decode_detections(torch.as_tensor(pred), float(stride), 8)
    jboxes, jscores = jax.vmap(lambda p: jdetect.decode_detections(p, float(stride), 8))(
        jnp.asarray(pred))
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores), atol=1e-6)
    np.testing.assert_allclose(boxes.numpy(), np.asarray(jboxes), atol=1e-4)
    assert boxes.shape == (B, C, 8, 4)
    # NMS and selection on the same post-sigmoid maps: indices exact.
    hm = 1.0 / (1.0 + np.exp(-pred[:, :C].astype(np.float64))).astype(np.float32)
    nms_k = 3 if stride >= 4 else 5
    lm = detect._local_max(torch.as_tensor(hm), nms_k)
    jlm = jax.vmap(lambda m: jdetect._local_max(m, nms_k))(jnp.asarray(hm))
    np.testing.assert_array_equal(lm.numpy(), np.asarray(jlm))
    _, idx = decode._topk_iterative(lm.reshape(B, C, -1), 8)
    _, jidx = jdecode._topk_iterative(jlm.reshape(B, C, -1), 8)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))


def _jax_draws(seed_key, fids):
    """JAX's augment draws for the keys fold_in(seed_key, f), as the port's."""
    draws = []
    for f in fids:
        k1, k2, k3, k4 = jax.random.split(jax.random.fold_in(seed_key, int(f)), 4)
        draws.append((1.0 + jax.random.uniform(k1, (), minval=-0.2, maxval=0.2),
                      1.0 + jax.random.uniform(k2, (), minval=-0.2, maxval=0.2),
                      1.0 + jax.random.uniform(k3, (3,), minval=-0.05, maxval=0.05),
                      jax.random.normal(k4, (RES, RES, 3))))
    return preprocess.AugmentDraws(*(torch.as_tensor(np.asarray(np.stack(v), np.float32))
                                     for v in zip(*draws)))


def test_data_detect_train_step_matches_jax(frames):
    """``make_data_detect_train_step`` against the JAX package's on shard
    rows (rgb, bbox2d int32, inst_visible), narrow stride-2 net, 3 steps
    with JAX's augment draws (keys fold_in(seed, step * B + i))."""
    batch, _, roster, jroster = frames
    kw = dict(stage_features=(16, 32, 32, 64), deconv_features=32, output_stride=2)
    jm = jbackbone.HeatmapBackbone(num_channels=C + 4, dtype=jnp.float32, **kw)
    js = jloop.create_train_state(JCFG, jm, jax.random.PRNGKey(2))
    tm = backbone.HeatmapBackbone(C + 4, dtype=torch.float32, **kw)
    state = convert.train_state(js, tm, CFG)
    rgb, bbox, vis = (batch.rgb.numpy(), batch.bbox2d.numpy(), batch.inst_visible.numpy())
    seed = jax.random.PRNGKey(7)
    step = detect_loop.make_data_detect_train_step(CFG, tm, roster)
    own = step.draws(11, 2, B)
    ref = preprocess.augment_draws(11, range(2 * B, 3 * B), RES, RES)
    assert all(torch.equal(a, b) for a, b in zip(own, ref))
    step.draws = lambda _seed, s, b: _jax_draws(seed, s * b + np.arange(b))
    jstep = jax.jit(jdetect_loop.make_data_detect_train_step(JCFG, jm, jroster))
    for i in range(3):
        js, jmet = jstep(js, seed, jnp.asarray(rgb), jnp.asarray(bbox), jnp.asarray(vis))
        state, met = step(state, 0, rgb, bbox, vis)
        np.testing.assert_allclose(met["loss"].item(), float(jmet["loss"]), rtol=1e-5)
        assert met["step"] == int(jmet["step"]) == i
    ref_sd = convert.pose_net_params(js.params, tm)
    two_lr = 2.0 * (state.scheduler.lr_lambdas[0](1) + state.scheduler.lr_lambdas[0](2))
    d = np.concatenate([np.abs(p.detach().numpy() - ref_sd[name].numpy()).ravel()
                        for name, p in tm.named_parameters()])
    assert (d > 1e-5).mean() <= 0.01 and d.max() <= two_lr, ((d > 1e-5).sum(), d.size, d.max())
    assert state.step == int(js.step) == 3


class Fixed(nn.Module):
    """A stand-in network: returns ``out`` (N, C, h, w) for any N images."""

    def __init__(self, out, stride):
        super().__init__()
        self.out, self.output_stride = torch.as_tensor(out), stride

    def forward(self, x):
        assert x.shape[0] == self.out.shape[0]
        return self.out


class JFixed:
    """The same stand-in for the JAX package's ``pose_net.forward``."""

    def __init__(self, out, stride):
        self.out, self.output_stride = jnp.asarray(np.transpose(out, (0, 2, 3, 1))), stride

    def apply(self, params, x):
        return self.out


def _check(got, ref, skip=()):
    assert set(got) == set(ref), set(got) ^ set(ref)
    for k, r in ref.items():
        if k in skip:
            continue
        g, r = _n(got[k]), np.asarray(r)
        if k.startswith("n_"):
            np.testing.assert_array_equal(g, r, err_msg=k)
        elif k.startswith(("add_mean", "rmse", "t_err")):
            np.testing.assert_allclose(g, r, atol=1e-3, rtol=1e-3, err_msg=k)
        elif k.startswith("rot_err"):
            np.testing.assert_allclose(g, r, atol=0.05, err_msg=k)
        elif k == "boxes" or k.endswith("_boxes"):
            np.testing.assert_allclose(g, r, atol=1e-4, err_msg=k)
        else:
            np.testing.assert_allclose(g, r, atol=1e-6, err_msg=k)


@pytest.fixture(scope="module")
def detector(frames):
    """``evaluate_detector`` (analysis on) of both packages on the same
    stand-in stride-2 detector outputs."""
    batch, jb, roster, jroster = frames
    pred = _det_logits(batch, roster, 2, seed=3)
    got = ev.evaluate_detector(batch, roster, Fixed(pred, 2), analysis=True)
    ref = jax.jit(lambda b: jeval.evaluate_detector(b, jroster, JFixed(pred, 2), None,
                                                    analysis=True))(jb)
    return got, ref


def test_evaluate_detector_matches_jax(detector):
    got, ref = detector
    _check(got, ref)
    assert 0 < float(got["recall"]) and 0 < float(got["map"]) < 1
    assert float(got["miss_loc_fence"]) + float(got["miss_score_human"]) > 0  # misses split


def _bumps(uv_crop, vis, n_ch, size, stride, seed):
    """Crop-net logits (N, n_ch, h, h) with a bump at each visible
    keypoint's crop position (uv_crop (N, n_ch, 2)), moved by up to 1.5
    crop px, on a -5 background."""
    rng = np.random.RandomState(seed)
    h = size // stride
    uv = (uv_crop + rng.uniform(-1.5, 1.5, uv_crop.shape)) / stride
    ys, xs = np.mgrid[:h, :h]
    d2 = (xs - uv[..., 0, None, None]) ** 2 + (ys - uv[..., 1, None, None]) ** 2
    out = 10.0 * np.exp(-d2 / 4.5) * vis[..., None, None] - 5.0
    return out.astype(np.float32)


def _dumper_crop_logits(batch, roster, boxes, size, stride, seed):
    """Stand-in dumper crop-net outputs for the square ROIs of ``boxes``
    (B, I, 4), the keypoints of the instance each box overlaps most."""
    idxs = [i for i, n in enumerate(roster.inst_class_names) if n == "dumper"]
    K = 10
    tb = torch.as_tensor(boxes)
    gt = batch.bbox2d[:, idxs].float()
    iou = ev._iou(tb[:, :, None], gt[:, None])  # (B, I, I_gt)
    owner = torch.argmax(iou, -1)
    uv = batch.kpt_uv[:, idxs, :K][torch.arange(B)[:, None], owner]  # (B, I, K, 2)
    vis = batch.kpt_visible[:, idxs, :K][torch.arange(B)[:, None], owner]
    roi = crop.square_roi(tb)
    uvc = crop.uv_to_crop(uv, *(x[..., None] for x in roi), size)
    return _bumps(_n(uvc).reshape(-1, K, 2), _n(vis).reshape(-1, K), K, size, stride, seed)


def test_evaluate_crop_6dof_matches_jax(frames, detector):
    """The label boxes of the first dumper, then the detector's best dumper
    box (two dumpers: each frame's box scored against the instance it
    overlaps most)."""
    batch, jb, roster, jroster = frames
    intr, jintr = camera.intrinsics_from_apertures(12.0, 25.0, RES, RES), \
        jcam.intrinsics_from_apertures(12.0, 25.0, RES, RES)
    o = roster.inst_class_names.index("dumper")
    for boxes in (None, _n(detector[0]["dumper_boxes"])):
        bx = _n(batch.bbox2d[:, o]).astype(np.float32) if boxes is None else boxes
        out = _dumper_crop_logits(batch, roster, bx[:, None], 32, 4, 1)
        tb = None if boxes is None else torch.as_tensor(boxes)
        # A dumper is ~5 px wide at 64^2: min_box_px 2 keeps the frames in.
        got = ev.evaluate_crop_6dof(batch, roster, intr, Fixed(out, 4), "dumper", 32,
                                    score_threshold=0.15, min_box_px=2.0, boxes=tb)
        ref = jax.jit(lambda b, bx: jeval.evaluate_crop_6dof(
            b, jroster, jintr, JFixed(out, 4), None, "dumper", 32, score_threshold=0.15,
            min_box_px=2.0, boxes=bx))(jb, None if boxes is None else jnp.asarray(boxes))
        _check(got, ref)
        assert int(got["n_valid"]) > 0


def test_evaluate_crop_6dof_multi_matches_jax(frames, detector):
    """Both dumpers from the label boxes, then from the detector's dumper
    detections matched one to one (``match_boxes_to_instances``)."""
    batch, jb, roster, jroster = frames
    intr, jintr = camera.intrinsics_from_apertures(12.0, 25.0, RES, RES), \
        jcam.intrinsics_from_apertures(12.0, 25.0, RES, RES)
    di = detect.DET_CLASSES.index("dumper")
    det_b, det_s = detector[0]["boxes"][:, di], detector[0]["scores"][:, di]
    idxs = [i for i, n in enumerate(roster.inst_class_names) if n == "dumper"]
    gt = batch.bbox2d[:, idxs].float()
    matched = ev.match_boxes_to_instances(det_b, det_s, gt)
    jmatched = jeval.match_boxes_to_instances(jnp.asarray(_n(det_b)), jnp.asarray(_n(det_s)),
                                              jnp.asarray(_n(gt)))
    np.testing.assert_allclose(_n(matched[0]), np.asarray(jmatched[0]), atol=1e-6)
    np.testing.assert_array_equal(_n(matched[1]), np.asarray(jmatched[1]))
    for use_det in (False, True):
        rois = _n(matched[0]) if use_det else _n(gt)
        out = _dumper_crop_logits(batch, roster, rois, 32, 4, 2)
        kw = dict(boxes=det_b, box_scores=det_s) if use_det else {}
        got = ev.evaluate_crop_6dof_multi(batch, roster, intr, Fixed(out, 4), "dumper", 32,
                                          score_threshold=0.15, min_box_px=2.0, **kw)
        jkw = {k: jnp.asarray(_n(v)) for k, v in kw.items()}
        ref = jax.jit(lambda b, kw: jeval.evaluate_crop_6dof_multi(
            b, jroster, jintr, JFixed(out, 4), None, "dumper", 32, score_threshold=0.15,
            min_box_px=2.0, **kw))(jb, jkw)
        _check(got, ref)


def _crane_crop_logits(batch, roster, rois, size, stride, seed, half_v=None):
    """Stand-in crane crop-net outputs (4 * Kp channels) for ROIs (B, R)."""
    s0, Kp = crop_loop.crane_channels(roster)
    uv, vis = crop_loop._crane_keypoints(batch, roster)  # (B, 4 Kp, 2), (B, 4 Kp)
    cu, cv, half = rois
    hv = half if half_v is None else half_v
    uvc = crop.uv_to_crop(uv[:, None], cu[..., None], cv[..., None], half[..., None], size,
                          half_v=hv[..., None])  # (B, R, 4 Kp, 2)
    R = cu.shape[1]
    vis = vis[:, None].expand(-1, R, -1)
    return _bumps(_n(uvc).reshape(-1, 4 * Kp, 2), _n(vis).reshape(-1, 4 * Kp), 4 * Kp, size,
                  stride, seed)


@pytest.mark.parametrize("mode", ["union", "per part, labels", "per part, detector"])
def test_evaluate_crop_crane_6dof_matches_jax(frames, detector, mode):
    batch, jb, roster, jroster = frames
    intr, jintr = camera.intrinsics_from_apertures(12.0, 25.0, RES, RES), \
        jcam.intrinsics_from_apertures(12.0, 25.0, RES, RES)
    s0, _ = crop_loop.crane_channels(roster)
    size, stride = 32, 2
    kw, jkw = {}, {}
    if mode == "union":
        box, _ = crop_loop.crane_union_roi(batch, roster)
        roi = tuple(x[:, None] for x in crop.square_roi(box))
        out = _crane_crop_logits(batch, roster, roi, size, stride, 3)
    else:
        if mode == "per part, detector":
            pb, ps = ev.best_part_boxes(detector[0]["boxes"], detector[0]["scores"])
            jpb, jps = jeval.best_part_boxes(detector[1]["boxes"], detector[1]["scores"])
            np.testing.assert_allclose(_n(pb), np.asarray(jpb), atol=1e-4)
            np.testing.assert_allclose(_n(ps), np.asarray(jps), atol=1e-6)
            kw = dict(part_boxes=pb, part_scores=ps)
            jkw = {k: jnp.asarray(_n(v)) for k, v in kw.items()}
        else:
            pb = batch.bbox2d[:, s0:s0 + 4].float()
        cu, cv, hu, hv = crop.rect_roi(pb, min_half=24.0)
        out = _crane_crop_logits(batch, roster, (cu, cv, hu), size, stride, 4, half_v=hv)
    per_part = mode != "union"
    got = ev.evaluate_crop_crane_6dof(batch, roster, intr, Fixed(out, stride), size,
                                      per_part=per_part, **kw)
    ref = jax.jit(lambda b, kw: jeval.evaluate_crop_crane_6dof(
        b, jroster, jintr, JFixed(out, stride), None, size, per_part=per_part, **kw))(jb, jkw)
    _check(got, ref)
    assert int(got["n_valid"]) > 0
    if mode == "per part, labels":
        vis = batch.inst_visible[:, s0:s0 + 4]
        got = ev.crane_part_keypoints(batch.rgb, pb, vis, roster, Fixed(out, stride), size)
        ref = jeval.crane_part_keypoints(jb.rgb, jnp.asarray(_n(pb)), jnp.asarray(_n(vis)),
                                         jroster, JFixed(out, stride), None, size)
        for g, r in zip(got, ref):
            np.testing.assert_allclose(_n(g), np.asarray(r), atol=1e-4)


def test_crop_models_have_the_jax_channels(frames):
    _, _, roster, jroster = frames
    from constructionsceneposeestimation_tpu.train import crop_loop as jcrop_loop
    for cls in ("dumper", "crane"):
        m = crop_loop.make_crop_model(cls, lite=True, roster=roster, device="cpu")
        jm = jcrop_loop.make_crop_model(cls, lite=True, roster=jroster)
        assert m.num_channels == jm.num_channels
    m = detect_loop.make_detect_model(output_stride=2, device="cpu")
    assert m.num_channels == C + 4 == jdetect_loop.make_detect_model().num_channels
    assert m.output_stride == 2

