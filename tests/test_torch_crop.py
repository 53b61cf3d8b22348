"""The crop stage of the port (``ops/crop.py``, ``train/crop_loop.py``)
against the JAX package's, on one batch of 64^2 ladder frames (the port's
CPU generate; both packages take it as the same numpy arrays).

Tolerances: ``crop_resize`` 1e-5 on [0, 1] images (both build the same
triangle weights and contract them in f32, in another order); the ROI ops
1e-6 relative; ``crop_batch`` and its crane variants with JAX's draws handed
in: images 1e-5 on the [0, 1] scale (compared with the normalization
undone: it divides by std ~0.225), targets 1e-6, weights exact; the crop training step (flax's f32 weights and optax's
state through ``convert.train_state``, the same crops on both sides): the
loss 1e-5 relative at each of 3 steps, and the parameters after them 1e-5,
as ``test_train_on_batch_matches_jax``, on 99% of the net's weights.
Adam moves a weight by about lr whatever its gradient's size, so a weight
whose gradient is within the two packages' rounding (their gradients agree
to ~1e-4 of a tensor's norm) moves in the direction its rounding gives, on
each side its own: at most 1% of the weights, which are held within
two steps' lr. (The stage-1 test meets 1e-5 on every weight of its net.)
The per-part crane crops are held by ``crop_batch`` only: at 64^2 frames
most of them lie largely off the frame, and GroupNorm over their constant
zero regions divides rounding noise by sqrt(1e-6), so the two packages'
gradients on them part by more than the training step's tolerance."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from constructionsceneposeestimation_tpu.config import Config as JConfig
from constructionsceneposeestimation_tpu.config import SceneConfig as JSceneConfig
from constructionsceneposeestimation_tpu.config import TrainConfig as JTrainConfig
from constructionsceneposeestimation_tpu.models import backbone as jbackbone
from constructionsceneposeestimation_tpu.models import pose_net as jpose_net
from constructionsceneposeestimation_tpu.ops import crop as jcrop
from constructionsceneposeestimation_tpu.parallel import pipeline as jpipeline
from constructionsceneposeestimation_tpu.scene import world as jworld
from constructionsceneposeestimation_tpu.train import crop_loop as jcrop_loop
from constructionsceneposeestimation_tpu.train import loop as jloop
from constructionsceneposeestimation_tpu.train import losses as jlosses
from constructionsceneposeestimation_tpu_torch import convert
from constructionsceneposeestimation_tpu_torch.config import Config, PipelineConfig, SceneConfig
from constructionsceneposeestimation_tpu_torch.config import TrainConfig
from constructionsceneposeestimation_tpu_torch.models import backbone
from constructionsceneposeestimation_tpu_torch.ops import crop, preprocess
from constructionsceneposeestimation_tpu_torch.parallel.pipeline import Pipeline
from constructionsceneposeestimation_tpu_torch.train import crop_loop

torch.set_num_threads(2)
RES, B, CROP, SIGMA = 64, 4, 32, 1.5
STEP_CROP = 64  # the training step's crops: the narrow net's /32 stage is then 2 x 2
SCENE = dict(n_cones=2, n_trees=1, n_fence_panels=4)
CFG = Config(scene=SceneConfig(**SCENE), pipeline=PipelineConfig(render_width=RES,
                                                                 render_height=RES),
             train=TrainConfig(batch_size=B, steps=10, warmup_steps=2, loss="focal"))
JCFG = JConfig(scene=JSceneConfig(**SCENE),
               train=JTrainConfig(batch_size=B, steps=10, warmup_steps=2, loss="focal"))
NARROW = dict(stage_features=(16, 32, 32, 64), deconv_features=32)
SEED = jax.random.PRNGKey(3)


def to_jax(batch):
    """A port ``FrameBatch`` as the JAX package's, field for field."""
    return jpipeline.FrameBatch(*(jnp.asarray(v.numpy()) for v in batch))


@pytest.fixture(scope="module")
def frames():
    """(port batch, JAX batch, port roster, JAX roster): 4 ladder frames."""
    pipe = Pipeline(CFG, device="cpu")
    batch = pipe.make_generate_fn(ladder=True, include_heatmaps=False)(0, range(B))
    return batch, to_jax(batch), pipe.roster, jworld.make_roster(JCFG.scene)


def _np(x):
    return np.asarray(x, np.float32)


def _unit(images):
    """Normalized crops back on the [0, 1] scale."""
    return np.asarray(images) * preprocess.IMAGENET_STD + preprocess.IMAGENET_MEAN


# Four ROIs (one per frame) of each kind: [u0, v0, u1, v1] boxes.
ROI_CASES = {
    "shrink": [[4.0, 6.0, 60.0, 58.0], [10.0, 0.0, 50.0, 44.0], [0.0, 0.0, 63.0, 63.0],
               [20.0, 20.0, 60.0, 62.0]],
    "grow": [[30.0, 30.0, 34.0, 33.0], [10.0, 12.0, 13.0, 14.0], [50.0, 40.0, 52.0, 44.0],
             [1.0, 1.0, 3.0, 2.0]],
    "rectangular": [[20.0, 5.0, 24.0, 60.0], [5.0, 30.0, 60.0, 34.0], [30.0, 10.0, 33.0, 50.0],
                    [10.0, 40.0, 55.0, 43.0]],
    "fractional": [[20.3, 17.7, 41.1, 29.9], [3.25, 5.5, 9.75, 30.125], [33.1, 33.9, 35.3, 36.7],
                   [0.4, 60.6, 12.2, 63.3]],
    "partly outside": [[-10.0, 50.0, 12.0, 80.0], [55.0, -5.0, 90.0, 20.0],
                       [-30.0, -30.0, 5.0, 5.0], [40.0, 58.0, 70.0, 75.0]],
    "unseen (-1 box)": [[-1.0, -1.0, -1.0, -1.0]] * 4,
}


@pytest.fixture(scope="module")
def jax_crop():
    """``crop_resize`` vmapped over frames, one ROI each, under one jit."""
    return jax.jit(jax.vmap(lambda img, cu, cv, hu, hv: jcrop.crop_resize(
        img, cu, cv, hu, CROP, half_v=hv)))


@pytest.mark.parametrize("case", list(ROI_CASES))
def test_crop_resize_matches_jax(jax_crop, case):
    """Square ROIs and rect_roi's, the same images: 1e-5."""
    rng = np.random.RandomState(len(case))
    img = rng.uniform(0, 1, (B, RES, RES, 3)).astype(np.float32)
    box = np.asarray(ROI_CASES[case], np.float32)
    for rect in (False, True):
        if rect:
            jroi = jcrop.rect_roi(jnp.asarray(box), min_half=4.0)
            roi = crop.rect_roi(torch.as_tensor(box), min_half=4.0)
        else:
            jroi = jcrop.square_roi(jnp.asarray(box), min_half=4.0)
            jroi = (*jroi, jroi[2])
            roi = crop.square_roi(torch.as_tensor(box), min_half=4.0)
            roi = (*roi, roi[2])
        ref = np.asarray(jax_crop(jnp.asarray(img), *jroi))
        got = crop.crop_resize(torch.as_tensor(img), *roi[:3], CROP, half_v=roi[3])
        assert got.shape == (B, CROP, CROP, 3)
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, err_msg=f"rect {rect}")
    if case == "unseen (-1 box)":
        # The min_half ROI about (-1, -1): crop pixels below 19.5 sample
        # outside the frame and are 0.
        assert not got[:, :19].any() and not got[:, :, :19].any() and got[:, 20:, 20:].all()


def test_crop_resize_several_rois_a_frame():
    """(B, R) ROIs crop each frame R times: the same as one ROI a call."""
    rng = np.random.RandomState(1)
    img = torch.as_tensor(rng.uniform(0, 1, (2, RES, RES, 3)).astype(np.float32))
    box = torch.as_tensor(np.asarray([ROI_CASES["fractional"][:3],
                                      ROI_CASES["rectangular"][:3]], np.float32))
    cu, cv, hu, hv = crop.rect_roi(box)
    both = crop.crop_resize(img, cu, cv, hu, CROP, half_v=hv)
    assert both.shape == (2, 3, CROP, CROP, 3)
    for r in range(3):
        one = crop.crop_resize(img, cu[:, r], cv[:, r], hu[:, r], CROP, half_v=hv[:, r])
        np.testing.assert_allclose(both[:, r].numpy(), one.numpy(), atol=1e-6)


def test_roi_ops_match_jax():
    rng = np.random.RandomState(2)
    box = np.sort(rng.uniform(-20, 80, (16, 2, 2)), axis=1).transpose(0, 2, 1)
    box = box.reshape(16, 4)[:, [0, 2, 1, 3]].astype(np.float32)
    box[3] = -1.0
    keys = jax.random.split(jax.random.PRNGKey(7), 16)
    d = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (3,), minval=-1.0, maxval=1.0))(keys))
    uv = rng.uniform(-10, 70, (16, 5, 2)).astype(np.float32)
    tb, td, tuv = torch.as_tensor(box), torch.tensor(d), torch.as_tensor(uv)
    jb, juv = jnp.asarray(box), jnp.asarray(uv)

    def close(got, ref):
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6, atol=1e-5)

    close(crop.square_roi(tb), jcrop.square_roi(jb))
    close(crop.rect_roi(tb, min_half=24.0), jcrop.rect_roi(jb, min_half=24.0))
    sq, jsq = crop.square_roi(tb), jcrop.square_roi(jb)
    close(crop.jitter_roi(td, *sq), jax.vmap(jcrop.jitter_roi)(keys, *jsq))
    rc, jrc = crop.rect_roi(tb), jcrop.rect_roi(jb)
    close(crop.jitter_roi(td, *rc[:3], half_v=rc[3]), jax.vmap(
        lambda k, u, v, hu, hv: jcrop.jitter_roi(k, u, v, hu, half_v=hv))(keys, *jrc))
    for fn, jfn in ((crop.uv_to_crop, jcrop.uv_to_crop), (crop.crop_to_uv, jcrop.crop_to_uv)):
        got = fn(tuv, *(x[:, None] for x in rc[:3]), CROP, half_v=rc[3][:, None])
        ref = jfn(juv, *(x[:, None] for x in jrc[:3]), CROP, half_v=jrc[3][:, None])
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-4)
    back = crop.crop_to_uv(crop.uv_to_crop(tuv, *(x[:, None] for x in sq), CROP),
                           *(x[:, None] for x in sq), CROP)
    np.testing.assert_allclose(back.numpy(), uv, atol=1e-4)


def _jax_crop_draws(seed, frame_ids, parts):
    """The JAX crop functions' draws for the frames' keys fold_in(seed, f)
    (split in 4 per frame for the crane's parts, then into an ROI key and
    an augment key per crop), as the port's ``CropDraws``."""
    jit, b, c, gains, noise = [], [], [], [], []
    for f in frame_ids:
        key = jax.random.fold_in(seed, int(f))
        for k in (jax.random.split(key, 4) if parts == 4 else [key]):
            k_roi, k_aug = jax.random.split(k)
            jit.append(jax.random.uniform(k_roi, (3,), minval=-1.0, maxval=1.0))
            k1, k2, k3, k4 = jax.random.split(k_aug, 4)
            b.append(1.0 + jax.random.uniform(k1, (), minval=-0.2, maxval=0.2))
            c.append(1.0 + jax.random.uniform(k2, (), minval=-0.2, maxval=0.2))
            gains.append(1.0 + jax.random.uniform(k3, (3,), minval=-0.05, maxval=0.05))
            noise.append(jax.random.normal(k4, (CROP, CROP, 3)))
    t = lambda v: torch.as_tensor(_np(np.stack(v)))
    return crop_loop.CropDraws(t(jit), preprocess.AugmentDraws(t(b), t(c), t(gains), t(noise)))


KINDS = {  # kind: (JAX function and its arguments after the roster, stride, crops a frame)
    "dumper": (lambda s, b, r: jcrop_loop.crop_batch(s, b, r, "dumper", CROP, 4, SIGMA), 4, 1),
    "crane": (lambda s, b, r: jcrop_loop.crop_batch_crane(s, b, r, CROP, 2, SIGMA), 2, 1),
    "crane_parts": (lambda s, b, r: jcrop_loop.crop_batch_crane_parts(s, b, r, CROP, 2, SIGMA),
                    2, 4),
}


def _port_crops(kind, batch, roster, draws, size=CROP):
    stride = KINDS[kind][1]
    if kind == "dumper":
        return crop_loop.crop_batch(batch, roster, "dumper", size, stride, SIGMA, draws)
    if kind == "crane":
        return crop_loop.crop_batch_crane(batch, roster, size, stride, SIGMA, draws)
    return crop_loop.crop_batch_crane_parts(batch, roster, size, stride, SIGMA, draws)


@pytest.mark.parametrize("kind", list(KINDS))
def test_crop_batch_matches_jax(frames, kind):
    batch, jb, roster, jroster = frames
    fn, stride, parts = KINDS[kind]
    ref = jax.jit(lambda s, b: fn(s, b, jroster))(SEED, jb)
    draws = _jax_crop_draws(SEED, range(B), parts)
    got = _port_crops(kind, batch, roster, draws)
    n, C = B * parts, ref[1].shape[1]
    assert got[0].shape == (n, CROP, CROP, 3) and got[1].shape == (n, C, CROP // stride,
                                                                   CROP // stride)
    np.testing.assert_allclose(_unit(got[0]), _unit(ref[0]), atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), atol=1e-6)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    assert got[1].max() > 0.5  # a keypoint inside some crop


def test_crop_batch_without_jitter_or_augment(frames):
    """``jitter=False, augment=False`` (no draws) against JAX's."""
    batch, jb, roster, jroster = frames
    ref = jcrop_loop.crop_batch_crane(SEED, jb, jroster, CROP, 2, SIGMA, jitter=False,
                                      augment=False)
    got = crop_loop.crop_batch_crane(batch, roster, CROP, 2, SIGMA, jitter=False, augment=False)
    np.testing.assert_allclose(_unit(got[0]), _unit(ref[0]), atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), atol=1e-6)


def test_crane_helpers_match_jax(frames):
    batch, jb, roster, jroster = frames
    assert crop_loop.crane_channels(roster) == jcrop_loop.crane_channels(jroster)
    box, vis = crop_loop.crane_union_roi(batch, roster)
    jbox, jvis = jcrop_loop.crane_union_roi(jb, jroster)
    np.testing.assert_array_equal(box.numpy(), np.asarray(jbox))
    np.testing.assert_array_equal(vis.numpy(), np.asarray(jvis))
    assert bool(vis.any()) and not bool(vis.all())  # seen and unseen frames


def test_crop_draws_are_per_crop():
    """A crop's draws depend on (seed, frame, part) only."""
    a = crop_loop.crop_draws(5, [10, 11], 4, 8)
    b = crop_loop.crop_draws(5, [11], 4, 8)
    assert torch.equal(a.jitter[4:], b.jitter)
    assert all(torch.equal(x[4:], y) for x, y in zip(a.augment, b.augment))
    assert not torch.equal(a.jitter[4], a.jitter[5])
    assert bool((a.jitter.abs() <= 1).all()) and a.augment.noise.shape == (8, 8, 8, 3)
    one = crop_loop.crop_draws(5, [11], 1, 8)
    assert torch.equal(one.jitter[0], b.jitter[0])  # part 0 of a frame is its single crop


def _jax_crop_loss(jm, kind, loss):
    """The JAX crop step's loss (``make_crop_train_step``'s ``loss_fn``,
    written out): per sample, weighted by sample_w."""

    def loss_fn(params, images, targets, sample_w):
        pred = jpose_net.forward(jm, params, images)
        if loss == "focal":
            per = jax.vmap(jlosses.focal_heatmap_loss)(pred, targets)
        else:
            per = jax.vmap(lambda p, t: jlosses.heatmap_mse(p, t))(pred, targets)
        return jnp.sum(per * sample_w) / jnp.maximum(jnp.sum(sample_w), 1.0)
    return loss_fn


@pytest.mark.parametrize("kind,loss", [("dumper", "focal"), ("crane", "focal")])
def test_crop_train_step_matches_jax(frames, kind, loss):
    """Three updates on the same crops from flax's weights and optax's state
    (``crop_batch`` output; frames without the class weigh 0): the port's
    ``train_on_crops`` against the JAX step's loss, gradient and AdamW."""
    batch, jb, roster, jroster = frames
    _, stride, parts = KINDS[kind]
    channels = 10 if kind == "dumper" else 28
    jcfg = dataclasses.replace(JCFG, train=dataclasses.replace(JCFG.train, loss=loss))
    cfg = dataclasses.replace(CFG, train=dataclasses.replace(CFG.train, loss=loss))
    jm = jbackbone.HeatmapBackbone(num_channels=channels, output_stride=stride,
                                   dtype=jnp.float32, **NARROW)
    js = jcrop_loop.create_crop_train_state(jcfg, jm, jax.random.PRNGKey(1), STEP_CROP)
    tm = backbone.HeatmapBackbone(channels, output_stride=stride, dtype=torch.float32, **NARROW)
    state = convert.train_state(js, tm, cfg)
    images, targets, w = _port_crops(kind, batch, roster, crop_loop.crop_draws(
        0, range(B), parts, STEP_CROP), STEP_CROP)
    assert 0 < float(w.sum()) < len(w)  # crops weighted in and out
    tx = jloop.make_optimizer(jcfg)

    @jax.jit
    def jstep(params, opt_state, im, tg, sw):
        value, grads = jax.value_and_grad(_jax_crop_loss(jm, kind, loss))(params, im, tg, sw)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, value

    step = crop_loop.CropTrainStep(cfg, tm, Pipeline(cfg, device="cpu"), "crane" if
                                   kind != "dumper" else "dumper", STEP_CROP, SIGMA,
                                   per_part=kind == "crane_parts")
    params, opt_state = js.params, js.opt_state
    ji = [jnp.asarray(x.numpy()) for x in (images, targets, w)]
    for i in range(3):
        params, opt_state, ref = jstep(params, opt_state, *ji)
        state, met = step.train_on_crops(state, images, targets, w)
        np.testing.assert_allclose(met["loss"].item(), float(ref), rtol=1e-5)
        assert met["n_visible"].item() == float(w.sum()) and met["step"] == i
    ref_sd = convert.pose_net_params(params, tm)
    two_lr = 2.0 * (state.scheduler.lr_lambdas[0](1) + state.scheduler.lr_lambdas[0](2))
    d = np.concatenate([np.abs(p.detach().numpy() - ref_sd[name].numpy()).ravel()
                        for name, p in tm.named_parameters()])
    assert (d > 1e-5).mean() <= 0.01 and d.max() <= two_lr, ((d > 1e-5).sum(), d.size, d.max())
    assert state.step == 3


@pytest.mark.parametrize("kind", ["focal", "mse"])
def test_per_sample_losses_match_jax(kind):
    """``focal_per_sample`` / ``mse_per_sample`` against ``jax.vmap`` of the
    JAX losses, values and gradients (the MSE crop step's loss: with Adam,
    MSE's gradients, ~1e-8 here, leave a few weights' update signs to
    rounding, so its steps are not compared over 3 updates)."""
    from constructionsceneposeestimation_tpu_torch.train import losses

    rng = np.random.RandomState(5)
    pred = rng.randn(4, 7, 8, 8).astype(np.float32) * 3.0
    target = rng.uniform(0, 1, pred.shape).astype(np.float32) ** 8
    target[:, :, 2, 3] = 1.0
    target[2] = 0.0  # a sample with no positive
    w = jnp.asarray([1.0, 0.0, 1.0, 1.0])
    jfn = jlosses.focal_heatmap_loss if kind == "focal" else jlosses.heatmap_mse
    tfn = losses.focal_per_sample if kind == "focal" else losses.mse_per_sample
    ref, ref_g = jax.value_and_grad(lambda p: jnp.sum(jax.vmap(jfn)(p, jnp.asarray(target)) * w))(
        jnp.asarray(pred))
    p = torch.tensor(pred, requires_grad=True)
    got = torch.sum(tfn(p, torch.as_tensor(target)) * torch.tensor(np.asarray(w)))
    got.backward()
    np.testing.assert_allclose(got.item(), float(ref), rtol=2e-6)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(ref_g), rtol=1e-6,
                               atol=1e-6 * np.abs(np.asarray(ref_g)).max())
