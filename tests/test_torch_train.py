"""The port's training step against the JAX package's: the losses, the
roster's channel weights, optax's schedule and ``adamw``, the photometric
augment, the camera-mix choice, and ``train_on_batch`` and the shard-fed
``make_data_train_step`` on one JAX-generated ``FrameBatch``
(``convert.frame_batch``) from flax's f32 weights and optax's state
(``convert.train_state``). Where JAX draws randomness, the test draws
it from the same key and hands it to the port.

Tolerances (f32 on both sides): the losses 2e-6 relative (sums of 3584
terms in f32, in another order on each side: 1.2e-6 seen), their gradients
1e-6 relative; the schedule 1e-7 absolute; AdamW's parameters and moments 1e-6
over 3 steps; the augment 1e-6 (its normalized output 1e-5: normalizing
divides by std ~0.225); the cameras 1e-6 m; the training step's loss 1e-5
relative, each gradient to 1e-4 of its tensor's norm, the parameters after
3 steps 1e-5."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from constructionsceneposeestimation_tpu.config import Config as JConfig
from constructionsceneposeestimation_tpu.config import PipelineConfig as JPipelineConfig
from constructionsceneposeestimation_tpu.config import SceneConfig as JSceneConfig
from constructionsceneposeestimation_tpu.config import TrainConfig as JTrainConfig
from constructionsceneposeestimation_tpu.models import backbone as jbackbone
from constructionsceneposeestimation_tpu.ops import preprocess as jpre
from constructionsceneposeestimation_tpu.parallel import pipeline as jpipeline
from constructionsceneposeestimation_tpu.sample import camera_sampler as jcs
from constructionsceneposeestimation_tpu.train import loop as jloop
from constructionsceneposeestimation_tpu.train import losses as jlosses
from constructionsceneposeestimation_tpu.utils import prng as jprng
from constructionsceneposeestimation_tpu_torch import convert
from constructionsceneposeestimation_tpu_torch.config import Config, PipelineConfig, SceneConfig
from constructionsceneposeestimation_tpu_torch.config import TrainConfig
from constructionsceneposeestimation_tpu_torch.models import backbone
from constructionsceneposeestimation_tpu_torch.ops import preprocess
from constructionsceneposeestimation_tpu_torch.parallel.pipeline import Pipeline
from constructionsceneposeestimation_tpu_torch.sample import camera_sampler
from constructionsceneposeestimation_tpu_torch.scene import world
from constructionsceneposeestimation_tpu_torch.train import loop, losses

torch.set_num_threads(2)
RES, B, MIX = 64, 4, 0.5
SCENE = dict(n_cones=2, n_trees=1, n_fence_panels=4)
JCFG = JConfig(scene=JSceneConfig(**SCENE),
               pipeline=JPipelineConfig(render_width=RES, render_height=RES),
               train=JTrainConfig(batch_size=B, steps=10, warmup_steps=2, loss="focal",
                                  camera_mix=MIX))
CFG = Config(scene=SceneConfig(**SCENE),
             pipeline=PipelineConfig(render_width=RES, render_height=RES),
             train=TrainConfig(batch_size=B, steps=10, warmup_steps=2, loss="focal",
                               camera_mix=MIX))
GEN_SEED = 1


@pytest.fixture(scope="module")
def jbatch():
    """One JAX training batch (camera mix on), generated once."""
    pipe = jpipeline.Pipeline(JCFG)
    gen = jax.jit(pipe.make_generate_fn(camera_mix=MIX))
    return gen(jax.random.PRNGKey(GEN_SEED), jnp.arange(B))


def _np(x):
    return np.asarray(x, np.float32)


def _loss_inputs(shape, seed):
    rng = np.random.RandomState(seed)
    pred = rng.randn(*shape).astype(np.float32) * 3.0
    pred.flat[:5] = [40.0, -40.0, 25.0, -25.0, 0.0]  # sigmoid saturates: clipped
    target = rng.uniform(0.0, 1.0, shape).astype(np.float32) ** 8
    target.flat[5:40] = 1.0  # positives
    w = rng.uniform(0.2, 2.0, shape[-3]).astype(np.float32)
    return pred, target, w


@pytest.mark.parametrize("kind,weighted", [("mse", False), ("mse", True), ("focal", False),
                                           ("focal", True)])
def test_losses_and_gradients_match_jax(kind, weighted):
    # Focal's weights scale the leading axis (the detector's per-class maps).
    shape = (2, 7, 16, 16) if kind == "mse" else (7, 16, 16)
    pred, target, w = _loss_inputs(shape, 3)
    jfn = jlosses.heatmap_mse if kind == "mse" else jlosses.focal_heatmap_loss
    tfn = losses.heatmap_mse if kind == "mse" else losses.focal_heatmap_loss
    jw = jnp.asarray(w) if weighted else None
    tw = torch.as_tensor(w) if weighted else None
    ref, ref_g = jax.value_and_grad(
        lambda p: jfn(p, jnp.asarray(target), channel_weights=jw))(jnp.asarray(pred))
    p = torch.as_tensor(pred).requires_grad_(True)
    got = tfn(p, torch.as_tensor(target), channel_weights=tw)
    got.backward()
    np.testing.assert_allclose(got.item(), float(ref), rtol=2e-6)
    scale = np.abs(np.asarray(ref_g)).max()
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(ref_g), rtol=1e-6, atol=1e-6 * scale)


def test_clip_gradient_at_the_bounds_matches_jnp_clip():
    x = np.asarray([0.2, 0.25, 0.5, 0.75, 0.8], np.float32)
    ref = jax.grad(lambda v: jnp.sum(jnp.clip(v, 0.25, 0.75) ** 2))(jnp.asarray(x))
    t = torch.as_tensor(x).requires_grad_(True)
    torch.sum(losses._clip(t, 0.25, 0.75) ** 2).backward()
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(ref))


def test_channel_weights_from_roster_equal():
    jr = jpipeline.Pipeline(JConfig()).roster
    ref = np.asarray(jloop.channel_weights_from_roster(jr))
    got = loop.channel_weights_from_roster(world.make_roster(SceneConfig())).numpy()
    np.testing.assert_array_equal(got, ref)


def test_lr_schedule_matches_optax():
    tc = TrainConfig(steps=32000)  # lr 1e-3, warmup 500
    ref = optax.warmup_cosine_decay_schedule(0.0, tc.learning_rate, tc.warmup_steps,
                                             max(tc.steps, tc.warmup_steps + 1))
    fn = loop.lr_schedule(tc)
    for count in (0, 1, 20, 500, 16000, 32000):
        assert abs(fn(count) - float(ref(count))) < 1e-7, count
    assert fn(0) == 0.0


def test_adamw_matches_optax_over_three_steps():
    """The port's AdamW + LambdaLR against optax's ``adamw`` on the same
    gradients: the first update (lr 0) moves no weight but the moments."""
    rng = np.random.RandomState(0)
    params = {"a": rng.randn(3, 4).astype(np.float32), "b": rng.randn(5).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(3)]
    tx = jloop.make_optimizer(JCFG)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.as_tensor(v.copy())) for k, v in params.items()}
    opt, sched = loop.make_optimizer(CFG, tp.values())
    for i, g in enumerate(grads):
        upd, js = tx.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.as_tensor(g[k])
        opt.step()
        sched.step()
        if i == 0:
            for k, p in tp.items():
                np.testing.assert_array_equal(p.detach().numpy(), params[k])
    adam = js[0]
    for k, p in tp.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), atol=1e-6)
        np.testing.assert_allclose(opt.state[p]["exp_avg"].numpy(), np.asarray(adam.mu[k]),
                                   atol=1e-6)
        np.testing.assert_allclose(opt.state[p]["exp_avg_sq"].numpy(), np.asarray(adam.nu[k]),
                                   atol=1e-6)
        assert opt.state[p]["step"].item() == int(adam.count) == 3


def _jax_draws(seed_key, fids, shape):
    """The JAX augment's draws of ``preprocess.photometric_augment`` for
    the frames' keys fold_in(seed_key, fid), as the port's AugmentDraws."""
    b, c, gains, noise = [], [], [], []
    for f in fids:
        k1, k2, k3, k4 = jax.random.split(jax.random.fold_in(seed_key, int(f)), 4)
        b.append(1.0 + jax.random.uniform(k1, (), minval=-0.2, maxval=0.2))
        c.append(1.0 + jax.random.uniform(k2, (), minval=-0.2, maxval=0.2))
        gains.append(1.0 + jax.random.uniform(k3, (3,), minval=-0.05, maxval=0.05))
        noise.append(jax.random.normal(k4, shape))
    return preprocess.AugmentDraws(*(torch.as_tensor(_np(np.stack(v))) for v in
                                     (b, c, gains, noise)))


@pytest.mark.parametrize("out", [RES, RES // 2])
def test_augment_matches_jax(out):
    rng = np.random.RandomState(4)
    rgb = rng.randint(0, 256, (2, RES, RES, 3)).astype(np.uint8)
    key = jax.random.PRNGKey(9)
    draws = _jax_draws(key, [3, 8], (out, out, 3))
    ref = np.stack([np.asarray(jpre.preprocess_frame(jax.random.fold_in(key, f), rgb[i], out,
                                                     out, augment=True))
                    for i, f in enumerate([3, 8])])
    got = preprocess.preprocess_frame(torch.as_tensor(rgb), out, out, augment=True, draws=draws)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)
    img = rng.uniform(0, 1, (2, out, out, 3)).astype(np.float32)
    ref = np.stack([np.asarray(jpre.photometric_augment(jax.random.fold_in(key, f), img[i]))
                    for i, f in enumerate([3, 8])])
    got = preprocess.photometric_augment(torch.as_tensor(img), draws)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6)


def test_augment_draws_are_per_frame():
    """A frame's draws depend on (seed, frame id) only, not on its batch."""
    a = preprocess.augment_draws(5, [10, 11, 12], 8, 8)
    b = preprocess.augment_draws(5, [11], 8, 8)
    for x, y in zip(a, b):
        assert torch.equal(x[1:2], y)
    assert not torch.equal(a.noise[0], a.noise[1])
    for lo, hi, v in ((0.8, 1.2, a.brightness), (0.8, 1.2, a.contrast), (0.95, 1.05, a.gains)):
        assert bool(((v >= lo) & (v <= hi)).all())
    with pytest.raises(ValueError):
        preprocess.preprocess_frame(torch.zeros(1, 8, 8, 3, dtype=torch.uint8), 8, 8,
                                    augment=True)


def test_camera_mix_choice_matches_jax(jbatch):
    """The JAX frames' coin and DR camera (from the keys its generate
    splits) through the port's choice give the JAX batch's cameras."""
    seed = jax.random.PRNGKey(GEN_SEED)
    ladder = jcs.systematic_camera_positions(JCFG.pipeline.max_iterations,
                                             jax.random.PRNGKey(JCFG.pipeline.seed))
    coins, dr_cam, dr_tgt = [], [], []
    for f in range(B):
        k_cam, _ = jax.random.split(jprng.frame_key(seed, f))
        k_mix, k_dr = jax.random.split(k_cam)
        coins.append(float(jax.random.uniform(k_mix)))
        c, t = jcs.sample_camera_batch(k_dr, 1, JCFG.camera)
        dr_cam.append(_np(c[0]))
        dr_tgt.append(_np(t[0]))
    idx = np.arange(B) % ladder[0].shape[0]
    use = torch.as_tensor(coins) < MIX
    cam, _ = camera_sampler.mix_cameras(use, torch.as_tensor(_np(ladder[0])[idx]),
                                        torch.as_tensor(_np(ladder[1])[idx]),
                                        torch.as_tensor(np.stack(dr_cam)),
                                        torch.as_tensor(np.stack(dr_tgt)))
    assert 0 < int(use.sum()) < B  # both kinds of view in the batch
    np.testing.assert_allclose(cam.numpy(), _np(jbatch.camera_pose7)[:, :3], atol=1e-6)


def test_default_generate_unchanged_by_camera_mix_option():
    """``camera_mix=None`` is the default path bit for bit, and with a mix a
    frame whose coin picks the DR view is that frame of the default path:
    the coin has its own stream and moves no other draw."""
    pipe = Pipeline(CFG, device="cpu")
    base = pipe.make_generate_fn()(3, range(4))
    same = pipe.make_generate_fn(camera_mix=None)(3, range(4))
    assert all(torch.equal(a, b) for a, b in zip(base, same))
    mixed = pipe.make_generate_fn(camera_mix=0.5)(3, range(4))
    ladder = pipe.ladder()[0]
    on_ladder = [torch.equal(mixed.camera_pose7[i, :3], ladder[i]) for i in range(4)]
    assert 0 < sum(on_ladder) < 4
    for i in range(4):
        if not on_ladder[i]:
            assert all(torch.equal(a[i], b[i]) for a, b in zip(base, mixed))
    lad = pipe.make_generate_fn(ladder=True)(3, range(4))
    assert torch.equal(lad.camera_pose7[:, :3], ladder[:4])


@pytest.fixture(scope="module")
def jstate():
    """flax's f32 LiteBackbone and a fresh optax state."""
    jm = jbackbone.LiteBackbone(num_channels=71, dtype=jnp.float32)
    return jm, jloop.create_train_state(JCFG, jm, jax.random.PRNGKey(0))


@pytest.mark.parametrize("kind", ["focal", "mse"])
def test_train_on_batch_matches_jax(jbatch, jstate, kind):
    jcfg = dataclasses.replace(JCFG, train=dataclasses.replace(JCFG.train, loss=kind))
    cfg = dataclasses.replace(CFG, train=dataclasses.replace(CFG.train, loss=kind))
    jm, js = jstate
    tm = backbone.LiteBackbone(71, dtype=torch.float32)
    state = convert.train_state(js, tm, cfg)
    batch = convert.frame_batch(jbatch)
    roster = world.make_roster(cfg.scene)
    seed = jax.random.PRNGKey(7)
    fids = np.arange(B)

    # One step's loss and gradients: the JAX step's body on this batch.
    keys = jax.vmap(lambda i: jax.random.fold_in(seed, i))(jnp.asarray(fids))
    images = jax.vmap(lambda k, r: jpre.preprocess_frame(k, r, RES, RES))(keys, jbatch.rgb)
    ch_w = jloop.channel_weights_from_roster(jpipeline.Pipeline(jcfg).roster)
    (ref_loss, _), ref_g = jax.value_and_grad(jloop._make_loss_fn(jcfg, jm, ch_w), has_aux=True)(
        js.params, images, jbatch.heatmaps)
    bs = loop.BatchStep(cfg, roster)
    loss = bs.forward_backward(state, batch, _jax_draws(seed, fids, (RES, RES, 3)))
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    ref_sd = convert.pose_net_params(ref_g, tm)
    for name, p in tm.named_parameters():
        g, r = p.grad.numpy(), ref_sd[name].numpy()
        assert np.linalg.norm(g - r) <= 1e-4 * max(np.linalg.norm(r), 1e-12), name

    # Three steps of the JAX package's fixed-batch step (augment keys of
    # frames step * B + arange(B)) against three train_on_batch.
    jstep = jax.jit(jloop.make_data_train_step(jcfg, jm))
    st = convert.train_state(js, tm, cfg)
    for i in range(3):
        js_i, _ = jstep(js if i == 0 else js_i, seed, jbatch.rgb, jbatch.heatmaps)
        st, _ = bs(st, batch, _jax_draws(seed, i * B + fids, (RES, RES, 3)))
    ref_sd = convert.pose_net_params(js_i.params, tm)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref_sd[name].numpy(), atol=1e-5,
                                   err_msg=name)
    assert st.step == int(js_i.step) == 3


def test_data_train_step_matches_jax(jbatch, jstate):
    """``make_data_train_step`` against the JAX package's on the rows of a
    shard (rgb u8, heatmaps f16 as ``save_shard`` stores them) over 3
    steps, JAX's augment draws (keys fold_in(seed, step * B + i)) handed to
    the port's step: the losses 1e-5 relative, the parameters 1e-5."""
    jm, js = jstate
    tm = backbone.LiteBackbone(71, dtype=torch.float32)
    state = convert.train_state(js, tm, CFG)
    rgb = np.array(jbatch.rgb)  # writable, as the reader's rows are
    hm16 = np.asarray(jbatch.heatmaps).astype(np.float16)
    seed = jax.random.PRNGKey(7)
    step = loop.make_data_train_step(CFG, tm)
    # The port's own draws key frames step * B + arange(B).
    own = step.draws(11, 2, B)
    ref = preprocess.augment_draws(11, range(2 * B, 3 * B), RES, RES)
    assert all(torch.equal(a, b) for a, b in zip(own, ref))
    step.draws = lambda _seed, s, b: _jax_draws(seed, s * b + np.arange(b), (RES, RES, 3))
    jstep = jax.jit(jloop.make_data_train_step(JCFG, jm))
    for i in range(3):
        js, jmet = jstep(js, seed, jnp.asarray(rgb), jnp.asarray(hm16, jnp.float32))
        state, met = step(state, 0, rgb, hm16)
        np.testing.assert_allclose(met["loss"].item(), float(jmet["loss"]), rtol=1e-5)
        assert met["step"] == int(jmet["step"]) == i
    ref_sd = convert.pose_net_params(js.params, tm)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref_sd[name].numpy(), atol=1e-5,
                                   err_msg=name)
    assert state.step == int(js.step) == 3
