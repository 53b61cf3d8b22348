"""The port's checkpoints and its step loop (counterpart of the JAX
``tests/test_checkpoint_utils.py``): a round trip of the whole
``TrainState``, ``save_every``, retention, resuming bit for bit on the
CPU, and ``make_scanned_train_fn`` against single steps, on the lite
backbone at 64^2 with 2 frames a step."""

import os

import pytest
import torch

from constructionsceneposeestimation_tpu_torch.config import Config, PipelineConfig, SceneConfig
from constructionsceneposeestimation_tpu_torch.config import TrainConfig
from constructionsceneposeestimation_tpu_torch.models import pose_net
from constructionsceneposeestimation_tpu_torch.parallel.pipeline import Pipeline
from constructionsceneposeestimation_tpu_torch.train import checkpoint
from constructionsceneposeestimation_tpu_torch.train import loop as train_loop

torch.set_num_threads(2)
TINY = Config(scene=SceneConfig(n_cones=1, n_trees=0, n_fence_panels=4),
              pipeline=PipelineConfig(render_width=64, render_height=64),
              train=TrainConfig(batch_size=2, steps=4, warmup_steps=1, loss="focal",
                                camera_mix=0.5))
SEED = 7


def _state(seed=0):
    return train_loop.create_train_state(TINY, pose_net.make_model(lite=True, device="cpu",
                                                                   seed=seed))


@pytest.fixture(scope="module")
def pipe():
    return Pipeline(TINY, device="cpu")


def _assert_states_equal(a, b):
    assert a.step == b.step
    assert a.scheduler.last_epoch == b.scheduler.last_epoch
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    oa, ob = a.optimizer.state_dict()["state"], b.optimizer.state_dict()["state"]
    assert oa.keys() == ob.keys()
    for i in oa:
        for k in oa[i]:
            assert torch.equal(oa[i][k], ob[i][k]), (i, k)


def _steps(state, pipe, n, first_step=0):
    step = train_loop.make_train_step(TINY, state.model, pipe)
    for i in range(first_step, first_step + n):
        state, m = step(state, SEED, range(i * 2, i * 2 + 2))
        assert torch.isfinite(m["loss"])
    return state


def test_checkpoint_roundtrip(tmp_path, pipe):
    state = _steps(_state(), pipe, 2)
    mgr = checkpoint.CheckpointManager(str(tmp_path / "ckpt"), save_every=1)
    state.step = 5
    assert mgr.maybe_save(state, force=True)
    assert mgr.latest_step() == 5
    assert not mgr.maybe_save(state, force=True)  # already saved at this step
    restored = mgr.restore(_state(seed=1))
    _assert_states_equal(restored, state)
    assert not [f for f in os.listdir(tmp_path / "ckpt") if f.endswith(".tmp")]
    mgr.close()
    with pytest.raises(FileNotFoundError):
        checkpoint.CheckpointManager(str(tmp_path / "empty")).restore(_state())


def test_checkpoint_save_every(tmp_path):
    state = _state()
    mgr = checkpoint.CheckpointManager(str(tmp_path / "c"), save_every=10)
    state.step = 5
    assert not mgr.maybe_save(state)
    state.step = 10
    assert mgr.maybe_save(state)
    assert not checkpoint.CheckpointManager(str(tmp_path / "d"), save_every=0).maybe_save(state)


def test_checkpoint_keeps_the_newest_three(tmp_path):
    state = _state()
    mgr = checkpoint.CheckpointManager(str(tmp_path / "k"), save_every=1)
    for s in range(1, 6):
        state.step = s
        assert mgr.maybe_save(state)
    assert mgr.steps() == [3, 4, 5]
    assert mgr.restore(_state(), step=4).step == 4


def test_resume_is_bit_exact(tmp_path, pipe):
    """4 steps equal 2 steps, a save, a restore into a fresh state, and 2
    more, bit for bit."""
    straight = _steps(_state(), pipe, 4)
    half = _steps(_state(), pipe, 2)
    mgr = checkpoint.CheckpointManager(str(tmp_path / "r"), save_every=0)
    assert mgr.maybe_save(half, force=True)
    resumed = _steps(mgr.restore(_state(seed=3)), pipe, 2, first_step=2)
    _assert_states_equal(resumed, straight)


def test_scanned_train_matches_stepwise(pipe):
    """``make_scanned_train_fn(inner=2)`` twice equals 4 single steps."""
    single = _steps(_state(), pipe, 4)
    state = _state()
    run = train_loop.make_scanned_train_fn(TINY, state.model, pipe, inner_steps=2)
    for start in (0, 4):
        state, metrics = run(state, SEED, start)
    assert metrics["step"] == 3
    _assert_states_equal(state, single)
